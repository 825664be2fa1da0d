"""The port's flight-recorder dumps (``anovos_tpu_torch/obs/flight.py`` and
the scheduler's triggers) against the JAX package's, case by case as
``tests/test_flight.py`` holds the JAX one:

* the ring and the dump: the disarm knob, the bound, the file name, tmp
  and rename, a second trigger on one node that never overwrites the
  first, a fresh ring per ``configure``;
* ``build_snapshot``'s keys equal to JAX's (no key differs), and its
  values where both packages see the same state;
* the scheduler's triggers: a raise-mode node's fatal error, and in the
  concurrent mode a hang under a ``node_timeout`` that escalates (a dump
  with the node in flight) and then is abandoned, fails or ends the run
  (a second dump, ``_2``); a clean run and an absorbed retry dump
  nothing, and the retry is in the ring.  The runner's dump list is held
  against JAX's on a fatal run; the JAX package's wedge case (the
  ``backend_failover`` dump) is in ``tests/test_torch_failover.py``.

Every test leaves no thread behind (``_no_thread_left``).
"""

import copy
import glob
import json
import os

import pytest

from _torch_port import assert_no_thread_left, thread_names, torch_cpu_runtime  # noqa: F401
from anovos_tpu_torch.obs import flight
from anovos_tpu_torch.parallel.scheduler import DagScheduler, NodeTimeout


@pytest.fixture(autouse=True)
def _no_thread_left():
    from anovos_tpu.obs import flight as jflight
    from anovos_tpu.resilience import chaos as jchaos
    from anovos_tpu.resilience import policy as jpolicy
    from anovos_tpu_torch.resilience import chaos, policy

    before = thread_names()
    yield
    flight.reset()
    jflight.reset()
    # both packages' chaos plans: the runner test installs one in each, and
    # a plan left installed would fire in a later file's scheduler runs
    chaos.reset()
    jchaos.reset()
    policy.reset_degraded()
    jpolicy.reset_degraded()
    assert_no_thread_left(before)


# ---------------------------------------------------------------------------
# the ring and the dump
# ---------------------------------------------------------------------------

def test_disarmed_by_default_and_by_env(tmp_path, monkeypatch):
    flight.reset()
    assert not flight.enabled() and flight.dump("fatal_error", node="x") is None
    monkeypatch.setenv("ANOVOS_TPU_FLIGHTREC", "0")
    flight.configure(str(tmp_path))
    assert not flight.enabled() and flight.dump("fatal_error", node="x") is None
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("bound,kept", [("32", 32), ("5", 16), ("garbage", 100)])
def test_ring_is_bounded_as_jax_bounds_it(bound, kept, tmp_path, monkeypatch):
    from anovos_tpu.obs import flight as jflight

    monkeypatch.setenv("ANOVOS_TPU_FLIGHTREC", bound)
    docs = []
    for fl, d in ((flight, tmp_path / "p"), (jflight, tmp_path / "j")):
        fl.configure(str(d))
        for i in range(100):
            fl.record("ev", i=i)
        docs.append(json.load(open(fl.dump("fatal_error", node="ring"))))
    assert len(docs[0]["events"]) == kept and docs[0]["events"][-1]["i"] == 99
    assert [(e["ev"], e["i"]) for e in docs[0]["events"]] == [(e["ev"], e["i"]) for e in docs[1]["events"]]


def test_dump_names_node_trigger_and_sanitizes_filename(tmp_path):
    flight.configure(str(tmp_path))
    flight.record("journal", event="node_begin", node="a/b", kind="timeout_retry")
    p = flight.dump("timeout_escalation", node="quality_checker/IDness detection",
                    inflight=[{"node": "a/b", "state": "running"}], queue_depth=3, extra={"why": "test"})
    assert os.path.basename(p) == "flightrec_quality_checker_IDness_detection.json"
    doc = json.load(open(p))
    assert doc["trigger"] == "timeout_escalation" and doc["node"] == "quality_checker/IDness detection"
    assert doc["queue_depth"] == 3 and doc["inflight"][0]["node"] == "a/b" and doc["extra"] == {"why": "test"}
    ev = doc["events"][0]
    assert ev["ev"] == "journal" and ev["kind"] == "timeout_retry"  # the type never clobbers a kind field
    assert "metrics" in doc and "spans_tail" in doc and p in flight.dump_paths()
    assert not glob.glob(str(tmp_path / "*.tmp.*"))


def test_second_trigger_same_node_never_overwrites(tmp_path):
    flight.configure(str(tmp_path))
    (tmp_path / "flightrec_quality_checker_dup_2.json").write_text("{}")  # an earlier run's
    p1 = flight.dump("timeout_escalation", node="quality_checker/dup")
    p2 = flight.dump("fatal_timeout", node="quality_checker/dup")
    assert [os.path.basename(p) for p in (p1, p2)] == ["flightrec_quality_checker_dup.json",
                                                        "flightrec_quality_checker_dup_3.json"]
    assert json.load(open(p1))["trigger"] == "timeout_escalation"
    assert json.load(open(p2))["trigger"] == "fatal_timeout"
    assert flight.dump_paths() == [p1, p2]
    assert (tmp_path / "flightrec_quality_checker_dup_2.json").read_text() == "{}"


def test_reconfigure_resets_dumps_and_ring(tmp_path):
    flight.configure(str(tmp_path / "a"))
    flight.record("x")
    flight.dump("fatal_error", node="n")
    assert flight.dump_paths()
    flight.configure(str(tmp_path / "b"))
    assert flight.dump_paths() == []
    assert json.load(open(flight.dump("fatal_error", node="n")))["events"] == []


def test_snapshot_keys_equal_jax(tmp_path):
    """``build_snapshot`` of both packages on the same arguments: the same
    keys at the top and in each in-flight entry, no named difference; the
    same trigger, node, queue depth, rendezvous holders, in-flight list,
    extra and event types; ``backend`` is each runtime's (``cpu`` both)."""
    from anovos_tpu.obs import flight as jflight

    args = dict(node="n", inflight=[{"node": "n", "state": "running", "lane": "host"}], queue_depth=2,
                rendezvous_holders=[], extra={"error": "boom"})
    docs = []
    for fl, d in ((flight, tmp_path / "p"), (jflight, tmp_path / "j")):
        fl.configure(str(d))
        fl.record("chaos", kind="exc", site="node:n")
        docs.append(fl.build_snapshot("fatal_error", **args))
    p, j = docs
    assert sorted(p) == sorted(j)
    for k in ("flightrec_version", "trigger", "node", "queue_depth", "rendezvous_holders", "inflight",
              "extra", "doctor", "backend"):
        assert p[k] == j[k], k
    assert [e["ev"] for e in p["events"]] == [e["ev"] for e in j["events"]] == ["chaos"]


# ---------------------------------------------------------------------------
# the scheduler's triggers
# ---------------------------------------------------------------------------

def test_fatal_node_failure_dumps_postmortem(tmp_path):
    flight.configure(str(tmp_path))

    def boom():
        raise RuntimeError("deliberate")

    sched = DagScheduler(name="t")
    sched.add("ok_node", lambda: None)
    sched.add("bad/node", boom, on_error="raise")
    with pytest.raises(RuntimeError):
        sched.run(mode="sequential")
    files = glob.glob(str(tmp_path / "flightrec_*.json"))
    assert [os.path.basename(f) for f in files] == ["flightrec_bad_node.json"]
    doc = json.load(open(files[0]))
    assert doc["trigger"] == "fatal_error" and doc["node"] == "bad/node"
    assert "deliberate" in doc["extra"]["error"]
    assert [e["node"] for e in doc["inflight"]] == ["bad/node"]


def test_clean_scheduler_run_dumps_nothing(tmp_path):
    flight.configure(str(tmp_path))
    sched = DagScheduler(name="t")
    sched.add("a", lambda: None)
    sched.add("b", lambda: None)
    sched.run(mode="concurrent", max_workers=2)
    assert glob.glob(str(tmp_path / "flightrec_*.json")) == []


def test_retrying_node_does_not_dump(tmp_path):
    flight.configure(str(tmp_path))
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("transient")

    sched = DagScheduler(name="t")
    sched.add("flaky", flaky, on_error="retry:2")
    sched.run(mode="sequential")
    assert glob.glob(str(tmp_path / "flightrec_*.json")) == []
    p = flight.dump("fatal_error", node="probe")
    assert any(e.get("ev") == "journal" and e.get("event") == "node_retry" for e in json.load(open(p))["events"])


@pytest.mark.parametrize("policy,hang,triggers,raises", [
    ("retry:0:degrade", "chaos", ["timeout_escalation", "node_abandoned"], None),
    ("raise", "chaos", ["timeout_escalation", "fatal_error"], "ChaosHang"),
    ("raise", "sleep", ["timeout_escalation", "fatal_timeout"], "NodeTimeout"),
])
def test_hang_escalates_then_dumps_again_under_another_name(policy, hang, triggers, raises, tmp_path):
    """A hang under a 0.3 s ``node_timeout`` in the concurrent mode: the
    escalation dumps with the node in flight, and the second trigger on
    the node dumps into ``_2``, never over the first.  A chaos ``hang`` on
    every attempt unwinds at the interrupt: a degrade node re-executes,
    hangs again past the escalated bound (x1.5) and is abandoned while the
    run goes on; a raise node fails at once (``fatal_error``).  A hang
    that ignores the interrupt (a 1.2 s sleep) blows the escalated bound
    and ends the run (``fatal_timeout``)."""
    import time

    from anovos_tpu_torch.resilience import chaos

    flight.configure(str(tmp_path))
    if hang == "chaos":
        chaos.install("hang@node:stuck:secs=30:n=99")
    sched = DagScheduler(name="t")
    sched.add("stuck", (lambda: None) if hang == "chaos" else (lambda: time.sleep(1.2)), on_error=policy)
    sched.add("after", lambda: None, reads=("x",))
    if raises:
        with pytest.raises(Exception) as err:
            sched.run(mode="concurrent", max_workers=2, node_timeout=0.3)
        assert type(err.value).__name__ == raises
    else:
        summary = sched.run(mode="concurrent", max_workers=2, node_timeout=0.3)
        assert summary["nodes"]["stuck"]["state"] == "degraded"
    paths = flight.dump_paths()
    assert [os.path.basename(p) for p in paths] == ["flightrec_stuck.json", "flightrec_stuck_2.json"]
    docs = [json.load(open(p)) for p in paths]
    assert [d["trigger"] for d in docs] == triggers
    assert [e["node"] for e in docs[0]["inflight"]] == ["stuck"]
    assert docs[0]["inflight"][0]["escalated"] is True and docs[0]["extra"]["factor"] == 1.5
    assert any(e.get("ev") == "chaos" for e in docs[0]["events"]) == (hang == "chaos")


def test_runner_names_its_dumps_as_jax_does(tmp_path, monkeypatch):
    """Both runners on the mini config, sequential, with a chaos ``exc`` on
    every attempt of the stats nodes under ``ANOVOS_TPU_RETRIES=0`` and
    ``ANOVOS_TPU_DEGRADE=0``: each
    aborts with the injected error and leaves one ``fatal_error`` dump of
    the same name, with the injection in its ring.  A clean run of the
    port names no dump in its manifest."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import obs
    from anovos_tpu_torch import workflow as pwf
    from test_torch_obs import mini_cfg, mini_parquet

    cfg = mini_cfg(mini_parquet(tmp_path))
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.setenv("ANOVOS_TPU_RETRIES", "0")
    monkeypatch.setenv("ANOVOS_TPU_DEGRADE", "0")
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "seed=1;exc@node:stats_generator/*:n=99")
    names = {}
    for name, wf in (("port", pwf), ("jax", jwf)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        with pytest.raises(Exception, match="chaos"):
            wf.main(copy.deepcopy(cfg), "local")
        dumps = sorted(glob.glob(str(d / "report_stats" / "obs" / "flightrec_*.json")))
        names[name] = [os.path.basename(p) for p in dumps]
        doc = json.load(open(dumps[0]))
        assert doc["trigger"] == "fatal_error" and any(e.get("ev") == "chaos" for e in doc["events"])
    assert names["port"] == names["jax"] and len(names["port"]) == 1
    monkeypatch.delenv("ANOVOS_TPU_CHAOS")
    monkeypatch.delenv("ANOVOS_TPU_TELEMETRY", raising=False)
    d = tmp_path / "clean"
    d.mkdir()
    monkeypatch.chdir(d)
    pwf.main(copy.deepcopy(cfg), "local")
    assert obs.load_manifest(pwf.LAST_MANIFEST_PATH)["resilience"]["flight_dumps"] == []
