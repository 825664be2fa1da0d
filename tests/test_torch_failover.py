"""The port's backend failover (``anovos_tpu_torch/resilience/failover.py``,
the scheduler's failover half, the runner's df versions after a flip,
``resilience/scenarios.py``) against the JAX package's, case by case as
``tests/test_resilience.py`` and ``tests/test_flight.py`` hold the JAX one:

* the journal's ``node_retry`` and ``backend_failover`` records; the probe
  healthy on the CPU and unhealthy under a simulated wedge; a wedge that
  flips once, clears and re-executes its node; a raise-mode node that
  takes no re-execution while the run still flips; ordinary errors that
  never pay a probe (each with the same counters, attempts, events and
  ``failover_count()`` as JAX's);
* the probe's deadline: a dispatch that hangs answers False within
  ``ANOVOS_TPU_HEALTH_TIMEOUT`` and leaves its named thread behind;
* the runner: a wedge's ``backend_failover`` dump, named as JAX names it;
  ``/healthz``'s ``backend.failovers`` after a flip; a df version committed
  before the flip re-placed on the live runtime's device;
* the ``wedge`` and ``full`` scenarios against ``tools.chaos_run`` on the
  same synthetic config, and the scenario CLI.

``_torch_port.failover_isolated`` resets both packages after every test
and asserts that no flip, wedge or ``anovos-torch-*`` thread outlives it.
"""

import copy
import json
import threading
import time

import pytest

from _torch_port import failover_isolated, thread_names, torch_cpu_runtime  # noqa: F401


@pytest.fixture(autouse=True)
def _isolated(failover_isolated):  # noqa: F811
    from anovos_tpu.resilience import chaos as jchaos
    from anovos_tpu.resilience import failover as jfailover
    from anovos_tpu_torch.resilience import chaos, failover

    for mod in (chaos, jchaos, failover, jfailover):
        mod.reset()
    yield


def _packages():
    """(name, scheduler module, chaos, failover, cache) of each package."""
    from anovos_tpu import cache as jcache
    from anovos_tpu.parallel import scheduler as jsched
    from anovos_tpu.resilience import chaos as jchaos
    from anovos_tpu.resilience import failover as jfailover
    from anovos_tpu_torch import cache
    from anovos_tpu_torch.parallel import scheduler
    from anovos_tpu_torch.resilience import chaos, failover

    return (("jax", jsched, jchaos, jfailover, jcache), ("port", scheduler, chaos, failover, cache))


# ------------------------------------------------------------ scheduler ----
def test_node_retry_and_failover_events_land_in_journal(tmp_path):
    got = {}
    for name, sched, chaos, _, cache in _packages():
        journal = cache.RunJournal(str(tmp_path / f"{name}.jsonl"))
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")

        chaos.install("wedge@node:wedgy")
        s = sched.DagScheduler(journal=journal)
        s.add("flaky", flaky, on_error="retry:1")
        s.add("wedgy", lambda: None, on_error="retry:0")
        summary = s.run(mode="sequential")
        recs = cache.read_journal(journal.path)
        got[name] = ([(r["event"], r.get("node"), r.get("kind"), r.get("attempt")) for r in recs],
                     {k: summary["resilience"][k] for k in ("retries", "failover_retries", "failovers")})
        chaos.reset()
    assert got["port"] == got["jax"]
    events, res = got["port"]
    assert ("node_retry", "flaky", "retry", 1) in events and ("backend_failover", None, None, None) in events
    assert res == {"retries": 2, "failover_retries": 1, "failovers": 1}


def test_probe_in_process_healthy_on_cpu():
    from anovos_tpu.shared.backend_probe import probe_in_process as jprobe
    from anovos_tpu_torch.resilience.failover import probe_in_process

    assert probe_in_process(60.0) is True and jprobe(60.0) is True


def test_backend_healthy_false_under_simulated_wedge():
    for _, _, chaos, failover, _ in _packages():
        chaos.set_wedged()
        assert failover.backend_healthy() is False
        chaos.clear_wedge()
        assert failover.backend_healthy() is True


def test_wedge_flips_once_and_clears():
    from anovos_tpu_torch.shared.runtime import get_runtime, runtime_generation

    gen = runtime_generation()
    got = {}
    for name, sched, chaos, failover, _ in _packages():
        chaos.install("wedge@node:w")
        ran = []
        s = sched.DagScheduler()
        # retry:0: no policy budget; the post-failover re-execution is the
        # budget-free grant a retry-mode node gets
        s.add("w", lambda: ran.append(1), on_error="retry:0")
        summary = s.run(mode="sequential")
        again = failover.maybe_failover(RuntimeError(
            "XlaRuntimeError: x" if name == "jax" else "CUDA error: an illegal memory access was encountered"))
        got[name] = (ran, summary["resilience"]["failovers"], summary["resilience"]["failover_retries"],
                     summary["nodes"]["w"]["attempts"], chaos.backend_wedged(), again, failover.failover_count())
    assert got["port"] == got["jax"] == ([1], 1, 1, 2, False, False, 1)
    # the flip is an init_runtime("cpu"): the generation moved
    assert get_runtime().device.type == "cpu" and runtime_generation() == gen + 1


def test_raise_mode_node_opts_out_of_all_reexecution():
    """A node registered on_error='raise' takes no re-execution of any
    kind; the run-level flip still happens."""
    got = {}
    for name, sched, chaos, failover, _ in _packages():
        chaos.install("wedge@node:w")
        calls = {"n": 0}

        def body():
            calls["n"] += 1

        s = sched.DagScheduler()
        s.add("w", body, on_error="raise")
        with pytest.raises(chaos.BackendWedge):
            s.run(mode="sequential")
        got[name] = (calls["n"], s._by_name["w"].attempts, failover.failover_count())
    assert got["port"] == got["jax"] == (0, 1, 1)


def test_ordinary_errors_never_pay_a_probe(monkeypatch):
    got = {}
    for name, _, _, failover, _ in _packages():
        probed = []
        monkeypatch.setattr(failover, "backend_healthy", lambda *a, **k: probed.append(1) or True)
        shaped = "XlaRuntimeError: dead" if name == "jax" else "CUDA error: unspecified launch failure"
        got[name] = (failover.maybe_failover(ValueError("plain config error")), list(probed),
                     failover.maybe_failover(RuntimeError(shaped)), list(probed), failover.failover_count())
    assert got["port"] == got["jax"] == (False, [], False, [1], 0)


@pytest.mark.parametrize("text", ["RuntimeError: CUDA error: device-side assert triggered",
                                  "cudaErrorLaunchFailure", "CUBLAS_STATUS_EXECUTION_FAILED",
                                  "AcceleratorError: an illegal memory access was encountered"])
def test_cuda_shaped_errors_pay_one_probe(text, monkeypatch):
    from anovos_tpu_torch.resilience import failover

    probed = []
    monkeypatch.setattr(failover, "backend_healthy", lambda *a, **k: probed.append(1) or True)
    assert failover.maybe_failover(RuntimeError(text)) is False and probed == [1]


def test_probe_deadline_answers_false_and_leaves_its_thread_named(monkeypatch):
    """A dispatch that hangs: both probes answer False within their
    deadline (here ``ANOVOS_TPU_HEALTH_TIMEOUT=0.2``) and leave their thread
    running, the port's named ``anovos-torch-health-probe``."""
    from anovos_tpu.resilience import failover as jfailover
    from anovos_tpu.shared import backend_probe
    from anovos_tpu_torch.resilience import failover

    release = threading.Event()
    monkeypatch.setattr(failover, "_dispatch", lambda device: release.wait(30))
    monkeypatch.setattr(backend_probe, "_inproc_probe_fn", lambda: (lambda x: release.wait(30) and x + 1.0))
    monkeypatch.setenv("ANOVOS_TPU_HEALTH_TIMEOUT", "0.2")
    try:
        for fo, thread in ((failover, "anovos-torch-health-probe"), (jfailover, "backend-health-probe")):
            t0 = time.monotonic()
            assert fo.backend_healthy() is False
            assert time.monotonic() - t0 < 2.0
            assert thread in thread_names()
    finally:
        release.set()


def test_flip_counts_clears_and_records_once(tmp_path):
    """The flip without a journal, once: the wedge cleared, the counter as
    JAX's, and the ``backend_failover`` record in the flight ring in the
    shape a journal append records it."""
    from anovos_tpu.obs import flight as jflight
    from anovos_tpu.obs import get_metrics as jmetrics
    from anovos_tpu.resilience import chaos as jchaos
    from anovos_tpu.resilience import failover as jfailover
    from anovos_tpu_torch.obs import flight, get_metrics
    from anovos_tpu_torch.resilience import chaos, failover

    flight.configure(str(tmp_path / "p"))
    jflight.configure(str(tmp_path / "j"))
    counts = []
    for reg, ch, fo in ((get_metrics(), chaos, failover), (jmetrics(), jchaos, jfailover)):
        reg.reset()
        ch.set_wedged()
        assert fo.failover_to_cpu("test wedge") is True and fo.failover_to_cpu("again") is False
        assert not ch.backend_wedged() and fo.failover_count() == 1
        counts.append(reg.snapshot()["backend_failovers_total"]["series"])
    assert counts[0] == counts[1] and list(counts[0].values()) == [1]
    events = [e for e in flight.snapshot_events() if e.get("event") == "backend_failover"]
    assert [(e["ev"], e["reason"]) for e in events] == [("journal", "test wedge")]


# --------------------------------------------------------------- runner ----
def test_wedge_leaves_failover_postmortem(tmp_path, monkeypatch):
    """``tests/test_flight.py``'s wedge case through both runners."""
    from tools.chaos_run import synthetic_config

    from anovos_tpu import obs as jobs
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import obs as pobs
    from anovos_tpu_torch import workflow as pwf

    cfg = synthetic_config(str(tmp_path))
    monkeypatch.delenv("ANOVOS_TPU_CACHE", raising=False)
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "seed=7;wedge@node:drift_detector/*")
    got = {}
    for name, wf, ob in (("jax", jwf, jobs), ("port", pwf, pobs)):
        rundir = tmp_path / name
        rundir.mkdir()
        monkeypatch.chdir(rundir)
        wf.main(copy.deepcopy(cfg), "local")
        man = ob.load_manifest(wf.LAST_MANIFEST_PATH)
        dumps = man["resilience"]["flight_dumps"]
        doc = json.load(open(str(rundir / "report_stats" / "obs" / dumps[0])))
        got[name] = (dumps, doc["trigger"], doc["node"],
                     any(e.get("ev") == "chaos" and e.get("kind") == "wedge" for e in doc["events"]),
                     doc["extra"]["pre_flip"]["backend"], doc["extra"]["pre_flip"]["wedged"],
                     "resilience" in ob.stable_view(man),
                     {k: man["resilience"][k] for k in ("failovers", "failover_retries", "degraded")},
                     man["scheduler"]["nodes"]["drift_detector/drift_statistics"]["attempts"])
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (["flightrec_drift_detector_drift_statistics.json"], "backend_failover",
                               "drift_detector/drift_statistics", True)


def test_healthz_backend_failovers_after_a_flip():
    """``/healthz``'s ``backend`` section: the flips of this run, which make
    the run degraded, in both packages."""
    from anovos_tpu.obs import telemetry as jtelemetry
    from anovos_tpu_torch.obs import telemetry

    docs = []
    for _, _, _, failover, _ in _packages():
        assert failover.failover_to_cpu("test wedge")
    for tel in (telemetry, jtelemetry):
        doc = tel.health()
        docs.append((doc["backend"], doc["status"] != "ok",
                     [r for r in doc.get("reasons", []) if "failed over" in r]))
    assert docs[0] == docs[1] == ({"wedged": False, "failovers": 1}, True,
                                  ["backend failed over to CPU 1x this run"])


def test_df_version_from_before_the_flip_is_replaced_on_the_live_device(monkeypatch):
    """A df version committed on one device reaches its next reader on the
    live runtime's device, moved once (an exact copy: same columns, kinds,
    dtype names and vocabularies); ``Table.to`` of the device a Table is on
    is the Table itself.  The live runtime here is torch's ``meta`` device,
    standing in for the CPU a card flips to."""
    import torch

    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.shared.artifact_store import AsyncArtifactWriter
    from anovos_tpu_torch.shared.runtime import Runtime
    from anovos_tpu_torch.shared.table import Table
    from _torch_port import income_frame

    t = Table.from_pandas(income_frame(64), device="cpu")
    assert t.to("cpu") is t
    writer = AsyncArtifactWriter(workers=1, sync=True)
    pipe = workflow._PipelineRun(workflow.DagScheduler(), writer, t)
    assert pipe._resolve(0) is t
    monkeypatch.setattr(workflow, "peek_runtime", lambda: Runtime(device=torch.device("meta")))
    moved = pipe._resolve(0)
    assert moved is not t and moved.device.type == "meta" and pipe._resolve(0) is moved
    assert moved.nrows == t.nrows and moved.dtypes() == t.dtypes()
    for name, c in t.columns.items():
        m = moved.columns[name]
        assert (m.kind, m.data.dtype, m.mask.dtype, m.vocab is c.vocab) == (c.kind, c.data.dtype, c.mask.dtype, True)
        assert m.data.device.type == m.mask.device.type == "meta"
    assert workflow._on_live_device(None) is None
    writer.close()


# ------------------------------------------------------------ scenarios ----
@pytest.mark.parametrize("scenario", ["wedge", "full"])
def test_scenario_matches_tools_chaos_run(scenario, tmp_path):
    from tools.chaos_run import run_scenario as jrun

    from anovos_tpu_torch.resilience import scenarios

    got = scenarios.run_scenario(scenario, str(tmp_path / "port"))
    exp = jrun(scenario, str(tmp_path / "jax"))

    def outcome(r):
        return (r["ok"], r["injections"], r["resilience"]["failovers"], r["degraded"],
                sorted((d["trigger"], d["node"]) for d in r["flightrec"]), r["parity"], r["clean_flightrec"])

    assert outcome(got) == outcome(exp), (got, exp)
    assert got["ok"] and got["failovers"] == 1 and got["cpu_parity_files"] == 0
    assert got["post_flip_nodes"] == ["drift_detector/drift_statistics"]
    assert scenarios.tree_hash(tmp_path / "port" / "chaos") == scenarios.tree_hash(tmp_path / "port" / "clean")


def test_scenario_cli_on_the_cpu(tmp_path, capsys):
    from anovos_tpu_torch.resilience import scenarios

    rc = scenarios.main(["--scenario", "wedge", "--json", "--device", "cpu", "--workdir", str(tmp_path)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["ok"] and res["injections"] == 1 and res["failovers"] == 1 and res["parity"]
    assert [(d["trigger"], d["node"]) for d in res["flightrec"]] == [
        ("backend_failover", "drift_detector/drift_statistics")]
