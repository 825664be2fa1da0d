"""The port's continuum as a service on the CPU: the CLI
(``python -m anovos_tpu_torch.continuum run|step|status``), a mid-fold
kill and resume in fresh processes, heartbeats, the alert and poll
knobs, the service knobs of the live plane, the flight recorder's call sites,
and the runner's ``continuous_analysis`` block (with and without
``input_dataset``, and its failure policy against the JAX runner's).

The CLI runs in ``python -c`` subprocesses that call
``init_runtime("cpu")`` first: ``python -m anovos_tpu_torch.continuum``
asks for the card and exits at ``init_runtime`` without one.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pandas as pd
import pytest

from _torch_port import free_port, torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_continuum import _cfg, _fresh_registries, _journal, _tree_hash, _write_feed  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CLI = ("import sys; from anovos_tpu_torch.shared.runtime import init_runtime; init_runtime('cpu'); "
           "from anovos_tpu_torch.continuum.__main__ import main; sys.exit(main(sys.argv[1:]))")


def _run_cli(args, chaos=None, module=False):
    env = {**os.environ, "PYTHONPATH": REPO}
    for k in ("ANOVOS_TPU_CHAOS", "ANOVOS_TPU_TELEMETRY", "ANOVOS_TPU_TRACE_ROTATE"):
        env.pop(k, None)
    if chaos:
        env["ANOVOS_TPU_CHAOS"] = chaos
    cmd = ([sys.executable, "-m", "anovos_tpu_torch.continuum"] if module
           else [sys.executable, "-c", CPU_CLI])
    return subprocess.run(cmd + list(args), env=env, cwd=REPO, capture_output=True, text=True, timeout=300)


def test_midfold_kill_and_resume_no_redecode(tmp_path):
    """A chaos ``exc`` right after day-02's ``fold_commit`` kills the step
    (before its snapshot); a second process resumes: the artifact tree
    equals an uninterrupted run's, each part has exactly one
    ``fold_commit``, and one snapshot commits."""
    work = str(tmp_path)
    feed = os.path.join(work, "feed")
    _write_feed(feed, {i: {} for i in range(1, 5)})

    def cli(tag, chaos=None):
        return _run_cli(["step", "--json", "--dataset", feed, "--state-dir", os.path.join(work, tag, "state"),
                         "--output", os.path.join(work, tag, "out")], chaos=chaos)

    r = cli("ref")
    assert r.returncode == 0, r.stderr[-2000:]
    r = cli("crash", chaos="seed=1;exc@continuum:fold_committed:day-02*:n=1")
    assert r.returncode != 0 and "ChaosError" in r.stderr
    recs = _journal(os.path.join(work, "crash", "state"))
    assert [r["part"] for r in recs if r["event"] == "fold_commit"] == ["day-01.parquet", "day-02.parquet"]
    r = cli("crash")
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["folded"] == ["day-03.parquet", "day-04.parquet"]
    assert _tree_hash(os.path.join(work, "ref", "out")) == _tree_hash(os.path.join(work, "crash", "out"))
    recs = _journal(os.path.join(work, "crash", "state"))
    fc = Counter(r["part"] for r in recs if r.get("event") == "fold_commit")
    assert sorted(fc) == [f"day-0{i}.parquet" for i in range(1, 5)] and set(fc.values()) == {1}, fc
    assert sum(1 for r in recs if r.get("event") == "snapshot_commit") == 1


def test_cli_status_and_run_loop(tmp_path):
    work = str(tmp_path)
    feed = os.path.join(work, "feed")
    _write_feed(feed, {1: {}})
    dirs = ["--dataset", feed, "--state-dir", os.path.join(work, "state"), "--output", os.path.join(work, "out")]
    r = _run_cli(["run", "--json", "--max-iterations", "2", "--poll", "0", *dirs])
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["iterations"] == 2 and doc["last"]["folded"] == []
    r = _run_cli(["status", "--json", *dirs])
    assert r.returncode == 0, r.stderr[-2000:]
    st = json.loads(r.stdout.strip().splitlines()[-1])
    assert st["partitions"] == 1 and st["rows"] == 300 and st["last_snapshot"]
    assert st["last_step"]["folded"] == 0 and st["quarantined"] == []


def test_cli_step_without_a_card_exits_at_init_runtime(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is there: the CLI runs on it")
    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}})
    r = _run_cli(["step", "--dataset", feed, "--state-dir", str(tmp_path / "state"),
                  "--output", str(tmp_path / "out")], module=True)
    assert r.returncode != 0
    assert "init_runtime" in r.stderr and "is_available() is False" in r.stderr
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("knob,value", [("ANOVOS_TPU_TELEMETRY", "9464"), ("ANOVOS_TPU_TRACE_ROTATE", "30s")])
def test_run_refuses_the_unported_service_knobs(tmp_path, monkeypatch, knob, value):
    """The two service knobs are ported and ``run`` no longer refuses them:
    for the loop's lifetime it holds the live plane on the knob's port
    (its ``/healthz`` answers during the step) or the trace rotator (its
    thread runs during the step, and its final flush leaves a segment under
    ``<output>/obs``); after the loop neither a listener nor a thread of
    either is left."""
    import threading
    import urllib.request

    from anovos_tpu_torch.continuum import watcher
    from anovos_tpu_torch.obs import telemetry

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}})
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False)
    if knob == "ANOVOS_TPU_TELEMETRY":
        value = str(free_port())  # a port the OS picks, not the case's label
    monkeypatch.setenv(knob, value)
    seen = {}
    step = watcher.step

    def observed(c):
        srv = telemetry.current()
        if srv is not None:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz", timeout=10) as r:
                seen["healthz"] = (srv.port, r.status)
        seen["threads"] = {t.name for t in threading.enumerate()}
        return step(c)

    monkeypatch.setattr(watcher, "step", observed)
    before = {t.name for t in threading.enumerate()}
    assert len(watcher.run(cfg, max_iterations=1)) == 1
    if knob == "ANOVOS_TPU_TELEMETRY":
        assert seen["healthz"] == (int(value), 200)
        assert "anovos-torch-telemetry" in seen["threads"]
    else:
        assert "anovos-torch-trace-rotator" in seen["threads"]
        assert sorted(os.listdir(os.path.join(cfg.output_path, "obs"))) == ["trace_0001.json"]
    assert telemetry.current() is None
    assert {t.name for t in threading.enumerate()} == before


def test_one_shot_steps_register_no_heartbeat(tmp_path, monkeypatch):
    """``step`` never registers a beat; ``run`` beats around each step,
    its fold refreshes the beat, and a clean exit clears it."""
    from anovos_tpu_torch.continuum import watcher
    from anovos_tpu_torch.obs import telemetry

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}})
    cfg = _cfg(str(tmp_path), "t", feed_dir=feed, drift=False)
    assert watcher.step(cfg)["folded"] == ["day-01.parquet", "day-02.parquet"]
    assert telemetry.heartbeat_ages() == {}
    _write_feed(feed, {3: {}}, rng_seed=3)
    seen = []
    orig = telemetry.refresh_heartbeat

    def refresh(name):
        seen.append(dict(telemetry.heartbeat_ages()))
        orig(name)

    monkeypatch.setattr(telemetry, "refresh_heartbeat", refresh)
    out = watcher.run(cfg, max_iterations=1)
    assert out[0]["folded"] == ["day-03.parquet"]
    assert seen and all(s.get(watcher.HEARTBEAT, {}).get("interval_s") == 30.0 for s in seen)
    assert telemetry.heartbeat_ages() == {}


def test_alerts_knob_disables_emission(tmp_path, monkeypatch):
    from anovos_tpu_torch.continuum import alerts

    monkeypatch.setenv("ANOVOS_CONTINUUM_ALERTS", "0")
    assert alerts.emit([{"kind": "drift", "partition": "p"}], str(tmp_path), None) == []
    assert not os.path.exists(os.path.join(str(tmp_path), "continuum_alerts.jsonl"))
    monkeypatch.setenv("ANOVOS_CONTINUUM_ALERTS", "1")
    out = alerts.emit([{"kind": "drift", "partition": "p"}], str(tmp_path), None)
    assert len(out) == 1 and os.path.exists(os.path.join(str(tmp_path), "continuum_alerts.jsonl"))


def test_poll_seconds_env_override(monkeypatch):
    from anovos_tpu.continuum.watcher import poll_seconds as jpoll
    from anovos_tpu_torch.continuum.watcher import poll_seconds

    for raw in (None, "2.5", "junk", "-3"):
        if raw is None:
            monkeypatch.delenv("ANOVOS_CONTINUUM_POLL_S", raising=False)
        else:
            monkeypatch.setenv("ANOVOS_CONTINUUM_POLL_S", raw)
        assert poll_seconds(30.0) == jpoll(30.0)
    monkeypatch.setenv("ANOVOS_CONTINUUM_POLL_S", "2.5")
    assert poll_seconds(30.0) == 2.5


def test_flight_ring_records_journal_chaos_and_quarantine(tmp_path, monkeypatch):
    """The three call sites of the flight recorder: every journal append,
    every chaos injection and every part the guard quarantines land in the
    ring, as in the JAX package; ``ANOVOS_TPU_FLIGHTREC=0`` disarms it."""
    from anovos_tpu_torch.cache.journal import RunJournal
    from anovos_tpu_torch.data_ingest.data_ingest import read_host_frame
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import chaos

    flight.configure(str(tmp_path / "obs"))
    RunJournal(str(tmp_path / "j.jsonl")).append("fold_commit", part="p", rows=3)
    chaos.install("exc@continuum:fold_committed:p")
    with pytest.raises(chaos.ChaosError):
        chaos.chaos_point("continuum:fold_committed:p")
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(b"NOTPARQUET" * 10)
    good = tmp_path / "good.parquet"
    pd.DataFrame({"a": [1.0, 2.0]}).to_parquet(good)
    assert len(read_host_frame([str(bad), str(good)], "parquet", {})) == 2
    ev = flight.snapshot_events()
    assert ev[0]["ev"] == "journal" and ev[0]["event"] == "fold_commit" and ev[0]["part"] == "p"
    assert {"ev": "chaos", "kind": "exc", "site": "continuum:fold_committed:p"}.items() <= ev[1].items()
    assert ev[-1]["ev"] == "quarantine" and ev[-1]["file"] == "bad.parquet"
    monkeypatch.setenv("ANOVOS_TPU_FLIGHTREC", "0")
    flight.configure(str(tmp_path / "obs"))
    flight.record("journal", event="x")
    assert not flight.enabled() and flight.snapshot_events() == []


# ---------------------------------------------------------------------------
# the runner's continuous_analysis block
# ---------------------------------------------------------------------------
def _continuum_config(work, feed, **extra):
    return {"continuous_analysis": {"dataset_path": feed, "state_dir": os.path.join(work, "state"),
                                    "output_path": os.path.join(work, "out")},
            "report_preprocessing": {"master_path": os.path.join(work, "rep")}, **extra}


def test_workflow_node_without_input_dataset_matches_jax(tmp_path, monkeypatch):
    """No ``input_dataset``: both runners read no Table and run one step;
    the artifacts agree (missing and categorical byte-equal, stats in
    the moment bands) and the block's wall is logged."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow as pwf
    from test_torch_continuum import _assert_stats_close

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}, 2: {}})
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    outs = {}
    for tag, wf in (("port", pwf), ("jax", jwf)):
        work = os.path.join(str(tmp_path), tag)
        os.makedirs(work)
        monkeypatch.chdir(work)
        wf.main(_continuum_config(work, feed), "local")
        outs[tag] = os.path.join(work, "out")
        assert os.path.exists(os.path.join(outs[tag], "continuum_stats.csv"))
        assert os.path.exists(os.path.join(outs[tag], "continuum_report.html"))
    assert "continuous_analysis" in pwf.block_times() and pwf.degraded_sections() == {}
    assert "continuous_analysis/step" in jwf.LAST_RUN_SUMMARY.get("nodes", {})
    for name in ("continuum_missing.csv", "continuum_categorical.csv"):
        with open(os.path.join(outs["port"], name)) as a, open(os.path.join(outs["jax"], name)) as b:
            assert a.read() == b.read(), name
    _assert_stats_close(pd.read_csv(os.path.join(outs["port"], "continuum_stats.csv")),
                        pd.read_csv(os.path.join(outs["jax"], "continuum_stats.csv")))


def test_workflow_node_beside_an_input_dataset(tmp_path, monkeypatch):
    """With ``input_dataset``, the Table's blocks run and the continuum
    step runs beside them, its paths resolved against the master path."""
    from anovos_tpu_torch import workflow

    work = str(tmp_path)
    feed = os.path.join(work, "feed")
    _write_feed(feed, {1: {}, 2: {}})
    monkeypatch.chdir(work)
    cfg = {"input_dataset": {"read_dataset": {"file_path": os.path.join(feed, "day-01.parquet"),
                                              "file_type": "parquet"}},
           "stats_generator": {"metric": ["measures_of_counts"], "metric_args": {"list_of_cols": "all"}},
           "continuous_analysis": {"dataset_path": feed, "state_dir": "cstate", "output_path": "cout"},
           "report_preprocessing": {"master_path": os.path.join(work, "rep")}}
    workflow.main(cfg, "local")
    assert os.path.exists(os.path.join(work, "rep", "measures_of_counts.csv"))
    assert os.path.exists(os.path.join(work, "rep", "cout", "continuum_stats.csv"))
    assert os.path.exists(os.path.join(work, "rep", "cstate", "state_manifest.json"))
    assert set(workflow.block_times()) >= {"stats_generator, measures_of_counts", "continuous_analysis"}


def test_workflow_node_failure_policy_matches_jax(tmp_path, monkeypatch):
    """The JAX runner's policy for this node: one more attempt after a
    failure (``ANOVOS_TPU_RETRIES``, default 1), then the section
    degrades as ``continuous_analysis/step`` and the run completes;
    ``ANOVOS_TPU_DEGRADE=0`` raises instead.  A fault that fires once is
    absorbed by the retry, which resumes from the committed partitions."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu.resilience import policy as jpol
    from anovos_tpu_torch import workflow as pwf
    from anovos_tpu_torch.resilience.chaos import ChaosError

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {i: {} for i in range(1, 5)})
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    # every fold commit raises: attempt 1 commits day 1, attempt 2 day 2
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "exc@continuum:fold_committed:*:n=99")
    degraded = {}
    for tag, wf, reg in (("port", pwf, pwf.degraded_sections), ("jax", jwf, jpol.degraded_sections)):
        work = os.path.join(str(tmp_path), "always", tag)
        os.makedirs(work)
        monkeypatch.chdir(work)
        wf.main(_continuum_config(work, feed), "local")
        degraded[tag] = sorted(reg())
        commits = [r["part"] for r in _journal(os.path.join(work, "state")) if r["event"] == "fold_commit"]
        assert commits == ["day-01.parquet", "day-02.parquet"], (tag, commits)
    assert degraded["port"] == degraded["jax"] == ["continuous_analysis/step"]

    work = os.path.join(str(tmp_path), "raise")
    os.makedirs(work)
    monkeypatch.chdir(work)
    monkeypatch.setenv("ANOVOS_TPU_DEGRADE", "0")
    with pytest.raises(ChaosError):
        pwf.main(_continuum_config(work, feed), "local")

    monkeypatch.delenv("ANOVOS_TPU_DEGRADE")
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "exc@continuum:fold_committed:day-02*:n=1")
    work = os.path.join(str(tmp_path), "once")
    os.makedirs(work)
    monkeypatch.chdir(work)
    pwf.main(_continuum_config(work, feed), "local")
    assert pwf.degraded_sections() == {}
    fc = Counter(r["part"] for r in _journal(os.path.join(work, "state")) if r["event"] == "fold_commit")
    assert sorted(fc) == [f"day-0{i}.parquet" for i in range(1, 5)] and set(fc.values()) == {1}
    assert np.isfinite(pd.read_csv(os.path.join(work, "out", "continuum_stats.csv"))["mean"]).all()


@pytest.mark.parametrize("fails,degrade", [(1, "1"), (99, "1"), (99, "0")])
def test_fanout_section_policy_matches_jax(tmp_path, monkeypatch, fails, degrade):
    """Every fan-out section shares the continuum step's policy, as in the
    JAX runner: a stats metric that fails once is absorbed by the retry,
    one that keeps failing degrades as ``stats_generator/<metric>`` after
    two attempts, and ``ANOVOS_TPU_DEGRADE=0`` raises instead."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu.data_analyzer import stats_generator as jsg
    from anovos_tpu.resilience import policy as jpol
    from anovos_tpu_torch import workflow as pwf
    from anovos_tpu_torch.data_analyzer import stats_generator as psg

    feed = os.path.join(str(tmp_path), "feed")
    _write_feed(feed, {1: {}})
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.setenv("ANOVOS_TPU_DEGRADE", degrade)
    for tag, wf, sg, reg in (("port", pwf, psg, pwf.degraded_sections),
                             ("jax", jwf, jsg, jpol.degraded_sections)):
        calls = []
        real = sg.measures_of_counts

        def flaky(*a, real=real, calls=calls, **k):
            calls.append(1)
            if len(calls) <= fails:
                raise RuntimeError("injected")
            return real(*a, **k)

        monkeypatch.setattr(sg, "measures_of_counts", flaky)
        work = os.path.join(str(tmp_path), tag)
        os.makedirs(work)
        monkeypatch.chdir(work)
        cfg = {"input_dataset": {"read_dataset": {"file_path": os.path.join(feed, "day-01.parquet"),
                                                  "file_type": "parquet"}},
               "stats_generator": {"metric": ["measures_of_counts"], "metric_args": {"list_of_cols": "all"}},
               "report_preprocessing": {"master_path": os.path.join(work, "rep")}}
        if degrade == "0":
            with pytest.raises(RuntimeError, match="injected"):
                wf.main(cfg, "local")
            assert len(calls) == 2, tag
            continue
        wf.main(cfg, "local")
        assert len(calls) == 2, tag
        wrote = os.path.exists(os.path.join(work, "rep", "measures_of_counts.csv"))
        if fails == 1:
            assert sorted(reg()) == [] and wrote, tag
        else:
            assert sorted(reg()) == ["stats_generator/measures_of_counts"] and not wrote, tag


def test_chip_smoke_phase_14_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py phases 13 and 14 at 4 target and 2 source parts of
    20,000 rows on the CPU: the CUDA calls stubbed, the plain kernel
    versions wrapped to count launches (they count none), the CLI of (e)
    run on the CPU; every check of phase 14 runs, and the launches are
    those the card must show: B1 and B2 once a part in the catch-up (the
    baseline's re-decode launches B2), once each for the arrival."""
    import torch

    import chip_smoke as cs
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.ops.kernels import histogram, moments
    from examples._data import synthesize

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "kernel_times", lambda torch, fn, cold=False, iters=0, reps=0:
                        (fn(), {"min": 0.0, "median": 0.0, "max": 0.0, "repeats": []})[1])
    monkeypatch.setattr(cs, "cuda_ms", lambda torch, fn, iters: (fn(), 0.0)[1])
    for mod, attr, kname in ((moments, "masked_moments_plain", "masked_moments"),
                             (histogram, "binned_histograms_plain", "binned_histograms")):
        plain = getattr(mod, attr)

        def counted(*a, plain=plain, kname=kname):
            kernels.LAUNCHES[kname] += 1
            return plain(*a)

        monkeypatch.setattr(mod, attr, counted)
    monkeypatch.setattr(cs, "STREAM_PARTS", 4)
    monkeypatch.setattr(cs, "STREAM_SRC_PARTS", 2)
    monkeypatch.setattr(cs, "STREAM_PART_ROWS", 20_000)
    monkeypatch.setattr(cs, "STREAM_CHUNK", 20_000)
    monkeypatch.setattr(cs, "CONTINUUM_CLI", (sys.executable, "-c", CPU_CLI))
    monkeypatch.delenv("ANOVOS_TPU_CHAOS", raising=False)
    df = synthesize(80_000, seed=0).drop(columns=cs.DROP)
    stream = cs.phase_streaming(torch, 0, df, str(tmp_path))
    out = cs.phase_continuum(torch, 0, df, stream.pop("feed"), str(tmp_path))
    assert out["launches"]["a"] == {"masked_moments": 6, "binned_histograms": 6, "neighbor_counts": 0}
    assert out["launches"]["b"] == {"masked_moments": 1, "binned_histograms": 1, "neighbor_counts": 0}
    assert out["path_launches"] == {"masked_moments": 7, "binned_histograms": 7, "neighbor_counts": 0}
    assert out["model"]["frequency_files"] == 18 and out["drift_max_abs_err"] <= 1e-4
    assert out["arrival_alerts"] >= 1
