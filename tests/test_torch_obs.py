"""The port's run record (``anovos_tpu_torch.obs``), case by case as
``tests/test_obs.py`` holds the JAX package's:

* ``Tracer`` spans nest (parent recorded), survive concurrent recording
  from many threads, and export valid Chrome-trace JSON;
* the DAG scheduler emits one node span per executed node with its deps
  and queue wait, and books node wall/queue-wait histograms;
* ``MetricsRegistry`` snapshots are deterministic (sorted, rounded);
* ``timed()`` separates a signature's first call from its later calls,
  counting the later ones, with torch tensors keyed by (shape, dtype);
* the run manifest round-trips, serializes byte-stably, and two
  sequential-mode runs of one config agree under ``stable_view`` while
  naming every executed node;
* ``ANOVOS_TPU_TRACE`` gates the trace export, and the report's Run
  Timings tab renders from a manifest and is absent without one.

The Prometheus text exposition is held against the JAX package's in
``tests/test_torch_telemetry.py``.  Everything runs on the CPU runtime.
"""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from anovos_tpu_torch import obs
from anovos_tpu_torch.parallel.scheduler import DagScheduler


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_span_nesting_records_parent():
    tr = obs.Tracer(buffer=1000)
    with tr.span("outer"):
        with tr.span("middle"):
            with tr.span("inner"):
                pass
    spans = {s.name: s for s in tr.snapshot()}
    assert spans["inner"].args["parent"] == "middle"
    assert spans["middle"].args["parent"] == "outer"
    assert "parent" not in spans["outer"].args
    assert [s.name for s in tr.snapshot()] == ["inner", "middle", "outer"]


def test_tracer_thread_safety_under_concurrent_recording():
    tr = obs.Tracer(buffer=10_000)
    done = threading.Barrier(8)

    def work(i):
        for _ in range(50):
            with tr.span("outer", idx=i):
                with tr.span("inner"):
                    pass
        done.wait()  # every thread alive until all have recorded: 8 idents

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = tr.snapshot()
    assert len(spans) == 8 * 50 * 2
    assert all(s.args["parent"] == "outer" for s in spans if s.name == "inner")
    # one lane per thread in the export
    doc = tr.to_chrome()
    lanes = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert len(lanes) == 8


def test_tracer_buffer_bounded():
    tr = obs.Tracer(buffer=10)
    for i in range(25):
        tr.instant(f"e{i}")
    assert len(tr.snapshot()) == 10
    assert tr.dropped == 15
    assert [s.name for s in tr.snapshot()] == [f"e{i}" for i in range(15, 25)]


def test_span_records_error_and_reraises():
    tr = obs.Tracer(buffer=10)
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")
    (sp,) = tr.snapshot()
    assert sp.args["error"] == "ValueError"


def test_chrome_trace_schema(tmp_path):
    tr = obs.Tracer(buffer=100)
    with tr.span("a", cat="node", deps=["x"], n=1):
        tr.instant("marker")
    path = tr.export(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert metas and all(e["name"] == "thread_name" for e in metas)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 1
    (x,) = xs
    for key in ("name", "cat", "ts", "dur", "pid", "tid"):
        assert key in x, key
    assert x["args"]["deps"] == ["x"]
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert len(instants) == 1 and "dur" not in instants[0]


def test_trace_destination_env(monkeypatch):
    monkeypatch.delenv("ANOVOS_TPU_TRACE", raising=False)
    assert obs.trace_destination("/base") is None
    monkeypatch.setenv("ANOVOS_TPU_TRACE", "0")
    assert obs.trace_destination("/base") is None
    monkeypatch.setenv("ANOVOS_TPU_TRACE", "1")
    assert obs.trace_destination("/base") == os.path.join("/base", "obs", "trace.json")
    monkeypatch.setenv("ANOVOS_TPU_TRACE", "/tmp/custom.json")
    assert obs.trace_destination("/base") == "/tmp/custom.json"


# ---------------------------------------------------------------------------
# scheduler integration
# ---------------------------------------------------------------------------

def test_scheduler_emits_node_spans_with_deps_and_queue_wait():
    obs.get_tracer().clear()
    obs.get_metrics().reset()
    s = DagScheduler(name="obs-test")
    s.add("producer", lambda: None, writes=("r",))
    s.add("consumer", lambda: None, reads=("r",))
    summary = s.run(mode="concurrent", max_workers=2, node_timeout=30)
    node_spans = {sp.name: sp for sp in obs.get_tracer().snapshot() if sp.cat == "node"}
    assert set(node_spans) == {"producer", "consumer"}
    assert node_spans["consumer"].args["deps"] == ["producer"]
    assert node_spans["consumer"].args["queue_wait_s"] >= 0.0
    assert node_spans["consumer"].args["scheduler"] == "obs-test"
    assert node_spans["consumer"].args["lane"] == "host"
    snap = obs.get_metrics().snapshot()
    assert snap["node_wall_seconds"]["series"]['node="consumer"']["count"] == 1
    assert snap["node_queue_wait_seconds"]["series"]['node="producer"']["count"] == 1
    assert summary["nodes"]["consumer"]["deps"] == ["producer"]
    assert summary["nodes"]["consumer"]["queue_wait_s"] is not None


def test_scheduler_sequential_spans_cover_wall():
    """Sequential mode runs everything on one lane: node durations sum to
    ≤ the wall and each is > 0."""
    import time

    obs.get_tracer().clear()
    s = DagScheduler()
    for i in range(3):
        s.add(f"n{i}", lambda: time.sleep(0.01))
    summary = s.run(mode="sequential")
    durs = [n["dur_s"] for n in summary["nodes"].values()]
    assert all(d is not None and d > 0 for d in durs)
    assert sum(durs) <= summary["wall_s"] + 1e-6


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_registry_counter_gauge_histogram():
    reg = obs.MetricsRegistry()
    reg.counter("c", "help!").inc(2, k="a")
    reg.counter("c").inc(3, k="a")
    reg.gauge("g").set_max(5.0)
    reg.gauge("g").set_max(3.0)  # lower: high-water keeps 5
    reg.histogram("h").observe(0.02, op="x")
    snap = reg.snapshot()
    assert snap["c"]["series"]['k="a"'] == 5.0
    assert snap["c"]["help"] == "help!"
    assert snap["g"]["series"][""] == 5.0
    h = snap["h"]["series"]['op="x"']
    assert h["count"] == 1 and abs(h["sum"] - 0.02) < 1e-9
    assert h["min"] == h["max"]


def test_metrics_type_conflict_raises():
    reg = obs.MetricsRegistry()
    reg.counter("m")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("m")


def test_metrics_snapshot_deterministic_and_sorted():
    def feed(reg):
        reg.counter("z_total").inc(1, b="2", a="1")
        reg.counter("a_total").inc(4)
        reg.histogram("h_seconds").observe(0.5, node="n2")
        reg.histogram("h_seconds").observe(0.5, node="n1")

    r1, r2 = obs.MetricsRegistry(), obs.MetricsRegistry()
    feed(r1)
    feed(r2)
    assert json.dumps(r1.snapshot(), sort_keys=True) == json.dumps(r2.snapshot(), sort_keys=True)
    assert list(r1.snapshot()) == sorted(r1.snapshot())


def test_thread_safe_counter_accumulation():
    reg = obs.MetricsRegistry()

    def work():
        for _ in range(1000):
            reg.counter("n").inc()
            reg.histogram("h").observe(0.001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.counter("n").value() == 8000
    assert reg.snapshot()["h"]["series"][""]["count"] == 8000


# ---------------------------------------------------------------------------
# timed (first call vs steady state)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [np.zeros, torch.zeros], ids=["numpy", "torch"])
def test_timed_separates_compile_from_execute(make):
    obs.get_metrics().reset()
    obs.get_tracer().clear()
    dt = np.float32 if make is np.zeros else torch.float32

    @obs.timed("test.op")
    def op(x):
        return x * 2

    a = make((4, 3), dtype=dt)
    op(a)          # first call at this signature
    op(a + 1)      # same shape and dtype: a steady-state call
    op(make((8, 3), dtype=dt))  # new shape: a first call again
    snap = obs.get_metrics().snapshot()
    assert snap["op_compile_seconds"]["series"]['op="test.op"']["count"] == 2
    assert snap["op_execute_seconds"]["series"]['op="test.op"']["count"] == 1
    assert snap["op_cache_hit_total"]["series"]['op="test.op"'] == 1.0
    phases = [s.args["phase"] for s in obs.get_tracer().snapshot() if s.name == "test.op"]
    assert phases.count("compile") == 2 and phases.count("execute") == 1


def test_timed_preserves_function_behavior():
    @obs.timed()
    def add(x, y=1):
        return x + y

    assert add(2, y=3) == 5
    assert add.__wrapped__(2, y=3) == 5


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def _summary_stub():
    return {
        "mode": "sequential", "workers": 1, "wall_s": 1.0, "serial_s": 1.0,
        "critical_path_s": 1.0, "parallel_speedup": 1.0,
        "critical_path": ["n1"],
        "nodes": {"n1": {"state": "done", "dur_s": 1.0, "queue_wait_s": 0.0,
                         "start_s": 0.0, "end_s": 1.0, "thread": "t",
                         "deps": []}},
    }


def test_manifest_roundtrip_and_byte_stability(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("rows_ingested_total").inc(100)
    man = obs.build_manifest({"cfg": 1}, _summary_stub(), reg.snapshot(),
                             block_times={"b": 0.5}, generated_unix=123.0)
    p1 = obs.write_manifest(man, str(tmp_path / "a" / "run_manifest.json"))
    p2 = obs.write_manifest(man, str(tmp_path / "b" / "run_manifest.json"))
    assert obs.load_manifest(p1) == man
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    assert man["backend"] == "cpu" and man["compile_census"] is None and man["cache"] is None


def test_stable_view_drops_only_volatile_fields():
    reg = obs.MetricsRegistry()
    reg.counter("rows_ingested_total").inc(100)
    reg.histogram("node_wall_seconds").observe(1.0, node="n1")
    man1 = obs.build_manifest({"cfg": 1}, _summary_stub(), reg.snapshot(),
                              block_times={"b": 0.5}, generated_unix=1.0)
    s2 = _summary_stub()
    s2["wall_s"] = 99.0
    s2["nodes"]["n1"]["dur_s"] = 99.0
    s2["nodes"]["n1"]["thread"] = "other"
    s2["multidev_overlap"] = 3
    # the port's telemetry field is stripped by name
    s2["nodes"]["n1"]["stream"] = True
    reg2 = obs.MetricsRegistry()
    reg2.counter("rows_ingested_total").inc(100)
    reg2.histogram("node_wall_seconds").observe(77.0, node="n1")
    man2 = obs.build_manifest({"cfg": 1}, s2, reg2.snapshot(),
                              block_times={"b": 9.5}, generated_unix=2.0)
    assert obs.stable_view(man1) == obs.stable_view(man2)
    man3 = obs.build_manifest({"cfg": 2}, _summary_stub(), reg.snapshot(), generated_unix=1.0)
    assert obs.stable_view(man1) != obs.stable_view(man3)
    reg3 = obs.MetricsRegistry()
    reg3.counter("rows_ingested_total").inc(999)
    man4 = obs.build_manifest({"cfg": 1}, _summary_stub(), reg3.snapshot(), generated_unix=1.0)
    assert obs.stable_view(man1) != obs.stable_view(man4)


# ---------------------------------------------------------------------------
# workflow integration: sequential-mode manifest determinism
# ---------------------------------------------------------------------------

def _synthesize_income(n=800):
    spec = importlib.util.spec_from_file_location(
        "_example_data", os.path.join(os.path.dirname(__file__), "..", "examples", "_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synthesize(n)


def mini_cfg(pq: str) -> dict:
    """``tests/test_obs.py``'s ``_mini_cfg``: ingest, two stats metrics
    and a duplicate check, into a ``report_stats`` master path."""
    return {
        "input_dataset": {
            "read_dataset": {"file_path": pq, "file_type": "parquet"},
            "delete_column": ["logfnl", "empty", "dt_1", "dt_2"],
        },
        "stats_generator": {
            "metric": ["global_summary", "measures_of_counts"],
            "metric_args": {"list_of_cols": "all", "drop_cols": ["ifa"]},
        },
        "quality_checker": {
            "duplicate_detection": {"list_of_cols": "all", "drop_cols": ["ifa"], "treatment": True},
        },
        "report_preprocessing": {"master_path": "report_stats"},
    }


def mini_parquet(tmp_path, n=800) -> str:
    pq = tmp_path / "pq"
    pq.mkdir()
    _synthesize_income(n).to_parquet(pq / "part-0.parquet")
    return str(pq)


def test_sequential_manifest_stable_and_names_all_nodes(tmp_path, monkeypatch):
    """obs/run_manifest.json is equal across two sequential-mode runs
    modulo timestamp fields (stable_view equality plus deterministic
    serialization), and names every executed node."""
    from anovos_tpu_torch import workflow

    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.delenv("ANOVOS_TPU_TRACE", raising=False)
    cfg = mini_cfg(mini_parquet(tmp_path))
    manifests = []
    for run in ("r1", "r2"):
        d = tmp_path / run
        d.mkdir()
        monkeypatch.chdir(d)
        workflow.main(cfg, "local")
        assert workflow.LAST_MANIFEST_PATH.endswith(os.path.join("obs", "run_manifest.json"))
        assert os.path.exists(workflow.LAST_MANIFEST_PATH)
        manifests.append(obs.load_manifest(workflow.LAST_MANIFEST_PATH))
    m1, m2 = manifests
    assert obs.stable_view(m1) == obs.stable_view(m2)
    expected = {"stats_generator/global_summary", "stats_generator/measures_of_counts",
                "quality_checker/duplicate_detection"}
    assert expected <= set(m1["scheduler"]["nodes"])
    for node in m1["scheduler"]["nodes"].values():
        assert node["state"] == "done"
        assert node["dur_s"] is not None
    assert m1["executor"]["mode"] == "sequential"
    assert m2["block_seconds"] == workflow.block_times() != {}
    assert m1["metrics"]["rows_ingested_total"]["series"] == m2["metrics"]["rows_ingested_total"]["series"]


def test_trace_export_gated_by_env(tmp_path, monkeypatch):
    from anovos_tpu_torch import workflow

    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    cfg = mini_cfg(mini_parquet(tmp_path, 300))

    d1 = tmp_path / "notrace"
    d1.mkdir()
    monkeypatch.chdir(d1)
    monkeypatch.delenv("ANOVOS_TPU_TRACE", raising=False)
    workflow.main(cfg, "local")
    assert not (d1 / "report_stats" / "obs" / "trace.json").exists()

    d2 = tmp_path / "trace"
    d2.mkdir()
    monkeypatch.chdir(d2)
    monkeypatch.setenv("ANOVOS_TPU_TRACE", "1")
    workflow.main(cfg, "local")
    tpath = d2 / "report_stats" / "obs" / "trace.json"
    assert tpath.exists()
    doc = json.loads(tpath.read_text())
    node_events = [e for e in doc["traceEvents"] if e.get("cat") == "node" and e["ph"] == "X"]
    names = {e["name"] for e in node_events}
    assert {"stats_generator/global_summary", "input_dataset/ETL"} <= names
    man = obs.load_manifest(str(d2 / "report_stats" / "obs" / "run_manifest.json"))
    assert man["trace_path"] and man["trace_path"].endswith("trace.json")
    # scheduler node spans on the one sequential lane sum to ≤ its wall
    wall = man["scheduler"]["wall_s"]
    lane_sum = sum(e["dur"] for e in node_events if e["name"] != "input_dataset/ETL") / 1e6
    assert 0 < lane_sum <= wall * 1.10 + 0.05


def test_run_timings_tab_renders_from_manifest(tmp_path):
    """The report's Run Timings tab is manifest-gated: absent without one,
    rendered from it when present."""
    from anovos_tpu_torch.data_report.report_generation import run_timings_gen

    assert run_timings_gen(str(tmp_path)) == ""
    reg = obs.MetricsRegistry()
    man = obs.build_manifest({"cfg": 1}, _summary_stub(), reg.snapshot(),
                             block_times={"blk": 0.5}, generated_unix=1.0)
    obs.write_manifest(man, str(tmp_path / "obs" / "run_manifest.json"))
    html = run_timings_gen(str(tmp_path))
    assert "n1" in html and "sequential" in html
    assert "blk" in html
