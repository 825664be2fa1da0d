"""The port's DAG scheduler (``anovos_tpu_torch/parallel/scheduler.py``)
and async artifact writer (``shared/artifact_store.AsyncArtifactWriter``):
the cases of ``tests/test_workflow_scheduler.py`` on the port, the same
registrations giving the JAX scheduler's edges and summary structure,
the watchdog's escalation and degradation at a chaos ``node:`` hang, and
the thread-safety of the counters the concurrent runner shares (block
walls, kernel launches, the degradation registry).

The sequential-against-concurrent artifact comparison runs the port's
runner in subprocesses, each with ``ANOVOS_TPU_NODE_TIMEOUT`` and a hard
timeout, on the income demo config of the JAX gate at 2,000 rows.
"""

import hashlib
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from anovos_tpu_torch.parallel.scheduler import DagScheduler, NodeTimeout, default_workers
from anovos_tpu_torch.shared.artifact_store import AsyncArtifactWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _order_recorder():
    order, lock = [], threading.Lock()

    def rec(name):
        def f():
            with lock:
                order.append(name)
        return f
    return order, rec


@pytest.fixture(autouse=True)
def _clean_registries():
    from anovos_tpu_torch.resilience import chaos, policy

    chaos.reset()
    policy.reset_degraded()
    yield
    chaos.reset()
    policy.reset_degraded()


# ---------------------------------------------------------------------------
# graph construction / ordering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_topological_correctness_raw_waw_war(mode):
    """Readers run after their writer (RAW), a re-writer runs after both the
    previous writer (WAW) and its readers (WAR)."""
    order, rec = _order_recorder()
    s = DagScheduler()
    s.add("w1", rec("w1"), writes=("r",))
    s.add("read1", rec("read1"), reads=("r",))
    s.add("read2", rec("read2"), reads=("r",))
    s.add("w2", rec("w2"), writes=("r",))      # WAW w1, WAR read1/read2
    s.add("read3", rec("read3"), reads=("r",))  # RAW w2
    summary = s.run(mode=mode)
    pos = {n: i for i, n in enumerate(order)}
    assert pos["w1"] < min(pos["read1"], pos["read2"], pos["w2"])
    assert max(pos["read1"], pos["read2"]) < pos["w2"] < pos["read3"]
    assert summary["mode"] == mode
    assert all(n["state"] == "done" for n in summary["nodes"].values())


def test_sequential_runs_registration_order():
    order, rec = _order_recorder()
    s = DagScheduler()
    for name in ("a", "b", "c", "d"):
        s.add(name, rec(name))  # fully independent
    s.run(mode="sequential")
    assert order == ["a", "b", "c", "d"]


def test_duplicate_node_name_rejected():
    s = DagScheduler()
    s.add("n", lambda: None)
    with pytest.raises(ValueError, match="duplicate"):
        s.add("n", lambda: None)


def test_unwritten_resource_is_external_input():
    """Reading a resource nobody writes neither blocks nor errors."""
    order, rec = _order_recorder()
    s = DagScheduler()
    s.add("r", rec("r"), reads=("never_written",))
    s.run(mode="concurrent", node_timeout=30)
    assert order == ["r"]


def test_independent_nodes_actually_overlap():
    """Two nodes that each wait on the OTHER's started-event only finish if
    they genuinely run concurrently."""
    ev_a, ev_b = threading.Event(), threading.Event()

    def a():
        ev_a.set()
        assert ev_b.wait(10), "b never started concurrently with a"

    def b():
        ev_b.set()
        assert ev_a.wait(10), "a never started concurrently with b"

    s = DagScheduler()
    s.add("a", a)
    s.add("b", b)
    summary = s.run(mode="concurrent", max_workers=2, node_timeout=30)
    assert summary["nodes"]["a"]["state"] == "done"
    assert summary["nodes"]["b"]["state"] == "done"
    assert summary["multidev_overlap"] == 2


def test_spine_vs_fanout_ordering():
    """A fan-out node pinned to version 1 sees version 1 even when the spine
    has already advanced to version 2 (the workflow's df-versioning)."""
    versions = {0: "v0"}
    fanout_saw = {}
    spine2_done = threading.Event()

    def spine1():
        versions[1] = versions[0] + "+s1"

    def spine2():
        versions[2] = versions[1] + "+s2"
        spine2_done.set()

    def fan():
        spine2_done.wait(10)  # let the spine advance first if it can
        fanout_saw["df"] = versions[1]

    s = DagScheduler()
    s.add("spine1", spine1, reads=("df:0",), writes=("df:1",))
    s.add("fan", fan, reads=("df:1",))
    s.add("spine2", spine2, reads=("df:1",), writes=("df:2",))
    s.run(mode="concurrent", max_workers=3, node_timeout=30)
    assert fanout_saw["df"] == "v0+s1"
    assert versions[2] == "v0+s1+s2"


# ---------------------------------------------------------------------------
# failure semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_continue_node_failure_does_not_kill_run(mode):
    order, rec = _order_recorder()

    def boom():
        raise RuntimeError("best-effort analyzer crashed")

    s = DagScheduler()
    s.add("geo", boom, on_error="continue")
    s.add("stats", rec("stats"))
    s.add("after_geo", rec("after_geo"), reads=("x",))
    summary = s.run(mode=mode, node_timeout=30)
    assert order.count("stats") == 1 and order.count("after_geo") == 1
    assert summary["nodes"]["geo"]["state"] == "failed-continued"


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_spine_failure_aborts_with_original_exception(mode):
    order, rec = _order_recorder()

    class SpineError(RuntimeError):
        pass

    def boom():
        raise SpineError("spine block failed")

    s = DagScheduler()
    s.add("ok", rec("ok"), writes=("df:1",))
    s.add("bad", boom, reads=("df:1",), writes=("df:2",))
    s.add("down", rec("down"), reads=("df:2",))
    with pytest.raises(SpineError, match="spine block failed"):
        s.run(mode=mode, node_timeout=30)
    assert "down" not in order  # dependent never ran


def test_spine_failure_skips_pending_nodes_concurrent():
    ran, rec = _order_recorder()

    s = DagScheduler()
    s.add("bad", lambda: (_ for _ in ()).throw(ValueError("dead")), writes=("df:1",))
    s.add("dep", rec("dep"), reads=("df:1",))
    with pytest.raises(ValueError):
        s.run(mode="concurrent", node_timeout=30)
    assert ran == []
    assert all(n.state in ("failed", "skipped") for n in s._nodes)


def test_watchdog_names_stuck_node():
    hung = threading.Event()

    def stuck():
        hung.wait(20)  # far beyond the timeout

    s = DagScheduler()
    s.add("stuck_block", stuck)
    t0 = time.monotonic()
    with pytest.raises(NodeTimeout, match="stuck_block"):
        s.run(mode="concurrent", node_timeout=0.3)
    assert time.monotonic() - t0 < 10
    hung.set()  # unblock the daemon worker


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_retry_then_degrade_records_the_section(mode):
    """A ``retry:1:degrade`` node that fails twice is degraded (the
    registry names it with its last error) and its dependents still run; a
    node that fails once and then succeeds is done after two attempts."""
    from anovos_tpu_torch.resilience import policy

    calls = {"flaky": 0}
    order, rec = _order_recorder()

    def always():
        raise KeyError("gone")

    def flaky():
        calls["flaky"] += 1
        if calls["flaky"] == 1:
            raise OSError("transient")

    s = DagScheduler()
    s.add("bad", always, writes=("stats:x",), on_error="retry:1:degrade")
    s.add("flaky", flaky, on_error="retry:1:degrade")
    s.add("after", rec("after"), reads=("stats:x",))
    summary = s.run(mode=mode, node_timeout=30)
    assert summary["nodes"]["bad"]["state"] == "degraded" and summary["nodes"]["bad"]["attempts"] == 2
    assert summary["nodes"]["flaky"]["state"] == "done" and summary["nodes"]["flaky"]["attempts"] == 2
    assert order == ["after"]
    assert policy.degraded_sections() == {"bad": "KeyError: 'gone'"}
    assert summary["resilience"] == {"retries": 2, "timeout_retries": 0, "failover_retries": 0,
                                     "timeout_escalations": 0, "failovers": 0, "degraded": ["bad"]}


def test_chaos_hang_escalates_then_degrades(monkeypatch):
    """``hang@node:<name>`` on a fan-out node under a 0.4 s bound: the
    watchdog interrupts the first attempt and escalates (x1.5), the
    re-execution hangs again and outlives the escalated bound, the node is
    abandoned and degraded, and the run completes; the zombie unwinds on
    its interrupt and does not run the body again."""
    from anovos_tpu_torch.resilience import chaos, policy
    from anovos_tpu_torch.workflow import _node_policies

    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "hang@node:stats/*:secs=600:n=5")
    chaos.install_from_env()
    ran, rec = _order_recorder()
    _, fanout = _node_policies()
    s = DagScheduler()
    s.add("stats/counts", rec("stats/counts"), writes=("stats:counts",), on_error=fanout)
    s.add("report", rec("report"), reads=("stats:counts",))
    t0 = time.monotonic()
    summary = s.run(mode="concurrent", max_workers=2, node_timeout=0.4)
    wall = time.monotonic() - t0
    node = summary["nodes"]["stats/counts"]
    assert node["state"] == "degraded" and node["escalated"] and node["attempts"] == 2
    assert 0.4 * 2.5 <= wall < 10
    assert ran == ["report"]
    reason = policy.degraded_sections()["stats/counts"]
    assert "still running after its escalated bound (0s x1.5)" in reason
    assert summary["resilience"]["timeout_escalations"] == 1
    assert summary["resilience"]["timeout_retries"] == 1
    time.sleep(0.3)  # the zombie unwinds on the interrupt set at abandonment
    assert ran == ["report"] and chaos.plan().summary()["fired"] == {"hang@node:stats/*": 2}


# ---------------------------------------------------------------------------
# async artifact writer
# ---------------------------------------------------------------------------

def test_async_writer_keyed_wait_and_drain_reraise(tmp_path):
    w = AsyncArtifactWriter(workers=2)
    w.submit("ok", (tmp_path / "a.txt").write_text, "hello")

    def boom():
        raise IOError("disk full")

    w.submit("bad", boom)
    w.wait(["ok"])  # keyed wait: unaffected by the failing key
    assert (tmp_path / "a.txt").read_text() == "hello"
    with pytest.raises(IOError, match="disk full"):
        w.wait(["bad"])
    with pytest.raises(IOError, match="disk full"):
        w.drain()
    w._pending.clear()  # drop the failed ticket so close() can succeed
    w.close()


def test_async_writer_sync_mode_inline(tmp_path):
    w = AsyncArtifactWriter(sync=True)
    w.submit("k", (tmp_path / "s.txt").write_text, "now")
    assert (tmp_path / "s.txt").read_text() == "now"  # no drain needed
    w.drain()
    w.close()


def test_default_workers_env_override(monkeypatch):
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR_WORKERS", "5")
    assert default_workers() == 5
    monkeypatch.delenv("ANOVOS_TPU_EXECUTOR_WORKERS")
    assert default_workers() >= 2


# ---------------------------------------------------------------------------
# the JAX scheduler on the same registrations
# ---------------------------------------------------------------------------

# (name, reads, writes): a spine of df versions, analyzers pinned to them,
# stats read through stats_args, the charts on the drift model, the report
# on every artifact
REGISTRATIONS = [
    ("join_dataset", ("df:0",), ("df:1",)),
    ("timeseries_analyzer/auto_detection", ("df:1",), ("df:2", "report:ts_autodetect")),
    ("stats_generator/measures_of_counts", ("df:2",), ("stats:measures_of_counts",)),
    ("stats_generator/measures_of_cardinality", ("df:2",), ("stats:measures_of_cardinality",)),
    ("quality_checker/nullColumns_detection", ("df:2", "stats:measures_of_counts"),
     ("df:3", "stats:nullColumns_detection")),
    ("association_evaluator/IV_calculation", ("df:3",), ("stats:IV_calculation",)),
    ("drift_detector/drift_statistics", ("df:3",), ("stats:drift_statistics", "drift:model")),
    ("transformers/IQR_standardization", ("df:3",), ("df:4",)),
    ("report_preprocessing/charts_to_objects", ("df:4", "stats:measures_of_cardinality", "drift:model"),
     ("charts:objects",)),
    ("report_generation", ("df:4", "report:ts_autodetect", "stats:measures_of_counts",
                           "stats:measures_of_cardinality", "stats:nullColumns_detection",
                           "stats:IV_calculation", "stats:drift_statistics", "drift:model",
                           "charts:objects"), ()),
]


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_same_registrations_give_the_jax_edges_and_summary(mode):
    """The same registrations on the JAX scheduler and the port's: the same
    dependencies for every node, the same node names and deps in the run
    summary, and the same critical path when each node's duration is the
    same fixed sleep."""
    from anovos_tpu.parallel.scheduler import DagScheduler as JaxScheduler

    durations = {name: 0.01 * (1 + i % 3) for i, (name, _, _) in enumerate(REGISTRATIONS)}
    summaries = {}
    for tag, cls in (("jax", JaxScheduler), ("port", DagScheduler)):
        s = cls(name="workflow")
        for name, reads, writes in REGISTRATIONS:
            s.add(name, lambda d=durations[name]: time.sleep(d), reads=reads, writes=writes,
                  on_error="retry:1:degrade", placement="mesh")
        summaries[tag] = s.run(mode=mode, max_workers=4, node_timeout=60)
    jax_nodes, port_nodes = summaries["jax"]["nodes"], summaries["port"]["nodes"]
    assert list(port_nodes) == list(jax_nodes) == [r[0] for r in REGISTRATIONS]
    for name in jax_nodes:
        assert port_nodes[name]["deps"] == jax_nodes[name]["deps"], name
        assert port_nodes[name]["state"] == jax_nodes[name]["state"] == "done"
        assert port_nodes[name]["lane"] == jax_nodes[name]["lane"] == "mesh"
    assert summaries["port"]["critical_path"] == summaries["jax"]["critical_path"]
    assert summaries["port"]["critical_path"][-1] == "report_generation"
    assert port_nodes["report_generation"]["deps"][0] == "transformers/IQR_standardization"


# ---------------------------------------------------------------------------
# workflow-level satellites
# ---------------------------------------------------------------------------

def test_save_none_write_config_is_identity_even_with_reread():
    """No write config → the data returns untouched before any path logic,
    including under reread=True."""
    from anovos_tpu_torch import workflow

    sentinel = object()
    assert workflow.save(sentinel, None, "anything", reread=True) is sentinel
    assert workflow.save(sentinel, {}, "anything", reread=True) is sentinel


@pytest.mark.parametrize("from_disk", ["0", "1"])
def test_save_checkpoints_and_reread(tmp_path, monkeypatch, from_disk):
    """A checkpoint is written synchronously or through the writer under
    its key; ``reread=True`` returns the in-memory data unless
    ``ANOVOS_REREAD_FROM_DISK=1``, which reads the written CSV back (its
    round trip turns the int column's nulls into floats), as in the JAX
    runner."""
    import pandas as pd

    from anovos_tpu_torch import workflow

    monkeypatch.setenv("ANOVOS_REREAD_FROM_DISK", from_disk)
    frame = pd.DataFrame({"a": [1, 2, 3], "b": ["x", None, "z"]})
    cfg = {"file_path": str(tmp_path / "ckpt"), "file_type": "csv",
           "file_configs": {"mode": "overwrite", "header": True}}
    back = workflow.save(frame, cfg, "step", reread=True)
    written = pd.read_csv(next((tmp_path / "ckpt" / "step").glob("part-*")))
    assert written["a"].tolist() == [1, 2, 3] and written["b"].fillna("").tolist() == ["x", "", "z"]
    if from_disk == "1":
        assert back is not frame and back["a"].tolist() == [1, 2, 3]
    else:
        assert back is frame
    w = AsyncArtifactWriter(workers=1)
    assert workflow.save(frame, dict(cfg, file_path=str(tmp_path / "queued")), "step", writer=w,
                         key="stats:k") is frame
    w.wait(["stats:k"])
    pd.testing.assert_frame_equal(pd.read_csv(next((tmp_path / "queued" / "step").glob("part-*"))), written)
    w.close()


def test_main_and_run_have_no_mutable_default_auth():
    import inspect

    from anovos_tpu_torch import workflow

    assert inspect.signature(workflow.main).parameters["auth_key_val"].default is None
    assert inspect.signature(workflow.run).parameters["auth_key_val"].default is None
    assert workflow._auth_key(None) == "NA"
    assert workflow._auth_key({}) == "NA"
    assert workflow._auth_key({"a": "k1", "b": "k2"}) == "k2"


def test_block_times_thread_safe_accumulation():
    """8 threads adding 200 walls of about a second each to one label lose
    none of them."""
    from anovos_tpu_torch import workflow

    with workflow._BLOCK_LOCK:
        workflow._BLOCK_TIMES.clear()
    start = time.monotonic() - 1.0

    def add():
        for _ in range(200):
            workflow._log_block_time("label", start)

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bt = workflow.block_times()
    assert list(bt) == ["label"]
    assert 1600.0 <= bt["label"] < 1700.0


def test_kernel_launch_counts_and_degradations_thread_safe():
    """Launch counts and the degradation registry written from 8 threads at
    once: every increment and every record lands."""
    from anovos_tpu_torch.ops import kernels
    from anovos_tpu_torch.resilience import policy

    kernels.reset_launches()

    def work(i):
        for j in range(5000):
            kernels.count_launch("masked_moments")
            if j % 1000 == 0:
                policy.record_degraded(f"node{i}/{j}", "x")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernels.LAUNCHES["masked_moments"] == 40_000
    assert len(policy.degraded_sections()) == 40
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# sequential against concurrent artifacts, income-demo config
# ---------------------------------------------------------------------------

def _demo_cfg(pq: str) -> dict:
    """tests/test_workflow_scheduler.py's demo config."""
    src = {
        "read_dataset": {"file_path": pq, "file_type": "parquet"},
        "delete_column": ["logfnl", "empty", "dt_1", "dt_2"],
        "rename_column": {
            "list_of_cols": ["marital-status", "education-num"],
            "list_of_newcols": ["marital_status", "education_num"],
        },
    }
    return {
        "input_dataset": dict(src),
        "anovos_basic_report": {"basic_report": False},
        "stats_generator": {
            "metric": ["global_summary", "measures_of_counts", "measures_of_cardinality",
                       "measures_of_centralTendency"],
            "metric_args": {"list_of_cols": "all", "drop_cols": ["ifa"]},
        },
        "quality_checker": {
            "duplicate_detection": {"list_of_cols": "all", "drop_cols": ["ifa"], "treatment": True},
            "nullColumns_detection": {
                "list_of_cols": "all", "drop_cols": ["ifa", "income"], "treatment": True,
                "treatment_method": "MMM", "treatment_configs": {"method_type": "median"},
            },
        },
        "association_evaluator": {
            "IV_calculation": {"list_of_cols": "all", "drop_cols": "ifa",
                               "label_col": "income", "event_label": ">50K"},
        },
        "drift_detector": {
            "drift_statistics": {
                "configs": {"list_of_cols": "all", "drop_cols": ["ifa", "income"],
                            "method_type": "PSI", "threshold": 0.1},
                "source_dataset": dict(src),
            },
        },
        "report_preprocessing": {
            "master_path": "report_stats",
            "charts_to_objects": {"list_of_cols": "all", "drop_cols": "ifa",
                                  "label_col": "income", "event_label": ">50K",
                                  "bin_size": 10, "drift_detector": True},
        },
        "report_generation": {"master_path": "report_stats", "id_col": "ifa",
                              "label_col": "income", "final_report_path": "report_stats"},
        "write_intermediate": {"file_path": "intermediate_data", "file_type": "csv",
                               "file_configs": {"mode": "overwrite", "header": True}},
        "write_main": {"file_path": "output", "file_type": "parquet",
                       "file_configs": {"mode": "overwrite"}},
    }


def tree_hashes(root: str) -> dict:
    """{relative path: sha1} of every file under ``root``, ``obs/`` left out."""
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "obs"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(fh.read()).hexdigest()
    return out


_RUNNER = """
import json, logging, os, sys, warnings
logging.disable(logging.INFO)
warnings.filterwarnings("ignore")
from anovos_tpu_torch.shared.runtime import init_runtime
init_runtime("cpu")
from anovos_tpu_torch import workflow
with open(sys.argv[1]) as f:
    cfg = json.load(f)
os.chdir(sys.argv[2])
workflow.main(cfg, "local")
s = workflow.LAST_RUN_SUMMARY
with open(sys.argv[3], "w") as f:
    json.dump({"mode": s["mode"], "critical_path": s["critical_path"],
               "nodes": {k: v["deps"] for k, v in s["nodes"].items()},
               "streams": sum(v["stream"] for v in s["nodes"].values())}, f)
"""


def test_executor_modes_produce_identical_artifacts(tmp_path):
    """The income-demo pipeline once per executor mode, each in a
    subprocess under the watchdog and a hard timeout: every artifact
    (stats CSVs, chart JSONs, intermediate checkpoints, the drift model,
    the final parquet, the HTML report) byte-identical, the same nodes and
    dependencies, the report last on the critical path.  On the CPU no
    node takes a CUDA stream."""
    from examples._data import synthesize

    pq = tmp_path / "parquet"
    pq.mkdir()
    synthesize(2000).to_parquet(pq / "part-0.parquet")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_demo_cfg(str(pq))))
    runner = tmp_path / "runner.py"
    runner.write_text(_RUNNER)
    outs, summaries = {}, {}
    for mode in ("sequential", "concurrent"):
        d = tmp_path / mode
        d.mkdir()
        env = dict(os.environ, ANOVOS_TPU_EXECUTOR=mode, ANOVOS_TPU_NODE_TIMEOUT="300",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   CUDA_VISIBLE_DEVICES="")
        summary_path = tmp_path / f"summary_{mode}.json"
        r = subprocess.run([sys.executable, str(runner), str(cfg_path), str(d), str(summary_path)],
                           capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
        assert r.returncode == 0, f"{mode} run failed:\n{r.stderr[-3000:]}"
        outs[mode] = tree_hashes(str(d))
        summaries[mode] = json.loads(summary_path.read_text())
    assert "report_stats/ml_anovos_report.html" in outs["sequential"]
    assert outs["sequential"] == outs["concurrent"]
    assert summaries["sequential"]["nodes"] == summaries["concurrent"]["nodes"]
    for mode, s in summaries.items():
        assert s["mode"] == mode
        assert s["critical_path"][-1] == "report_generation"
        assert s["streams"] == 0


def test_concurrent_describes_of_one_table_compute_it_once(monkeypatch):
    """The concurrent runner's stats nodes ask for one Table's description
    at once: 8 threads get the same arrays and B1's plain version runs
    once (as in the sequential walk, so both modes launch B1 as often)."""
    import pandas as pd

    from anovos_tpu_torch.ops import describe
    from anovos_tpu_torch.ops.kernels import moments
    from anovos_tpu_torch.shared.table import Table

    calls = []
    plain = moments.masked_moments_plain

    def counted(*a):
        calls.append(1)
        time.sleep(0.05)  # hold the first caller inside the computation
        return plain(*a)

    monkeypatch.setattr(moments, "masked_moments_plain", counted)
    t = Table.from_pandas(pd.DataFrame({"a": [1.0, 2.0, None, 4.0], "b": ["x", "y", "x", None]}),
                          device="cpu")
    got = [None] * 8

    def work(i):
        got[i] = describe.table_describe(t, ["a"], ["b"])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(calls) == 1
    assert all(g is got[0] for g in got)
