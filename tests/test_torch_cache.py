"""The port's node cache (``anovos_tpu_torch/cache``, the scheduler's cache
half, the writer's recorder binding) against the JAX package's
``anovos_tpu/cache`` and the tests it has there (``tests/test_cache.py``,
``tests/test_resilience.py::test_retry_discards_partial_artifacts_but_keeps_appends``),
on the CPU.

* Fingerprints: ``canonical``, ``digest``, ``dataset_fingerprint`` and
  ``node_fingerprint`` give JAX's digest byte for byte; ``base_material``
  differs from JAX's only by the package part; ``env_fingerprint`` moves
  with ``ANOVOS_GEOCODE_TABLE``; every env read a node body can reach is
  on ``KNOWN_ENV_KNOBS`` or ``EXEMPT_ENV_KNOBS`` (a parse of the sources).
* Store: commit, lookup and restore; a lookup misses an evicted object;
  each package restores the other's store; the two ``gc``s on copies of
  one store evict the same nodes and report the same bytes; the gc CLI
  exits as ``tools/cache_gc.py`` does.
* Capture and journal: the open hook; the writer's recorder binding; the
  journal round trip and its committed frontier against JAX's.
* Scheduler: a hit restores and skips the body, a new dep fingerprint
  invalidates its dependents, a retry discards partial files and keeps
  appends, an abandoned attempt commits nothing.
* The df checkpoint (``shared.table.save_table``/``load_table``): the
  restored Table equals the saved one.
* A file the JAX package's capture misses: ``np.savez`` model files.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "anovos_tpu_torch")


def _commit_files(store, tmp_path, n=3, size=4096):
    """``n`` nodes of one file each under ``tmp_path/b`` (the LRU clock
    staggered oldest first); their fingerprints."""
    base = tmp_path / "b"
    base.mkdir(exist_ok=True)
    fps = []
    for i in range(n):
        f = base / f"f{i}.bin"
        f.write_bytes(bytes([i]) * size)
        fp = f"{i}" * 64
        store.commit(fp, f"n{i}", [str(f)], base_dir=str(base))
        os.utime(store._manifest_path(fp), (1000 + i, 1000 + i))
        fps.append(fp)
    return fps


# ------------------------------------------------------------ fingerprints
@pytest.mark.parametrize("obj", [
    {"a": 1, "b": None},
    {"a": {"x": None, "y": [1, None]}, "b": [{"k": None, "v": 2.5}]},
    {"b": 2, "a": 1, "c": (1, "x")},
    {"path": "/tmp/x", "when": pd.Timestamp("2020-01-01")},
    [None, {"n": None}],
])
def test_canonical_and_digest_equal_jax(obj):
    from anovos_tpu.cache import canonical as jcanonical
    from anovos_tpu.cache import digest as jdigest
    from anovos_tpu_torch.cache import canonical, digest

    assert canonical(obj) == jcanonical(obj)
    assert digest(canonical(obj), "x", b"y") == jdigest(jcanonical(obj), "x", b"y")
    assert digest("ab", "c") != digest("a", "bc")


def test_dataset_fingerprint_equals_jax_and_tracks_file_state(tmp_path):
    from anovos_tpu.cache import dataset_fingerprint as jdfp
    from anovos_tpu_torch.cache import dataset_fingerprint

    d = tmp_path / "ds"
    (d / "sub").mkdir(parents=True)
    (d / "a.csv").write_text("x,y\n1,2\n")
    (d / "sub" / "b.csv").write_text("x,y\n3,4\n")
    for spec in ({"read_dataset": {"file_path": str(d), "file_type": "csv"}},
                 {"read_dataset": {"file_path": str(d / "a.csv"), "file_type": "csv"}, "delete_column": None},
                 None, {}, {"read_dataset": {"file_path": str(tmp_path / "missing")}}):
        assert dataset_fingerprint(spec) == jdfp(spec)
    spec = {"read_dataset": {"file_path": str(d), "file_type": "csv"}}
    fp1 = dataset_fingerprint(spec)
    (d / "a.csv").write_text("x,y\n1,3\n")
    assert dataset_fingerprint(spec) != fp1 and dataset_fingerprint(spec) == jdfp(spec)


@pytest.mark.parametrize("args", [
    ("base", "n", {"k": 1}, ("w",), ("dep1",)),
    ("base", "n", {"k": 2, "none": None}, ("w2", "w1"), ("dep2", "dep1")),
    ("b2", "stats_generator/global_summary", {"placement": "device", "slice": {"metric": "m"}}, (), ()),
])
def test_node_fingerprint_equals_jax(args):
    from anovos_tpu.cache import node_fingerprint as jnfp
    from anovos_tpu_torch.cache import node_fingerprint

    assert node_fingerprint(*args) == jnfp(*args)
    a = node_fingerprint("base", "n", {"k": 1}, ("w",), ("dep1",))
    assert a != node_fingerprint("base", "n", {"k": 1}, ("w",), ("dep2",))
    assert a != node_fingerprint("base2", "n", {"k": 1}, ("w",), ("dep1",))


def test_base_material_differs_from_jax_only_by_the_package(tmp_path, monkeypatch):
    """Both packages are version 0.1.0 and both default --resume to
    .anovos_cache: the port's base folds in its package name after the
    version, so a shared root never hands one package's results to the
    other (ROADMAP.md, divergences by design)."""
    import anovos_tpu.cache.fingerprint as jf
    from anovos_tpu.version import __version__ as jversion

    from anovos_tpu_torch.cache import fingerprint as pf
    from anovos_tpu_torch.version import __version__

    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "p.parquet").write_bytes(b"x")
    cfg = {"input_dataset": {"read_dataset": {"file_path": str(tmp_path / "d"), "file_type": "parquet"}},
           "write_main": {"file_path": "output"}, "report_preprocessing": {"master_path": "rs"}}
    monkeypatch.setattr(jf, "env_fingerprint", lambda: "ENV")
    monkeypatch.setattr(pf, "env_fingerprint", lambda: "ENV")
    assert __version__ == jversion
    parts = (jf.dataset_fingerprint(cfg["input_dataset"]),
             jf.canonical({"run_type": "local", "write_main": cfg["write_main"], "write_intermediate": None,
                           "write_stats": None, "report_preprocessing": {"master_path": "rs"}}))
    assert jf.base_material(cfg) == jf.digest(jversion, "ENV", *parts)
    assert pf.base_material(cfg) == jf.digest(jversion, "anovos_tpu_torch", "ENV", *parts)
    assert pf.base_material(cfg) != jf.base_material(cfg)
    assert pf.base_material(cfg, "emr") != pf.base_material(cfg)


def test_env_fingerprint_moves_with_the_audited_knobs(monkeypatch):
    from anovos_tpu_torch.cache import env_fingerprint

    base = env_fingerprint()
    monkeypatch.setenv("ANOVOS_GEOCODE_TABLE", "/tables/cities.csv")
    assert env_fingerprint() != base
    monkeypatch.delenv("ANOVOS_GEOCODE_TABLE")
    monkeypatch.setenv("ANOVOS_SHAPE_BUCKETS", "0")
    assert env_fingerprint() != base
    monkeypatch.delenv("ANOVOS_SHAPE_BUCKETS")
    # a pure performance knob does not invalidate
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR_WORKERS", "7")
    assert env_fingerprint() == base


def _env_reads(path: str):
    """(function qualname, knob) of every environment read in one source
    file: ``os.environ.get/setdefault/pop``, ``os.getenv``,
    ``os.environ[...]`` and ``... in os.environ``, the knob resolved
    through module-level string constants (``<dynamic>`` otherwise)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    consts = {n.targets[0].id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name)
              and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)}

    def environ(e):
        return (isinstance(e, ast.Attribute) and e.attr == "environ") or (
            isinstance(e, ast.Name) and e.id == "environ")

    def knob(a):
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
        return consts.get(a.id, "<dynamic>") if isinstance(a, ast.Name) else "<dynamic>"

    out = []

    def visit(node, stack):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                visit(ch, stack + [ch.name])
                continue
            k = None
            if isinstance(ch, ast.Call) and isinstance(ch.func, ast.Attribute) and ch.args:
                f = ch.func
                if (f.attr in ("get", "setdefault", "pop") and environ(f.value)) or f.attr == "getenv":
                    k = knob(ch.args[0])
            elif isinstance(ch, ast.Subscript) and environ(ch.value):
                k = knob(ch.slice)
            elif isinstance(ch, ast.Compare) and any(environ(c) for c in ch.comparators):
                k = knob(ch.left)
            if k is not None:
                out.append((".".join(stack) or "<module>", k))
            visit(ch, stack)

    visit(tree, [])
    return out


# Every env read of the port that is on neither list, with where it may be
# read (module, function qualname) and why no node body reaches it.  A
# read of such a knob anywhere else (a node body among them) fails.
OUTSIDE_NODE_BODIES = {
    ("workflow.py", "main", "ANOVOS_TPU_EXECUTOR"): "the runner's executor mode, before any node",
    ("workflow.py", "main", "ANOVOS_TPU_WRITER_WORKERS"): "the async writer's width",
    ("workflow.py", "_node_policies", "ANOVOS_TPU_RETRIES"): "a registration's error policy",
    ("workflow.py", "_node_policies", "ANOVOS_TPU_DEGRADE"): "a registration's error policy",
    ("workflow.py", "_sweep", "ANOVOS_TPU_CACHE_MAX_BYTES"): "the store's end-of-run sweep",
    ("workflow.py", "run", "ANOVOS_PROFILE"): "the profiler around the whole run",
    ("cache/store.py", "CacheStore.restore", "ANOVOS_TPU_CACHE_LINK"):
        "the scheduler's restore: a link or a copy of the same bytes",
    ("cache/fingerprint.py", "env_fingerprint", "<dynamic>"): "reads KNOWN_ENV_KNOBS for the key",
    ("obs/manifest.py", "_env_section", "<dynamic>"): "reads KNOWN_ENV_KNOBS for the manifest",
    ("obs/telemetry.py", "check_unported_knobs", "<dynamic>"): "main's and run's knob check",
    ("obs/tracing.py", "buffer_size", "ANOVOS_TPU_TRACE_BUFFER"): "main's trace ring",
    ("obs/tracing.py", "rotation_spec", "ANOVOS_TPU_TRACE_ROTATE"): "the rotator main and run start",
    ("obs/telemetry.py", "telemetry_port", "ANOVOS_TPU_TELEMETRY"): "the listener main and run acquire",
    ("obs/telemetry.py", "error_budget", "ANOVOS_TPU_SLO_ERROR_BUDGET"):
        "the rolling windows' burn rate, read at a scrape",
    ("obs/tracing.py", "trace_destination", "ANOVOS_TPU_TRACE"): "main's trace export",
    ("obs/devprof.py", "node_bracket", "ANOVOS_PROFILE"): "the scheduler's bracket around a node",
    ("parallel/scheduler.py", "default_workers", "ANOVOS_TPU_EXECUTOR_WORKERS"): "the pool's width",
    ("parallel/scheduler.py", "DagScheduler.run", "ANOVOS_TPU_EXECUTOR"): "the executor mode",
    ("parallel/scheduler.py", "DagScheduler.run", "ANOVOS_TPU_NODE_TIMEOUT"): "the watchdog",
    ("ops/kernels/build.py", "nvcc", "CUDA_HOME"): "which nvcc builds the kernels, not what they compute",
    ("feature_recommender/featrec_init.py", "<module>", "FR_CORPUS_PATH"):
        "the recommender, which no runner block calls",
    ("feature_recommender/featrec_init.py", "_EmbeddingModel.__init__", "FR_BACKEND"): "as FR_CORPUS_PATH",
    ("feature_recommender/featrec_init.py", "detect_model_path", "FR_MODEL_PATH"): "as FR_CORPUS_PATH",
    ("serving/server.py", "FeatureServer.__init__", "ANOVOS_SERVE_BATCH_WINDOW_MS"):
        "the feature server's batcher, which no runner block starts",
    ("serving/server.py", "FeatureServer.__init__", "ANOVOS_SERVE_MAX_BATCH"): "as the batch window",
    ("serving/program.py", "ApplyProgram.__init__", "ANOVOS_SERVE_BF16"): "refused where a server builds its program",
    ("resilience/failover.py", "backend_healthy", "ANOVOS_TPU_HEALTH_TIMEOUT"):
        "the health probe, which the scheduler pays outside the node body that failed",
    ("resilience/scenarios.py", "_knobs", "<dynamic>"): "the chaos scenarios' knobs, set around workflow.main",
}


def test_every_node_reachable_env_read_is_audited():
    """The port's counterpart of the JAX package's graftcheck GC008: a knob
    a node body can read is on KNOWN_ENV_KNOBS (it changes artifacts, so
    it is in the key) or EXEMPT_ENV_KNOBS (it cannot); every other read
    sits where OUTSIDE_NODE_BODIES says, outside every node body."""
    from anovos_tpu_torch.cache.fingerprint import EXEMPT_ENV_KNOBS, KNOWN_ENV_KNOBS

    assert not set(KNOWN_ENV_KNOBS) & set(EXEMPT_ENV_KNOBS)
    assert "ANOVOS_GEOCODE_TABLE" in KNOWN_ENV_KNOBS
    seen, stray = set(), []
    for d, _, files in os.walk(PORT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), PORT)
            for fn, k in _env_reads(os.path.join(d, f)):
                if k in KNOWN_ENV_KNOBS or k in EXEMPT_ENV_KNOBS:
                    continue
                if (rel, fn, k) in OUTSIDE_NODE_BODIES:
                    seen.add((rel, fn, k))
                else:
                    stray.append((rel, fn, k))
    assert not stray, f"env reads on neither list: {stray}"
    assert seen == set(OUTSIDE_NODE_BODIES), set(OUTSIDE_NODE_BODIES) - seen


def test_the_scan_sees_reads_through_constants_and_in_closures(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nKNOB = 'ANOVOS_X'\n"
                   "def main():\n    def body():\n        return os.environ.get(KNOB)\n"
                   "    return 'ANOVOS_Y' in os.environ, os.getenv('ANOVOS_Z'), os.environ['ANOVOS_W']\n")
    assert sorted(_env_reads(str(src))) == [("main", "ANOVOS_W"), ("main", "ANOVOS_Y"),
                                            ("main", "ANOVOS_Z"), ("main.body", "ANOVOS_X")]


# ------------------------------------------------------------------ store
def test_store_commit_lookup_restore_roundtrip(tmp_path):
    from anovos_tpu_torch.cache import CacheStore

    store = CacheStore(str(tmp_path / "store"))
    base = tmp_path / "base1"
    (base / "sub").mkdir(parents=True)
    (base / "a.csv").write_bytes(b"alpha")
    (base / "sub" / "b.json").write_bytes(b'{"x":1}')
    outside = tmp_path / "pinned.txt"
    outside.write_bytes(b"abs")
    man = store.commit("f" * 64, "node/x", [str(base / "a.csv"), str(base / "sub" / "b.json"), str(outside),
                                            str(base / "gone.csv")], base_dir=str(base))
    assert man["node"] == "node/x" and len(man["files"]) == 3 and not man["payload"]
    assert [e["portable"] for e in man["files"]] == [True, True, False]
    got = store.lookup("f" * 64)
    assert got is not None and got["files"] == man["files"]
    assert store.lookup("0" * 64) is None
    dest = tmp_path / "base2"
    dest.mkdir()
    outside.unlink()
    assert store.restore(got, base_dir=str(dest)) == 3
    assert (dest / "a.csv").read_bytes() == b"alpha"
    assert (dest / "sub" / "b.json").read_bytes() == b'{"x":1}'
    assert outside.read_bytes() == b"abs"


def test_linked_restore_shares_the_object(tmp_path, monkeypatch):
    from anovos_tpu_torch.cache import CacheStore

    store = CacheStore(str(tmp_path / "store"))
    (tmp_path / "a.csv").write_bytes(b"alpha")
    man = store.commit("a" * 64, "n", [str(tmp_path / "a.csv")], base_dir=str(tmp_path))
    dest = tmp_path / "d"
    monkeypatch.setenv("ANOVOS_TPU_CACHE_LINK", "1")
    assert store.restore(man, base_dir=str(dest)) == 1
    assert os.path.samefile(dest / "a.csv", store._obj_path(man["files"][0]["sha256"]))
    monkeypatch.setenv("ANOVOS_TPU_CACHE_LINK", "0")
    store.restore(man, base_dir=str(dest))
    assert not os.path.samefile(dest / "a.csv", store._obj_path(man["files"][0]["sha256"]))


def test_store_lookup_misses_on_evicted_objects(tmp_path):
    from anovos_tpu_torch.cache import CacheStore

    store = CacheStore(str(tmp_path / "store"))
    f = tmp_path / "x.txt"
    f.write_bytes(b"content")
    man = store.commit("a" * 64, "n", [str(f)], base_dir=str(tmp_path))
    assert store.lookup("a" * 64) is not None
    os.remove(store._obj_path(man["files"][0]["sha256"]))
    assert store.lookup("a" * 64) is None


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_restores_the_others_store(writer, reader, tmp_path):
    from anovos_tpu.cache import CacheStore as JStore
    from anovos_tpu_torch.cache import CacheStore

    stores = {"jax": JStore, "port": CacheStore}
    base = tmp_path / "run"
    (base / "report_stats").mkdir(parents=True)
    (base / "report_stats" / "global_summary.csv").write_bytes(b"metric,value\nrows,3\n")
    (base / "ts_cols_stats.csv").write_bytes(b"attribute,status\n")
    paths = [str(base / "report_stats" / "global_summary.csv"), str(base / "ts_cols_stats.csv")]
    root = str(tmp_path / "store")
    man = stores[writer](root).commit("c" * 64, "stats_generator/global_summary", paths, base_dir=str(base),
                                      payload_write=lambda d: open(os.path.join(d, "p"), "w").close())
    other = stores[reader](root)
    got = other.lookup("c" * 64)
    assert got == man
    dest = tmp_path / "elsewhere"
    assert other.restore(got, base_dir=str(dest)) == 2
    for p in paths:
        rel = os.path.relpath(p, base)
        assert (dest / rel).read_bytes() == open(p, "rb").read()
    assert os.path.exists(os.path.join(other.payload_dir("c" * 64), "p"))


def test_gc_evicts_what_the_jax_gc_evicts(tmp_path):
    """The two gcs, each on a copy of one store (node entries sharing an
    object, a payload, the JAX compile cache's files under xla/, tmp
    debris and an orphan object), at several caps."""
    from anovos_tpu.cache import CacheStore as JStore
    from anovos_tpu_torch.cache import CacheStore

    src = tmp_path / "src"
    store = CacheStore(str(src))
    fps = _commit_files(store, tmp_path, n=4)
    (tmp_path / "b" / "f0.bin").write_bytes(bytes([0]) * 4096)  # same bytes as node 0: a shared object
    store.commit("9" * 64, "shared", [str(tmp_path / "b" / "f0.bin")], base_dir=str(tmp_path / "b"),
                 payload_write=lambda d: open(os.path.join(d, "df"), "wb").write(b"p" * 3000))
    os.utime(store._manifest_path("9" * 64), (1500, 1500))
    os.makedirs(src / "xla" / "ab")
    for i, t in enumerate((900, 1200)):
        p = src / "xla" / "ab" / f"prog{i}"
        p.write_bytes(b"x" * 2048)
        os.utime(p, (t, t))
    (src / "objects" / "zz").mkdir()
    (src / "objects" / "zz" / "orphan").write_bytes(b"o" * 100)
    (src / "nodes" / "x.json.tmp-1-2-3").write_text("{")
    total = store.total_bytes()
    for cap in (total, total - 3000, total - 9000, 0):
        for dry in (True, False):
            a, b = tmp_path / f"jax_{cap}_{dry}", tmp_path / f"port_{cap}_{dry}"
            shutil.copytree(src, a)
            shutil.copytree(src, b)
            got = CacheStore(str(b)).gc(cap, dry_run=dry)
            exp = JStore(str(a)).gc(cap, dry_run=dry)
            assert got == exp, (cap, dry)
            assert sorted(os.listdir(a / "nodes")) == sorted(os.listdir(b / "nodes"))
    assert fps[0] in exp["evicted_nodes"] and exp["evicted_xla_files"] == 2


def test_gc_cli_exits_as_the_jax_tool(tmp_path, capsys):
    """``python -m anovos_tpu_torch.cache.gc`` against ``tools/cache_gc.py``:
    the same exit codes (0 when the store fits, 1 when it does not or the
    root is missing) and the same JSON, each on a copy of one store."""
    import tools.cache_gc as jcli

    from anovos_tpu_torch.cache import CacheStore
    from anovos_tpu_torch.cache import gc as cli

    root = tmp_path / "store"
    store = CacheStore(str(root))
    _commit_files(store, tmp_path, n=2, size=8192)
    for argv in (["--max-bytes", "1G"], ["--max-bytes", "9000", "--json"], ["--max-bytes", "0", "--dry-run", "--json"],
                 ["--max-bytes", "-1"]):
        outs = []
        for i, fn in enumerate((jcli.main, cli.main)):
            copy = tmp_path / f"c{i}_{len(argv)}_{argv[1]}"
            shutil.copytree(root, copy)
            rc = fn(["--root", str(copy), *argv])
            outs.append((rc, capsys.readouterr().out.replace(str(copy), "ROOT")))
        assert outs[0] == outs[1], argv
    assert outs[0][0] == 1
    assert cli.main(["--root", str(tmp_path / "nope"), "--max-bytes", "1"]) == 1
    assert jcli.main(["--root", str(tmp_path / "nope"), "--max-bytes", "1"]) == 1
    # lookup() touches the LRU clock: n0 is now the most recently used
    assert store.lookup("0" * 64) is not None
    assert cli.main(["--root", str(root), "--max-bytes", "9000", "--json"]) == 0
    assert "1" * 64 in json.loads(capsys.readouterr().out.strip().splitlines()[-1])["evicted_nodes"]
    env = dict(os.environ, PYTHONPATH=REPO, ANOVOS_TPU_CACHE=str(root))
    res = subprocess.run([sys.executable, "-m", "anovos_tpu_torch.cache.gc", "--max-bytes", "1"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("cache_gc: ") and "evicted 1 node entry" in res.stdout


# ------------------------------------------------------- capture, journal
def test_open_hook_records_write_opens_on_recording_thread(tmp_path):
    import builtins

    from anovos_tpu_torch.cache import capture

    capture.install_open_hook()
    try:
        rec = capture.Recorder()
        (tmp_path / "log.csv").write_text("old\n")
        with capture.recording(rec):
            with open(tmp_path / "w.txt", "w") as f:
                f.write("x")
            with open(tmp_path / "w.txt") as f:  # read mode: not recorded
                f.read()
            with open(tmp_path / "log.csv", "a") as f:
                f.write("new\n")
        with open(tmp_path / "outside.txt", "w") as f:  # no recorder active
            f.write("y")

        def other():
            with open(tmp_path / "thread.txt", "w") as f:
                f.write("z")

        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert rec.paths == {str(tmp_path / "w.txt"), str(tmp_path / "log.csv")}
        assert rec.discardable_paths() == {str(tmp_path / "w.txt")}
    finally:
        capture.uninstall_open_hook()
    assert builtins.open.__name__ == "open"


def test_open_hook_survives_foreign_repatch(tmp_path):
    """A tool that wraps builtins.open on top of the hook keeps working
    after the uninstall, and a re-install does not cycle."""
    import builtins

    from anovos_tpu_torch.cache import capture

    capture.install_open_hook()
    hooked = builtins.open
    calls = []

    def foreign(*a, **k):
        calls.append(a)
        return hooked(*a, **k)

    builtins.open = foreign
    try:
        capture.uninstall_open_hook()
        with open(tmp_path / "still_works.txt", "w") as f:
            f.write("x")
        assert calls
        capture.install_open_hook()
        rec = capture.Recorder()
        with capture.recording(rec), open(tmp_path / "still_works2.txt", "w") as f:
            f.write("y")
        assert rec.paths == {str(tmp_path / "still_works2.txt")}
        capture.uninstall_open_hook()
    finally:
        builtins.open = capture._ORIG_OPEN
    assert builtins.open.__name__ == "open"


@pytest.mark.parametrize("workers", [0, 2])
def test_async_writer_propagates_the_recorder(workers, tmp_path):
    from anovos_tpu_torch.cache import capture
    from anovos_tpu_torch.shared.artifact_store import AsyncArtifactWriter

    capture.install_open_hook()
    try:
        writer = AsyncArtifactWriter(workers=workers)
        rec = capture.Recorder()

        def write_it(p):
            with open(p, "w") as f:
                f.write("queued")

        with capture.recording(rec):
            writer.submit("stats:x", write_it, str(tmp_path / "q.csv"))
        writer.submit("stats:y", write_it, str(tmp_path / "unrecorded.csv"))
        writer.close()
        assert rec.keys == {"stats:x"}
        assert rec.paths == {str(tmp_path / "q.csv")}
    finally:
        capture.uninstall_open_hook()


def test_journal_roundtrip_and_committed_frontier_equal_jax(tmp_path):
    from anovos_tpu.cache import committed_fingerprints as jcommitted
    from anovos_tpu.cache import read_journal as jread
    from anovos_tpu_torch.cache import RunJournal, committed_fingerprints, read_journal

    path = str(tmp_path / "obs" / "run_journal.jsonl")
    j = RunJournal(path)
    j.append("run_begin", run_id="r1")
    j.append("node_begin", node="a", fp="fa")
    j.append("node_commit", node="a", fp="fa")
    j.append("node_restored", node="b", fp="fb")
    j.append("node_failed", node="c", fp="fc")
    j.append("run_begin", run_id="r2")
    j.append("node_restored", node="a", fp="fa")
    j.append("node_commit", node="d", fp="fd")
    with open(path, "a") as f:
        f.write('{"torn": ')  # a kill mid-line
    records = read_journal(path)
    assert records == jread(path)
    assert [r["event"] for r in records][:3] == ["run_begin", "node_begin", "node_commit"]
    assert committed_fingerprints(records) == jcommitted(records) == ["fa", "fb", "fd"]
    assert committed_fingerprints(records, since_run="r2") == jcommitted(records, since_run="r2") == ["fa", "fd"]


def test_journal_rides_the_async_writer(tmp_path):
    from anovos_tpu_torch.cache import RunJournal, read_journal
    from anovos_tpu_torch.cache.journal import JOURNAL_KEY
    from anovos_tpu_torch.shared.artifact_store import AsyncArtifactWriter

    writer = AsyncArtifactWriter(workers=4)
    j = RunJournal(str(tmp_path / "j.jsonl"), writer)
    for i in range(40):
        j.append("node_commit", node=f"n{i}", fp=f"f{i}")
    writer.wait([JOURNAL_KEY])
    writer.close()
    records = read_journal(str(tmp_path / "j.jsonl"))
    assert len(records) == 40 and {r["node"] for r in records} == {f"n{i}" for i in range(40)}


# -------------------------------------------------------------- scheduler
def _cached_dag(store, workdir, runs, a_key="a", journal=None):
    from anovos_tpu_torch.cache import NodeCachePolicy, digest
    from anovos_tpu_torch.parallel.scheduler import DagScheduler

    os.chdir(workdir)
    s = DagScheduler("t", cache_store=store, journal=journal)

    def a():
        runs.append("a")
        with open("a.txt", "w") as f:
            f.write("A")

    def b():
        runs.append("b")
        with open("b.txt", "w") as f:
            f.write("B")

    s.add("a", a, writes=("r:a",), cache=NodeCachePolicy(key_material=digest("base", a_key)))
    s.add("b", b, reads=("r:a",), cache=NodeCachePolicy(key_material=digest("base", "b")))
    s.add("plain", lambda: runs.append("plain"))  # no policy: always runs
    return s


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
def test_scheduler_hit_restores_and_skips_the_body(mode, tmp_path, monkeypatch):
    """A hit restores the files and skips the body; a restored node's
    devprof bracket closes on its own (no attempt, no stream) with its
    parts within its wall."""
    from anovos_tpu_torch.cache import CacheStore, RunJournal, capture, read_journal
    from anovos_tpu_torch.obs import devprof

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("ANOVOS_TPU_DEVPROF", raising=False)
    store = CacheStore(str(tmp_path / "store"))
    capture.install_open_hook()
    try:
        runs = []
        d1, d2 = tmp_path / "w1", tmp_path / "w2"
        d1.mkdir()
        d2.mkdir()
        j = RunJournal(str(tmp_path / "j.jsonl"))
        sm1 = _cached_dag(store, d1, runs, journal=j).run(mode=mode)
        assert sm1["cache"] == {"enabled": True, "hits": 0, "misses": 2, "restore_s": 0.0, "uncacheable": 1}
        runs.clear()
        devprof.reset()
        sm2 = _cached_dag(store, d2, runs, journal=j).run(mode=mode)
    finally:
        capture.uninstall_open_hook()
    assert runs == ["plain"]
    dp = devprof.results()
    assert set(dp) == {"a", "b", "plain"}
    for e in dp.values():
        assert e["device_time_s"] + e["dispatch_s"] + e["transfer_s"] + e["host_s"] <= e["wall_s"] + 1e-6
    assert sm2["cache"]["hits"] == 2 and sm2["cache"]["misses"] == 0 and sm2["cache"]["restore_s"] > 0
    assert (d2 / "a.txt").read_text() == "A" and (d2 / "b.txt").read_text() == "B"
    assert sm2["nodes"]["a"]["cached"] and sm2["nodes"]["b"]["cached"] and not sm2["nodes"]["plain"]["cached"]
    assert sm2["nodes"]["a"]["state"] == "done" and sm2["nodes"]["a"]["attempts"] == 0
    events = [(r["event"], r.get("node")) for r in read_journal(str(tmp_path / "j.jsonl"))]
    assert events == [("node_begin", "a"), ("node_commit", "a"), ("node_begin", "b"), ("node_commit", "b"),
                      ("node_restored", "a"), ("node_restored", "b")]


def test_scheduler_dep_fingerprint_invalidation(tmp_path, monkeypatch):
    """A changed upstream key re-executes the downstream reader although
    its own key material is unchanged (RAW folding)."""
    from anovos_tpu_torch.cache import CacheStore, NodeCachePolicy, capture
    from anovos_tpu_torch.parallel.scheduler import DagScheduler

    monkeypatch.chdir(tmp_path)
    store = CacheStore(str(tmp_path / "store"))
    capture.install_open_hook()
    try:
        runs = []
        for i, key in enumerate(("a-v1", "a-v2", "a-v2")):
            (tmp_path / f"w{i}").mkdir()
            _cached_dag(store, tmp_path / f"w{i}", runs, a_key=key).run(mode="sequential")
    finally:
        capture.uninstall_open_hook()
    assert runs == ["a", "b", "plain", "a", "b", "plain", "plain"]
    s = DagScheduler("u", cache_store=store)
    s.add("nokey", lambda: None, writes=("r:x",))
    n = s.add("reader", lambda: None, reads=("r:x",), cache=NodeCachePolicy(key_material="k"))
    assert n.fingerprint is None  # a producer without a fingerprint
    assert s.run(mode="sequential")["cache"]["uncacheable"] == 2


def test_retry_discards_partial_artifacts_but_keeps_appends(tmp_path):
    """Between attempts the recorder's created files are removed, while an
    append-mode file keeps its earlier content (tests/test_resilience.py's
    test of the JAX scheduler)."""
    from anovos_tpu_torch.cache import CacheStore, NodeCachePolicy, capture
    from anovos_tpu_torch.parallel.scheduler import DagScheduler

    store = CacheStore(str(tmp_path / "store"))
    partial = tmp_path / "partial.csv"
    appended = tmp_path / "metrics.csv"
    appended.write_text("history\n")
    calls = {"n": 0}

    def body():
        calls["n"] += 1
        if calls["n"] == 1:
            with open(partial, "w") as f:
                f.write("half-written")
            with open(appended, "a") as f:
                f.write("attempt1\n")
            raise RuntimeError("mid-write failure")
        assert not partial.exists()
        assert appended.read_text().startswith("history\n")
        with open(partial, "w") as f:
            f.write("complete")

    s = DagScheduler(cache_store=store)
    s.add("writer_node", body, on_error="retry:1", cache=NodeCachePolicy(key_material="km"))
    capture.install_open_hook()
    try:
        summary = s.run(mode="sequential")
    finally:
        capture.uninstall_open_hook()
    assert calls["n"] == 2 and summary["resilience"]["retries"] == 1
    assert partial.read_text() == "complete"
    assert "history\n" in appended.read_text()
    assert store.lookup(s._by_name["writer_node"].fingerprint) is not None


def test_abandoned_attempt_is_not_committed(tmp_path):
    """A node stuck past its escalated bound is abandoned and degraded; its
    attempt that finishes late writes its file but commits nothing."""
    from anovos_tpu_torch.cache import CacheStore, NodeCachePolicy, capture
    from anovos_tpu_torch.parallel.scheduler import DagScheduler
    from anovos_tpu_torch.resilience import policy as rpolicy

    store = CacheStore(str(tmp_path / "store"))
    done = threading.Event()

    def stuck():
        time.sleep(3.0)  # ignores the interrupt
        with open(tmp_path / "late.csv", "w") as f:
            f.write("late")
        done.set()

    s = DagScheduler(cache_store=store)
    node = s.add("stuck", stuck, on_error="retry:0:degrade", cache=NodeCachePolicy(key_material="k"))
    s.add("fine", lambda: None, cache=NodeCachePolicy(key_material="k2"))
    capture.install_open_hook()
    try:
        summary = s.run(mode="concurrent", max_workers=2, node_timeout=0.2)
        assert done.wait(10)
        time.sleep(0.2)  # the zombie returns through _run_body
    finally:
        capture.uninstall_open_hook()
        rpolicy.reset_degraded()
    assert node.abandoned and summary["nodes"]["stuck"]["state"] == "degraded"
    assert (tmp_path / "late.csv").read_text() == "late"
    assert store.lookup(node.fingerprint) is None
    assert store.lookup(s._by_name["fine"].fingerprint) is not None


# ------------------------------------------------------ the df checkpoint
def _assert_tables_equal(got, exp):
    assert got.nrows == exp.nrows and list(got.columns) == list(exp.columns)
    for name, e in exp.columns.items():
        g = got[name]
        assert (g.kind, g.dtype_name) == (e.kind, e.dtype_name), name
        assert g.data.dtype == e.data.dtype and torch.equal(g.data, e.data), name
        assert torch.equal(g.mask, e.mask), name
        assert (g.exact is None) == (e.exact is None), name
        if e.exact is not None:
            assert g.exact.dtype == e.exact.dtype and torch.equal(g.exact, e.exact), name
        assert (g.vocab is None) == (e.vocab is None), name
        if e.vocab is not None:
            assert list(g.vocab) == list(e.vocab), name


def test_the_restored_table_equals_the_saved_one(tmp_path, monkeypatch):
    """Kinds and Spark dtype names, exact int64/float64 values, masks,
    vocabularies (one with entries no row uses any more) and codes,
    columns that ts auto-detection converted to timestamps, all-null
    columns: what ``_save_df`` writes, ``_LazyTable`` gives back."""
    from anovos_tpu_torch.data_ingest.ts_auto_detection import ts_preprocess
    from anovos_tpu_torch.shared.table import Table
    from anovos_tpu_torch.workflow import _LazyTable, _PipelineRun

    g = np.random.default_rng(3)
    n = 300
    df = pd.DataFrame({
        "wide_int": (np.arange(n, dtype=np.int64) * 12_345_678_901) - 7,
        "small_int64": np.arange(n, dtype=np.int64),
        "wide_float": g.normal(0, 1, n) * 1e9 + 0.123456789,
        "f32": g.normal(0, 1, n).astype(np.float32),
        "nullable": pd.array([None if i % 7 == 0 else i * 2**40 for i in range(n)], dtype="Int64"),
        "flag": g.random(n) > 0.5,
        "cat": pd.Series(g.choice(["a", "bé", "ç", None], n), dtype=object),
        "id": [f"id{i:05d}" for i in range(n)],
        "empty_obj": [None] * n,
        "empty_num": np.full(n, np.nan),
        "dt": pd.date_range("2021-01-01", periods=n, freq="h").strftime("%Y-%m-%d %H:%M:%S"),
    })
    monkeypatch.chdir(tmp_path)
    table = ts_preprocess(Table.from_pandas(df), "id", output_path=str(tmp_path))
    assert table["dt"].kind == "ts"
    table = table.filter_rows(torch.from_numpy(np.arange(n) % 3 != 0))  # leaves unused vocab entries
    pipe = _PipelineRun.__new__(_PipelineRun)
    pipe._versions = {1: table}
    pipe._save_df(1, str(tmp_path / "payload"))
    lazy = _LazyTable(str(tmp_path / "payload" / "df"))
    got = lazy.get()
    assert lazy.get() is got
    _assert_tables_equal(got, table)
    pd.testing.assert_frame_equal(got.to_pandas(), table.to_pandas())


def test_two_readers_of_a_restored_version_share_one_load(tmp_path, monkeypatch):
    """The first read loads; a second reader racing it waits on the lock
    and gets the same Table."""
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.shared.table import Table, save_table

    save_table(Table.from_pandas(pd.DataFrame({"a": np.arange(50.0)})), str(tmp_path / "df"))
    loads, gate = [], threading.Event()
    real = workflow.load_table

    def slow_load(path):
        loads.append(path)
        gate.wait(5)
        return real(path)

    monkeypatch.setattr(workflow, "load_table", slow_load)
    lazy = workflow._LazyTable(str(tmp_path / "df"))
    got = []
    threads = [threading.Thread(target=lambda: got.append(lazy.get())) for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join()
    assert len(loads) == 1 and got[0] is got[1]


# --------------------------------------------- a file JAX's capture misses
def test_npz_model_files_are_booked_where_jax_misses_them(tmp_path):
    """``imputation_sklearn`` saves its model with ``np.savez``, which opens
    the file through zipfile's ``io.open``, past the open hook.  The JAX
    package's capture misses it, so its cached run would lack the model
    file; the port books it (ROADMAP.md, faults of the reference)."""
    from anovos_tpu.cache import capture as jcapture
    from anovos_tpu.data_transformer.imputers import imputation_sklearn as jimpute
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.cache import capture
    from anovos_tpu_torch.data_transformer.imputers import imputation_sklearn
    from anovos_tpu_torch.shared.table import Table

    g = np.random.default_rng(0)
    df = pd.DataFrame({"a": g.normal(0, 1, 64), "b": g.normal(0, 1, 64)})
    df.loc[::5, "a"] = np.nan
    got = {}
    for name, cap, fn, table in (("jax", jcapture, jimpute, JTable.from_pandas(df)),
                                 ("port", capture, imputation_sklearn, Table.from_pandas(df))):
        model = tmp_path / name
        cap.install_open_hook()
        try:
            rec = cap.Recorder()
            with cap.recording(rec):
                fn(table, method_type="regression", model_path=str(model))
        finally:
            cap.uninstall_open_hook()
        (npz,) = model.glob("*.npz")
        got[name] = str(npz) in rec.paths
    assert got == {"jax": False, "port": True}
