"""The node cache through the port's runner, held against the JAX
package's runner on ``tests/test_cache.py``'s mini config (a copy of its
fixtures), sequential, on the CPU:

* populate and full hit: the hits and misses equal JAX's (0/6, then
  6/0), every node of the hit run restored, the trees byte-equal to the
  port's uncached tree, the journal, metrics and manifest booking the
  hits, ``ANOVOS_TPU_CACHE_MAX_BYTES`` accepted;
* an incremental edit re-executes the node names JAX's re-executes, and
  gives the tree of an uncached run of the edited config;
* a run killed inside the drift node resumes with frontier 5, hits 5,
  misses 1 and the uncached tree, in process and through ``python -m
  anovos_tpu_torch ... --resume`` after an ``os._exit``;
* the port's cached tree against JAX's cached tree, within the bands of
  the other tree comparisons (``test_torch_workflow.assert_dirs_close``);
* the end-of-run sweep evicts under a cap below the store's size.
"""

import copy
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_workflow import assert_dirs_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mini_data(tmp_path_factory):
    """A small synthetic table written once (dataset fingerprints are
    stat-based, so the file must not be rewritten between runs)."""
    d = tmp_path_factory.mktemp("mini_data")
    rng = np.random.default_rng(7)
    pd.DataFrame({
        "age": rng.normal(40, 9, 1500).round(1),
        "fnlwgt": rng.normal(2e5, 4e4, 1500).round(0),
        "workclass": rng.choice(["private", "gov", "self"], 1500),
        "income": rng.choice(["<=50K", ">50K"], 1500),
    }).to_parquet(os.path.join(str(d), "part-0.parquet"), index=False)
    return str(d)


def mini_config(data_dir: str) -> dict:
    return {
        "input_dataset": {"read_dataset": {"file_path": data_dir, "file_type": "parquet"}},
        "stats_generator": {
            "metric": ["global_summary", "measures_of_counts", "measures_of_cardinality"],
            "metric_args": {"list_of_cols": "all", "drop_cols": []},
        },
        "quality_checker": {
            "duplicate_detection": {"list_of_cols": "all", "drop_cols": [], "treatment": True},
            "IDness_detection": {"list_of_cols": "all", "drop_cols": [], "treatment": True,
                                 "treatment_threshold": 0.9},
        },
        "drift_detector": {"drift_statistics": {
            "configs": {"list_of_cols": "all", "drop_cols": [], "method_type": "PSI", "threshold": 0.1},
            "source_dataset": {"read_dataset": {"file_path": data_dir, "file_type": "parquet"}},
        }},
        "report_preprocessing": {"master_path": "report_stats"},
        "write_main": {"file_path": "output", "file_type": "parquet", "file_configs": {"mode": "overwrite"}},
    }


def tree_hash(root, skip=("obs", ".anovos_cache")) -> str:
    """sha256 over (relative path, bytes) of every file under ``root``,
    the run record (``obs/``) and a cache root inside it left out."""
    h = hashlib.sha256()
    root = pathlib.Path(root)
    for p in sorted(root.rglob("*")):
        if p.is_file() and not set(skip) & set(p.relative_to(root).parts):
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def run_main(cfg, workdir, monkeypatch, cache_dir=None, resume=False, package="port"):
    """One sequential ``workflow.main`` of ``package`` in ``workdir`` (made
    here): its manifest."""
    if package == "port":
        from anovos_tpu_torch import workflow
        from anovos_tpu_torch.obs import load_manifest
    else:
        from anovos_tpu import workflow
        from anovos_tpu.obs import load_manifest
    if cache_dir is None:
        monkeypatch.delenv("ANOVOS_TPU_CACHE", raising=False)
    else:
        monkeypatch.setenv("ANOVOS_TPU_CACHE", str(cache_dir))
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    os.makedirs(workdir, exist_ok=True)
    monkeypatch.chdir(workdir)
    workflow.main(copy.deepcopy(cfg), "local", resume=resume)
    return load_manifest(workflow.LAST_MANIFEST_PATH)


def executed(manifest) -> set:
    return {k for k, v in manifest["scheduler"]["nodes"].items() if not v["cached"]}


@pytest.fixture(scope="module")
def cached_runs(mini_data, tmp_path_factory):
    """Each package: an uncached run, a populate run and a full hit (under
    ``ANOVOS_TPU_CACHE_MAX_BYTES=1G``), each in a directory of its own,
    and the port's hit run once more; {(package, run): (dir, manifest)}."""
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")  # before the function-scoped autouse fixture runs
    root = tmp_path_factory.mktemp("cached")
    cfg = mini_config(mini_data)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for package in ("port", "jax"):
            store = root / package / "store"
            for run, cache, cap in (("uncached", None, None), ("populate", store, None),
                                    ("hit", store, "1G"), ("hit2", store, None)):
                if run == "hit2" and package == "jax":
                    continue
                if cap:
                    mp.setenv("ANOVOS_TPU_CACHE_MAX_BYTES", cap)
                d = root / package / run
                out[package, run] = (d, run_main(cfg, d, mp, cache_dir=cache, package=package))
                mp.delenv("ANOVOS_TPU_CACHE_MAX_BYTES", raising=False)
    return out


def test_populate_and_full_hit_count_as_jax(cached_runs):
    for package in ("port", "jax"):
        pop, hit = cached_runs[package, "populate"][1], cached_runs[package, "hit"][1]
        assert (pop["cache"]["hits"], pop["cache"]["misses"]) == (0, 6), package
        assert (hit["cache"]["hits"], hit["cache"]["misses"]) == (6, 0), package
        assert hit["cache"]["uncacheable"] == 0 and hit["cache"]["resumed_from"] == 0
        assert all(n["cached"] for n in hit["scheduler"]["nodes"].values()), package
    assert cached_runs["port", "uncached"][1]["cache"] is None


def test_cached_trees_are_byte_equal_to_the_uncached_tree(cached_runs):
    golden = tree_hash(cached_runs["port", "uncached"][0])
    for run in ("populate", "hit", "hit2"):
        assert tree_hash(cached_runs["port", run][0]) == golden, run


def test_the_hit_is_booked_in_journal_metrics_and_manifest(cached_runs):
    from anovos_tpu_torch.cache import read_journal
    from anovos_tpu_torch.obs import stable_view

    d, m = cached_runs["port", "hit"]
    journal = read_journal(str(d / "report_stats" / "obs" / "run_journal.jsonl"))
    assert [r["event"] for r in journal] == ["run_begin"] + ["node_restored"] * 6 + ["run_end"]
    assert journal[0]["cache_root"] == m["cache"]["root"] and journal[-1]["hits"] == 6
    assert m["metrics"]["cache_hits_total"]["series"] and m["metrics"]["cache_restore_seconds"]["series"]
    assert m["metrics"]["cache_store_nodes"]["series"][""] == 6
    assert m["cache"]["enabled"] and m["cache"]["restore_s"] > 0
    pm = cached_runs["port", "populate"][1]
    assert pm["metrics"]["cache_misses_total"]["series"] and "cache_hits_total" not in pm["metrics"]
    # two hit runs of one config compare equal under stable_view
    assert stable_view(m) == stable_view(cached_runs["port", "hit2"][1])
    assert set(m["cache"]) == set(cached_runs["jax", "hit"][1]["cache"])


def test_the_cached_tree_stays_within_the_jax_bands(cached_runs):
    assert_dirs_close(str(cached_runs["port", "hit"][0]), str(cached_runs["jax", "hit"][0]))


def test_incremental_edit_reexecutes_the_jax_cone(cached_runs, mini_data, tmp_path, monkeypatch):
    cfg = mini_config(mini_data)
    cfg["quality_checker"]["IDness_detection"]["treatment_threshold"] = 0.8
    got = {}
    for package in ("port", "jax"):
        store = cached_runs[package, "populate"][0].parent / "store"
        got[package] = run_main(cfg, tmp_path / package, monkeypatch, cache_dir=store, package=package)
    assert executed(got["port"]) == executed(got["jax"]) == {
        "quality_checker/duplicate_detection", "quality_checker/IDness_detection",
        "drift_detector/drift_statistics"}
    run_main(cfg, tmp_path / "scratch", monkeypatch)
    assert tree_hash(tmp_path / "port") == tree_hash(tmp_path / "scratch")


def _kill_drift(monkeypatch, error):
    import anovos_tpu_torch.drift_stability.drift_detector as dd

    monkeypatch.setattr(dd, "statistics", lambda *a, **k: (_ for _ in ()).throw(error))


def test_killed_run_resumes_to_the_golden_tree(cached_runs, mini_data, tmp_path, monkeypatch):
    """The drift node dies after stats and quality committed; ``--resume``
    in the same directory restores the frontier and executes the drift."""
    from anovos_tpu_torch.cache import committed_fingerprints, read_journal

    cfg = mini_config(mini_data)
    store, d = tmp_path / "store", tmp_path / "crashed"
    with monkeypatch.context() as mp:
        _kill_drift(mp, KeyboardInterrupt("simulated kill"))
        with pytest.raises(KeyboardInterrupt):
            run_main(cfg, d, mp, cache_dir=store)
    records = read_journal(str(d / "report_stats" / "obs" / "run_journal.jsonl"))
    assert len(committed_fingerprints(records)) == 5
    failed = [r for r in records if r["event"] == "node_failed"]
    assert [r["node"] for r in failed] == ["drift_detector/drift_statistics"]
    m = run_main(cfg, d, monkeypatch, cache_dir=store, resume=True)
    assert m["cache"]["resumed_from"] == 5
    assert (m["cache"]["hits"], m["cache"]["misses"]) == (5, 1)
    assert executed(m) == {"drift_detector/drift_statistics"}
    assert tree_hash(d) == tree_hash(cached_runs["port", "uncached"][0])


def test_cli_kill_and_resume(cached_runs, mini_data, tmp_path):
    """``python -m anovos_tpu_torch`` killed hard (``os._exit``) inside the
    drift node, then run again with ``--resume`` in the same directory
    with ``ANOVOS_TPU_CACHE`` unset: the root defaults to ``.anovos_cache``
    there, the five committed nodes restore, and the tree is the uncached
    one."""
    import yaml

    from anovos_tpu_torch.obs import load_manifest

    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(mini_config(mini_data), sort_keys=False))
    work = tmp_path / "work"
    work.mkdir()
    prelude = ("import runpy, sys, os; from anovos_tpu_torch.shared.runtime import init_runtime; "
               "init_runtime('cpu'); ")
    kill = ("import anovos_tpu_torch.drift_stability.drift_detector as dd; "
            "dd.statistics = lambda *a, **k: os._exit(9); ")
    env = {k: v for k, v in os.environ.items() if k != "ANOVOS_TPU_CACHE"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", ANOVOS_TPU_EXECUTOR="sequential")
    out = []
    for code, argv, extra in ((kill, [], {"ANOVOS_TPU_CACHE": ".anovos_cache"}), ("", ["--resume"], {})):
        run = f"sys.argv = ['anovos_tpu_torch', {str(cfg_path)!r}, 'local', *{argv!r}]; " \
              "runpy.run_module('anovos_tpu_torch', run_name='__main__')"
        out.append(subprocess.run([sys.executable, "-c", prelude + code + run], cwd=str(work),
                                  env=dict(env, **extra), capture_output=True, text=True, timeout=300))
    assert out[0].returncode == 9, out[0].stderr[-2000:]
    assert out[1].returncode == 0, out[1].stderr[-3000:]
    assert "previously committed node result(s)" in out[1].stderr
    m = load_manifest(str(work / "report_stats" / "obs" / "run_manifest.json"))
    assert m["cache"]["root"] == str(work / ".anovos_cache")
    assert m["cache"]["resumed_from"] == 5 and (m["cache"]["hits"], m["cache"]["misses"]) == (5, 1)
    assert tree_hash(work) == tree_hash(cached_runs["port", "uncached"][0])


def test_the_end_of_run_sweep_evicts_below_the_cap(cached_runs, mini_data, tmp_path, monkeypatch, caplog):
    import logging
    import shutil

    from anovos_tpu_torch.cache import CacheStore

    store = tmp_path / "store"
    shutil.copytree(cached_runs["port", "populate"][0].parent / "store", store)
    size = CacheStore(str(store)).total_bytes()
    monkeypatch.setenv("ANOVOS_TPU_CACHE_MAX_BYTES", str(size // 2))
    with caplog.at_level(logging.INFO, logger="anovos_tpu_torch.workflow"):
        m = run_main(mini_config(mini_data), tmp_path / "w", monkeypatch, cache_dir=store)
    assert m["cache"]["hits"] == 6
    assert CacheStore(str(store)).total_bytes() <= size // 2
    assert any("cache gc:" in r.getMessage() and "evicted" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_sweep_that_evicts_every_entry_keeps_the_final_dataset(cached_runs, mini_data, tmp_path, monkeypatch,
                                                                 package):
    """A full hit under a 1-byte cap: the sweep evicts every entry, the
    final df's payload among them.  The port loads the restored final df
    before it sweeps and writes the uncached tree; the JAX runner sweeps
    first and fails on the evicted payload (a fault of the reference the
    port does not copy)."""
    import shutil

    from anovos_tpu_torch.cache import CacheStore

    store = tmp_path / "store"
    shutil.copytree(cached_runs[package, "populate"][0].parent / "store", store)
    monkeypatch.setenv("ANOVOS_TPU_CACHE_MAX_BYTES", "1")
    if package == "jax":
        with pytest.raises(FileNotFoundError):
            run_main(mini_config(mini_data), tmp_path / "w", monkeypatch, cache_dir=store, package="jax")
        return
    m = run_main(mini_config(mini_data), tmp_path / "w", monkeypatch, cache_dir=store)
    assert (m["cache"]["hits"], m["cache"]["misses"]) == (6, 0)
    assert CacheStore(str(store)).manifests() == []
    assert tree_hash(tmp_path / "w") == tree_hash(cached_runs["port", "uncached"][0])
