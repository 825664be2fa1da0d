"""The node cache on the shipped configs through the port's runner, on the
CPU at ``test_torch_workflow.income_data``'s 2,000 rows:

* ``configs_basic`` and ``configs_full``: the nodes that get a cache key
  are the JAX runner's, name for name (each runner stopped at its
  scheduler's ``run``);
* ``configs_basic`` (join, ts auto-detection, the basic report), in the
  default executor mode: the populate run and the full hit give the
  uncached tree byte for byte; an edit of the basic report's options
  re-executes the report alone, on the df version restored from the
  cache (its timestamp columns converted by ts auto-detection), and gives
  the tree of an uncached run of the edited config;
* ``configs_full``: the full hit's tree equals the uncached tree byte for
  byte, so every file a node writes is captured (pyarrow's parquet and
  CSV parts, the appended stability metrics, the models).
"""

import copy
import os

import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_cache_workflow import tree_hash
from test_torch_workflow import basic_config, income_data
from test_torch_workflow_full import full_config


class _Registered(Exception):
    pass


def cacheable_nodes(package: str, cfg: dict, workdir, monkeypatch) -> list:
    """The names of the nodes ``package``'s runner gives a cache key on
    ``cfg``: its scheduler is stopped at ``run``."""
    if package == "port":
        from anovos_tpu_torch import workflow
        from anovos_tpu_torch.parallel.scheduler import DagScheduler
    else:
        from anovos_tpu import workflow
        from anovos_tpu.parallel.scheduler import DagScheduler
    seen = []

    def stop(self, *a, **k):
        seen.extend(n.name for n in self._nodes if n.fingerprint is not None)
        raise _Registered()

    monkeypatch.setattr(DagScheduler, "run", stop)
    monkeypatch.setenv("ANOVOS_TPU_CACHE", str(workdir / "store"))
    os.makedirs(workdir)
    monkeypatch.chdir(workdir)
    with pytest.raises(_Registered):
        workflow.main(copy.deepcopy(cfg), "local")
    monkeypatch.undo()
    return seen


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")
    return income_data(str(tmp_path_factory.mktemp("income")))


@pytest.mark.parametrize("name", ["configs_basic", "configs_full"])
def test_the_cacheable_nodes_are_jax_s(name, data, tmp_path):
    cfg = basic_config(data["main"], data["join"]) if name == "configs_basic" else full_config(data)
    got = {}
    for package in ("port", "jax"):
        with pytest.MonkeyPatch.context() as mp:
            got[package] = cacheable_nodes(package, cfg, tmp_path / package, mp)
    assert got["port"] == got["jax"]
    if name == "configs_basic":
        assert got["port"] == ["join_dataset", "timeseries_analyzer/auto_detection", "anovos_basic_report"]
    else:
        assert "report_generation" not in got["port"] and len(got["port"]) > 20


def _run(cfg, workdir, cache=None, mode=None):
    """``workflow.main`` in ``workdir``: (its manifest's cache section, its
    executed nodes)."""
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.obs import load_manifest

    with pytest.MonkeyPatch.context() as mp:
        if cache is None:
            mp.delenv("ANOVOS_TPU_CACHE", raising=False)
        else:
            mp.setenv("ANOVOS_TPU_CACHE", str(cache))
        if mode is None:
            mp.delenv("ANOVOS_TPU_EXECUTOR", raising=False)
        else:
            mp.setenv("ANOVOS_TPU_EXECUTOR", mode)
        os.makedirs(workdir)
        mp.chdir(workdir)
        workflow.main(copy.deepcopy(cfg), "local")
    m = load_manifest(workflow.LAST_MANIFEST_PATH)
    return m["cache"], {k for k, v in m["scheduler"]["nodes"].items() if not v["cached"]}


def test_configs_basic_incremental_report_on_the_restored_df(data, tmp_path):
    cfg = basic_config(data["main"], data["join"])
    store = tmp_path / "store"
    _run(cfg, tmp_path / "uncached")
    golden = tree_hash(tmp_path / "uncached")
    pop, ran = _run(cfg, tmp_path / "populate", store)
    assert (pop["hits"], pop["misses"]) == (0, 3) and tree_hash(tmp_path / "populate") == golden
    hit, ran = _run(cfg, tmp_path / "hit", store)
    assert (hit["hits"], hit["misses"], ran) == (3, 0, set())
    assert tree_hash(tmp_path / "hit") == golden
    edited = copy.deepcopy(cfg)
    edited["anovos_basic_report"]["report_args"]["event_label"] = "<=50K"
    inc, ran = _run(edited, tmp_path / "incremental", store)
    assert (inc["hits"], inc["misses"], ran) == (2, 1, {"anovos_basic_report"})
    _run(edited, tmp_path / "edited_uncached")
    assert tree_hash(tmp_path / "incremental") == tree_hash(tmp_path / "edited_uncached")


def test_configs_full_hit_tree_is_the_uncached_tree(data, tmp_path):
    cfg = full_config(data)
    store = tmp_path / "store"
    _run(cfg, tmp_path / "uncached", mode="sequential")
    pop, _ = _run(cfg, tmp_path / "populate", store, mode="sequential")
    hit, ran = _run(cfg, tmp_path / "hit", store, mode="sequential")
    assert pop["hits"] == 0 and hit["misses"] == 0 and hit["hits"] == pop["misses"]
    assert ran == {"report_generation"}
    golden = tree_hash(tmp_path / "uncached")
    assert tree_hash(tmp_path / "populate") == golden
    assert tree_hash(tmp_path / "hit") == golden
