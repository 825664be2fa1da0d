"""The port's run record against the JAX package's: both runners on one
sequential run of ``tests/test_obs.py``'s mini config (800 synthesized
income rows), each with ``ANOVOS_TPU_TRACE=1``, in a working directory of
its own.

* ``write_manifest`` of one dict and ``config_hash`` of one config: the
  same bytes and digest; ``KNOWN_ENV_KNOBS`` the same list and
  ``env_fingerprint`` the JAX digest of the port's backend and count;
* the two manifests: the same keys, and ``stable_view`` equal but for
  the entries of :data:`MANIFEST_DIFFERENCES`, each with its reason; the
  port's summary keys are JAX's plus the two it strips by name;
* the node spans of the two Chrome traces: the same names;
* ``run_timings_gen`` and ``_devprof_split_html`` of one manifest: the
  same HTML bytes;
* the ops' ``@timed`` labels: the same (label, parent) pairs on the same
  calls, directly and through a warm run of each runner;
* ``ANOVOS_PROFILE`` on the CPU: ``workflow.run`` writes a profiler trace
  holding the node ranges.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_obs import mini_cfg, mini_parquet

# Every way the port's manifest may differ from the JAX one on the same
# sequential run, as (section, key) -> reason: a key one side lacks, or a
# value of stable_view that differs.  Nothing else may differ.
MANIFEST_DIFFERENCES = {
    ("scheduler", "n_devices"):
        "value: the JAX package runs on the tests' 8 virtual CPU devices (tests/conftest.py), "
        "the port on one device; each summary states its own runtime's count",
    ("resilience", "failover_retries"):
        "JAX only: the port has no backend failover (ROADMAP.md Queue A item 4), so no "
        "failover re-execution to count (the section is stripped by stable_view)",
    ("resilience", "failovers"):
        "JAX only: as failover_retries",
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners on the mini config, sequential, traced: {"jax": dir,
    "port": dir, "jax_manifest", "port_manifest"}."""
    from anovos_tpu import obs as jobs
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import obs as pobs
    from anovos_tpu_torch import workflow as pwf
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")
    root = tmp_path_factory.mktemp("record")
    cfg = mini_cfg(mini_parquet(root))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
        mp.setenv("ANOVOS_TPU_TRACE", "1")
        for name, wf, ob in (("jax", jwf, jobs), ("port", pwf, pobs)):
            d = root / name
            d.mkdir()
            mp.chdir(d)
            wf.main(copy.deepcopy(cfg), "local")
            out[name] = str(d)
            out[f"{name}_manifest"] = ob.load_manifest(wf.LAST_MANIFEST_PATH)
    return out


def test_write_manifest_bytes_equal_jax(tmp_path):
    from anovos_tpu.obs import write_manifest as jwrite
    from anovos_tpu_torch.obs import write_manifest

    man = {"b": [1, 2.5, None, "é"], "a": {"z": 1.0, "y": {"x": True}}, "generated_unix": 1.125}
    p, j = write_manifest(man, str(tmp_path / "p" / "m.json")), jwrite(man, str(tmp_path / "j" / "m.json"))
    with open(p, "rb") as fp, open(j, "rb") as fj:
        assert fp.read() == fj.read()


def test_config_hash_equals_jax():
    from anovos_tpu.obs import config_hash as jhash
    from anovos_tpu_torch.obs import config_hash
    from test_torch_workflow import load_config

    for name in ("configs_basic.yaml", "configs_full.yaml"):
        cfg = load_config(name)
        assert config_hash(cfg) == jhash(cfg)


def test_env_fingerprint_is_the_jax_digest_of_the_runtime(monkeypatch):
    import anovos_tpu.cache.fingerprint as jf

    from anovos_tpu_torch.cache import fingerprint as pf

    assert pf.KNOWN_ENV_KNOBS == jf.KNOWN_ENV_KNOBS
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "exc@node:x")
    knobs = {k: os.environ.get(k, "") for k in jf.KNOWN_ENV_KNOBS}
    assert pf.env_fingerprint() == jf.digest(jf.canonical(knobs), "cpu", "1")


def test_manifests_have_the_same_keys(runs):
    from anovos_tpu_torch.obs.manifest import PORT_ONLY_NODE_FIELDS

    jm, pm = runs["jax_manifest"], runs["port_manifest"]
    assert sorted(pm) == sorted(jm)
    assert set(pm["scheduler"]) == set(jm["scheduler"])
    assert set(PORT_ONLY_NODE_FIELDS) == {"stream"}
    for name, node in pm["scheduler"]["nodes"].items():
        assert set(node) == set(jm["scheduler"]["nodes"][name]) | {"stream"}
    jax_only = {k for section, k in MANIFEST_DIFFERENCES if section == "resilience"}
    assert set(pm["resilience"]) == set(jm["resilience"]) - jax_only
    assert set(pm["scheduler"]["resilience"]) == set(jm["scheduler"]["resilience"]) - jax_only
    assert set(pm["env"]) == set(jm["env"])
    assert pm["backend"] == jm["backend"] == "cpu"
    assert pm["compile_census"] is None and pm["cache"] is None


def test_stable_view_equals_jax_but_for_the_named_differences(runs):
    from anovos_tpu.obs import stable_view as jstable
    from anovos_tpu_torch.obs import stable_view

    got, exp = stable_view(runs["port_manifest"]), jstable(runs["jax_manifest"])
    differing = set()
    for section in sorted(set(got) | set(exp)):
        g, e = got.get(section), exp.get(section)
        if isinstance(g, dict) and isinstance(e, dict):
            differing |= {(section, k) for k in set(g) | set(e) if g.get(k) != e.get(k)}
        elif g != e:
            differing.add((section, None))
    assert differing == {d for d in MANIFEST_DIFFERENCES if d[0] in got}, differing
    assert got["metrics"]["rows_ingested_total"] == exp["metrics"]["rows_ingested_total"]
    assert got["scheduler"]["nodes"] == exp["scheduler"]["nodes"] != {}


def test_trace_node_spans_equal_jax(runs):
    def node_spans(root):
        with open(os.path.join(root, "report_stats", "obs", "trace.json")) as f:
            doc = json.load(f)
        return {e["name"] for e in doc["traceEvents"] if e.get("cat") == "node" and e["ph"] == "X"}

    got, exp = node_spans(runs["port"]), node_spans(runs["jax"])
    assert got == exp
    assert {"input_dataset/ETL", "quality_checker/duplicate_detection"} <= got
    assert got - {"input_dataset/ETL"} == set(runs["port_manifest"]["scheduler"]["nodes"])


def test_run_timings_html_equals_jax(runs, tmp_path):
    """Both renderers' Run Timings tab over one manifest (the port run's,
    then the JAX run's): the same bytes; the devprof split too."""
    from anovos_tpu.data_report import report_generation as jrg
    from anovos_tpu_torch.data_report import report_generation as prg
    from anovos_tpu_torch.obs import write_manifest

    for which in ("port_manifest", "jax_manifest"):
        d = tmp_path / which
        write_manifest(runs[which], str(d / "obs" / "run_manifest.json"))
        prg._table_seq[0] = jrg._table_seq[0] = 0  # the tables' ids count from the report's start
        got, exp = prg.run_timings_gen(str(d)), jrg.run_timings_gen(str(d))
        assert got == exp and "Workflow Run Timings" in got
    dev = runs["port_manifest"]["devprof"]
    assert dev and prg._devprof_split_html(dev) == jrg._devprof_split_html(dev)
    assert "Device-time attribution" in prg._devprof_split_html(dev)


def test_report_over_a_finished_run_gains_the_run_timings_tab(runs, tmp_path):
    """A report rendered over the port run's report_stats, which now holds
    its manifest, has the Run Timings tab last, as the JAX renderer's over
    the same tree."""
    import shutil

    from anovos_tpu.data_report.report_generation import anovos_report as janovos_report
    from anovos_tpu_torch.data_report.report_generation import anovos_report
    from test_torch_workflow import report_tabs

    master = tmp_path / "master"
    shutil.copytree(os.path.join(runs["port"], "report_stats"), master)
    htmls = []
    for fn, out in ((anovos_report, "p"), (janovos_report, "j")):
        with open(fn(master_path=str(master), final_report_path=str(tmp_path / out))) as f:
            htmls.append(f.read())
    assert report_tabs(htmls[0]) == report_tabs(htmls[1])
    assert report_tabs(htmls[0])[-1] == "Run Timings"


# ---------------------------------------------------------------------------
# @timed labels
# ---------------------------------------------------------------------------

def _op_pairs(tracer) -> set:
    return {(s.name, s.args.get("parent")) for s in tracer.snapshot() if s.cat == "op"}


# (label, parent) pairs the port books and the JAX package does not: the
# port's describe_numeric takes its moments from masked_moments (B1 on the
# card), a timed op of its own, where the JAX describe_numeric computes
# them inline in its one jitted program
PORT_ONLY_OP_PAIRS = {("ops.masked_moments", "ops.describe_numeric")}


def _direct_calls():
    """(name, JAX call, port call) on the same seeded (1000, 3) block."""
    import jax.numpy as jnp

    import anovos_tpu.ops.correlation as jc
    import anovos_tpu.ops.datetime_kernels as jdt
    import anovos_tpu.ops.describe as jd
    import anovos_tpu.ops.hll as jh
    import anovos_tpu.ops.quantiles as jq
    import anovos_tpu.ops.reductions as jr
    import anovos_tpu.ops.segment as js
    import anovos_tpu_torch.ops.correlation as pc
    import anovos_tpu_torch.ops.datetime_kernels as pdt
    import anovos_tpu_torch.ops.describe as pd_
    import anovos_tpu_torch.ops.hll as ph
    import anovos_tpu_torch.ops.quantiles as pq
    import anovos_tpu_torch.ops.reductions as pr
    import anovos_tpu_torch.ops.segment as ps

    g = np.random.default_rng(11)
    X = g.normal(size=(1000, 3)).astype(np.float32)
    M = g.random((1000, 3)) > 0.1
    secs = g.integers(0, 2**30, 1000).astype(np.int32)
    jX, jM, pX, pM = jnp.asarray(X), jnp.asarray(M), torch.from_numpy(X), torch.from_numpy(M)
    return [
        ("masked_moments", lambda: jr.masked_moments(jX, jM), lambda: pr.masked_moments(pX, pM)),
        ("describe_numeric", lambda: jd.describe_numeric(jX, jM), lambda: pd_.describe_numeric(pX, pM)),
        ("masked_quantiles", lambda: jq.masked_quantiles(jX, jM, jnp.asarray([0.25, 0.5], jnp.float32)),
         lambda: pq.masked_quantiles(pX, pM, [0.25, 0.5])),
        ("masked_corr", lambda: jc.masked_corr(jX, jM), lambda: pc.masked_corr(pX, pM)),
        ("masked_cov", lambda: jc.masked_cov(jX, jM), lambda: pc.masked_cov(pX, pM)),
        ("masked_nunique", lambda: js.masked_nunique(jX, jM), lambda: ps.masked_nunique(pX, pM)),
        ("hll_registers", lambda: jh.hll_registers(jX, jM, 10), lambda: ph.hll_registers(pX, pM, 10)),
        ("extract_unit", lambda: jdt.extract_unit(jnp.asarray(secs), "day"),
         lambda: pdt.extract_unit(torch.from_numpy(secs), "day")),
    ]


def test_timed_labels_of_direct_calls_equal_jax():
    from anovos_tpu import obs as jobs
    from anovos_tpu_torch import obs as pobs

    for name, jcall, pcall in _direct_calls():
        for _ in range(2):  # a first call and a steady-state one
            jobs.get_tracer().clear()
            pobs.get_tracer().clear()
            jcall()
            pcall()
            assert _op_pairs(jobs.get_tracer()) == {(f"ops.{name}", None)}
            assert _op_pairs(pobs.get_tracer()) - PORT_ONLY_OP_PAIRS == {(f"ops.{name}", None)}


def test_timed_labels_of_a_warm_run_equal_jax(tmp_path, monkeypatch):
    """The (label, parent) pairs of a second run of each runner on
    tools/chaos_run.py's synthetic config (stats, quality checks, drift):
    equal.  (A first JAX run also books the ops its programs call while
    jax traces them, which a warm run does not.)"""
    from tools.chaos_run import synthetic_config

    from anovos_tpu import obs as jobs
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import obs as pobs
    from anovos_tpu_torch import workflow as pwf

    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.delenv("ANOVOS_TPU_CHAOS", raising=False)
    cfg = synthetic_config(str(tmp_path))
    pairs = {}
    for name, wf, ob in (("jax", jwf, jobs), ("port", pwf, pobs)):
        for rep in range(2):
            d = tmp_path / f"{name}{rep}"
            d.mkdir()
            monkeypatch.chdir(d)
            wf.main(copy.deepcopy(cfg), "local")
        pairs[name] = _op_pairs(ob.get_tracer())
    assert pairs["port"] - PORT_ONLY_OP_PAIRS == pairs["jax"]
    assert PORT_ONLY_OP_PAIRS <= pairs["port"]
    assert {"ops.table_describe", "ops.describe_numeric", "ops.describe_wide_int",
            "ops.drift_side_full"} <= {label for label, _ in pairs["port"]}


# ---------------------------------------------------------------------------
# ANOVOS_PROFILE
# ---------------------------------------------------------------------------

def test_profile_writes_a_trace_with_node_ranges(tmp_path, monkeypatch):
    """``workflow.run`` under ANOVOS_PROFILE=<dir> on the CPU runtime: one
    Chrome-format profiler trace in <dir>, holding a range for every node
    of the run (the node brackets' record_function)."""
    import yaml

    from anovos_tpu_torch import workflow

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(mini_cfg(mini_parquet(tmp_path, 300))))
    prof = tmp_path / "profile"
    monkeypatch.setenv("ANOVOS_PROFILE", str(prof))
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.chdir(tmp_path)
    workflow.run(str(cfg_path), "local")
    (path,) = list(prof.iterdir())
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    nodes = set(workflow.LAST_RUN_SUMMARY["nodes"])
    assert nodes and nodes <= names


def test_profile_records_the_card_when_no_runtime_is_set(tmp_path, monkeypatch):
    """``python -m anovos_tpu_torch`` sets no runtime before ``workflow.run``:
    under ANOVOS_PROFILE the profiler takes the runtime main would take
    (the card where there is one) and records its CUDA activity.  The card
    is faked (``torch.cuda.is_available``), as are ``main`` and the
    profiler, which only note what they were given."""
    from torch.profiler import ProfilerActivity

    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.shared import runtime

    seen = {}

    class Profile:
        def __init__(self, activities, **kw):
            seen["activities"] = list(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

        def export_chrome_trace(self, path):
            seen["trace"] = path

    def main(all_configs, run_type, auth_key_val, resume=False):
        seen["runtime"] = runtime.peek_runtime()

    monkeypatch.setattr(runtime, "_RUNTIME", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: seen.setdefault("synced", device))
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(workflow, "main", main)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text("{}\n")
    monkeypatch.setenv("ANOVOS_PROFILE", str(tmp_path / "profile"))
    monkeypatch.chdir(tmp_path)
    workflow.run(str(cfg_path), "local")
    assert seen["runtime"].device == torch.device("cuda", 0)
    assert ProfilerActivity.CUDA in seen["activities"] and ProfilerActivity.CPU in seen["activities"]
    assert seen["synced"] == torch.device("cuda", 0)
    assert seen["trace"].startswith(str(tmp_path / "profile"))
