"""Both runners in both executor modes on every shipped config, the JAX
gate's way (``tests/test_workflow_scheduler.py::
test_executor_modes_produce_identical_artifacts``): each (package, mode)
runs all nine configs in one subprocess (the JAX package on a single CPU
device), under ``ANOVOS_TPU_NODE_TIMEOUT`` and a hard timeout, each config
in a working directory of its own, on the small inputs of the port's
per-config tests (2,000 income rows; the sales, segmentation and check-in
frames).  ``obs/`` is left out everywhere.

* The port's two modes write the same bytes: every file, the report HTML
  included, and the same schedule (nodes and their dependencies).
* So do the JAX package's two modes.
* Across packages, in each mode: the same files, the same schedule, the
  same degraded sections and reports with the same tabs, the Degraded
  Sections tab equal.  The values in
  the files are held to JAX's by the per-config tests
  (``test_torch_workflow*.py``); the segmentation config's autoencoder
  draws from each package's own generator here.
* A chaos hang on a fan-out node of ``configs_full`` under a 30 s bound:
  both runners escalate, abandon and degrade the node, finish the run and
  name the node in the report's Degraded Sections tab.
"""

import json
import os
import subprocess
import sys

import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_scheduler import tree_hashes
from test_torch_workflow import assert_report_close, basic_config, degraded_tab, income_data, report_tabs, tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["configs_basic", "configs_full", "configs", "configs_mlflow", "configs_feast",
           "configs_time_series", "configs_geospatial", "configs_sales_supervised",
           "configs_segmentation_unsupervised"]
HANG_NODE = "association_evaluator/IV_calculation"
# configs_feast's two timestamp columns (each run's own time)
FEAST_STAMPS = ["event_time", "create_time_col"]
# the watchdog's bound in the hang runs: above any real node's wall there
# (JAX compiles included), since it bounds every node
HANG_BOUND = 30

_RUNNER = """
import json, logging, os, sys, warnings
logging.disable(logging.WARNING)
warnings.filterwarnings("ignore")
sys.modules["mlflow"] = None  # the mlflow config runs without mlflow, as in its per-config test
package, jobs_path, out_path = sys.argv[1:]
if package == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from anovos_tpu import workflow
    from anovos_tpu.resilience import policy
else:
    from anovos_tpu_torch.shared.runtime import init_runtime
    init_runtime("cpu")
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.resilience import policy
with open(jobs_path) as f:
    jobs = json.load(f)
out = {}
for name, cfg, run_dir in jobs:
    os.makedirs(run_dir)
    os.chdir(run_dir)
    workflow.main(cfg, "local")
    s = workflow.LAST_RUN_SUMMARY
    out[name] = {"mode": s["mode"], "critical_path": s["critical_path"],
                 "nodes": {k: v["deps"] for k, v in s["nodes"].items()},
                 "states": {k: v["state"] for k, v in s["nodes"].items()},
                 "degraded": policy.degraded_sections()}
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def shipped_configs(root: str) -> dict:
    """{name: config} of the nine shipped configs on the per-config tests'
    inputs, written under ``root``."""
    from test_torch_workflow_checkin import _csv, checkin_config, checkin_frame
    from test_torch_workflow_configs import sales_config, segmentation_config
    from test_torch_workflow_full import full_config
    from test_torch_workflow_scenarios import (feast_config, income_config, income_scenario_data,
                                               mlflow_config)
    from examples._data import synthesize

    income = income_data(os.path.join(root, "basic"))
    scenario = income_scenario_data(os.path.join(root, "scenario"))
    num = synthesize(1500, seed=3).select_dtypes("number").drop(columns=["empty", "logfnl"])
    ck = os.path.join(root, "checkin")
    checkin = {"checkin": _csv(ck, "checkin", checkin_frame(2000, 8)),
               "stability": [_csv(ck, f"si{i}", num.iloc[i * 500:(i + 1) * 500]) for i in range(3)]}
    cfgs = {
        "configs_basic": basic_config(income["main"], income["join"]),
        "configs_full": full_config(income),
        "configs": income_config(scenario),
        "configs_mlflow": mlflow_config(scenario),
        "configs_feast": feast_config(scenario),
        "configs_time_series": checkin_config("configs_time_series.yaml", checkin),
        "configs_geospatial": checkin_config("configs_geospatial.yaml", checkin),
        "configs_sales_supervised": sales_config(os.path.join(root, "sales")),
        "configs_segmentation_unsupervised": segmentation_config(os.path.join(root, "segmentation")),
    }
    assert sorted(cfgs) == sorted(CONFIGS)
    return cfgs


def _launch(package: str, jobs: list, root: str, tag: str, env_extra: dict):
    jobs_path = os.path.join(root, f"jobs_{tag}.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    runner = os.path.join(root, "runner.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="", CUDA_VISIBLE_DEVICES="",
               ANOVOS_TPU_NODE_TIMEOUT="300",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(env_extra)
    for knob in ("ANOVOS_TPU_CHAOS", "ANOVOS_PERF_LEDGER", "ANOVOS_RUN_DIFF_BASELINE"):
        if knob not in env_extra:
            env.pop(knob, None)
    out_path = os.path.join(root, f"summary_{tag}.json")
    proc = subprocess.Popen([sys.executable, runner, package, jobs_path, out_path], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out_path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Six subprocesses at once: each package in each mode over the nine
    configs, and each package's chaos-hang run of configs_full."""
    root = str(tmp_path_factory.mktemp("executor"))
    with open(os.path.join(root, "runner.py"), "w") as f:
        f.write(_RUNNER)
    cfgs = shipped_configs(os.path.join(root, "data"))
    procs = {}
    for package in ("jax", "port"):
        for mode in ("sequential", "concurrent"):
            jobs = [(name, cfgs[name], os.path.join(root, package, mode, name)) for name in CONFIGS]
            procs[(package, mode)] = _launch(package, jobs, root, f"{package}_{mode}",
                                             {"ANOVOS_TPU_EXECUTOR": mode})
        hang = [("configs_full", cfgs["configs_full"], os.path.join(root, package, "hang"))]
        procs[(package, "hang")] = _launch(package, hang, root, f"{package}_hang", {
            "ANOVOS_TPU_EXECUTOR": "concurrent", "ANOVOS_TPU_NODE_TIMEOUT": str(HANG_BOUND),
            "ANOVOS_TPU_CHAOS": f"hang@node:{HANG_NODE}:secs=600:n=5"})
    out = {"root": root}
    for key, (proc, path) in procs.items():
        try:
            _, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for p, _ in procs.values():
                p.kill()
            raise
        assert proc.returncode == 0, f"{key} failed:\n{err[-4000:]}"
        with open(path) as f:
            out[key] = json.load(f)
    return out


def _dir(runs, package, mode, name):
    return os.path.join(runs["root"], package, mode, name)


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("name", CONFIGS)
def test_modes_write_the_same_bytes(runs, package, name):
    """Every file byte-equal between the modes, but configs_feast's final
    dataset, whose two timestamp columns hold each run's own time: that
    one equal without them."""
    import pandas as pd

    dirs = [_dir(runs, package, mode, name) for mode in ("sequential", "concurrent")]
    seq, conc = (tree_hashes(d) for d in dirs)
    assert seq and (name == "configs_feast" or any(p.endswith("ml_anovos_report.html") for p in seq))
    assert set(seq) == set(conc)
    differ = [p for p in seq if seq[p] != conc[p]]
    if name == "configs_feast":
        stamps = [p for p in differ if p.startswith("output/final_dataset/part-")]
        for p in stamps:
            a, b = (pd.read_parquet(os.path.join(d, p)) for d in dirs)
            pd.testing.assert_frame_equal(a.drop(columns=FEAST_STAMPS), b.drop(columns=FEAST_STAMPS))
        differ = [p for p in differ if p not in stamps]
    assert differ == []
    s_seq, s_conc = runs[(package, "sequential")][name], runs[(package, "concurrent")][name]
    assert (s_seq["mode"], s_conc["mode"]) == ("sequential", "concurrent")
    assert s_seq["nodes"] == s_conc["nodes"]
    assert s_seq["degraded"] == s_conc["degraded"]


@pytest.mark.parametrize("mode", ["sequential", "concurrent"])
@pytest.mark.parametrize("name", CONFIGS)
def test_runners_write_the_same_files_and_schedule(runs, mode, name):
    got, exp = (_dir(runs, p, mode, name) for p in ("port", "jax"))
    assert tree(got) == tree(exp)
    port, jax = runs[("port", mode)][name], runs[("jax", mode)][name]
    assert port["nodes"] == jax["nodes"]
    assert port["states"] == jax["states"]
    assert set(port["degraded"]) == set(jax["degraded"])
    for rel in tree(exp):
        if rel.endswith("ml_anovos_report.html"):
            assert_report_close(os.path.join(got, rel), os.path.join(exp, rel))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_chaos_hang_degrades_the_node_and_the_report_names_it(runs, package):
    summary = runs[(package, "hang")]["configs_full"]
    assert summary["states"][HANG_NODE] == "degraded"
    assert list(summary["degraded"]) == [HANG_NODE]
    assert f"escalated bound ({HANG_BOUND}s x1.5)" in summary["degraded"][HANG_NODE]
    assert all(s == "done" for n, s in summary["states"].items() if n != HANG_NODE)
    rdir = os.path.join(runs["root"], package, "hang", "report_stats")
    assert "IV_calculation.csv" not in os.listdir(rdir)
    with open(os.path.join(rdir, "ml_anovos_report.html")) as f:
        html = f.read()
    assert report_tabs(html)[0] == "Degraded Sections"
    assert f"<b>{HANG_NODE}</b>" in degraded_tab(html)


def test_chaos_hang_tabs_equal_across_packages(runs):
    got, exp = (open(os.path.join(runs["root"], p, "hang", "report_stats", "ml_anovos_report.html")).read()
                for p in ("port", "jax"))
    assert report_tabs(got) == report_tabs(exp)
    assert degraded_tab(got) == degraded_tab(exp)
