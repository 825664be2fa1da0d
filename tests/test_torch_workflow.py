"""The port's YAML runner against the JAX package's on
``config/configs_basic.yaml``: both ``workflow.run``s on the same 2,000
synthesized income rows (``examples/_data.py`` ``materialize_income_parquet``;
the join side written as avro by the port's writer, as the config reads
avro), each in a working directory of its own.

Parity standard (ROADMAP.md): integer results exact; f32 statistics within
one unit of the 4th decimal the CSVs are rounded to plus 1e-5 relative
(``ATOL``/``RTOL``); chart counts exact and event rates within 1e-6; the
final dataset equal.  ``obs/`` holds the run manifest in both trees; its
contents are held to JAX's in ``tests/test_torch_run_record.py``.  No file
of this run carries a divergence by design (no sampling at 2,000 rows, no
k-means).  Also here: the port's renderer over the JAX run's
``report_stats`` gives the same bytes, and the port's checkers read the
JAX-written stats CSVs.

The helpers are shared with ``tests/test_torch_workflow_full.py``.
"""

import copy
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

ROWS = 2000
# the CSVs print 4 decimals: one unit of the last, plus f32 accumulation
ATOL = 1e-4 * (1 + 1e-6)
RTOL = 1e-5
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config")


def load_config(name: str) -> dict:
    import yaml

    with open(os.path.join(CONFIG_DIR, name)) as f:
        return yaml.safe_load(f)


def basic_config(main_dir: str, join_dir: str) -> dict:
    """config/configs_basic.yaml with its two read paths pointed at the
    test's files."""
    cfg = load_config("configs_basic.yaml")
    cfg["input_dataset"]["read_dataset"]["file_path"] = main_dir
    cfg["join_dataset"]["dataset1"]["read_dataset"]["file_path"] = join_dir
    return cfg


def income_data(root: str, n: int = ROWS) -> dict:
    """The income schema at ``n`` rows as parquet, its ifa/age/workclass
    join side as avro (written by the port) and four CSV slices of its
    numeric columns for the stability index."""
    from examples._data import materialize_income_parquet, synthesize
    from anovos_tpu_torch.data_ingest.data_ingest import write_dataset
    from anovos_tpu_torch.shared.table import Table

    main_dir, side_dir = materialize_income_parquet(os.path.join(root, "income"), n)
    side = pd.read_parquet(os.path.join(side_dir, "part-00000.parquet"))
    join_dir = os.path.join(root, "income", "join_avro")
    write_dataset(Table.from_pandas(side, device="cpu"), join_dir, "avro")
    num = synthesize(n).select_dtypes("number").drop(columns=["empty", "logfnl"])
    si_dirs = []
    for i in range(4):
        d = os.path.join(root, "income", "stability", str(i))
        os.makedirs(d)
        num.iloc[i * n // 4:(i + 1) * n // 4].to_csv(os.path.join(d, "part-00000.csv"), index=False)
        si_dirs.append(d)
    return {"main": main_dir, "join": join_dir, "stability": si_dirs}


def run_both(cfg: dict, root: str) -> dict:
    """``workflow.run`` of each package on ``cfg`` (written as YAML), each
    in a working directory of its own: {"jax": dir, "port": dir, "block_times":
    the port's}."""
    import yaml

    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow as pwf
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cpu")
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
        mp.delenv("ANOVOS_PERF_LEDGER", raising=False)
        mp.delenv("ANOVOS_RUN_DIFF_BASELINE", raising=False)
        for name, wf in (("jax", jwf), ("port", pwf)):
            d = os.path.join(root, name)
            os.makedirs(d)
            mp.chdir(d)
            wf.run(cfg_path, "local")
            out[name] = d
    out["block_times"] = pwf.block_times()
    out["degraded"] = pwf.degraded_sections()
    return out


def tree(root: str, skip=("obs",)) -> list:
    """Relative paths of the files under ``root``, ``skip`` dirs left out."""
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if x not in skip)
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def assert_csv_close(got_path: str, exp_path: str, atol: float = ATOL, rtol: float = RTOL) -> None:
    """Same columns and rows; columns that hold integers in both files
    equal, other numeric columns within atol + rtol·|exp|, the rest equal
    as text."""
    got, exp = pd.read_csv(got_path), pd.read_csv(exp_path)
    name = os.path.basename(exp_path)
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp), name
    for c in exp.columns:
        g, e = got[c], exp[c]
        if pd.api.types.is_numeric_dtype(e) and pd.api.types.is_numeric_dtype(g):
            g64, e64 = g.to_numpy(np.float64), e.to_numpy(np.float64)
            if pd.api.types.is_integer_dtype(e) and pd.api.types.is_integer_dtype(g):
                np.testing.assert_array_equal(g64, e64, err_msg=f"{name}:{c}")
            else:
                np.testing.assert_allclose(g64, e64, rtol=rtol, atol=atol, equal_nan=True,
                                           err_msg=f"{name}:{c}")
        else:
            assert g.astype(str).tolist() == e.astype(str).tolist(), f"{name}:{c}"


def _assert_json_close(got, exp, exact: bool, where: str) -> None:
    if isinstance(exp, dict):
        assert isinstance(got, dict) and list(got) == list(exp), where
        for k in exp:
            _assert_json_close(got[k], exp[k], exact, f"{where}.{k}")
    elif isinstance(exp, list):
        assert isinstance(got, list) and len(got) == len(exp), where
        for i, (g, e) in enumerate(zip(got, exp)):
            _assert_json_close(g, e, exact, f"{where}[{i}]")
    elif isinstance(exp, float) and not exact:
        assert isinstance(got, (int, float)) and (abs(got - exp) <= 1e-6 or np.isnan(got) and np.isnan(exp)), \
            f"{where}: {got} vs {exp}"
    else:
        assert got == exp, f"{where}: {got!r} vs {exp!r}"


def assert_chart_close(got_path: str, exp_path: str) -> None:
    """Chart JSONs: the same figure; frequency counts exact, every other
    number (event rates, drift frequencies, map points) within 1e-6."""
    with open(got_path) as fg, open(exp_path) as fe:
        got, exp = json.load(fg), json.load(fe)
    name = os.path.basename(exp_path)
    _assert_json_close(got, exp, name.startswith("freqDist_"), name)


def report_tabs(html: str) -> list:
    """The report's tab names, in order."""
    import re

    return re.findall(r"onclick='showTab\(\d+\)'>([^<]*)</button>", html)


def degraded_tab(html: str):
    """The Degraded Sections tab's markup, or None when the report has none."""
    import re

    m = re.search(r"<div class='anv-degraded'>.*?</div>", html, re.S)
    return m.group(0) if m else None


def assert_report_close(got_path: str, exp_path: str) -> None:
    """Two runners' reports: the same tabs in the same order, and the
    Degraded Sections tab, where there is one, equal to the JAX one.
    (The other tabs print the runs' own f32 statistics; ``render_both``
    holds them byte-equal on one tree.)"""
    with open(got_path) as fg, open(exp_path) as fe:
        got, exp = fg.read(), fe.read()
    assert report_tabs(got) == report_tabs(exp)
    assert degraded_tab(got) == degraded_tab(exp)


def assert_dirs_close(got_dir: str, exp_dir: str, rules=None) -> list:
    """Every file of ``exp_dir`` (``obs/`` left out) present in ``got_dir``
    and close: CSVs by ``assert_csv_close``, chart JSONs by
    ``assert_chart_close``, parquet model parts equal, the report HTML by
    ``assert_report_close``.  ``rules``: {file name: check(got_path,
    exp_path)} replacing those.  Returns the relative paths compared."""
    names = tree(exp_dir)
    assert tree(got_dir) == names
    for rel in names:
        gp, ep = os.path.join(got_dir, rel), os.path.join(exp_dir, rel)
        base = os.path.basename(rel)
        if rules and base in rules:
            rules[base](gp, ep)
        elif base == "ml_anovos_report.html":
            assert_report_close(gp, ep)
        elif rel.endswith(".csv"):
            assert_csv_close(gp, ep)
        elif rel.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(gp), pd.read_parquet(ep), obj=rel)
        elif base == "_SUCCESS":
            continue
        else:
            assert_chart_close(gp, ep)
    return names


def render_both(master_src: str, root: str, degraded=None, **kw) -> tuple:
    """Both packages' ``anovos_report`` over one copy of ``master_src``
    (its report HTML and ``obs/`` left out), each into a fresh output dir,
    both packages' degradation and quarantine registries reset and then
    given the same ``degraded`` {section: reason}: (port HTML, JAX HTML)
    as bytes."""
    from anovos_tpu.data_ingest import guard
    from anovos_tpu.data_report.report_generation import anovos_report as janovos_report
    from anovos_tpu.resilience import policy
    from anovos_tpu_torch.data_ingest import guard as pguard
    from anovos_tpu_torch.data_report.report_generation import anovos_report
    from anovos_tpu_torch.resilience import policy as ppolicy

    master = os.path.join(root, "master")
    shutil.copytree(master_src, master,
                    ignore=shutil.ignore_patterns("obs", "ml_anovos_report.html"))
    for pol, grd in ((policy, guard), (ppolicy, pguard)):
        pol.reset_degraded()
        grd.reset()
        for section, reason in (degraded or {}).items():
            pol.record_degraded(section, reason)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ANOVOS_PERF_LEDGER", raising=False)
        mp.delenv("ANOVOS_RUN_DIFF_BASELINE", raising=False)
        for name, fn in (("port", anovos_report), ("jax", janovos_report)):
            path = fn(master_path=master, final_report_path=os.path.join(root, name), **kw)
            with open(path, "rb") as f:
                out.append(f.read())
    return tuple(out)


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("basic"))
    data = income_data(root)
    out = run_both(basic_config(data["main"], data["join"]), root)
    out["root"] = root
    return out


BASIC_CSVS = ["global_summary", "measures_of_counts", "measures_of_centralTendency",
              "measures_of_cardinality", "measures_of_dispersion", "measures_of_percentiles",
              "measures_of_shape", "duplicate_detection", "nullRows_detection",
              "nullColumns_detection", "IDness_detection", "biasedness_detection",
              "outlier_detection", "invalidEntries_detection", "IV_calculation", "IG_calculation",
              "data_type"]


def test_same_files(runs):
    """The same file tree, obs/ included: both runs leave their run
    manifest under the write_main path."""
    assert tree(runs["port"], skip=()) == tree(runs["jax"], skip=())
    assert "ts_cols_stats.csv" in tree(runs["port"])
    assert "output/obs/run_manifest.json" in tree(runs["port"], skip=())


@pytest.mark.parametrize("name", BASIC_CSVS)
def test_report_stats_csv_matches_jax(runs, name):
    assert_csv_close(os.path.join(runs["port"], "report_stats", name + ".csv"),
                     os.path.join(runs["jax"], "report_stats", name + ".csv"))


def test_charts_match_jax(runs):
    """Every freqDist_/eventDist_ chart: counts exact, rates within 1e-6
    (the all-null ``empty`` column's charts included: zero counts)."""
    charts = [p for p in os.listdir(os.path.join(runs["jax"], "report_stats"))
              if p.startswith(("freqDist_", "eventDist_"))]
    assert {"freqDist_empty", "eventDist_empty", "freqDist_dupl_age", "eventDist_dupl_workclass",
            "freqDist_income"} <= set(charts)
    for name in charts:
        assert_chart_close(os.path.join(runs["port"], "report_stats", name),
                           os.path.join(runs["jax"], "report_stats", name))
    with open(os.path.join(runs["port"], "report_stats", "freqDist_empty")) as f:
        assert json.load(f)["data"][0]["y"] == [0.0] * 10


def test_ts_cols_stats_in_working_directory(runs):
    """With no report_preprocessing block ts_preprocess writes to '.', the
    working directory; dt_1 and dt_2 are converted."""
    got = pd.read_csv(os.path.join(runs["port"], "ts_cols_stats.csv"))
    pd.testing.assert_frame_equal(got, pd.read_csv(os.path.join(runs["jax"], "ts_cols_stats.csv")))
    assert set(got.loc[got["status"] == "converted", "attribute"]) == {"dt_1", "dt_2"}


def test_final_dataset_matches_jax(runs):
    rel = os.path.join("output", "final_dataset", "part-00000.parquet")
    got, exp = (pd.read_parquet(os.path.join(runs[p], rel)) for p in ("port", "jax"))
    pd.testing.assert_frame_equal(got, exp)
    assert {"dupl_age", "dupl_workclass", "empty"} <= set(got.columns)
    assert "logfnl" not in got.columns and len(got) == ROWS


def test_block_times_under_the_jax_labels(runs):
    assert list(runs["block_times"]) == ["join_dataset", "timeseries_analyzer", "Basic Report"]
    assert all(v >= 0 for v in runs["block_times"].values())
    assert runs["degraded"] == {}


def test_report_html_six_tabs(runs):
    with open(os.path.join(runs["port"], "report_stats", "ml_anovos_report.html")) as f:
        html = f.read()
    tabs = ["Executive Summary", "Wiki", "Descriptive Statistics", "Quality Check",
            "Attribute Associations", "Drift &amp; Stability"]
    assert html.count("onclick='showTab(") == 6
    assert all(f">{t}</button>" in html for t in tabs)


def test_renderer_bytes_over_the_jax_tree(runs, tmp_path):
    """The port's anovos_report and the JAX one over the JAX run's
    report_stats write the same bytes."""
    port, jax = render_both(os.path.join(runs["jax"], "report_stats"), str(tmp_path),
                            id_col="ifa", label_col="income")
    assert port == jax


def test_renderer_bytes_with_a_degraded_section(runs, tmp_path):
    """Both renderers over the JAX run's report_stats with the same two
    sections in both degradation registries: the same bytes, and the
    Degraded Sections tab first, naming both, escaped, with the JAX
    sentence that points at the manifest's resilience section."""
    degraded = {"stats_generator/measures_of_shape": "ChaosError: <injected> & gone",
                "association_evaluator/IV_calculation": "KeyError: 'income'"}
    port, jax = render_both(os.path.join(runs["jax"], "report_stats"), str(tmp_path), degraded=degraded,
                            id_col="ifa", label_col="income")
    port, jax = port.decode(), jax.decode()
    assert port == jax
    assert report_tabs(port)[0] == "Degraded Sections" and len(report_tabs(port)) == 7
    tab = degraded_tab(port)
    assert "2 analytics section(s) DEGRADED" in tab and "&lt;injected&gt; &amp; gone" in tab
    assert "run manifest's <code>resilience</code> section" in tab


@pytest.mark.parametrize("check", ["nullColumns_detection", "IDness_detection", "biasedness_detection"])
def test_checkers_read_the_jax_written_stats(runs, check):
    """The port's basic-report wiring (``stats_args``) pointed at the JAX
    run's stats CSVs, on the port's final table: the JAX run's check CSV."""
    from anovos_tpu_torch.data_analyzer import quality_checker
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.data_report.basic_report_generation import stats_args

    jax_stats = os.path.join(runs["jax"], "report_stats")
    extra = stats_args(jax_stats, check)
    assert extra and all(os.path.exists(v["file_path"]) for v in extra.values())
    table = read_dataset(os.path.join(runs["port"], "output", "final_dataset"), "parquet")
    _, stats = getattr(quality_checker, check)(table, drop_cols=["ifa"], treatment=False, **extra)
    got = os.path.join(str(runs["root"]), f"{check}.csv")
    stats.to_csv(got, index=False)
    assert_csv_close(got, os.path.join(jax_stats, check + ".csv"))


def test_workflow_stats_args_resolves_the_same_files(runs):
    """workflow.stats_args of both packages on configs_full's stats wiring."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu_torch import workflow as pwf

    cfg = load_config("configs_full.yaml")
    for func in ("nullColumns_detection", "IDness_detection", "charts_to_objects",
                 "variable_clustering", "duplicate_detection"):
        assert pwf.stats_args(cfg, func) == jwf.stats_args(cfg, func)
    cfg.pop("report_preprocessing")
    assert pwf.stats_args(cfg, "nullColumns_detection") == jwf.stats_args(cfg, "nullColumns_detection")
    basic = copy.deepcopy(cfg)
    basic.pop("stats_generator")
    assert pwf.stats_args(basic, "IDness_detection") == {}
