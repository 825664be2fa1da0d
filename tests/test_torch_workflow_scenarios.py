"""The port's YAML runner against the JAX package's on ``config/configs.yaml``,
``config/configs_mlflow.yaml`` and ``config/configs_feast.yaml``, on
synthesized income rows with the configs' paths substituted and the dictionaries set to ``NA``: the whole
output trees compared as in ``tests/test_torch_workflow.py``.

``configs.yaml`` runs the ETL steps, ``concatenate_dataset`` (method
name) of the input with a second read of it, the inner ``join_dataset``
with an Avro side (one row per distinct ``ifa``) written by the JAX
package's writer, ``timeseries_analyzer``, ``geospatial_controller`` with
``auto_detection_analyzer: False`` (no geo files), stats, quality,
association, drift with stability, the transformers block, the report and
its three writes.  ``configs_mlflow.yaml`` runs with ``mlflow`` unimportable:
the runner logs its warning and goes on.  ``configs_feast.yaml`` adds two
timestamp columns before its one-part final write and writes a Feast
repository file; the timestamps' values are each run's own.

PCA's outputs carry a fault of the JAX package the port does not copy
(an all-null input column turns every JAX latent NaN) and are compared by
their own rule, ``_pca_rule``; ``configs.yaml``'s drift section degrades in
both runners (its source lacks the join's columns).  Nothing is sampled at
these sizes."""

import os
import sys

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_workflow import assert_dirs_close, load_config, run_both

ROWS = 2000


def income_scenario_data(root: str, n: int = ROWS) -> dict:
    """The income schema at ``n`` rows as parquet, its ifa/age/workclass join
    side as avro written by the JAX package, and four CSV slices of its
    numeric columns for the stability index."""
    from anovos_tpu.data_ingest.avro_io import write_avro
    from examples._data import materialize_income_parquet, synthesize

    main_dir, _ = materialize_income_parquet(os.path.join(root, "income"), n)
    df = synthesize(n)
    join_dir = os.path.join(root, "income", "join_avro")
    os.makedirs(join_dir)
    write_avro(df[["ifa", "age", "workclass"]].drop_duplicates("ifa"),
               os.path.join(join_dir, "part-00000.avro"))
    num = df.select_dtypes("number").drop(columns=["empty", "logfnl"])
    si = []
    for i in range(4):
        d = os.path.join(root, "income", "stability", str(i))
        os.makedirs(d)
        num.iloc[i * n // 4:(i + 1) * n // 4].to_csv(os.path.join(d, "part-00000.csv"), index=False)
        si.append(d)
    return {"main": main_dir, "join": join_dir, "stability": si}


def income_config(data: dict) -> dict:
    """configs.yaml with every read path pointed at ``data``'s files."""
    cfg = load_config("configs.yaml")
    cfg["input_dataset"]["read_dataset"]["file_path"] = data["main"]
    cfg["concatenate_dataset"]["dataset1"]["read_dataset"]["file_path"] = data["main"]
    cfg["join_dataset"]["dataset1"]["read_dataset"]["file_path"] = data["join"]
    drift = cfg["drift_detector"]
    drift["drift_statistics"]["source_dataset"]["read_dataset"]["file_path"] = data["main"]
    for i, d in enumerate(data["stability"]):
        drift["stability_index"][f"dataset{i + 1}"]["read_dataset"]["file_path"] = d
    cfg["report_generation"]["dataDict_path"] = "NA"
    cfg["report_generation"]["metricDict_path"] = "NA"
    return cfg


def feast_config(data: dict) -> dict:
    cfg = load_config("configs_feast.yaml")
    cfg["input_dataset"]["read_dataset"]["file_path"] = data["main"]
    return cfg


def mlflow_config(data: dict) -> dict:
    cfg = load_config("configs_mlflow.yaml")
    cfg["input_dataset"]["read_dataset"]["file_path"] = data["main"]
    cfg["report_generation"]["dataDict_path"] = "NA"
    cfg["report_generation"]["metricDict_path"] = "NA"
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return income_scenario_data(str(tmp_path_factory.mktemp("income_data")))


def run_both_recorded(cfg: dict, root: str) -> dict:
    """``run_both``, and the sections each runner degraded."""
    from anovos_tpu.resilience import policy

    out = run_both(cfg, root)
    out["jax_degraded"] = policy.degraded_sections()
    return out


@pytest.fixture(scope="module")
def income_runs(data, tmp_path_factory):
    return run_both_recorded(income_config(data), str(tmp_path_factory.mktemp("configs")))


@pytest.fixture(scope="module")
def feast_runs(data, tmp_path_factory):
    return run_both_recorded(feast_config(data), str(tmp_path_factory.mktemp("feast")))


@pytest.fixture(scope="module")
def mlflow_runs(data, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "mlflow", None)  # `import mlflow` raises ImportError
        return run_both_recorded(mlflow_config(data), str(tmp_path_factory.mktemp("mlflow")))


def _pca_rule(read):
    """PCA's output on this chain: its input holds an all-null column
    (longitude's square root), so every JAX latent is NaN, a fault of the
    JAX package the port does not copy (ROADMAP Queue C; pinned by
    ``test_torch_latent.py::test_all_null_column_adds_nothing``).  The
    other columns equal, the port's latents finite."""
    def rule(got_path, exp_path):
        got, exp = read(got_path), read(exp_path)
        lat = [c for c in got.columns if c.startswith("latent_")]
        assert list(exp.columns) == [c for c in got.columns if c not in lat[1:]] and lat
        pd.testing.assert_frame_equal(got.drop(columns=lat), exp.drop(columns=["latent_0"]))
        assert exp["latent_0"].isna().all()
        assert np.isfinite(got[lat].to_numpy(np.float64)).all()
    return rule


@pytest.mark.parametrize("sub", ["report_stats", "si_metrics", "output", "intermediate_data"])
def test_configs_yaml_trees_match_jax(income_runs, sub):
    """Every file of each output tree: the report's CSVs and charts, the
    stability metrics, the final dataset, and the intermediate datasets of
    the concatenate, the join, the seven quality checks and the six
    transformer steps (``stats`` stays empty in both: the stats go to the
    report's master path)."""
    got_dir, exp_dir = (os.path.join(income_runs[p], sub) for p in ("port", "jax"))
    if sub == "intermediate_data":
        pca = os.path.join("data_transformer", "transformers", "PCA_latentFeatures")
        for d in (got_dir, exp_dir):  # compared below by PCA's rule
            os.rename(os.path.join(d, pca), d + "_pca")
        names = assert_dirs_close(got_dir, exp_dir)
        assert_dirs_close(got_dir + "_pca", exp_dir + "_pca", rules={"part-00000.csv": _pca_rule(pd.read_csv)})
        for step in ("concatenate_dataset", "join_dataset", "outlier_detection", "IQR_standardization"):
            assert any(step in n for n in names), step
    else:
        names = assert_dirs_close(got_dir, exp_dir, rules={"part-00000.parquet": _pca_rule(pd.read_parquet)})
    assert names
    assert not os.path.exists(os.path.join(income_runs["port"], "stats"))
    assert not os.path.exists(os.path.join(income_runs["jax"], "stats"))


def test_configs_yaml_degrades_drift_as_jax_does(income_runs):
    """The config drifts every column of the joined table against the
    unjoined source, which lacks the join's dupl_age and dupl_workclass:
    both runners skip drift_statistics, record it as degraded, and go on
    (ROADMAP Queue C: a fault of the config both packages keep)."""
    assert income_runs["degraded"] == {"drift_detector/drift_statistics": "KeyError: 'dupl_age'"}
    assert set(income_runs["jax_degraded"]) == set(income_runs["degraded"])
    assert "dupl_age" in income_runs["jax_degraded"]["drift_detector/drift_statistics"]
    assert "drift_statistics.csv" not in os.listdir(os.path.join(income_runs["port"], "report_stats"))


def test_configs_yaml_report_names_the_degraded_drift(income_runs):
    """Both runners' reports on configs.yaml lead with the Degraded Sections
    tab naming drift_statistics and its error; the port's tab is the JAX
    markup without the sentence that points at the run manifest and the run
    journal, which the port does not write yet."""
    from test_torch_workflow import JAX_ONLY_DEGRADED_TEXT, degraded_tab, report_tabs

    got, exp = (open(os.path.join(income_runs[p], "report_stats", "ml_anovos_report.html")).read()
                for p in ("port", "jax"))
    assert report_tabs(got) == report_tabs(exp)
    assert report_tabs(got)[0] == "Degraded Sections"
    assert degraded_tab(got) == degraded_tab(exp).replace(JAX_ONLY_DEGRADED_TEXT, "")
    assert ("1 analytics section(s) DEGRADED" in degraded_tab(got)
            and "<b>drift_detector/drift_statistics</b>" in degraded_tab(got)
            and "dupl_age" in degraded_tab(got))


def test_quarantined_part_in_the_degraded_tab(data, tmp_path, monkeypatch):
    """A part the ingest guard quarantines (corrupt on every read, no
    retry) through both runners: the report's Degraded Sections tab lists
    the part with its error class and the rows it held, and equals the JAX
    tab but for ``JAX_ONLY_DEGRADED_TEXT``."""
    from test_torch_workflow import JAX_ONLY_DEGRADED_TEXT, degraded_tab, report_tabs

    full = pd.read_parquet(os.path.join(data["main"], "part-00000.parquet"))
    parts = tmp_path / "parts"
    parts.mkdir()
    for i in range(2):
        full.iloc[i * ROWS // 2:(i + 1) * ROWS // 2].to_parquet(parts / f"part-0000{i}.parquet", index=False)
    cfg = {"input_dataset": {"read_dataset": {"file_path": str(parts), "file_type": "parquet"}},
           "stats_generator": {"metric": ["measures_of_counts"],
                               "metric_args": {"list_of_cols": "all", "drop_cols": ["ifa"]}},
           "report_preprocessing": {"master_path": "report_stats"},
           "report_generation": {"master_path": "report_stats", "id_col": "ifa",
                                 "final_report_path": "report_stats"}}
    monkeypatch.setenv("ANOVOS_INGEST_RETRIES", "0")
    monkeypatch.setenv("ANOVOS_TPU_CHAOS", "corrupt@io:*part-00001.parquet:n=99")
    (tmp_path / "runs").mkdir()
    runs = run_both_recorded(cfg, str(tmp_path / "runs"))
    assert set(runs["degraded"]) == set(runs["jax_degraded"]) == {"ingest/part-00001.parquet"}
    got, exp = (open(os.path.join(runs[p], "report_stats", "ml_anovos_report.html")).read()
                for p in ("port", "jax"))
    assert report_tabs(got) == report_tabs(exp) and report_tabs(got)[0] == "Degraded Sections"
    tab = degraded_tab(got)
    assert tab == degraded_tab(exp).replace(JAX_ONLY_DEGRADED_TEXT, "")
    assert (f"1 input part(s) QUARANTINED</b> ({ROWS // 2} row(s) lost" in tab
            and f"<td>part-00001.parquet</td><td>ChaosCorrupt</td><td>{ROWS // 2}</td>" in tab)
    counts = pd.read_csv(os.path.join(runs["port"], "report_stats", "measures_of_counts.csv"))
    assert (counts["fill_count"] <= ROWS // 2).all()


def test_configs_yaml_concatenates_and_joins(income_runs, data):
    """The joined dataset holds both reads of the input, each row joined to
    its one avro row, as pandas concatenates and merges them; the duplicate
    check then drops the second copy of every row."""
    rel = os.path.join("intermediate_data", "data_ingest", "join_dataset", "part-00000.csv")
    joined = pd.read_csv(os.path.join(income_runs["port"], rel))
    src = pd.read_parquet(os.path.join(data["main"], "part-00000.parquet"))
    exp = pd.concat([src, src], ignore_index=True)[["ifa", "age", "workclass"]].merge(
        src[["ifa", "age", "workclass"]].rename(columns={"age": "dupl_age", "workclass": "dupl_workclass"}),
        on="ifa", how="inner")
    assert len(joined) == len(exp) == 2 * ROWS
    got = joined[["ifa", "age", "workclass", "dupl_age", "dupl_workclass"]].sort_values(
        ["ifa"], kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp.sort_values(["ifa"], kind="stable").reset_index(drop=True),
                                  check_dtype=False)
    final = pd.read_parquet(os.path.join(income_runs["port"], "output", "final_dataset",
                                         "part-00000.parquet"))
    assert len(final) == ROWS
    assert not any(n.startswith("geospatial_") for n in os.listdir(
        os.path.join(income_runs["port"], "report_stats")))
    times = income_runs["block_times"]
    for block in ("concatenate_dataset", "join_dataset", "timeseries_analyzer"):
        assert block in times, block


@pytest.mark.parametrize("sub", ["report_stats", "output"])
def test_configs_mlflow_trees_match_jax(mlflow_runs, sub):
    names = assert_dirs_close(os.path.join(mlflow_runs["port"], sub), os.path.join(mlflow_runs["jax"], sub))
    assert names
    assert mlflow_runs["degraded"] == mlflow_runs["jax_degraded"] == {}


def test_configs_mlflow_runs_without_mlflow(mlflow_runs):
    """No mlflow: the port's runner wrote the whole report anyway."""
    rs = os.path.join(mlflow_runs["port"], "report_stats")
    assert os.path.exists(os.path.join(rs, "ml_anovos_report.html"))
    gs = pd.read_csv(os.path.join(rs, "global_summary.csv"))
    assert int(float(dict(zip(gs["metric"], gs["value"]))["rows_count"])) == ROWS


FEAST_TS = ["event_time", "create_time_col"]


def _without_timestamps(got_path, exp_path):
    """The final dataset: equal but for the two timestamp columns, which
    hold each run's own time; those are timestamps of one value each."""
    got, exp = pd.read_parquet(got_path), pd.read_parquet(exp_path)
    assert list(got.columns) == list(exp.columns) and list(got.columns[-2:]) == FEAST_TS
    pd.testing.assert_frame_equal(got.drop(columns=FEAST_TS), exp.drop(columns=FEAST_TS))
    for c in FEAST_TS:
        assert str(got[c].dtype) == str(exp[c].dtype) and got[c].dtype.kind == "M"
        assert got[c].nunique() == 1 and not got[c].isna().any()


def _same_bytes(got_path, exp_path):
    with open(got_path, "rb") as g, open(exp_path, "rb") as e:
        assert g.read() == e.read()


def test_configs_feast_tree_matches_jax(feast_runs, data):
    """configs_feast.yaml: the stats and chart files, the one-part final
    dataset with its two timestamp columns (their values set aside) and
    the Feast repository file byte for byte, which compiles and names the
    written part."""
    names = assert_dirs_close(feast_runs["port"], feast_runs["jax"], rules={
        "part-00000.parquet": _without_timestamps, "anovos.py": _same_bytes})
    assert "feast_repo/anovos.py" in names and "output/final_dataset/part-00000.parquet" in names
    assert feast_runs["degraded"] == feast_runs["jax_degraded"] == {}
    with open(os.path.join(feast_runs["port"], "feast_repo", "anovos.py")) as f:
        text = f.read()
    compile(text, "anovos.py", "exec")
    assert 'path="output/final_dataset/part-00000.parquet"' in text
    assert 'Field(name="income", dtype=String)' in text and 'Field(name="ifa"' not in text
    final = pd.read_parquet(os.path.join(feast_runs["port"], "output", "final_dataset"))
    assert len(final) == ROWS


@pytest.mark.parametrize("name", ["configs.yaml", "configs_time_series.yaml", "configs_geospatial.yaml",
                                  "configs_mlflow.yaml", "configs_feast.yaml"])
def test_chip_smoke_copies_equal_the_yamls(name):
    """chip_smoke.py phase 11 runs its own copies of the four configs (the
    card's machine may lack a YAML reader): after the same substitution of
    the read paths and the dictionaries they are the files', blocks in the
    files' order."""
    import chip_smoke
    from test_torch_workflow_checkin import checkin_config

    si = [f"/data/si{i}" for i in range(4)]
    data = {"main": "/data/main", "join": "/data/join", "stability": si, "checkin": "/data/checkin"}
    if name == "configs.yaml":
        got, exp = chip_smoke.income_config("/data/main", "/data/join", si), income_config(data)
    elif name == "configs_mlflow.yaml":
        got, exp = chip_smoke.mlflow_config("/data/main"), mlflow_config(data)
    elif name == "configs_feast.yaml":
        got, exp = chip_smoke.feast_config("/data/main"), feast_config(data)
    else:
        template = {"configs_time_series.yaml": chip_smoke.TS_SCENARIO_CONFIG,
                    "configs_geospatial.yaml": chip_smoke.GEO_SCENARIO_CONFIG}[name]
        got = chip_smoke.checkin_config(template, "/data/checkin", si[:3] if "time" in name else ())
        exp = checkin_config(name, dict(data, stability=si[:3]))
    assert got == exp and list(got) == list(exp)
    for key, block in exp.items():
        if isinstance(block, dict):
            assert list(got[key]) == list(block), key
