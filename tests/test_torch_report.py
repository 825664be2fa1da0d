"""The port's report layer against the JAX package's, function by function:
``charts_to_objects`` on tables with an all-null column, a constant column
and row counts ≡ 1, 2, 3 mod 4 (the histogram kernel's plain version on
the CPU against the JAX binning), the single-chart helpers, ``save_stats``
and the artifact store.  Chart files are compared as JSON, exactly: both
packages count in f32 and divide the same f32 counts on the host, so even
the event rates agree bit for bit.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import jax_and_port, torch_cpu_runtime  # noqa: F401  (autouse fixture)


def chart_frame(n: int, seed: int = 3) -> pd.DataFrame:
    """A normal, a skewed integer-valued and a constant column, an all-null
    one, a categorical column with nulls and a binary label with nulls."""
    g = np.random.default_rng(seed)
    df = pd.DataFrame({
        "x": g.normal(50, 20, n),
        "k": g.poisson(3, n).astype(float),
        "flat": np.full(n, 7.0),
        "empty": np.full(n, np.nan),
        "grp": g.choice(["a", "b", "c", "d"], n).astype(object),
        "income": g.choice(["<=50K", ">50K"], n, p=[0.7, 0.3]).astype(object),
    })
    df.loc[g.random(n) < 0.05, "x"] = np.nan
    df.loc[g.random(n) < 0.05, "grp"] = None
    df.loc[g.random(n) < 0.03, "income"] = None
    return df


def read_dir(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if name.endswith(".csv"):
            out[name] = pd.read_csv(p).to_dict("list")
        elif os.path.isfile(p):
            with open(p) as f:
                out[name] = json.load(f)
    return out


@pytest.mark.parametrize("bin_method", ["equal_frequency", "equal_range"])
@pytest.mark.parametrize("rows", [1001, 1002, 1003])
def test_charts_to_objects_matches_jax(tmp_path, rows, bin_method):
    """Every chart and data_type.csv equal; the all-null column's charts
    count zero in every bin (its cutoffs are NaN)."""
    from anovos_tpu.data_report.report_preprocessing import charts_to_objects as jcharts
    from anovos_tpu_torch.data_report.report_preprocessing import charts_to_objects

    jt, pt = jax_and_port(chart_frame(rows))
    kw = dict(label_col="income", event_label=">50K", bin_method=bin_method, bin_size=10,
              outlier_charts=True)
    charts_to_objects(pt, master_path=str(tmp_path / "p"), **kw)
    jcharts(jt, master_path=str(tmp_path / "j"), **kw)
    got, exp = read_dir(str(tmp_path / "p")), read_dir(str(tmp_path / "j"))
    assert got == exp
    assert {"freqDist_flat", "eventDist_empty", "outlier_x", "freqDist_income"} <= set(got)
    assert got["freqDist_empty"]["data"][0]["y"] == [0.0] * 10
    assert sum(got["freqDist_flat"]["data"][0]["y"]) == rows


@pytest.mark.parametrize("col", ["x", "flat", "grp", "income"])
def test_plot_frequency_and_event_rate_match_jax(col):
    from anovos_tpu.data_report import report_preprocessing as jrp
    from anovos_tpu_torch.data_report import report_preprocessing as rp

    jt, pt = jax_and_port(chart_frame(1501))
    assert rp.plot_frequency(pt, col) == jrp.plot_frequency(jt, col)
    assert rp.plot_eventRate(pt, col, "income", ">50K") == jrp.plot_eventRate(jt, col, "income", ">50K")


@pytest.mark.parametrize("split_var", [None, "grp"])
def test_plot_outlier_matches_jax(split_var):
    from anovos_tpu.data_report.report_preprocessing import plot_outlier as jplot
    from anovos_tpu_torch.data_report.report_preprocessing import plot_outlier

    jt, pt = jax_and_port(chart_frame(801))
    assert plot_outlier(pt, "x", split_var, sample_size=300) == jplot(jt, "x", split_var, sample_size=300)


@pytest.fixture
def drift_model(tmp_path):
    """A drift model (attribute_binning cutoffs and frequency CSVs) the
    port's drift statistics persisted under ``tmp_path``."""
    from anovos_tpu_torch.drift_stability import statistics
    from anovos_tpu_torch.shared.table import Table

    src = Table.from_pandas(chart_frame(1200, seed=4), device="cpu")
    tgt = Table.from_pandas(chart_frame(900, seed=5), device="cpu")
    statistics(tgt, src, source_path=str(tmp_path), use_sampling=False)
    return str(tmp_path)


@pytest.mark.parametrize("col", ["x", "k", "grp"])
def test_plot_comparative_drift_matches_jax(drift_model, col):
    from anovos_tpu.data_report.report_preprocessing import plot_comparative_drift as jplot
    from anovos_tpu_torch.data_report.report_preprocessing import plot_comparative_drift

    jt, pt = jax_and_port(chart_frame(777, seed=6))
    assert plot_comparative_drift(pt, drift_model, col) == jplot(jt, drift_model, col)


def test_bin_range_to_bin_idx_matches_jax(drift_model):
    from anovos_tpu.data_report.report_preprocessing import binRange_to_binIdx as jbin
    from anovos_tpu_torch.data_report.report_preprocessing import binRange_to_binIdx

    jt, pt = jax_and_port(chart_frame(1003, seed=6))
    model = os.path.join(drift_model, "drift_statistics")
    got = binRange_to_binIdx(pt, "x", model).to_pandas()["x_binIdx"]
    exp = jbin(jt, "x", model).to_pandas()["x_binIdx"]
    pd.testing.assert_series_equal(got, exp)
    assert got.dropna().between(1, 10).all()
    with pytest.raises(ValueError, match="no binning model"):
        binRange_to_binIdx(pt, "grp", model)


@pytest.mark.parametrize("label", ["1-5", "3-3", "3.5-3.5", "-10--5", "-2--2", "abc", "7"])
def test_edit_bin_range_matches_jax(label):
    from anovos_tpu.data_report.report_preprocessing import edit_binRange as jedit
    from anovos_tpu_torch.data_report.report_preprocessing import edit_binRange

    assert edit_binRange(label) == jedit(label)


def test_save_stats_round_trip_matches_jax(tmp_path):
    from anovos_tpu.data_report.report_preprocessing import save_stats as jsave
    from anovos_tpu_torch.data_report.report_preprocessing import save_stats

    df = pd.DataFrame({"attribute": ["a", "b"], "mean": [1.25, np.nan], "count": [3, 4]})
    got = save_stats(df, str(tmp_path / "p" / "m"), "measures", reread=True)
    exp = jsave(df, str(tmp_path / "j" / "m"), "measures", reread=True)
    pd.testing.assert_frame_equal(got, exp)
    with open(tmp_path / "p" / "m" / "measures.csv") as fp, open(tmp_path / "j" / "m" / "measures.csv") as fj:
        assert fp.read() == fj.read()


# -- the artifact store ------------------------------------------------------

PATHS = ["report_stats", "s3://bucket/master_stats", "s3://bucket/a b;rm -rf",
         "dbfs:/mnt/out", "wasbs://cont@acct.blob.core.windows.net/key/dir", "/abs/local"]


@pytest.mark.parametrize("run_type", ["local", "databricks", "emr", "ak8s"])
def test_artifact_store_matches_jax(run_type, monkeypatch, tmp_path):
    """staging_dir, pull, pull_dir and push of every path: the same result
    and the same CLI argv lists in both packages."""
    from anovos_tpu.shared import artifact_store as jas
    from anovos_tpu_torch.shared import artifact_store as pas

    monkeypatch.chdir(tmp_path)
    out = []
    for mod in (pas, jas):
        store = mod.for_run_type(run_type, "?sv=token")
        cmds = []
        if hasattr(store, "_run"):
            monkeypatch.setattr(store, "_run", cmds.append)
        res = [store.name]
        for p in PATHS:
            res += [store.staging_dir(p), store.pull(p, "local.csv"), store.pull_dir(p, "stage")]
            store.push("stage/f.csv", p)
        out.append((res, cmds))
    assert out[0] == out[1]


def test_artifact_store_registry_and_override(monkeypatch):
    from anovos_tpu_torch.shared import artifact_store as pas

    with pytest.raises(ValueError, match="Invalid run_type"):
        pas.for_run_type("yarn")

    class Fake(pas.ArtifactStore):
        name = "fake"

    monkeypatch.setitem(pas._REGISTRY, "fake", Fake)
    assert isinstance(pas.for_run_type("fake"), Fake)
    pas.register_store("fake", pas.S3Store)
    assert isinstance(pas.for_run_type("fake"), pas.S3Store)
    monkeypatch.setenv("ANOVOS_ARTIFACT_STORE", "anovos_tpu_torch.shared.artifact_store:DatabricksStore")
    store = pas.for_run_type("local", "key")
    assert isinstance(store, pas.DatabricksStore) and store.auth_key == "key"
