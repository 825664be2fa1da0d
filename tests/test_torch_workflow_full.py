"""The port's YAML runner against the JAX package's on the whole of
``config/configs_full.yaml`` (analyze → quality → association → drift →
report → transformers), the dictionaries set to ``NA``, every read path
pointed at the same 2,000 synthesized income rows and the stability
datasets at four CSV slices of them.

Parity standard as in ``tests/test_torch_workflow.py``.  Files that carry
a divergence by design (ROADMAP.md Queue C) are compared by their own
rule, not value for value:

- ``cluster_output_kmeans_latitude_longitude.csv`` and
  ``geospatial_kmeans_latitude_longitude.csv``: k-means first centers
  differ (seeded ``torch.Generator`` against ``jax.random``), and on the
  synthesized uniform lat/lon the elbow can settle on another k; both
  files hold one row a cluster over the same analysed points;
- the drift binning model (``attribute_binning``): equal-range cutoffs
  within one f32 ulp (XLA may contract lo + j·width into an FMA), as
  ``tests/test_torch_drift.py`` holds them;
- the PCA latent columns (``PCA_latentFeatures``' intermediate dataset and
  the final dataset): ``eigh`` may return a component with either sign, so
  each column is aligned to the JAX sign, then held to 1e-4·(1 + |x|)
  plus 2e-5 of the largest latent;
- the IV/IG group counts' int64/float64 against f32 does not show: every
  group holds fewer than 2^24 rows.

Nothing is sampled (every ``sample_size`` exceeds 2,000 rows).  Also here:
the port's renderer over the JAX run's ``report_stats`` gives the same
bytes, and the port's ``charts_to_objects`` over the JAX run's drift model
gives the JAX ``drift_*`` charts.
"""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from test_torch_workflow import (ROWS, assert_chart_close, assert_csv_close, assert_dirs_close, income_data,
                                 load_config, render_both, run_both, tree)


def full_config(data: dict) -> dict:
    """configs_full.yaml, its paths pointed at ``income_data``'s files and
    the dictionaries set to NA."""
    cfg = load_config("configs_full.yaml")
    cfg["input_dataset"]["read_dataset"]["file_path"] = data["main"]
    drift = cfg["drift_detector"]
    drift["drift_statistics"]["source_dataset"]["read_dataset"]["file_path"] = data["main"]
    for i, d in enumerate(data["stability"]):
        drift["stability_index"][f"dataset{i + 1}"]["read_dataset"]["file_path"] = d
    cfg["report_generation"]["dataDict_path"] = "NA"
    cfg["report_generation"]["metricDict_path"] = "NA"
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("full"))
    out = run_both(full_config(income_data(root)), root)
    out["root"] = root
    return out


def _kmeans_rule(got_path, exp_path):
    got, exp = pd.read_csv(got_path), pd.read_csv(exp_path)
    assert list(got.columns) == list(exp.columns) == ["cluster", "lat_center", "lon_center", "count"]
    assert got["cluster"].tolist() == list(range(len(got)))
    assert got["count"].sum() == exp["count"].sum()
    for c in ("lat_center", "lon_center"):
        assert got[c].between(exp[c].min() - 20, exp[c].max() + 20).all()


def _cutoffs_rule(got_path, exp_path):
    got, exp = pd.read_parquet(got_path), pd.read_parquet(exp_path)
    assert got["attribute"].tolist() == exp["attribute"].tolist()
    for g, e, c in zip(got["parameters"], exp["parameters"], exp["attribute"]):
        np.testing.assert_allclose(np.asarray(g, float), np.asarray(e, float), rtol=2 ** -23, atol=0,
                                   err_msg=c)


KMEANS = {"cluster_output_kmeans_latitude_longitude.csv": _kmeans_rule,
          "geospatial_kmeans_latitude_longitude.csv": _kmeans_rule}
TRANSFORMERS = ("feature_transformation", "attribute_binning", "outlier_categories", "cat_to_num_supervised",
                "IQR_standardization", "PCA_latentFeatures")


def assert_latents_close(got: pd.DataFrame, exp: pd.DataFrame) -> None:
    """Two frames with ``latent_<i>`` columns: the other columns equal, each
    latent column aligned to the JAX sign, then within 1e-4·(1 + |x|) plus
    2e-5 of the largest latent (a component of a small eigenvalue turns
    with the covariance's rounding, by its share of the largest one)."""
    lat = [c for c in exp.columns if c.startswith("latent_")]
    assert list(got.columns) == list(exp.columns) and lat
    pd.testing.assert_frame_equal(got.drop(columns=lat), exp.drop(columns=lat), check_dtype=False)
    scale = float(np.abs(exp[lat].to_numpy(np.float64)).max())
    for c in lat:
        g, e = got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64)
        g = g * (1.0 if (g * e).sum() >= 0 else -1.0)
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4 + 2e-5 * scale, err_msg=c)


def test_report_stats_tree_matches_jax(runs):
    """Every file under report_stats/ (stats, quality, association, drift,
    stability, ts, geo and chart JSONs)."""
    names = assert_dirs_close(os.path.join(runs["port"], "report_stats"),
                              os.path.join(runs["jax"], "report_stats"), rules=KMEANS)
    for n in ("correlation_matrix.csv", "variable_clustering.csv", "drift_statistics.csv",
              "stability_index.csv", "stabilityIndex_metrics.csv", "ts_cols_stats.csv",
              "geospatial_dbscan_latitude_longitude.csv", "drift_age", "freqDist_income"):
        assert n in names, n


def test_si_metrics_match_jax(runs):
    assert assert_dirs_close(os.path.join(runs["port"], "si_metrics"),
                             os.path.join(runs["jax"], "si_metrics"))


def test_drift_model_matches_jax(runs):
    """intermediate_data/drift_statistics: every column's frequency keys
    equal and p within 1e-6; the cutoffs within one f32 ulp."""
    rel = os.path.join("intermediate_data", "drift_statistics")
    got_dir, exp_dir = (os.path.join(runs[p], rel) for p in ("port", "jax"))
    freq = os.path.join(exp_dir, "frequency_counts")
    assert sorted(os.listdir(os.path.join(got_dir, "frequency_counts"))) == sorted(os.listdir(freq))
    for c in os.listdir(freq):
        g = pd.read_csv(os.path.join(got_dir, "frequency_counts", c, "part-00000.csv"), dtype=str)
        e = pd.read_csv(os.path.join(freq, c, "part-00000.csv"), dtype=str)
        assert g.iloc[:, 0].tolist() == e.iloc[:, 0].tolist(), c
        np.testing.assert_allclose(g["p"].astype(float), e["p"].astype(float), rtol=0, atol=1e-6, err_msg=c)
    part = os.path.join("attribute_binning", "part-00000.parquet")
    _cutoffs_rule(os.path.join(got_dir, part), os.path.join(exp_dir, part))


def test_final_dataset_matches_jax(runs):
    """The transformed table: PCA's latents (the chain ends in it) and the
    columns it leaves."""
    rel = os.path.join("output", "final_dataset", "part-00000.parquet")
    got, exp = (pd.read_parquet(os.path.join(runs[p], rel)) for p in ("port", "jax"))
    assert got.dtypes.to_dict() == exp.dtypes.to_dict()
    assert_latents_close(got, exp)
    assert len(got) <= ROWS and "latent_1" in got.columns


def test_intermediate_tree_matches_jax(runs):
    """Every file under intermediate_data/: the quality checkers' datasets,
    the drift model and the six transformers' datasets."""
    got_dir, exp_dir = (os.path.join(runs[p], "intermediate_data") for p in ("port", "jax"))
    names = tree(exp_dir)
    assert tree(got_dir) == names
    for fn in TRANSFORMERS:
        assert any(n.startswith(f"data_transformer/transformers/{fn}/") for n in names), fn
    for rel in names:
        gp, ep = os.path.join(got_dir, rel), os.path.join(exp_dir, rel)
        if rel.startswith("data_transformer/transformers/PCA_latentFeatures/") and rel.endswith(".csv"):
            assert_latents_close(pd.read_csv(gp), pd.read_csv(ep))
        elif rel.endswith(os.path.join("attribute_binning", "part-00000.parquet")):
            _cutoffs_rule(gp, ep)
        elif rel.endswith(".csv") and os.path.getsize(ep):
            assert_csv_close(gp, ep)
        elif rel.endswith(".csv"):
            assert os.path.getsize(gp) == 0, rel
        elif rel.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(gp), pd.read_parquet(ep), obj=rel)
        else:
            assert os.path.basename(rel) == "_SUCCESS", rel


def test_block_times_under_the_jax_labels(runs):
    times = runs["block_times"]
    for label in ("timeseries_analyzer", "geospatial_controller", "stats_generator, measures_of_counts",
                  "quality_checker, outlier_detection", "association_evaluator, correlation_matrix",
                  "drift_detector, drift_statistics", "drift_detector, stability_index",
                  "report_preprocessing, charts_to_objects", "report_generation, full_report",
                  *(f"transformers, {fn}" for fn in TRANSFORMERS)):
        assert label in times, label
    assert runs["degraded"] == {}


def test_renderer_bytes_over_the_jax_tree(runs, tmp_path):
    """The port's anovos_report and the JAX one over the JAX run's
    report_stats (8 tabs: time series and geospatial too) write the same
    bytes."""
    kw = {k: v for k, v in load_config("configs_full.yaml")["report_generation"].items()
          if k not in ("master_path", "final_report_path", "dataDict_path", "metricDict_path")}
    port, jax = render_both(os.path.join(runs["jax"], "report_stats"), str(tmp_path), **kw)
    assert port == jax
    assert port.count(b"onclick='showTab(") == 8


def test_drift_charts_from_the_jax_drift_model(runs, tmp_path):
    """The port's charts_to_objects(drift_detector=True) on the table the
    port's charts saw (the last quality check's dataset, before the
    transformers), reading the JAX run's drift model: the JAX drift_*
    charts."""
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
    from anovos_tpu_torch.data_report.report_preprocessing import charts_to_objects

    table = read_dataset(os.path.join(runs["port"], "intermediate_data", "data_analyzer", "quality_checker",
                                      "nullColumns_detection", "dataset"), "csv",
                         {"header": True, "inferSchema": True})
    cfg = dict(load_config("configs_full.yaml")["report_preprocessing"]["charts_to_objects"])
    cfg["source_path"] = os.path.join(runs["jax"], "intermediate_data")
    charts_to_objects(table, **cfg, master_path=str(tmp_path))
    exp_dir = os.path.join(runs["jax"], "report_stats")

    def charts(d):
        return sorted(p for p in os.listdir(d) if p.startswith("drift_") and not p.endswith(".csv"))

    drift = charts(exp_dir)
    assert len(drift) > 10 and charts(tmp_path) == drift
    for name in drift:
        assert_chart_close(os.path.join(tmp_path, name), os.path.join(exp_dir, name))
