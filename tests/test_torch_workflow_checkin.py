"""The port's YAML runner against the JAX package's on
``config/configs_time_series.yaml`` and ``config/configs_geospatial.yaml``,
both of which read the check-in dataset (users' venue check-ins: ids, a
venue category, lat/lon and a free-form UTC timestamp), here synthesized
with the dataset's schema, and the time-series config's stability
sub-block three CSV slices of income rows.  The configs' paths are substituted
and the dictionaries set to ``NA``; the output trees are compared as in
``tests/test_torch_workflow.py``.

The geospatial config runs DBSCAN's default grid (eps 0.3 and 0.5,
min_samples 100 and 300) through the host codec's union-find.  Its lat/lon
sit on ``_torch_port.lattice_points``' lattice, so no pair distance lies in
the f32 band of either eps and the labels must be equal.  The k-means
files follow ``tests/test_torch_workflow_full.py``'s rule (the first
centers come from another generator)."""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_no_band_pairs, lattice_points, torch_cpu_runtime  # noqa: F401
from test_torch_workflow import assert_dirs_close, load_config, run_both
from test_torch_workflow_full import KMEANS

ROWS = 3000
CATEGORIES = ["Bar", "Coffee Shop", "Gym / Fitness Center", "Office", "Subway", "Home (private)",
              "Café", "Train Station", "Park", "Food & Drink Shop"]


def checkin_frame(n: int, seed: int) -> pd.DataFrame:
    """The check-in dataset's columns: userId, venueId, venueCategoryId,
    venueCategory, latitude, longitude, timezoneOffset and utcTimestamp in
    the dataset's text format ("Tue Apr 03 18:00:09 +0000 2012"); the
    points in three cities on the test lattice."""
    g = np.random.default_rng(seed)
    pts = lattice_points(n, seed, [(0.0, 0.0), (1.6, 0.4), (-0.9, 1.7)], sd=0.25, noise=0.03,
                         base=(40.0, -74.0))
    venues = g.integers(0, 400, n)
    cat = g.integers(0, len(CATEGORIES), n)
    secs = g.integers(1333238400, 1360000000, n)  # April 2012 to February 2013
    ts = pd.to_datetime(secs, unit="s").strftime("%a %b %d %H:%M:%S +0000 %Y")
    return pd.DataFrame({
        "userId": g.integers(1, 1084, n),
        "venueId": [f"{v:024x}" for v in 0x4A000000 + venues * 7919],
        "venueCategoryId": [f"4bf58dd8d48988d1{c:02d}941735" for c in cat],
        "venueCategory": np.asarray(CATEGORIES, object)[cat],
        "latitude": pts[:, 0].astype(np.float64),
        "longitude": pts[:, 1].astype(np.float64),
        "timezoneOffset": g.choice([-240, -300, 540], n),
        "utcTimestamp": ts,
    })


def _csv(root: str, name: str, df: pd.DataFrame) -> str:
    d = os.path.join(root, name)
    os.makedirs(d)
    df.to_csv(os.path.join(d, "part-00000.csv"), index=False)
    return d


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from examples._data import synthesize

    root = str(tmp_path_factory.mktemp("checkin_data"))
    num = synthesize(1500, seed=3).select_dtypes("number").drop(columns=["empty", "logfnl"])
    return {"checkin": _csv(root, "checkin", checkin_frame(ROWS, 8)),
            "stability": [_csv(root, f"si{i}", num.iloc[i * 500:(i + 1) * 500]) for i in range(3)]}


def checkin_config(name: str, data: dict) -> dict:
    """``name``'s YAML with its read paths pointed at ``data``'s files."""
    cfg = load_config(name)
    cfg["input_dataset"]["read_dataset"]["file_path"] = data["checkin"]
    si = (cfg.get("drift_detector") or {}).get("stability_index")
    if si:
        for i, d in enumerate(data["stability"]):
            si[f"dataset{i + 1}"]["read_dataset"]["file_path"] = d
    cfg["report_generation"]["dataDict_path"] = "NA"
    return cfg


@pytest.fixture(scope="module")
def ts_runs(data, tmp_path_factory):
    return run_both(checkin_config("configs_time_series.yaml", data), str(tmp_path_factory.mktemp("ts")))


@pytest.fixture(scope="module")
def geo_runs(data, tmp_path_factory):
    return run_both(checkin_config("configs_geospatial.yaml", data), str(tmp_path_factory.mktemp("geo")))


def test_checkin_points_keep_clear_of_every_eps():
    """The premise of equal DBSCAN labels: no pair in the f32 band."""
    pts = checkin_frame(ROWS, 8)[["latitude", "longitude"]].to_numpy(np.float32)
    assert_no_band_pairs(pts, [0.3, 0.5])


@pytest.mark.parametrize("sub", ["report_stats", "si_metrics", "output"])
def test_time_series_trees_match_jax(ts_runs, sub):
    names = assert_dirs_close(os.path.join(ts_runs["port"], sub), os.path.join(ts_runs["jax"], sub))
    assert names
    if sub == "report_stats":
        for n in ("ts_cols_stats.csv", "stability_index.csv", "global_summary.csv",
                  "measures_of_centralTendency.csv"):
            assert n in names, n
        assert any(n.startswith("ts_") and "utcTimestamp" in n for n in names)
    assert ts_runs["degraded"] == {}


def test_time_series_converts_the_timestamp(ts_runs):
    """utcTimestamp's text was detected and converted: it is no longer a
    string column of the final dataset."""
    final = pd.read_parquet(os.path.join(ts_runs["port"], "output", "final_dataset", "part-00000.parquet"))
    assert pd.api.types.is_datetime64_any_dtype(final["utcTimestamp"])
    exp = pd.read_parquet(os.path.join(ts_runs["jax"], "output", "final_dataset", "part-00000.parquet"))
    pd.testing.assert_series_equal(final["utcTimestamp"], exp["utcTimestamp"])


@pytest.mark.parametrize("sub", ["report_stats", "output"])
def test_geospatial_trees_match_jax(geo_runs, sub):
    names = assert_dirs_close(os.path.join(geo_runs["port"], sub), os.path.join(geo_runs["jax"], sub),
                              rules=KMEANS)
    assert names
    if sub == "report_stats":
        for n in ("geospatial_dbscan_latitude_longitude.csv", "cluster_output_dbscan_latitude_longitude.csv",
                  "geospatial_stats.csv", "global_summary.csv"):
            assert n in names, n
    assert geo_runs["degraded"] == {}


def test_geospatial_dbscan_found_the_cities(geo_runs):
    """Every combo of the grid through the union-find: at eps 0.3 both
    min_samples levels find the three cities, with about the 3% of noise
    points left over."""
    out = pd.read_csv(os.path.join(geo_runs["port"], "report_stats",
                                   "cluster_output_dbscan_latitude_longitude.csv"))
    assert out[["eps", "min_samples"]].values.tolist() == [[0.3, 100], [0.3, 300], [0.5, 100], [0.5, 300]]
    at03 = out[out["eps"] == 0.3]
    assert at03["n_clusters"].tolist() == [3, 3]
    assert (at03["noise_pct"] >= 0.02).all() and (at03["noise_pct"] <= 0.1).all()
