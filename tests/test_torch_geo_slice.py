"""The port's geospatial slice as a whole, against the JAX package:
parquet → read_dataset → geospatial_autodetection through both DBSCAN
routes.  The data and the comparison are test_torch_geo.py's
(``_torch_port.geo_frame``, ``assert_dirs_match``); the two CPU-heavy
cases live in a file of their own because ``--dist loadfile`` starts the
files with the most tests first.
"""

import pandas as pd
import pytest

from _torch_port import assert_dirs_match, geo_frame, torch_cpu_runtime  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("route", ["host_cc", "b3"])
def test_whole_geo_slice_matches_jax(route, tmp_path, monkeypatch):
    """parquet → read_dataset → geospatial_autodetection in both packages,
    20,000 rows, max_analysis_records=5000: with the default knobs (a
    4096-point grid sample, host connected components) and with a
    2048-point sample above a 1024-point host cap, which takes B3's counts
    and the batched device labeling."""
    from anovos_tpu.data_analyzer.geospatial_analyzer import geospatial_autodetection as jauto
    from anovos_tpu.data_ingest.data_ingest import read_dataset as jread
    from anovos_tpu_torch.data_analyzer.geospatial_analyzer import geospatial_autodetection
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset

    if route == "b3":
        monkeypatch.setenv("ANOVOS_DBSCAN_GRID_SAMPLE", "2048")
        monkeypatch.setenv("ANOVOS_DBSCAN_HOST_CC_MAX", "1024")
    data = tmp_path / "geo"
    data.mkdir()
    geo_frame(20000, 1).to_parquet(data / "part-00000.parquet", index=False)
    got = geospatial_autodetection(read_dataset(str(data), "parquet"), "id", str(tmp_path / "p"),
                                   max_analysis_records=5000)
    exp = jauto(jread(str(data), "parquet"), "id", str(tmp_path / "j"), max_analysis_records=5000)
    assert got == exp == (["latitude"], ["longitude"], ["geohash"])
    assert_dirs_match(str(tmp_path / "p"), str(tmp_path / "j"))
    km = pd.read_csv(tmp_path / "p" / "geospatial_kmeans_latitude_longitude.csv")
    db = pd.read_csv(tmp_path / "p" / "geospatial_dbscan_latitude_longitude.csv")
    assert len(km) == 2 and len(db) == 5 * 7
    assert (db["n_clusters"] == 2).any() and (db["silhouette"] > 0.5).any()
