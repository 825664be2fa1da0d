"""The port's geospatial slice — geo_utils, ll_gh_cols and the geospatial
analyzer's writers — against the JAX package; the whole slice (parquet →
read_dataset → geospatial_autodetection) through both of its DBSCAN
routes is in test_torch_geo_slice.py.

The lat/lon points sit on a lattice (``_torch_port.lattice_points``)
whose pair distances keep far from every eps of the default grid, so the two packages' f32 roundings of the distance
expansion cannot disagree about a neighbour and the integer columns must
be equal.  The port's k-means starts from a torch.Generator draw, the JAX
package's from jax.random: k-means rows are compared after sorting by
center.
"""

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_dirs_match, geo_frame, torch_cpu_runtime  # noqa: F401  (autouse fixture)


def test_geohash_codec_matches_jax():
    from anovos_tpu.data_transformer import geo_utils as jgu
    from anovos_tpu_torch.data_transformer import geo_utils as pgu

    g = np.random.default_rng(0)
    pts = np.concatenate([g.uniform(-90, 90, (300, 1)), g.uniform(-180, 180, (300, 1))], 1)
    pts[:4] = [[0, 0], [-90, -180], [90, 180], [45, -22.5]]  # midpoints go up
    for lat, lon in pts:
        for p in (1, 5, 7, 12):
            gh = pgu.geohash_encode(lat, lon, p)
            assert gh == jgu.geohash_encode(lat, lon, p)
            assert pgu.geohash_decode(gh) == jgu.geohash_decode(gh)
    assert pgu.geohash_decode("9Q8YY") == jgu.geohash_decode("9Q8YY")


def _detection_frames():
    g = np.random.default_rng(0)
    n = 2000
    yield pd.DataFrame({"latitude": g.uniform(-60, 60, n), "longitude": g.uniform(-170, 170, n)})
    yield pd.DataFrame({"position_a": g.uniform(25, 49, n), "position_b": g.uniform(-124, -67, n),
                        "price": g.uniform(200, 500, n).round(2), "qty": g.integers(0, 50, n)})
    yield pd.DataFrame({"latitude": g.uniform(-60, 60, n), "x": g.normal(size=n)})
    yield pd.DataFrame({"plat_version": g.integers(1, 8, n).astype(float),
                        "lng": np.where(g.random(n) < 0.1, np.nan, g.uniform(-170, 170, n))})
    from anovos_tpu_torch.data_transformer.geo_utils import geohash_encode

    cells = [geohash_encode(a, o, 7) for a, o in zip(g.uniform(-60, 60, 400), g.uniform(-170, 170, 400))]
    yield pd.DataFrame({"cell": cells + ["unknown_location"], "word": ["alpha", "beta"] * 200 + ["x"],
                        "short": ["9q8y"] * 401})
    yield geo_frame(3000, 3)


@pytest.mark.parametrize("case", range(6))
def test_ll_gh_cols_matches_jax(case):
    from anovos_tpu.data_ingest.geo_auto_detection import ll_gh_cols as jdetect
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.data_ingest.geo_auto_detection import ll_gh_cols
    from anovos_tpu_torch.shared.table import Table

    df = list(_detection_frames())[case]
    got = ll_gh_cols(Table.from_pandas(df))
    assert got == jdetect(JTable.from_pandas(df))
    # a lone latitude or longitude resets both; every other frame detects
    assert any(got) == (case not in (2, 3))


def test_geo_helpers_match_jax():
    from anovos_tpu.data_ingest import geo_auto_detection as jgad
    from anovos_tpu_torch.data_ingest import geo_auto_detection as pgad

    for v in (None, -12.5, 0.0, 33.25, float("nan"), 1.123456789):
        assert pgad.conv_str_plus(v) == jgad.conv_str_plus(v)
        assert pgad.precision_lev(v) == jgad.precision_lev(v)
    assert pgad.latlong_to_geo(12.5, -7.25, 9) == jgad.latlong_to_geo(12.5, -7.25, 9)
    assert pgad.latlong_to_geo(None, 1.0) is None
    assert pgad.geo_to_latlong("u4pruyd") == jgad.geo_to_latlong("u4pruyd")
    for opt in ("latitude", "longitude"):
        assert pgad.reg_lat_lon(opt).pattern == jgad.reg_lat_lon(opt).pattern


def test_stats_charts_and_cluster_generator_match_jax(tmp_path):
    """Every other public writer of the analyzer on one small table: the
    stats of lat/lon pairs and geohash columns, the cluster generator over
    a lat/lon pair and a decoded precision-5 geohash (its cell centres sit
    on a 45/1024-degree lattice, also clear of every eps), the location
    charts and descriptive_stats_geospatial."""
    from anovos_tpu.data_analyzer import geospatial_analyzer as jga
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.data_analyzer import geospatial_analyzer as pga
    from anovos_tpu_torch.shared.table import Table

    df = geo_frame(3000, 8, gh_precision=5)
    pt, jt = Table.from_pandas(df), JTable.from_pandas(df)
    for mod, t, d in ((pga, pt, tmp_path / "p"), (jga, jt, tmp_path / "j")):
        (d / "charts").mkdir(parents=True)
        mod.stats_gen_lat_long_geo(t, ["latitude"], ["longitude"], ["geohash"], "id", str(d), 50)
        mod.geo_cluster_generator(t, ["latitude"], ["longitude"], ["geohash"], max_cluster=8,
                                  eps="0.3,0.5,0.1", min_samples="20,80,30", master_path=str(d))
        mod.generate_loc_charts_controller(t, "id", ["latitude"], ["longitude"], ["geohash"], 40,
                                           master_path=str(d / "charts"))
    assert_dirs_match(str(tmp_path / "p"), str(tmp_path / "j"))
    assert_dirs_match(str(tmp_path / "p" / "charts"), str(tmp_path / "j" / "charts"))
    assert pga.descriptive_stats_geospatial(pt, "latitude", "longitude", 1000) == \
        jga.descriptive_stats_geospatial(jt, "latitude", "longitude", 1000)
