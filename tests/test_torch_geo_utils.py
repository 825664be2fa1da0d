"""The port's host geospatial helpers (``anovos_tpu_torch/data_transformer/
geo_utils.py``) against the JAX package's ``geo_utils`` on the same seeded
inputs: the distances, polygon tests, country boxes and the scalar
location-format helpers, all float64 numpy on the host, equal bit for
bit."""

import warnings

import numpy as np
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


def _pairs(n=2000, seed=3):
    g = np.random.default_rng(seed)
    lat1, lon1 = g.uniform(-89, 89, n), g.uniform(-180, 180, n)
    lat2 = np.clip(lat1 + g.normal(0, 5, n), -90, 90)
    lon2 = lon1 + g.normal(0, 5, n)
    lat2[:100], lon2[:100] = -lat1[:100], lon1[:100] + 180  # exact antipodes
    lat2[100:110], lon2[100:110] = lat1[100:110], lon1[100:110]  # coincident
    return lat1, lon1, lat2, lon2


@pytest.mark.parametrize("fn", ["haversine_distance", "vincenty_distance", "euclidean_distance"])
@pytest.mark.parametrize("unit", ["m", "km"])
def test_distances_equal_jax(fn, unit):
    from anovos_tpu.data_transformer import geo_utils as jgu
    from anovos_tpu_torch.data_transformer import geo_utils

    args = _pairs()
    got = getattr(geo_utils, fn)(*args, unit=unit)
    np.testing.assert_array_equal(got, getattr(jgu, fn)(*args, unit=unit))
    assert np.isfinite(got).all()
    assert geo_utils.EARTH_RADIUS_M == jgu.EARTH_RADIUS_M


def _rings():
    outer = [(0.0, 0.0), (10.0, 0.0), (10.0, 10.0), (0.0, 10.0)]
    hole = [(3.0, 3.0), (7.0, 3.0), (7.0, 7.0), (3.0, 7.0)]
    other = [(5.0, 5.0), (15.0, 5.0), (15.0, 15.0), (5.0, 15.0)]
    return outer, hole, other


def test_polygon_tests_equal_jax(tmp_path):
    """point_in_polygon, point_in_geojson (a hole, a MultiPolygon, two
    overlapping polygons), _points_in_polygon_list with and without the
    bounding boxes, point_in_polygons and f_point_in_polygons."""
    import json

    from anovos_tpu.data_transformer import geo_utils as jgu
    from anovos_tpu_torch.data_transformer import geo_utils

    g = np.random.default_rng(1)
    lat, lon = g.uniform(-2, 17, 3000), g.uniform(-2, 17, 3000)
    lat[:4], lon[:4] = [0.0, 5.0, 3.0, 10.0], [0.0, 10.0, 5.0, 5.0]  # on edges and vertices
    outer, hole, other = _rings()
    got = geo_utils.point_in_polygon(lat, lon, outer)
    np.testing.assert_array_equal(got, jgu.point_in_polygon(lat, lon, outer))
    gj = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {"type": "MultiPolygon", "coordinates": [
            [[list(p) for p in outer], [list(p) for p in hole]]]}},
        {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [[list(p) for p in other]]}}]}
    path = tmp_path / "p.geojson"
    path.write_text(json.dumps(gj))
    got = geo_utils.point_in_geojson(lat, lon, str(path))
    np.testing.assert_array_equal(got, jgu.point_in_geojson(lat, lon, str(path)))
    assert got.any() and not got.all()
    polys = [[[list(p) for p in outer], [list(p) for p in hole]], [list(p) for p in other]]
    for sw, ne in (((), ()), ((1.0, 1.0), (12.0, 12.0))):
        got = geo_utils._points_in_polygon_list(lon, lat, polys, sw, ne)
        np.testing.assert_array_equal(got, jgu._points_in_polygon_list(lon, lat, polys, sw, ne))
        f, jf = geo_utils.f_point_in_polygons(polys, sw, ne), jgu.f_point_in_polygons(polys, sw, ne)
        np.testing.assert_array_equal(f(lon, lat), jf(lon, lat))
        for x, y in ((5.0, 5.0), (1.0, 1.0), (12.0, 12.0), (20.0, 20.0)):
            assert geo_utils.point_in_polygons(x, y, polys, sw, ne) == jgu.point_in_polygons(x, y, polys, sw, ne)


def test_country_boxes_equal_jax():
    from anovos_tpu.data_transformer import geo_utils as jgu
    from anovos_tpu_torch.data_transformer import geo_utils

    assert geo_utils.COUNTRY_BOUNDING_BOXES == jgu.COUNTRY_BOUNDING_BOXES
    g = np.random.default_rng(2)
    lat, lon = g.uniform(-60, 80, 4000), g.uniform(-180, 180, 4000)
    for c in ("US", "india", "Russia", "SG"):
        np.testing.assert_array_equal(geo_utils.point_in_country_approx(lat, lon, c),
                                      jgu.point_in_country_approx(lat, lon, c))
    with pytest.raises(ValueError, match="unknown country"):
        geo_utils.point_in_country_approx(lat, lon, "Atlantis")


LOCS = [
    ((40.7128, -74.006), "dd"), (("12.5", "-7.25"), "dd"), ((None, 3.0), "dd"), (None, "dd"),
    ([[40, 42, 46.08], [-74, 0, 21.6]], "dms"), ([["x", 1, 2], [3, 4, 5]], "dms"),
    ((0.7105724, -1.2916483), "radian"), ((1334000.0, -4650000.0, 4077000.0), "cartesian"),
    ("dr5regw3p", "geohash"), ("zzzzzz", "geohash"), ((95.0, 10.0), "dd"), ((1.0, 200.0), "radian"),
]


@pytest.mark.parametrize("loc,fmt", LOCS)
def test_to_latlon_and_back_equal_jax(loc, fmt):
    """to_latlon_decimal_degrees (and its in_range warning), then
    from_latlon_decimal_degrees to every format, and the dms split."""
    from anovos_tpu.data_transformer import geo_utils as jgu
    from anovos_tpu_torch.data_transformer import geo_utils

    with warnings.catch_warnings(record=True) as wg:
        warnings.simplefilter("always")
        got = geo_utils.to_latlon_decimal_degrees(loc, fmt)
    with warnings.catch_warnings(record=True) as we:
        warnings.simplefilter("always")
        exp = jgu.to_latlon_decimal_degrees(loc, fmt)
    assert got == exp
    assert [str(w.message) for w in wg] == [str(w.message) for w in we]
    for out in ("dd", "dms", "radian", "cartesian", "geohash"):
        assert geo_utils.from_latlon_decimal_degrees(got, out) == jgu.from_latlon_decimal_degrees(exp, out), out
    v = None if got is None else got[0]
    assert geo_utils.decimal_degrees_to_degrees_minutes_seconds(v) == \
        jgu.decimal_degrees_to_degrees_minutes_seconds(v)
    with warnings.catch_warnings(record=True) as wg:
        warnings.simplefilter("always")
        geo_utils.in_range(loc, fmt)
    with warnings.catch_warnings(record=True) as we:
        warnings.simplefilter("always")
        jgu.in_range(loc, fmt)
    assert len(wg) == len(we)
    with pytest.raises(ValueError, match="unknown"):
        geo_utils.to_latlon_decimal_degrees((1.0, 2.0), "utm")
    with pytest.raises(ValueError, match="unknown"):
        geo_utils.from_latlon_decimal_degrees((1.0, 2.0), "utm")


def test_vectorized_geohash_decode_equals_the_scalar_one():
    """geohash_decode_many: element for element the JAX package's
    geohash_decode (both cases, 1-12 characters), NaN for "", and its
    KeyError for a character outside the alphabet."""
    from anovos_tpu.data_transformer import geo_utils as jgu
    from anovos_tpu_torch.data_transformer import geo_utils

    g = np.random.default_rng(6)
    hs = ["".join(geo_utils._BASE32[k] for k in g.integers(0, 32, g.integers(1, 13))) for _ in range(3000)]
    hs += ["DR5REGW3P", "u", ""]
    lat, lon = geo_utils.geohash_decode_many(np.array(hs, object))
    ref = np.array([jgu.geohash_decode(h) if h else (np.nan, np.nan) for h in hs])
    np.testing.assert_array_equal(lat, ref[:, 0])
    np.testing.assert_array_equal(lon, ref[:, 1])
    with pytest.raises(KeyError, match="a"):
        geo_utils.geohash_decode_many(["dr5", "abc"])
    assert [len(x) for x in geo_utils.geohash_decode_many([])] == [0, 0]
