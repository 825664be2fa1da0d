"""The port's geospatial transformers (``anovos_tpu_torch/data_transformer/
geospatial.py`` over ``ops/geo_kernels.py``) against the JAX package's on
the same seeded frames, and against float64 references (``geo_utils``,
pandas).

Exact: geohash digits and strings (cell edges, ±0.0, ±90, ±180 among
them), dms strings and parsed values, precision-control vocabularies and
codes, polygon flags, keep sets and ids.  Bands, stated where used: the
distances, conversions, centroids and radii, computed in float64 by the
port and stored f32 as the JAX package stores them.

Three faults of the JAX package the port does not copy are pinned here
(ROADMAP Queue C): centroids by an integer id (an empty frame in JAX),
the f32 distances near the antipode, and geohash bits where the f32 sum
``v + offset`` rounds across a cell edge.
"""

import json

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

R = 6371009.0
N = 3000
GAP = 2e5  # metres short of the antipode below which a pair counts as near-antipodal


def geo_frame(n: int = N, seed: int = 0) -> pd.DataFrame:
    """Two lat/lon pairs (half the second within ~50 km of the first, half
    uniform, 5% near-antipodal), 2% nulls in lat1 and lon2, an int id with
    7 values and the same ids as strings, a float id, a positive weight,
    and a third pair (clat, clon) clustered by id.  Values are f32's, so
    neither package keeps a wide copy."""
    g = np.random.default_rng(seed)
    lat1, lon1 = g.uniform(-80, 80, n), g.uniform(-180, 180, n)
    near = g.random(n) < 0.5
    lat2 = np.where(near, lat1 + g.normal(0, 0.2, n), g.uniform(-85, 85, n))
    lon2 = np.where(near, lon1 + g.normal(0, 0.2, n), g.uniform(-180, 180, n))
    anti = ~near & (g.random(n) < 0.1)
    lat2[anti] = -lat1[anti] + g.normal(0, 0.05, anti.sum())
    lon2[anti] = lon1[anti] + 180 + g.normal(0, 0.05, anti.sum())
    lon2 = (lon2 + 180) % 360 - 180
    f32 = lambda a: a.astype(np.float32).astype(np.float64)  # noqa: E731
    df = pd.DataFrame({"lat1": f32(lat1), "lon1": f32(lon1), "lat2": f32(np.clip(lat2, -90, 90)),
                       "lon2": f32(lon2)})
    df.loc[g.random(n) < 0.02, "lat1"] = np.nan
    df.loc[g.random(n) < 0.02, "lon2"] = np.nan
    uid = g.integers(0, 7, n)
    df["uid"] = uid
    df["sid"] = np.array([f"id{u}" for u in uid], object)
    df["fid"] = f32(uid * 1.5 - 2.25)
    df["w"] = f32(g.uniform(0.5, 2.0, n))
    # a cluster of points a uid (sigma 2 degrees) for the centroids
    centres = np.stack([g.uniform(-60, 60, 7), g.uniform(-170, 170, 7)], 1)
    pts = centres[uid] + g.normal(0, 2.0, (n, 2))
    df["clat"], df["clon"] = f32(pts[:, 0]), f32(pts[:, 1])
    df.loc[g.random(n) < 0.02, "clat"] = np.nan
    return df


def edge_frame() -> pd.DataFrame:
    """Points exactly on geohash cell edges (multiples of 180/2^j and
    360/2^j), ±0.0, ±90 and ±180."""
    lat = [k * 180.0 / 2 ** j - 90 for j in range(1, 26, 3) for k in (1, 3, 2 ** j - 1)]
    lon = [k * 360.0 / 2 ** j - 180 for j in range(1, 26, 3) for k in (1, 5, 2 ** j - 3)]
    lat += [0.0, -0.0, 90.0, -90.0, 0.0, -0.0]
    lon += [0.0, -0.0, 180.0, -180.0, -180.0, 180.0]
    m = min(len(lat), len(lon))
    return pd.DataFrame({"lat1": np.float32(lat[:m]).astype(float), "lon1": np.float32(lon[:m]).astype(float)})


def both(df):
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    return Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)


def pair_cols(df):
    return [df[c].to_numpy(np.float64) for c in ("lat1", "lon1", "lat2", "lon2")]


@pytest.fixture(scope="module")
def frame():
    return geo_frame()


@pytest.fixture(scope="module")
def tables(frame):
    return both(frame)


@pytest.mark.parametrize("kind,host,jax_atol,jax_rtol", [
    ("haversine", "haversine_distance", 1.0, 4e-6),
    ("vincenty", "vincenty_distance", 3.0, 1e-6),
    ("euclidean", "euclidean_distance", 1.0, 5e-7),
])
def test_location_distance_matches_jax_and_float64(tables, frame, kind, host, jax_atol, jax_rtol):
    """metres and km; the port within f32 storage (1e-3 m + 1.2e-7·d) of
    float64 ``geo_utils`` and within jax_atol + jax_rtol·d of JAX's f32,
    both away from the antipode (nearer than GAP, counted: there Vincenty's
    series does not converge in either float64 form, and JAX's f32 loses
    its bits, see test_near_antipodal_distances_keep_their_bits)."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geo_utils, geospatial

    pt, jt = tables
    ref = getattr(geo_utils, host)(*pair_cols(frame))
    hav = geo_utils.haversine_distance(*pair_cols(frame))
    far = np.isfinite(ref) & (np.pi * R - hav > GAP)
    assert 50 < (np.isfinite(ref) & ~far).sum() < 0.1 * N
    for unit, scale in (("m", 1.0), ("km", 1e-3)):
        kw = dict(list_of_lat=["lat1", "lat2"], list_of_lon=["lon1", "lon2"], distance_type=kind, unit=unit)
        got = geospatial.location_distance(pt, **kw).to_pandas()[f"distance_{kind}"].to_numpy()
        exp = jgeo.location_distance(jt, **kw).to_pandas()[f"distance_{kind}"].to_numpy()
        assert np.array_equal(np.isnan(got), np.isnan(exp)) and np.array_equal(np.isnan(got), np.isnan(ref))
        r = ref[far] * scale
        assert np.all(np.abs(got[far] - r) <= (1e-3 + 1.2e-7 * ref[far]) * scale), kind
        assert np.all(np.abs(got[far] - exp[far]) <= (jax_atol + jax_rtol * ref[far]) * scale), kind


def test_location_distance_reference_convention_and_radians(tables, frame):
    """``list_of_cols_loc1/2`` with ``loc_format="radian"`` on radian
    columns gives the dd call's distances to within the f32 storage of
    the radians (half an ulp of π is 1.2e-7 rad, 0.76 m on the sphere, so
    4 m for four coordinates)."""
    from anovos_tpu_torch.data_transformer import geospatial

    pt, _ = tables
    rad = geospatial.geo_format_latlon(pt, "lat1|lat2", "lon1|lon2", output_format="radian")
    got = geospatial.location_distance(rad, list_of_cols_loc1=["lat1_radian", "lon1_radian"],
                                       list_of_cols_loc2="lat2_radian|lon2_radian", loc_format="radian",
                                       result_prefix="r").to_pandas()["r_distance_haversine"].to_numpy()
    exp = geospatial.location_distance(pt, ["lat1", "lat2"], ["lon1", "lon2"]).to_pandas()[
        "distance_haversine"].to_numpy()
    ok = ~np.isnan(exp)
    assert np.array_equal(np.isnan(got), ~ok)
    assert np.all(np.abs(got[ok] - exp[ok]) <= 4.0 + 5e-7 * exp[ok])


def test_near_antipodal_distances_keep_their_bits():
    """Fault 2 of the JAX package, not copied: its f32 haversine loses
    hundreds of metres near the antipode (arcsin is ill-conditioned there)
    and its f32 Vincenty kilometres; the port's haversine, in float64, is
    float64 ``geo_utils``' to f32 storage."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geo_utils, geospatial

    g = np.random.default_rng(5)
    n = 400
    lat1, lon1 = g.uniform(-60, 60, n), g.uniform(-180, 180, n)
    df = pd.DataFrame({"lat1": lat1, "lon1": lon1, "lat2": -lat1 + g.normal(0, 0.02, n),
                       "lon2": (lon1 + 360 + g.normal(0, 0.02, n)) % 360 - 180}).astype(np.float32).astype(float)
    pt, jt = both(df)
    ref = geo_utils.haversine_distance(*pair_cols(df))
    kw = dict(list_of_lat=["lat1", "lat2"], list_of_lon=["lon1", "lon2"])
    got = geospatial.location_distance(pt, **kw).to_pandas()["distance_haversine"].to_numpy()
    exp = jgeo.location_distance(jt, **kw).to_pandas()["distance_haversine"].to_numpy()
    assert np.abs(exp - ref).max() > 100.0
    assert np.all(np.abs(got - ref) <= 1e-3 + 1.2e-7 * ref)


def test_geohash_digits_equal_jax_and_the_host_encoder(frame):
    """Digits of the seeded points and of points on cell edges equal the
    JAX package's and ``geo_utils.geohash_encode``'s at precision 1-12."""
    import jax.numpy as jnp

    from anovos_tpu.ops import geo_kernels as jgk
    from anovos_tpu_torch.data_transformer.geo_utils import geohash_encode
    from anovos_tpu_torch.ops import geo_kernels as pgk
    import torch

    pts = pd.concat([frame[["lat1", "lon1"]].dropna().iloc[:500], edge_frame()], ignore_index=True)
    lat, lon = (pts[c].to_numpy(np.float32) for c in ("lat1", "lon1"))
    for p in (1, 5, 9, 12):
        got = pgk.geohash_digits(torch.from_numpy(lat), torch.from_numpy(lon), p).numpy()
        exp = np.asarray(jgk.geohash_digits(jnp.asarray(lat), jnp.asarray(lon), p))
        assert np.array_equal(got, exp), p
        b32 = np.array(list("0123456789bcdefghjkmnpqrstuvwxyz"))
        strs = ["".join(r) for r in b32[got]]
        assert strs == [geohash_encode(float(a), float(o), p) for a, o in zip(lat, lon)], p


def test_geohash_where_jax_rounds_the_offset():
    """Fault 3 of the JAX package, not copied: its bits come from the f32
    sum v + 180 (v + 90) and re-inject the rounding error after 10 bits,
    so where that sum rounds onto or across a cell edge of the first 10
    bits its remaining bits are all 0 (or 1).  The port's bits are the
    exact ones, ``geohash_encode``'s."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import geo_kernels as jgk
    from anovos_tpu_torch.data_transformer.geo_utils import geohash_encode
    from anovos_tpu_torch.ops import geo_kernels as pgk

    lat = np.float32([40.28708, 31.47488, 39.72656, 10.0, 10.0])
    lon = np.float32([-1e-6, -1e-30, -119.16428, -45.000004, -44.999996])
    got = pgk.geohash_digits(torch.from_numpy(lat), torch.from_numpy(lon), 9).numpy()
    exp = np.asarray(jgk.geohash_digits(jnp.asarray(lat), jnp.asarray(lon), 9))
    b32 = np.array(list("0123456789bcdefghjkmnpqrstuvwxyz"))
    ref = [geohash_encode(float(a), float(o), 9) for a, o in zip(lat, lon)]
    assert ["".join(r) for r in b32[got]] == ref
    jax_strs = ["".join(r) for r in b32[exp]]
    assert [a != b for a, b in zip(jax_strs, ref)] == [True, True, True, True, False]
    assert jax_strs[0] == "sp0j0n010" and ref[0] == "ezpvpypcp"


@pytest.mark.parametrize("fmt_in,fmt_out", [("dd", "dms"), ("dd", "dd"), ("dd", "radian"), ("dd", "cartesian"),
                                            ("dd", "geohash"), ("radian", "dd"), ("radian", "radian"),
                                            ("dms", "dd"), ("dms", "geohash")])
def test_geo_format_latlon_matches_jax(tables, fmt_in, fmt_out):
    """Column names, dtypes and nulls equal; strings (dms, geohash) and
    dd values equal; through radians within 2 f32 ulps, cartesian within
    2 m (the port's float64 trig against XLA's f32, both stored f32).  dms
    and radian inputs are made by each package from the same dd columns."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    if fmt_in != "dd":
        pt = geospatial.geo_format_latlon(pt, "lat1|lat2", "lon1|lon2", output_format=fmt_in, output_mode="replace",
                                          result_prefix="")
        jt = jgeo.geo_format_latlon(jt, "lat1|lat2", "lon1|lon2", output_format=fmt_in, output_mode="replace",
                                    result_prefix="")
    lats, lons = (["lat1_" + fmt_in, "lat2_" + fmt_in], ["lon1_" + fmt_in, "lon2_" + fmt_in]) \
        if fmt_in != "dd" else (["lat1", "lat2"], ["lon1", "lon2"])
    kw = dict(list_of_lat=lats, list_of_lon=lons, input_format=fmt_in, output_format=fmt_out,
              result_prefix=["", "p2"], optional_configs={"geohash_precision": 7})
    got, exp = geospatial.geo_format_latlon(pt, **kw), jgeo.geo_format_latlon(jt, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    new = [c for c in got.col_names if c not in pt.col_names]
    assert len(new) == 2 * {"cartesian": 3, "geohash": 1}.get(fmt_out, 2)
    g, e = got.to_pandas()[new], exp.to_pandas()[new]
    for c in new:
        assert g[c].isna().equals(e[c].isna()), c
        if fmt_out in ("dms", "geohash") or fmt_out == "dd" and fmt_in != "radian":
            assert g[c].fillna(-999).equals(e[c].fillna(-999)), c
        elif fmt_out == "cartesian":
            np.testing.assert_allclose(g[c], e[c], atol=2.0, rtol=0, err_msg=c)
        else:
            gv, ev = g[c].to_numpy(np.float32), e[c].to_numpy(np.float32)
            ok = ~np.isnan(ev)
            assert np.all(np.abs(gv[ok] - ev[ok]) <= 2 * np.spacing(np.abs(ev[ok]))), c


def test_dms_strings_and_signs_round_trip():
    """The dms strings of values in (-1, 0) keep their '-', and parsing
    them gives the same float64 in both packages."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    v = np.array([-0.5, -0.0, 0.0, -1e-7, 12.999999, -179.75, np.nan, 45.0, -90.0])
    got, exp = geospatial._dd_to_dms_str(v), jgeo._dd_to_dms_str(v)
    assert list(got) == list(exp) and got[0].startswith("-0°")
    strs = np.array(list(got) + ["-0°30'0\"", "12d 3m 4.5s", "bad", None], object)
    np.testing.assert_array_equal(geospatial._dms_str_to_dd(strs), jgeo._dms_str_to_dd(strs))


@pytest.mark.parametrize("fmt_out", ["dd", "radian", "geohash"])
def test_geo_format_cartesian_matches_jax(tables, fmt_out):
    """From each package's cartesian columns of the same points: lat/lon
    within 3e-5 degrees (JAX's f32 round trip is off by up to 2.3e-5),
    radians within 6e-7; the
    port's geohash strings are ``geohash_encode``'s of its own f32 lat/lon,
    and JAX's wherever its lat/lon are the port's bit for bit."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geo_utils, geospatial

    pt, jt = tables
    cart = dict(list_of_lat="lat1", list_of_lon="lon1", output_format="cartesian")
    pt, jt = geospatial.geo_format_latlon(pt, **cart), jgeo.geo_format_latlon(jt, **cart)
    kw = dict(list_of_x="lat1_lon1_x", list_of_y="lat1_lon1_y", list_of_z="lat1_lon1_z", output_format=fmt_out)
    got, exp = geospatial.geo_format_cartesian(pt, **kw), jgeo.geo_format_cartesian(jt, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    new = [c for c in got.col_names if c not in pt.col_names]
    g, e = got.to_pandas()[new], exp.to_pandas()[new]
    for c in new:
        assert g[c].isna().equals(e[c].isna()), c
    if fmt_out == "geohash":
        dd = dict(kw, output_format="dd")
        pdd = geospatial.geo_format_cartesian(pt, **dd).to_pandas().iloc[:, -2:].to_numpy(np.float32)
        jdd = jgeo.geo_format_cartesian(jt, **dd).to_pandas().iloc[:, -2:].to_numpy(np.float32)
        ok = ~np.isnan(pdd[:, 0])
        strs = g[new[0]].to_numpy()
        assert list(strs[ok]) == [geo_utils.geohash_encode(float(a), float(o), 9) for a, o in pdd[ok]]
        same = ok & (pdd == jdd).all(axis=1)
        assert same.sum() > 0.3 * ok.sum() and (strs[same] == e[new[0]].to_numpy()[same]).all()
    else:
        tol = 3e-5 if fmt_out == "dd" else 6e-7
        np.testing.assert_allclose(g, e, atol=tol, rtol=0)
    if fmt_out == "dd":  # the port's round trip against the float64 source
        lat = g[new[0]].to_numpy()
        ok = ~np.isnan(lat)
        assert np.abs(lat[ok] - pt.to_pandas()["lat1"].to_numpy()[ok]).max() < 4e-6


@pytest.mark.parametrize("fmt_out", ["dd", "radian"])
def test_geo_format_geohash_matches_jax(tables, fmt_out):
    """Decoded cell centres equal (dd) or within 1 f32 ulp (radian)."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    gh = dict(list_of_lat="lat1", list_of_lon="lon1", output_format="geohash")
    pt, jt = geospatial.geo_format_latlon(pt, **gh), jgeo.geo_format_latlon(jt, **gh)
    kw = dict(list_of_geohash="lat1_lon1_geohash", output_format=fmt_out, result_prefix="d", output_mode="replace")
    got, exp = geospatial.geo_format_geohash(pt, **kw), jgeo.geo_format_geohash(jt, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    g, e = (t.to_pandas()[["d_lat1_lon1_geohash_latitude", "d_lat1_lon1_geohash_longitude"]] for t in (got, exp))
    if fmt_out == "dd":
        pd.testing.assert_frame_equal(g, e)
    else:
        gv, ev = g.to_numpy(np.float32), e.to_numpy(np.float32)
        ok = ~np.isnan(ev)
        assert np.array_equal(np.isnan(gv), ~ok)
        assert np.all(np.abs(gv[ok] - ev[ok]) <= np.spacing(np.abs(ev[ok])))


@pytest.mark.parametrize("kw", [{"output_precision": 5}, {"km_max_error": 1.0, "output_mode": "append"}, {}])
def test_geohash_precision_control_matches_jax(tables, kw):
    """Vocabularies and codes equal."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    gh = dict(list_of_lat="lat1", list_of_lon="lon1", output_format="geohash")
    pt, jt = geospatial.geo_format_latlon(pt, **gh), jgeo.geo_format_latlon(jt, **gh)
    got = geospatial.geohash_precision_control(pt, "lat1_lon1_geohash|sid|lat1", **kw)
    exp = jgeo.geohash_precision_control(jt, "lat1_lon1_geohash|sid|lat1", **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    name = "lat1_lon1_geohash" + ("_precision" if kw.get("output_mode") == "append" else "")
    gc, ec = got.columns[name], exp.columns[name]
    assert list(gc.vocab) == list(ec.vocab)
    assert np.array_equal(gc.data.numpy(), np.asarray(ec.data)[:got.nrows])
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())


def ring(cx, cy, r, k):
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    return [[float(np.float32(cx + r * np.cos(a))), float(np.float32(cy + r * np.sin(a)))] for a in t]


def polygon_object() -> dict:
    """A FeatureCollection: a MultiPolygon whose first polygon has a hole,
    and two polygons that overlap each other (~300 edges)."""
    return {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {"type": "MultiPolygon", "coordinates": [
            [ring(10, 20, 40, 60), ring(10, 20, 15, 30)],
            [ring(-100, -30, 25, 50)]]}},
        {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [ring(120, 40, 30, 80)]}},
        {"type": "Polygon", "coordinates": [ring(140, 50, 30, 80)]},
    ]}


def test_location_in_polygon_matches_jax(tables, frame):
    """Flags equal, with a hole, a MultiPolygon and two overlapping
    polygons (the overlap counts inside); each part holds points."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    kw = dict(list_of_lat="lat1|lat2", list_of_lon="lon1|lon2", polygon=polygon_object(), result_prefix="a|b")
    got = geospatial.location_in_polygon(pt, **kw).to_pandas()[["a_in_poly", "b_in_poly"]]
    exp = jgeo.location_in_polygon(jt, **kw).to_pandas()[["a_in_poly", "b_in_poly"]]
    pd.testing.assert_frame_equal(got, exp)
    lat, lon = frame["lat1"], frame["lon1"]
    flag = got["a_in_poly"]
    hole = np.hypot(lon - 10, lat - 20) < 14
    overlap = (np.hypot(lon - 120, lat - 40) < 29) & (np.hypot(lon - 140, lat - 50) < 29)
    assert (flag[hole] == 0).all() and hole.sum() > 5
    assert (flag[overlap] == 1).all() and overlap.sum() > 5
    assert 0.05 < flag.mean() < 0.5
    with pytest.raises(TypeError, match="Invalid input"):
        geospatial.location_in_polygon(pt, "nope", "lon1", polygon_object())


def test_location_in_country_matches_jax(tables, tmp_path):
    """approx (the bounding box) and exact (a GeoJSON file) flags equal."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    path = tmp_path / "shape.geojson"
    path.write_text(json.dumps(polygon_object()))
    for kw in (dict(country="US"), dict(country="India", result_prefix="x"),
               dict(country="XX", method_type="exact", country_shapefile_path=str(path))):
        got = geospatial.location_in_country(pt, "lat1|lat2", "lon1|lon2", **kw)
        exp = jgeo.location_in_country(jt, "lat1|lat2", "lon1|lon2", **kw)
        assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
        pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    with pytest.raises(ValueError, match="unknown country"):
        geospatial.location_in_country(pt, "lat1", "lon1", country="Atlantis")


def test_polygon_tiles_give_the_same_flags(frame, monkeypatch):
    """Row tiles of 1, 7 and all rows give one set of flags."""
    import torch

    from anovos_tpu_torch.data_transformer.geospatial import _geojson_obj_edges
    from anovos_tpu_torch.ops import geo_kernels

    lat = torch.from_numpy(frame["lat2"].fillna(0).to_numpy(np.float32))
    lon = torch.from_numpy(frame["lon2"].fillna(0).to_numpy(np.float32))
    edges = _geojson_obj_edges(polygon_object())
    flags = []
    for t in (1, 7 * 310, 1 << 27):
        monkeypatch.setattr(geo_kernels, "POLYGON_TILE_ELEMENTS", t)
        flags.append(geo_kernels.point_in_polygon_set(lat, lon, *edges))
    assert all(torch.equal(flags[0], f) for f in flags[1:]) and flags[0].any()


def float64_groups(df, id_col, weight=None):
    """pandas float64 centroids (unrounded) of (clat, clon) and counts of
    the valid rows."""
    d = df.dropna(subset=["clat", "clon", id_col])
    la, lo = np.radians(d["clat"]), np.radians(d["clon"])
    w = d[weight] if weight else 1.0
    xyz = pd.DataFrame({"id": d[id_col], "x": R * np.cos(la) * np.cos(lo) * w,
                        "y": R * np.cos(la) * np.sin(lo) * w, "z": R * np.sin(la) * w,
                        "w": w if weight else 1.0})
    s = xyz.groupby("id").sum()
    x, y, z = s["x"] / s["w"], s["y"] / s["w"], s["z"] / s["w"]
    return pd.DataFrame({"lat": np.degrees(np.arctan2(z, np.hypot(x, y))), "lon": np.degrees(np.arctan2(y, x)),
                         "n": xyz.groupby("id").size()})


def rog_float64(df, id_col):
    from anovos_tpu_torch.data_transformer.geo_utils import haversine_distance

    d = df.dropna(subset=["clat", "clon", id_col])
    c = float64_groups(df, id_col).loc[d[id_col]]
    dist = haversine_distance(d["clat"].to_numpy(), d["clon"].to_numpy(), c["lat"].to_numpy(), c["lon"].to_numpy())
    return pd.Series(dist ** 2, index=d[id_col].to_numpy()).groupby(level=0).mean() ** 0.5


@pytest.mark.parametrize("id_col", ["sid", "fid"])
def test_centroids_by_id_match_jax_and_float64(tables, frame, id_col):
    """String and float ids: ids and keep sets equal JAX's; centroids
    within 2e-5 degrees of JAX's f32 and within 1e-6 (6-decimal rounding)
    of a float64 pandas groupby; radii within 1e-4 relative of JAX's and
    1e-9 of float64."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    ref = float64_groups(frame, id_col)
    for fn, args, cols in (("centroid", (), ("clat_centroid", "clon_centroid")),
                           ("weighted_centroid", ("w",), ("clat_weighted_centroid", "clon_weighted_centroid"))):
        got = getattr(geospatial, fn)(pt, "clat", "clon", id_col, *args)
        exp = getattr(jgeo, fn)(jt, "clat", "clon", id_col, *args)
        assert list(got.columns) == list(exp.columns) == [id_col, *cols]
        assert list(got[id_col]) == list(exp[id_col]) == list(ref.index)
        np.testing.assert_allclose(got[list(cols)], exp[list(cols)], atol=2e-5, rtol=0)
        wref = float64_groups(frame, id_col, weight=args[0] if args else None)
        np.testing.assert_allclose(got[cols[0]], wref["lat"], atol=1.000001e-6, rtol=0)
        np.testing.assert_allclose(got[cols[1]], wref["lon"], atol=1.000001e-6, rtol=0)
    got = geospatial.rog_calculation(pt, "clat", "clon", id_col)
    exp = jgeo.rog_calculation(jt, "clat", "clon", id_col)
    assert list(got[id_col]) == list(exp[id_col])
    np.testing.assert_allclose(got["rog"], exp["rog"], rtol=1e-4)
    np.testing.assert_allclose(got["rog"], rog_float64(frame, id_col).to_numpy(), rtol=1e-9)


def test_centroids_by_integer_id_are_not_empty(tables, frame):
    """Fault 1 of the JAX package, not copied: its integer-id codes pad the
    distinct values with f32 max cast to int32 (INT32_MIN), an unsorted
    buffer, so searchsorted sends every row past the last segment and
    centroid, weighted_centroid and rog_calculation return empty frames.
    The port's ``torch.unique`` codes give pandas' 7 groups."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    ref = float64_groups(frame, "uid")
    for fn, args in (("centroid", ()), ("weighted_centroid", ("w",)), ("rog_calculation", ())):
        assert len(getattr(jgeo, fn)(jt, "clat", "clon", "uid", *args)) == 0, fn
        got = getattr(geospatial, fn)(pt, "clat", "clon", "uid", *args)
        assert list(got["uid"]) == list(ref.index) == list(range(7)), fn
    got = geospatial.centroid(pt, "clat", "clon", "uid")
    np.testing.assert_allclose(got["clat_centroid"], ref["lat"], atol=1.000001e-6, rtol=0)
    sid = geospatial.centroid(pt, "clat", "clon", "sid")
    np.testing.assert_array_equal(got[["clat_centroid", "clon_centroid"]], sid[["clat_centroid", "clon_centroid"]])


def test_keep_sets_with_empty_ids_and_zero_weights():
    """An id whose rows are all null and an id whose weights sum to exactly
    0 are left out in both packages, the rest kept; a global centroid; an
    all-null id column gives an empty frame."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    df = pd.DataFrame({"lat1": [1.0, 2.0, np.nan, 4.0, 5.0, 6.0], "lon1": [10.0, 20.0, 30.0, 40.0, 50.0, 60.0],
                       "sid": ["a", "a", "b", "c", "c", "d"], "w": [1.0, 2.0, 1.0, 2.5, -2.5, 0.5],
                       "none": [None] * 6})
    pt, jt = both(df)
    for fn, args in (("centroid", ()), ("weighted_centroid", ("w",)), ("rog_calculation", ())):
        got, exp = (getattr(m, fn)(t, "lat1", "lon1", "sid", *args) for m, t in ((geospatial, pt), (jgeo, jt)))
        assert list(got["sid"]) == list(exp["sid"]), fn
        assert list(got["sid"]) == (["a", "d"] if fn == "weighted_centroid" else ["a", "c", "d"]), fn
        empty = getattr(geospatial, fn)(pt, "lat1", "lon1", "none", *args)
        assert len(empty) == 0 and list(empty.columns) == ["none", *got.columns[1:]]
    got, exp = geospatial.centroid(pt, "lat1", "lon1"), jgeo.centroid(jt, "lat1", "lon1")
    assert list(got.columns) == list(exp.columns) and len(got) == 1
    np.testing.assert_allclose(got.to_numpy(), exp.to_numpy(), atol=2e-5)


def test_reverse_geocoding_matches_jax(tables, frame):
    """Names, regions and country codes equal JAX's except where the two
    nearest cities' dot products are within 4 f32 ulps (counted, none
    expected here); out-of-range and null rows dropped in both with the
    same warnings."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    pt, jt = tables
    with pytest.warns(UserWarning, match="null value"):
        got = geospatial.reverse_geocoding(pt, "lat1", "lon1")
    with pytest.warns(UserWarning, match="null value"):
        exp = jgeo.reverse_geocoding(jt, "lat1", "lon1")
    assert list(got.columns) == ["lat1", "lon1", "name_of_place", "region", "country_code"]
    pd.testing.assert_frame_equal(got[["lat1", "lon1"]], exp[["lat1", "lon1"]])
    xyz, cities = geospatial._geocode_table()
    la, lo = np.radians(got["lat1"].to_numpy()), np.radians(got["lon1"].to_numpy())
    s = np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)], 1) @ xyz.astype(float).T
    top2 = np.sort(s, axis=1)[:, -2:]
    close = (top2[:, 1] - top2[:, 0]) <= 4 * np.spacing(np.float32(1))
    for c in ("name_of_place", "region", "country_code"):
        assert (got[c] == exp[c])[~close].all(), c
    assert close.sum() < 5
    assert "NA" in set(cities["cc"])  # Namibia's code, not a null
    with pytest.raises(TypeError, match="lat_col"):
        geospatial.reverse_geocoding(pt, "nope", "lon1")


def test_reverse_geocoding_drops_rows_as_jax_does():
    """Out-of-range rows warn and drop; no valid row gives an empty frame."""
    from anovos_tpu.data_transformer import geospatial as jgeo
    from anovos_tpu_torch.data_transformer import geospatial

    df = pd.DataFrame({"lat": [95.0, 48.85, -33.9], "lon": [0.0, 2.35, 151.2]})
    pt, jt = both(df)
    with pytest.warns(UserWarning, match="valid range"):
        got = geospatial.reverse_geocoding(pt, "lat", "lon")
    with pytest.warns(UserWarning, match="valid range"):
        exp = jgeo.reverse_geocoding(jt, "lat", "lon")
    pd.testing.assert_frame_equal(got, exp)
    assert list(got["country_code"]) == ["FR", "AU"]
    pt, _ = both(df.iloc[:1])
    with pytest.warns(UserWarning, match="No reverse_geocoding"):
        assert len(geospatial.reverse_geocoding(pt, "lat", "lon")) == 0
