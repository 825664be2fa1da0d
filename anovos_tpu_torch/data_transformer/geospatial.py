"""Geospatial transformers (counterpart of
``anovos_tpu/data_transformer/geospatial.py``): format conversion (dd,
dms, radian, cartesian, geohash), distances, geohash precision control,
country and polygon containment, centroids, radius of gyration and
reverse geocoding, with the JAX package's names, arguments, output column
names and dtype names.

The per-row math runs on the Table's device through ``ops/geo_kernels``;
the host touches only the dms and geohash strings (a vocabulary, or one
string a row where the output is a string), the GeoJSON edges and the
small per-id result frames.  Numeric outputs are stored as f32 columns
named ``double``, as the JAX package stores them; they are computed in
float64 from the f32 inputs.
"""

from __future__ import annotations

import json
import os
import re
import threading
import warnings
from typing import List, Optional, Union

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_transformer import geo_utils
from anovos_tpu_torch.data_transformer.datetime import argument_checker
from anovos_tpu_torch.ops import geo_kernels as gk
from anovos_tpu_torch.ops.mxu import true_f32
from anovos_tpu_torch.shared.table import Column, Table, host_to_column

EARTH_RADIUS_M = geo_utils.EARTH_RADIUS_M


def _dev_num(idf: Table, col: str):
    """(f32 values, mask) of a numeric column on the Table's device."""
    c = idf.columns[col]
    return c.data.to(torch.float32), c.mask


def _add_dev(idf: Table, name: str, vals: torch.Tensor, mask: torch.Tensor) -> Table:
    """``vals`` stored as an f32 ``double`` column, 0 where ``mask`` is False."""
    v = torch.where(mask, vals.to(torch.float32), 0.0)
    return idf.with_column(name, Column("num", v, mask, dtype_name="double"))


def _host_num(idf: Table, col: str) -> tuple:
    """(float64 values with NaN at nulls, mask) of a numeric column on the host."""
    c = idf.columns[col]
    vals = c.data.cpu().numpy().astype(float)
    mask = c.mask.cpu().numpy()
    return np.where(mask, vals, np.nan), mask


def _host_cat(idf: Table, col: str) -> np.ndarray:
    """A categorical column's strings on the host, None at nulls."""
    c = idf.columns[col]
    codes = c.data.cpu().numpy()
    mask = c.mask.cpu().numpy() & (codes >= 0)
    out = np.full(idf.nrows, None, dtype=object)
    out[mask] = c.vocab[codes[mask]]
    return out


def _add_cat(idf: Table, name: str, values: np.ndarray) -> Table:
    return idf.with_column(name, host_to_column(np.asarray(values, object), idf.nrows, idf.device))


def _dd_to_dms_str(v: np.ndarray) -> np.ndarray:
    """Decimal degrees → ``D°M'S.SSSS"`` strings, None where not finite."""
    av = np.abs(v)
    d = np.floor(av)
    m = np.floor((av - d) * 60)
    s = (av - d - m / 60) * 3600
    # explicit sign prefix: int(sg*dd) would lose the '-' for values in
    # (-1, 0) where the degree part is zero
    return np.array(
        [
            None
            if not np.isfinite(x)
            else f"{'-' if x < 0 else ''}{int(dd)}°{int(mm)}'{ss:.4f}\""
            for x, dd, mm, ss in zip(v, d, m, s)
        ],
        dtype=object,
    )


_DMS = re.compile(r"(-?\d+)[°d:\s]+(\d+)['m:\s]+([\d.]+)")


def _dms_str_to_dd(vals: np.ndarray) -> np.ndarray:
    """dms strings → float64 decimal degrees, NaN where a string does not parse."""
    out = np.full(len(vals), np.nan)
    for i, v in enumerate(vals):
        if v is None:
            continue
        sv = str(v).strip()
        m = _DMS.search(sv)
        if m:
            d, mi, s = float(m.group(1)), float(m.group(2)), float(m.group(3))
            # sign from the string, not float(d): "-0°30'" parses d as -0.0
            neg = sv.startswith("-")
            out[i] = (abs(d) + mi / 60 + s / 3600) * (-1 if neg else 1)
    return out


_BASE32_BYTES = np.frombuffer(b"0123456789bcdefghjkmnpqrstuvwxyz", np.uint8)


def _geohash_column(idf: Table, lat_d, lon_d, mask, name: str, precision: int = 9) -> Table:
    """lat/lon → geohash string column: the bits on the device; on the host
    the (rows, precision) digit matrix becomes the bytes of one Arrow
    string array (no Python string a row), null where ``mask`` is False."""
    import pyarrow as pa

    digits = gk.geohash_digits(lat_d, lon_d, precision).cpu().numpy()
    valid = mask.cpu().numpy()
    rows = len(digits)
    arr = pa.LargeStringArray.from_buffers(
        rows, pa.py_buffer(np.arange(rows + 1, dtype=np.int64) * precision),
        pa.py_buffer(np.ascontiguousarray(_BASE32_BYTES[digits])),
        pa.py_buffer(np.packbits(valid, bitorder="little")), null_count=int(rows - valid.sum()))
    strs = pd.arrays.ArrowExtensionArray(arr)
    return idf.with_column(name, host_to_column(strs, rows, idf.device))


def _latlon_dev_from_input(idf: Table, lat_c: str, lon_c: str, fmt: str):
    """Input decode → (lat, lon) f32 degrees on the device and the mask."""
    if fmt in ("dd", "radian"):
        lat, ml = _dev_num(idf, lat_c)
        lon, mo = _dev_num(idf, lon_c)
        if fmt == "radian":
            lat, lon = gk.degrees(lat).float(), gk.degrees(lon).float()
        return lat, lon, ml & mo
    if fmt == "dms":  # strings: host parse, one upload
        lat_h = _dms_str_to_dd(_host_cat(idf, lat_c))
        lon_h = _dms_str_to_dd(_host_cat(idf, lon_c))
        ok = np.isfinite(lat_h) & np.isfinite(lon_h)
        dev = idf.device
        return (torch.from_numpy(np.where(ok, lat_h, 0.0).astype(np.float32)).to(dev),
                torch.from_numpy(np.where(ok, lon_h, 0.0).astype(np.float32)).to(dev),
                torch.from_numpy(ok).to(dev))
    raise ValueError(f"unsupported loc_input_format {fmt}")


def _rad32(deg: torch.Tensor) -> torch.Tensor:
    return gk.radians(deg).float()


def _split(v) -> list:
    return [x.strip() for x in v.split("|")] if isinstance(v, str) else v


def geo_format_latlon(
    idf: Table,
    list_of_lat: Union[str, List[str]],
    list_of_lon: Union[str, List[str]],
    input_format: Optional[str] = None,
    output_format: Optional[str] = None,
    result_prefix="",
    optional_configs: Optional[dict] = None,
    output_mode: str = "append",
    loc_input_format: str = "dd",
    loc_output_format: str = "dms",
) -> Table:
    """Convert lat/lon pairs between dd / dms / radian / cartesian /
    geohash.  ``input_format``/``output_format`` take precedence over their
    aliases ``loc_input_format``/``loc_output_format``;
    ``optional_configs["geohash_precision"]`` (default 9) sets the geohash
    length.  A string in the ``optional_configs`` slot is taken as
    ``output_mode`` (the older positional call)."""
    if isinstance(optional_configs, str):
        optional_configs, output_mode = None, optional_configs
    loc_input_format = input_format or loc_input_format
    loc_output_format = output_format or loc_output_format
    argument_checker("geo_format_latlon", {"output_mode": output_mode})
    gh_precision = int((optional_configs or {}).get("geohash_precision", 9))
    list_of_lat, list_of_lon = _split(list_of_lat), _split(list_of_lon)
    if isinstance(result_prefix, (list, tuple)):
        result_prefix = "|".join(str(p) for p in result_prefix)
    odf = idf
    for i, (lat_c, lon_c) in enumerate(zip(list_of_lat, list_of_lon)):
        lat, lon, mask = _latlon_dev_from_input(idf, lat_c, lon_c, loc_input_format)
        # keep EMPTY entries: ["", "p2"] means pair 0 is unprefixed
        prefixes = str(result_prefix).split("|") if result_prefix else []
        pre = prefixes[i] if i < len(prefixes) else (prefixes[-1] if prefixes else "")
        pre = pre + "_" if pre else ""
        if loc_output_format == "dd":
            odf = _add_dev(odf, f"{pre}{lat_c}_dd", lat, mask)
            odf = _add_dev(odf, f"{pre}{lon_c}_dd", lon, mask)
        elif loc_output_format == "radian":
            odf = _add_dev(odf, f"{pre}{lat_c}_radian", _rad32(lat), mask)
            odf = _add_dev(odf, f"{pre}{lon_c}_radian", _rad32(lon), mask)
        elif loc_output_format == "dms":  # string output: host format
            m = mask.cpu().numpy()
            lat_h = np.where(m, lat.cpu().numpy().astype(float), np.nan)
            lon_h = np.where(m, lon.cpu().numpy().astype(float), np.nan)
            odf = _add_cat(odf, f"{pre}{lat_c}_dms", _dd_to_dms_str(lat_h))
            odf = _add_cat(odf, f"{pre}{lon_c}_dms", _dd_to_dms_str(lon_h))
        elif loc_output_format == "cartesian":
            x, y, z = gk.latlon_to_cartesian(lat, lon)
            odf = _add_dev(odf, f"{pre}{lat_c}_{lon_c}_x", x, mask)
            odf = _add_dev(odf, f"{pre}{lat_c}_{lon_c}_y", y, mask)
            odf = _add_dev(odf, f"{pre}{lat_c}_{lon_c}_z", z, mask)
        elif loc_output_format == "geohash":
            odf = _geohash_column(odf, lat, lon, mask, f"{pre}{lat_c}_{lon_c}_geohash", gh_precision)
        else:
            raise ValueError(f"unsupported loc_output_format {loc_output_format}")
        if output_mode == "replace":
            odf = odf.drop([lat_c, lon_c])
    return odf


def geo_format_cartesian(
    idf: Table,
    list_of_x,
    list_of_y,
    list_of_z,
    output_format: Optional[str] = None,
    result_prefix: str = "",
    loc_output_format: str = "dd",
    output_mode: str = "append",
    **_ignored,
) -> Table:
    """Cartesian → dd / radian / geohash.  ``output_format`` takes
    precedence over its alias ``loc_output_format``."""
    argument_checker("geo_format_cartesian", {"output_mode": output_mode})
    loc_output_format = output_format or loc_output_format
    list_of_x, list_of_y, list_of_z = _split(list_of_x), _split(list_of_y), _split(list_of_z)
    odf = idf
    for xc, yc, zc in zip(list_of_x, list_of_y, list_of_z):
        x, mx = _dev_num(idf, xc)
        y, my = _dev_num(idf, yc)
        z, mz = _dev_num(idf, zc)
        mask = mx & my & mz
        lat, lon = (t.float() for t in gk.cartesian_to_latlon(x, y, z))
        pre = (result_prefix + "_") if result_prefix else ""
        if loc_output_format == "dd":
            odf = _add_dev(odf, f"{pre}{xc}_{yc}_{zc}_lat", lat, mask)
            odf = _add_dev(odf, f"{pre}{xc}_{yc}_{zc}_lon", lon, mask)
        elif loc_output_format == "radian":
            odf = _add_dev(odf, f"{pre}{xc}_{yc}_{zc}_lat_radian", _rad32(lat), mask)
            odf = _add_dev(odf, f"{pre}{xc}_{yc}_{zc}_lon_radian", _rad32(lon), mask)
        elif loc_output_format == "geohash":
            odf = _geohash_column(odf, lat, lon, mask, f"{pre}{xc}_{yc}_{zc}_geohash")
        else:
            raise ValueError(f"unsupported loc_output_format {loc_output_format}")
        if output_mode == "replace":
            odf = odf.drop([xc, yc, zc])
    return odf


def geo_format_geohash(
    idf: Table,
    list_of_geohash,
    output_format: Optional[str] = None,
    result_prefix: str = "",
    loc_output_format: str = "dd",
    output_mode: str = "append",
    **_ignored,
) -> Table:
    """Geohash → lat/lon: each DISTINCT hash decoded once on the host, then
    a gather maps the codes to coordinates on the device.
    ``output_format`` takes precedence over ``loc_output_format``."""
    argument_checker("geo_format_geohash", {"output_mode": output_mode})
    loc_output_format = output_format or loc_output_format
    odf = idf
    for c in _split(list_of_geohash):
        col = idf.columns[c]
        lat_h, lon_h = geo_utils.geohash_decode_many(col.vocab)
        if len(lat_h) == 0:
            lat_h, lon_h = np.full(1, np.nan), np.full(1, np.nan)
        ok_v = np.isfinite(lat_h) & np.isfinite(lon_h)
        dev = idf.device
        lat_v = torch.from_numpy(np.where(ok_v, lat_h, 0.0).astype(np.float32)).to(dev)
        lon_v = torch.from_numpy(np.where(ok_v, lon_h, 0.0).astype(np.float32)).to(dev)
        safe = torch.clamp(col.data.to(torch.int64), 0, len(ok_v) - 1)
        mask = col.mask & (col.data >= 0) & torch.from_numpy(ok_v).to(dev)[safe]
        lat_d, lon_d = lat_v[safe], lon_v[safe]
        pre = (result_prefix + "_") if result_prefix else ""
        if loc_output_format == "radian":
            lat_d, lon_d = _rad32(lat_d), _rad32(lon_d)
        odf = _add_dev(odf, f"{pre}{c}_latitude", lat_d, mask)
        odf = _add_dev(odf, f"{pre}{c}_longitude", lon_d, mask)
        if output_mode == "replace":
            odf = odf.drop([c])
    return odf


_DISTANCES = {"haversine": gk.haversine, "vincenty": gk.vincenty, "euclidean": gk.equirectangular}


def location_distance(
    idf: Table,
    list_of_lat=None,
    list_of_lon=None,
    distance_type: str = "haversine",
    unit: str = "m",
    result_prefix: str = "",
    list_of_cols_loc1=None,
    list_of_cols_loc2=None,
    loc_format: str = "dd",
    **_ignored,
) -> Table:
    """Distance between two locations a row, as ``<prefix_>distance_<type>``
    in metres or km.  Two calling conventions: ``list_of_cols_loc1=["lat1",
    "lon1"], list_of_cols_loc2=["lat2", "lon2"]`` with a ``loc_format``
    (dd or radian), or ``list_of_lat=["lat1", "lat2"], list_of_lon=["lon1",
    "lon2"]``."""
    if (list_of_cols_loc1 is None) != (list_of_cols_loc2 is None):
        raise TypeError("list_of_cols_loc1 and list_of_cols_loc2 must be given together")
    if list_of_cols_loc1 is not None and list_of_cols_loc2 is not None:
        list_of_cols_loc1, list_of_cols_loc2 = _split(list_of_cols_loc1), _split(list_of_cols_loc2)
        list_of_lat = [list_of_cols_loc1[0], list_of_cols_loc2[0]]
        list_of_lon = [list_of_cols_loc1[1], list_of_cols_loc2[1]]
    list_of_lat, list_of_lon = _split(list_of_lat), _split(list_of_lon)
    if len(list_of_lat) != 2 or len(list_of_lon) != 2:
        raise ValueError("location_distance expects exactly two lat and two lon columns")
    lat1, m1 = _dev_num(idf, list_of_lat[0])
    lat2, m2 = _dev_num(idf, list_of_lat[1])
    lon1, m3 = _dev_num(idf, list_of_lon[0])
    lon2, m4 = _dev_num(idf, list_of_lon[1])
    if loc_format == "radian":
        lat1, lat2, lon1, lon2 = (gk.degrees(t) for t in (lat1, lat2, lon1, lon2))
    elif loc_format != "dd":
        raise ValueError(f"unsupported loc_format {loc_format} (dd/radian)")
    fn = _DISTANCES.get(distance_type)
    if fn is None:
        raise ValueError(f"unsupported distance_type {distance_type}")
    d = fn(lat1, lon1, lat2, lon2)
    if unit == "km":
        d = d / 1000.0
    pre = (result_prefix + "_") if result_prefix else ""
    return _add_dev(idf, f"{pre}distance_{distance_type}", d, m1 & m2 & m3 & m4)


_GEOHASH_ERR_KM = [2500, 630, 78, 20, 2.4, 0.61, 0.076, 0.019, 0.0024, 0.0006, 0.000074]


def geohash_precision_control(
    idf: Table,
    list_of_geohash,
    output_precision: Optional[int] = None,
    km_max_error: Optional[float] = None,
    output_mode: str = "replace",
    **_ignored,
) -> Table:
    """Truncate geohashes to ``output_precision`` characters (default 8),
    or to the shortest precision whose error radius is at most
    ``km_max_error``: the distinct strings truncate on the host, the codes
    remap on the device through a small lookup table."""
    if km_max_error is not None:
        precision = next((i + 1 for i, e in enumerate(_GEOHASH_ERR_KM) if e <= km_max_error),
                         len(_GEOHASH_ERR_KM))
    else:
        precision = int(output_precision if output_precision is not None else 8)
    odf = idf
    for c in _split(list_of_geohash):
        col = idf.columns[c]
        if col.kind != "cat" or len(col.vocab) == 0:
            continue
        # fixed-width numpy strings truncate and sort in C, in str order
        trunc = np.asarray(col.vocab, dtype=f"U{precision}") if precision > 0 else np.full(len(col.vocab), "")
        new_vocab, inv = np.unique(trunc, return_inverse=True)
        lut = torch.from_numpy(inv.astype(np.int32).reshape(-1)).to(col.data.device)
        safe = torch.clamp(col.data.to(torch.int64), 0, len(lut) - 1)
        data = torch.where(col.data >= 0, lut[safe], -1).to(torch.int32)
        name = c if output_mode == "replace" else c + "_precision"
        odf = odf.with_column(
            name, Column("cat", data, col.mask, vocab=new_vocab.astype(object), dtype_name="string"))
    return odf


def _country_bbox(country: str):
    key = country.upper()
    for code, (name, bb) in geo_utils.COUNTRY_BOUNDING_BOXES.items():
        if key == code or key == name.upper():
            return bb
    raise ValueError(f"unknown country for approx containment: {country}")


def location_in_country(
    idf: Table,
    list_of_lat,
    list_of_lon,
    country: str = "US",
    country_shapefile_path: Optional[str] = None,
    method_type: str = "approx",
    result_prefix: str = "",
    **_ignored,
) -> Table:
    """Flag rows inside a country as ``<prefix_><lat>_<lon>_in_<country>``
    (1.0 / 0.0): "approx" compares against the country's bounding box,
    "exact" ray-casts against the polygons of the GeoJSON file at
    ``country_shapefile_path``."""
    odf = idf
    for lat_c, lon_c in zip(_split(list_of_lat), _split(list_of_lon)):
        lat, ml = _dev_num(idf, lat_c)
        lon, mo = _dev_num(idf, lon_c)
        if method_type == "approx" or not country_shapefile_path:
            lo_lon, lo_lat, hi_lon, hi_lat = map(float, _country_bbox(country))
            # f32 comparisons against the f32-rounded bounds, as the JAX package's
            inside = (lat >= lo_lat) & (lat <= hi_lat) & (lon >= lo_lon) & (lon <= hi_lon)
        else:
            inside = gk.point_in_polygon_set(lat, lon, *_geojson_edges(country_shapefile_path, idf.device))
        pre = (result_prefix + "_") if result_prefix else ""
        odf = _add_dev(odf, f"{pre}{lat_c}_{lon_c}_in_{country}", inside.to(torch.float32), ml & mo)
    return odf


def location_in_polygon(
    idf: Table,
    list_of_lat,
    list_of_lon,
    polygon: dict,
    result_prefix=(),
    output_mode: str = "append",
    **_ignored,
) -> Table:
    """Flag rows inside a GeoJSON object (Polygon, MultiPolygon, Feature or
    FeatureCollection) as ``<lat>_<lon>_in_poly`` (or
    ``<result_prefix[i]>_in_poly``), 1.0 / 0.0: every ring flattened into
    one edge set, one ray cast a lat/lon pair."""
    list_of_lat, list_of_lon, result_prefix = _split(list_of_lat), _split(list_of_lon), _split(result_prefix)
    missing = [c for c in list(list_of_lat) + list(list_of_lon) if c not in idf.col_names]
    if missing:
        raise TypeError(f"Invalid input for list_of_lat or list_of_lon: {missing}")
    if len(list_of_lat) != len(list_of_lon):
        raise TypeError("list_of_lat and list_of_lon must have the same length")
    if result_prefix and len(result_prefix) != len(list_of_lat):
        raise TypeError("result_prefix must have the same length as list_of_lat")
    edges = _geojson_obj_edges(polygon, idf.device)
    odf = idf
    for i, (lat_c, lon_c) in enumerate(zip(list_of_lat, list_of_lon)):
        lat, ml = _dev_num(idf, lat_c)
        lon, mo = _dev_num(idf, lon_c)
        inside = gk.point_in_polygon_set(lat, lon, *edges)
        name = (result_prefix[i] if result_prefix else f"{lat_c}_{lon_c}") + "_in_poly"
        odf = _add_dev(odf, name, inside.to(torch.float32), ml & mo)
        if output_mode == "replace":
            odf = odf.drop([lat_c, lon_c])
    return odf


def _geojson_edges(path: str, device=None):
    """All rings of a GeoJSON file as edge arrays (``_geojson_obj_edges``)."""
    with open(path) as f:
        return _geojson_obj_edges(json.load(f), device)


def _geojson_obj_edges(gj: dict, device=None):
    """Flatten all rings of a parsed GeoJSON object into f32 edge arrays
    and an int64 polygon id an edge, on ``device``: the rings of one polygon
    (outer and holes) share an id, so even-odd parity runs per polygon and
    overlapping polygons union.  Returns (ex1, ey1, ex2, ey2, poly_id,
    n_poly)."""
    feats = gj["features"] if gj.get("type") == "FeatureCollection" else [gj]
    x1s, y1s, x2s, y2s, pids = [], [], [], [], []
    n_poly = 0
    for feat in feats:
        geom = feat.get("geometry", feat)
        polys = geom["coordinates"] if geom["type"] == "MultiPolygon" else [geom["coordinates"]]
        for poly in polys:
            for ring in poly:
                pts = np.asarray(ring, float)
                nxt = np.roll(pts, -1, axis=0)
                x1s.append(pts[:, 0])
                y1s.append(pts[:, 1])
                x2s.append(nxt[:, 0])
                y2s.append(nxt[:, 1])
                pids.append(np.full(len(pts), n_poly, np.int64))
            n_poly += 1

    def put(parts, dtype):
        return torch.from_numpy(np.concatenate(parts).astype(dtype)).to(device)

    f32 = np.float32
    return put(x1s, f32), put(y1s, f32), put(x2s, f32), put(y2s, f32), put(pids, np.int64), n_poly


def _id_codes(idf: Table, id_col: str):
    """(codes, valid) on the device and the host labels of a grouping
    column: a categorical column's codes and vocabulary, or a numeric
    column's ``torch.unique`` inverse and sorted distinct values (the exact
    int64/float64 values of a wide column)."""
    col = idf.columns[id_col]
    if col.kind == "cat":
        return col.data, col.mask & (col.data >= 0), col.vocab
    vals = col.exact if col.exact is not None else col.data
    uniq, inv = torch.unique(vals[col.mask], return_inverse=True)
    codes = torch.zeros(idf.nrows, dtype=torch.int64, device=vals.device)
    codes[col.mask] = inv
    return codes, col.mask, uniq.cpu().numpy()


def centroid(idf: Table, lat_col: str, long_col: str, id_col: Optional[str] = None) -> pd.DataFrame:
    """Per-id (or global) centroid, the mean of the points' cartesian
    vectors: [id?, <lat>_centroid, <long>_centroid], rounded to 6 decimals.
    Ids with no valid row are left out."""
    lat, ml = _dev_num(idf, lat_col)
    lon, mo = _dev_num(idf, long_col)
    x, y, z = gk.latlon_to_cartesian(lat, lon)
    if id_col:
        seg, valid, labels = _id_codes(idf, id_col)
        if len(labels) == 0:  # all-null id column: empty result frame
            return pd.DataFrame(columns=[id_col, lat_col + "_centroid", long_col + "_centroid"])
        clat, clon, cnt = (t.cpu().numpy() for t in gk.segment_centroid(x, y, z, seg, valid & ml & mo,
                                                                         len(labels)))
        keep = cnt > 0
        return pd.DataFrame({
            id_col: np.asarray(labels)[keep],
            lat_col + "_centroid": np.round(clat[keep], 6),
            long_col + "_centroid": np.round(clon[keep], 6),
        }).reset_index(drop=True)
    seg = torch.zeros(idf.nrows, dtype=torch.int64, device=lat.device)
    clat, clon, _ = (t.cpu().numpy() for t in gk.segment_centroid(x, y, z, seg, ml & mo, 1))
    return pd.DataFrame({lat_col + "_centroid": np.round(clat, 6), long_col + "_centroid": np.round(clon, 6)})


def weighted_centroid(
    idf: Table, lat_col: str, long_col: str, id_col: str, weight_col: str
) -> pd.DataFrame:
    """Per-id weighted centroid: [id, <lat>_weighted_centroid,
    <long>_weighted_centroid], rounded to 6 decimals; ids whose valid
    weights sum to 0 are left out."""
    lat, ml = _dev_num(idf, lat_col)
    lon, mo = _dev_num(idf, long_col)
    w, mw = _dev_num(idf, weight_col)
    x, y, z = gk.latlon_to_cartesian(lat, lon)
    seg, valid, labels = _id_codes(idf, id_col)
    if len(labels) == 0:
        return pd.DataFrame(columns=[id_col, lat_col + "_weighted_centroid", long_col + "_weighted_centroid"])
    clat, clon, sw = (t.cpu().numpy() for t in gk.segment_weighted_centroid(
        x, y, z, w, seg, valid & ml & mo & mw, len(labels)))
    keep = sw != 0
    return pd.DataFrame({
        id_col: np.asarray(labels)[keep],
        lat_col + "_weighted_centroid": np.round(clat[keep], 6),
        long_col + "_weighted_centroid": np.round(clon[keep], 6),
    }).reset_index(drop=True)


def rog_calculation(idf: Table, lat_col: str, long_col: str, id_col: str) -> pd.DataFrame:
    """Radius of gyration per id, the RMS haversine distance in metres of
    its points to its centroid: [id, rog]; ids with no valid row left out."""
    lat, ml = _dev_num(idf, lat_col)
    lon, mo = _dev_num(idf, long_col)
    seg, valid, labels = _id_codes(idf, id_col)
    if len(labels) == 0:
        return pd.DataFrame(columns=[id_col, "rog"])
    rog, cnt = (t.cpu().numpy() for t in gk.segment_rog(lat, lon, seg, valid & ml & mo, len(labels)))
    keep = cnt > 0
    return pd.DataFrame({id_col: np.asarray(labels)[keep], "rog": rog[keep]}).reset_index(drop=True)


# resolved path → (unit vectors (C, 3) f32 on the host, the city frame)
_GEOCODE_CACHE = {}
_GEOCODE_CACHE_LOCK = threading.Lock()


def _geocode_table() -> tuple:
    """The offline city table with its unit vectors, cached per resolved
    path (a change of the environment override takes effect).  Resolution
    order:

    1. ``ANOVOS_GEOCODE_TABLE``: a ``.csv`` (name, admin1, cc, lat, lon) or a
       ``.npz`` of the same arrays;
    2. ``data/cities.npz`` beside this module, when present;
    3. ``data/world_cities.csv`` beside this module (573 cities: capitals,
       large cities and the zoneinfo city list).
    """
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    path = os.environ.get("ANOVOS_GEOCODE_TABLE")
    if not path:
        npz = os.path.join(d, "cities.npz")
        path = npz if os.path.exists(npz) else os.path.join(d, "world_cities.csv")
    with _GEOCODE_CACHE_LOCK:
        if path not in _GEOCODE_CACHE:
            if path.endswith(".npz"):
                z = np.load(path, allow_pickle=False)
                cities = pd.DataFrame({
                    "name": z["name"].astype(str),
                    "admin1": z["admin1"].astype(str),
                    "cc": z["cc"].astype(str),
                    "lat": z["lat"].astype(np.float64),
                    "lon": z["lon"].astype(np.float64),
                })
            else:
                # keep_default_na=False: Namibia's country code IS the string "NA"
                cities = pd.read_csv(path, keep_default_na=False)
            la = np.radians(cities["lat"].to_numpy(float))
            lo = np.radians(cities["lon"].to_numpy(float))
            xyz = np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)],
                           axis=1).astype(np.float32)
            _GEOCODE_CACHE[path] = (xyz, cities)
        return _GEOCODE_CACHE[path]


_GEOCODE_CHUNK = 8192


def _nearest_city_chunk(lat_deg: torch.Tensor, lon_deg: torch.Tensor, city_xyz: torch.Tensor) -> torch.Tensor:
    """argmin great-circle distance = argmax dot product with the city unit
    vectors: one (n, 3) @ (3, C) f32 product (TF32 off), then argmax."""
    la = torch.deg2rad(lat_deg.to(torch.float32))
    lo = torch.deg2rad(lon_deg.to(torch.float32))
    pts = torch.stack([torch.cos(la) * torch.cos(lo), torch.cos(la) * torch.sin(lo), torch.sin(la)], dim=1)
    with true_f32():
        return torch.argmax(pts @ city_xyz.T, dim=1)


def _nearest_city_idx(lat: torch.Tensor, lon: torch.Tensor, city_xyz: np.ndarray) -> np.ndarray:
    """Nearest city of each point, in chunks of _GEOCODE_CHUNK points, so
    that a large city table never makes an (n, C) score matrix."""
    cx = torch.from_numpy(city_xyz).to(lat.device)
    out = torch.empty(len(lat), dtype=torch.int64, device=lat.device)
    for s in range(0, len(lat), _GEOCODE_CHUNK):
        out[s:s + _GEOCODE_CHUNK] = _nearest_city_chunk(lat[s:s + _GEOCODE_CHUNK], lon[s:s + _GEOCODE_CHUNK], cx)
    return out.cpu().numpy()


def reverse_geocoding(idf: Table, lat_col: str, long_col: str, **_ignored) -> pd.DataFrame:
    """[lat, long, name_of_place, region, country_code] of each row with a
    valid location, from its nearest city.  The optional
    ``reverse_geocoder`` package, when importable, takes precedence with
    its denser table; otherwise the nearest city of ``_geocode_table``."""
    if lat_col not in idf.columns:
        raise TypeError("Invalid input for lat_col")
    if long_col not in idf.columns:
        raise TypeError("Invalid input for long_col")
    lat, ml = _host_num(idf, lat_col)
    lon, mo = _host_num(idf, long_col)
    ok = ml & mo & np.isfinite(lat) & np.isfinite(lon)
    if (~ok).any():
        warnings.warn("Rows dropped due to null value in longitude and/or latitude values")
    rng_ok = (lat >= -90) & (lat <= 90) & (lon >= -180) & (lon <= 180)
    if (ok & ~rng_ok).any():
        warnings.warn("Rows dropped due to longitude and/or latitude values being out of the valid range")
    ok &= rng_ok
    if not ok.any():
        warnings.warn("No reverse_geocoding Computation - No valid latitude/longitude row(s) to compute")
        return pd.DataFrame(columns=[lat_col, long_col, "name_of_place", "region", "country_code"])
    la, lo = lat[ok], lon[ok]
    try:  # pragma: no cover - optional dependency with a denser database
        import reverse_geocoder as rg

        res = rg.search(list(zip(la, lo)), mode=1)
        name = [r["name"] for r in res]
        admin1 = [r["admin1"] for r in res]
        cc = [r["cc"] for r in res]
    except ImportError:
        city_xyz, cities = _geocode_table()
        keep = torch.from_numpy(ok).to(idf.device)
        idx = _nearest_city_idx(idf.columns[lat_col].data[keep], idf.columns[long_col].data[keep], city_xyz)
        name = cities["name"].to_numpy()[idx]
        admin1 = cities["admin1"].to_numpy()[idx]
        cc = cities["cc"].to_numpy()[idx]
    return pd.DataFrame({
        lat_col: la,
        long_col: lo,
        "name_of_place": name,
        "region": admin1,
        "country_code": cc,
    }).reset_index(drop=True)
