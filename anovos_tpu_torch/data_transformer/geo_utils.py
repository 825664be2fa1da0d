"""Geospatial primitives on the host (the port's own copy of
``anovos_tpu/data_transformer/geo_utils.py``): a base-32 geohash codec,
the haversine, Vincenty and equirectangular distances in float64 numpy,
ray-cast point-in-polygon tests, the country bounding boxes and the
scalar location-format helpers.  The geospatial analyzer, the column
auto-detection and the geospatial transformers use them; they are also
the float64 references the card's checks compare against."""

from __future__ import annotations

import json
import math
from typing import List, Sequence, Tuple

import numpy as np

EARTH_RADIUS_M = 6371009.0
_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_BASE32_IDX = {c: i for i, c in enumerate(_BASE32)}


# ----------------------------------------------------------------------
# geohash codec
# ----------------------------------------------------------------------
def geohash_encode(lat: float, lon: float, precision: int = 12) -> str:
    """(lat, lon) → geohash of ``precision`` characters: bisections of the
    longitude and latitude ranges, interleaved starting with longitude, a
    value on a midpoint going to the upper half."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    bits = []
    even = True
    while len(bits) < precision * 5:
        if even:
            mid = (lon_lo + lon_hi) / 2
            if lon >= mid:
                bits.append(1)
                lon_lo = mid
            else:
                bits.append(0)
                lon_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                bits.append(1)
                lat_lo = mid
            else:
                bits.append(0)
                lat_hi = mid
        even = not even
    out = []
    for i in range(0, len(bits), 5):
        out.append(_BASE32[int("".join(map(str, bits[i : i + 5])), 2)])
    return "".join(out)


def geohash_decode(gh: str) -> Tuple[float, float]:
    """Center point of the geohash cell."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for c in gh:
        val = _BASE32_IDX[c.lower()]
        for shift in range(4, -1, -1):
            bit = (val >> shift) & 1
            if even:
                mid = (lon_lo + lon_hi) / 2
                if bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return (lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2


# base-32 value of each ASCII code point (either case), -1 where invalid
_B32_LUT = np.full(128, -1, np.int64)
for _i, _c in enumerate(_BASE32):
    _B32_LUT[ord(_c)] = _B32_LUT[ord(_c.upper())] = _i


def geohash_decode_many(hashes) -> Tuple[np.ndarray, np.ndarray]:
    """Cell centres of many geohashes at once: (lat, lon) float64 arrays,
    element for element ``geohash_decode``'s (the same exact bisections),
    NaN for an empty string.  A string with a character outside the
    alphabet raises ``geohash_decode``'s KeyError."""
    u = np.asarray(list(hashes), dtype=str)
    n = len(u)
    width = max(u.dtype.itemsize // 4, 1)
    cps = u.view(np.uint32).reshape(n, -1) if n and u.dtype.itemsize else np.zeros((n, 1), np.uint32)
    length = np.char.str_len(u) if n else np.zeros(0, np.int64)
    vals = np.where(cps < 128, _B32_LUT[np.minimum(cps, 127)], -1)
    active = np.arange(cps.shape[1])[None, :] < length[:, None]
    bad = (active & (vals < 0)).any(axis=1)
    if bad.any():
        geohash_decode(str(u[np.argmax(bad)]))  # raises its KeyError
    lat_lo, lat_hi = np.full(n, -90.0), np.full(n, 90.0)
    lon_lo, lon_hi = np.full(n, -180.0), np.full(n, 180.0)
    even = True
    for j in range(width if n else 0):
        on = active[:, j]
        for shift in range(4, -1, -1):
            bit = ((vals[:, j] >> shift) & 1).astype(bool)
            if even:
                mid = (lon_lo + lon_hi) / 2
                lon_lo = np.where(on & bit, mid, lon_lo)
                lon_hi = np.where(on & ~bit, mid, lon_hi)
            else:
                mid = (lat_lo + lat_hi) / 2
                lat_lo = np.where(on & bit, mid, lat_lo)
                lat_hi = np.where(on & ~bit, mid, lat_hi)
            even = not even
    empty = length == 0
    return (np.where(empty, np.nan, (lat_lo + lat_hi) / 2), np.where(empty, np.nan, (lon_lo + lon_hi) / 2))


# ----------------------------------------------------------------------
# distances (vectorized)
# ----------------------------------------------------------------------
def haversine_distance(lat1, lon1, lat2, lon2, unit: str = "m") -> np.ndarray:
    lat1, lon1, lat2, lon2 = map(np.radians, (np.asarray(lat1, float), np.asarray(lon1, float), np.asarray(lat2, float), np.asarray(lon2, float)))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    d = 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
    return d / 1000.0 if unit == "km" else d


def vincenty_distance(lat1, lon1, lat2, lon2, unit: str = "m", max_iter: int = 50) -> np.ndarray:
    """WGS-84 ellipsoid inverse solution (vectorized Vincenty; falls back to
    haversine on non-convergence, e.g. near-antipodal points)."""
    a, b, f = 6378137.0, 6356752.314245, 1 / 298.257223563
    lat1, lon1, lat2, lon2 = map(np.radians, (np.asarray(lat1, float), np.asarray(lon1, float), np.asarray(lat2, float), np.asarray(lon2, float)))
    L = lon2 - lon1
    U1 = np.arctan((1 - f) * np.tan(lat1))
    U2 = np.arctan((1 - f) * np.tan(lat2))
    sinU1, cosU1 = np.sin(U1), np.cos(U1)
    sinU2, cosU2 = np.sin(U2), np.cos(U2)
    lam = L.copy() if isinstance(L, np.ndarray) else np.array(L, float)
    lam = np.array(lam, float)
    for _ in range(max_iter):
        sinLam, cosLam = np.sin(lam), np.cos(lam)
        sinSigma = np.sqrt(
            (cosU2 * sinLam) ** 2 + (cosU1 * sinU2 - sinU1 * cosU2 * cosLam) ** 2
        )
        cosSigma = sinU1 * sinU2 + cosU1 * cosU2 * cosLam
        sigma = np.arctan2(sinSigma, cosSigma)
        with np.errstate(invalid="ignore", divide="ignore"):
            sinAlpha = np.where(sinSigma != 0, cosU1 * cosU2 * sinLam / np.maximum(sinSigma, 1e-300), 0.0)
            cos2Alpha = 1 - sinAlpha**2
            cos2SigmaM = np.where(
                cos2Alpha != 0, cosSigma - 2 * sinU1 * sinU2 / np.maximum(cos2Alpha, 1e-300), 0.0
            )
        C = f / 16 * cos2Alpha * (4 + f * (4 - 3 * cos2Alpha))
        lam_new = L + (1 - C) * f * sinAlpha * (
            sigma + C * sinSigma * (cos2SigmaM + C * cosSigma * (-1 + 2 * cos2SigmaM**2))
        )
        if np.all(np.abs(lam_new - lam) < 1e-12):
            lam = lam_new
            break
        lam = lam_new
    u2 = cos2Alpha * (a**2 - b**2) / b**2
    A = 1 + u2 / 16384 * (4096 + u2 * (-768 + u2 * (320 - 175 * u2)))
    B = u2 / 1024 * (256 + u2 * (-128 + u2 * (74 - 47 * u2)))
    dSigma = (
        B
        * sinSigma
        * (
            cos2SigmaM
            + B / 4 * (cosSigma * (-1 + 2 * cos2SigmaM**2) - B / 6 * cos2SigmaM * (-3 + 4 * sinSigma**2) * (-3 + 4 * cos2SigmaM**2))
        )
    )
    d = b * A * (sigma - dSigma)
    d = np.where(np.isfinite(d), d, haversine_distance(np.degrees(lat1), np.degrees(lon1), np.degrees(lat2), np.degrees(lon2)))
    return d / 1000.0 if unit == "km" else d


def euclidean_distance(lat1, lon1, lat2, lon2, unit: str = "m") -> np.ndarray:
    """Equirectangular approximation (the 'euclidean' distance type)."""
    lat1, lon1, lat2, lon2 = (np.asarray(v, float) for v in (lat1, lon1, lat2, lon2))
    x = np.radians(lon2 - lon1) * np.cos(np.radians((lat1 + lat2) / 2))
    y = np.radians(lat2 - lat1)
    d = EARTH_RADIUS_M * np.hypot(x, y)
    return d / 1000.0 if unit == "km" else d


# ----------------------------------------------------------------------
# point in polygon (ray casting)
# ----------------------------------------------------------------------
def point_in_polygon(lat: np.ndarray, lon: np.ndarray, polygon: Sequence[Tuple[float, float]]) -> np.ndarray:
    """Vectorized ray cast: polygon = [(lon, lat), ...] ring."""
    lat = np.asarray(lat, float)
    lon = np.asarray(lon, float)
    inside = np.zeros(lat.shape, bool)
    n = len(polygon)
    for i in range(n):
        x1, y1 = polygon[i]
        x2, y2 = polygon[(i + 1) % n]
        cond = ((y1 > lat) != (y2 > lat)) & (
            lon < (x2 - x1) * (lat - y1) / np.where(y2 - y1 == 0, 1e-300, (y2 - y1)) + x1
        )
        inside ^= cond
    return inside


def point_in_geojson(lat: np.ndarray, lon: np.ndarray, geojson_path: str) -> np.ndarray:
    """Membership against every polygon of a geojson FeatureCollection."""
    with open(geojson_path) as f:
        gj = json.load(f)
    inside = np.zeros(np.asarray(lat).shape, bool)
    feats = gj["features"] if gj.get("type") == "FeatureCollection" else [gj]
    for feat in feats:
        geom = feat.get("geometry", feat)
        gtype = geom["type"]
        polys = geom["coordinates"] if gtype == "MultiPolygon" else [geom["coordinates"]]
        for poly in polys:
            outer = poly[0]
            hit = point_in_polygon(lat, lon, [(p[0], p[1]) for p in outer])
            for hole in poly[1:]:
                hit &= ~point_in_polygon(lat, lon, [(p[0], p[1]) for p in hole])
            inside |= hit
    return inside


# country bounding boxes for the "approx" containment mode
# (a representative subset of the countries; the exact mode's polygons
# cover the rest)
COUNTRY_BOUNDING_BOXES = {
    "US": ("United States", (-171.79, 18.91, -66.96, 71.36)),
    "IN": ("India", (68.17, 7.96, 97.40, 35.49)),
    "GB": ("United Kingdom", (-7.57, 49.96, 1.68, 58.64)),
    "DE": ("Germany", (5.99, 47.30, 15.02, 54.98)),
    "FR": ("France", (-5.14, 41.33, 9.56, 51.09)),
    "BR": ("Brazil", (-73.99, -33.77, -34.73, 5.24)),
    "AU": ("Australia", (113.34, -43.63, 153.57, -10.67)),
    "CN": ("China", (73.68, 18.20, 134.77, 53.46)),
    "JP": ("Japan", (129.41, 31.03, 145.54, 45.55)),
    "SG": ("Singapore", (103.60, 1.16, 104.03, 1.47)),
    "ID": ("Indonesia", (95.29, -10.36, 141.03, 5.48)),
    "ZA": ("South Africa", (16.34, -34.82, 32.83, -22.09)),
    "CA": ("Canada", (-141.0, 41.68, -52.65, 83.23)),
    "MX": ("Mexico", (-117.13, 14.54, -86.81, 32.72)),
    "RU": ("Russia", (19.66, 41.15, 180.0, 81.25)),
}


def point_in_country_approx(lat: np.ndarray, lon: np.ndarray, country: str) -> np.ndarray:
    key = country.upper()
    for code, (name, bbox) in COUNTRY_BOUNDING_BOXES.items():
        if key == code or key == name.upper():
            lo_lon, lo_lat, hi_lon, hi_lat = bbox
            lat = np.asarray(lat, float)
            lon = np.asarray(lon, float)
            return (lat >= lo_lat) & (lat <= hi_lat) & (lon >= lo_lon) & (lon <= hi_lon)
    raise ValueError(f"unknown country for approx containment: {country}")


# ----------------------------------------------------------------------
# scalar location-format helpers, the notebook-facing API; the batched
# device paths live in ops/geo_kernels.py
# ----------------------------------------------------------------------
def in_range(loc, loc_format: str = "dd") -> None:
    """Warn when a location is outside the valid lat/lon range."""
    import warnings

    try:
        if loc_format == "dd":
            lat, lon = [float(i) for i in loc]
        else:
            lat, lon = to_latlon_decimal_degrees(loc, loc_format)
    except Exception:
        return
    if lat is None or lon is None:
        return
    if lat > 90 or lat < -90 or lon > 180 or lon < -180:
        warnings.warn(
            "Rows may contain unintended values due to longitude and/or latitude "
            "values being out of the valid range"
        )


def decimal_degrees_to_degrees_minutes_seconds(dd) -> List:
    """Decimal degrees → [degree, minute, second]."""
    if dd is None:
        return [None, None, None]
    minute, second = divmod(float(dd) * 3600, 60)
    degree, minute = divmod(minute, 60)
    return [degree, minute, second]


def to_latlon_decimal_degrees(loc, input_format: str, radius: float = EARTH_RADIUS_M):
    """Any supported location format → [lat, lon]."""
    import warnings

    if loc is None:
        return None
    if isinstance(loc, (list, tuple)) and any(i is None for i in loc):
        return None
    if (
        isinstance(loc, (list, tuple))
        and loc
        and isinstance(loc[0], (list, tuple))
        and any(i is None for i in tuple(loc[0]) + tuple(loc[1]))
    ):
        return None
    if input_format not in ("dd", "dms", "radian", "cartesian", "geohash"):
        raise ValueError(f"unknown input_format {input_format}")
    lat = lon = None
    try:
        if input_format == "dd":
            lat, lon = float(loc[0]), float(loc[1])
        elif input_format == "dms":
            d1, m1, s1 = [float(i) for i in loc[0]]
            d2, m2, s2 = [float(i) for i in loc[1]]
            lat = d1 + m1 / 60 + s1 / 3600
            lon = d2 + m2 / 60 + s2 / 3600
        elif input_format == "radian":
            lat = math.degrees(float(loc[0]))
            lon = math.degrees(float(loc[1]))
        elif input_format == "cartesian":
            x, y, z = [float(i) for i in loc]
            lat = math.degrees(math.asin(z / radius))
            lon = math.degrees(math.atan2(y, x))
        elif input_format == "geohash":
            lat, lon = geohash_decode(loc)
    except Exception:  # malformed row: warn and drop, never crash
        warnings.warn("Rows dropped due to invalid longitude and/or latitude values")
        return [None, None]
    in_range((lat, lon))
    return [lat, lon]


def from_latlon_decimal_degrees(
    loc, output_format: str, radius: float = EARTH_RADIUS_M, geohash_precision: int = 8
):
    """[lat, lon] → any supported location format."""
    lat, lon = (None, None) if loc is None else (loc[0], loc[1])
    if output_format == "dd":
        return [lat, lon]
    if output_format == "dms":
        return [
            decimal_degrees_to_degrees_minutes_seconds(lat),
            decimal_degrees_to_degrees_minutes_seconds(lon),
        ]
    if lat is None or lon is None:
        return [None, None, None] if output_format == "cartesian" else (
            None if output_format == "geohash" else [None, None]
        )
    if output_format == "radian":
        return [math.radians(float(lat)), math.radians(float(lon))]
    if output_format == "cartesian":
        lat_r, lon_r = math.radians(float(lat)), math.radians(float(lon))
        return [
            radius * math.cos(lat_r) * math.cos(lon_r),
            radius * math.cos(lat_r) * math.sin(lon_r),
            radius * math.sin(lat_r),
        ]
    if output_format == "geohash":
        return geohash_encode(float(lat), float(lon), geohash_precision)
    raise ValueError(f"unknown output_format {output_format}")


def _points_in_polygon_list(x, y, polygon_list, south_west_loc=(), north_east_loc=()) -> np.ndarray:
    """Vectorized membership of (x=lon, y=lat) arrays against a
    MultiPolygon-style nested coordinate list; holes carve out via even-odd
    parity.  The bounding-box arguments pre-filter the points."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    candidate = np.ones(x.shape, bool)
    if south_west_loc:
        candidate &= (x >= south_west_loc[0]) & (y >= south_west_loc[1])
    if north_east_loc:
        candidate &= (x <= north_east_loc[0]) & (y <= north_east_loc[1])
    inside = np.zeros(x.shape, bool)
    for poly in polygon_list:
        rings = poly if isinstance(poly[0][0], (list, tuple)) else [poly]
        hit = point_in_polygon(y, x, [(p[0], p[1]) for p in rings[0]])
        for hole in rings[1:]:
            hit &= ~point_in_polygon(y, x, [(p[0], p[1]) for p in hole])
        inside |= hit
    return (inside & candidate).astype(np.int32)


def point_in_polygons(x, y, polygon_list, south_west_loc=(), north_east_loc=()) -> int:
    """Scalar form of the membership check."""
    return int(_points_in_polygon_list([x], [y], polygon_list, south_west_loc, north_east_loc)[0])


def f_point_in_polygons(polygon_list, south_west_loc=(), north_east_loc=()):
    """Membership function over arrays (a UDF factory without Spark):
    returns f(lon, lat) → int array, fully vectorized."""

    def f(x, y):
        return _points_in_polygon_list(x, y, polygon_list, south_west_loc, north_east_loc)

    return f
