"""Per-row geospatial math on the device (counterpart of
``anovos_tpu/ops/geo_kernels.py``): format conversions, the three
distances, geohash bits, ray-cast containment and per-segment centroids
as plain torch ops.

The conversions and distances take the f32 column values, compute in
float64 and return float64; callers store f32, as the JAX package stores
its f32 results.  That keeps the JAX formulas, constants and special
cases (Vincenty's 20 fixed rounds, ``d = 0`` where ``sin_sigma < 1e-12``,
haversine where Vincenty is not finite) without f32's loss on
near-antipodal pairs.  Geohash bits come from an exact float64 interval
bisection of the f32 input.  The polygon test keeps the JAX package's f32
straddle test and crossing abscissa, so its flags are the JAX flags, and
tiles the rows to bound its (rows, edges) block.  Segment sums run in
float64 with int64 counts, so they do not depend on the order of atomic
adds.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from anovos_tpu_torch.obs.timed import timed

EARTH_RADIUS_M = 6371009.0  # the host codec's, geo_utils.EARTH_RADIUS_M

_WGS84_A = 6_378_137.0
_WGS84_B = 6_356_752.314245
_WGS84_F = 1 / 298.257223563

# elements of one (rows, edges) block of the polygon test
POLYGON_TILE_ELEMENTS = 1 << 27

def _f64(*ts):
    return [t.to(torch.float64) for t in ts]


def radians(x: torch.Tensor) -> torch.Tensor:
    """Degrees → radians in float64."""
    return x.to(torch.float64) * (math.pi / 180.0)


def degrees(x: torch.Tensor) -> torch.Tensor:
    """Radians → degrees in float64."""
    return x.to(torch.float64) * (180.0 / math.pi)


def latlon_to_cartesian(lat: torch.Tensor, lon: torch.Tensor):
    """Degrees → (x, y, z) in metres on the sphere of EARTH_RADIUS_M."""
    latr, lonr = radians(lat), radians(lon)
    return (
        EARTH_RADIUS_M * torch.cos(latr) * torch.cos(lonr),
        EARTH_RADIUS_M * torch.cos(latr) * torch.sin(lonr),
        EARTH_RADIUS_M * torch.sin(latr),
    )


def cartesian_to_latlon(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y, z) → (lat, lon) degrees.  The arctan2 form needs no radius, so
    it also takes the mean vectors of segment_centroid, inside the sphere."""
    x, y, z = _f64(x, y, z)
    return degrees(torch.atan2(z, torch.sqrt(x * x + y * y))), degrees(torch.atan2(y, x))


def haversine(lat1, lon1, lat2, lon2) -> torch.Tensor:
    """Great-circle distance in metres."""
    lat1, lon1, lat2, lon2 = _f64(lat1, lon1, lat2, lon2)
    p1, p2 = radians(lat1), radians(lat2)
    dp, dl = radians(lat2 - lat1), radians(lon2 - lon1)
    a = torch.sin(dp / 2) ** 2 + torch.cos(p1) * torch.cos(p2) * torch.sin(dl / 2) ** 2
    return 2 * EARTH_RADIUS_M * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def equirectangular(lat1, lon1, lat2, lon2) -> torch.Tensor:
    """Equirectangular approximation in metres (the 'euclidean' type)."""
    lat1, lon1, lat2, lon2 = _f64(lat1, lon1, lat2, lon2)
    x = radians(lon2 - lon1) * torch.cos(radians((lat1 + lat2) / 2))
    y = radians(lat2 - lat1)
    return EARTH_RADIUS_M * torch.sqrt(x * x + y * y)


def _vincenty_terms(lam, sinU1, cosU1, sinU2, cosU2):
    sinl, cosl = torch.sin(lam), torch.cos(lam)
    sin_sigma = torch.sqrt((cosU2 * sinl) ** 2 + (cosU1 * sinU2 - sinU1 * cosU2 * cosl) ** 2)
    cos_sigma = sinU1 * sinU2 + cosU1 * cosU2 * cosl
    sigma = torch.atan2(sin_sigma, cos_sigma)
    sin_alpha = torch.where(sin_sigma > 0, cosU1 * cosU2 * sinl / torch.clamp(sin_sigma, min=1e-12), 0.0)
    cos2_alpha = 1 - sin_alpha ** 2
    cos_2sm = torch.where(cos2_alpha > 0,
                          cos_sigma - 2 * sinU1 * sinU2 / torch.clamp(cos2_alpha, min=1e-12), 0.0)
    return sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha, cos_2sm


@timed("ops.vincenty")
def vincenty(lat1, lon1, lat2, lon2, iters: int = 20) -> torch.Tensor:
    """Vincenty's inverse geodesic on the WGS-84 ellipsoid in metres, a
    fixed ``iters`` rounds of the λ update (no convergence test);
    coincident points give 0, and pairs where the series is not finite
    (near-antipodal) take the haversine distance."""
    lat1, lon1, lat2, lon2 = _f64(lat1, lon1, lat2, lon2)
    U1 = torch.atan((1 - _WGS84_F) * torch.tan(radians(lat1)))
    U2 = torch.atan((1 - _WGS84_F) * torch.tan(radians(lat2)))
    L = radians(lon2 - lon1)
    sinU1, cosU1 = torch.sin(U1), torch.cos(U1)
    sinU2, cosU2 = torch.sin(U2), torch.cos(U2)
    lam = L
    for _ in range(iters):
        sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha, cos_2sm = _vincenty_terms(
            lam, sinU1, cosU1, sinU2, cosU2)
        C = _WGS84_F / 16 * cos2_alpha * (4 + _WGS84_F * (4 - 3 * cos2_alpha))
        lam = L + (1 - C) * _WGS84_F * sin_alpha * (
            sigma + C * sin_sigma * (cos_2sm + C * cos_sigma * (-1 + 2 * cos_2sm ** 2)))
    sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha, cos_2sm = _vincenty_terms(
        lam, sinU1, cosU1, sinU2, cosU2)
    u2 = cos2_alpha * (_WGS84_A ** 2 - _WGS84_B ** 2) / _WGS84_B ** 2
    A = 1 + u2 / 16384 * (4096 + u2 * (-768 + u2 * (320 - 175 * u2)))
    B = u2 / 1024 * (256 + u2 * (-128 + u2 * (74 - 47 * u2)))
    dsig = B * sin_sigma * (
        cos_2sm
        + B / 4 * (
            cos_sigma * (-1 + 2 * cos_2sm ** 2)
            - B / 6 * cos_2sm * (-3 + 4 * sin_sigma ** 2) * (-3 + 4 * cos_2sm ** 2)
        )
    )
    d = _WGS84_B * A * (sigma - dsig)
    d = torch.where(sin_sigma < 1e-12, 0.0, d)
    return torch.where(torch.isfinite(d), d, haversine(lat1, lon1, lat2, lon2))


def _frac_bits(v: torch.Tensor, offset: float, rng: float, nbits: int) -> torch.Tensor:
    """First ``nbits`` binary-fraction bits of (v + offset) / rng, packed
    into an int64 (MSB first), for the f32 values ``v``.

    An interval bisection in float64: every midpoint −offset + rng·j/2^k
    (k ≤ 31) is exact in float64, and so is every f32 input, so each
    comparison is exact and the bits are those of the input's exact value
    (a value on a midpoint goes to the upper half), as the host encoder
    ``geo_utils.geohash_encode`` gives them."""
    x = v.to(torch.float32).to(torch.float64)
    lo = torch.full_like(x, -offset)
    hi = torch.full_like(x, rng - offset)
    q = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for _ in range(nbits):
        mid = (lo + hi) * 0.5
        bit = x >= mid
        lo = torch.where(bit, mid, lo)
        hi = torch.where(bit, hi, mid)
        q = q * 2 + bit.to(torch.int64)
    return q


def geohash_digits(lat: torch.Tensor, lon: torch.Tensor, precision: int) -> torch.Tensor:
    """Geohash base-32 digit indices, (rows, precision) int64: the lon and
    lat fraction bits (``_frac_bits``), interleaved lon first, 5 bits a
    digit."""
    nbits = 5 * precision
    n_lon = (nbits + 1) // 2
    n_lat = nbits // 2
    q_lon = _frac_bits(lon, 180.0, 360.0, n_lon)
    q_lat = _frac_bits(lat, 90.0, 180.0, n_lat)
    digits = []
    for j in range(precision):
        d = None
        for k in range(5):
            b = 5 * j + k  # global bit index; even → lon, odd → lat
            if b % 2 == 0:
                bit = (q_lon >> (n_lon - 1 - b // 2)) & 1
            else:
                bit = (q_lat >> (n_lat - 1 - b // 2)) & 1
            d = bit if d is None else d * 2 + bit
        digits.append(d)
    return torch.stack(digits, dim=1)


def point_in_polygon_set(lat, lon, ex1, ey1, ex2, ey2, poly_id, n_poly: int) -> torch.Tensor:
    """Union of per-polygon even-odd ray-cast containment (x = lon,
    y = lat): rows bool.  The rings of one polygon (outer and holes) share
    an id, so parity runs per polygon and overlapping polygons union.

    The straddle test and the crossing abscissa
    ``xi = x1 + (py − y1)(x2 − x1)/(y2 − y1)`` are the JAX package's f32
    operations in its order, so the flags are its flags.  Rows go through
    in tiles of at most POLYGON_TILE_ELEMENTS (row, edge) pairs, and each
    tile's crossings are summed per polygon by ``index_add_`` over the
    polygon ids, never a dense one-hot."""
    py_all, px_all = lat.to(torch.float32), lon.to(torch.float32)
    x1, y1 = ex1.to(torch.float32)[None, :], ey1.to(torch.float32)[None, :]
    x2, y2 = ex2.to(torch.float32)[None, :], ey2.to(torch.float32)[None, :]
    dx = x2 - x1
    den = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    pid = poly_id.to(torch.int64)
    rows, n_edges = py_all.shape[0], x1.shape[1]
    out = torch.zeros(rows, dtype=torch.bool, device=py_all.device)
    if rows == 0 or n_edges == 0:
        return out
    tile = max(1, POLYGON_TILE_ELEMENTS // n_edges)
    for s in range(0, rows, tile):
        py, px = py_all[s:s + tile, None], px_all[s:s + tile, None]
        straddles = (y1 > py) != (y2 > py)
        xi = x1 + (py - y1) * dx / den
        crossing = (straddles & (px < xi)).to(torch.int32)
        counts = torch.zeros((crossing.shape[0], n_poly), dtype=torch.int32, device=crossing.device)
        counts.index_add_(1, pid, crossing)
        out[s:s + tile] = (counts % 2 == 1).any(dim=1)
    return out


def _segment_sums(vals, seg, valid, nseg: int) -> torch.Tensor:
    """(len(vals), nseg) float64 sums of each row of ``vals`` over the valid
    rows of each segment."""
    s = torch.where(valid, seg.to(torch.int64), nseg)
    out = torch.zeros((vals.shape[0], nseg + 1), dtype=torch.float64, device=vals.device)
    out.index_add_(1, s, torch.where(valid, vals.to(torch.float64), 0.0))
    return out[:, :nseg]


@timed("ops.segment_centroid")
def segment_centroid(x, y, z, seg, valid, nseg: int):
    """Per-segment cartesian means → (clat, clon) float64 and the int64
    count of valid rows, each (nseg,)."""
    s = torch.where(valid, seg.to(torch.int64), nseg)
    cnt = torch.bincount(s, minlength=nseg + 1)[:nseg]
    sx, sy, sz = _segment_sums(torch.stack(_f64(x, y, z)), seg, valid, nseg)
    n = torch.clamp(cnt, min=1).to(torch.float64)
    clat, clon = cartesian_to_latlon(sx / n, sy / n, sz / n)
    return clat, clon, cnt


@timed("ops.segment_weighted_centroid")
def segment_weighted_centroid(x, y, z, w, seg, valid, nseg: int):
    """Per-segment weighted cartesian means → (clat, clon, sum of weights),
    float64 (nseg,); a segment whose weights sum to 0 divides by 1."""
    x, y, z, w = _f64(x, y, z, w)
    sw, sx, sy, sz = _segment_sums(torch.stack([w, x * w, y * w, z * w]), seg, valid, nseg)
    d = torch.where(sw != 0, sw, 1.0)
    clat, clon = cartesian_to_latlon(sx / d, sy / d, sz / d)
    return clat, clon, sw


@timed("ops.segment_rog")
def segment_rog(lat, lon, seg, valid, nseg: int):
    """Radius of gyration per segment: the RMS haversine distance of its
    valid rows to its centroid → (rog float64, count int64), (nseg,)."""
    x, y, z = latlon_to_cartesian(lat, lon)
    clat, clon, cnt = segment_centroid(x, y, z, seg, valid, nseg)
    safe = torch.clamp(seg.to(torch.int64), 0, nseg - 1)
    d = haversine(lat, lon, clat[safe], clon[safe])
    (sd2,) = _segment_sums((d * d)[None, :], seg, valid, nseg)
    return torch.sqrt(sd2 / torch.clamp(cnt, min=1).to(torch.float64)), cnt
