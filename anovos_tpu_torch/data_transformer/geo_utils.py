"""Geohash codec (the port's own copy of the parts of
``anovos_tpu/data_transformer/geo_utils.py`` that the geospatial analyzer
and the column auto-detection use).  Plain Python on the host; the
distances and polygon tests wait for the transformer slice."""

from __future__ import annotations

from typing import Tuple

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_BASE32_IDX = {c: i for i, c in enumerate(_BASE32)}


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
