"""Calendar functions over int32 epoch seconds, on the tensor's device
(counterpart of ``anovos_tpu/ops/datetime_kernels.py``).

Calendar decomposition is Howard Hinnant's civil-date algorithm: int32
floor divisions and multiplies, so timestamps never leave the device.
Every intermediate stays int32 and wraps as XLA's int32 does; divisions
and remainders floor (``torch.div(..., rounding_mode="floor")``,
``torch.remainder``), so dates before 1970 decompose as in the JAX package.
Host work is limited to the timezone transition table (``tz_offset_table``).

Epoch range: int32 seconds, 1901-12-13 .. 2038-01-19, the Table's ts
storage.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from anovos_tpu_torch.obs.timed import timed

SECS_PER_DAY = 86400

# cumulative days before each month, and days in each month (non-leap)
_CUM_DAYS = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334)
_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=like.device)


def _is_leap(y: torch.Tensor) -> torch.Tensor:
    return (torch.remainder(y, 4) == 0) & ((torch.remainder(y, 100) != 0) |
                                           (torch.remainder(y, 400) == 0))


def _i32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32)


def civil_from_epoch(secs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Calendar fields of epoch seconds, all int32 on ``secs``' device:
    year, month, day, hour, minute, second, dayofweek (Mon=0), dayofyear
    (1-based), quarter, weekofyear (ISO), days (epoch days), sod (second of
    day), leap (bool)."""
    secs = secs.to(torch.int32)
    days = _fdiv(secs, SECS_PER_DAY)
    sod = secs - days * SECS_PER_DAY
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy_mar = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # day of year, Mar 1 = 0
    mp = _fdiv(5 * doy_mar + 2, 153)
    d = doy_mar - _fdiv(153 * mp + 2, 5) + 1
    m = mp + 3 - 12 * _i32(mp >= 10)
    y = y + _i32(m <= 2)
    leap = _is_leap(y)
    cum = _table(_CUM_DAYS, secs)
    doy = cum[(m - 1).long()] + d + _i32((m > 2) & leap)
    dow = torch.remainder(days + 3, 7)  # 1970-01-01 was a Thursday; Mon = 0
    quarter = _fdiv(m - 1, 3) + 1
    week = _fdiv(doy - (dow + 1) + 10, 7)

    def weeks_in(yy, lp):
        # 53-week years: Jan 1 is a Thursday, or a Wednesday in a leap year
        ones = torch.ones_like(yy)
        jan1_dow = torch.remainder(_days_from_civil(yy, ones, ones) + 3, 7)
        return 52 + _i32((jan1_dow == 3) | (lp & (jan1_dow == 2)))

    week = torch.where(week < 1, weeks_in(y - 1, _is_leap(y - 1)),
                       torch.where(week > weeks_in(y, leap), torch.ones_like(week), week))
    return {
        "year": y, "month": m, "day": d,
        "hour": _fdiv(sod, 3600), "minute": torch.remainder(_fdiv(sod, 60), 60),
        "second": torch.remainder(sod, 60),
        "dayofweek": dow, "dayofyear": doy, "quarter": quarter, "weekofyear": week,
        "days": days, "sod": sod, "leap": leap,
    }


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Hinnant days_from_civil: (y, m, d) → epoch days, int32."""
    y = y - _i32(m <= 2)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    doy = _fdiv(153 * (m - 3 + 12 * _i32(m <= 2)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return _days_from_civil(y.to(torch.int32), m.to(torch.int32), d.to(torch.int32))


def _days_in_month(m: torch.Tensor, leap: torch.Tensor) -> torch.Tensor:
    return _table(_MONTH_DAYS, m)[(m - 1).long()] + _i32((m == 2) & leap)


@timed("ops.extract_unit")
def extract_unit(secs: torch.Tensor, unit: str) -> torch.Tensor:
    """One calendar component (pandas ``.dt`` semantics; dayofweek is
    1-based, as the reference's shifted Spark dayofweek)."""
    c = civil_from_epoch(secs)
    if unit in ("day", "dayofmonth"):
        return c["day"]
    if unit == "dayofweek":
        return c["dayofweek"] + 1
    return c[unit]


@timed("ops.period_boundary")
def period_boundary(secs: torch.Tensor, which: str, period: str) -> torch.Tensor:
    """Start or end (midnight) of the month, quarter or year, as epoch
    seconds."""
    c = civil_from_epoch(secs)
    y, m = c["year"], c["month"]
    if period == "month":
        m0 = m
    elif period == "quarter":
        m0 = (c["quarter"] - 1) * 3 + 1
    else:  # year
        m0 = torch.ones_like(m)
    if which == "start":
        days = _days_from_civil(y, m0, torch.ones_like(m0))
    else:
        m1 = m0 + {"month": 0, "quarter": 2, "year": 11}[period]
        days = _days_from_civil(y, m1, _days_in_month(m1, c["leap"]))
    return days * SECS_PER_DAY


@timed("ops.is_period_boundary")
def is_period_boundary(secs: torch.Tensor, which: str, period: str) -> torch.Tensor:
    """pandas is_{month,quarter,year}_{start,end}: the calendar day equals
    the period's boundary day (time of day ignored)."""
    c = civil_from_epoch(secs)
    return c["days"] * SECS_PER_DAY == period_boundary(secs, which, period)


@timed("ops.add_months")
def add_months(secs: torch.Tensor, months: int) -> torch.Tensor:
    """Month-aware shift with end-of-month clamping (``DateOffset``)."""
    c = civil_from_epoch(secs)
    total = c["year"] * 12 + (c["month"] - 1) + months
    y2 = _fdiv(total, 12)
    m2 = total - y2 * 12 + 1
    d2 = torch.minimum(c["day"], _days_in_month(m2, _is_leap(y2)))
    return _days_from_civil(y2, m2, d2) * SECS_PER_DAY + c["sod"]


def apply_offset_table(secs: torch.Tensor, transitions: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Timezone shift on the device: ``transitions`` (T,) sorted int32 epoch
    seconds, ``offsets`` (T+1,) int32 second deltas; offsets[i] applies to
    seconds in [transitions[i-1], transitions[i])."""
    secs = secs.to(torch.int32)
    idx = torch.searchsorted(transitions.to(torch.int32).contiguous(), secs, right=True)
    return secs + offsets.to(torch.int32)[idx]


def tz_offset_table(given_tz: str, output_tz: str, lo_sec: int, hi_sec: int):
    """Host helper: the merged transition table for given→output tz over
    [lo_sec, hi_sec], as (transitions int32, offsets int32) numpy arrays for
    ``apply_offset_table``.  The delta at instant t is offset_out(t) −
    offset_in(t), t read as a wall clock in ``given_tz``."""
    from datetime import datetime, timezone
    from zoneinfo import ZoneInfo

    zi, zo = ZoneInfo(given_tz), ZoneInfo(output_tz)

    def delta_at(ts: int) -> int:
        naive = datetime.fromtimestamp(ts, tz=timezone.utc).replace(tzinfo=None)
        out = naive.replace(tzinfo=zi).astimezone(zo).replace(tzinfo=None)
        return int((out - naive).total_seconds())

    # DST changes happen at most twice a year: probe day boundaries, then
    # bisect each change to its second
    lo_d, hi_d = lo_sec // SECS_PER_DAY - 1, hi_sec // SECS_PER_DAY + 2
    days = np.arange(lo_d, hi_d + 1, dtype=np.int64) * SECS_PER_DAY
    deltas = np.array([delta_at(int(t)) for t in days])
    change = np.nonzero(deltas[1:] != deltas[:-1])[0]
    transitions = []
    offsets = [int(deltas[0])]
    for i in change:
        lo_t, hi_t = int(days[i]), int(days[i + 1])
        a, b = deltas[i], deltas[i + 1]
        while hi_t - lo_t > 1:
            mid = (lo_t + hi_t) // 2
            if delta_at(mid) == a:
                lo_t = mid
            else:
                hi_t = mid
        transitions.append(hi_t)
        offsets.append(int(b))
    return (np.asarray(transitions, np.int64).astype(np.int32),
            np.asarray(offsets, np.int32))
