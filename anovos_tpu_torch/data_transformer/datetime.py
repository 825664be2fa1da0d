"""Datetime transformers (counterpart of ``anovos_tpu/data_transformer/
datetime.py``: its 32 public functions, same names and arguments).

A ts column is int32 epoch seconds and a mask on the Table's device.
Conversions, extraction, arithmetic, predicates, bucketing, windows and
lags run as tensor ops on that device (``ops/datetime_kernels.py``).  The
host does what needs it: strptime/strftime of distinct dictionary strings,
timezone transition tables, the aggregated frames, and the steps whose
result is host strings or that the JAX package keeps on the host
(``timestamp_to_string``, the expanding median, the aggregator's fallback
for formats that are not a year→second prefix).

Where the JAX package accumulates in f32, the port accumulates in float64
and int64 (bucket counts and sums, window cumulatives) and rounds the
result to f32: counts stay exact past 2^24 rows, and a rolling sum taken as
a difference of cumulative sums keeps its digits on long columns.
"""

from __future__ import annotations

import re
import warnings
from typing import List, Optional, Union

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.ops import datetime_kernels as dk
from anovos_tpu_torch.ops.segment import vocab_lookup
from anovos_tpu_torch.shared.table import Column, Table, host_to_column

_UNITS_SECONDS = {
    "second": 1, "seconds": 1, "minute": 60, "minutes": 60, "hour": 3600,
    "hours": 3600, "day": 86400, "days": 86400, "week": 604800, "weeks": 604800,
}

_I32_BIG = np.iinfo(np.int32).max


def _cols(list_of_cols) -> List[str]:
    if isinstance(list_of_cols, str):
        return [x.strip() for x in list_of_cols.split("|")]
    return list(list_of_cols)


def argument_checker(func_name: str, args: dict) -> None:
    """Shared argument validation."""
    oc = args.get("output_mode")
    if oc is not None and oc not in ("replace", "append"):
        raise TypeError(f"{func_name}: Invalid input for output_mode")


def _ts_col(idf: Table, col: str) -> Column:
    c = idf.columns[col]
    if c.kind != "ts":
        raise TypeError(f"{col} is not a timestamp column")
    return c


def _div_for(unit: str) -> int:
    return _UNITS_SECONDS.get(unit.rstrip("s") if unit not in _UNITS_SECONDS else unit, 86400)


def _out_name(name: str, output_mode: str, postfix: str) -> str:
    return name if output_mode == "replace" else name + postfix


def _emit_flag(idf: Table, name: str, flag: torch.Tensor, mask: torch.Tensor,
               output_mode: str, postfix: str) -> Table:
    """Boolean predicate → int32 num column (null where the ts is null)."""
    col = Column("num", flag.to(torch.int32), mask, dtype_name="int")
    return idf.with_column(_out_name(name, output_mode, postfix), col)


def _emit_num(idf: Table, name: str, vals: torch.Tensor, mask: torch.Tensor,
              output_mode: str, postfix: str) -> Table:
    dtn = "int" if vals.dtype in (torch.int32, torch.int16) else "double"
    return idf.with_column(_out_name(name, output_mode, postfix),
                           Column("num", vals, mask, dtype_name=dtn))


def _emit_ts(idf: Table, name: str, secs: torch.Tensor, mask: torch.Tensor,
             output_mode: str, postfix: str = "_ts") -> Table:
    col = Column("ts", secs.to(torch.int32), mask, dtype_name="timestamp")
    return idf.with_column(_out_name(name, output_mode, postfix), col)


def _ts_series(idf: Table, col: str) -> pd.Series:
    """The column on the host, for the steps whose result is host data."""
    c = _ts_col(idf, col)
    s = pd.Series(c.data.cpu().numpy().astype("int64").astype("datetime64[s]"))
    s[~c.mask.cpu().numpy()] = pd.NaT
    return s


def _host_values(idf: Table, col: str) -> np.ndarray:
    """float64 values of a numeric column on the host, NaN where null."""
    c = idf.columns[col]
    vals = c.data.cpu().numpy().astype(float)
    vals[~c.mask.cpu().numpy()] = np.nan
    return vals


def _col_min_max(data: torch.Tensor, mask: torch.Tensor):
    """Masked (min, max) of an int tensor as Python ints; (BIG, -BIG) when
    nothing is valid."""
    if not data.numel():
        return _I32_BIG, -_I32_BIG
    lo = torch.where(mask, data, _I32_BIG).min()
    hi = torch.where(mask, data, -_I32_BIG).max()
    lo, hi = torch.stack([lo.to(torch.int64), hi.to(torch.int64)]).tolist()
    return lo, hi


# ----------------------------------------------------------------------
# conversions
# ----------------------------------------------------------------------
def timestamp_to_unix(idf: Table, list_of_cols, precision: str = "s", tz: str = "local",
                      output_mode: str = "replace") -> Table:
    """Seconds: the epoch storage itself.  Milliseconds exceed int32, so
    the column is an exact int64 one (``Column.exact``), computed on the
    device."""
    argument_checker("timestamp_to_unix", {"output_mode": output_mode})
    odf = idf
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        if precision == "s":
            new = Column("num", col.data, col.mask, dtype_name="int")
        else:
            v64 = torch.where(col.mask, col.data.to(torch.int64) * 1000, 0)
            new = Column("num", v64.to(torch.float32), col.mask, dtype_name="bigint", exact=v64)
        odf = odf.with_column(_out_name(c, output_mode, "_unix"), new)
    return odf


def unix_to_timestamp(idf: Table, list_of_cols, precision: str = "s", tz: str = "local",
                      output_mode: str = "replace") -> Table:
    """Epoch numbers → ts, from the exact values: an int64 column divides
    in int64, any other in float64 (milliseconds floor, seconds truncate
    as a cast does)."""
    argument_checker("unix_to_timestamp", {"output_mode": output_mode})
    odf = idf
    for c in _cols(list_of_cols):
        col = idf.columns[c]
        if col.exact is not None and col.exact.dtype == torch.int64:
            secs = torch.div(col.exact, 1000 if precision == "ms" else 1, rounding_mode="floor")
        else:
            src = col.exact if col.exact is not None else col.data
            v = torch.where(col.mask, src.to(torch.float64), 0.0)
            secs = torch.floor(v / 1000) if precision == "ms" else v
        odf = _emit_ts(odf, c, secs.to(torch.int32), col.mask, output_mode)
    return odf


def timezone_conversion(idf: Table, list_of_cols, given_tz: str, output_tz: str,
                        output_mode: str = "replace") -> Table:
    """Epoch shift on the device through a host-built transition table
    (``ops/datetime_kernels.apply_offset_table``), exact across DST."""
    argument_checker("timezone_conversion", {"output_mode": output_mode})
    odf = idf
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        lo, hi = _col_min_max(col.data, col.mask)
        if lo > hi:  # all null: nothing to shift
            odf = _emit_ts(odf, c, col.data, col.mask, output_mode)
            continue
        tr, off = dk.tz_offset_table(given_tz, output_tz, lo, hi)
        dev = col.data.device
        shifted = dk.apply_offset_table(col.data, torch.from_numpy(tr).to(dev),
                                        torch.from_numpy(off).to(dev))
        odf = _emit_ts(odf, c, shifted, col.mask, output_mode)
    return odf


def string_to_timestamp(idf: Table, list_of_cols, input_format: str = "%Y-%m-%d %H:%M:%S",
                        output_type: str = "ts", output_mode: str = "replace") -> Table:
    """Each distinct string is parsed once on the host; a lookup through
    the codes maps every row on the device."""
    argument_checker("string_to_timestamp", {"output_mode": output_mode})
    odf = idf
    for c in _cols(list_of_cols):
        col = idf.columns[c]
        if col.kind != "cat":
            continue
        parsed = pd.to_datetime(pd.Series(col.vocab.astype(str)), format=input_format, errors="coerce")
        arr = parsed.to_numpy().astype("datetime64[s]")
        if output_type == "dt":
            arr = arr.astype("datetime64[D]").astype("datetime64[s]")
        ok_h = ~np.isnat(arr)
        secs_h = np.where(ok_h, arr.astype("int64"), 0).astype(np.int32)
        if len(secs_h):
            ok = col.mask & (col.data >= 0) & vocab_lookup(ok_h, col.data)
            secs = torch.where(ok, vocab_lookup(secs_h, col.data), 0)
        else:
            ok, secs = torch.zeros_like(col.mask), torch.zeros_like(col.data)
        odf = odf.with_column(_out_name(c, output_mode, "_ts"),
                              Column("ts", secs, ok, dtype_name="timestamp"))
    return odf


def timestamp_to_string(idf: Table, list_of_cols, output_format: str = "%Y-%m-%d %H:%M:%S",
                        output_mode: str = "replace") -> Table:
    """String output lives on the host (dictionary columns): one pull,
    strftime, dictionary encoding."""
    argument_checker("timestamp_to_string", {"output_mode": output_mode})
    odf = idf
    for c in _cols(list_of_cols):
        s = _ts_series(idf, c)
        vals = np.array(s.dt.strftime(output_format).to_numpy(dtype=object), copy=True)
        vals[s.isna().to_numpy()] = None
        odf = odf.with_column(_out_name(c, output_mode, "_str"),
                              host_to_column(vals, idf.nrows, idf.device))
    return odf


def dateformat_conversion(idf: Table, list_of_cols, input_format: str = "%Y-%m-%d",
                          output_format: str = "%d-%m-%Y", output_mode: str = "replace") -> Table:
    """String date → string date through the dictionary alone: distinct
    values are reformatted on the host, the codes remapped on the device."""
    argument_checker("dateformat_conversion", {"output_mode": output_mode})
    odf = idf
    for c in _cols(list_of_cols):
        col = idf.columns[c]
        if col.kind != "cat":
            continue
        parsed = pd.to_datetime(pd.Series(col.vocab.astype(str)), format=input_format, errors="coerce")
        formatted = parsed.dt.strftime(output_format)
        good = formatted.notna().to_numpy()
        # distinct inputs can format to one output: keep the vocabulary
        # unique, unparsed values become null
        fmt_strs = formatted.to_numpy(dtype=object)
        new_vocab, inv = (np.unique(fmt_strs[good].astype(str), return_inverse=True) if good.any()
                          else (np.array([], dtype=object), np.array([], dtype=np.int64)))
        lut = np.full(max(len(col.vocab), 1), -1, np.int32)
        lut[np.nonzero(good)[0]] = inv.astype(np.int32)
        data = torch.where(col.data >= 0, vocab_lookup(lut, col.data), -1)
        newc = Column("cat", data, col.mask & (data >= 0), vocab=new_vocab.astype(object),
                      dtype_name="string")
        odf = odf.with_column(_out_name(c, output_mode, "_fmt"), newc)
    return odf


_EXTRACT_UNITS = (
    "year", "month", "day", "dayofmonth", "hour", "minute", "second",
    "dayofweek", "dayofyear", "weekofyear", "quarter",
)


def timeUnits_extraction(idf: Table, list_of_cols, units: Union[str, List[str]] = "all",
                         output_mode: str = "append") -> Table:
    """Calendar components as int32 numeric columns; one decomposition per
    ts column serves every unit."""
    argument_checker("timeUnits_extraction", {"output_mode": output_mode})
    units = list(_EXTRACT_UNITS[:3]) + list(_EXTRACT_UNITS[4:]) if units == "all" else _cols(units)
    for u in units:
        if u not in _EXTRACT_UNITS:
            raise TypeError(f"Invalid unit {u}")
    odf = idf
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        civ = dk.civil_from_epoch(col.data)
        for u in units:
            if u in ("day", "dayofmonth"):
                vals = civ["day"]
            elif u == "dayofweek":
                vals = civ["dayofweek"] + 1
            else:
                vals = civ[u]
            odf = _emit_num(odf, f"{c}_{u}", vals, col.mask, "append", "")
        if output_mode == "replace":
            odf = odf.drop([c])
    return odf


# ----------------------------------------------------------------------
# arithmetic
# ----------------------------------------------------------------------
def time_diff(idf: Table, ts1: str, ts2: str, unit: str = "days", output_mode: str = "append") -> Table:
    argument_checker("time_diff", {"output_mode": output_mode})
    a, b = _ts_col(idf, ts1), _ts_col(idf, ts2)
    vals = torch.abs(b.data - a.data).to(torch.float32) / float(_div_for(unit))
    odf = _emit_num(idf, f"{ts1}_{ts2}_timediff", vals, a.mask & b.mask, "append", "")
    if output_mode == "replace":
        odf = odf.drop([ts1, ts2])
    return odf


def time_elapsed(idf: Table, list_of_cols, unit: str = "days", output_mode: str = "append") -> Table:
    """now − ts."""
    argument_checker("time_elapsed", {"output_mode": output_mode})
    odf = idf
    now = int(pd.Timestamp.now().timestamp())
    div = float(_div_for(unit))
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        now_t = torch.tensor(now, dtype=torch.int32, device=col.data.device)
        vals = (now_t - col.data).to(torch.float32) / div
        odf = _emit_num(odf, f"{c}_timeelapsed", vals, col.mask, "append", "")
        if output_mode == "replace":
            odf = odf.drop([c])
    return odf


def adding_timeUnits(idf: Table, list_of_cols, unit: str = "days", unit_value: float = 1,
                     output_mode: str = "replace") -> Table:
    """Shift timestamps by N units; months and years are calendar-aware
    with end-of-month clamping (``DateOffset``)."""
    argument_checker("adding_timeUnits", {"output_mode": output_mode})
    odf = idf
    key = unit if unit.endswith("s") else unit + "s"
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        if key in ("months", "years"):
            shifted = dk.add_months(col.data, int(unit_value) * (12 if key == "years" else 1))
        else:
            if key in _UNITS_SECONDS:
                delta = int(round(unit_value * _UNITS_SECONDS[key]))
            else:  # alias spellings (min, sec, w, ...): pandas resolves them
                delta = int(round(pd.to_timedelta(float(unit_value), unit=unit).total_seconds()))
            shifted = col.data + torch.tensor(delta, dtype=torch.int32, device=col.data.device)
        odf = _emit_ts(odf, c, shifted, col.mask, output_mode, "_adjusted")
    return odf


_COMPARISONS = {
    "greater_than": torch.gt, "less_than": torch.lt,
    "greaterThan_equalTo": torch.ge, "lessThan_equalTo": torch.le,
}


def timestamp_comparison(
    idf: Table,
    list_of_cols,
    comparison_type: str = "greater_than",
    comparison_value: str = "1970-01-01 00:00:00",
    comparison_format: str = "%Y-%m-%d %H:%M:%S",
    output_mode: str = "append",
) -> Table:
    """Flag against a fixed timestamp parsed with ``comparison_format``."""
    argument_checker("timestamp_comparison", {"output_mode": output_mode})
    if comparison_type not in _COMPARISONS:
        raise TypeError("Invalid input for comparison_type")
    # naive pandas timestamps read as UTC, the module's epoch convention.
    # An explicit format is strict (it exists to settle day- vs month-
    # first); only the default format also accepts e.g. a bare date
    try:
        cmp_ts = pd.to_datetime(str(comparison_value), format=comparison_format)
    except ValueError:
        if comparison_format != "%Y-%m-%d %H:%M:%S":
            raise
        cmp_ts = pd.to_datetime(str(comparison_value))
    ref = int(cmp_ts.timestamp())
    odf = idf
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        ref_t = torch.tensor(ref, dtype=torch.int32, device=col.data.device)
        flag = _COMPARISONS[comparison_type](col.data, ref_t)
        odf = _emit_flag(odf, c, flag, col.mask, output_mode, "_comparison")
    return odf


# ----------------------------------------------------------------------
# calendar boundaries and predicates
# ----------------------------------------------------------------------
def _boundary_ts(idf: Table, list_of_cols, which: str, period: str, postfix: str,
                 output_mode: str) -> Table:
    odf = idf
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        odf = _emit_ts(odf, c, dk.period_boundary(col.data, which, period), col.mask,
                       output_mode, postfix)
    return odf


def _boundary_flag(idf: Table, list_of_cols, which: str, period: str, postfix: str,
                   output_mode: str) -> Table:
    odf = idf
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        odf = _emit_flag(odf, c, dk.is_period_boundary(col.data, which, period), col.mask,
                         output_mode, postfix)
    return odf


def _civil_flag(idf: Table, list_of_cols, fn, postfix: str, output_mode: str) -> Table:
    """A flag computed from the calendar fields of each column."""
    odf = idf
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        odf = _emit_flag(odf, c, fn(dk.civil_from_epoch(col.data)), col.mask, output_mode, postfix)
    return odf


def start_of_month(idf, list_of_cols, output_mode="replace"):
    return _boundary_ts(idf, list_of_cols, "start", "month", "_monthStart", output_mode)


def is_monthStart(idf, list_of_cols, output_mode="append"):
    return _boundary_flag(idf, list_of_cols, "start", "month", "_ismonthStart", output_mode)


def end_of_month(idf, list_of_cols, output_mode="replace"):
    return _boundary_ts(idf, list_of_cols, "end", "month", "_monthEnd", output_mode)


def is_monthEnd(idf, list_of_cols, output_mode="append"):
    return _boundary_flag(idf, list_of_cols, "end", "month", "_ismonthEnd", output_mode)


def start_of_year(idf, list_of_cols, output_mode="replace"):
    return _boundary_ts(idf, list_of_cols, "start", "year", "_yearStart", output_mode)


def is_yearStart(idf, list_of_cols, output_mode="append"):
    return _boundary_flag(idf, list_of_cols, "start", "year", "_isyearStart", output_mode)


def end_of_year(idf, list_of_cols, output_mode="replace"):
    return _boundary_ts(idf, list_of_cols, "end", "year", "_yearEnd", output_mode)


def is_yearEnd(idf, list_of_cols, output_mode="append"):
    return _boundary_flag(idf, list_of_cols, "end", "year", "_isyearEnd", output_mode)


def start_of_quarter(idf, list_of_cols, output_mode="replace"):
    return _boundary_ts(idf, list_of_cols, "start", "quarter", "_quarterStart", output_mode)


def is_quarterStart(idf, list_of_cols, output_mode="append"):
    return _boundary_flag(idf, list_of_cols, "start", "quarter", "_isquarterStart", output_mode)


def end_of_quarter(idf, list_of_cols, output_mode="replace"):
    return _boundary_ts(idf, list_of_cols, "end", "quarter", "_quarterEnd", output_mode)


def is_quarterEnd(idf, list_of_cols, output_mode="append"):
    return _boundary_flag(idf, list_of_cols, "end", "quarter", "_isquarterEnd", output_mode)


def is_yearFirstHalf(idf, list_of_cols, output_mode="append"):
    return _civil_flag(idf, list_of_cols, lambda civ: civ["month"] <= 6, "_isFirstHalf", output_mode)


def is_selectedHour(idf, list_of_cols, start_hour: int = 0, end_hour: int = 23, output_mode="append"):
    """hour ∈ [start_hour, end_hour], wrapping past midnight when start >
    end."""
    lo, hi = int(start_hour), int(end_hour)

    def flag(civ):
        h = civ["hour"]
        return (h >= lo) & (h <= hi) if lo <= hi else (h >= lo) | (h <= hi)

    return _civil_flag(idf, list_of_cols, flag, "_isselectedHour", output_mode)


def is_leapYear(idf, list_of_cols, output_mode="append"):
    return _civil_flag(idf, list_of_cols, lambda civ: civ["leap"], "_isleapYear", output_mode)


def is_weekend(idf, list_of_cols, output_mode="append"):
    return _civil_flag(idf, list_of_cols, lambda civ: civ["dayofweek"] >= 5, "_isweekend", output_mode)


# ----------------------------------------------------------------------
# time-series aggregation
# ----------------------------------------------------------------------
_AGG_FUNCS = {"count", "min", "max", "sum", "mean", "median", "stddev"}

# strftime directive → bucket granularity rank (coarse → fine)
_GRAIN_RANK = {"Y": 0, "y": 0, "m": 1, "b": 1, "B": 1, "d": 2, "j": 2, "a": 2,
               "A": 2, "w": 2, "H": 3, "I": 3, "M": 4, "S": 5}
# the aggregator buckets on the device up to this many buckets a span
_MAX_DEVICE_SEGMENTS = 4_000_000


def _format_grain(fmt: str) -> Optional[str]:
    """Finest calendar field of a strftime format that is a prefix chain
    year[-month[-day[-hour...]]]; None for any other format (the host
    groupby)."""
    fields = re.findall(r"%(\w)", fmt)
    if not fields or any(f not in _GRAIN_RANK for f in fields):
        return None
    ranks = sorted({_GRAIN_RANK[f] for f in fields})
    if ranks != list(range(len(ranks))) or 0 not in ranks:
        return None
    return ["year", "month", "day", "hour", "minute", "second"][max(ranks)]


def _bucket_ids(secs: torch.Tensor, grain: str) -> torch.Tensor:
    c = dk.civil_from_epoch(secs)
    if grain == "year":
        return c["year"]
    if grain == "month":
        return c["year"] * 12 + (c["month"] - 1)
    if grain == "day":
        return c["days"]
    if grain == "hour":
        return c["days"] * 24 + c["hour"]
    if grain == "minute":
        return c["days"] * 1440 + torch.div(c["sod"], 60, rounding_mode="floor")
    return secs  # second grain


def _bucket_start_secs(ids: np.ndarray, grain: str) -> np.ndarray:
    """Host: bucket id → epoch seconds of the bucket's start (labels)."""
    ids = ids.astype("int64")
    if grain in ("year", "month"):
        y = ids if grain == "year" else ids // 12
        m = np.ones_like(ids) if grain == "year" else ids % 12 + 1
        dt = pd.to_datetime(pd.DataFrame({"year": y, "month": m, "day": 1}))
        return dt.astype("datetime64[ns]").astype("int64").to_numpy() // 10**9
    mult = {"day": 86400, "hour": 3600, "minute": 60, "second": 1}[grain]
    return ids * mult


def _bucket_ids_minmax(secs: torch.Tensor, mask: torch.Tensor, grain: str):
    """Bucket ids on the device and their masked span (lo, hi) as ints."""
    ids = _bucket_ids(secs, grain)
    lo, hi = _col_min_max(ids, mask)
    return ids, lo, hi


def _segment_aggregate(ids0: torch.Tensor, valid: torch.Tensor, V: torch.Tensor,
                       Mv: torch.Tensor, nseg: int):
    """Per-bucket count, sum, sum of squares, min, max and median of every
    value column, on the device.

    ids0: (rows,) bucket ids in [0, nseg); valid: (rows,) row validity;
    V, Mv: (rows, k) f32 values and their validity.  Returns host arrays
    of shape (k, nseg): count int64, sum and sum of squares float64, min,
    max and median f32 (the median of an even count is the f32 mean of the
    two middle values).  The median sorts each column by (bucket, value)
    with two stable sorts (value first, then bucket), the order of the JAX
    package's ``lexsort((v, s))``."""
    Vt, Mt = V.t(), Mv.t()
    k, rows = Vt.shape
    dev = Vt.device
    live = Mt & valid[None, :]
    s = torch.where(live, ids0.to(torch.int64)[None, :], nseg)  # (k, rows); dead rows → nseg
    flat = (s + torch.arange(k, device=dev)[:, None] * (nseg + 1)).reshape(-1)
    nflat = k * (nseg + 1)

    def per_bucket(vals, init, reduce=None):
        out = torch.full((nflat,), init, dtype=vals.dtype, device=dev)
        if reduce is None:
            out.index_add_(0, flat, vals.reshape(-1))
        else:
            out.scatter_reduce_(0, flat, vals.reshape(-1), reduce, include_self=True)
        return out.view(k, nseg + 1)[:, :nseg]

    v64 = torch.where(live, Vt.to(torch.float64), 0.0)
    cnt = per_bucket(live.to(torch.int64), 0)
    sm = per_bucket(v64, 0.0)
    sq = per_bucket(v64 * v64, 0.0)
    mn = per_bucket(torch.where(live, Vt, torch.inf), torch.inf, "amin")
    mx = per_bucket(torch.where(live, Vt, -torch.inf), -torch.inf, "amax")
    if rows:
        o1 = torch.sort(Vt, dim=1, stable=True).indices
        o2 = torch.sort(s.gather(1, o1), dim=1, stable=True).indices
        v_sorted = Vt.gather(1, o1.gather(1, o2))
        starts = torch.cumsum(cnt, dim=1) - cnt
        c_i = torch.clamp(cnt - 1, min=0)
        lo_i = torch.clamp(starts + torch.div(c_i, 2, rounding_mode="floor"), 0, rows - 1)
        hi_i = torch.clamp(starts + torch.div(c_i + 1, 2, rounding_mode="floor"), 0, rows - 1)
        med = (v_sorted.gather(1, lo_i) + v_sorted.gather(1, hi_i)) / 2
    else:
        med = torch.zeros((k, nseg), dtype=Vt.dtype, device=dev)
    return tuple(t.cpu().numpy() for t in (cnt, sm, sq, mn, mx, med))


def aggregator(idf: Table, list_of_cols, list_of_aggs, time_col: str,
               granularity_format: str = "%Y-%m-%d", **_ignored) -> pd.DataFrame:
    """groupBy over the formatted timestamp → an aggregated host frame.

    A year→second prefix format buckets on the device (calendar fields,
    then per-bucket reductions; only the per-bucket result reaches the
    host).  Any other format, or a span of more than 4,000,000 buckets,
    takes a host groupby."""
    cols = _cols(list_of_cols)
    aggs = _cols(list_of_aggs)
    bad = [a for a in aggs if a not in _AGG_FUNCS]
    if bad:
        raise TypeError(f"Invalid aggregate function(s): {bad}")
    tcol = _ts_col(idf, time_col)
    grain = _format_grain(granularity_format)
    if grain is None:
        warnings.warn(f"aggregator: non-standard granularity_format {granularity_format!r}; "
                      "falling back to host groupby")
        return _aggregator_host(idf, cols, aggs, time_col, granularity_format)
    ids, lo, hi = _bucket_ids_minmax(tcol.data, tcol.mask, grain)
    if lo > hi:  # all-null time column
        return pd.DataFrame(columns=[time_col] + [f"{c}_{a}" for c in cols for a in aggs])
    nseg = hi - lo + 1
    if nseg > _MAX_DEVICE_SEGMENTS:  # e.g. seconds over decades
        return _aggregator_host(idf, cols, aggs, time_col, granularity_format)
    V, Mv = idf.numeric_block(cols)
    agg = _segment_aggregate(ids - lo, tcol.mask, V, Mv, nseg)
    return format_segment_aggregate(agg, cols, aggs, time_col, granularity_format, lo, grain)


def format_segment_aggregate(agg, cols, aggs, time_col, granularity_format,
                             lo: int, grain: str) -> pd.DataFrame:
    """Host frame from one grain's (cnt, sm, sq, mn, mx, med) aggregate:
    buckets with any valid value, labelled by their start.  Count is int64;
    sum, mean and stddev are taken in float64 and rounded to f32."""
    cnt, sm, sq, mn, mx, med = agg
    idx = np.nonzero(cnt.max(axis=0) > 0)[0]
    keys = pd.Series(_bucket_start_secs(idx + lo, grain).astype("datetime64[s]")
                     ).dt.strftime(granularity_format)
    out = {time_col: keys.to_numpy()}
    f32 = np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        for j, c in enumerate(cols):
            n = cnt[j][idx]
            for a in aggs:
                if a == "count":
                    vals = n
                elif a == "sum":
                    vals = sm[j][idx].astype(f32)
                elif a == "mean":
                    vals = np.where(n > 0, sm[j][idx] / np.maximum(n, 1), np.nan).astype(f32)
                elif a == "min":
                    vals = np.where(n > 0, mn[j][idx], f32(np.nan))
                elif a == "max":
                    vals = np.where(n > 0, mx[j][idx], f32(np.nan))
                elif a == "median":
                    vals = np.where(n > 0, med[j][idx], f32(np.nan))
                else:  # stddev (sample)
                    var = (sq[j][idx] - sm[j][idx] ** 2 / np.maximum(n, 1)) / np.maximum(n - 1, 1)
                    vals = np.where(n > 1, np.sqrt(np.maximum(var, 0)), np.nan).astype(f32)
                out[f"{c}_{a}"] = vals
    return pd.DataFrame(out)


def _aggregator_host(idf: Table, cols, aggs, time_col, granularity_format) -> pd.DataFrame:
    s = _ts_series(idf, time_col)
    data = {time_col: s.dt.strftime(granularity_format)}
    for c in cols:
        data[c] = _host_values(idf, c)
    df = pd.DataFrame(data)
    pa = [a if a != "stddev" else "std" for a in aggs]
    out = df.groupby(time_col)[cols].agg(pa)
    out.columns = [f"{c}_{a if a != 'std' else 'stddev'}" for c, a in out.columns]
    return out.reset_index()


def _sort_order(key: torch.Tensor, pcode: Optional[torch.Tensor]) -> torch.Tensor:
    """Row order by (partition, key), ties in row order: a stable sort on
    the key, then a stable sort on the partition codes."""
    order = torch.sort(key, stable=True).indices
    if pcode is not None:
        order = order[torch.sort(pcode[order], stable=True).indices]
    return order


def _orderable(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) ordered as the f32 values ``x`` are."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b) + (1 << 31)


def _segmented_cumextreme(x: torch.Tensor, seg_id: torch.Tensor, largest: bool) -> torch.Tensor:
    """Running min (or max) of f32 ``x`` that restarts where ``seg_id``
    (non-decreasing) steps: one cummin/cummax over int64 keys whose high
    bits rank the segment so that no earlier segment can win."""
    if largest:
        key = (seg_id << 32) | _orderable(x)
        out = torch.cummax(key, dim=0).values
    else:
        key = ((seg_id.max() - seg_id) << 32) | _orderable(x)
        out = torch.cummin(key, dim=0).values
    b = (out & 0xFFFFFFFF) - (1 << 31)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return b.to(torch.int32).view(torch.float32)


def _window_values(osecs, omask, v, mv, agg: str, window_type: str, w: int, pcode=None):
    """One window aggregate of every row, in row order: (f32 values, ok).

    Rows sort by (partition, ts), nulls of the order column last; pandas
    min_periods semantics (a rolling window needs w valid values, an
    expanding one needs one; count gates on the window's row coverage).
    Counts and cumulative sums are int64 and float64, so a window sum
    taken as a difference of cumulative sums keeps its digits."""
    rows = v.shape[0]
    dev = v.device
    order = _sort_order(torch.where(omask, osecs, _I32_BIG), pcode)
    idx = torch.arange(rows, device=dev)
    if pcode is not None:
        po = pcode[order]
        newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), po[1:] != po[:-1]])
    else:
        newseg = idx == 0
    seg_start = torch.cummax(torch.where(newseg, idx, 0), dim=0).values
    vo, mo = v[order], mv[order]
    v64 = torch.where(mo, vo.to(torch.float64), 0.0)
    cnt = torch.cumsum(mo.to(torch.int64), 0)
    cs = torch.cumsum(v64, 0)
    cq = torch.cumsum(v64 * v64, 0)

    def before(c, at):
        """c[at - 1], 0 where at == 0."""
        return torch.cat([torch.zeros(1, dtype=c.dtype, device=dev), c])[at]

    in_seg = idx - seg_start + 1  # rows of the segment up to here
    res = None
    if window_type == "expanding":
        n, s, q = (c - before(c, seg_start) for c in (cnt, cs, cq))
        ok = n >= 1
        if agg in ("min", "max"):
            seg_id = torch.cumsum(newseg.to(torch.int64), 0)
            fill = -torch.inf if agg == "max" else torch.inf
            res = _segmented_cumextreme(torch.where(mo, vo, fill), seg_id, agg == "max")
    else:  # rolling, min_periods = w
        start = torch.where(in_seg >= w, idx - w + 1, seg_start)
        n, s, q = (c - before(c, start) for c in (cnt, cs, cq))
        ok = (n >= w) & (in_seg >= w)
        if agg in ("min", "max", "median"):
            pos = idx[:, None] - (w - 1) + torch.arange(w, device=dev)[None, :]
            safe = torch.clamp(pos, 0, max(rows - 1, 0))
            Wm = (pos >= 0) & mo[safe] & (pos >= seg_start[:, None])
            Wv = vo[safe]
            if agg == "min":
                res = torch.where(Wm, Wv, torch.inf).min(dim=1).values
            elif agg == "max":
                res = torch.where(Wm, Wv, -torch.inf).max(dim=1).values
            else:
                Ws = torch.sort(torch.where(Wm, Wv, torch.inf), dim=1).values
                res = (Ws[:, (w - 1) // 2] + Ws[:, w // 2]) / 2
    if agg == "count":
        res = n.to(torch.float32)
        ok = in_seg >= w if window_type == "rolling" else torch.ones_like(ok)
    elif agg == "sum":
        res = s.to(torch.float32)
    elif agg == "mean":
        res = (s / torch.clamp(n, min=1)).to(torch.float32)
    elif agg == "stddev":
        var = (q - s * s / torch.clamp(n, min=1)) / torch.clamp(n - 1, min=1)
        res = torch.sqrt(torch.clamp(var, min=0.0)).to(torch.float32)
        ok = ok & (n >= 2)
    out = torch.empty_like(res)
    out[order] = res
    okb = torch.empty_like(ok)
    okb[order] = ok
    return torch.where(okb, out, 0.0), okb


def window_aggregator(
    idf: Table,
    list_of_cols,
    list_of_aggs,
    order_col: str,
    window_type: str = "expanding",
    window_size: int = 3,
    partition_col: str = "",
    output_mode: str = "append",
    **_ignored,
) -> Table:
    """Expanding or rolling window aggregates ordered by a ts column, on
    the device (pandas min_periods semantics: a rolling window needs a full
    window of valid values, an expanding one needs one).  ``partition_col``
    restarts every window at its group's boundary.  The expanding median
    runs on the host, as in the JAX package."""
    argument_checker("window_aggregator", {"output_mode": output_mode})
    ocol = _ts_col(idf, order_col)
    aggs = _cols(list_of_aggs)
    w = int(window_size)
    pcode = None
    if partition_col:
        pc = idf.columns[partition_col]
        if pc.kind != "cat":
            raise TypeError("partition_col must be a categorical column")
        pcode = pc.data
    odf = idf
    for c in _cols(list_of_cols):
        col = idf.columns[c]
        for a in aggs:
            if a not in _AGG_FUNCS:
                raise TypeError(f"Invalid aggregate function {a}")
            if a == "median" and window_type == "expanding":
                vals_h, ok_h = _expanding_median_host(idf, c, order_col, partition_col)
                v = vals_h.astype(np.float64)
                v[~ok_h] = np.nan
                odf = odf.with_column(f"{c}_{a}_{window_type}",
                                      host_to_column(v, idf.nrows, idf.device))
                continue
            vals, ok = _window_values(ocol.data, ocol.mask, col.data.to(torch.float32), col.mask,
                                      a, window_type, w, pcode)
            odf = _emit_num(odf, f"{c}_{a}_{window_type}", vals, ok, "append", "")
        if output_mode == "replace":
            odf = odf.drop([c])
    return odf


def _expanding_median_host(idf: Table, c: str, order_col: str, partition_col: str = ""):
    s = _ts_series(idf, order_col)
    vals = _host_values(idf, c)
    back = np.empty(idf.nrows)
    if partition_col:
        codes = idf.columns[partition_col].data.cpu().numpy()
        order = np.lexsort((s.to_numpy(), codes))
        res = pd.Series(vals[order]).groupby(codes[order]).expanding().median().to_numpy()
    else:
        order = np.argsort(s.to_numpy(), kind="stable")
        res = pd.Series(vals[order]).expanding().median().to_numpy()
    back[order] = res
    return back, ~np.isnan(back)


def lagged_ts(
    idf: Table,
    list_of_cols,
    lag: int = 1,
    output_type: str = "ts",
    tsdiff_unit: str = "days",
    order_col: str = "",
    partition_col: str = "",
    output_mode: str = "append",
    **_ignored,
) -> Table:
    """Lag a ts column, ordered by itself or ``order_col``, and optionally
    its difference to the lag (``output_type="ts_diff"``): a sort, a shift
    and the inverse permutation on the device.  ``partition_col`` lags
    within each group only."""
    argument_checker("lagged_ts", {"output_mode": output_mode})
    odf = idf
    lag = int(lag)
    pcode = None
    if partition_col:
        pc = idf.columns[partition_col]
        if pc.kind != "cat":
            raise TypeError("partition_col must be a categorical column")
        pcode = pc.data
    for c in _cols(list_of_cols):
        col = _ts_col(idf, c)
        kcol = _ts_col(idf, order_col) if order_col else col
        lag_secs, lag_ok = _lag_values(col.data, col.mask, kcol.data, kcol.mask, lag, pcode)
        name = f"{c}_lag{lag}"
        if output_type == "ts":
            odf = odf.with_column(name, Column("ts", lag_secs, lag_ok, dtype_name="timestamp"))
        else:  # ts_diff
            diff = (col.data - lag_secs).to(torch.float32) / float(_div_for(tsdiff_unit))
            odf = _emit_num(odf, name + "_diff", diff, col.mask & lag_ok, "append", "")
        if output_mode == "replace":
            odf = odf.drop([c])
    return odf


def _lag_values(secs, mask, ksecs, kmask, lag: int, pcode=None):
    """Each row's value ``lag`` places earlier in (partition, key) order
    (nulls of the key last): (int32 seconds, ok)."""
    rows = secs.shape[0]
    order = _sort_order(torch.where(kmask, ksecs, _I32_BIG), pcode)
    so, mo = secs[order], mask[order]
    shift_s = torch.cat([torch.zeros(lag, dtype=so.dtype, device=so.device), so])[:rows]
    shift_m = torch.cat([torch.zeros(lag, dtype=torch.bool, device=so.device), mo])[:rows]
    if pcode is not None:
        po = pcode[order]
        shift_p = torch.cat([torch.full((lag,), -1, dtype=po.dtype, device=po.device), po])[:rows]
        shift_m = shift_m & (shift_p == po)
    out_s, out_m = torch.empty_like(shift_s), torch.empty_like(shift_m)
    out_s[order] = shift_s
    out_m[order] = shift_m
    return out_s, out_m
