"""Time-series inspection (counterpart of ``anovos_tpu/data_analyzer/
ts_analyzer.py``), with the same output files.

For each ts column: eligibility (span, distinct days, null share), then for
an eligible one the visualization data at three grains (daily buckets,
dayparts, weekdays) of every numeric column, the daily top-10 + Others
counts of the categorical columns, the daily/hourly/weekly/daypart record
counts, a seasonal decomposition and ADF/KPSS stationarity of the daily
count series, and a landscape summary row.

The JAX package pulls every row to host pandas for the calendar counts;
here they are calendar fields and bincounts on the device, and only the
per-day, per-hour and per-weekday counts (at most the span's days of rows)
reach the host, where the dates are formatted.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_transformer.datetime import (
    _col_min_max, _segment_aggregate, format_segment_aggregate,
)
from anovos_tpu_torch.ops import datetime_kernels as dk
from anovos_tpu_torch.ops.segment import code_histograms
from anovos_tpu_torch.shared.table import Table
from anovos_tpu_torch.shared.utils import ends_with

# the ts_stats.csv schema, shared by eligibility rows and the empty case
TS_STATS_COLUMNS = [
    "attribute", "eligible", "reason", "span_days", "distinct_days",
    "null_pct", "min_ts", "max_ts",
]

# daypart of each hour 0..23: late 0-5, early 6-9, work 10-16, evening
# 17-20, night 21-23
_DAYPART_LUT = np.array([0] * 6 + [1] * 4 + [2] * 7 + [3] * 4 + [4] * 3, np.int64)
_DAYPART_NAMES = ["late_hours", "early_hours", "work_hours", "evening_hours", "night_hours"]
_DOW_NAMES = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
_TS_NUM_AGGS = ["count", "min", "max", "mean", "median"]


@dataclasses.dataclass
class _Calendar:
    """The calendar counts of one ts column's valid rows (host values)."""
    records: int
    has_null: bool  # some row of the column is null
    lo: int  # min and max epoch seconds
    hi: int
    day_lo: int  # epoch day of ``lo``
    day_counts: np.ndarray  # rows a day, days day_lo .. day of hi
    hour_counts: np.ndarray  # (24,)
    dow_counts: np.ndarray  # (7,), Mon = 0

    def span_strings(self):
        """The first and last timestamps as pandas prints them."""
        return tuple(str(pd.Timestamp(np.datetime64(s, "s"))) for s in (self.lo, self.hi))

    def days_present(self):
        """(epoch days with rows, their counts)."""
        idx = np.nonzero(self.day_counts)[0]
        return idx + self.day_lo, self.day_counts[idx]

    def keyed(self, counts: np.ndarray) -> np.ndarray:
        """Hour or weekday keys with rows, typed as pandas types them on a
        column with nulls (float64) or without (int32)."""
        return np.nonzero(counts)[0].astype(np.float64 if self.has_null else np.int32)

    def daypart_counts(self) -> np.ndarray:
        return np.bincount(_DAYPART_LUT, weights=self.hour_counts, minlength=5).astype(np.int64)


def _day_strings(days: np.ndarray) -> np.ndarray:
    """Epoch days → "%Y-%m-%d" strings (four-digit years in the int32
    epoch range)."""
    return np.asarray(days, np.int64).astype("datetime64[D]").astype(str).astype(object)


def _calendar(idf: Table, col: str) -> Optional[_Calendar]:
    """Calendar fields and bincounts on the device, one transfer of the
    counts; None when the column is all null."""
    c = idf.columns[col]
    lo, hi = _col_min_max(c.data, c.mask)
    if lo > hi:
        return None
    civ = dk.civil_from_epoch(c.data)
    m = c.mask
    day_lo, day_hi = lo // dk.SECS_PER_DAY, hi // dk.SECS_PER_DAY
    ndays = day_hi - day_lo + 1
    counts = torch.cat([
        torch.bincount((civ["days"][m] - day_lo).long(), minlength=ndays),
        torch.bincount(civ["hour"][m].long(), minlength=24),
        torch.bincount(civ["dayofweek"][m].long(), minlength=7),
        (~m).sum().reshape(1),
    ]).cpu().numpy()
    return _Calendar(records=int(counts[:ndays].sum()), has_null=bool(counts[-1] > 0), lo=lo,
                     hi=hi, day_lo=day_lo, day_counts=counts[:ndays],
                     hour_counts=counts[ndays:ndays + 24], dow_counts=counts[ndays + 24:ndays + 31])


def _eligibility(col: str, cal: Optional[_Calendar], nrows: int, max_days: int) -> dict:
    if cal is None:
        return {"attribute": col, "eligible": 0, "reason": "all null"}
    span_days = (cal.hi - cal.lo) // dk.SECS_PER_DAY
    distinct_days = int(np.count_nonzero(cal.day_counts))
    return {
        "attribute": col,
        "eligible": int(0 < span_days <= max_days and distinct_days > 1),
        "span_days": span_days,
        "distinct_days": distinct_days,
        "null_pct": round(1 - cal.records / max(nrows, 1), 4),
        "min_ts": cal.span_strings()[0],
        "max_ts": cal.span_strings()[1],
    }


def _ts_series(idf: Table, col: str) -> pd.Series:
    """The ts column on the host as datetime64[s], NaT where null."""
    c = idf.columns[col]
    secs = c.data[: idf.nrows].cpu().numpy().astype("int64")
    ts = pd.Series(secs.astype("datetime64[s]"))
    ts[~c.mask[: idf.nrows].cpu().numpy()] = pd.NaT
    return ts


def daypart_cat(hour: pd.Series) -> pd.Series:
    """The daypart label of each hour (late_hours 0-5, early_hours 6-9,
    work_hours 10-16, evening_hours 17-20, night_hours 21-23); a null hour
    stays null."""
    bins = pd.cut(hour, bins=[-1, 5, 9, 16, 20, 23], labels=_DAYPART_NAMES)
    return bins.astype(str)


def ts_processed_feats(idf: Table, col: str) -> pd.DataFrame:
    """Per-row calendar features of one ts column on the host: the ts,
    date, hour, dayofweek, is_weekend, daypart, month and ``yyyymmdd_col``
    ("%Y-%m-%d", NaN where the ts is null)."""
    ts = _ts_series(idf, col)
    out = pd.DataFrame({col: ts})
    out["date"] = ts.dt.date
    out["hour"] = ts.dt.hour
    out["dayofweek"] = ts.dt.dayofweek
    out["is_weekend"] = ts.dt.dayofweek >= 5
    out["daypart"] = daypart_cat(ts.dt.hour)
    out["month"] = ts.dt.month
    ymd = ts.to_numpy().astype("datetime64[D]").astype(str).astype(object)
    ymd[pd.isna(ts).to_numpy()] = np.nan
    out["yyyymmdd_col"] = ymd
    return out


def ts_eligiblity_check(idf: Table, col: str, id_col: Optional[str] = None, max_days: int = 3600) -> dict:
    """Eligibility stats: span, distinct days, null share."""
    return _eligibility(col, _calendar(idf, col), idf.nrows, max_days)


def _grain_ids(tdata: torch.Tensor, grain: str) -> torch.Tensor:
    """Daypart ids (``"hourly"``) or weekday ids, Mon = 0."""
    civ = dk.civil_from_epoch(tdata)
    if grain == "hourly":
        return torch.from_numpy(_DAYPART_LUT).to(tdata.device)[civ["hour"].long()]
    return civ["dayofweek"]


def _small_grain_frame(agg, num_cols: List[str], labels: List[str]) -> pd.DataFrame:
    """Host frame from one small grain's (cnt, sm, sq, mn, mx, med)."""
    cnt, sm, _, mn, mx, med = agg
    rows = []
    for j, c in enumerate(num_cols):
        for b, lbl in enumerate(labels):
            if cnt[j][b] > 0:
                rows.append({
                    "bucket": lbl, "attribute": c, "count": int(cnt[j][b]),
                    "min": round(float(mn[j][b]), 4), "max": round(float(mx[j][b]), 4),
                    "mean": round(float(sm[j][b] / cnt[j][b]), 4),
                    "median": round(float(med[j][b]), 4),
                })
    return pd.DataFrame(rows, columns=["bucket", "attribute", "count", "min", "max", "mean", "median"])


def _ts_num_viz_all(idf: Table, ts_col: str, num_cols: List[str], cal: _Calendar):
    """(daily frame, daypart frame, weekday frame) of the numeric columns:
    three per-bucket aggregates on the device."""
    tcol = idf.columns[ts_col]
    V, Mv = idf.numeric_block(num_cols)
    days = dk.civil_from_epoch(tcol.data)["days"]
    agg_d = _segment_aggregate(days - cal.day_lo, tcol.mask, V, Mv, len(cal.day_counts))
    agg_h = _segment_aggregate(_grain_ids(tcol.data, "hourly"), tcol.mask, V, Mv, len(_DAYPART_NAMES))
    agg_w = _segment_aggregate(_grain_ids(tcol.data, "weekly"), tcol.mask, V, Mv, len(_DOW_NAMES))
    dv = format_segment_aggregate(agg_d, num_cols, _TS_NUM_AGGS, ts_col, "%Y-%m-%d", cal.day_lo, "day")
    return (dv, _small_grain_frame(agg_h, num_cols, _DAYPART_NAMES),
            _small_grain_frame(agg_w, num_cols, _DOW_NAMES))


def _cat_viz(idf: Table, ts_col: str, cat_cols: List[str], n_cat: int = 10) -> pd.DataFrame:
    """Top-``n_cat`` + Others category counts a day of each categorical
    column: code counts (all rows of the column), the top codes on the host,
    then one bincount of (column, day, top code or Others) on the device."""
    tcol = idf.columns[ts_col]
    days = dk.civil_from_epoch(tcol.data)["days"]
    lo, hi = _col_min_max(days, tcol.mask)
    if lo > hi or not cat_cols:
        return pd.DataFrame(columns=["date", "attribute", "category", "count"])
    ndays, k, ncat = hi - lo + 1, len(cat_cols), n_cat + 1
    nv = max(max(len(idf.columns[c].vocab) for c in cat_cols), 1)
    C = torch.stack([idf.columns[c].data for c in cat_cols], dim=1)
    Mc = torch.stack([idf.columns[c].mask for c in cat_cols], dim=1)
    # f32 counts: the top codes are np.argsort of the same f32 array as the
    # JAX package's, so ties fall alike
    cnts = code_histograms(C, Mc, nv).cpu().numpy()
    lut = np.full((k, nv), n_cat, np.int64)  # → Others
    tops = []
    for j, c in enumerate(cat_cols):
        top = np.argsort(-cnts[j, :len(idf.columns[c].vocab)])[:n_cat]
        lut[j, top] = np.arange(len(top))
        tops.append(top)
    Ct = C.t().long()
    valid = Mc.t() & (Ct >= 0) & tcol.mask[None, :]
    cb = torch.from_numpy(lut).to(C.device).gather(1, torch.clamp(Ct, 0, nv - 1))
    base = torch.arange(k, device=C.device)[:, None] * (ndays * ncat)
    seg = base + (days - lo).long()[None, :] * ncat + cb
    combo = torch.bincount(seg[valid], minlength=k * ndays * ncat)
    combo = combo.cpu().numpy().reshape(k, ndays, ncat)
    frames = []
    for j, c in enumerate(cat_cols):
        labels = np.array([str(idf.columns[c].vocab[t]) for t in tops[j]] + ["Others"], dtype=object)
        day_idx, cat_idx = np.nonzero(combo[j])
        frames.append(pd.DataFrame({"date": _day_strings(day_idx + lo), "attribute": c,
                                    "category": labels[cat_idx],
                                    "count": combo[j][day_idx, cat_idx].astype(np.int64)}))
    return pd.concat(frames, ignore_index=True)[["date", "attribute", "category", "count"]]


def ts_viz_data(idf: Table, col: str, output_path: str, output_type: str = "daily",
                _cal: Optional[_Calendar] = None) -> None:
    """Visualization data of one ts column: daily/daypart/weekday
    aggregates of the first 20 numeric columns, top-10 + Others daily
    counts of the first 10 categorical columns, record counts a day, hour,
    weekday and daypart, and the daily count series' decomposition and
    stationarity."""
    out = ends_with(output_path)
    num_all, cat_all, _ = idf.attribute_type_segregation()
    num_cols, cat_cols = num_all[:20], cat_all[:10]
    cal = _cal if _cal is not None else _calendar(idf, col)
    if cal is None:
        return
    day_ids, day_n = cal.days_present()
    daily = pd.DataFrame({"yyyymmdd_col": _day_strings(day_ids), "count": day_n})
    daily.to_csv(out + f"ts_daily_{col}.csv", index=False)

    if num_cols:
        dv, hourly_df, weekly_df = _ts_num_viz_all(idf, col, num_cols, cal)
        long_rows = []
        for c in num_cols:
            sub = pd.DataFrame({
                "date": dv[col], "attribute": c, "count": dv[f"{c}_count"],
                "min": dv[f"{c}_min"].round(4), "max": dv[f"{c}_max"].round(4),
                "mean": dv[f"{c}_mean"].round(4), "median": dv[f"{c}_median"].round(4),
            })
            long_rows.append(sub[sub["count"] > 0])
        pd.concat(long_rows, ignore_index=True).to_csv(out + f"ts_num_daily_{col}.csv", index=False)
        hourly_df.to_csv(out + f"ts_num_hourly_{col}.csv", index=False)
        weekly_df.to_csv(out + f"ts_num_weekly_{col}.csv", index=False)
    if cat_cols:
        _cat_viz(idf, col, cat_cols).to_csv(out + f"ts_cat_daily_{col}.csv", index=False)

    dec = seasonal_decompose_ma(daily["count"].to_numpy(), period=7)
    if dec is not None:
        trend, seas, resid = dec
        pd.DataFrame({
            "date": daily["yyyymmdd_col"], "observed": daily["count"],
            "trend": np.round(trend, 4), "seasonal": np.round(seas, 4),
            "residual": np.round(resid, 4),
        }).to_csv(out + f"ts_decompose_{col}.csv", index=False)
    adf = adf_test(daily["count"].to_numpy())
    kpss = kpss_test(daily["count"].to_numpy())
    if adf is not None or kpss is not None:
        pd.DataFrame([{"attribute": col, **(adf or {}), **(kpss or {})}]).to_csv(
            out + f"ts_stationarity_{col}.csv", index=False)
    for name, key, keys, counts in (
        ("hourly", "hour", cal.keyed(cal.hour_counts), cal.hour_counts),
        ("weekly", "dayofweek", cal.keyed(cal.dow_counts), cal.dow_counts),
    ):
        pd.DataFrame({key: keys, "count": counts[np.nonzero(counts)[0]]}).to_csv(
            out + f"ts_{name}_{col}.csv", index=False)
    dp = cal.daypart_counts()
    order = sorted((n, i) for i, n in enumerate(_DAYPART_NAMES) if dp[i] > 0)
    pd.DataFrame({"daypart": [n for n, _ in order], "count": [dp[i] for _, i in order]}).to_csv(
        out + f"ts_daypart_{col}.csv", index=False)


def seasonal_decompose_ma(series: np.ndarray, period: int = 7):
    """Additive moving-average decomposition (statsmodels'
    seasonal_decompose recipe): centred-MA trend, mean-by-phase seasonal,
    residual."""
    y = np.asarray(series, float)
    n = len(y)
    if n < 2 * period:
        return None
    kernel = np.ones(period) / period
    if period % 2 == 0:  # centred MA for even periods
        kernel = np.concatenate([[0.5], np.ones(period - 1), [0.5]]) / period
    trend = np.convolve(y, kernel, mode="same")
    half = len(kernel) // 2
    trend[:half] = np.nan
    trend[n - half:] = np.nan
    detr = y - trend
    seasonal = np.array([np.nanmean(detr[p::period]) for p in range(period)])
    seasonal = seasonal - np.nanmean(seasonal)
    seas_full = np.tile(seasonal, n // period + 1)[:n]
    resid = y - trend - seas_full
    return trend, seas_full, resid


def adf_test(series: np.ndarray, max_lag: int = None):
    """Augmented Dickey-Fuller t-statistic (constant-only regression) with
    MacKinnon critical values (statsmodels' adfuller recipe)."""
    y = np.asarray(series, float)
    y = y[~np.isnan(y)]
    n = len(y)
    if n < 10:
        return None
    if np.allclose(y, y[0]):
        # constant series: the regressors are collinear (statsmodels
        # raises); report stationary
        return {"adf_stat": float("-inf"), "stationary_1%": 1, "stationary_5%": 1, "stationary_10%": 1}
    if max_lag is None:
        max_lag = min(int(np.ceil(12 * (n / 100) ** 0.25)), n // 2 - 2)
    dy = np.diff(y)
    best = None
    lag = max_lag
    while lag >= 0:
        rows = len(dy) - lag
        if rows < 5 + lag:
            lag -= 1
            continue
        Xcols = [y[lag: lag + rows], np.ones(rows)]
        for i in range(1, lag + 1):
            Xcols.append(dy[lag - i: lag - i + rows])
        Xm = np.column_stack(Xcols)
        target = dy[lag: lag + rows]
        beta, res, rank, _ = np.linalg.lstsq(Xm, target, rcond=None)
        resid = target - Xm @ beta
        dof = rows - Xm.shape[1]
        if dof <= 0:
            lag -= 1
            continue
        sigma2 = resid @ resid / dof
        cov = sigma2 * np.linalg.pinv(Xm.T @ Xm)
        se = np.sqrt(max(cov[0, 0], 1e-300))
        best = float(beta[0] / se)
        break
    if best is None:
        return None
    crit = {"1%": -3.43, "5%": -2.86, "10%": -2.57}
    return {"adf_stat": round(best, 4), **{f"stationary_{k}": int(best < v) for k, v in crit.items()}}


def kpss_test(series: np.ndarray, regression: str = "c"):
    """KPSS level-stationarity statistic with a Bartlett-window long-run
    variance (statsmodels' kpss recipe).  Null hypothesis: stationary."""
    y = np.asarray(series, float)
    y = y[~np.isnan(y)]
    n = len(y)
    if n < 10 or np.allclose(y, y[0]):
        return None
    resid = y - y.mean()
    S = np.cumsum(resid)
    lags = int(np.ceil(12.0 * (n / 100.0) ** 0.25))  # statsmodels 'legacy'
    lags = min(lags, n - 1)
    s2 = float(resid @ resid) / n
    for k in range(1, lags + 1):
        w = 1.0 - k / (lags + 1.0)
        s2 += 2.0 / n * w * float(resid[k:] @ resid[:-k])
    if s2 <= 0:
        return None
    stat = float((S @ S) / (n * n * s2))
    crit = {"1%": 0.739, "5%": 0.463, "10%": 0.347}
    # KPSS rejects stationarity when the statistic exceeds the critical value
    return {"kpss_stat": round(stat, 4), **{f"kpss_stationary_{k}": int(stat < v) for k, v in crit.items()}}


def _landscape_row(c: str, cal: _Calendar) -> dict:
    _, day_n = cal.days_present()
    dp = cal.daypart_counts()
    top = min(_DAYPART_NAMES[i] for i in range(5) if dp[i] == dp.max())  # mode, ties by name
    return {
        "attribute": c,
        "records": cal.records,
        "distinct_days": int(len(day_n)),
        "avg_records_per_day": round(float(cal.records / len(day_n)), 2),
        "max_records_per_day": int(day_n.max()),
        "weekend_pct": round(float(int(cal.dow_counts[5:].sum()) / cal.records), 4),
        "top_daypart": top,
        "start": cal.span_strings()[0],
        "end": cal.span_strings()[1],
    }


def ts_landscape(idf: Table, ts_cols: List[str], id_col: Optional[str], output_path: str,
                 _cal_map: Optional[dict] = None) -> None:
    """One summary row a ts column: records, distinct days, records a day,
    weekend share, top daypart, span."""
    rows = []
    for c in ts_cols:
        cal = _cal_map[c] if _cal_map and c in _cal_map else _calendar(idf, c)
        if cal is not None:
            rows.append(_landscape_row(c, cal))
    if rows:
        pd.DataFrame(rows).to_csv(ends_with(output_path) + "ts_landscape.csv", index=False)


def ts_analyzer(
    idf: Table,
    id_col: Optional[str] = None,
    max_days: int = 3600,
    output_path: str = ".",
    output_type: str = "daily",
    tz_offset: str = "local",
    run_type: str = "local",
    auth_key: str = "NA",
    **_ignored,
) -> None:
    """Eligibility and visualization data of every ts column, and
    ``ts_stats.csv``."""
    Path(output_path).mkdir(parents=True, exist_ok=True)
    ts_cols = [c for c in idf.col_names if idf.columns[c].kind == "ts"]
    rows, cals = [], {}
    for c in ts_cols:
        cal = _calendar(idf, c)
        stats = _eligibility(c, cal, idf.nrows, max_days)
        rows.append(stats)
        if stats.get("eligible"):
            cals[c] = cal
            ts_viz_data(idf, c, output_path, output_type, _cal=cal)
    if cals:
        ts_landscape(idf, list(cals), id_col, output_path, _cal_map=cals)
    # always the same headered schema, also with no ts column
    pd.DataFrame(rows).reindex(columns=TS_STATS_COLUMNS).to_csv(
        ends_with(output_path) + "ts_stats.csv", index=False)
