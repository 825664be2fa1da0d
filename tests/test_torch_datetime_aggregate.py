"""The port's time-series aggregation against the JAX package's and a
float64 pandas reference: ``aggregator`` at every grain of a year→second
format and at a format that takes the host groupby, ``window_aggregator``
(expanding and rolling, every aggregate, with and without a partition) and
``lagged_ts`` (ts and ts_diff, with and without ``order_col`` and
``partition_col``).

Counts, min, max and median are equal.  The port sums in float64 and
rounds to f32, so sums, means and standard deviations are held to the
float64 reference within 1e-6 (1e-5 for a standard deviation) relative.
The JAX package sums in f32 (bucket sums of the aggregator, and window
sums as differences of f32 running sums), so against it the band is what
its f32 sums can lose: the recursive summation bound γ_N·Σ|v| of each sum
(``_bucket_band``, ``_window_band``), plus 1e-5 relative."""

import warnings

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401

ROWS = 3000
AGGS = ["count", "min", "max", "sum", "mean", "median", "stddev"]
GRAINS = [("%Y", "ts"), ("%Y-%m", "ts"), ("%Y-%m-%d", "ts"), ("%Y-%m-%d %H", "ts"),
          ("%Y-%m-%d %H:%M", "ts_short"), ("%Y-%m-%d %H:%M:%S", "ts_short"),
          ("%d", "ts"), ("%H:%M", "ts_short")]


def agg_frame(n=ROWS, seed=41):
    """Two ts columns (three years; ten hours) with ties and nulls, values
    with nulls, a partition column with nulls."""
    g = np.random.default_rng(seed)
    ts = (np.datetime64("1968-11-05T00:00:00", "s")
          + g.integers(0, 3 * 365 * 86400, n).astype("timedelta64[s]"))
    ts[g.random(n) < 0.03] = np.datetime64("NaT")
    ts[5:25] = ts[4]  # ties keep row order
    short = np.datetime64("2020-02-29T18:00:00", "s") + g.integers(0, 36000, n).astype("timedelta64[s]")
    v = g.normal(5, 2, n).astype(np.float32).astype(np.float64)
    v[g.random(n) < 0.05] = np.nan
    w = np.round(g.gamma(2, 3, n), 2)
    w[g.random(n) < 0.02] = np.nan
    part = g.choice(np.array(["a", "b", "c", None], dtype=object), n, p=[0.4, 0.3, 0.28, 0.02])
    return pd.DataFrame({"ts": ts, "ts_short": short, "v": v, "w": w, "part": part})


@pytest.fixture(scope="module")
def tables():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = agg_frame()
    return df, Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)


U = 2.0 ** -24


def _gamma(n):
    return n * U / (1 - n * U)


def _bucket_band(vals, key, keys, agg):
    """|port − JAX| bound of a bucket's sum, mean or standard deviation:
    the JAX package sums a bucket's n values in f32, off by at most
    γ_n·Σ|v| (its squares by (γ_n + 2u)·Σv²); a variance moves by those
    through sq − sm²/n over n − 1, a standard deviation by the smaller of
    the variance's bound over σ and its square root."""
    by = lambda x: x.groupby(key).sum().reindex(keys).to_numpy(np.float64)  # noqa: E731
    n, sa, sq = by(vals.notna()), by(vals.abs()), by(vals * vals)
    if agg == "sum":
        return _gamma(n) * sa
    if agg == "mean":
        return _gamma(n) * sa / np.maximum(n, 1)
    mean = sa / np.maximum(n, 1)
    dvar = ((_gamma(n) + 2 * U) * sq + 2 * mean * _gamma(n) * sa) / np.maximum(n - 1, 1)
    sd = vals.groupby(key).std().reindex(keys).to_numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.minimum(np.sqrt(dvar), np.where(sd > 0, dvar / sd, np.inf))


def _rel(got, ref, rtol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(ref)), what
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=rtol, atol=0, err_msg=what)


@pytest.mark.parametrize("fmt,tcol", GRAINS)
def test_aggregator_matches_jax_and_float64(tables, fmt, tcol):
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt

    df, pt, jt = tables
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the host fallback's warning
        got = pdt.aggregator(pt, ["v", "w"], AGGS, tcol, fmt)
        exp = jdt.aggregator(jt, ["v", "w"], AGGS, tcol, fmt)
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    assert got[tcol].tolist() == exp[tcol].tolist()
    # the reference sees the f32 values the Tables hold
    f32 = df[["v", "w"]].astype(np.float32).astype(np.float64)
    key = df[tcol].dt.strftime(fmt)
    ref = f32.assign(key=key).dropna(subset=["key"]).groupby("key")
    for c in ("v", "w"):
        for a in AGGS:
            name = f"{c}_{a}"
            g, e = got[name].to_numpy(np.float64), exp[name].to_numpy(np.float64)
            r = (ref[c].agg("std" if a == "stddev" else a).reindex(got[tcol]).to_numpy(np.float64))
            if a in ("count", "min", "max", "median"):
                np.testing.assert_array_equal(g, e, err_msg=name)
                # on the device a median of two values is their f32 mean;
                # the host groupby's is float64
                on_host = pdt._format_grain(fmt) is None
                np.testing.assert_array_equal(g, r if on_host else r.astype(np.float32), err_msg=name)
            else:
                _rel(g, r, 1e-5 if a == "stddev" else 1e-6, f"{name} vs float64")
                band = _bucket_band(f32[c], key, got[tcol], a)
                ok = ~np.isnan(r)
                assert np.all(np.abs(g - e)[ok] <= band[ok] + 1e-5 * np.abs(r[ok])), f"{name} vs jax"


def test_aggregator_all_null_time_column(tables):
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = tables[0].assign(ts=np.datetime64("NaT"))
    got = pdt.aggregator(Table.from_pandas(df, device="cpu"), "v|w", "sum|count", "ts")
    exp = jdt.aggregator(JTable.from_pandas(df), "v|w", "sum|count", "ts")
    assert got.empty and list(got.columns) == list(exp.columns)


def _window_band(v_sorted, order, n, mean, agg):
    """|port − JAX| bound of each row's window value.  The JAX package
    takes a window sum as a difference of two f32 running sums over the
    sorted column; a running sum of N terms is off by at most
    γ_N·Σ|v| (γ_N = N·u / (1 − N·u), u = 2^-24), so a window sum by twice
    that (÷ n for a mean), and a variance by the same of Σv² plus
    2·|mean| times the sum's bound, over n − 1 (a standard deviation by
    its square root)."""
    u = 2.0 ** -24
    N = np.arange(1, len(v_sorted) + 1)
    gamma = N * u / (1 - N * u)
    abs_b = np.empty(len(v_sorted))
    sq_b = np.empty(len(v_sorted))
    abs_b[order] = 2 * gamma * np.cumsum(np.abs(v_sorted))
    sq_b[order] = 2 * gamma * np.cumsum(v_sorted * v_sorted)
    if agg == "sum":
        return abs_b
    if agg == "mean":
        return abs_b / np.maximum(n, 1)
    return np.sqrt((sq_b + 2 * np.abs(np.nan_to_num(mean)) * abs_b) / np.maximum(n - 1, 1))


def _pandas_window(df, agg, window_type, w, partition):
    """pandas reference: sort by (partition, ts), nulls of ts last, stable;
    rolling with min_periods = w, expanding with 1 (count: window rows)."""
    key = df["ts"].astype("int64").where(df["ts"].notna(), np.iinfo(np.int32).max)
    if partition:
        codes = pd.Categorical(df["part"]).codes
        order = np.lexsort((np.arange(len(df)), key.to_numpy(), codes))
        groups = codes[order]
    else:
        order = np.argsort(key.to_numpy(), kind="stable")
        groups = np.zeros(len(df), int)
    s = pd.Series(df["v"].to_numpy()[order])
    roll = s.groupby(groups).rolling(w, min_periods=w) if window_type == "rolling" else \
        s.groupby(groups).expanding(1)
    fn = {"stddev": "std"}.get(agg, agg)
    res = getattr(roll, fn)().reset_index(level=0, drop=True).sort_index().to_numpy()
    if agg == "count" and window_type == "rolling":
        pos = pd.Series(np.ones(len(df))).groupby(groups).cumcount().to_numpy()
        res = np.where(pos + 1 >= w, s.notna().astype(float).groupby(groups).rolling(w, min_periods=1)
                       .sum().reset_index(level=0, drop=True).sort_index().to_numpy(), np.nan)
    out = np.empty(len(df))
    out[order] = res
    return out, order, groups


@pytest.mark.parametrize("window_type", ["expanding", "rolling"])
@pytest.mark.parametrize("partition", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_window_aggregator_matches_jax_and_pandas(tables, window_type, partition, agg):
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt

    df, pt, jt = tables
    kw = dict(order_col="ts", window_type=window_type, window_size=3,
              partition_col="part" if partition else "")
    name = f"v_{agg}_{window_type}"
    got = pdt.window_aggregator(pt, ["v"], [agg], **kw)
    exp = jdt.window_aggregator(jt, ["v"], [agg], **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    g = got.to_pandas()[name].to_numpy(np.float64)
    e = exp.to_pandas()[name].to_numpy(np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(e))
    ref, order, groups = _pandas_window(df, agg, window_type, 3, partition)
    assert np.array_equal(np.isnan(g), np.isnan(ref))
    ok = ~np.isnan(g)
    if agg in ("count", "min", "max", "median"):
        np.testing.assert_array_equal(g, e)
        # a rolling median of two values is their f32 mean; the expanding
        # median is pandas' on the host, float64
        np.testing.assert_array_equal(
            g[ok], ref[ok] if window_type == "expanding" else ref[ok].astype(np.float32))
        return
    np.testing.assert_allclose(g[ok], ref[ok], rtol=1e-5 if agg == "stddev" else 1e-6,
                               atol=1e-6 if agg == "stddev" else 0)
    counts, _, _ = _pandas_window(df, "count", window_type, 3, partition)
    mean, _, _ = _pandas_window(df, "mean", window_type, 3, partition)
    band = _window_band(np.nan_to_num(df["v"].to_numpy()[order]), order, counts, mean, agg)
    assert np.all(np.abs(g - e)[ok] <= band[ok] + 1e-5 * np.abs(ref[ok])), agg


@pytest.mark.parametrize("output_type", ["ts", "ts_diff"])
@pytest.mark.parametrize("order_col", ["", "ts_short"])
@pytest.mark.parametrize("partition_col", ["", "part"])
def test_lagged_ts_equals_jax(tables, output_type, order_col, partition_col):
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt

    _, pt, jt = tables
    kw = dict(lag=2, output_type=output_type, tsdiff_unit="hours", order_col=order_col,
              partition_col=partition_col)
    got = pdt.lagged_ts(pt, "ts", **kw)
    exp = jdt.lagged_ts(jt, "ts", **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())


def test_lagged_ts_is_pandas_shift(tables):
    from anovos_tpu_torch.data_transformer import datetime as pdt

    df, pt, _ = tables
    got = pdt.lagged_ts(pt, "ts", lag=1, output_type="ts_diff", tsdiff_unit="days").to_pandas()
    s = df["ts"].sort_values(kind="stable", na_position="last")
    diff = ((s - s.shift(1)).dt.total_seconds() / 86400).astype(np.float32).reindex(df.index)
    np.testing.assert_array_equal(got["ts_lag1_diff"].to_numpy(np.float32), diff.to_numpy())
