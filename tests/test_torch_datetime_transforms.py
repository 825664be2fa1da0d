"""Every other public function of the port's ``data_transformer/datetime.py``
against the JAX package's on one seeded Table: conversions, unit
extraction, arithmetic, comparison, the calendar boundaries and
predicates.  Column names, Spark dtypes, values and nulls are equal.

Two divergences are pinned: ``unix_to_timestamp`` of a float64 epoch
column that f32 cannot hold reads the exact float64 values, where the JAX
package reads their f32 rounding (seconds off by up to 64 around 2e9); and
``timestamp_to_unix(precision="ms")``, which raises in the JAX package,
gives an exact int64 column, held to pandas."""

import types

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_port import torch_cpu_runtime  # noqa: F401

ROWS = 1200
PREDICATES = ["start_of_month", "is_monthStart", "end_of_month", "is_monthEnd",
              "start_of_year", "is_yearStart", "end_of_year", "is_yearEnd",
              "start_of_quarter", "is_quarterStart", "end_of_quarter", "is_quarterEnd",
              "is_yearFirstHalf", "is_leapYear", "is_weekend"]


def transform_frame(n=ROWS, seed=51):
    g = np.random.default_rng(seed)
    secs = g.integers(-2_000_000_000, 2_100_000_000, n)
    secs[:6] = [0, -1, 951_782_400, 1_709_164_800, 2_147_483_647, -2_147_483_648]
    ts = secs.astype("datetime64[s]")
    ts[g.random(n) < 0.05] = np.datetime64("NaT")
    ts2 = (np.datetime64("2010-01-01T00:00:00", "s")
           + g.integers(0, 20 * 365 * 86400, n).astype("timedelta64[s]"))
    days = pd.Series(pd.Timestamp("1995-01-01") + pd.to_timedelta(g.integers(0, 9000, n), unit="D"))
    dstr = days.dt.strftime("%Y-%m-%d").to_numpy(dtype=object)
    dstr[g.random(n) < 0.05] = None
    dstr[g.random(n) < 0.03] = "not a date"
    dtstr = (days + pd.to_timedelta(g.integers(0, 86400, n), unit="s")).dt.strftime(
        "%Y-%m-%d %H:%M:%S").to_numpy(dtype=object)
    dtstr[::17] = None
    epoch_i = g.integers(-1_000_000_000, 2_000_000_000, n).astype(np.int32)
    epoch_ms = g.integers(-10**12, 2 * 10**12, n).astype(np.int64)
    epoch_f = (g.integers(0, 2**23, n) * 256).astype(np.float64)  # f32 holds them
    epoch_f[::13] = np.nan
    return pd.DataFrame({"ts": ts, "ts2": ts2, "dstr": dstr, "dtstr": dtstr, "epoch_i": epoch_i,
                         "epoch_ms": epoch_ms, "epoch_f": epoch_f,
                         "epoch_f_ms": epoch_f * 4})


@pytest.fixture(scope="module")
def tables():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = transform_frame()
    return Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)


def both(tables, name, *args, **kw):
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt

    pt, jt = tables
    return getattr(pdt, name)(pt, *args, **kw), getattr(jdt, name)(jt, *args, **kw)


def assert_same(got, exp):
    assert got.col_names == exp.col_names
    assert got.dtypes() == exp.dtypes()
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())


@pytest.mark.parametrize("output_mode", ["replace", "append"])
def test_timestamp_to_unix(tables, output_mode):
    assert_same(*both(tables, "timestamp_to_unix", ["ts", "ts2"], output_mode=output_mode))


@pytest.mark.parametrize("output_mode", ["replace", "append"])
def test_timestamp_to_unix_milliseconds(tables, output_mode):
    """An exact int64 column of the milliseconds, against pandas.  The JAX
    package's call raises under numpy 2: it subtracts 2^31 from an int32
    array to pad the low half of its (hi, lo) pair."""
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt

    pt, jt = tables
    got = pdt.timestamp_to_unix(pt, ["ts", "ts2"], precision="ms", output_mode=output_mode)
    name = "ts_unix" if output_mode == "append" else "ts"
    col = got[name]
    assert col.dtype_name == "bigint" and col.exact.dtype == torch.int64
    src = pt.to_pandas()["ts"]
    ref = pd.array(src.to_numpy().astype("datetime64[ms]").astype(np.int64), dtype="Int64")
    ref[src.isna().to_numpy()] = pd.NA
    pd.testing.assert_extension_array_equal(pd.array(got.to_pandas()[name]), ref)
    np.testing.assert_array_equal(col.data.numpy(), col.exact.numpy().astype(np.float32))
    with pytest.raises(OverflowError):
        jdt.timestamp_to_unix(jt, ["ts"], precision="ms")


@pytest.mark.parametrize("col,precision", [("epoch_i", "s"), ("epoch_ms", "ms"), ("epoch_f", "s")])
def test_unix_to_timestamp(tables, col, precision):
    assert_same(*both(tables, "unix_to_timestamp", col, precision=precision, output_mode="append"))


@pytest.mark.parametrize("col,precision", [("epoch_i", "ms"), ("epoch_f_ms", "ms"), ("e64", "s")])
def test_unix_to_timestamp_divides_exact_values(tables, col, precision):
    """Divergence by design: the port divides the exact values in float64.
    The JAX package reads a float64 column that f32 cannot hold as its f32
    rounding (seconds off by up to 64 around 2e9), and divides
    milliseconds in f32 as (x − fmod(x, 1000)) / 1000, whose subtraction
    rounds to the f32 spacing (512 at 5e9): a second too many."""
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.data_transformer import datetime as pdt
    from anovos_tpu_torch.shared.table import Table

    if col == "e64":
        df = pd.DataFrame({col: [1_999_999_999.0, 1_700_000_123.0, np.nan, -86_401.0]})
        pt, jt = Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)
        vals = df[col].to_numpy()
    else:
        pt, jt = tables
        vals = pt.to_pandas()[col].to_numpy(np.float64)  # the values the Table holds
    got = pdt.unix_to_timestamp(pt, col, precision=precision).to_pandas()[col]
    exp = jdt.unix_to_timestamp(jt, col, precision=precision).to_pandas()[col]
    secs = np.floor(vals / 1000) if precision == "ms" else np.trunc(vals)
    ref = np.where(np.isnan(secs), np.datetime64("NaT"), np.nan_to_num(secs).astype(np.int64).astype("datetime64[s]"))
    as_s = lambda x: x.to_numpy().astype("datetime64[s]")  # noqa: E731
    np.testing.assert_array_equal(as_s(got), ref)
    assert (as_s(exp) != ref).any()


@pytest.mark.parametrize("given,output", [("UTC", "Asia/Kolkata"), ("America/New_York", "Europe/Berlin")])
def test_timezone_conversion(tables, given, output):
    assert_same(*both(tables, "timezone_conversion", ["ts2"], given, output, output_mode="append"))


@pytest.mark.parametrize("col,fmt,output_type", [("dtstr", "%Y-%m-%d %H:%M:%S", "ts"),
                                                 ("dstr", "%Y-%m-%d", "ts"), ("dtstr", "%Y-%m-%d %H:%M:%S", "dt"),
                                                 ("dstr", "%d/%m/%Y", "ts")])
def test_string_to_timestamp(tables, col, fmt, output_type):
    assert_same(*both(tables, "string_to_timestamp", col, input_format=fmt, output_type=output_type,
                      output_mode="append"))


@pytest.mark.parametrize("fmt", ["%Y-%m-%d %H:%M:%S", "%d/%m/%Y %H"])
def test_timestamp_to_string(tables, fmt):
    assert_same(*both(tables, "timestamp_to_string", "ts|ts2", output_format=fmt))


@pytest.mark.parametrize("out_fmt", ["%d-%m-%Y", "%Y"])
def test_dateformat_conversion(tables, out_fmt):
    got, exp = both(tables, "dateformat_conversion", "dstr", output_format=out_fmt, output_mode="append")
    assert_same(got, exp)
    assert list(got["dstr_fmt"].vocab) == list(exp.columns["dstr_fmt"].vocab)


@pytest.mark.parametrize("units,output_mode", [("all", "append"), ("hour|dayofweek|dayofmonth", "replace")])
def test_timeUnits_extraction(tables, units, output_mode):
    assert_same(*both(tables, "timeUnits_extraction", ["ts", "ts2"], units=units, output_mode=output_mode))


@pytest.mark.parametrize("unit", ["days", "hours", "week", "second", "minutes"])
def test_time_diff(tables, unit):
    assert_same(*both(tables, "time_diff", "ts", "ts2", unit=unit))


def test_time_elapsed(tables, monkeypatch):
    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt

    fixed = types.SimpleNamespace(now=lambda: pd.Timestamp("2024-05-01 12:34:56"))
    for mod in (jdt, pdt):
        monkeypatch.setattr(mod, "pd", types.SimpleNamespace(Timestamp=fixed))
    for unit in ("days", "hours"):
        assert_same(*both(tables, "time_elapsed", ["ts2"], unit=unit))


@pytest.mark.parametrize("unit,value", [("days", 1.5), ("hours", -3), ("months", 1), ("years", -2),
                                        ("month", 14), ("min", 90), ("weeks", 2)])
def test_adding_timeUnits(tables, unit, value):
    assert_same(*both(tables, "adding_timeUnits", ["ts2"], unit=unit, unit_value=value,
                      output_mode="append"))


@pytest.mark.parametrize("ctype", ["greater_than", "less_than", "greaterThan_equalTo", "lessThan_equalTo"])
def test_timestamp_comparison(tables, ctype):
    assert_same(*both(tables, "timestamp_comparison", ["ts", "ts2"], comparison_type=ctype,
                      comparison_value="2019-06-30 12:00:00"))
    assert_same(*both(tables, "timestamp_comparison", "ts2", comparison_type=ctype,
                      comparison_value="30/06/2019", comparison_format="%d/%m/%Y"))


def test_timestamp_comparison_rejects_unknown_type(tables):
    from anovos_tpu_torch.data_transformer import datetime as pdt

    with pytest.raises(TypeError):
        pdt.timestamp_comparison(tables[0], "ts", comparison_type="equal")


@pytest.mark.parametrize("name", PREDICATES)
@pytest.mark.parametrize("output_mode", ["append", "replace"])
def test_boundary_and_predicate(tables, name, output_mode):
    assert_same(*both(tables, name, ["ts", "ts2"], output_mode=output_mode))


@pytest.mark.parametrize("start,end", [(0, 23), (9, 17), (22, 4)])
def test_is_selectedHour(tables, start, end):
    assert_same(*both(tables, "is_selectedHour", "ts|ts2", start_hour=start, end_hour=end))


def test_argument_checker_rejects_output_mode():
    from anovos_tpu_torch.data_transformer import datetime as pdt

    pdt.argument_checker("f", {"output_mode": "append"})
    with pytest.raises(TypeError):
        pdt.argument_checker("f", {"output_mode": "inplace"})


def test_every_public_function_is_ported():
    import inspect

    from anovos_tpu.data_transformer import datetime as jdt
    from anovos_tpu_torch.data_transformer import datetime as pdt

    public = [n for n, f in vars(jdt).items() if inspect.isfunction(f) and not n.startswith("_")
              and f.__module__ == jdt.__name__]
    assert len(public) == 32
    for n in public:
        assert list(inspect.signature(getattr(pdt, n)).parameters) == \
            list(inspect.signature(getattr(jdt, n)).parameters), n
