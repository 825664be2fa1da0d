"""The time-series analyzer of the port against the JAX package's:
``ts_preprocess`` then ``ts_analyzer`` on ``synthesize(20_000)`` (dt_1, dt_2
and ifa kept), with three ts columns added to both Tables: seconds over the
same span with 5% nulls, an all-null column and a one-day column (neither
of the last two is eligible).

Both write the same files with the same rows.  Dates, counts, min, max and
median are equal; a mean is within 1e-5 relative plus one unit of its
4th decimal, since the JAX package sums in f32 and the port in float64
before both round to 4 decimals.  Count columns of the aggregated frames
are int64 in the port and f32 in the JAX package ("12" against "12.0" in
the CSV text), so counts compare as numbers."""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401

ROWS = 20_000


def _ts_columns(n, seed=31):
    """(dt_hours: seconds with 5% nulls, all-null, one day) host arrays."""
    g = np.random.default_rng(seed)
    base = np.datetime64("2015-01-01T00:00:00", "s")
    hours = base + (g.integers(0, 3600, n) * 86400 + g.integers(0, 86400, n)).astype("timedelta64[s]")
    hours[g.random(n) < 0.05] = np.datetime64("NaT")
    one_day = np.datetime64("2019-06-01T00:00:00", "s") + g.integers(0, 86400, n).astype("timedelta64[s]")
    none = np.full(n, np.datetime64("NaT"), "datetime64[s]")
    return {"dt_hours": hours, "dt_none": none, "dt_oneday": one_day}


def _add(table, cols, host_to_column):
    for name, arr in cols.items():
        table = table.with_column(name, host_to_column(arr, len(arr)))
    return table


@pytest.fixture(scope="module")
def analyzed(tmp_path_factory):
    import torch

    from anovos_tpu.data_analyzer.ts_analyzer import ts_analyzer as jan
    from anovos_tpu.data_ingest.ts_auto_detection import ts_preprocess as jpre
    from anovos_tpu.shared.runtime import get_runtime as jrt
    from anovos_tpu.shared.table import Table as JTable, _host_to_column
    from anovos_tpu_torch.data_analyzer.ts_analyzer import ts_analyzer as pan
    from anovos_tpu_torch.data_ingest.ts_auto_detection import ts_preprocess as ppre
    from anovos_tpu_torch.shared.table import Table, host_to_column
    from examples._data import synthesize

    df = synthesize(ROWS, seed=3)
    extra = _ts_columns(ROWS)
    jd, pdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jt = jpre(JTable.from_pandas(df), "ifa", output_path=str(jd))
    pt = ppre(Table.from_pandas(df, device="cpu"), "ifa", output_path=str(pdir))
    jt = _add(jt, extra, lambda a, n: _host_to_column(a, n, jt.pad_target(), jrt()))
    pt = _add(pt, extra, lambda a, n: host_to_column(a, n, torch.device("cpu")))
    jan(jt, "ifa", max_days=3600, output_path=str(jd), output_type="daily")
    pan(pt, "ifa", max_days=3600, output_path=str(pdir), output_type="daily")
    return pdir, jd


def test_same_files(analyzed):
    pdir, jdir = analyzed
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    # three eligible columns with 10 files each, the landscape, the stats
    # and the detection stats
    assert len(names) == 3 * 10 + 3
    assert not [n for n in names if "dt_none" in n or "dt_oneday" in n]


def _read(d, name):
    return pd.read_csv(os.path.join(d, name), keep_default_na=False, dtype=str)


@pytest.mark.parametrize("kind", ["ts_cols_stats", "ts_stats", "ts_landscape", "ts_daily",
                                  "ts_hourly", "ts_weekly", "ts_daypart", "ts_decompose",
                                  "ts_stationarity", "ts_cat_daily"])
def test_count_files_equal_text(analyzed, kind):
    """Files of counts and what is computed from them on the host: equal
    text."""
    pdir, jdir = analyzed
    names = [n for n in sorted(os.listdir(jdir)) if n == kind + ".csv" or n.startswith(kind + "_dt")]
    assert names
    for n in names:
        with open(os.path.join(pdir, n)) as fg, open(os.path.join(jdir, n)) as fe:
            assert fg.read() == fe.read(), n


@pytest.mark.parametrize("grain", ["daily", "hourly", "weekly"])
def test_numeric_viz_files_match(analyzed, grain):
    pdir, jdir = analyzed
    names = [n for n in sorted(os.listdir(jdir)) if n.startswith(f"ts_num_{grain}_")]
    assert len(names) == 3
    for n in names:
        got, exp = _read(pdir, n), _read(jdir, n)
        assert list(got.columns) == list(exp.columns) and len(got) == len(exp), n
        for c in exp.columns:
            if c == "count":
                np.testing.assert_array_equal(got[c].astype(float), exp[c].astype(float), err_msg=n)
            elif c == "mean":
                g, e = got[c].astype(float), exp[c].astype(float)
                np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-4 * (1 + 1e-9), err_msg=n)
            else:
                assert got[c].tolist() == exp[c].tolist(), f"{n}:{c}"


def test_hourly_keys_follow_nulls(analyzed):
    """The hour keys of a column with nulls are floats, as pandas makes
    them; of a column without, ints."""
    pdir, _ = analyzed
    assert _read(pdir, "ts_hourly_dt_hours.csv")["hour"].iloc[0] == "0.0"
    assert _read(pdir, "ts_weekly_dt_1.csv")["dayofweek"].iloc[0] == "0"


def test_ineligible_columns_in_stats(analyzed):
    pdir, _ = analyzed
    stats = pd.read_csv(os.path.join(pdir, "ts_stats.csv")).set_index("attribute")
    assert stats.loc["dt_none", "reason"] == "all null" and stats.loc["dt_none", "eligible"] == 0
    assert stats.loc["dt_oneday", "eligible"] == 0 and stats.loc["dt_oneday", "span_days"] == 0
    days = pd.read_csv(os.path.join(pdir, "ts_daily_dt_1.csv"))
    assert stats.loc["dt_1", "eligible"] == 1 and stats.loc["dt_1", "distinct_days"] == len(days)
    assert days["count"].sum() == ROWS


@pytest.mark.parametrize("module", ["data_analyzer.ts_analyzer", "data_ingest.ts_auto_detection"])
def test_public_functions_have_the_jax_arguments(module):
    """Every public function of the JAX module has a counterpart with the
    same arguments (private ``_``-arguments aside); the pandas helpers the
    port replaces with device counts (``daypart_cat``, ``ts_processed_feats``)
    are not ported."""
    import importlib
    import inspect

    jm = importlib.import_module(f"anovos_tpu.{module}")
    pm = importlib.import_module(f"anovos_tpu_torch.{module}")
    args = lambda f: [p for p in inspect.signature(f).parameters if not p.startswith("_")]  # noqa: E731
    public = [n for n, f in vars(jm).items() if inspect.isfunction(f) and not n.startswith("_")
              and f.__module__ == jm.__name__ and n not in ("daypart_cat", "ts_processed_feats")]
    assert "ts_analyzer" in public or "ts_preprocess" in public
    for n in public:
        assert args(getattr(pm, n)) == args(getattr(jm, n)), n
