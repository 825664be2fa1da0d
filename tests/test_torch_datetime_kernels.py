"""The port's calendar functions (``anovos_tpu_torch/ops/datetime_kernels.py``)
against the JAX package's on the same int32 epoch seconds: every field bit
for bit, across the whole int32 range (dates before 1970, 29 February, ISO
week-53 years, both int32 edges)."""

import numpy as np
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401

I32 = np.iinfo(np.int32)
FIELDS = ["year", "month", "day", "hour", "minute", "second", "dayofweek", "dayofyear",
          "quarter", "weekofyear", "days", "sod", "leap"]
PERIODS = [(w, p) for w in ("start", "end") for p in ("month", "quarter", "year")]


def _secs(*dates):
    import pandas as pd

    return [int(pd.Timestamp(d).timestamp()) for d in dates]


def epochs(n=10_000, seed=17):
    """Seeded epochs over the int32 range plus the edges that matter."""
    g = np.random.default_rng(seed)
    special = [I32.min, I32.min + 1, I32.max, I32.max - 1, -1, 0, 1, -86400, -86401, 86399]
    special += _secs("1904-02-29 12:00:00", "1900-03-01", "1969-12-31 23:59:59", "2000-02-29",
                     "2000-03-01 00:00:00", "2024-02-29 23:59:59", "2036-02-29",
                     # ISO week 53 and its neighbours
                     "1903-12-31", "1904-01-03", "1908-12-31", "1976-01-01", "1981-01-04",
                     "2004-12-31", "2005-01-02", "2009-12-31", "2010-01-03", "2015-12-31",
                     "2016-01-03", "2020-12-31", "2021-01-03", "2026-12-31", "2027-01-03",
                     "2037-12-31", "1911-01-01", "1916-01-02")
    rand = g.integers(I32.min, I32.max, n - len(special), dtype=np.int64, endpoint=True)
    return np.concatenate([np.asarray(special, np.int64), rand]).astype(np.int32)


@pytest.fixture(scope="module")
def both_civil():
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import datetime_kernels as jdk
    from anovos_tpu_torch.ops import datetime_kernels as pdk

    s = epochs()
    exp = {k: np.asarray(v) for k, v in jdk.civil_from_epoch(jnp.asarray(s)).items()}
    got = {k: v.numpy() for k, v in pdk.civil_from_epoch(torch.from_numpy(s)).items()}
    return s, got, exp


@pytest.mark.parametrize("field", FIELDS)
def test_civil_field_equals_jax(both_civil, field):
    _, got, exp = both_civil
    assert got[field].dtype == exp[field].dtype
    np.testing.assert_array_equal(got[field], exp[field])


def test_civil_fields_are_pandas_calendar(both_civil):
    """A check that the shared arithmetic is the calendar: pandas .dt on
    the same instants (ISO week from isocalendar, Mon = 0)."""
    import pandas as pd

    s, got, _ = both_civil
    ts = pd.Series(s.astype(np.int64).astype("datetime64[s]"))
    for field, ref in (("year", ts.dt.year), ("month", ts.dt.month), ("day", ts.dt.day),
                       ("hour", ts.dt.hour), ("minute", ts.dt.minute), ("second", ts.dt.second),
                       ("dayofweek", ts.dt.dayofweek), ("dayofyear", ts.dt.dayofyear),
                       ("quarter", ts.dt.quarter), ("weekofyear", ts.dt.isocalendar().week),
                       ("leap", ts.dt.is_leap_year)):
        np.testing.assert_array_equal(got[field], ref.to_numpy().astype(got[field].dtype),
                                      err_msg=field)
    assert got["weekofyear"].max() == 53


def test_days_from_civil_equals_jax(both_civil):
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import datetime_kernels as jdk
    from anovos_tpu_torch.ops import datetime_kernels as pdk

    _, got, _ = both_civil
    y, m, d = got["year"], got["month"], got["day"]
    exp = np.asarray(jdk.days_from_civil(jnp.asarray(y), jnp.asarray(m), jnp.asarray(d)))
    res = pdk.days_from_civil(torch.from_numpy(y), torch.from_numpy(m), torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(res, exp)
    np.testing.assert_array_equal(res, got["days"])


@pytest.mark.parametrize("unit", ["year", "day", "dayofmonth", "dayofweek", "weekofyear", "quarter"])
def test_extract_unit_equals_jax(unit):
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import datetime_kernels as jdk
    from anovos_tpu_torch.ops import datetime_kernels as pdk

    s = epochs(2000, seed=3)
    np.testing.assert_array_equal(pdk.extract_unit(torch.from_numpy(s), unit).numpy(),
                                  np.asarray(jdk.extract_unit(jnp.asarray(s), unit)))


@pytest.mark.parametrize("which,period", PERIODS)
def test_period_boundaries_equal_jax(which, period):
    """Boundaries and their predicates, int32 wraparound past 2038 included
    (the end of 2038's year lies beyond the int32 range)."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import datetime_kernels as jdk
    from anovos_tpu_torch.ops import datetime_kernels as pdk

    s = epochs(4000, seed=5)
    s = np.concatenate([s, np.asarray(_secs("2020-01-31", "2020-03-31 05:00:00", "2021-12-31",
                                            "2020-01-01 23:00:00", "1960-06-30"), np.int32)])
    t, j = torch.from_numpy(s), jnp.asarray(s)
    np.testing.assert_array_equal(pdk.period_boundary(t, which, period).numpy(),
                                  np.asarray(jdk.period_boundary(j, which, period)))
    flags = pdk.is_period_boundary(t, which, period).numpy()
    np.testing.assert_array_equal(flags, np.asarray(jdk.is_period_boundary(j, which, period)))
    assert flags.any()


@pytest.mark.parametrize("months", [-25, -1, 1, 2, 13, 120])
def test_add_months_clamps_like_jax(months):
    import jax.numpy as jnp
    import pandas as pd
    import torch

    from anovos_tpu.ops import datetime_kernels as jdk
    from anovos_tpu_torch.ops import datetime_kernels as pdk

    month_ends = np.asarray(_secs("2020-01-31 10:00:00", "2019-01-31", "2000-02-29", "1999-03-31",
                                  "1950-05-31 23:59:59", "2024-08-31"), np.int32)
    s = np.concatenate([month_ends, epochs(3000, seed=months + 100)])
    got = pdk.add_months(torch.from_numpy(s), months).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdk.add_months(jnp.asarray(s), months)))
    # end-of-month clamping is DateOffset's
    ref = (pd.Series(month_ends.astype(np.int64).astype("datetime64[s]"))
           + pd.DateOffset(months=months)).to_numpy().astype("datetime64[s]").astype(np.int64)
    np.testing.assert_array_equal(got[:len(month_ends)], ref)


def test_apply_offset_table_equals_jax():
    """searchsorted(right=True) of int32 seconds in int32 transitions: a
    second exactly at a transition takes the new offset."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import datetime_kernels as jdk
    from anovos_tpu_torch.ops import datetime_kernels as pdk

    g = np.random.default_rng(9)
    tr = np.sort(g.choice(np.arange(-2_000_000_000, 2_000_000_000, 977), 40, replace=False)).astype(np.int32)
    off = g.integers(-14, 15, 41).astype(np.int32) * 1800
    s = np.concatenate([tr, tr - 1, tr + 1, epochs(3000, seed=11)]).astype(np.int32)
    got = pdk.apply_offset_table(torch.from_numpy(s), torch.from_numpy(tr), torch.from_numpy(off))
    exp = jdk.apply_offset_table(jnp.asarray(s), jnp.asarray(tr), jnp.asarray(off))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    # no transition in the span: one offset for every second
    one = pdk.apply_offset_table(torch.from_numpy(s), torch.zeros(0, dtype=torch.int32),
                                 torch.tensor([3600], dtype=torch.int32))
    np.testing.assert_array_equal(one.numpy(), s + 3600)


@pytest.mark.parametrize("given,out", [("America/New_York", "UTC"), ("UTC", "Asia/Kolkata"),
                                       ("Europe/London", "America/Los_Angeles")])
def test_tz_offset_table_equals_jax(given, out):
    from anovos_tpu.ops import datetime_kernels as jdk
    from anovos_tpu_torch.ops import datetime_kernels as pdk

    lo, hi = _secs("2015-01-01", "2018-06-30")
    got, exp = pdk.tz_offset_table(given, out, lo, hi), jdk.tz_offset_table(given, out, lo, hi)
    for g_arr, e_arr in zip(got, exp):
        assert g_arr.dtype == e_arr.dtype == np.int32
        np.testing.assert_array_equal(g_arr, e_arr)
