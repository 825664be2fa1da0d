"""stats_generator: each of the eleven public functions of the port against
the JAX package's on the same frame.

Integer results are compared exactly (counts, unique counts, modes, 'lower'
percentiles, min/max).  f32 moment results are compared to rel 1e-6 — a
few times PERF.md's "Moment accumulation error" bands (≤ 3e-7 relative
for either package against float64) — plus one step of the 4-decimal
rounding both frames apply (1e-4); skewness and kurtosis get an absolute
3e-4 (PERF.md's 1.7e-4 absolute for skewness near 0, plus that step).
"""

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, income_frame, torch_cpu_runtime  # noqa: F401

FUNCS = [
    "global_summary", "missingCount_computation", "nonzeroCount_computation",
    "measures_of_counts", "mode_computation", "measures_of_centralTendency",
    "uniqueCount_computation", "measures_of_cardinality", "measures_of_dispersion",
    "measures_of_percentiles", "measures_of_shape",
]


@pytest.fixture(scope="module")
def tables():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = income_frame(4000, seed=11)
    g = np.random.default_rng(2)
    df["big_id"] = (np.int64(1) << 36) + g.integers(0, 50, len(df))
    df["all_null"] = np.nan
    df["const"] = 3.0
    df["int_col"] = g.integers(0, 7, len(df)).astype(np.int32)
    return JTable.from_pandas(df), Table.from_pandas(df, device="cpu")


@pytest.mark.parametrize("fn", FUNCS)
def test_stats_function_matches_jax(fn, tables):
    from anovos_tpu.data_analyzer import stats_generator as jsg
    from anovos_tpu_torch.data_analyzer import stats_generator as psg

    jt, pt = tables
    exp = getattr(jsg, fn)(jt)
    got = getattr(psg, fn)(pt)
    moment_cols = {"mean", "stddev", "cov", "skewness", "kurtosis", "variance"}
    exact = [c for c in exp.columns if c not in moment_cols]
    assert_frames_close(got[exact], exp[exact], exact_cols=exact)
    for c in moment_cols & set(exp.columns):
        g = pd.to_numeric(got[c]).to_numpy(np.float64)
        e = pd.to_numeric(exp[c]).to_numpy(np.float64)
        if c in ("skewness", "kurtosis"):
            atol = 3e-4
        elif c == "variance":
            # variance is round(stddev, 4)**2: one rounding step of stddev
            atol = 2e-4 * np.nan_to_num(np.sqrt(np.abs(e))) + 1e-4
        else:
            atol = 1e-4
        assert (np.isnan(g) == np.isnan(e)).all(), c
        ok = np.isnan(e) | (np.abs(g - e) <= atol + 1e-6 * np.abs(e))
        assert ok.all(), f"{c}: {g[~ok]} vs {e[~ok]}"


def test_describe_exact_values_of_wide_columns(tables):
    """The wide columns' order statistics come from their int64 / float64
    values, not the f32 approximation."""
    from anovos_tpu_torch.data_analyzer.stats_generator import measures_of_percentiles, mode_computation

    _, pt = tables
    pc = measures_of_percentiles(pt, ["big_id", "latitude"]).set_index("attribute")
    host = pt.columns["big_id"].exact_host()
    assert pc.loc["big_id", "min"] == host.min() and pc.loc["big_id", "max"] == host.max()
    lat = pt.columns["latitude"].exact_host()
    assert pc.loc["latitude", "max"] == np.round(lat.max(), 4)
    vals, cnt = np.unique(host, return_counts=True)
    mode = mode_computation(pt, ["big_id"]).iloc[0]
    assert mode["mode"] == str(vals[np.argmax(cnt)]) and mode["mode_rows"] == cnt.max()


def test_unsupported_paths_raise(tables):
    """The approx distinct count runs (tests/test_torch_hll.py holds it
    against the JAX package); an rsd at or below 0 raises."""
    from anovos_tpu_torch.data_analyzer.stats_generator import uniqueCount_computation

    _, pt = tables
    approx = uniqueCount_computation(pt, compute_approx_unique_count=True)
    assert list(approx["attribute"]) == list(uniqueCount_computation(pt)["attribute"])
    with pytest.raises(ValueError):
        uniqueCount_computation(pt, compute_approx_unique_count=True, rsd=0)


def test_describe_refuses_compensated_size(monkeypatch):
    """At 2^24 logical rows the port no longer refuses: ``table_describe``
    takes the compensated moments (the threshold reads ``nrows``, so a
    small table claiming 2^24 rows shows it)."""
    from anovos_tpu_torch.ops import describe
    from anovos_tpu_torch.shared.table import Table

    monkeypatch.setenv("ANOVOS_COMPENSATED_MOMENTS", "auto")
    calls = []
    real = describe.compensated_moments
    monkeypatch.setattr(describe, "compensated_moments", lambda X, M: calls.append(X.shape) or real(X, M))
    t = Table.from_numpy({"x": np.arange(100, dtype=np.float32)}, device="cpu")
    describe.table_describe(t, ["x"], [])
    assert calls == []
    t.nrows = 1 << 24
    num, _ = describe.table_describe(t, ["x"], [])
    assert calls == [(100, 1)] and num["mean"].dtype == np.float64 and num["mean"][0] == 49.5
