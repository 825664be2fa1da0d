"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: the same seeded host inputs go through both."""

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def torch_cpu_runtime():
    """The port runs on the CPU in these tests (its plain kernel versions)."""
    from anovos_tpu_torch.shared.runtime import init_runtime

    return init_runtime("cpu")


def port_table_from_jax(jt):
    """The port's Table holding exactly the JAX Table's columns."""
    from anovos_tpu_torch.shared.convert import table_from_numpy_columns

    cols = {}
    for name, c in jt.columns.items():
        exact = None
        if c.is_wide:
            exact = (np.asarray(c.wide_hi), np.asarray(c.wide_lo), c.wide_kind)
        cols[name] = (np.asarray(c.data), np.asarray(c.mask), c.vocab, c.dtype_name, exact)
    return table_from_numpy_columns(cols, jt.nrows)


def income_frame(n: int, seed: int = 7):
    """The income schema of examples/_data.py at ``n`` rows, with the
    columns the drift bench drops removed."""
    from examples._data import synthesize

    return synthesize(n, seed=seed).drop(columns=["ifa", "dt_1", "dt_2", "empty", "logfnl"])


def assert_frames_close(got, exp, exact_cols=(), rtol=0.0, atol=0.0):
    """Same columns and rows; ``exact_cols`` equal, the numeric rest within
    rtol/atol, everything else equal as strings."""
    import pandas as pd

    assert list(got.columns) == list(exp.columns)
    assert len(got) == len(exp)
    for c in got.columns:
        g, e = got[c], exp[c]
        if c not in exact_cols and pd.api.types.is_numeric_dtype(e) and pd.api.types.is_numeric_dtype(g):
            np.testing.assert_allclose(g.to_numpy(np.float64), e.to_numpy(np.float64),
                                       rtol=rtol, atol=atol, equal_nan=True, err_msg=c)
        else:
            assert [None if pd.isna(v) else str(v) for v in g] == \
                [None if pd.isna(v) else str(v) for v in e], c


def hist_inputs(rows, k, nbins, seed, nan_rows=(), dead_cols=()):
    g = np.random.default_rng(seed)
    X = g.normal(50, 20, (rows, k)).astype(np.float32)
    M = g.random((rows, k)) > 0.1
    cuts = np.sort(g.normal(50, 20, (k, nbins - 1)), axis=1).astype(np.float32)
    # values sitting exactly on a cutoff must go to the lower bin
    X[: min(rows, nbins - 1), 0] = cuts[0, : min(rows, nbins - 1)]
    for j in nan_rows:
        cuts[j] = np.nan
    for j in dead_cols:
        M[:, j] = False
    return X, M, cuts


HIST_CASES = [
    (5000, 6, 10, (), ()),
    (2049, 3, 10, (1,), ()),  # ragged tile + NaN cutoff row → bin 0
    (1, 2, 10, (), (1,)),  # one row, all-masked column
    (4097, 4, 2, (), (0,)),
    (3000, 5, 32, (4,), (2,)),
]


def assert_close(got, exp, rtol, atol, what):
    """|got - exp| <= atol + rtol·|exp| elementwise, atol per column."""
    err = np.abs(got.astype(np.float64) - exp.astype(np.float64))
    bound = np.asarray(atol, np.float64) + rtol * np.abs(exp.astype(np.float64))
    assert np.all(err <= bound), f"{what}: err {err} > bound {bound}"


def moment_inputs(rows, seed):
    g = np.random.default_rng(seed)
    X = np.stack([g.normal(1e5, 3.0, rows), g.exponential(5, rows), g.normal(0, 1, rows),
                  np.where(g.random(rows) < 0.3, 0.0, g.gamma(2, 3, rows))], 1).astype(np.float32)
    M = g.random((rows, 4)) > 0.1
    M[0, 0] = False  # the large-mean column starts with a null
    M[:, 2] = False if rows < 3000 else M[:, 2]
    X[~M] = 0.0  # a null is stored as 0, as in the Table
    return X, M


def assert_moments_close(got, exp, rtol):
    """Two (8, k) moment accumulators [n, mean, M2, M3, M4, min, max,
    nonzero]: n/min/max/nonzero equal; mean within rtol·(|mean| + σ); M2,
    M3, M4 within rtol relative plus rtol · n · σ^p (central sums of
    near-symmetric data sit near 0, where a relative band alone says
    nothing) plus the shift a rounded tile mean gives them.

    The plain version and the Pallas kernel take a two-pass sum over each
    2048-row tile; the summation order moves a tile mean by a few ulps of
    the tile sum over 2048, Δ ≤ 4 · spacing(|mean| · 2048) / 2048 (0.03 for
    a normal(1e5, 3) column, 2e-6 for a mean near 5), and a central sum
    around a mean off by Δ moves by its binomial terms: n·Δ² for M2,
    3·Δ·M2 + n·Δ³ for M3, 4·Δ·|M3| + 6·Δ²·M2 + n·Δ⁴ for M4."""
    for row in (0, 5, 6, 7):
        np.testing.assert_array_equal(got[row], exp[row])
    e = exp.astype(np.float64)
    n = np.maximum(e[0], 1)
    sigma = np.sqrt(np.maximum(e[2], 0) / n)
    d = 4 * np.spacing(np.abs(e[1] * 2048).astype(np.float32)).astype(np.float64) / 2048
    assert_close(got[1], exp[1], rtol, rtol * sigma, "mean")
    assert_close(got[2], exp[2], rtol, rtol * n * sigma ** 2 + n * d ** 2, "M2")
    assert_close(got[3], exp[3], rtol, rtol * n * sigma ** 3 + 3 * d * e[2] + n * d ** 3, "M3")
    assert_close(got[4], exp[4], rtol,
                 rtol * n * sigma ** 4 + 4 * d * np.abs(e[3]) + 6 * d ** 2 * e[2] + n * d ** 4, "M4")
