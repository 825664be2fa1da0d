"""The port's masked correlation and covariance, and ``correlation_matrix``,
against the JAX package's on the same seeded inputs with nulls.  Both
centre every column by its masked mean before five f32 products, so they
agree to a few f32 ulps of the statistics: 1e-5 absolute on r, 1e-5
relative on the covariance (both scale-free bands of the f32 products'
rounding, well above either package's summation-order noise).  Under
``ANOVOS_TPU_BF16=1`` each package rounds its own centred values to bf16,
so they agree within the JAX package's bf16 band (tests/test_mxu_bf16.py):
2e-2 on r, 2e-2 of the largest variance on the covariance."""

import numpy as np
import pytest

from _torch_port import income_frame, torch_cpu_runtime  # noqa: F401


def corr_inputs(rows=3000, seed=4):
    """Five columns, 10% nulls: correlated normals, a year-like column
    (large offset, spread of a few units), a skewed one, and a column
    valid in under half the rows."""
    g = np.random.default_rng(seed)
    a = g.normal(0, 1, rows)
    X = np.stack([a, 0.8 * a + g.normal(0, 0.6, rows), 2015 + np.round(a * 3 + g.normal(0, 1, rows)),
                  g.exponential(5, rows), g.normal(1e5, 3, rows)], 1).astype(np.float32)
    M = g.random((rows, 5)) > 0.1
    M[:, 4] &= g.random(rows) > 0.5
    X[~M] = 0.0
    return X, M


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fn", ["masked_corr", "masked_cov", "masked_corr_cc"])
def test_masked_products_match_jax(fn, bf16, monkeypatch):
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import correlation as jc
    from anovos_tpu_torch.ops import correlation as pc

    monkeypatch.setenv("ANOVOS_TPU_BF16", "1" if bf16 else "0")
    X, M = corr_inputs()
    jargs = (jnp.asarray(X), jnp.asarray(M)) + ((X.shape[1],) if fn == "masked_corr_cc" else ())
    exp = np.asarray(getattr(jc, fn)(*jargs), np.float64)
    got = getattr(pc, fn)(torch.from_numpy(X), torch.from_numpy(M)).numpy().astype(np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(exp))
    if bf16:
        scale = float(np.nanmax(np.abs(np.diag(exp)))) if fn == "masked_cov" else 1.0
        np.testing.assert_allclose(got, exp, rtol=0, atol=2e-2 * scale, equal_nan=True)
    elif fn == "masked_cov":
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=0, equal_nan=True)
    else:
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5, equal_nan=True)
    if fn == "masked_corr" and not bf16:
        # the year-like column keeps its correlation: float64 pairwise-complete r
        both = M[:, 0] & M[:, 2]
        r = np.corrcoef(X[both, 0].astype(np.float64), X[both, 2].astype(np.float64))[0, 1]
        assert abs(got[0, 2] - r) <= 1e-5


def test_correlation_matrix_frame_matches_jax():
    from anovos_tpu.data_analyzer.association_evaluator import correlation_matrix as jcm
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.data_analyzer.association_evaluator import correlation_matrix as pcm
    from anovos_tpu_torch.shared.table import Table

    df = income_frame(3000, seed=5)
    exp = jcm(JTable.from_pandas(df), list_of_cols="all", drop_cols=["ifa"])
    got = pcm(Table.from_pandas(df, device="cpu"), list_of_cols="all", drop_cols=["ifa"])
    assert list(got.columns) == list(exp.columns)
    assert list(got["attribute"]) == list(exp["attribute"])
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(np.float64), exp.iloc[:, 1:].to_numpy(np.float64),
                               rtol=0, atol=1e-5)


def test_correlation_matrix_rejects_non_numeric_columns():
    from anovos_tpu_torch.data_analyzer.association_evaluator import correlation_matrix
    from anovos_tpu_torch.shared.table import Table

    t = Table.from_pandas(income_frame(50, seed=1), device="cpu")
    for cols in (["age", "workclass"], []):
        with pytest.raises(TypeError):
            correlation_matrix(t, cols)


def test_guarded_matmul_is_true_f32_and_restores_the_setting():
    """mm pins f32 matmuls to IEEE f32 for the call and gives back the
    caller's TF32 setting, whichever it was."""
    import torch

    from anovos_tpu_torch.ops.mxu import mm

    flags = torch.backends.cuda.matmul
    before = flags.fp32_precision
    a = torch.arange(6, dtype=torch.float32).view(2, 3)
    try:
        for setting in ("tf32", "ieee"):
            flags.fp32_precision = setting
            assert torch.equal(mm(a, a.t(), False), a @ a.t())
            assert flags.fp32_precision == setting
    finally:
        flags.fp32_precision = before


def test_correlation_of_wide_spread_columns_stays_finite():
    """A fault of the JAX package the port does not copy: its denominator
    sqrt(var_a · var_b) multiplies two n²σ² terms, which passes the f32
    maximum (3.4e38) here at 3,000 rows of σ = 1e7, as at 4,000,000 income
    rows for fnlwgt or capital-gain; its r is then 0.  The port takes the
    square roots apart."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.correlation import masked_corr as jcorr
    from anovos_tpu_torch.ops.correlation import masked_corr as pcorr

    g = np.random.default_rng(6)
    a = g.normal(0, 1e7, 3000)
    X = np.stack([a, a + g.normal(0, 1e7, 3000)], 1).astype(np.float32)
    M = np.ones(X.shape, bool)
    r = np.corrcoef(X.astype(np.float64).T)[0, 1]
    assert abs(float(pcorr(torch.from_numpy(X), torch.from_numpy(M))[0, 1]) - r) <= 1e-5
    assert float(np.asarray(jcorr(jnp.asarray(X), jnp.asarray(M)))[0, 1]) == 0.0
