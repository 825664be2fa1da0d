"""The port's small ops (reductions, quantiles, segment counts, cutoffs and
list helpers) against their JAX package counterparts on the same seeded
numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


def _block(rows=3001, k=4, seed=3):
    g = np.random.default_rng(seed)
    X = np.stack([g.normal(50, 20, rows), g.integers(0, 7, rows), g.exponential(3, rows),
                  g.normal(1e4, 2, rows)], 1).astype(np.float32)[:, :k]
    M = g.random((rows, k)) > 0.15
    M[:, min(2, k - 1)] &= np.arange(rows) < 40  # a sparse column
    return X, M


@pytest.mark.parametrize("fn", ["masked_count", "masked_mean", "masked_var"])
def test_reductions_match_jax(fn):
    """Count exactly; mean and variance within 1e-5 relative (f32 sums
    taken in another order)."""
    import anovos_tpu.ops.reductions as jr
    import anovos_tpu_torch.ops.reductions as tr

    X, M = _block()
    if fn == "masked_count":
        np.testing.assert_array_equal(tr.masked_count(torch.from_numpy(M)).numpy(),
                                      np.asarray(jr.masked_count(jnp.asarray(M))))
        return
    got = getattr(tr, fn)(torch.from_numpy(X), torch.from_numpy(M)).numpy()
    exp = np.asarray(getattr(jr, fn)(jnp.asarray(X), jnp.asarray(M)))
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("interpolation", ["lower", "linear"])
def test_quantiles_match_jax(interpolation):
    """'lower' picks elements of the column, so it is exact; 'linear' is
    one f32 interpolation, equal within 1 ulp."""
    from anovos_tpu.ops.quantiles import masked_quantiles as jq
    from anovos_tpu_torch.ops.quantiles import masked_quantiles

    X, M = _block()
    M[:, 0] = False  # an all-null column gives NaN
    qs = np.array([0.0, 0.01, 0.25, 0.5, 0.75, 0.99, 1.0], np.float32)
    got = masked_quantiles(torch.from_numpy(X), torch.from_numpy(M), qs, interpolation).numpy()
    exp = np.asarray(jq(jnp.asarray(X), jnp.asarray(M), jnp.asarray(qs), interpolation))
    if interpolation == "lower":
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=2 ** -23, equal_nan=True)


def test_median_matches_jax():
    from anovos_tpu.ops.quantiles import masked_median as jm
    from anovos_tpu_torch.ops.quantiles import masked_median

    X, M = _block(rows=2000)
    np.testing.assert_allclose(masked_median(torch.from_numpy(X), torch.from_numpy(M)).numpy(),
                               np.asarray(jm(jnp.asarray(X), jnp.asarray(M))), rtol=2 ** -23)


def test_code_counts_and_mode_match_jax():
    """Counts exactly; the mode is the lowest code among count ties."""
    from anovos_tpu.ops import segment as js
    from anovos_tpu_torch.ops import segment as ts

    g = np.random.default_rng(5)
    codes = g.integers(-1, 9, 4000).astype(np.int32)
    codes[:50] = 3  # 3 and 7 tie at the top
    codes[50:100] = 7
    M = g.random(4000) > 0.05
    counts = ts.code_counts(torch.from_numpy(codes), torch.from_numpy(M), 9)
    exp = np.asarray(js.code_counts(jnp.asarray(codes), jnp.asarray(M), 9))[:9]
    np.testing.assert_array_equal(counts.numpy(), exp)
    tie = torch.tensor([2.0, 5.0, 1.0, 5.0])
    code, n = ts.mode_from_counts(tie)
    jcode, jn = js.mode_from_counts(jnp.asarray(tie.numpy()))
    assert (int(code), float(n)) == (int(jcode), float(jn)) == (1, 5.0)
    code, n = ts.mode_from_counts(counts)
    jcode, jn = js.mode_from_counts(jnp.asarray(exp))
    assert (int(code), float(n)) == (int(jcode), float(jn))


def test_cutoffs_from_bounds_match_jax():
    """f32 lo + j·width on both sides.  XLA on the CPU may contract the
    product and sum to an FMA, which skips the rounding of j·width: the two
    differ by at most one ulp of j·width (more ulps of the cutoff itself
    where lo < 0 cancels part of the product)."""
    from anovos_tpu.ops.drift_kernels import cutoffs_from_bounds as jc
    from anovos_tpu_torch.ops.drift_kernels import cutoffs_from_bounds

    lo = np.array([0.0, -3.5, 1e5, 7.0], np.float32)
    hi = np.array([1.0, 12.25, 1e5 + 6, 7.0], np.float32)
    n = np.array([10, 5, 3, 0], np.int32)  # the last column has no valid value
    got = cutoffs_from_bounds(torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(n), 10)
    exp = np.asarray(jc(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(n), 10))
    assert got.dtype == torch.float32 and got.shape == (4, 9)
    assert np.isnan(got[3].numpy()).all() and np.isnan(exp[3]).all()
    j = np.arange(1, 10, dtype=np.float32)
    prod = j[None, :] * ((hi[:3] - lo[:3]) / np.float32(10))[:, None]
    assert np.all(np.abs(got[:3].numpy() - exp[:3]) <= np.spacing(np.abs(prod)))


@pytest.mark.parametrize("args", [
    ("all", ["a", "b", "c"], None),
    ("c|a| b", ["a", "b", "c"], "a"),
    (["b", "b", "c"], ["a", "b", "c"], ["c"]),
    ("a", ["a", "b"], "a|b"),
])
def test_parse_cols_matches_jax(args):
    from anovos_tpu.shared.utils import parse_cols as jp
    from anovos_tpu_torch.shared.utils import parse_cols

    assert parse_cols(*args) == jp(*args)


def test_pairwise_reduce_and_ends_with_match_jax():
    from anovos_tpu.shared import utils as ju
    from anovos_tpu_torch.shared import utils as tu

    for n in (1, 2, 5, 8):
        items = [f"x{i}" for i in range(n)]
        join = lambda a, b: f"({a}+{b})"  # noqa: E731  (order shows in the result)
        assert tu.pairwise_reduce(join, items) == ju.pairwise_reduce(join, items)
    with pytest.raises(ValueError):
        tu.pairwise_reduce(max, [])
    for s, e in (("a/b", "/"), ("a/b/", "/"), ("x.csv", ".csv"), ("", "/")):
        assert tu.ends_with(s, e) == ju.ends_with(s, e)
