"""The port's elementwise transformers against the JAX package's on the
same frames: ``feature_transformation`` (all 25 ops), ``boxcox_transformation``
(its KS statistic, the λ search and the apply) and ``expression_parser``
(every whitelisted function).

Nulls (a null input or a non-finite result) must be equal.  Values: the
ops both packages compute exactly the same way (powers by products,
floor/ceil, floored modulo, half-to-even rounding, affine scaling) are
equal; the transcendental ones are held to 2e-6 relative (about 16 f32
ulps, the two libraries' approximations); the port's cube root,
sign(x)·|x|^(1/3), to 1e-6 relative of ``jnp.cbrt``; factorial,
exp(lgamma(x + 1)), to 1e-5 relative (its relative error is lgamma's
absolute error, at values up to 12! here); roundN to one ulp (2^-23
relative): XLA divides by 10^N as a product with the f32 reciprocal, the
port divides.  The JAX package runs
its moments through its XLA reference on the CPU."""

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, jax_and_port, torch_cpu_runtime  # noqa: F401

EXACT = ("sq", "cb", "floor", "ceil", "mul_inv", "remainderDivByN")
TRANSCENDENTAL_RTOL = 2e-6


@pytest.fixture(scope="module")
def frame():
    """Signed, positive and integer-valued columns with nulls and zeros,
    values on .25 steps (ties of roundN at 1 decimal) included."""
    g = np.random.default_rng(17)
    n = 400
    signed = g.uniform(-5, 5, n)
    signed[:20] = np.arange(-10, 10) / 4.0
    signed[20:25] = 0.0
    pos = g.lognormal(1.0, 1.2, n)
    ints = g.integers(-3, 12, n).astype(float)
    df = pd.DataFrame({"signed": signed, "pos": pos, "ints": ints, "cat": g.choice(["a", "b"], n)})
    for c in ("signed", "pos", "ints"):
        df.loc[g.random(n) < 0.05, c] = np.nan
    return df


OPS = ["ln", "log10", "log2", "exp", "powOf2", "powOf10", "sqrt", "cbrt", "sq", "cb", "sin", "cos",
       "tan", "asin", "acos", "atan", "radians", "factorial", "mul_inv", "floor", "ceil"]
OPS_N = [("powOfN", 3), ("toPowerN", 2.5), ("remainderDivByN", 3), ("roundN", 1)]


@pytest.mark.parametrize("method,N", [(m, None) for m in OPS] + OPS_N)
def test_feature_transformation_matches_jax(frame, method, N):
    from anovos_tpu.data_transformer.transformers import feature_transformation as jft
    from anovos_tpu_torch.data_transformer.transformers import feature_transformation as pft

    jt, pt = jax_and_port(frame)
    kw = dict(method_type=method, N=N, output_mode="append")
    exp, got = jft(jt, **kw), pft(pt, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    rtol = {"cbrt": 1e-6, "factorial": 1e-5, "roundN": 2.0 ** -23}.get(
        method, 0.0 if method in EXACT else TRANSCENDENTAL_RTOL)
    g, e = got.to_pandas(), exp.to_pandas()
    for c in [c for c in g.columns if c not in frame.columns]:
        assert g[c].isna().tolist() == e[c].isna().tolist(), c
    assert_frames_close(g, e, rtol=rtol, atol=1e-30)


def test_feature_transformation_replace_and_errors(frame):
    from anovos_tpu_torch.data_transformer.transformers import feature_transformation

    _, pt = jax_and_port(frame)
    out = feature_transformation(pt, ["pos"], method_type="sqrt")
    assert out.col_names == pt.col_names
    np.testing.assert_allclose(out.to_pandas()["pos"], np.sqrt(frame["pos"].astype(np.float32)),
                               rtol=2.4e-7)  # 2 ulps: torch's vectorized CPU sqrt
    with pytest.raises(TypeError):
        feature_transformation(pt, ["pos"], method_type="powOfN")
    with pytest.raises(TypeError):
        feature_transformation(pt, ["pos"], method_type="nope")
    with pytest.raises(TypeError):
        feature_transformation(pt, ["cat"], method_type="sqrt")


def test_remainder_is_floored_and_round_is_half_even():
    """remainderDivByN takes the divisor's sign (Python's %), roundN rounds
    half to even, as jnp does."""
    import torch

    from anovos_tpu_torch.data_transformer.transformers import _MATH_OPS_N

    x = torch.tensor([-7.0, -1.5, 0.0, 2.5, 7.0, 0.25, 0.35, -0.25])
    np.testing.assert_array_equal(_MATH_OPS_N["remainderDivByN"](x, 3).numpy(),
                                  np.array([-7.0, -1.5, 0.0, 2.5, 7.0, 0.25, 0.35, -0.25], np.float32) % 3)
    np.testing.assert_array_equal(_MATH_OPS_N["roundN"](torch.tensor([0.5, 1.5, 2.5, -0.5]), 0).numpy(),
                                  [0.0, 2.0, 2.0, -0.0])


@pytest.fixture(scope="module")
def boxcox_frame():
    """Columns whose best λ is clear (KS margins far above f32 noise):
    lognormal (λ = 0), normal shifted positive (λ = 1), its square
    (λ = 0.5), its reciprocal (λ = -1), an all-negative normal."""
    g = np.random.default_rng(23)
    n = 3000
    z = g.normal(20, 2, n)
    df = pd.DataFrame({"lognorm": g.lognormal(0.0, 0.8, n), "norm": z, "sq": z ** 2,
                       "recip": 1.0 / z, "neg": -g.normal(20, 2, n)})
    df.loc[g.random(n) < 0.05, "lognorm"] = np.nan
    return df


def test_ks_statistic_matches_jax(boxcox_frame):
    import jax.numpy as jnp
    import torch

    from anovos_tpu.data_transformer.transformers import _ks_vs_normal as jks
    from anovos_tpu_torch.data_transformer.transformers import _ks_vs_normal as pks

    X = boxcox_frame.to_numpy(np.float32)
    M = ~np.isnan(X)
    X = np.where(M, X, 0.0).astype(np.float32)
    exp = np.asarray(jks(jnp.asarray(X), jnp.asarray(M)))
    got = pks(torch.from_numpy(X), torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=2e-6)
    # against scipy in float64
    from scipy import stats

    for j in range(X.shape[1]):
        v = X[M[:, j], j].astype(np.float64)
        ref = stats.kstest((v - v.mean()) / v.std(ddof=1), "norm").statistic
        assert abs(got[j] - ref) < 2e-5


def test_boxcox_lambdas_and_values_match_jax(boxcox_frame):
    """The λ of each column equals JAX's, every column's best KS beats the
    runner-up by far more than f32 noise, and the transformed values agree
    within TRANSCENDENTAL_RTOL."""
    import torch

    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    jt, pt = jax_and_port(boxcox_frame)
    cols = list(boxcox_frame.columns)
    X, M = pt.numeric_block(cols)
    lam = ptr._boxcox_fit_lambdas(X, M, len(cols))
    jX, jM = jt.numeric_block(cols)
    np.testing.assert_array_equal(lam, jtr._boxcox_fit_lambdas(jX, jM, len(cols)))
    # the all-negative column: ln leaves no valid value, whose KS is 0, so
    # λ = 0 wins there (and the apply nulls the column), in both packages
    np.testing.assert_array_equal(lam, [0.0, 1.0, 0.5, -1.0, 0.0])
    ks = np.stack([ptr._ks_vs_normal(*(lambda Y: (torch.where(M & torch.isfinite(Y), Y, 0.0),
                                                   M & torch.isfinite(Y)))(ptr._boxcox_power(X, lmb))).numpy()
                   for lmb in ptr._BOXCOX_LAMBDAS])
    srt = np.sort(ks, axis=0)
    assert (srt[1] - srt[0] > 1e-4).all(), srt[:2]
    exp, got = jtr.boxcox_transformation(jt, output_mode="append"), ptr.boxcox_transformation(pt, output_mode="append")
    assert got.col_names == exp.col_names
    g, e = got.to_pandas(), exp.to_pandas()
    for c in cols:
        assert g[c + "_bxcx"].isna().tolist() == e[c + "_bxcx"].isna().tolist(), c
    assert_frames_close(g, e, rtol=TRANSCENDENTAL_RTOL, atol=1e-30)
    # given λs: one for all, one a column
    for lam_arg in (0.5, [1.0, 2.0, 0.0, -0.5, 3.0]):
        assert_frames_close(ptr.boxcox_transformation(pt, boxcox_lambda=lam_arg).to_pandas(),
                            jtr.boxcox_transformation(jt, boxcox_lambda=lam_arg).to_pandas(),
                            rtol=TRANSCENDENTAL_RTOL, atol=1e-30)


EXPRESSIONS = [
    "log(pos) + 1.5", "ln(pos) * 2", "log2(pos)", "log10(pos)", "exp(signed)", "sqrt(pos)", "cbrt(signed)",
    "abs(signed) - 1", "sin(signed)", "cos(signed)", "tan(signed)", "asin(signed / 5)",
    "acos(signed / 5)", "atan(signed)", "sinh(signed)", "cosh(signed)", "tanh(signed)", "floor(signed)",
    "ceil(signed)", "round(signed)", "pow(pos, 2)", "sign(signed)", "greatest(signed, ints)",
    "least(signed, ints)", "signed > 1.5", "(signed > 0) & (ints < 5)", "2 ** ints", "ints % 3",
    "ints // 2", "pos if 1 else signed", "-signed + ~(ints > 3)", "3", "sqrt(4) + signed",
]


def test_expression_parser_matches_jax(frame):
    from anovos_tpu.data_transformer.transformers import expression_parser as jexp
    from anovos_tpu_torch.data_transformer.transformers import expression_parser as pexp

    jt, pt = jax_and_port(frame)
    exp, got = jexp(jt, EXPRESSIONS, postfix="_e"), pexp(pt, EXPRESSIONS, postfix="_e")
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    g, e = got.to_pandas(), exp.to_pandas()
    for c in [c for c in g.columns if c not in frame.columns]:
        assert g[c].isna().tolist() == e[c].isna().tolist(), c
    assert_frames_close(g, e, rtol=TRANSCENDENTAL_RTOL, atol=1e-30)


def test_expression_parser_special_names_and_pipe_string():
    """Column names with special characters are matched longest first; a
    string input splits at '|'."""
    from anovos_tpu.data_transformer.transformers import expression_parser as jexp

    df = pd.DataFrame({"a-b": [1.0, 4.0, np.nan], "a": [2.0, 3.0, 5.0], "a-b c": [9.0, 16.0, 25.0]})
    jt, pt = jax_and_port(df)
    from anovos_tpu_torch.data_transformer.transformers import expression_parser as pexp

    expr = "sqrt(a-b c) + a-b * a|a - 1"
    assert_frames_close(pexp(pt, expr).to_pandas(), jexp(jt, expr).to_pandas(), rtol=0, atol=0)


def test_boxcox_exact_tie_takes_the_first_lambda():
    """A 0/1 column (the income schema's ``label``): every positive λ maps
    it to itself, so their KS statistics tie exactly; both packages keep
    the first λ of the grid, 1.0 (the tie chip_smoke.py phase 10a meets on
    4M rows; ROADMAP Queue C)."""
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    g = np.random.default_rng(29)
    df = pd.DataFrame({"label": g.integers(0, 2, 2000).astype(float)})
    jt, pt = jax_and_port(df)
    X, M = pt.numeric_block(["label"])
    jX, jM = jt.numeric_block(["label"])
    assert ptr._boxcox_fit_lambdas(X, M, 1).tolist() == jtr._boxcox_fit_lambdas(jX, jM, 1).tolist() == [1.0]
