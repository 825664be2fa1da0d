"""The port's model-based imputers against the JAX package's: the KNN
tile (``ops/knn.py``), ALS (``ops/als.py``), the iterative ridge,
``imputation_sklearn`` (KNN and regression, with their npz models crossing
between the packages), ``imputation_matrixFactorization``,
``auto_imputation`` and ``nullColumns_detection``'s model-based
treatments.

The frames have 2,048 rows, a row count the JAX Table does not pad, so
``auto_imputation``'s holdout (numpy ``default_rng(0)`` over the block's
shape) and ALS's starting factors (drawn over the padded block) are the
same draws in both packages.  ALS starts from the JAX package's
``jax.random`` factors (the port draws its own from a ``torch.Generator``).

Bands: KNN values within 1e-5 relative (the same donors; the mean of 5
in another order); the ridge coefficients within 1e-4·(1 + |β|) and its
imputed values within 5e-5·(1 + |x|) on well-conditioned columns (f32
normal equations summed in another order), 2e-4 relative on the frame's
nearly collinear ones (y = 2x + noise: a condition number near 150 over
f32's 6e-8, on a raw Gram 12 times the centred one), their coefficients
within 1e-3 of the largest; ALS completions within 1e-4 absolute on standardized data
(20 alternating f32 solves); ``auto_imputation``'s scores within 1e-4
relative, the same choice.  The JAX package runs its moments through its
XLA reference on the CPU."""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, jax_and_port, torch_cpu_runtime  # noqa: F401

ROWS = 2048


@pytest.fixture(scope="module")
def frame():
    """Correlated columns (so the model-based methods beat the mean), 10%
    nulls in two of them, 3% in a third, a categorical column."""
    g = np.random.default_rng(5)
    x = g.normal(10, 3, ROWS)
    df = pd.DataFrame({"x": x, "y": 2 * x + g.normal(0, 0.5, ROWS), "z": -x + g.normal(0, 0.5, ROWS),
                       "w": g.exponential(4.0, ROWS), "cat": g.choice(["a", "b", "c"], ROWS)})
    df.loc[g.random(ROWS) < 0.1, "y"] = np.nan
    df.loc[g.random(ROWS) < 0.1, "z"] = np.nan
    df.loc[g.random(ROWS) < 0.03, "w"] = np.nan
    return df


def _block(seed, rows, k, null=0.2):
    g = np.random.default_rng(seed)
    X = g.normal(0, 1, (rows, k)).astype(np.float32) * np.arange(1, k + 1, dtype=np.float32) + 5
    M = g.random((rows, k)) > null
    return np.where(M, X, 0).astype(np.float32), M


@pytest.mark.parametrize("features", [None, [1, 3]])
def test_knn_tile_matches_jax(features):
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.knn import knn_impute_tile as jknn
    from anovos_tpu_torch.ops.knn import knn_impute_tile as pknn

    Xq, Mq = _block(1, 300, 4)
    Xs, Ms = _block(2, 700, 4)
    exp = np.asarray(jknn(jnp.asarray(Xq), jnp.asarray(Mq), jnp.asarray(Xs), jnp.asarray(Ms)))
    got = pknn(torch.from_numpy(Xq), torch.from_numpy(Mq), torch.from_numpy(Xs), torch.from_numpy(Ms),
               features=features).numpy()
    np.testing.assert_allclose(got, exp[:, features] if features else exp, rtol=1e-5, atol=1e-6)


def _knn_reference(Xq, Mq, Xs, Ms, K=5):
    """float64 nan-euclidean KNN; ties toward the lower fit row."""
    k = Xq.shape[1]
    out = np.zeros(Xq.shape)
    for i in range(len(Xq)):
        both = Mq[i][None, :] & Ms
        d2 = np.where(both, (Xq[i][None, :] - Xs) ** 2, 0.0).sum(1) * k / np.maximum(both.sum(1), 1)
        d2[both.sum(1) == 0] = np.inf
        for j in range(k):
            dj = np.where(Ms[:, j], d2, np.inf)
            order = np.lexsort((np.arange(len(dj)), dj))[:K]
            sel = order[np.isfinite(dj[order])]
            out[i, j] = Xs[sel, j].mean() if len(sel) else 0.0
    return out


def test_knn_tie_case_takes_the_lower_rows():
    """Integer points whose f32 distances are exact: many donors tie at
    the 5th distance (duplicated rows and rows at equal distance).  Both
    packages take the lower fit rows first (``lax.top_k``'s order; the
    port breaks the tie explicitly, since ``torch.topk`` leaves it open),
    so both equal the float64 reference with that rule, and differ from
    taking the higher rows."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.knn import knn_impute_tile as jknn
    from anovos_tpu_torch.ops.knn import knn_impute_tile as pknn

    g = np.random.default_rng(9)
    Xs = g.integers(0, 4, (54, 3)).astype(np.float32)
    Xs[:, 0] = np.arange(54) % 7  # the feature to impute: donors differ in it
    # 10 duplicated rows; 64 fit rows keep the fit-set mean, and so every
    # centred value and distance, exact in f32
    Xs = np.concatenate([Xs, Xs[:10]])
    Ms = np.ones_like(Xs, bool)
    Xq = g.integers(0, 4, (40, 3)).astype(np.float32)
    Mq = np.ones_like(Xq, bool)
    Mq[:, 0] = False
    exp = np.asarray(jknn(jnp.asarray(Xq), jnp.asarray(Mq), jnp.asarray(Xs), jnp.asarray(Ms)))[:, 0]
    got = pknn(torch.from_numpy(Xq), torch.from_numpy(Mq), torch.from_numpy(Xs), torch.from_numpy(Ms),
               features=[0]).numpy()[:, 0]
    ref = _knn_reference(Xq.astype(np.float64), Mq, Xs.astype(np.float64), Ms)[:, 0]
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    rev = _knn_reference(Xq.astype(np.float64), Mq, Xs[::-1].astype(np.float64), Ms[::-1])[:, 0]
    assert (np.abs(rev - ref) > 1e-3).sum() >= 5  # the tie rule decides these rows


def _jax_factors(Z, M, rank, seed=0):
    """The starting column factors of the JAX package's als_impute (its
    row factors, drawn too, are solved over before they are read)."""
    import jax
    import jax.numpy as jnp
    import torch

    k = Z.shape[1]
    _, k2 = jax.random.split(jax.random.PRNGKey(seed))
    scale = jnp.sqrt(jnp.abs(jnp.where(jnp.asarray(M), jnp.asarray(Z), 0.0)).mean() / max(rank, 1) + 1e-6)
    return torch.from_numpy(np.asarray(jax.random.normal(k2, (k, rank), jnp.float32) * scale))


def _jax_draws(monkeypatch):
    """The port's ALS started from the JAX package's factors."""
    from anovos_tpu_torch.ops import als

    monkeypatch.setattr(als, "init_factors", lambda X, M, rank, seed: _jax_factors(X.numpy(), M.numpy(), rank, seed))


def test_als_matches_jax(monkeypatch):
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.als import als_impute as jals
    from anovos_tpu_torch.ops.als import als_impute as pals

    X, M = _block(4, 500, 6, null=0.3)
    Z = np.where(M, (X - X.mean(0)) / X.std(0), 0).astype(np.float32)
    exp = np.asarray(jals(jnp.asarray(Z), jnp.asarray(M), rank=4, iters=20, reg=0.01))
    # its own draws: a completion of the same quality on the observed cells
    own = pals(torch.from_numpy(Z), torch.from_numpy(M), rank=4, iters=20, reg=0.01).numpy()
    _jax_draws(monkeypatch)
    got = pals(torch.from_numpy(Z), torch.from_numpy(M), rank=4, iters=20, reg=0.01).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-4)
    err = lambda C: float(np.sqrt(np.mean((C[M] - Z[M]) ** 2)))  # noqa: E731
    assert err(own) < 1.25 * err(exp)


def test_iterative_ridge_matches_jax_and_float64():
    import jax.numpy as jnp
    import torch

    from anovos_tpu.data_transformer.imputers import _apply_iterative_ridge as japply
    from anovos_tpu.data_transformer.imputers import _fit_iterative_ridge as jfit
    from anovos_tpu_torch.data_transformer.imputers import _apply_iterative_ridge, _fit_iterative_ridge

    g = np.random.default_rng(8)
    x = g.normal(10, 3, 1500)
    X = np.stack([x, 0.5 * x + g.normal(0, 2, 1500), -0.3 * x + g.normal(0, 2, 1500),
                  g.normal(5, 2, 1500)], 1)
    M = g.random(X.shape) > 0.15
    X = np.where(M, X, 0).astype(np.float32)
    jm, jc = (np.asarray(a) for a in jfit(jnp.asarray(X), jnp.asarray(M)))
    pm, pc = (a.numpy() for a in _fit_iterative_ridge(torch.from_numpy(X), torch.from_numpy(M)))
    np.testing.assert_allclose(pm, jm, rtol=1e-6)
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-4 * (1 + np.abs(jc)).max())
    got = _apply_iterative_ridge(torch.from_numpy(X), torch.from_numpy(M), torch.from_numpy(pm),
                                 torch.from_numpy(pc)).numpy()
    exp = np.asarray(japply(jnp.asarray(X), jnp.asarray(M), jnp.asarray(jm), jnp.asarray(jc)))
    np.testing.assert_allclose(got, exp, rtol=5e-5, atol=5e-5)
    # float64: column 1 on the others over its observed rows, once the
    # others' cells are filled as the fit left them (least squares)
    Xf = got.astype(np.float64)
    rows = M[:, 1]
    A = np.concatenate([np.delete(Xf[rows], 1, axis=1), np.ones((rows.sum(), 1))], 1)
    beta = np.linalg.lstsq(A, Xf[rows, 1], rcond=None)[0]
    np.testing.assert_allclose(np.delete(pc[1, :4], 1), beta[:3], rtol=0, atol=2e-3)
    np.testing.assert_allclose(pc[1, 4], beta[3], rtol=0, atol=2e-2)


@pytest.mark.parametrize("method,kw", [("KNN", {}), ("KNN", {"sample_size": 500}), ("regression", {})])
def test_imputation_sklearn_matches_jax(frame, method, kw, tmp_path):
    from anovos_tpu.data_transformer.imputers import imputation_sklearn as jimp
    from anovos_tpu_torch.data_transformer.imputers import imputation_sklearn as pimp

    jt, pt = jax_and_port(frame)
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    exp = jimp(jt, method_type=method, model_path=jp, output_mode="append", **kw)
    got = pimp(pt, method_type=method, model_path=pp, output_mode="append", **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    assert [c for c in got.col_names if c.endswith("_imputed")] == ["y_imputed", "z_imputed", "w_imputed"]
    g, e = got.to_pandas(), exp.to_pandas()
    assert not g[["y_imputed", "z_imputed", "w_imputed"]].isna().any().any()
    tol = 1e-5 if method == "KNN" else 2e-4
    assert_frames_close(g, e, rtol=tol, atol=tol)
    name = f"imputation_sklearn_{method}.npz"
    with np.load(os.path.join(pp, name)) as a, np.load(os.path.join(jp, name)) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["feat_cols"].tolist() == b["feat_cols"].tolist()
        for f in a.files:
            if f == "coefs":  # the collinear columns' coefficients: 1e-3 of the largest
                np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-3 * (1 + np.abs(b[f]).max()))
            elif f != "feat_cols":
                np.testing.assert_allclose(a[f], b[f], rtol=1e-5, atol=1e-5)
    for mp in (jp, pp):
        kw2 = dict(method_type=method, pre_existing_model=True, model_path=mp)
        assert_frames_close(pimp(pt, **kw2).to_pandas(), jimp(jt, **kw2).to_pandas(), rtol=tol, atol=tol)


def test_imputation_matrix_factorization_matches_jax(frame, monkeypatch):
    from anovos_tpu.data_transformer.imputers import imputation_matrixFactorization as jmf
    from anovos_tpu_torch.data_transformer.imputers import imputation_matrixFactorization as pmf

    _jax_draws(monkeypatch)
    jt, pt = jax_and_port(frame)
    exp, got = jmf(jt, output_mode="append"), pmf(pt, output_mode="append")
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    g, e = got.to_pandas(), exp.to_pandas()
    sd = frame[["y", "z", "w"]].std().to_numpy()
    for c, s in zip(("y", "z", "w"), sd):
        np.testing.assert_allclose(g[c + "_imputed"], e[c + "_imputed"], rtol=0, atol=1e-4 * s, err_msg=c)


def test_auto_imputation_matches_jax(frame):
    """The same holdout (2,048 rows), the five scores within 1e-4 relative,
    the same choice, the same output."""
    import logging

    from anovos_tpu.data_transformer.imputers import auto_imputation as jauto
    from anovos_tpu_torch.data_transformer import imputers as pimp

    jt, pt = jax_and_port(frame)
    scores = pimp.auto_imputation_scores(pt, ["y", "z", "w"])
    assert sorted(scores) == ["KNN", "MF", "MMM_mean", "MMM_median", "regression"]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    jlog = logging.getLogger("anovos_tpu.data_transformer.imputers")
    jlog.addHandler(handler)
    old = jlog.level
    jlog.setLevel(logging.INFO)
    try:
        exp = jauto(jt, output_mode="append")
    finally:
        jlog.removeHandler(handler)
        jlog.setLevel(old)
    msg = records[-1].getMessage()
    jscores = eval(msg[msg.index("{"): msg.index("}") + 1])  # noqa: S307 (the JAX log line's dict)
    best = min(scores, key=scores.get)
    assert msg.endswith("→ " + best)
    for k, v in jscores.items():
        if k != "MF":  # ALS starts from other draws in the two packages
            assert abs(round(scores[k], 4) - v) <= 1e-4 * max(v, 1) + 1e-4, k
    got = pimp.auto_imputation(pt, output_mode="append")
    assert_frames_close(got.to_pandas(), exp.to_pandas(), rtol=2e-4, atol=2e-4)


def test_auto_imputation_without_holdout_takes_the_median(frame):
    from anovos_tpu_torch.data_transformer.imputers import auto_imputation
    from anovos_tpu_torch.data_transformer.transformers import imputation_MMM

    _, pt = jax_and_port(frame)
    a = auto_imputation(pt, list_of_cols=["y"], null_pct=0.0).to_pandas()
    b = imputation_MMM(pt, list_of_cols=["y"], method_type="median").to_pandas()
    pd.testing.assert_frame_equal(a, b)


@pytest.mark.parametrize("method", ["KNN", "regression", "MF", "auto"])
def test_null_columns_treatments_match_jax(frame, method, monkeypatch):
    from anovos_tpu.data_analyzer.quality_checker import nullColumns_detection as jnull
    from anovos_tpu_torch.data_analyzer.quality_checker import nullColumns_detection as pnull

    _jax_draws(monkeypatch)
    num = frame.drop(columns=["cat"])
    jt, pt = jax_and_port(num)
    (po, ps), (jo, js) = (pnull(pt, list_of_cols="all", treatment=True, treatment_method=method),
                          jnull(jt, list_of_cols="all", treatment=True, treatment_method=method))
    assert_frames_close(ps, js)
    assert po.col_names == jo.col_names and po.dtypes() == jo.dtypes()
    assert not po.to_pandas().isna().any().any()
    assert_frames_close(po.to_pandas(), jo.to_pandas(), rtol=1e-4, atol=1e-4 * float(num.std().max()))


def test_ridge_on_large_means_keeps_its_bits():
    """Columns of mean 1e4 and σ ≈ 1: the JAX package's raw Gram less
    n·āāᵀ cancels away every f32 bit of the centred system, the port's
    centred scatter keeps them (ROADMAP.md Queue C).  Against float64
    least squares, the port's slope within 1e-3, JAX's off by more than
    0.1."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.data_transformer.imputers import _fit_iterative_ridge as jfit
    from anovos_tpu_torch.data_transformer.imputers import _fit_iterative_ridge

    g = np.random.default_rng(12)
    x = g.normal(1e4, 1.0, 4096)
    X = np.stack([x, x + g.normal(0, 0.5, 4096)], 1)
    M = np.ones(X.shape, bool)
    M[g.random(4096) < 0.1, 1] = False
    X32 = np.where(M, X, 0).astype(np.float32)
    X64 = X32.astype(np.float64)
    rows = M[:, 1]
    slope = np.linalg.lstsq(np.stack([X64[rows, 0], np.ones(rows.sum())], 1), X64[rows, 1], rcond=None)[0][0]
    got = _fit_iterative_ridge(torch.from_numpy(X32), torch.from_numpy(M))[1].numpy()[1, 0]
    exp = np.asarray(jfit(jnp.asarray(X32), jnp.asarray(M))[1])[1, 0]
    assert abs(got - slope) < 1e-3 * abs(slope)
    assert not abs(exp - slope) < 0.1 * abs(slope)


def test_all_null_column_predicts_nothing():
    """An all-null numeric column: the JAX ridge's NaN mean makes every
    imputed cell NaN; the port fills it with 0, so it imputes as without
    the column (ROADMAP.md Queue C)."""
    from anovos_tpu.data_transformer.imputers import imputation_sklearn as jimp
    from anovos_tpu_torch.data_transformer.imputers import imputation_sklearn as pimp

    g = np.random.default_rng(13)
    x = g.normal(10, 3, ROWS)
    df = pd.DataFrame({"x": x, "y": 0.5 * x + g.normal(0, 1, ROWS), "empty": np.nan})
    df.loc[g.random(ROWS) < 0.1, "y"] = np.nan
    jt, pt = jax_and_port(df)
    exp = jimp(jt, list_of_cols=["y"], method_type="regression").to_pandas()
    got = pimp(pt, list_of_cols=["y"], method_type="regression").to_pandas()
    assert exp["y"].isna().sum() == df["y"].isna().sum() > 0
    without = pimp(jax_and_port(df.drop(columns=["empty"]))[1], list_of_cols=["y"],
                   method_type="regression").to_pandas()
    np.testing.assert_allclose(got["y"], without["y"], rtol=1e-5)
