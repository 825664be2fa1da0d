"""The port's latent features against the JAX package's: ``_prep_block``,
``PCA_latentFeatures`` and the autoencoder (``models/autoencoder.py`` and
``autoencoder_latentFeatures``).

Bands:
- ``_prep_block``: the median fill exact, the standardized values within
  2e-6·(1 + |z|) (f32 moments, PERF.md "Moment accumulation error");
- PCA: the same k; each component's loadings, sign-aligned (``eigh`` may
  return either sign), within 1e-4 absolute (the eigenvectors of two f32
  covariances whose entries agree to ~1e-6 relative; the spectrum's gaps
  here are ≥ 0.05 of the top eigenvalue), the projections within
  1e-4·(1 + |z|);
- the autoencoder, started from the same (JAX) parameters: a forward pass
  and the latents within 1e-5·(1 + |x|) (f32 matmuls in another order),
  three Adam steps' losses within 1e-5 relative and the parameters after
  them within 1e-5·(1 + |p|), but the dense biases whose shift a
  BatchNorm removes (all but the output's), whose exact gradient is 0
  (each package moves them by lr a step in the direction of its own
  rounding noise: within 3·lr of the start), and the BatchNorm running
  means, which take 0.01 of those biases' gap a step (within 3e-4);
- a model written by either package loads in the other and gives the same
  latents within the forward band.
The JAX package runs its moments through its XLA reference on the CPU."""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, jax_and_port, torch_cpu_runtime  # noqa: F401

FWD = 1e-5


@pytest.fixture(scope="module")
def latent_df():
    """Four observed columns driven by two latent factors, plus a skewed
    one, with nulls."""
    g = np.random.default_rng(21)
    n = 2000
    f1, f2 = g.normal(size=n), g.normal(size=n)
    df = pd.DataFrame({"a": 3 * f1 + 0.05 * g.normal(size=n) + 10, "b": -f1 + 0.05 * g.normal(size=n),
                       "c": f2 + 0.05 * g.normal(size=n), "d": 2 * f2 + f1 + 0.05 * g.normal(size=n),
                       "e": g.exponential(2.0, n), "cat": g.choice(["x", "y"], n)})
    for c in "abe":
        df.loc[g.random(n) < 0.05, c] = np.nan
    return df


def _close(got, exp, tol, what):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    err = np.abs(got - exp)
    assert np.all(err <= tol * (1 + np.abs(exp))), f"{what}: max err {err.max()}"


@pytest.mark.parametrize("standardization,imputation", [(True, True), (False, True), (True, False)])
def test_prep_block_matches_jax(latent_df, standardization, imputation):
    from anovos_tpu.data_transformer.latent_features import _prep_block as jprep
    from anovos_tpu_torch.data_transformer.latent_features import _prep_block as pprep

    jt, pt = jax_and_port(latent_df)
    cols = list("abcde")
    Xj, mj, sj = jprep(jt, cols, standardization, imputation)
    Xp, mp, sp = pprep(pt, cols, standardization, imputation)
    _close(Xp.numpy(), np.asarray(Xj)[: pt.nrows], 2e-6, "block")
    _close(mp.numpy(), np.asarray(mj), 1e-6, "mean")
    _close(sp.numpy(), np.asarray(sj), 1e-6, "std")


def _aligned(got, exp):
    """got's columns with the sign that best matches exp's."""
    s = np.sign((got * exp).sum(axis=0))
    return got * np.where(s == 0, 1, s)


@pytest.mark.parametrize("cutoff,standardization", [(0.95, False), (0.8, True), (0.999, False)])
def test_pca_matches_jax(latent_df, cutoff, standardization, tmp_path):
    from anovos_tpu.data_transformer.latent_features import PCA_latentFeatures as jpca
    from anovos_tpu_torch.data_transformer.latent_features import PCA_latentFeatures as ppca

    jt, pt = jax_and_port(latent_df)
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(explained_variance_cutoff=cutoff, standardization=standardization, output_mode="append")
    exp, got = jpca(jt, model_path=jp, **kw), ppca(pt, model_path=pp, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    lat = [c for c in got.col_names if c.startswith("latent_")]
    assert len(lat) >= 2
    g, e = got.to_pandas(), exp.to_pandas()
    assert_frames_close(g.drop(columns=lat), e.drop(columns=lat))
    part = os.path.join("PCA_latentFeatures", "part-00000.parquet")
    mg, me = pd.read_parquet(os.path.join(pp, part)), pd.read_parquet(os.path.join(jp, part))
    assert mg["component"].tolist() == me["component"].tolist() == lat
    Lg, Le = np.stack(mg["loadings"]).T, np.stack(me["loadings"]).T
    np.testing.assert_allclose(_aligned(Lg, Le), Le, rtol=0, atol=1e-4)
    s = np.sign((Lg * Le).sum(axis=0))
    _close(g[lat].to_numpy() * s, e[lat].to_numpy(), 1e-4, "projections")
    # the models cross: each package applies the other's
    for mp in (jp, pp):
        kw2 = dict(pre_existing_model=True, model_path=mp, standardization=standardization)
        _close(ppca(pt, **kw2).to_pandas()[lat].to_numpy(), jpca(jt, **kw2).to_pandas()[lat].to_numpy(),
               1e-4, "pre-existing model")


def test_pca_k_against_float64(latent_df):
    """k is the fewest components whose float64 eigenvalues reach the
    cutoff (the cutoffs here are far from every cumulative share)."""
    from anovos_tpu_torch.data_transformer.latent_features import PCA_latentFeatures

    _, pt = jax_and_port(latent_df)
    X = latent_df[list("abcde")].astype(np.float32).astype(np.float64)
    X = X.fillna(X.median()).to_numpy()
    ev = np.linalg.eigvalsh(np.cov(X, rowvar=False))[::-1]
    ratio = np.cumsum(ev) / ev.sum()
    for cutoff in (0.5, 0.9, 0.99):
        assert np.abs(ratio - cutoff).min() > 1e-3
        out = PCA_latentFeatures(pt, explained_variance_cutoff=cutoff)
        assert sum(c.startswith("latent_") for c in out.col_names) == int(np.searchsorted(ratio, cutoff) + 1)


# -- the autoencoder -------------------------------------------------------
def jax_params(n, k, seed=0):
    from anovos_tpu.models.autoencoder import AutoEncoder as JAE

    import jax

    return jax.tree_util.tree_map(np.asarray, JAE(n, k, seed=seed, compute_dtype="f32").init_params())


def test_params_round_trip_between_layouts():
    import torch

    from anovos_tpu_torch.models.autoencoder import AENet, params_from_jax, params_to_jax

    tree = jax_params(5, 2)
    sd = params_from_jax(tree)
    net = AENet(5, 2)
    net.load_state_dict(sd)  # every key and shape of the module
    back = params_to_jax(net.state_dict())
    for layer, leaves in tree.items():
        for key, v in leaves.items():
            if key == "bn":
                for bk, bv in v.items():
                    np.testing.assert_array_equal(back[layer]["bn"][bk], bv)
            else:
                np.testing.assert_array_equal(back[layer][key], v)
    assert tuple(net.dense["enc1"].weight.shape) == (10, 5) and tree["enc1"]["w"].shape == (5, 10)
    assert torch.equal(net.dense["enc1"].weight, torch.from_numpy(tree["enc1"]["w"].T.copy()))


@pytest.fixture(scope="module")
def ae_data(latent_df):
    from anovos_tpu_torch.data_transformer.latent_features import _prep_block

    _, pt = jax_and_port(latent_df)
    X, _, _ = _prep_block(pt, list("abcde"), True, True)
    return X.numpy().copy()


def test_forward_and_latent_match_jax(ae_data):
    import jax.numpy as jnp

    from anovos_tpu.models.autoencoder import AutoEncoder as JAE
    from anovos_tpu_torch.models.autoencoder import AutoEncoder, params_from_jax

    tree = jax_params(5, 2, seed=3)
    # non-trivial running statistics, so eval-mode BatchNorm is exercised
    g = np.random.default_rng(3)
    for layer in ("enc1", "enc2", "dec1", "dec2"):
        bn = tree[layer]["bn"]
        bn["mean"] = g.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = g.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
        bn["scale"] = g.uniform(0.8, 1.2, bn["scale"].shape).astype(np.float32)
    jae, pae = JAE(5, 2, compute_dtype="f32"), AutoEncoder(5, 2)
    net = pae.net_from_state(params_from_jax(tree))
    jtree = {k: {kk: (jnp.asarray(vv) if kk != "bn" else {b: jnp.asarray(x) for b, x in vv.items()})
                 for kk, vv in v.items()} for k, v in tree.items()}
    import torch

    X = torch.from_numpy(ae_data)
    _close(pae.latent(net, X).numpy(), np.asarray(jae.latent(jtree, jnp.asarray(ae_data))), FWD, "latent")
    _close(pae.reconstruct(net, X).numpy(), np.asarray(jae.reconstruct(jtree, jnp.asarray(ae_data))), FWD,
           "reconstruction")


def test_three_adam_steps_match_jax(ae_data):
    """Train-mode BatchNorm (biased batch variance, ε 1e-3, running update
    0.99/0.01), LeakyReLU 0.3 and Adam(1e-3) against optax from the same
    parameters on the same three batches."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from anovos_tpu.models.autoencoder import AutoEncoder as JAE
    from anovos_tpu_torch.models.autoencoder import AutoEncoder, params_from_jax, params_to_jax

    tree = jax_params(5, 2, seed=1)
    batches = [ae_data[i * 256:(i + 1) * 256] for i in range(3)]
    jae = JAE(5, 2, compute_dtype="f32")
    opt = optax.adam(1e-3)
    step = jae.make_train_step(opt)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(jp)
    jloss = []
    for b in batches:
        jp, state, loss = step(jp, state, jnp.asarray(b))
        jloss.append(float(loss))
    pae = AutoEncoder(5, 2)
    net = pae.net_from_state(params_from_jax(tree))
    popt = torch.optim.Adam(net.parameters(), lr=1e-3)
    ploss = [float(x) for x in pae.train_steps(net, popt, [torch.from_numpy(b) for b in batches])]
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    got = params_to_jax(net.state_dict())
    exp = jax.tree_util.tree_map(np.asarray, jp)
    for layer in got:
        for key in got[layer]:
            pairs = (got[layer][key].items() if key == "bn" else [(key, got[layer][key])])
            for kk, v in pairs:
                e = exp[layer]["bn"][kk] if key == "bn" else exp[layer][key]
                if key == "b" and layer != "out":
                    # every dense bias but the output's is a shift a
                    # BatchNorm removes (the bottleneck's through dec1), so
                    # its gradient is 0 in exact arithmetic: Adam's step on
                    # it is the sign of rounding noise, lr a step, in either
                    # package
                    for p in (v, e):
                        assert np.all(np.abs(p - tree[layer]["b"]) <= 3e-3 * (1 + 1e-6)), layer
                    continue
                if kk == "mean":
                    # the running mean takes 0.01 of each batch mean, which
                    # carries those biases' gap (≤ 2·lr·t at step t, the
                    # bottleneck's times dec1's weights): at most
                    # 0.01 · 2e-3 · (0 + 1 + 2) · (1 + Σ|w|) < 3e-4
                    assert np.all(np.abs(v - e) <= 1e-5 * (1 + np.abs(e)) + 3e-4), layer
                    continue
                _close(v, e, 1e-5, f"{layer}.{kk}")


def test_model_npz_crosses_between_packages(latent_df, tmp_path):
    """autoencoder_latentFeatures' model.npz: the JAX model applied by the
    port and the port's applied by JAX give each other's latents; the
    port's own round trip is bit-exact."""
    from anovos_tpu.data_transformer.latent_features import autoencoder_latentFeatures as jae
    from anovos_tpu_torch.data_transformer.latent_features import autoencoder_latentFeatures as pae

    jt, pt = jax_and_port(latent_df)
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(list_of_cols=list("abcde"), epochs=2, output_mode="append")
    fit_p = pae(pt, model_path=pp, **kw).to_pandas()
    jae(jt, model_path=jp, **kw)
    with np.load(os.path.join(pp, "autoencoders_latentFeatures", "model.npz")) as a, \
            np.load(os.path.join(jp, "autoencoders_latentFeatures", "model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[f].shape == b[f].shape and a[f].dtype == b[f].dtype for f in a.files)
    lat = ["latent_0", "latent_1"]
    again = pae(pt, pre_existing_model=True, model_path=pp, **kw).to_pandas()
    pd.testing.assert_frame_equal(again, fit_p)
    for mp in (jp, pp):
        got = pae(pt, pre_existing_model=True, model_path=mp, **kw).to_pandas()[lat].to_numpy()
        exp = jae(jt, pre_existing_model=True, model_path=mp, **kw).to_pandas()[lat].to_numpy()
        _close(got, exp, FWD, f"latents of the model in {os.path.basename(mp)}")


def test_autoencoder_transformer_trains(latent_df):
    """Two latent factors behind four columns: the fit's validation MSE
    falls below the first epoch's and well below the mean predictor's
    (1.0 on standardized data); columns and modes as in JAX."""
    from anovos_tpu.data_transformer.latent_features import autoencoder_latentFeatures as jae
    from anovos_tpu_torch.data_transformer.latent_features import _prep_block
    from anovos_tpu_torch.models.autoencoder import AutoEncoder

    jt, pt = jax_and_port(latent_df)
    X, _, _ = _prep_block(pt, list("abcd"), True, True)
    ae = AutoEncoder(4, 2)
    ae.fit(X[:1600], epochs=30, batch_size=256, validation_X=X[1600:])
    val = [h["val_mse"] for h in ae.history]
    assert np.isfinite(val).all() and val[-1] < val[0] and val[-1] < 0.5
    from anovos_tpu_torch.data_transformer.latent_features import autoencoder_latentFeatures as pae

    for mode in ("replace", "append"):
        g = pae(pt, list_of_cols=list("abcd"), epochs=1, output_mode=mode)
        e = jae(jt, list_of_cols=list("abcd"), epochs=1, output_mode=mode)
        assert g.col_names == e.col_names and g.dtypes() == e.dtypes()


def test_all_null_column_adds_nothing(latent_df):
    """An all-null numeric column: the JAX package fills it with its NaN
    median, so every latent is NaN; the port fills it with 0, so PCA gives
    the latents of the table without it and a 0 loading (ROADMAP.md
    Queue C)."""
    from anovos_tpu.data_transformer.latent_features import PCA_latentFeatures as jpca
    from anovos_tpu_torch.data_transformer.latent_features import PCA_latentFeatures as ppca

    df = latent_df.assign(empty=np.nan)
    jt, pt = jax_and_port(df)
    exp = jpca(jt, list_of_cols=list("abcde") + ["empty"]).to_pandas()
    got = ppca(pt, list_of_cols=list("abcde") + ["empty"]).to_pandas()
    lat = [c for c in got.columns if c.startswith("latent_")]
    assert exp[[c for c in exp.columns if c.startswith("latent_")]].isna().all().all()
    ref = ppca(jax_and_port(latent_df)[1], list_of_cols=list("abcde")).to_pandas()
    assert lat == [c for c in ref.columns if c.startswith("latent_")]
    np.testing.assert_allclose(_aligned(got[lat].to_numpy(), ref[lat].to_numpy()), ref[lat].to_numpy(),
                               rtol=1e-4, atol=1e-4)


# the bf16 band: both models round the same f32 values to bf16 and sum the
# exact products in f32, so only the sum order differs (4.9e-8 on this
# data); an intermediate that the order moves across a bf16 rounding step
# changes one input of the next layer by 2^-8 of itself
BF16 = 1e-3


@pytest.mark.parametrize("how", ["constructor", "env"])
def test_bf16_latents_match_jax_bf16(ae_data, how, monkeypatch):
    """``compute_dtype="bf16"`` (or ``ANOVOS_AE_COMPUTE=bf16`` under
    ``auto``) from weights carried across: the latents and reconstruction
    within BF16 of the JAX model's bf16 run, and apart from the f32 run's
    (the knob is honoured, not ignored)."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.models.autoencoder import AutoEncoder as JAE
    from anovos_tpu_torch.models.autoencoder import AutoEncoder, params_from_jax

    tree = jax_params(5, 2, seed=4)
    if how == "env":
        monkeypatch.setenv("ANOVOS_AE_COMPUTE", "bf16")
        jae, pae = JAE(5, 2), AutoEncoder(5, 2)
    else:
        monkeypatch.setenv("ANOVOS_AE_COMPUTE", "f32")  # the constructor wins
        jae, pae = JAE(5, 2, compute_dtype="bf16"), AutoEncoder(5, 2, compute_dtype="bf16")
    assert pae.compute_dtype == torch.bfloat16 and jae.compute_dtype == jnp.bfloat16
    jtree = {k: {kk: (jnp.asarray(vv) if kk != "bn" else {b: jnp.asarray(x) for b, x in vv.items()})
                 for kk, vv in v.items()} for k, v in tree.items()}
    net = pae.net_from_state(params_from_jax(tree))
    X = torch.from_numpy(ae_data)
    got = pae.latent(net, X).numpy()
    exp = np.asarray(jae.latent(jtree, jnp.asarray(ae_data)))
    _close(got, exp, BF16, "bf16 latent")
    _close(pae.reconstruct(net, X).numpy(), np.asarray(jae.reconstruct(jtree, jnp.asarray(ae_data))), BF16,
           "bf16 reconstruction")
    f32 = AutoEncoder(5, 2, compute_dtype="f32")
    assert f32.compute_dtype is None
    assert np.abs(f32.latent(f32.net_from_state(params_from_jax(tree)), X).numpy() - got).max() > 1e-5


def test_compute_dtype_precedence(monkeypatch):
    """The constructor's dtype, then ``ANOVOS_AE_COMPUTE``, then f32: off a
    TPU the JAX package's ``auto`` is f32 too."""
    import torch

    from anovos_tpu.models.autoencoder import _resolve_compute_dtype as jresolve
    from anovos_tpu_torch.models.autoencoder import resolve_compute_dtype

    for env, req in [(None, "auto"), ("bf16", "auto"), ("f32", "bf16"), ("bfloat16", "auto"), ("bf16", "f32")]:
        if env is None:
            monkeypatch.delenv("ANOVOS_AE_COMPUTE", raising=False)
        else:
            monkeypatch.setenv("ANOVOS_AE_COMPUTE", env)
        got, exp = resolve_compute_dtype(req), jresolve(req)
        assert (got is torch.bfloat16) == (exp is not None), (env, req)
