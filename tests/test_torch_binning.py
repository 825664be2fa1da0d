"""Binning and label encoding of the port against the JAX package's on the
same frames: ``digitize`` and the bin-count helpers, ``attribute_binning``
(both methods, numerical ids and categorical labels, its model crossing
between the packages), ``monotonic_binning``'s chosen bins and
``cat_to_num_unsupervised`` under every ``index_order``.  Bin ids, codes
and counts are integers and must be equal; the f32 equal-range edges of
``equal_range_cutoffs`` are held to 1e-6 of their column's scale."""

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, income_frame, jax_and_port, torch_cpu_runtime  # noqa: F401

NUM = ["age", "fnlwgt", "education-num", "capital-gain", "capital-loss", "hours-per-week"]


@pytest.fixture(scope="module")
def frame():
    df = income_frame(3000, seed=9)
    g = np.random.default_rng(9)
    df["all_null"] = np.nan
    # an event rate that rises with age, for monotonic_binning
    df["target"] = (df["age"].fillna(50) + g.normal(0, 12, len(df)) > 55).astype(float)
    return df


def test_digitize_and_bin_counts_match_jax():
    """Values equal to an interior edge go to the lower bin, a NaN edge
    row puts every value in bin 0; counts and label sums per bin equal."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops import histogram as jh
    from anovos_tpu_torch.ops import histogram as ph

    g = np.random.default_rng(3)
    X = g.normal(0, 2, (500, 4)).astype(np.float32)
    M = g.random((500, 4)) > 0.2
    edges = np.sort(g.normal(0, 2, (4, 9)), axis=1).astype(np.float32)
    edges[:, 0], edges[:, -1] = -np.inf, np.inf
    X[:7, 0] = edges[0, 1:8]
    edges[3, 1:-1] = np.nan
    y = (g.random(500) > 0.6).astype(np.float32)
    jb = np.asarray(jh.digitize(jnp.asarray(X), jnp.asarray(edges)))
    pb = ph.digitize(torch.from_numpy(X), torch.from_numpy(edges)).numpy()
    np.testing.assert_array_equal(pb, jb)
    assert (pb[:7, 0] == np.arange(7)).all() and (pb[:, 3] == 0).all()
    nb = edges.shape[1] - 1
    tb, tm = torch.from_numpy(pb), torch.from_numpy(M)
    np.testing.assert_array_equal(ph.masked_bincount(tb, tm, nb).numpy(),
                                  np.asarray(jh.masked_bincount(jnp.asarray(jb), jnp.asarray(M), nb)))
    np.testing.assert_array_equal(
        ph.masked_label_bincount(tb, tm, torch.from_numpy(y), nb).numpy(),
        np.asarray(jh.masked_label_bincount(jnp.asarray(jb), jnp.asarray(M), jnp.asarray(y), nb)))
    got = ph.equal_range_cutoffs(torch.from_numpy(X), tm, 10).numpy()
    exp = np.asarray(jh.equal_range_cutoffs(jnp.asarray(X), jnp.asarray(M), 10))
    # lo + step·(hi − lo) rounds once or twice: 1e-6 of the column's scale
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6 * np.abs(exp).max())


@pytest.mark.parametrize("method", ["equal_range", "equal_frequency"])
@pytest.mark.parametrize("bin_dtype", ["numerical", "categorical"])
def test_attribute_binning_matches_jax(frame, method, bin_dtype):
    from anovos_tpu.data_transformer.transformers import attribute_binning as jbin
    from anovos_tpu_torch.data_transformer.transformers import attribute_binning as pbin

    jt, pt = jax_and_port(frame)
    kw = dict(list_of_cols=NUM + ["all_null"], method_type=method, bin_size=10, bin_dtype=bin_dtype,
              output_mode="append")
    exp, got = jbin(jt, **kw), pbin(pt, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    assert_frames_close(got.to_pandas(), exp.to_pandas())
    if bin_dtype == "categorical":
        for c in got.col_names:
            if c.endswith("_binned"):
                assert list(got.columns[c].vocab) == list(exp.columns[c].vocab), c


def test_binning_models_cross_between_packages(frame, tmp_path):
    """A model written by one package, applied by the other with
    pre_existing_model=True, bins as the writer did."""
    from anovos_tpu.data_transformer.transformers import attribute_binning as jbin
    from anovos_tpu_torch.data_transformer.transformers import attribute_binning as pbin

    jt, pt = jax_and_port(frame)
    for method in ("equal_frequency", "equal_range"):
        for writer, reader, tw, tr, d in ((jbin, pbin, jt, pt, "j"), (pbin, jbin, pt, jt, "p")):
            mp = str(tmp_path / f"{method}_{d}")
            w = writer(tw, NUM, method_type=method, bin_size=7, model_path=mp)
            r = reader(tr, NUM, method_type=method, bin_size=7, model_path=mp, pre_existing_model=True)
            assert r.dtypes() == w.dtypes()
            assert_frames_close(r.to_pandas(), w.to_pandas())


@pytest.mark.parametrize("method", ["equal_range", "equal_frequency"])
def test_monotonic_binning_matches_jax(frame, method):
    """The same bin count is chosen: the binned columns are equal."""
    from anovos_tpu.data_transformer.transformers import monotonic_binning as jmono
    from anovos_tpu_torch.data_transformer.transformers import monotonic_binning as pmono

    jt, pt = jax_and_port(frame)
    kw = dict(list_of_cols=["age", "hours-per-week"], label_col="target", event_label=1,
              bin_method=method, output_mode="append")
    exp, got = jmono(jt, **kw), pmono(pt, **kw)
    assert got.col_names == exp.col_names
    assert_frames_close(got.to_pandas(), exp.to_pandas())
    assert int(got.columns["age_binned"].data.max()) > 1


@pytest.mark.parametrize("index_order", ["frequencyDesc", "frequencyAsc", "alphabetDesc", "alphabetAsc"])
@pytest.mark.parametrize("encoding", ["label_encoding", "onehot_encoding"])
def test_cat_to_num_unsupervised_matches_jax(frame, encoding, index_order, tmp_path):
    """Codes (or one-hot columns) equal; geohash's 97 categories exceed
    the one-hot cardinality threshold and are skipped by both."""
    from anovos_tpu.data_transformer.transformers import cat_to_num_unsupervised as jenc
    from anovos_tpu_torch.data_transformer.transformers import cat_to_num_unsupervised as penc

    df = frame.copy()
    df.loc[::13, "workclass"] = None
    jt, pt = jax_and_port(df)
    kw = dict(list_of_cols="all", drop_cols=["income"], method_type=encoding, index_order=index_order)
    exp = jenc(jt, **kw, model_path=str(tmp_path / "j"))
    got = penc(pt, **kw, model_path=str(tmp_path / "p"))
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    assert_frames_close(got.to_pandas(), exp.to_pandas())
    mj = pd.read_csv(tmp_path / "j" / "cat_to_num_unsupervised" / "part-00000.csv", dtype=str)
    mp = pd.read_csv(tmp_path / "p" / "cat_to_num_unsupervised" / "part-00000.csv", dtype=str)
    pd.testing.assert_frame_equal(mp, mj)


def test_cat_to_num_transformer_dispatch(frame):
    from anovos_tpu_torch.data_transformer.transformers import cat_to_num_transformer
    from anovos_tpu_torch.shared.table import Table

    pt = Table.from_pandas(frame, device="cpu")
    out = cat_to_num_transformer(pt, drop_cols="income", method_type="unsupervised",
                                 encoding="label_encoding")
    assert out.columns["workclass"].kind == "num"
    sup = cat_to_num_transformer(pt, drop_cols="ifa", method_type="supervised", label_col="income",
                                 event_label=">50K")
    assert sup.columns["workclass"].kind == "num" and sup.columns["income"].kind == "cat"
    with pytest.raises(TypeError):
        cat_to_num_transformer(pt, method_type="other")
