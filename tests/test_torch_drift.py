"""drift_detector.statistics of the port against the JAX package's.

Cutoffs are f32 ``lo + j·width``; XLA on the CPU may contract that to a
fused multiply-add, so fitted cutoffs are compared within 1 ulp.  Given the
same cutoffs, histograms are integer counts and must be equal.  Metrics
are compared within 1e-4 (both round to 4 decimals).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from _torch_port import income_frame, torch_cpu_runtime  # noqa: F401

METHODS = ["PSI", "HD", "JSD", "KS"]


@pytest.fixture(scope="module")
def sides():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = income_frame(6000, seed=3)
    src, tgt = df.iloc[:3000].reset_index(drop=True), df.iloc[3000:].reset_index(drop=True).copy()
    # drift in a few columns, a category unseen in the source, an all-null
    # source column that the fit drops
    tgt["age"] = tgt["age"] + 9.0
    tgt.loc[::3, "race"] = "Unseen"
    tgt["hours-per-week"] = tgt["hours-per-week"] * 1.5
    src = src.assign(gone=np.nan)
    tgt = tgt.assign(gone=np.linspace(0, 1, len(tgt)))
    return ((JTable.from_pandas(tgt), JTable.from_pandas(src)),
            (Table.from_pandas(tgt, device="cpu"), Table.from_pandas(src, device="cpu")))


def _run_both(sides, tmp_path, **kw):
    from anovos_tpu.drift_stability.drift_detector import statistics as jstat
    from anovos_tpu_torch.drift_stability.drift_detector import statistics as pstat

    (jt, js), (pt, ps) = sides
    with pytest.warns(UserWarning):
        exp = jstat(jt, js, source_path=str(tmp_path / "jax"), use_sampling=False, **kw)
    with pytest.warns(UserWarning):
        got = pstat(pt, ps, source_path=str(tmp_path / "port"), use_sampling=False, **kw)
    return got, exp


def _assert_drift_equal(got, exp, methods):
    assert list(got["attribute"]) == list(exp["attribute"])
    assert list(got["flagged"]) == list(exp["flagged"])
    for m in methods:
        np.testing.assert_allclose(got[m].to_numpy(np.float64), exp[m].to_numpy(np.float64),
                                   rtol=0, atol=1e-4, err_msg=m)


@pytest.mark.parametrize("bin_method", ["equal_range", "equal_frequency"])
def test_statistics_all_methods_match_jax(sides, tmp_path, bin_method):
    got, exp = _run_both(sides, tmp_path, method_type="all", bin_method=bin_method, bin_size=10)
    _assert_drift_equal(got, exp, METHODS)
    assert "gone" not in set(got["attribute"])  # all-null in the source: dropped
    assert got["flagged"].sum() >= 3


@pytest.mark.parametrize("method", METHODS)
def test_statistics_single_method_matches_jax(sides, tmp_path, method):
    got, exp = _run_both(sides, tmp_path, method_type=method, bin_size=7, threshold=0.05)
    assert list(got.columns) == ["attribute", method, "flagged"]
    _assert_drift_equal(got, exp, [method])


def test_persisted_model_matches_jax(sides, tmp_path):
    from anovos_tpu.drift_stability.drift_detector import load_frequency_map as jload
    from anovos_tpu_torch.shared.convert import load_drift_model

    _run_both(sides, tmp_path, method_type="PSI", bin_size=10)
    (pt, _), _ = sides
    cols = pt.col_names
    jdir = os.path.join(tmp_path, "jax", "drift_statistics")
    pdir = os.path.join(tmp_path, "port", "drift_statistics")
    jcuts, jfreq = load_drift_model(jdir, cols)
    pcuts, pfreq = load_drift_model(pdir, cols)
    assert list(pcuts) == list(jcuts)
    for c in jcuts:
        np.testing.assert_allclose(pcuts[c], jcuts[c], rtol=2 ** -23, atol=0, err_msg=c)
    assert set(pfreq) == set(jfreq)
    for c in jfreq:
        assert list(pfreq[c]) == list(jfreq[c]), c
        np.testing.assert_allclose(list(pfreq[c].values()), list(jfreq[c].values()),
                                   rtol=0, atol=1e-9, err_msg=c)
        assert jload(pdir, c) == pfreq[c]
    # the files themselves have the same layout
    assert sorted(os.listdir(os.path.join(pdir, "frequency_counts"))) == \
        sorted(os.listdir(os.path.join(jdir, "frequency_counts")))
    assert os.listdir(os.path.join(pdir, "attribute_binning")) == ["part-00000.parquet"]


def test_pre_existing_source_on_jax_model(sides, tmp_path):
    """The port re-runs on the model the JAX package persisted, and gives
    the JAX package's own re-run."""
    from anovos_tpu.drift_stability.drift_detector import statistics as jstat
    from anovos_tpu_torch.drift_stability.drift_detector import statistics as pstat

    (jt, js), (pt, _) = sides
    model = str(tmp_path / "jax")
    with pytest.warns(UserWarning):
        jstat(jt, js, source_path=model, method_type="all", use_sampling=False)
    with pytest.warns(UserWarning):
        exp = jstat(jt, None, pre_existing_source=True, source_path=model, method_type="all",
                    use_sampling=False)
    with pytest.warns(UserWarning):
        got = pstat(pt, None, pre_existing_source=True, source_path=model, method_type="all",
                    use_sampling=False)
    _assert_drift_equal(got, exp, METHODS)


@pytest.mark.parametrize("method", ["equal_range", "equal_frequency"])
def test_fit_cutoffs_match_jax(method):
    from anovos_tpu.ops.drift_kernels import fit_cutoffs as jfit
    from anovos_tpu_torch.ops.drift_kernels import fit_cutoffs

    g = np.random.default_rng(4)
    cols = [g.normal(10, 3, 3001).astype(np.float32), g.exponential(2, 3001).astype(np.float32),
            g.integers(0, 9, 3001).astype(np.int32), np.zeros(3001, np.float32)]
    masks = [g.random(3001) > 0.2 for _ in cols]
    masks[-1][:] = False
    exp = np.asarray(jfit(tuple(jnp.asarray(c) for c in cols), tuple(jnp.asarray(m) for m in masks),
                          10, method))
    got = fit_cutoffs([torch.from_numpy(c) for c in cols], [torch.from_numpy(m) for m in masks],
                      10, method).numpy()
    assert got.dtype == np.float32 and got.shape == exp.shape
    assert np.isnan(got[-1]).all() and np.isnan(exp[-1]).all()
    ulp = np.spacing(np.abs(exp[:-1]))
    assert (np.abs(got[:-1] - exp[:-1]) <= ulp).all()


def test_side_histograms_equal_given_same_cutoffs(sides):
    """drift_side_full of both packages on one side, fed identical
    cutoffs and LUTs: numeric and categorical counts are equal."""
    from anovos_tpu.drift_stability import drift_detector as jdd
    from anovos_tpu.ops.drift_kernels import drift_side_full as jside
    from anovos_tpu_torch.drift_stability import drift_detector as pdd
    from anovos_tpu_torch.ops.drift_kernels import drift_side_full

    (jt, js), (pt, ps) = sides
    num, cat, _ = pt.attribute_type_segregation()
    cuts = pdd._fit_cutoffs_dev(ps, num, 10, "equal_range")
    vocabs = pdd._union_vocabs_for(ps, pt, cat)
    n_union = max(len(v) for v in vocabs.values())
    got_num, got_cat = drift_side_full(*pdd._side_args(pt, num, cat, cuts, vocabs, 10, n_union))
    jargs = jdd._side_args(jt, num, cat, jnp.asarray(cuts.numpy()),
                           jdd._lut_for(jt, cat, vocabs), 10, n_union)
    exp_num, exp_cat = (np.asarray(a) for a in jside(*jargs))
    np.testing.assert_array_equal(got_num.numpy(), exp_num[: len(num)])
    np.testing.assert_array_equal(got_cat.numpy(), exp_cat[: len(cat)])


def test_sampling_path_raises(sides, tmp_path):
    """use_sampling=True samples each side above sample_size through
    data_sample, so a bad sample_method raises its TypeError in both
    packages; a good one runs."""
    from anovos_tpu.drift_stability.drift_detector import statistics as jstat
    from anovos_tpu_torch.drift_stability.drift_detector import statistics

    (jt, js), (pt, ps) = sides
    for stat, t, s in ((statistics, pt, ps), (jstat, jt, js)):
        with pytest.raises(TypeError, match="data_sample method_type"):
            stat(t, s, use_sampling=True, sample_size=100, sample_method="bogus",
                 source_path=str(tmp_path))
    with pytest.warns(UserWarning):
        odf = statistics(pt, ps, use_sampling=True, sample_size=100, source_path=str(tmp_path))
    assert len(odf) > 0 and odf["PSI"].notna().all()
