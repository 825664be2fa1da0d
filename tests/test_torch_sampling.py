"""Sampling in the port against the JAX package: ``Table.filter_rows`` /
``gather_rows``, ``ops/sampling`` and ``data_sample``, and drift
``statistics`` with ``use_sampling=True``.

The port draws from a seeded ``torch.Generator``; the JAX package draws
``jax.random`` rows, so the two keep different rows for one seed (a
divergence by design, pinned by ``test_rng_diverges_from_jax_by_design``).
Kept shares are therefore held within 5 binomial σ, and where both
packages must see the same rows one keep mask goes to both.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_port import income_frame, torch_cpu_runtime  # noqa: F401


def _frame(n, seed):
    g = np.random.default_rng(seed)
    return pd.DataFrame({
        "stratum": g.choice(["a", "b", "c", None], n, p=[0.6, 0.3, 0.08, 0.02]),
        "grade": g.choice([1.0, 2.0, np.nan], n, p=[0.7, 0.29, 0.01]),
        "x": g.normal(0, 1, n),
        "big": g.integers(2**40, 2**41, n),
        "id": np.arange(n),
    })


@pytest.fixture(scope="module")
def small():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = _frame(600, 1)
    return df, JTable.from_pandas(df), Table.from_pandas(df, device="cpu")


def test_filter_and_gather_rows_match_jax(small):
    df, jt, pt = small
    g = np.random.default_rng(2)
    keep = g.random(len(df)) < 0.4
    pd.testing.assert_frame_equal(pt.filter_rows(keep).to_pandas(), jt.filter_rows(keep).to_pandas())
    pd.testing.assert_frame_equal(pt.filter_rows(torch.from_numpy(keep)).to_pandas(),
                                  jt.filter_rows(keep).to_pandas())
    idx = g.integers(0, len(df), 300)
    idx[::7] = -1
    valid = idx >= 0
    valid[::11] = False  # an outer join's unmatched rows
    got, exp = pt.gather_rows(idx, valid=valid), jt.gather_rows(idx, valid=valid)
    assert got.dtypes() == exp.dtypes()
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    assert got.to_pandas().loc[~valid].isna().all().all()
    for t in (pt, jt):
        with pytest.raises(IndexError):
            t.gather_rows(np.array([0, len(df)]))
        with pytest.raises(ValueError):
            t.filter_rows(keep[:-1])


def test_sample_mask_share_and_determinism():
    from anovos_tpu_torch.ops.sampling import sample_mask

    n, f = 20000, 0.3
    a = sample_mask(5, n, f, "cpu")
    assert torch.equal(a, sample_mask(5, n, f, "cpu"))
    assert not torch.equal(a, sample_mask(6, n, f, "cpu"))
    assert abs(int(a.sum()) - n * f) <= 5 * np.sqrt(n * f * (1 - f))


def test_rng_diverges_from_jax_by_design():
    """One seed keeps other rows in the two packages; both keep the
    expected share."""
    from anovos_tpu.ops.sampling import sample_mask as jmask
    from anovos_tpu_torch.ops.sampling import sample_mask

    n, f = 20000, 0.5
    got = sample_mask(12, n, f, "cpu").numpy()
    exp = np.asarray(jmask(12, n, f))
    assert not np.array_equal(got, exp)
    for m in (got, exp):
        assert abs(int(m.sum()) - n * f) <= 5 * np.sqrt(n * f * (1 - f))


@pytest.mark.parametrize("stratified_type", ["population", "balanced"])
def test_stratified_counts_within_binomial_band(stratified_type):
    from anovos_tpu_torch.data_ingest.data_sampling import data_sample
    from anovos_tpu_torch.shared.table import Table

    df = _frame(20000, 3)
    f = 0.4
    out = data_sample(Table.from_pandas(df, device="cpu"), strata_cols="stratum|grade", fraction=f,
                      method_type="stratified", stratified_type=stratified_type, seed_value=7)
    got = out.to_pandas()
    assert got["stratum"].notna().all() and got["grade"].notna().all()  # null strata dropped
    counts = df.groupby(["stratum", "grade"]).size()
    kept = got.groupby(["stratum", "grade"]).size().reindex(counts.index, fill_value=0)
    p = f * (counts.min() / counts if stratified_type == "balanced" else 1.0)
    sigma = np.sqrt(counts * p * (1 - p))
    assert (np.abs(kept - counts * p) <= 5 * sigma + 1).all(), pd.concat([kept, counts * p], axis=1)


def test_high_cardinality_skip_warns_as_jax(small):
    """The id-like column is skipped with the JAX package's warning; with
    only such columns both return the table unsampled."""
    from anovos_tpu.data_ingest.data_sampling import data_sample as jds
    from anovos_tpu_torch.data_ingest.data_sampling import data_sample

    df, jt, pt = small
    msgs = []
    for fn, t in ((jds, jt), (data_sample, pt)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn(t, strata_cols=["stratum", "id", "x"], method_type="stratified", fraction=0.5)
            out = fn(t, strata_cols="id|x", method_type="stratified", fraction=0.5,
                     unique_threshold=10)
        msgs.append([str(x.message) for x in w])
        assert out.nrows == len(df)
    assert msgs[0] == msgs[1]
    assert msgs[1][0] == "Columns dropped from strata due to high cardinality: id,x"


@pytest.mark.parametrize("kw", [
    {"fraction": 0}, {"fraction": 1.5}, {"fraction": True}, {"seed_value": 1.5},
    {"method_type": "systematic"}, {"method_type": "stratified", "stratified_type": "equal"},
    {"method_type": "stratified", "unique_threshold": 2.5}, {"method_type": "stratified", "unique_threshold": -1},
    {"method_type": "stratified", "strata_cols": "nope"},
    {"method_type": "stratified", "strata_cols": "x", "drop_cols": "x"},
])
def test_argument_checks_match_jax(small, kw):
    from anovos_tpu.data_ingest.data_sampling import data_sample as jds
    from anovos_tpu_torch.data_ingest.data_sampling import data_sample

    _, jt, pt = small
    kw = {"fraction": 0.5, **kw}
    with pytest.raises(TypeError) as exp:
        jds(jt, **kw)
    with pytest.raises(TypeError, match=f"^{exp.value}$"):
        data_sample(pt, **kw)


@pytest.fixture(scope="module")
def income():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = income_frame(3000, seed=4)
    return df, JTable.from_pandas(df), Table.from_pandas(df, device="cpu")


def test_drift_matches_jax_on_one_keep_mask(income, tmp_path):
    """Both packages filter with the port's keep mask, then drift without
    sampling: the bands of tests/test_torch_drift.py."""
    from anovos_tpu.drift_stability.drift_detector import statistics as jstat
    from anovos_tpu_torch.drift_stability.drift_detector import statistics
    from anovos_tpu_torch.ops.sampling import sample_mask

    df, jt, pt = income
    keep = sample_mask(3, len(df), 0.6, "cpu").numpy()
    half = np.arange(len(df)) < len(df) // 2
    got = statistics(pt.filter_rows(keep & ~half), pt.filter_rows(keep & half), method_type="all",
                     use_sampling=False, source_path=str(tmp_path / "p"))
    exp = jstat(jt.filter_rows(keep & ~half), jt.filter_rows(keep & half), method_type="all",
                use_sampling=False, source_path=str(tmp_path / "j"))
    assert list(got["attribute"]) == list(exp["attribute"])
    assert list(got["flagged"]) == list(exp["flagged"])
    for m in ("PSI", "HD", "JSD", "KS"):
        np.testing.assert_allclose(got[m], exp[m], rtol=0, atol=1e-4, err_msg=m)


def test_sampled_statistics_runs_and_its_model_crosses(income, tmp_path):
    """use_sampling=True above sample_size no longer raises; the binning
    model written after sampling is read by the JAX package as its own."""
    from anovos_tpu.drift_stability.drift_detector import statistics as jstat
    from anovos_tpu_torch.drift_stability.drift_detector import statistics
    from anovos_tpu_torch.shared.table import Table

    df, jt, pt = income
    src, tgt = pt.slice_rows(0, 1500), pt.slice_rows(1500, 3000)
    got = statistics(tgt, src, method_type="all", sample_size=1000, source_path=str(tmp_path))
    assert sorted(got["attribute"]) == sorted(src.col_names)
    assert np.isfinite(got[["PSI", "HD", "JSD", "KS"]].to_numpy(np.float64)).all()
    # the persisted model of the sampled source, applied by both packages
    jt_tgt = jt.gather_rows(np.arange(1500, 3000))
    exp = jstat(jt_tgt, None, method_type="all", use_sampling=False, pre_existing_source=True,
                source_path=str(tmp_path))
    again = statistics(Table.from_pandas(df.iloc[1500:], device="cpu"), None, method_type="all",
                       use_sampling=False, pre_existing_source=True, source_path=str(tmp_path))
    assert list(again["attribute"]) == list(exp["attribute"])
    for m in ("PSI", "HD", "JSD", "KS"):
        np.testing.assert_allclose(again[m], exp[m], rtol=0, atol=1e-4, err_msg=m)
