"""The port's scalers, rare-category clubbing and target encoding against
the JAX package's on the same synthesized income frame:
``z_standardization``, ``IQR_standardization``, ``normalization``,
``outlier_categories``, ``cat_to_num_supervised`` and the supervised branch
of ``cat_to_num_transformer``, each with its model crossing between the
packages.

Bands: the 'lower' quantiles, min/max, keep sets, codes and 4-decimal
rates are exact (equal files); the moments' mean within 1e-6·(|μ| + σ)
and stddev within 1e-6 relative (PERF.md "Moment accumulation error":
≤ 3e-7 for these columns), so z-scores within 2e-6·(1 + |z|); values
scaled by equal parameters are equal.  The JAX package runs its moments
through its XLA reference on the CPU."""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, income_frame, jax_and_port, torch_cpu_runtime  # noqa: F401


@pytest.fixture(scope="module")
def frame():
    df = income_frame(3000, seed=31)
    df["const"] = 7.0
    df["all_null"] = np.nan
    g = np.random.default_rng(31)
    df.loc[g.random(len(df)) < 0.03, "workclass"] = None
    # a rare tail for outlier_categories
    df.loc[g.random(len(df)) < 0.01, "occupation"] = "Rare-a"
    df.loc[g.random(len(df)) < 0.004, "occupation"] = "Rare-b"
    return df


NUM = ["age", "fnlwgt", "education-num", "capital-gain", "hours-per-week", "latitude", "const", "all_null"]


def _both(name, frame, **kw):
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    jt, pt = jax_and_port(frame)
    with pytest.warns(UserWarning) as jw:
        exp = getattr(jtr, name)(jt, **kw)
    with pytest.warns(UserWarning) as pw:
        got = getattr(ptr, name)(pt, **kw)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    return got, exp


@pytest.mark.parametrize("output_mode", ["replace", "append"])
def test_z_standardization_matches_jax(frame, output_mode, tmp_path):
    got, exp = _both("z_standardization", frame, list_of_cols=NUM, output_mode=output_mode,
                     model_path=str(tmp_path / "port"))
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    g, e = got.to_pandas(), exp.to_pandas()
    assert_frames_close(g, e, rtol=2e-6, atol=2e-6)
    m = pd.read_parquet(tmp_path / "port" / "z_standardization" / "part-00000.parquet")
    ref = frame[NUM].astype(np.float32).astype(np.float64)
    assert m["attribute"].tolist() == NUM
    for _, r in m.iterrows():
        v = ref[r["attribute"]].dropna()
        if len(v) < 2:
            assert np.isnan(r["mean"] if len(v) == 0 else r["stddev"])
            continue
        assert abs(r["mean"] - v.mean()) <= 1e-6 * (abs(v.mean()) + v.std())
        assert abs(r["stddev"] - v.std()) <= 1e-6 * v.std() + 1e-30


@pytest.mark.parametrize("output_mode", ["replace", "append"])
def test_iqr_standardization_matches_jax(frame, output_mode, tmp_path):
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    got, exp = _both("IQR_standardization", frame, list_of_cols=NUM, output_mode=output_mode, model_path=pp)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    assert_frames_close(got.to_pandas(), exp.to_pandas())
    from anovos_tpu.data_transformer.transformers import IQR_standardization as jiqr

    jiqr(jax_and_port(frame)[0], list_of_cols=NUM, model_path=jp)
    part = os.path.join("IQR_standardization", "part-00000.parquet")
    pd.testing.assert_frame_equal(pd.read_parquet(os.path.join(pp, part)), pd.read_parquet(os.path.join(jp, part)))
    m = pd.read_parquet(os.path.join(pp, part)).set_index("attribute")
    for c in ("age", "fnlwgt", "hours-per-week"):
        v = np.sort(frame[c].dropna().to_numpy(np.float32))
        q = [v[int(np.floor(p * (len(v) - 1)))] for p in (0.25, 0.5, 0.75)]
        assert m.loc[c, "median"] == q[1] and m.loc[c, "iqr"] == np.float32(q[2] - q[1] + q[1] - q[0])


@pytest.mark.parametrize("output_mode", ["replace", "append"])
def test_normalization_matches_jax(frame, output_mode, tmp_path):
    got, exp = _both("normalization", frame, list_of_cols=NUM, output_mode=output_mode,
                     model_path=str(tmp_path))
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    assert_frames_close(got.to_pandas(), exp.to_pandas())
    m = pd.read_parquet(tmp_path / "normalization" / "part-00000.parquet").set_index("attribute")
    assert m.loc["age", "min"] == frame["age"].min() and m.loc["fnlwgt", "max"] == np.float32(frame["fnlwgt"].max())


@pytest.mark.parametrize("name", ["z_standardization", "IQR_standardization", "normalization"])
def test_scaler_models_cross_between_packages(frame, name, tmp_path):
    """Each package applies the other's model and gives what the model's
    own package gives."""
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    jt, pt = jax_and_port(frame)
    cols = ["age", "fnlwgt", "hours-per-week"]
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(jtr, name)(jt, list_of_cols=cols, model_path=jp)
    getattr(ptr, name)(pt, list_of_cols=cols, model_path=pp)
    for mp in (jp, pp):
        kw = dict(list_of_cols=cols, pre_existing_model=True, model_path=mp, output_mode="append")
        assert_frames_close(getattr(ptr, name)(pt, **kw).to_pandas(), getattr(jtr, name)(jt, **kw).to_pandas())


@pytest.mark.parametrize("coverage,max_category", [(0.9, 20), (1.0, 50), (0.5, 3), (0.99, 4)])
def test_outlier_categories_matches_jax(frame, coverage, max_category, tmp_path):
    from anovos_tpu.data_transformer.transformers import outlier_categories as joc
    from anovos_tpu_torch.data_transformer.transformers import outlier_categories as poc

    jt, pt = jax_and_port(frame)
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(drop_cols=["income"], coverage=coverage, max_category=max_category, output_mode="append")
    exp, got = joc(jt, model_path=jp, **kw), poc(pt, model_path=pp, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    for c in got.col_names:
        if c.endswith("_outliered"):
            assert list(got.columns[c].vocab) == list(exp.columns[c].vocab), c
            np.testing.assert_array_equal(got.columns[c].data.numpy(), np.asarray(exp.columns[c].data)[:got.nrows])
    assert_frames_close(got.to_pandas(), exp.to_pandas())
    part = os.path.join("outlier_categories", "part-00000.csv")
    with open(os.path.join(pp, part)) as f, open(os.path.join(jp, part)) as g:
        assert f.read() == g.read()
    # the keep set: the most frequent values up to the coverage, at most max_category - 1
    occ = frame["occupation"].dropna().value_counts()
    occ = occ.sort_values(kind="stable", ascending=False)
    cum = (occ / occ.sum()).cumsum()
    lag = cum.shift(fill_value=0.0)
    keep = [v for i, (v, cu, la) in enumerate(zip(occ.index, cum, lag))
            if not (cu >= coverage and la >= coverage) and i <= max_category - 2]
    kept = set(got.columns["occupation_outliered"].vocab) - {"outlier_categories"}
    assert kept == set(keep)
    for mp in (jp, pp):
        kw2 = dict(list_of_cols=["occupation", "race"], pre_existing_model=True, model_path=mp)
        assert_frames_close(poc(pt, **kw2).to_pandas(), joc(jt, **kw2).to_pandas())


@pytest.mark.parametrize("label,event", [("income", ">50K"), ("label", 1)])
def test_cat_to_num_supervised_matches_jax(frame, label, event, tmp_path):
    """Equal rates (the model CSVs are the same bytes), equal encoded
    columns, the rates equal to a pandas groupby mean at 4 decimals (as
    f32, which the model holds)."""
    from anovos_tpu.data_transformer.transformers import cat_to_num_supervised as jsup
    from anovos_tpu_torch.data_transformer.transformers import cat_to_num_supervised as psup

    jt, pt = jax_and_port(frame)
    jp, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(label_col=label, event_label=event, output_mode="append")
    exp, got = jsup(jt, model_path=jp, **kw), psup(pt, model_path=pp, **kw)
    assert got.col_names == exp.col_names and got.dtypes() == exp.dtypes()
    assert_frames_close(got.to_pandas(), exp.to_pandas())
    cols = [c for c in got.col_names if c.endswith("_encoded")]
    assert len(cols) >= 5
    for c in cols:
        base = c[: -len("_encoded")]
        part = os.path.join("cat_to_num_supervised", base, "part-00000.csv")
        with open(os.path.join(pp, part)) as f, open(os.path.join(jp, part)) as g:
            assert f.read() == g.read(), base
        sub = frame[[base, label]].dropna()
        hit = sub[label] == event if isinstance(event, (int, float)) else sub[label].astype(str) == event
        ref = hit.groupby(sub[base].astype(str)).mean().round(4)
        m = pd.read_csv(os.path.join(pp, part), dtype={base: str}).set_index(base)[c]
        for v, r in ref.items():
            assert np.float32(m[v]) == np.float32(r), (base, v)
    # apply: both models, no label column needed
    nolab = frame.drop(columns=[label])
    jt2, pt2 = jax_and_port(nolab)
    for mp in (jp, pp):
        kw2 = dict(list_of_cols=["workclass", "race"], label_col=label, pre_existing_model=True, model_path=mp)
        assert_frames_close(psup(pt2, **kw2).to_pandas(), jsup(jt2, **kw2).to_pandas())


def test_rates_round_as_jax_does():
    """A rate whose f32 value sits on a 4-decimal tie (1/8 = 0.125 is
    exact; 0.00005-ties are not) rounds as numpy rounds the f32 quotient:
    10 events of 16 rows → 0.625, 1 of 3 → 0.3333, 2 of 3 → 0.6667."""
    from anovos_tpu.data_transformer.transformers import cat_to_num_supervised as jsup
    from anovos_tpu_torch.data_transformer.transformers import cat_to_num_supervised as psup

    cats = ["a"] * 16 + ["b"] * 3 + ["c"] * 3 + ["d"]
    ys = [1] * 10 + [0] * 6 + [1, 0, 0] + [1, 1, 0] + [None]
    df = pd.DataFrame({"c": cats, "y": ys})
    jt, pt = jax_and_port(df)
    g, e = psup(pt, label_col="y", event_label=1).to_pandas(), jsup(jt, label_col="y", event_label=1).to_pandas()
    assert_frames_close(g, e)
    assert g["c"].iloc[[0, 16, 19]].tolist() == [0.625, np.float32(0.3333), np.float32(0.6667)]
    assert np.isnan(g["c"].iloc[22])  # a category without a labelled row encodes as null


def test_cat_to_num_transformer_supervised_branch(frame):
    from anovos_tpu_torch.data_transformer.transformers import cat_to_num_supervised, cat_to_num_transformer

    _, pt = jax_and_port(frame)
    a = cat_to_num_transformer(pt, drop_cols="ifa", method_type="supervised", label_col="income",
                               event_label=">50K").to_pandas()
    b = cat_to_num_supervised(pt, drop_cols="ifa", label_col="income", event_label=">50K").to_pandas()
    pd.testing.assert_frame_equal(a, b)
