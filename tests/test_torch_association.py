"""The association evaluator of the port against the JAX package's:
``IV_calculation`` and ``IG_calculation`` on the income schema with label
``income`` / ``'>50K'`` (equal-frequency bins, as configs_full.yaml asks),
``variable_clustering`` on columns in clear correlated groups, and the
argument errors.  IV and IG come from integer counts, so their 4-decimal
values are equal; VarClus runs on f32 correlations of two packages, so its
clusters are equal and RS_Ratio is within 1e-4 (one step of its 4
decimals)."""

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, income_frame, jax_and_port, torch_cpu_runtime  # noqa: F401

ENCODING = {"bin_method": "equal_frequency", "bin_size": 10, "monotonicity_check": 0}


@pytest.fixture(scope="module")
def income():
    df = income_frame(4000, seed=12)
    df.loc[::17, "workclass"] = None
    df.loc[::29, "income"] = None
    return jax_and_port(df)


@pytest.mark.parametrize("fn", ["IV_calculation", "IG_calculation"])
def test_iv_ig_match_jax(income, fn):
    from anovos_tpu.data_analyzer import association_evaluator as jae
    from anovos_tpu_torch.data_analyzer import association_evaluator as pae

    jt, pt = income
    kw = dict(list_of_cols="all", drop_cols="ifa", label_col="income", event_label=">50K",
              encoding_configs=ENCODING)
    exp, got = getattr(jae, fn)(jt, **kw), getattr(pae, fn)(pt, **kw)
    assert_frames_close(got, exp)
    assert "income" not in set(got["attribute"]) and got.iloc[:, 1].notna().all()


def test_iv_of_categories_by_hand(income):
    """IV of a categorical column from pandas counts (nulls their own group)."""
    from anovos_tpu_torch.data_analyzer.association_evaluator import IV_calculation

    _, pt = income
    df = pt.to_pandas()
    df = df[df["income"].notna()]
    y = (df["income"] == ">50K").astype(float)
    tab = y.groupby(df["workclass"].fillna("<null>")).agg(["sum", "count"])
    l1 = tab["sum"].to_numpy(float)
    l0 = (tab["count"] - tab["sum"]).to_numpy(float)
    ev, nev = l1 / l1.sum(), l0 / l0.sum()
    iv = round(float(np.sum((nev - ev) * np.log(nev / ev))), 4)
    got = IV_calculation(pt, ["workclass"], label_col="income", event_label=">50K")
    assert got.loc[0, "iv"] == iv


def clustered_frame(n=3000, seed=3):
    """Two tight groups of numeric columns, a categorical column ordered
    with the first group, a constant column (dropped) and nulls (imputed)."""
    g = np.random.default_rng(seed)
    x, z = g.normal(size=n), g.normal(size=n)
    df = pd.DataFrame({"x": x, "y": x + g.normal(size=n) * 0.2, "z": z,
                       "w": z + g.normal(size=n) * 0.2, "v": 0.5 * z + g.normal(size=n) * 0.3,
                       "const": np.full(n, 2.0)})
    df["grade"] = np.where(x > 0.7, "c", np.where(x < -0.7, "a", "b")).astype(object)
    df.loc[g.random(n) < 0.05, "y"] = np.nan
    df.loc[g.random(n) < 0.05, "grade"] = None
    return df


def test_variable_clustering_matches_jax():
    from anovos_tpu.data_analyzer.association_evaluator import variable_clustering as jvc
    from anovos_tpu_torch.data_analyzer.association_evaluator import variable_clustering as pvc

    jt, pt = jax_and_port(clustered_frame())
    exp, got = jvc(jt), pvc(pt)
    assert list(got.columns) == ["Cluster", "Attribute", "RS_Ratio"]
    assert got["Cluster"].tolist() == exp["Cluster"].tolist()
    assert got["Attribute"].tolist() == exp["Attribute"].tolist()
    np.testing.assert_allclose(got["RS_Ratio"], exp["RS_Ratio"], rtol=0, atol=1e-4 * (1 + 1e-6))
    by = got.set_index("Attribute")["Cluster"]
    assert "const" not in by.index
    assert by["x"] == by["y"] == by["grade"] and by["z"] == by["w"] == by["v"] != by["x"]


def test_association_argument_errors(income):
    from anovos_tpu_torch.data_analyzer import association_evaluator as pae

    _, pt = income
    for fn in (pae.IV_calculation, pae.IG_calculation):
        with pytest.raises(TypeError, match="Column"):
            fn(pt, ["income"], label_col="income", event_label=">50K")
        with pytest.raises(TypeError, match="Label Column"):
            fn(pt, ["age"], label_col="no_such_label")
    with pytest.raises(TypeError):
        pae.variable_clustering(pt, [])


def test_chip_smoke_runs_the_association_block():
    """chip_smoke.py keeps its own copy of configs_full.yaml's
    cat_to_num_transformer and association_evaluator blocks (the GPU
    machine may lack a YAML reader): they must be the file's."""
    import pathlib

    import yaml

    import chip_smoke

    cfg = yaml.safe_load((pathlib.Path(__file__).resolve().parents[1] / "config" / "configs_full.yaml")
                         .read_text())
    assert chip_smoke.ASSOC_CONFIG == cfg["association_evaluator"]
    assert list(chip_smoke.ASSOC_CONFIG) == list(cfg["association_evaluator"])
    assert chip_smoke.CAT_TO_NUM_CONFIG == cfg["cat_to_num_transformer"]
