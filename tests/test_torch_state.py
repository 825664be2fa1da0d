"""The port's serving state contract against the JAX package's:
``fitted_state`` → JSON → ``from_state().apply`` for every servable family
on ``anovos_tpu/serving/demo.py``'s frame.

- The JSON documents have the same structure (keys, family, apply_config,
  cols, table names and columns); the categorical families' models
  (binning cutoffs of equal_frequency, label codes, target rates, keep
  sets, MMM fills, boxcox λ) are equal, the moment-based numeric ones
  (z mean/stddev, equal-range cutoffs) within 1e-6 relative of the
  column's scale.
- A served apply is byte-identical to the batch fit + apply, in the port.
- Each package's state applies in the other package and gives that
  package's batch result (the states are interchangeable)."""

import json

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_frames_close, torch_cpu_runtime  # noqa: F401

FAMILY_CASES = [
    ("attribute_binning", {"list_of_cols": ["age", "hours"], "bin_size": 6}),
    ("attribute_binning", {"list_of_cols": ["age"], "method_type": "equal_frequency",
                           "bin_size": 4, "bin_dtype": "categorical", "output_mode": "append"}),
    ("z_standardization", {"list_of_cols": ["age", "fnlwgt"]}),
    ("IQR_standardization", {"list_of_cols": ["hours"]}),
    ("normalization", {"list_of_cols": ["fnlwgt", "hours"], "output_mode": "append"}),
    ("imputation_MMM", {"list_of_cols": ["age", "workclass"], "method_type": "median"}),
    ("cat_to_num_unsupervised", {"list_of_cols": ["workclass", "education"],
                                 "method_type": "label_encoding"}),
    ("cat_to_num_supervised", {"list_of_cols": ["workclass"], "label_col": "label",
                               "event_label": "1", "output_mode": "append"}),
    ("outlier_categories", {"list_of_cols": ["education"], "coverage": 0.8, "max_category": 4}),
    ("boxcox_transformation", {"list_of_cols": ["hours"]}),
    ("feature_transformation", {"list_of_cols": ["hours"], "method_type": "sqrt", "output_mode": "append"}),
]
IDS = [f"{f}-{i}" for i, (f, _) in enumerate(FAMILY_CASES)]
# model columns fitted from f32 moments: within 1e-6 of the column's scale
MOMENT_FAMILIES = {"z_standardization": ("mean", "stddev"), "attribute_binning": ("parameters",)}


@pytest.fixture(scope="module")
def tables():
    from anovos_tpu.serving.demo import demo_frame
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = demo_frame(600, seed=7)
    return JTable.from_pandas(df), Table.from_pandas(df, device="cpu"), df


def _frames_equal(a: pd.DataFrame, b: pd.DataFrame) -> bool:
    if list(a.columns) != list(b.columns) or len(a) != len(b):
        return False
    for c in a.columns:
        na_a, na_b = a[c].isna(), b[c].isna()
        if not (na_a == na_b).all() or not (a[c][~na_a].values == b[c][~na_b].values).all():
            return False
    return True


def _assert_tables_close(got: dict, exp: dict, scale_cols, scale: float):
    assert list(got) == list(exp)
    for col in exp:
        g, e = got[col], exp[col]
        if col in scale_cols:
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(e, float), rtol=0, atol=1e-6 * scale)
        else:
            assert g == e, col


@pytest.mark.parametrize("family,cfg", FAMILY_CASES, ids=IDS)
def test_fitted_state_matches_jax(tables, family, cfg):
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    jt, pt, df = tables
    got = json.loads(json.dumps(ptr.fitted_state(pt, family, cfg)))
    exp = json.loads(json.dumps(jtr.fitted_state(jt, family, cfg)))
    assert sorted(got) == sorted(exp)
    for k in ("state_version", "family", "apply_config", "cols"):
        assert got[k] == exp[k], k
    if exp["model"] is None:
        assert got["model"] is None
        return
    assert got["model"]["fmt"] == exp["model"]["fmt"]
    assert list(got["model"]["tables"]) == list(exp["model"]["tables"])
    scale = float(np.nanmax(np.abs(df[got["cols"]].to_numpy(np.float64)))) if family in MOMENT_FAMILIES else 1.0
    scale_cols = MOMENT_FAMILIES.get(family, ()) if cfg.get("method_type") != "equal_frequency" else ()
    for name, tab in exp["model"]["tables"].items():
        _assert_tables_close(got["model"]["tables"][name], tab, scale_cols, scale)


@pytest.mark.parametrize("family,cfg", FAMILY_CASES, ids=IDS)
def test_from_state_apply_is_byte_identical_to_batch(tables, tmp_path, family, cfg):
    from anovos_tpu_torch.data_transformer import transformers as ptr

    _, pt, _ = tables
    kwargs = dict(cfg)
    if ptr._STATE_MODEL_FMT.get(family):
        kwargs["model_path"] = str(tmp_path / "m")
    batch = getattr(ptr, family)(pt, **kwargs).to_pandas()
    state = json.loads(json.dumps(ptr.fitted_state(pt, family, cfg)))
    served = ptr.from_state(state).apply(pt).to_pandas()
    assert _frames_equal(batch, served), family


@pytest.mark.parametrize("family,cfg", FAMILY_CASES, ids=IDS)
def test_states_cross_between_packages(tables, family, cfg):
    """The JAX state applied by the port equals the JAX package's own
    apply of it: exactly, but for the power transforms (boxcox within
    2e-6 relative, as in test_torch_transformers_math.py) and sqrt (two
    ulps: torch's vectorized CPU sqrt is not correctly rounded)."""
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch.data_transformer import transformers as ptr

    jt, pt, _ = tables
    state = json.loads(json.dumps(jtr.fitted_state(jt, family, cfg)))
    got = ptr.from_state(state).apply(pt).to_pandas()
    exp = jtr.from_state(state).apply(jt).to_pandas()
    rtol = {"boxcox_transformation": 2e-6, "feature_transformation": 2.4e-7}.get(family, 0.0)
    assert_frames_close(got, exp, rtol=rtol)


def test_state_errors(tables):
    from anovos_tpu_torch.data_transformer import transformers as ptr

    _, pt, _ = tables
    with pytest.raises(ValueError, match="not a servable"):
        ptr.fitted_state(pt, "expression_parser", {})
    state = ptr.fitted_state(pt, "z_standardization", {"list_of_cols": ["age"]})
    with pytest.raises(ValueError, match="version"):
        ptr.from_state(dict(state, state_version=99))
    with pytest.raises(ValueError, match="unknown transformer family"):
        ptr.FittedTransformer(dict(state, family="nope"))


def test_namespace_has_every_public_name_of_the_jax_one():
    """The port's transformers namespace (the runner's getattr target)
    holds every public name of the JAX package's; the geospatial
    transformers, which neither namespace re-exports (so both runners
    raise AttributeError for them), are all in the port's geospatial
    module under the JAX names."""
    from anovos_tpu.data_transformer import transformers as jtr
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.data_transformer import geospatial as pgeo
    from anovos_tpu_torch.data_transformer import transformers as ptr

    assert [n for n in jtr.__all__ if not hasattr(ptr, n)] == []
    assert not hasattr(workflow, "NOT_PORTED")  # the runner refuses no block
    import anovos_tpu.data_transformer.geospatial as jgeo

    public = sorted(n for n, v in vars(jgeo).items() if callable(v) and not n.startswith("_")
                    and getattr(v, "__module__", "") == jgeo.__name__)
    assert len(public) == 11
    assert [n for n in public if getattr(getattr(pgeo, n, None), "__module__", "") != pgeo.__name__] == []
    assert [n for n in public if hasattr(ptr, n) or hasattr(jtr, n)] == []
