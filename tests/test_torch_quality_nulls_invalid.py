"""quality_checker's null-column and invalid-entry treatments of the port
against the JAX package's on the table of ``tests/test_torch_quality.py``:
nullColumns row_removal, column_removal and MMM, the imputers that are
not ported yet, invalid-entry treatments, manual rules and integer
columns.  Bands as there."""

import numpy as np
import pandas as pd
import pytest

from _torch_port import (assert_frames_close, assert_quality_same, quality_both,  # noqa: F401
                         quality_tables, torch_cpu_runtime)


@pytest.fixture(scope="module")
def tables():
    return quality_tables()


@pytest.mark.parametrize("method,configs", [
    ("row_removal", {}), ("row_removal", {"treatment_threshold": 0.02}),
    ("column_removal", {"treatment_threshold": 0.02}),
    ("MMM", {"method_type": "mean"}), ("MMM", {"method_type": "median", "output_mode": "append"}),
])
def test_null_columns_treatments_match_jax(tables, method, configs):
    jt, pt = tables
    got, exp = quality_both("nullColumns_detection", jt, pt, list_of_cols="all", drop_cols=["ifa"],
                     treatment=True, treatment_method=method, treatment_configs=configs)
    assert_quality_same(got, exp, rtol=1e-6)


@pytest.mark.parametrize("method", ["null_replacement", "column_removal", "MMM"])
def test_invalid_entries_treatments_match_jax(tables, method):
    jt, pt = tables
    got, exp = quality_both("invalidEntries_detection", jt, pt, list_of_cols="tokens|score|age",
                     treatment=True, treatment_method=method, treatment_threshold=0.001,
                     treatment_configs={"method_type": "mean"})
    assert_quality_same(got, exp, rtol=1e-6)
    stats = got[1].set_index("attribute")
    # "###" is no auto token: the repeat rule takes letters and digits only
    assert stats.loc["tokens", "invalid_entries"] == "aaa|abc|n/a|unknown"


def test_invalid_entries_manual_rules_match_jax(tables):
    jt, pt = tables
    got, exp = quality_both("invalidEntries_detection", jt, pt, list_of_cols="tokens|education|score",
                     detection_type="both", invalid_entries=["gam.*"], valid_entries=["[a-z#/]+", "\\d+"],
                     partial_match=False)
    assert_quality_same(got, exp)


def test_invalid_entries_on_integer_columns():
    """Integer columns stay integer: int32 and exact int64 values are
    checked as ``str(int(v))``.  The invalid values equal the JAX
    package's; the counts equal numpy's.  The JAX package counts 0 rows on
    an int32 column (its ``_member_mask`` pads the sorted distinct values
    with f32 max cast to int32, which wraps to INT32_MIN, so its
    searchsorted misses): a fault of the reference the port does not copy
    (ROADMAP.md Queue C)."""
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    g = np.random.default_rng(3)
    n = 1500
    df = pd.DataFrame({"code": g.choice([7, 123, 456, 1000, 2], n).astype(np.int32),
                       "big": g.choice([3_000_000_000, 1_111_111_111_111, 5, 9_876_543_210], n)})
    jt, pt = JTable.from_pandas(df), Table.from_pandas(df, device="cpu")
    assert pt.columns["big"].is_wide_int and jt.columns["big"].is_wide
    (po, ps), (jo, js) = quality_both("invalidEntries_detection", jt, pt, list_of_cols="all", treatment=True)
    assert list(ps["invalid_entries"]) == list(js["invalid_entries"]) == ["123|456", "1111111111111"]
    assert list(ps["invalid_count"]) == [int(df["code"].isin([123, 456]).sum()),
                                         int((df["big"] == 1_111_111_111_111).sum())]
    assert list(js["invalid_count"]) == [0, ps["invalid_count"][1]]
    assert_frames_close(po.to_pandas()[["big"]], jo.to_pandas()[["big"]])
    assert po.to_pandas()["code"].isna().sum() == ps["invalid_count"][0]


@pytest.mark.parametrize("method", ["KNN", "regression", "MF", "auto"])
def test_model_based_imputers_not_ported_yet(tables, method):
    """The model-based treatments are ported now (the name is kept): on
    the quality frame KNN, regression and MF impute its numeric columns as
    the JAX package does (KNN within 1e-5 relative, the ridge within 2e-4
    relative, MF's completions, from the port's own ALS draws, finite;
    the frame's all-null column left out, whose NaN mean would reach every
    predicted cell in both packages);
    auto refuses the frame's categorical columns with the JAX package's
    TypeError (its column resolution takes numeric columns only)."""
    from anovos_tpu.data_analyzer.quality_checker import nullColumns_detection as jnull
    from anovos_tpu_torch.data_analyzer.quality_checker import nullColumns_detection

    jt, pt = tables
    kw = dict(list_of_cols="all", drop_cols=["ifa"], treatment=True, treatment_method=method)
    if method == "auto":
        with pytest.raises(TypeError, match="non-numerical") as pe:
            nullColumns_detection(pt, **kw)
        with pytest.raises(TypeError) as je:
            jnull(jt, **kw)
        assert str(pe.value) == str(je.value)
        return
    # the all-null column's NaN mean would fill every cell the ridge and MF
    # predict with NaN, in both packages: they impute the other columns
    jt, pt = jt.drop(["empty"]), pt.drop(["empty"])
    (po, ps), (jo, js) = nullColumns_detection(pt, **kw), jnull(jt, **kw)
    assert_frames_close(ps, js)
    assert po.col_names == jo.col_names and po.dtypes() == jo.dtypes()
    num = [c for c in po.col_names if po.columns[c].kind == "num"]
    g, e = po.to_pandas(), jo.to_pandas()
    assert not g[num].isna().any().any()
    if method == "MF":
        assert_frames_close(g.drop(columns=num), e.drop(columns=num))
        assert np.isfinite(g[num].to_numpy(np.float64)).all()
        return
    tol = 1e-5 if method == "KNN" else 2e-4
    assert_frames_close(g, e, rtol=tol, atol=tol)
