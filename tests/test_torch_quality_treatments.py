"""quality_checker's outlier treatments of the port against the JAX
package's on the table of ``tests/test_torch_quality.py``: the three
treatments and detection sides, the ``outlier_numcols`` and
``imputation_MMM`` models crossing between the packages, and the fit on
a sample above ``sample_size``.  Bands as there."""

import pandas as pd
import pytest

from _torch_port import (QUALITY_CONFIG, assert_frames_close, assert_quality_same,  # noqa: F401
                         quality_both, quality_tables, torch_cpu_runtime)


@pytest.fixture(scope="module")
def tables():
    return quality_tables()


@pytest.mark.parametrize("side,method", [("upper", "value_replacement"), ("both", "null_replacement"),
                                         ("lower", "row_removal"), ("both", "value_replacement")])
def test_outlier_treatments_match_jax(tables, side, method):
    jt, pt = tables
    kw = dict(QUALITY_CONFIG["outlier_detection"], detection_side=side, treatment_method=method,
              output_mode="append" if method == "null_replacement" else "replace")
    got, exp = quality_both("outlier_detection", jt, pt, **kw)
    assert_quality_same(got, exp, rtol=1e-6)


def test_models_cross_between_packages(tables, tmp_path):
    """outlier_numcols and imputation_MMM written by one package, applied by
    the other with pre_existing_model=True."""
    from anovos_tpu.data_analyzer.quality_checker import outlier_detection as jout
    from anovos_tpu.data_transformer.transformers import imputation_MMM as jimp
    from anovos_tpu_torch.data_analyzer.quality_checker import outlier_detection as pout
    from anovos_tpu_torch.data_transformer.transformers import imputation_MMM as pimp

    jt, pt = tables
    kw = dict(QUALITY_CONFIG["outlier_detection"], detection_side="both")
    for writer, reader, table_w, table_r, d in ((jout, pout, jt, pt, "j"), (pout, jout, pt, jt, "p")):
        mp = str(tmp_path / d)
        w_odf, w_stats = writer(table_w, **dict(kw, model_path=mp))
        r_odf, r_stats = reader(table_r, **dict(kw, model_path=mp, pre_existing_model=True))
        assert_frames_close(r_stats, w_stats)
        assert_frames_close(r_odf.to_pandas(), w_odf.to_pandas())
    for writer, reader, table_w, table_r, d in ((jimp, pimp, jt, pt, "ji"), (pimp, jimp, pt, jt, "pi")):
        mp = str(tmp_path / d)
        w = writer(table_w, list_of_cols="all", method_type="mean", model_path=mp)
        r = reader(table_r, list_of_cols="all", pre_existing_model=True, model_path=mp)
        assert r.dtypes() == w.dtypes()
        assert_frames_close(r.to_pandas(), w.to_pandas())


def test_outlier_detection_samples_above_sample_size(tables):
    """Above sample_size the fences come from a seeded random sample: two
    runs agree, and the counts are those of the returned bounds on all
    rows."""
    from anovos_tpu_torch.data_analyzer.quality_checker import outlier_detection

    _, pt = tables
    kw = dict(QUALITY_CONFIG["outlier_detection"], treatment=False, sample_size=500)
    _, a = outlier_detection(pt, **kw)
    _, b = outlier_detection(pt, **kw)
    pd.testing.assert_frame_equal(a, b)
    _, full = outlier_detection(pt, **dict(kw, sample_size=10**6))
    assert list(a["attribute"]) == list(full["attribute"])
