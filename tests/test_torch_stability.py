"""stability_index_computation of the port against the JAX package's, over
three slices of one frame.

The per-slice mean / stddev / kurtosis come from f32 moments (the port's
moments kernel against the JAX two-pass reductions); the CVs derived from
them are rounded to 4 decimals, so they are compared within 1e-4 plus
rel 1e-5, and the 0-4 scores and the flags exactly.
"""

import numpy as np
import pandas as pd
import pytest

from _torch_port import income_frame, torch_cpu_runtime  # noqa: F401


def _slices(n=3):
    df = income_frame(9000, seed=21)
    df["hours-per-week"] = df["hours-per-week"] * np.repeat([1.0, 1.2, 1.6], 3000)
    return [df.iloc[i * 3000:(i + 1) * 3000].reset_index(drop=True) for i in range(n)]


@pytest.mark.parametrize("binary", [[], ["label"]])
def test_stability_matches_jax(binary, tmp_path):
    from anovos_tpu.drift_stability.stability import stability_index_computation as jsi
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.drift_stability.stability import stability_index_computation as psi
    from anovos_tpu_torch.shared.table import Table

    frames = _slices()
    exp = jsi(*[JTable.from_pandas(f) for f in frames], binary_cols=binary,
              appended_metric_path=str(tmp_path / "jax"))
    got = psi(*[Table.from_pandas(f, device="cpu") for f in frames], binary_cols=binary,
              appended_metric_path=str(tmp_path / "port"))
    assert list(got.columns) == list(exp.columns)
    for c in ("attribute", "type", "mean_si", "stddev_si", "kurtosis_si", "stability_index", "flagged"):
        assert [None if pd.isna(v) else v for v in got[c]] == \
            [None if pd.isna(v) else v for v in exp[c]], c
    for c in ("mean_stddev", "mean_cv", "stddev_cv", "kurtosis_cv"):
        np.testing.assert_allclose(pd.to_numeric(got[c]).to_numpy(np.float64),
                                   pd.to_numeric(exp[c]).to_numpy(np.float64),
                                   rtol=1e-5, atol=1e-4, equal_nan=True, err_msg=c)
    hist_p = pd.read_csv(tmp_path / "port" / "part-00000.csv")
    hist_j = pd.read_csv(tmp_path / "jax" / "part-00000.csv")
    assert list(hist_p.columns) == list(hist_j.columns) and len(hist_p) == len(hist_j)
    np.testing.assert_allclose(hist_p["mean"], hist_j["mean"], rtol=1e-6)


def test_stability_appends_to_existing_history(tmp_path):
    from anovos_tpu_torch.drift_stability.stability import stability_index_computation
    from anovos_tpu_torch.shared.table import Table

    frames = [Table.from_pandas(f, device="cpu") for f in _slices()]
    stability_index_computation(*frames[:2], appended_metric_path=str(tmp_path / "h"))
    out = stability_index_computation(frames[2], existing_metric_path=str(tmp_path / "h"),
                                      appended_metric_path=str(tmp_path / "h2"))
    hist = pd.read_csv(tmp_path / "h2" / "part-00000.csv")
    assert sorted(hist["idx"].unique()) == [1, 2, 3]
    assert len(out) == len(frames[0].attribute_type_segregation()[0])
