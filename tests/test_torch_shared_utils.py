"""The port's shared helpers against the JAX package's: the path rewrites
and frame helpers of ``shared/utils.py`` on a port Table and on a pandas
frame, and ``ops/describe.describe_wide_int`` on (hi, lo) int32 pairs."""

import numpy as np
import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("path", ["dbfs:/mnt/data/x.csv", "/dbfs/mnt/x", "s3://bucket/key",
                                  "wasbs://box@acct.blob.core.windows.net/dir/file.parquet", "wasbs://nobody",
                                  "relative/path", ""])
def test_path_rewrites_equal_jax(path):
    from anovos_tpu.shared import utils as ju
    from anovos_tpu_torch.shared import utils

    assert utils.output_to_local(path) == ju.output_to_local(path)
    assert utils.path_ak8s_modify(path) == ju.path_ak8s_modify(path)


def _frame():
    return pd.DataFrame({"attribute": ["a", "b", "c"], "mean": [1.0, np.nan, 3.5], "count": [3, 0, 7],
                         "kind": ["x", "y", None], "when": pd.to_datetime(["2020-01-01", None, "2021-05-06"]),
                         "flag": [True, False, True]})


def test_segregation_and_dtypes_equal_jax():
    """On a Table the Table's kinds and Spark-style names, on a pandas
    frame its dtype kinds and names: both packages alike."""
    from anovos_tpu.shared import utils as ju
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared import utils
    from anovos_tpu_torch.shared.table import Table

    df = _frame()
    pt, jt = Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)
    assert utils.attributeType_segregation(pt) == ju.attributeType_segregation(jt)
    assert utils.attributeType_segregation(df) == ju.attributeType_segregation(df)
    for c in df.columns:
        assert utils.get_dtype(pt, c) == ju.get_dtype(jt, c), c
        assert utils.get_dtype(df, c) == ju.get_dtype(df, c), c


def test_flatten_and_transpose_equal_jax():
    from anovos_tpu.shared import utils as ju
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared import utils
    from anovos_tpu_torch.shared.table import Table

    df = _frame()[["attribute", "mean", "count"]]
    pt, jt = Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)
    for a, b in ((df, df), (pt, jt)):
        pd.testing.assert_frame_equal(utils.flatten_dataframe(a, ["attribute"]),
                                      ju.flatten_dataframe(b, ["attribute"]))
        pd.testing.assert_frame_equal(utils.transpose_dataframe(a, "attribute"),
                                      ju.transpose_dataframe(b, "attribute"))
    t = utils.transpose_dataframe(df, "attribute")
    assert list(t["key"]) == ["mean", "count"] and list(t.columns) == ["key", "a", "b", "c"]


def _pairs(v: np.ndarray):
    return (v >> 32).astype(np.int32), ((v & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)


def test_describe_wide_int_equals_jax():
    """Counts, distinct counts, the percentile grid and the mode as
    (hi, lo) pairs, equal to the JAX program's on int64 columns past
    2^32 and negative, with nulls, ties and an all-null column."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.describe import describe_wide_int as jdw
    from anovos_tpu_torch.ops.describe import describe_wide_int

    g = np.random.default_rng(4)
    rows = 1000
    v = np.stack([g.integers(-2 ** 40, 2 ** 40, rows), g.integers(0, 5, rows) * (2 ** 33) - 7,
                  np.full(rows, 2 ** 62 + 3), g.integers(-10, 10, rows)], 1).astype(np.int64)
    M = g.random((rows, 4)) > 0.1
    M[:, 2] = False
    hi, lo = _pairs(v)
    got = describe_wide_int(torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(M))
    exp = jdw(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(M))
    assert set(got) == set(exp)
    for k in exp:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]), err_msg=k)
    back = (got["pctl_hi"].numpy().astype(np.int64) << 32) + got["pctl_lo"].numpy() + (1 << 31)
    np.testing.assert_array_equal(back[:, 0], np.sort(v[M[:, 0], 0])[np.floor(
        np.array([0.0, 0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99, 1.0], np.float32)
        * np.float32(M[:, 0].sum() - 1)).astype(int)])
