"""Timestamp auto-detection of the port against the JAX package's: one
Table with a column of every format family of ``tests/test_ts_format_matrix.py``,
epoch-second int columns and two string columns that are no dates go through
both packages' ``ts_preprocess``; the converted columns must have equal
seconds and masks, the others stay as they were, and ``ts_cols_stats.csv``
is equal."""

import numpy as np
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401
from test_ts_format_matrix import CASES

ROWS = 1500


def detection_frame():
    import pandas as pd

    g = np.random.default_rng(23)
    cols = {}
    for i, (vals, _) in enumerate(CASES):
        v = np.array(vals + [None], dtype=object)
        cols[f"fmt{i}"] = v[g.integers(0, len(v), ROWS)]
    # epoch seconds: the first 1,000 rows in the triage range, then rows
    # of small values (still parseable) that sort first among the distinct
    # values, so the families must be scored on the rows in row order
    epoch = g.integers(1_400_000_000, 1_700_000_000, ROWS).astype(np.int32)
    epoch[1000:] = g.integers(0, 400, ROWS - 1000)
    cols["epoch"] = epoch
    cols["epoch_clean"] = g.integers(1_500_000_000, 1_500_100_000, ROWS).astype(np.int32)
    cols["note"] = g.choice(["hello", "world", "foo", "bar"], ROWS)
    cols["code"] = g.choice(["A-17", "B-22", "x", "zz-9"], ROWS)
    cols["amount"] = g.normal(0, 1, ROWS)
    return pd.DataFrame(cols)


@pytest.fixture(scope="module")
def detected(tmp_path_factory):
    from anovos_tpu.data_ingest.ts_auto_detection import ts_preprocess as jpre
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.data_ingest.ts_auto_detection import ts_preprocess as ppre
    from anovos_tpu_torch.shared.table import Table

    df = detection_frame()
    jd, pd_ = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jo = jpre(JTable.from_pandas(df), output_path=str(jd))
    po = ppre(Table.from_pandas(df, device="cpu"), output_path=str(pd_))
    return df, po, jo, pd_, jd


def test_ts_cols_stats_equal(detected):
    _, _, _, pdir, jdir = detected
    got = (pdir / "ts_cols_stats.csv").read_text()
    assert got == (jdir / "ts_cols_stats.csv").read_text()
    assert got.count("converted") == len(CASES) + 2


@pytest.mark.parametrize("col", [f"fmt{i}" for i in range(len(CASES))] + ["epoch", "epoch_clean"])
def test_converted_column_equals_jax(detected, col):
    _, po, jo, _, _ = detected
    got, exp = po[col], jo.columns[col]
    assert got.kind == exp.kind == "ts" and got.dtype_name == exp.dtype_name
    mask = np.asarray(exp.mask)[:jo.nrows]
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.data.numpy()[mask], np.asarray(exp.data)[:jo.nrows][mask])
    np.testing.assert_array_equal(got.data.numpy()[~mask], 0)


def test_other_columns_unchanged(detected):
    df, po, jo, _, _ = detected
    import pandas as pd

    rest = ["note", "code", "amount"]
    assert po.col_names == jo.col_names == list(df.columns)
    pd.testing.assert_frame_equal(po.select(rest).to_pandas(), df[rest])
    pd.testing.assert_frame_equal(po.select(rest).to_pandas(), jo.select(rest).to_pandas())


def test_epoch_seconds_are_pandas(detected):
    import pandas as pd

    df, po, _, _, _ = detected
    exp = pd.to_datetime(df["epoch"], unit="s").to_numpy().astype("datetime64[s]").astype(np.int64)
    np.testing.assert_array_equal(po["epoch"].data.numpy().astype(np.int64), exp)
    assert bool(po["epoch"].mask.all())
