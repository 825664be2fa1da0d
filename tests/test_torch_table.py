"""The port's Table against the JAX package's on the same frame."""

import numpy as np
import pandas as pd
import pytest

from _torch_port import income_frame, port_table_from_jax, torch_cpu_runtime  # noqa: F401


def _frame():
    df = income_frame(3000)
    g = np.random.default_rng(5)
    # wide int64 ids outside int32, an int64 column inside it, a float32
    # column, booleans and timestamps with nulls
    df["big_id"] = (np.int64(3) << 40) + g.integers(0, 1 << 20, len(df))
    df["small_int64"] = g.integers(-5, 5, len(df)).astype(np.int64)
    df["f32"] = g.normal(0, 1, len(df)).astype(np.float32)
    df["flag"] = g.random(len(df)) < 0.5
    ts = pd.Series(pd.Timestamp("2020-01-01") + pd.to_timedelta(g.integers(0, 900, len(df)), unit="D"))
    ts[::7] = pd.NaT
    df["when"] = ts
    df.loc[::11, "workclass"] = None
    return df


def test_from_pandas_matches_jax_table():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = _frame()
    jt = JTable.from_pandas(df)
    pt = Table.from_pandas(df)
    assert pt.col_names == jt.col_names
    assert pt.dtypes() == jt.dtypes()
    assert pt.attribute_type_segregation() == jt.attribute_type_segregation()
    n = jt.nrows
    for name, jc in jt.columns.items():
        pc = pt.columns[name]
        assert pc.kind == jc.kind, name
        np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(jc.mask)[:n], err_msg=name)
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(jc.data)[:n], err_msg=name)
        assert pc.data.numpy().dtype == np.asarray(jc.data).dtype, name
        if jc.kind == "cat":
            assert list(pc.vocab) == list(jc.vocab), name
        assert pc.is_wide == jc.is_wide, name
        if jc.is_wide:
            exact = pc.exact_host()
            assert exact.dtype == (np.int64 if jc.wide_kind == "int" else np.float64)
            np.testing.assert_array_equal(exact, jc.exact_host(n), err_msg=name)
    wide = [c for c in pt.col_names if pt.columns[c].is_wide]
    assert {"big_id", "fnlwgt", "latitude", "longitude"} <= set(wide)


def test_to_pandas_round_trip_matches_jax():
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = _frame()
    got = Table.from_pandas(df).to_pandas()
    exp = JTable.from_pandas(df).to_pandas()
    pd.testing.assert_frame_equal(got, exp)


def test_convert_round_trip_equals_direct_build():
    """A JAX Table carried over through shared/convert.py gives the same
    port Table as building it from the frame directly."""
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared.table import Table

    df = _frame()
    jt = JTable.from_pandas(df)
    conv = port_table_from_jax(jt)
    direct = Table.from_pandas(df)
    assert conv.nrows == direct.nrows and conv.dtypes() == direct.dtypes()
    for name in direct.col_names:
        a, b = conv.columns[name], direct.columns[name]
        assert a.kind == b.kind and a.is_wide == b.is_wide
        assert a.data.equal(b.data) and a.mask.equal(b.mask), name
        if b.is_wide:
            assert a.exact.dtype == b.exact.dtype and a.exact.equal(b.exact), name
    pd.testing.assert_frame_equal(conv.to_pandas(), direct.to_pandas())


@pytest.mark.parametrize("op", ["select", "drop", "rename", "numeric_block"])
def test_column_ops(op):
    from anovos_tpu_torch.shared.table import Table

    t = Table.from_pandas(_frame())
    if op == "select":
        s = t.select(["age", "race"])
        assert s.col_names == ["age", "race"] and s.nrows == t.nrows
        with pytest.raises(KeyError):
            t.select(["nope"])
    elif op == "drop":
        assert "age" not in t.drop(["age"]).col_names
    elif op == "rename":
        r = t.rename({"age": "years"})
        assert r.col_names[t.col_names.index("age")] == "years"
        assert r["years"] is t["age"]
    else:
        X, M = t.numeric_block(["age", "fnlwgt"])
        assert X.shape == (t.nrows, 2) and X.t().is_contiguous() and M.t().is_contiguous()
        assert not M[:, 0].all() and M[:, 1].all()
