"""The rest of ingest in the port against the JAX package:
``concatenate_dataset`` (two methods), ``write_dataset`` (four formats,
three modes), ``recommend_type`` and Avro files crossing between the
packages (``join_dataset``: ``tests/test_torch_ingest_join.py``).  All
results are exact: codes, counts and values written and read back."""

import os

import numpy as np
import pandas as pd
import pytest

from _torch_port import jax_and_port, join_sides, torch_cpu_runtime  # noqa: F401

@pytest.mark.parametrize("method_type", ["name", "index"])
def test_concatenate_dataset_matches_jax(method_type):
    from anovos_tpu.data_ingest.data_ingest import concatenate_dataset as jcat
    from anovos_tpu_torch.data_ingest.data_ingest import concatenate_dataset

    a, b = join_sides(3)
    b = b.rename(columns={"b_num": "a_num", "b_cat": "a_cat", "b_int": "a_int"})
    b["a_cat"] = b["a_cat"].replace({"x": "w"})  # a value only one part has
    b["a_int"] = b["a_int"].astype(np.float64)  # int32 meets f32
    if method_type == "index":
        b = b[list(a.columns)].set_axis([f"c{i}" for i in range(a.shape[1])], axis=1)
    else:
        b = b[list(a.columns)[::-1]]
    (ja, pa_), (jb, pb), (jc, pc) = jax_and_port(a), jax_and_port(b), jax_and_port(a.iloc[:7])
    got = concatenate_dataset(pa_, pb, pc, method_type=method_type)
    exp = jcat(ja, jb, jc, method_type=method_type)
    assert got.dtypes() == exp.dtypes()
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    assert got.columns["kbig"].is_wide_int
    np.testing.assert_array_equal(got.to_pandas()["kbig"].to_numpy()[: len(a)], a["kbig"].to_numpy())
    assert list(got.columns["a_cat"].vocab) == ["w", "x", "y", "z"]


def test_concatenate_small_and_wide_ints_stays_exact():
    from anovos_tpu.data_ingest.data_ingest import concatenate_dataset as jcat
    from anovos_tpu_torch.data_ingest.data_ingest import concatenate_dataset

    small = pd.DataFrame({"v": np.array([1, -5, 7], np.int64)})
    wide = pd.DataFrame({"v": np.array([2**53 + 1, -(2**40) - 3], np.int64)})
    (js, ps), (jw, pw) = jax_and_port(small), jax_and_port(wide)
    got, exp = concatenate_dataset(ps, pw), jcat(js, jw)
    assert got.dtypes() == exp.dtypes() == [("v", "bigint")]
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    assert got.to_pandas()["v"].tolist() == [1, -5, 7, 2**53 + 1, -(2**40) - 3]


def _write_frame():
    from examples._data import synthesize

    df = synthesize(240, seed=11).drop(columns=["empty", "logfnl"])
    df["big"] = np.arange(len(df), dtype=np.int64) * 3 + 2**41
    df["whole"] = np.arange(len(df), dtype=np.float64)  # whole-valued floats keep their dtype
    return df


@pytest.mark.parametrize("file_type", ["csv", "parquet", "avro", "json"])
def test_write_dataset_reads_back_in_both_packages(file_type, tmp_path):
    from anovos_tpu.data_ingest.data_ingest import read_dataset as jread
    from anovos_tpu.data_ingest.data_ingest import write_dataset as jwrite
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset, write_dataset

    df = _write_frame()
    jt, pt = jax_and_port(df)
    out = str(tmp_path / "p")
    write_dataset(pt, out, file_type, {"repartition": 3})
    parts = sorted(os.listdir(out))
    assert parts == ["_SUCCESS"] + [f"part-0000{i}.{file_type}" for i in range(3)]
    got, exp = read_dataset(out, file_type), jread(out, file_type)
    assert got.dtypes() == exp.dtypes()
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    pd.testing.assert_frame_equal(got.to_pandas(), pt.to_pandas(), check_dtype=False)
    with pytest.raises(FileExistsError):
        write_dataset(pt, out, file_type)
    write_dataset(pt.slice_rows(0, 50), out, file_type, {"mode": "overwrite"})
    assert read_dataset(out, file_type).nrows == 50
    # append writes its parts beside the old ones, the same names replaced,
    # as the JAX package does
    write_dataset(pt.slice_rows(0, 20), out, file_type, {"mode": "append", "repartition": 2})
    jout = str(tmp_path / "j")
    jwrite(jt.gather_rows(np.arange(50)), jout, file_type, {"mode": "overwrite"})
    jwrite(jt.gather_rows(np.arange(20)), jout, file_type, {"mode": "append", "repartition": 2})
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    pd.testing.assert_frame_equal(read_dataset(out, file_type).to_pandas(),
                                  jread(jout, file_type).to_pandas())


def test_avro_files_cross_between_packages(tmp_path):
    """A JAX-written Avro part read by the port and a port-written one by
    the JAX package, with ``column_order``; numeric-looking string columns
    become numeric in both."""
    from anovos_tpu.data_ingest.data_ingest import read_dataset as jread
    from anovos_tpu.data_ingest.data_ingest import write_dataset as jwrite
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset, write_dataset

    df = _write_frame()
    df["numstr"] = [str(i % 17) for i in range(len(df))]
    df.loc[::13, "numstr"] = None
    jt, pt = jax_and_port(df)
    order = ["ifa", "numstr", "age", "big", "workclass"]
    jwrite(jt, str(tmp_path / "j"), "avro", column_order=order)
    write_dataset(pt, str(tmp_path / "p"), "avro", column_order=order)
    for d in ("j", "p"):
        got, exp = read_dataset(str(tmp_path / d), "avro"), jread(str(tmp_path / d), "avro")
        assert got.col_names == order and got.dtypes() == exp.dtypes()
        pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    assert read_dataset(str(tmp_path / "j"), "avro").columns["numstr"].kind == "num"


def test_recommend_type_matches_jax():
    from anovos_tpu.data_ingest.data_ingest import recommend_type as jrec
    from anovos_tpu_torch.data_ingest.data_ingest import recommend_type

    df = _write_frame()
    df.loc[::5, "race"] = None
    jt, pt = jax_and_port(df)
    for kw in ({}, {"dynamic_threshold": 0.5, "static_threshold": 30, "drop_cols": "ifa"}):
        pd.testing.assert_frame_equal(recommend_type(pt, **kw), jrec(jt, **kw))
    with pytest.raises(TypeError):
        recommend_type(pt, dynamic_threshold=0)
