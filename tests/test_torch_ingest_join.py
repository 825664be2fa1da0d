"""``join_dataset`` of the port against the JAX package's: the six join
types on categorical, f32 and exact int64 keys with null keys, two keys
and three tables.  Results are exact."""

import numpy as np
import pandas as pd
import pytest

from _torch_port import JOIN_KEYS, jax_and_port, join_sides, torch_cpu_runtime  # noqa: F401


@pytest.mark.parametrize("join_type", ["inner", "full", "left", "right", "left_semi", "left_anti"])
def test_join_dataset_matches_jax(join_type):
    from anovos_tpu.data_ingest.data_ingest import join_dataset as jjoin
    from anovos_tpu_torch.data_ingest.data_ingest import join_dataset

    left, right = join_sides(1)
    for key in JOIN_KEYS:
        others = [k for k in JOIN_KEYS if k != key]
        jl, pl = jax_and_port(left)
        jr, pr = jax_and_port(right.drop(columns=others))
        got = join_dataset(pl, pr, join_cols=key, join_type=join_type)
        exp = jjoin(jl, jr, join_cols=key, join_type=join_type)
        assert got.dtypes() == exp.dtypes(), key
        pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas(), obj=key)
        if key == "kbig":
            assert got.columns["kbig"].is_wide_int


def test_join_on_two_keys_and_three_tables_matches_jax():
    from anovos_tpu.data_ingest.data_ingest import join_dataset as jjoin
    from anovos_tpu_torch.data_ingest.data_ingest import join_dataset

    left, right = join_sides(2)
    third = right[["kcat", "kf"]].assign(c_num=np.arange(len(right), dtype=np.float64))
    jl, pl = jax_and_port(left)
    jr, pr = jax_and_port(right.drop(columns="kbig"))
    j3, p3 = jax_and_port(third)
    got = join_dataset(pl.drop(["kbig"]), pr, p3, join_cols="kcat|kf", join_type="full")
    exp = jjoin(jl.drop(["kbig"]), jr, j3, join_cols="kcat|kf", join_type="full")
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())
    with pytest.raises(ValueError):
        join_dataset(pl, pr, join_cols="kcat", join_type="inner")  # kf, kbig on both sides
