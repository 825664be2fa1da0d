"""quality_checker of the port against the JAX package's: the seven checks
with the ``config/configs_full.yaml`` arguments and their treatments,
chained as the workflow runs them, on a 2,100-row table (below every
``sample_size``, so neither package samples), and ``row_signature`` bit
for bit.  More treatments: ``tests/test_torch_quality_treatments.py`` and
``tests/test_torch_quality_nulls_invalid.py``.

Counts, flags, codes, stats and treated integer/categorical values are
equal; numeric values within 1e-6 relative, for the f32 values that the
stdev fence clips and the mean fills (the moments kernel's plain version
and the Pallas kernel sum in other orders).
"""

import numpy as np
import pytest

from _torch_port import (QUALITY_CONFIG, assert_quality_same, quality_both,  # noqa: F401
                         quality_tables, torch_cpu_runtime)


@pytest.fixture(scope="module")
def tables():
    return quality_tables()


def test_row_signature_bit_for_bit():
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.segment import row_signature as jsig
    from anovos_tpu_torch.ops.segment import row_signature

    g = np.random.default_rng(0)
    X = g.integers(-(2**31), 2**31, (3000, 7), dtype=np.int64).astype(np.int32)
    X[:, 1] = g.integers(-5, 5, 3000)
    X[0] = np.iinfo(np.int32).min
    X[1] = np.iinfo(np.int32).max
    X[2] = -2
    M = g.random((3000, 7)) > 0.2
    exp = np.asarray(jsig(jnp.asarray(X), jnp.asarray(M)))
    got = row_signature(torch.from_numpy(X), torch.from_numpy(M)).numpy()
    assert exp.dtype == np.uint32 and got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), exp)


@pytest.fixture(scope="module")
def chained(tables):
    """The seven checks with the config's arguments in its order, each on
    the previous one's treated table, as the workflow runs them:
    {check: (port result, JAX result)}."""
    jt, pt = tables
    out = {}
    for check, kw in QUALITY_CONFIG.items():
        got, exp = quality_both(check, jt, pt, **kw)
        out[check] = got, exp
        pt, jt = got[0], exp[0]
    return out


@pytest.mark.parametrize("check", list(QUALITY_CONFIG))
def test_check_with_config_arguments_matches_jax(chained, check):
    got, exp = chained[check]
    assert_quality_same(got, exp, rtol=1e-6)
    stats = got[1]
    if check == "duplicate_detection":
        assert stats.set_index("metric").loc["duplicate_rows", "value"] >= 100
    if check == "invalidEntries_detection":
        inv = stats.set_index("attribute")
        assert inv.loc["tokens", "invalid_count"] > 0
        assert inv.loc["score", "invalid_entries"] == "111.0"
    if check == "IDness_detection":
        assert "fnlwgt" not in got[0].col_names  # distinct in every row
    if check == "nullColumns_detection":
        assert all(bool(c.mask.all()) for c in got[0].columns.values())


def test_chip_smoke_runs_the_config_block():
    """chip_smoke.py keeps its own copy of the block (the GPU machine may
    lack a YAML reader): it must be the file's."""
    import chip_smoke

    assert chip_smoke.QUALITY_CONFIG == QUALITY_CONFIG
    assert list(chip_smoke.QUALITY_CONFIG) == list(QUALITY_CONFIG)


@pytest.mark.parametrize("config,name", [("configs_basic.yaml", "TS_BASIC_CONFIG"),
                                         ("configs_full.yaml", "TS_FULL_CONFIG")])
def test_chip_smoke_runs_the_timeseries_block(config, name):
    """chip_smoke.py's copies of the two configs' timeseries_analyzer
    blocks are the files'."""
    import pathlib

    import yaml

    import chip_smoke

    path = pathlib.Path(__file__).resolve().parents[1] / "config" / config
    assert getattr(chip_smoke, name) == yaml.safe_load(path.read_text())["timeseries_analyzer"]
