"""HyperLogLog of the port against the JAX package's: registers equal bit
for bit (f32 values with ±0.0 and nulls, int codes, the mixed lanes of
wide int64 and float64 columns), estimates equal, and the approx
``uniqueCount_computation`` frame equal.

The JAX package's ``hll_registers`` adds 0.0 to a float input inside its
jitted program, where XLA folds x + 0.0 to x: −0.0 keeps its bits and
hashes as a value of its own.  The port adds 0.0 eagerly, so −0.0 is
+0.0, as the JAX package's ``uniqueCount_computation`` has it (it adds
0.0 eagerly before the sketch).  The register test gives the JAX call
+0.0 in place of −0.0 and pins the difference."""

import numpy as np
import pytest

from _torch_port import jax_and_port, torch_cpu_runtime  # noqa: F401


def hll_frame(n=5000, seed=21):
    import pandas as pd

    g = np.random.default_rng(seed)
    f = np.round(g.normal(0, 50, n), 1)
    f[::7] = 0.0
    f[::11] = -0.0
    f[::13] = np.nan
    return pd.DataFrame({
        "f": f,
        "code": g.integers(-5, 3000, n).astype(np.int32),
        "cat": g.choice([f"c{i}" for i in range(300)] + [None], n),
        "big_id": (np.int64(1) << 40) + g.integers(0, 4000, n) * np.int64(1 << 33) - np.int64(7),
        "fine": 1.0 + g.integers(0, 2000, n) * 1e-12,
    })


@pytest.mark.parametrize("p", [4, 9, 12])
def test_registers_equal_jax_bit_for_bit(p):
    import jax.numpy as jnp
    import torch

    from anovos_tpu.ops.hll import hll_registers as jregs
    from anovos_tpu_torch.ops.hll import hll_registers as pregs

    g = np.random.default_rng(p)
    X = g.normal(0, 3, (3000, 3)).astype(np.float32)
    X[::5, 0] = 0.0
    X[::7, 0] = -0.0
    M = g.random((3000, 3)) > 0.1
    C = g.integers(-3, 500, (3000, 2)).astype(np.int32)
    Mc = g.random((3000, 2)) > 0.2
    for A, B in ((X, M), (C, Mc)):
        exp = np.asarray(jregs(jnp.asarray(A + np.zeros((), A.dtype)), jnp.asarray(B), p))
        got = pregs(torch.from_numpy(A), torch.from_numpy(B), p).numpy()
        np.testing.assert_array_equal(got, exp)
    # −0.0 and +0.0 are one value in the port, two in the JAX package's jit
    z = np.array([[0.0], [-0.0]], np.float32)
    ones = np.ones((2, 1), bool)
    assert int((pregs(torch.from_numpy(z), torch.from_numpy(ones), p) > 0).sum()) == 1
    assert int((np.asarray(jregs(jnp.asarray(z), jnp.asarray(ones), p)) > 0).sum()) == 2


def test_wide_lanes_and_frame_match_jax():
    """The port rebuilds the JAX package's (hi, lo) pair of a wide column
    from its exact int64 / float64 values: same int32 lanes, registers,
    estimates and frame."""
    import jax.numpy as jnp
    import torch

    from anovos_tpu.data_analyzer.stats_generator import uniqueCount_computation as juc
    from anovos_tpu.ops.hll import hll_estimate as jest
    from anovos_tpu.ops.hll import hll_registers as jregs
    from anovos_tpu_torch.data_analyzer.stats_generator import _exact_bits
    from anovos_tpu_torch.data_analyzer.stats_generator import uniqueCount_computation as puc
    from anovos_tpu_torch.ops.hll import hll_estimate as pest
    from anovos_tpu_torch.ops.hll import hll_registers as pregs

    jt, pt = jax_and_port(hll_frame())
    assert pt.columns["big_id"].is_wide_int and pt.columns["fine"].is_wide
    for c in ("big_id", "fine"):
        jc = jt.columns[c]
        lane_j = np.asarray(jc.wide_hi ^ (jc.wide_lo * jnp.int32(-1640531527)))[: jt.nrows]
        lane_p = _exact_bits(pt.columns[c])
        np.testing.assert_array_equal(lane_p.numpy(), lane_j)
        mask = np.asarray(jc.mask)[: jt.nrows].copy()
        rj = np.asarray(jregs(jnp.asarray(lane_j[:, None]), jnp.asarray(mask[:, None]), 9))
        rp = pregs(lane_p[:, None], torch.from_numpy(mask[:, None]), 9).numpy()
        np.testing.assert_array_equal(rp, rj)
        np.testing.assert_array_equal(pest(rp), jest(rj))
    for rsd in (0.05, 0.01):
        exp = juc(jt, compute_approx_unique_count=True, rsd=rsd)
        got = puc(pt, compute_approx_unique_count=True, rsd=rsd)
        assert got.equals(exp), (got, exp)
    exact = puc(pt).set_index("attribute")["unique_values"]
    approx = got.set_index("attribute")["unique_values"]
    assert (np.abs(approx - exact) <= 3 * 0.01 * exact).all()


def test_precision_and_rsd_checks():
    from anovos_tpu_torch.data_analyzer.stats_generator import uniqueCount_computation
    from anovos_tpu_torch.ops.hll import precision_for_rsd

    assert [precision_for_rsd(r) for r in (0.5, 0.05, 0.01)] == [4, 9, 14]
    with pytest.warns(UserWarning, match="clamped"):
        assert precision_for_rsd(0.001) == 16
    _, pt = jax_and_port(hll_frame(50))
    with pytest.raises(ValueError):
        uniqueCount_computation(pt, compute_approx_unique_count=True, rsd=0)
