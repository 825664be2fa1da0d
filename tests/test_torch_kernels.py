"""The port's kernels (ops/kernels) against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against ``binned_histograms_pallas`` / ``moments_pallas`` in
interpret mode and against their XLA twins, on the same seeded numpy
inputs.  tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import (  # noqa: F401  (torch_cpu_runtime: autouse fixture)
    HIST_CASES, assert_moments_close, hist_inputs, moment_inputs, torch_cpu_runtime)


@pytest.mark.parametrize("rows,k,nbins,nan_rows,dead_cols", HIST_CASES)
def test_histogram_plain_equals_pallas_and_xla(rows, k, nbins, nan_rows, dead_cols):
    from anovos_tpu.ops.drift_kernels import _binned_histograms_xla
    from anovos_tpu.ops.pallas_kernels import binned_histograms_pallas
    from anovos_tpu_torch.ops.drift_kernels import binned_histograms

    X, M, cuts = hist_inputs(rows, k, nbins, seed=rows + k, nan_rows=nan_rows, dead_cols=dead_cols)
    got = binned_histograms(torch.from_numpy(X), torch.from_numpy(M), torch.from_numpy(cuts), nbins)
    pallas = np.asarray(binned_histograms_pallas(jnp.asarray(X), jnp.asarray(M), jnp.asarray(cuts),
                                                 nbins, interpret=True))
    xla = np.asarray(_binned_histograms_xla(jnp.asarray(X), jnp.asarray(M), jnp.asarray(cuts), nbins))
    # integer counts: exact equality, no tolerance
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    assert got.dtype == torch.float32 and got.sum().item() == M.sum()


@pytest.mark.parametrize("rows", [60000, 2049, 1, 5000])
def test_moments_plain_matches_pallas_interpret(rows):
    """The plain version repeats the Pallas kernel's tile merge operation
    for operation; only the f32 summation order inside a tile differs, so
    the band is rel 1e-6 plus the tile-mean rounding terms of
    ``assert_moments_close``."""
    from anovos_tpu.ops.pallas_kernels import moments_pallas
    from anovos_tpu_torch.ops.reductions import moments_accumulator

    X, M = moment_inputs(rows, seed=rows)
    got = moments_accumulator(torch.from_numpy(X), torch.from_numpy(M)).numpy()
    exp = np.asarray(moments_pallas(jnp.asarray(X), jnp.asarray(M), interpret=True))
    assert_moments_close(got, exp, rtol=1e-6)


def test_masked_moments_matches_xla_twin():
    """Finalized moments against the JAX two-pass XLA reductions, with the
    bands of tests/test_pallas_kernels.py (same kernel-vs-twin question)."""
    from anovos_tpu.ops.reductions import masked_moments as jax_moments
    from anovos_tpu_torch.ops.reductions import masked_moments

    X, M = moment_inputs(60000, seed=3)
    got = masked_moments(torch.from_numpy(X), torch.from_numpy(M))
    exp = jax_moments(jnp.asarray(X), jnp.asarray(M))
    for k in ("count", "min", "max", "nonzero"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]), err_msg=k)
    for k in ("mean", "stddev", "variance"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]), rtol=5e-3, atol=1e-3, err_msg=k)
    for k in ("skewness", "kurtosis"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(exp[k]), rtol=2e-2, atol=2e-2,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("fn", ["moments", "histogram"])
def test_wrappers_reject_bad_inputs(fn):
    """Shape mismatches raise; a tensor on neither the CPU nor CUDA raises
    instead of silently taking the plain version."""
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols

    X = torch.zeros((2, 10))
    M = torch.ones((2, 10), dtype=torch.bool)
    cuts = torch.zeros((2, 9))
    call = (lambda x, m: masked_moments_cols(x, m)) if fn == "moments" \
        else (lambda x, m: binned_histograms_cols(x, m, cuts.to(x.device), 10))
    with pytest.raises(ValueError):
        call(X, M[:, :5])
    with pytest.raises(ValueError):
        call(X.to("meta"), M.to("meta"))
