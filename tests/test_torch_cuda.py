"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor
the JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from _torch_port import HIST_CASES, assert_moments_close, hist_inputs, moment_inputs


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda.is_available() is False: the CUDA kernels need an NVIDIA GPU")


@pytest.mark.cuda
def test_cuda_histogram_equals_plain():
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols, binned_histograms_plain

    _require_cuda()
    for rows, k, nbins, nan_rows, dead_cols in HIST_CASES:
        X, M, cuts = hist_inputs(rows, k, nbins, seed=rows, nan_rows=nan_rows, dead_cols=dead_cols)
        Xc = torch.from_numpy(X.T.copy()).cuda()
        Mc = torch.from_numpy(M.T.copy()).cuda()
        c = torch.from_numpy(cuts).cuda()
        got = binned_histograms_cols(Xc, Mc, c, nbins)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), binned_histograms_plain(Xc, Mc, c, nbins).cpu())


@pytest.mark.cuda
def test_cuda_moments_match_plain():
    from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols, masked_moments_plain

    _require_cuda()
    for rows in (60000, 2049, 1):
        X, M = moment_inputs(rows, seed=rows)
        Xc = torch.from_numpy(X.T.copy()).cuda()
        Mc = torch.from_numpy(M.T.copy()).cuda()
        got = masked_moments_cols(Xc, Mc).cpu().numpy()
        torch.cuda.synchronize()
        exp = masked_moments_plain(Xc, Mc).cpu().numpy()
        # the kernel runs Welford per thread and merges threads and blocks,
        # the plain version merges 2048-row tiles: a looser rtol than the
        # plain-vs-Pallas test, which shares the tile structure
        assert_moments_close(got, exp, rtol=1e-5)
