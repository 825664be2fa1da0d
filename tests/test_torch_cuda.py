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


@pytest.mark.cuda
def test_cuda_neighbor_counts_equal_plain():
    """Kernel B3 and its plain version evaluate d² with the same rounded
    operations in the same order: the counts are equal, not just close,
    across the Pallas test's regimes, a ragged block and d = 3."""
    from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_plain, neighbor_counts_rows

    _require_cuda()
    for n, eps, d in ((3000, 0.4, 2), (1024, 0.05, 2), (1500, 50.0, 2), (257, 0.3, 2),
                      (2049, 0.7, 3), (1, 0.1, 2)):
        g = np.random.default_rng(n)
        X = g.uniform(-40, 40, (4, d))[g.integers(0, 4, n)] + g.normal(0, 0.3, (n, d))
        X = X.astype(np.float32)
        Xc = torch.from_numpy(X - X.mean(axis=0, keepdims=True)).cuda()
        eps2 = float(np.float32(eps * eps))
        got = neighbor_counts_rows(Xc, eps2)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), neighbor_counts_plain(Xc, eps2).cpu()), (n, eps, d)
        assert int(got.min()) >= 1
