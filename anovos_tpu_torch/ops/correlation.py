"""Pearson correlation and covariance as masked matmuls (counterpart of
``anovos_tpu/ops/correlation.py``).

Pairwise-complete statistics are five X.T @ X-shaped products over the
rows where both columns are valid.  Every column is first centred by its
masked mean: Pearson r and the covariance do not change under a shift,
and without it the n·Sxy − Sx·Sy cancellation loses most f32 bits of a
large-offset, low-spread column (a year column).
"""

from __future__ import annotations

import torch

from anovos_tpu_torch.ops.mxu import bf16_sweep, mm
from anovos_tpu_torch.ops.reductions import masked_mean


def _centred(X: torch.Tensor, M: torch.Tensor):
    Mf = M.to(torch.float32)
    Xf = X.to(torch.float32)
    return torch.where(M, Xf - masked_mean(Xf, M)[None, :], 0.0), Mf


def masked_corr(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Pairwise-complete Pearson correlation: X, M (rows, k) → (k, k) f32,
    1 on the diagonal, NaN where a pair has no spread."""
    bf16 = bf16_sweep()
    Xm, Mf = _centred(X, M)
    n = mm(Mf.t(), Mf, bf16)  # pairwise counts
    Sx = mm(Xm.t(), Mf, bf16)  # Sx[a, b] = Σ x_a over the rows where a and b are valid
    Sxx = mm((Xm * Xm).t(), Mf, bf16)
    Sxy = mm(Xm.t(), Xm, bf16)
    Sy, Syy = Sx.t(), Sxx.t()
    cov_n = n * Sxy - Sx * Sy
    var_a = n * Sxx - Sx * Sx
    var_b = n * Syy - Sy * Sy
    # the square roots apart: var_a · var_b (≈ n⁴σa²σb²) passes the f32
    # maximum at a few million rows of values in the thousands
    denom = torch.sqrt(torch.clamp_min(var_a, 0.0)) * torch.sqrt(torch.clamp_min(var_b, 0.0))
    corr = torch.where(denom > 0, cov_n / torch.clamp_min(denom, 1e-30), float("nan"))
    eye = torch.eye(X.shape[1], dtype=torch.bool, device=X.device)
    return torch.where(eye, 1.0, corr)


def masked_cov(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Pairwise-complete sample covariance (n − 1): (k, k) f32, NaN where a
    pair has fewer than two rows.

    The f32 centred values' cross-products accumulate in float64 and the
    (k, k) result is cast to f32: a near-zero covariance is a difference
    of large sums, and f32 accumulation left it 1.2e-5 relative off
    float64, with a sign of error that followed the BLAS summation order.
    Under ``ANOVOS_TPU_BF16=1`` the products stay bf16 in, f32 out."""
    bf16 = bf16_sweep()
    Xm, Mf = _centred(X, M)
    if bf16:
        n = mm(Mf.t(), Mf, bf16)
        Sx = mm(Xm.t(), Mf, bf16)
        Sxy = mm(Xm.t(), Xm, bf16)
    else:
        Xd, Md = Xm.to(torch.float64), Mf.to(torch.float64)
        n, Sx, Sxy = Md.t() @ Md, Xd.t() @ Md, Xd.t() @ Xd
    mean_prod = Sx * Sx.t() / torch.clamp_min(n, 1.0)
    cov = torch.where(n > 1, (Sxy - mean_prod) / torch.clamp_min(n - 1.0, 1.0), float("nan"))
    return cov.to(torch.float32)


def masked_corr_cc(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Complete-case Pearson correlation: only rows valid in every column."""
    return masked_corr(X, M & M.all(dim=1, keepdim=True))
