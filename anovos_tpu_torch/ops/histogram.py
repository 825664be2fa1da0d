"""Binning and bin counts (counterpart of ``anovos_tpu/ops/histogram.py``)."""

from __future__ import annotations

import torch


def digitize(X: torch.Tensor, cutoffs: torch.Tensor) -> torch.Tensor:
    """Bin ids per column: X (rows, k); cutoffs (k, nb+1) ascending edges
    whose first and last are ±inf-like bounds.  A value's bin is the number
    of interior edges strictly below it, so a value equal to edge i lands
    in bin i (right-closed bins); NaN values and NaN edges count as not
    below, as in the JAX package's compare.  Returns int32 (rows, k) in
    [0, nb − 1], laid out as X is (a row-major view of column-major data
    stays so)."""
    interior = cutoffs[:, 1:-1].to(X.dtype)
    out = torch.zeros_like(X, dtype=torch.int32)
    for j in range(interior.shape[1]):
        out += X > interior[None, :, j]
    return out


def masked_bincount(idx: torch.Tensor, M: torch.Tensor, nbins: int) -> torch.Tensor:
    """Counts of bin ids per column: idx (rows, k) in [0, nbins), M (rows,
    k) → (k, nbins) f32."""
    k = idx.shape[1]
    offset = torch.arange(k, device=idx.device)[None, :] * nbins
    flat = torch.where(M, idx.to(torch.int64) + offset, k * nbins)
    counts = torch.bincount(flat.reshape(-1), minlength=k * nbins + 1)[: k * nbins]
    return counts.view(k, nbins).to(torch.float32)


def masked_label_bincount(idx: torch.Tensor, M: torch.Tensor, y: torch.Tensor,
                          nbins: int) -> torch.Tensor:
    """Sum of a 0/1 label y (rows,) per column and bin: (k, nbins) f32."""
    k = idx.shape[1]
    offset = torch.arange(k, device=idx.device)[None, :] * nbins
    flat = torch.where(M, idx.to(torch.int64) + offset, k * nbins)
    w = (M.to(torch.float64) * y.to(torch.float64)[:, None]).reshape(-1)
    sums = torch.bincount(flat.reshape(-1), weights=w, minlength=k * nbins + 1)[: k * nbins]
    return sums.view(k, nbins).to(torch.float32)


def equal_range_cutoffs(X: torch.Tensor, M: torch.Tensor, nbins: int) -> torch.Tensor:
    """Equal-width edges (k, nbins + 1) f32 from each column's masked
    min and max."""
    Xf = X.to(torch.float32)
    big = torch.finfo(torch.float32).max
    lo = torch.where(M, Xf, big).amin(dim=0)
    hi = torch.where(M, Xf, -big).amax(dim=0)
    steps = torch.linspace(0.0, 1.0, nbins + 1, dtype=torch.float32, device=X.device)
    return lo[:, None] + steps[None, :] * (hi - lo)[:, None]
