"""Exact quantiles by device sort, and quantiles from fixed-width
histograms (counterpart of ``anovos_tpu/ops/quantiles.py``
``masked_quantiles``, ``masked_median`` and ``quantiles_from_histogram``)."""

from __future__ import annotations

import numpy as np
import torch


def masked_quantiles(X: torch.Tensor, M: torch.Tensor, qs, interpolation: str = "linear") -> torch.Tensor:
    """Exact quantiles per column: X, M (rows, k); qs (q,) in [0, 1] →
    (q, k).  Invalid entries sort to the dtype's max; the index is scaled
    by each column's valid count in the value dtype, as in the JAX package.
    ``interpolation``: 'linear' or 'lower' (actual elements)."""
    dt = X.dtype if X.dtype in (torch.float32, torch.float64) else torch.float32
    big = torch.finfo(dt).max
    Xs = torch.sort(torch.where(M, X.to(dt), big), dim=0).values
    n = M.sum(dim=0)
    qs = torch.as_tensor(qs, dtype=dt, device=X.device)
    pos = qs[:, None] * torch.clamp_min(n[None, :] - 1, 0).to(dt)
    lo = torch.floor(pos).to(torch.int64)
    v_lo = torch.gather(Xs, 0, lo)
    if interpolation == "lower":
        out = v_lo
    else:
        hi = torch.ceil(pos).to(torch.int64)
        v_hi = torch.gather(Xs, 0, hi)
        out = v_lo + (pos - lo).to(dt) * (v_hi - v_lo)
    return torch.where(n[None, :] > 0, out, torch.full_like(out, float("nan")))


def masked_median(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    return masked_quantiles(X, M, [0.5])[0]


def quantiles_from_histogram(hist, lo, bin_width, qs) -> np.ndarray:
    """Quantiles from per-column (k, nbins) counts against fixed-width
    bins (counterpart of ``anovos_tpu/ops/quantiles.py``
    ``quantiles_from_histogram``): the bin where the cumulative count
    first reaches q·n, its centre returned.  Targets and centres in f32,
    as in the JAX package; the counts may be int64."""
    hist = np.asarray(hist)
    cum = np.cumsum(hist, axis=1)
    n = cum[:, -1:].astype(np.float32)
    targets = np.asarray(qs, np.float32)[:, None, None] * n[None]  # (q, k, 1)
    bin_i = np.clip((cum[None] < targets).sum(axis=2), 0, hist.shape[1] - 1)
    lo = np.asarray(lo, np.float32)
    return lo[None] + (bin_i.astype(np.float32) + np.float32(0.5)) * np.asarray(bin_width, np.float32)[None]
