"""Exact quantiles by device sort (counterpart of ``anovos_tpu/ops/quantiles.py``
``masked_quantiles`` / ``masked_median``)."""

from __future__ import annotations

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
