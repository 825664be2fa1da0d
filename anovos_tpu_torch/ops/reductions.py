"""Masked moment reductions (counterpart of ``anovos_tpu/ops/reductions.py``).

Semantics match Spark: ``stddev``/``variance`` are sample (n-1),
``skewness``/``kurtosis`` are population with excess kurtosis, and every
statistic is over the valid (masked) entries only.  ``masked_moments`` is
the single-pass moments kernel (``ops/kernels/moments.py``) and its
finalizer.
"""

from __future__ import annotations

from typing import Dict

import torch

from anovos_tpu_torch.obs.timed import timed
from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols


def finalize_moments(n, s1, m2, m3, m4, cmin, cmax, nonzero) -> Dict[str, torch.Tensor]:
    """Reduced sums → the moments dict (``anovos_tpu`` ``finalize_moments``)."""
    safe_n = torch.clamp_min(n, 1.0)
    mean = s1 / safe_n
    var_samp = m2 / torch.clamp_min(n - 1.0, 1.0)
    std = torch.sqrt(var_samp)
    m2p = m2 / safe_n
    nan = torch.full_like(s1, float("nan"))
    skew = torch.where(m2p > 0, (m3 / safe_n) / torch.pow(torch.clamp_min(m2p, 1e-38), 1.5), nan)
    kurt = torch.where(m2p > 0, (m4 / safe_n) / torch.clamp_min(m2p * m2p, 1e-38) - 3.0, nan)
    empty = n == 0
    return {
        "count": n,
        "sum": s1,
        "mean": torch.where(empty, nan, mean),
        "variance": torch.where(n > 1, var_samp, nan),
        "stddev": torch.where(n > 1, std, nan),
        "skewness": torch.where(empty, nan, skew),
        "kurtosis": torch.where(empty, nan, kurt),
        "min": torch.where(empty, nan, cmin),
        "max": torch.where(empty, nan, cmax),
        "nonzero": nonzero,
    }


def moments_accumulator(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(rows, k) values and mask → the kernel's (8, k) accumulator
    [n, mean, M2, M3, M4, min, max, nonzero]."""
    Xc = X.t().to(torch.float32)
    return masked_moments_cols(Xc.contiguous(), M.t().contiguous())


@timed("ops.masked_moments")
def masked_moments(X: torch.Tensor, M: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All central moments per column of a masked (rows, k) block: dict of
    (k,) f32 tensors count, sum, mean, variance (sample), stddev, skewness,
    kurtosis (excess), min, max, nonzero."""
    acc = moments_accumulator(X, M)
    n, mean = acc[0], acc[1]
    return finalize_moments(n, mean * n, acc[2], acc[3], acc[4], acc[5], acc[6], acc[7])


def masked_count(M: torch.Tensor) -> torch.Tensor:
    """Valid count per column: (rows, k) bool → (k,)."""
    return M.sum(dim=0)


def masked_mean(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    n = torch.clamp_min(M.sum(dim=0), 1)
    return torch.where(M, X, 0).sum(dim=0) / n


def masked_var(X: torch.Tensor, M: torch.Tensor, ddof: int = 1) -> torch.Tensor:
    n = M.sum(dim=0).to(X.dtype)
    mean = torch.where(M, X, 0).sum(dim=0) / torch.clamp_min(n, 1)
    d = torch.where(M, X - mean, 0)
    return (d * d).sum(dim=0) / torch.clamp_min(n - ddof, 1)
