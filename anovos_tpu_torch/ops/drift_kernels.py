"""Drift histograms and cutoff fitting (counterpart of
``anovos_tpu/ops/drift_kernels.py``).

Per dataset side, numeric columns are binned against the source cutoffs
by the histogram kernel (``ops/kernels/histogram.py``) and categorical
columns are counted over their local codes, then permuted into the union
vocabulary through a per-column LUT.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols
from anovos_tpu_torch.ops.quantiles import masked_quantiles
from anovos_tpu_torch.ops.segment import code_histograms


def binned_histograms(X: torch.Tensor, M: torch.Tensor, cutoffs: torch.Tensor,
                      nbins: int) -> torch.Tensor:
    """Numeric columns → per-column bin counts.  X/M (rows, k); cutoffs
    (k, nbins-1) interior edges.  Returns (k, nbins) f32 counts of the
    valid entries."""
    Xc = X.t().to(torch.float32).contiguous()
    return binned_histograms_cols(Xc, M.t().contiguous(),
                                  cutoffs.to(torch.float32).contiguous(), nbins)


def drift_side_full(
    num_datas: Sequence[torch.Tensor],
    num_masks: Sequence[torch.Tensor],
    cutoffs: torch.Tensor,
    cat_datas: Sequence[torch.Tensor],
    cat_masks: Sequence[torch.Tensor],
    lut: torch.Tensor,
    nbins: int,
    n_cat_bins: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dataset side from raw column tensors: (k_num, nbins) numeric and
    (k_cat, n_cat_bins) categorical counts."""
    device = cutoffs.device
    if num_datas:
        # column-major stack: the kernel's layout, no transpose
        Xc = torch.stack([d.to(torch.float32) for d in num_datas])
        Mc = torch.stack(list(num_masks))
        num_h = binned_histograms_cols(Xc, Mc, cutoffs.to(torch.float32).contiguous(), nbins)
    else:
        num_h = torch.zeros((0, nbins), dtype=torch.float32, device=device)
    if cat_datas:
        C = torch.stack(list(cat_datas), dim=1)
        Mc = torch.stack(list(cat_masks), dim=1)
        # histogram-then-permute: count each column's LOCAL codes, then move
        # the small (k, maxv) count matrix into the union vocabulary
        local_h = code_histograms(C, Mc, lut.shape[1])
        cat_h = torch.zeros((local_h.shape[0], n_cat_bins), dtype=torch.float32, device=C.device)
        cat_h.scatter_add_(1, lut.to(torch.int64), local_h)
    else:
        cat_h = torch.zeros((0, n_cat_bins), dtype=torch.float32, device=device)
    return num_h, cat_h


def fit_cutoffs(
    num_datas: Sequence[torch.Tensor],
    num_masks: Sequence[torch.Tensor],
    nbins: int,
    method: str = "equal_range",
) -> torch.Tensor:
    """Interior bin cutoffs (k, nbins-1), f32."""
    X = torch.stack([d.to(torch.float32) for d in num_datas], dim=1)
    M = torch.stack(list(num_masks), dim=1)
    if method == "equal_frequency":
        qs = [j / nbins for j in range(1, nbins)]
        return masked_quantiles(X, M, qs, interpolation="lower").t()
    big = torch.finfo(torch.float32).max
    lo = torch.where(M, X, big).amin(dim=0)
    hi = torch.where(M, X, -big).amax(dim=0)
    return _equal_range_cuts(lo, hi, M.sum(dim=0), nbins)


def _equal_range_cuts(lo: torch.Tensor, hi: torch.Tensor, n: torch.Tensor, nbins: int) -> torch.Tensor:
    """lo + j * (hi - lo) / nbins in f32, j = 1..nbins-1; NaN rows for
    columns without a valid value."""
    width = (hi - lo) / nbins
    j = torch.arange(1, nbins, dtype=torch.float32, device=lo.device)
    cuts = lo[:, None] + j[None, :] * width[:, None]
    return torch.where(n[:, None] > 0, cuts, float("nan"))


def cutoffs_from_bounds(lo: torch.Tensor, hi: torch.Tensor, n: torch.Tensor, nbins: int) -> torch.Tensor:
    """Equal-range cutoffs from already-reduced per-column bounds."""
    return _equal_range_cuts(lo.to(torch.float32), hi.to(torch.float32), n, nbins)
