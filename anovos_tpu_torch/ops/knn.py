"""Nan-euclidean k-nearest-neighbour imputation of one query tile
(counterpart of ``anovos_tpu/ops/knn.py`` ``knn_impute_tile``, the
sklearn ``KNNImputer(n_neighbors=5, metric="nan_euclidean")`` semantics).

d²(x, y) = (k / |obs(x) ∩ obs(y)|) · Σ over both observed (x_j − y_j)²,
expanded into three matmuls.  It is a quadratic expansion, so the
products run in true f32 (TF32 off) and every feature is first centred on
the fit set's masked mean, as the JAX package does.  Per feature, the
donors are the ``n_neighbors`` nearest fit rows that observe it; among
equal distances the lower fit row goes first, as ``lax.top_k`` orders
them (``_donor_mean``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from anovos_tpu_torch.obs.timed import timed
from anovos_tpu_torch.ops.mxu import true_f32
from anovos_tpu_torch.ops.reductions import masked_mean


@timed("ops.knn_impute_tile")
def knn_impute_tile(
    Xq: torch.Tensor,
    Mq: torch.Tensor,
    Xs: torch.Tensor,
    Ms: torch.Tensor,
    n_neighbors: int = 5,
    features: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Xq/Mq (b, k) queries, Xs/Ms (s, k) fit sample → (b, len(features))
    imputed values of the ``features`` (default all k) for every query row
    (the caller keeps the observed ones): the mean of the feature over its
    nearest donors, 0 where no fit row observes it."""
    k = Xq.shape[1]
    features = range(k) if features is None else features
    mq, ms = Mq.to(torch.float32), Ms.to(torch.float32)
    mu = masked_mean(Xs.to(torch.float32), Ms)
    xq = torch.where(Mq, Xq - mu[None, :], 0.0)
    xs = torch.where(Ms, Xs - mu[None, :], 0.0)
    with true_f32():
        raw = (xq * xq * mq) @ ms.t() + mq @ (xs * xs * ms).t() - 2.0 * xq @ xs.t()
        cnt = mq @ ms.t()
    inf = torch.tensor(float("inf"), device=Xq.device)
    d2 = torch.where(cnt > 0, raw * (k / torch.clamp_min(cnt, 1.0)), inf)
    d2 = torch.clamp_min(d2, 0.0)
    K = min(n_neighbors, Xs.shape[0])
    out = []
    for j in features:
        dj = torch.where(Ms[:, j][None, :], d2, inf)
        out.append(_donor_mean(dj, Xs[:, j], K))
    return torch.stack(out, dim=1)


def _donor_mean(dj: torch.Tensor, donor: torch.Tensor, K: int) -> torch.Tensor:
    """Per row of the (b, s) distances ``dj``, the mean of ``donor`` over
    the K nearest finite ones, equal distances taken in fit-row order.
    ``torch.topk`` leaves the order of ties open, so the K + 1 nearest are
    taken: where the K-th is strictly nearer than the next, they are the
    set; the rows with a tie there pick their donors by fit-row order
    over the whole row."""
    s = dj.shape[1]
    top_v, top_i = torch.topk(dj, min(K + 1, s), dim=1, largest=False, sorted=True)
    vals, idx = top_v[:, :K], top_i[:, :K]
    w = torch.isfinite(vals).to(torch.float32)
    res = (donor[idx] * w).sum(dim=1) / torch.clamp_min(w.sum(dim=1), 1.0)
    if K < s:
        tied = torch.nonzero(top_v[:, K] == top_v[:, K - 1]).flatten()
        if len(tied):
            d = dj[tied]
            kth = top_v[tied, K - 1:K]
            below, at = d < kth, d == kth
            take = below | (at & (torch.cumsum(at, dim=1) <= K - below.sum(dim=1, keepdim=True)))
            wt = (take & torch.isfinite(d)).to(torch.float32)
            res[tied] = (wt * donor[None, :]).sum(dim=1) / torch.clamp_min(wt.sum(dim=1), 1.0)
    return res
