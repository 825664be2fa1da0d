"""Clustering (counterpart of ``anovos_tpu/ops/cluster.py``): Lloyd k-means
with the elbow sweep, and DBSCAN over an (eps × min_samples) grid.

- Squared distances of the DBSCAN paths all come from
  ``ops/kernels/neighbor_counts.sq_dist``, the arithmetic of kernel B3, so
  the neighbour counts (B3), the within-eps adjacency and the border
  adoption agree bit for bit on one device.  They are elementwise f32
  operations, never a TF32 product.
- k-means runs its Lloyd rounds in float64 on the device (distances,
  cluster sums and centers) and returns f32 centers.  The JAX package's
  f32 expansion on uncentred lat/lon (|x|² near 1e4) rounds each distance
  by about 1e-3 deg², which moves the points near a bisector of two
  centers of one city and the centers with them by 1e-4 degrees; float64
  keeps the fit to the data's own precision.  No product here or in the
  DBSCAN paths is f32, so none can run in TF32.
- Points are centred in numpy f32 on the host before any distance, as in
  the JAX package: every distance bit follows from that subtraction.
- ``jax.lax.while_loop`` becomes a Python loop that reads its convergence
  flag once per round; ``lax.map`` becomes a loop over query tiles.  Eager
  loops handle a ragged last tile, so no point set is padded.

Knobs read at call time, with the JAX package's names and defaults:
``ANOVOS_KMEANS_ELBOW_SAMPLE`` (6144), ``ANOVOS_KMEANS_ELBOW_ITERS`` (15),
``ANOVOS_DBSCAN_BATCH_MAX`` (16384).
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from anovos_tpu_torch.ops.kernels.neighbor_counts import neighbor_counts_rows, row_sq_norms, sq_dist
from anovos_tpu_torch.shared.runtime import get_runtime

_INF = float("inf")


def _device_f32(X) -> torch.Tensor:
    """Host or device points → an f32 tensor on the runtime's device."""
    if isinstance(X, torch.Tensor):
        return X.to(device=get_runtime().device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(get_runtime().device)


def _eps2(eps: float) -> float:
    """eps² rounded to f32, as the JAX package compares it."""
    return float(np.float32(eps * eps))


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------
def kmeans_init_indices(n: int, k: int, seed: int = 0) -> torch.Tensor:
    """The ``k`` distinct row indices :func:`kmeans_fit` starts from: a
    permutation drawn by a CPU ``torch.Generator`` seeded with ``seed``.
    (The JAX package draws them with ``jax.random.choice``; the streams
    differ, so the two packages start from different centers.)"""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:k]


def _center_dists(X: torch.Tensor, C: torch.Tensor, active: Optional[torch.Tensor]) -> torch.Tensor:
    """(..., n, k) float64 squared distances of the (n, d) points to the
    (..., k, d) centers by the matmul expansion; inactive centers (mask
    (..., k)) at +inf."""
    D = (X * X).sum(1, keepdim=True) - 2 * torch.matmul(X, C.transpose(-1, -2)) \
        + (C * C).sum(-1)[..., None, :]
    return D if active is None else torch.where(active[..., None, :], D, _INF)


def _lloyd_step(X: torch.Tensor, C: torch.Tensor, active: Optional[torch.Tensor]) -> torch.Tensor:
    lbl = _center_dists(X, C, active).argmin(dim=-1)
    onehot = torch.nn.functional.one_hot(lbl, C.shape[-2]).to(X.dtype)
    counts = onehot.sum(-2)
    means = (onehot.transpose(-1, -2) @ X) / torch.clamp_min(counts, 1.0)[..., None]
    return torch.where(counts[..., None] > 0, means, C)


def _lloyd(X: torch.Tensor, C: torch.Tensor, iters: int, active: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Lloyd rounds over the float64 points ``X`` from the float64 centers
    ``C`` until no center moves beyond 1e-6 · (1 + |C|) (the JAX package's
    rule) or ``iters`` rounds."""
    i, moved = 0, True
    while moved and i < iters:
        Cn = _lloyd_step(X, C, active)
        moved = bool(((Cn - C).abs() > 1e-6 * (1.0 + C.abs())).any())
        C, i = Cn, i + 1
    return C


def kmeans_fit(X, k: int, iters: int = 50, seed: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm.  X: (n, d) → (centers (k, d), labels (n,),
    inertia), tensors on the runtime's device."""
    X = _device_f32(X).to(torch.float64)
    C = _lloyd(X, X[kmeans_init_indices(X.shape[0], k, seed).to(X.device)], iters)
    D = _center_dists(X, C, None)
    labels = D.argmin(dim=1)
    inertia = torch.clamp_min(D.gather(1, labels[:, None]).sum(), 0.0)
    return C.to(torch.float32), labels, inertia.to(torch.float32)


def _kmeans_inertia_sweep(X: torch.Tensor, max_k: int, iters: int = 50, seed: int = 0) -> torch.Tensor:
    """Inertias (float64) for every k in 1..max_k of the float64 points
    ``X``: each candidate runs ``max_k`` centers with only the first k
    active (inactive centers sit at +inf distance, so no point selects them
    and they stay put).  The candidates run side by side, one batched Lloyd
    round for all of them, and each stops at its own round as
    :func:`_lloyd` would: a candidate whose centers no longer move keeps
    them while the others go on.  (A loop over candidates costs max_k times
    the tensor operations, each a kernel launch on the card.)"""
    dev = X.device
    C = X[kmeans_init_indices(X.shape[0], max_k, seed).to(dev)].expand(max_k, -1, -1)
    ks = torch.arange(1, max_k + 1, device=dev)
    active = torch.arange(max_k, device=dev)[None, :] < ks[:, None]  # (candidate, center)
    running = torch.ones(max_k, dtype=torch.bool, device=dev)
    i = 0
    while i < iters and bool(running.any()):
        Cn = _lloyd_step(X, C, active)
        moved = ((Cn - C).abs() > 1e-6 * (1.0 + C.abs())).flatten(1).any(dim=1)
        C = torch.where(running[:, None, None], Cn, C)
        running, i = running & moved, i + 1
    return torch.clamp_min(_center_dists(X, C, active).amin(dim=-1).sum(dim=-1), 0.0)


def kmeans_elbow(X: np.ndarray, max_k: int = 20, seed: int = 0) -> Tuple[int, np.ndarray]:
    """Pick k by the knee of the inertia curve (elbow method).  The sweep
    runs on at most ``ANOVOS_KMEANS_ELBOW_SAMPLE`` points (0 = all) for
    ``ANOVOS_KMEANS_ELBOW_ITERS`` Lloyd rounds: the knee is a property of
    the normalized curve, which a uniform subsample and partial convergence
    both preserve."""
    X = np.asarray(X, np.float32)
    cap = int(os.environ.get("ANOVOS_KMEANS_ELBOW_SAMPLE", 6144))
    if cap and len(X) > cap:
        X = X[np.random.default_rng(seed).choice(len(X), cap, replace=False)]
    # centre in f32 as the JAX package does: inertia is translation-invariant
    Xd = _device_f32(X - X.mean(axis=0, keepdims=True)).to(torch.float64)
    ks = list(range(1, max(2, max_k) + 1))
    iters = int(os.environ.get("ANOVOS_KMEANS_ELBOW_ITERS", 15))
    inertias = _kmeans_inertia_sweep(Xd, ks[-1], iters=iters, seed=seed).cpu().numpy()
    if len(inertias) < 3:
        return ks[-1], inertias
    # knee: max distance from the line joining the first and last points
    x = np.array(ks, float)
    y = inertias / max(inertias[0], 1e-30)
    x0, y0, x1, y1 = x[0], y[0], x[-1], y[-1]
    denom = np.hypot(x1 - x0, y1 - y0)
    dist = np.abs((y1 - y0) * x - (x1 - x0) * y + x1 * y0 - y1 * x0) / max(denom, 1e-30)
    return int(x[np.argmax(dist)]), inertias


# ---------------------------------------------------------------------------
# DBSCAN
# ---------------------------------------------------------------------------
def neighbor_counts(X: np.ndarray, eps: float, tile: int = 4096) -> np.ndarray:
    """Within-eps neighbour count per point, self included (kernel B3 on
    the card): the count pass of DBSCAN, shared by every min_samples of a
    grid at one eps.  ``tile`` is the plain version's query tile."""
    X = np.asarray(X, np.float32)
    Xd = _device_f32(X - X.mean(axis=0, keepdims=True))  # magnitude → spread
    return neighbor_counts_rows(Xd.contiguous(), _eps2(eps), tile).cpu().numpy()


def _nearest_core_tile(Xq: torch.Tensor, Xs: torch.Tensor, eps2: float):
    """Nearest within-eps source point per query row: (index, hit); ties go
    to the lowest index."""
    D = sq_dist(Xq, Xs, row_sq_norms(Xq), row_sq_norms(Xs))
    Dm = torch.where(D <= eps2, D, _INF)
    idx = Dm.argmin(dim=1)
    return idx, torch.isfinite(Dm.gather(1, idx[:, None])[:, 0])


def _pointer_jump(lab: torch.Tensor) -> torch.Tensor:
    """Six rounds of lab = min(lab, lab[lab]) along the last axis."""
    for _ in range(6):
        lab = torch.minimum(lab, lab.gather(-1, lab.long()))
    return lab


def _propagate_labels(Xc: torch.Tensor, eps2: float, tile: int, max_iter: int, lab0: torch.Tensor):
    """Min-label propagation over the within-eps graph of the core points
    ``Xc``: tiled distance sweeps plus pointer jumping, from the seed labels
    ``lab0``, until a round changes nothing or ``max_iter`` rounds.
    Returns (labels, converged)."""
    m = Xc.shape[0]
    norms = row_sq_norms(Xc)

    def one_round(lab):
        new = torch.empty_like(lab)
        for s in range(0, m, tile):
            D = sq_dist(Xc[s:s + tile], Xc, norms[s:s + tile], norms)
            nbr = torch.where(D <= eps2, lab[None, :], _INF).amin(dim=1)
            new[s:s + tile] = torch.minimum(lab[s:s + tile], nbr)
        return _pointer_jump(new)

    lab, i, done = one_round(lab0), 0, False
    while not done and i < max_iter:
        new = one_round(lab)
        done = bool(torch.equal(new, lab))
        lab, i = new, i + 1
    return lab, done


def _cell_clique_seed(Xc_host: np.ndarray, eps: float) -> np.ndarray:
    """Initial labels from an (eps/√d)-cell grid: points sharing a cell are
    within eps of each other, hence one clique — merged upfront so the
    propagation rounds scale with the cell-graph diameter instead of the
    point count along a dense cluster."""
    m = len(Xc_host)
    if not eps > 0:  # eps=0: no merging is valid (only exact duplicates connect)
        return np.arange(m, dtype=np.float32)
    cell = np.floor(Xc_host / (eps / np.sqrt(Xc_host.shape[1]))).astype(np.int64)
    _, inv = np.unique(cell, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    seed = np.full(inv.max() + 1, m, np.int64)
    np.minimum.at(seed, inv, np.arange(m))
    return seed[inv].astype(np.float32)


def _dbscan_batch(X: torch.Tensor, eps2: float, coreB: torch.Tensor, lab0B: torch.Tensor,
                  tile: int, max_iter: int):
    """B DBSCAN labelings of one point set at one eps, one per core mask
    in ``coreB`` (B, n): the within-eps adjacency is built once (n² bools:
    why dbscan_grid caps this path) and every labeling's masked min rides
    it.  Returns ((B, n) labels — component min-index for core points,
    nearest-core label for border points, −1 noise — and the converged
    flag)."""
    n = X.shape[0]
    norms = row_sq_norms(X)
    starts = list(range(0, n, tile))
    within = [sq_dist(X[s:s + tile], X, norms[s:s + tile], norms) <= eps2 for s in starts]

    def one_round(labB):
        new = torch.empty_like(labB)
        for s, w in zip(starts, within):
            e = s + w.shape[0]
            nbr = torch.where(w[None] & coreB[:, None, :], labB[:, None, :], _INF).amin(dim=2)
            new[:, s:e] = torch.where(coreB[:, s:e], torch.minimum(labB[:, s:e], nbr), labB[:, s:e])
        return _pointer_jump(new)

    labB, i, done = one_round(lab0B), 0, False
    while not done and i < max_iter:
        new = one_round(labB)
        done = bool(torch.equal(new, labB))
        labB, i = new, i + 1

    # border points adopt their nearest within-eps core neighbour's label
    out = torch.empty_like(labB)
    for s in starts:
        D = sq_dist(X[s:s + tile], X, norms[s:s + tile], norms)
        e = s + D.shape[0]
        Dm = torch.where((D <= eps2)[None] & coreB[:, None, :], D[None], _INF)
        j = Dm.argmin(dim=2)
        hit = torch.isfinite(Dm.gather(2, j[:, :, None])[:, :, 0])
        adopted = torch.where(hit, labB.gather(1, j), -1.0)
        out[:, s:e] = torch.where(coreB[:, s:e], labB[:, s:e], adopted)
    return out, done


def pairwise_d2(X: torch.Tensor) -> torch.Tensor:
    """Full (n, n) squared-distance matrix.  It is eps-independent, so a
    hyperparameter grid computes it once and thresholds it per combo."""
    norms = row_sq_norms(X)
    return sq_dist(X, X, norms, norms)


def dbscan_host_grid(D2: np.ndarray, eps: float, min_samples_list: List[int]) -> np.ndarray:
    """DBSCAN labels for every min_samples at one eps — the single-eps view
    of :func:`dbscan_host_grid_multi`."""
    return dbscan_host_grid_multi(D2, [eps], min_samples_list)[0]


def dbscan_host_grid_multi(D2: np.ndarray, eps_list: List[float], min_samples_list: List[int]
                           ) -> np.ndarray:
    """DBSCAN labels for the full (eps × min_samples) grid from a
    precomputed squared-distance matrix: scipy connected components over
    the core graph plus nearest-core border adoption, the semantics of
    :func:`dbscan_grid` (dense int labels, −1 noise), on the host.

    The within-eps adjacency is monotone in eps, so the edge list is
    extracted once at max(eps) and every smaller eps filters it; per-eps
    neighbour counts come from edge bincounts.  Border points adopt from a
    prefix of their T nearest neighbours, built once for the whole grid
    over the union border set, and fall back to the full row where the
    prefix is inconclusive.  Returns (len(eps_list), len(min_samples_list),
    n) labels."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(D2)
    if not eps_list:  # empty grid (e.g. inverted eps range) → empty labels
        return np.full((0, len(min_samples_list), n), -1, np.int64)
    emax = max(eps_list)
    ei, ej = np.nonzero(D2 <= emax * emax)
    keep = ei < ej
    ei, ej = ei[keep], ej[keep]
    d2e = D2[ei, ej]
    out = np.full((len(eps_list), len(min_samples_list), n), -1, np.int64)
    # T-nearest prefix over the union border set (non-core at the smallest
    # eps and the largest min_samples ⊇ every combo's border set), sorted by
    # (d², index): the first in-eps core of a row's prefix is the exact
    # lowest-index nearest core whenever its distance beats the prefix max
    nn_part = nn_d2 = nn_pmax = bi_pos = None
    if len(min_samples_list):
        emin = min(eps_list)
        wmin = d2e <= emin * emin
        cmin = np.bincount(ei[wmin], minlength=n) + np.bincount(ej[wmin], minlength=n) + 1
        UBI = np.nonzero(cmin < max(min_samples_list))[0]
        if len(UBI):
            Du = D2[UBI]
            T = min(64, n)
            nn_part = np.argpartition(Du, T - 1, axis=1)[:, :T] if T < n else (
                np.broadcast_to(np.arange(n), (len(UBI), n)).copy())
            nn_d2 = np.take_along_axis(Du, nn_part, axis=1)
            o1 = np.argsort(nn_part, axis=1)
            nn_part = np.take_along_axis(nn_part, o1, axis=1)
            nn_d2 = np.take_along_axis(nn_d2, o1, axis=1)
            o2 = np.argsort(nn_d2, axis=1, kind="stable")
            nn_part = np.take_along_axis(nn_part, o2, axis=1)
            nn_d2 = np.take_along_axis(nn_d2, o2, axis=1)
            nn_pmax = nn_d2[:, -1]
            bi_pos = np.full(n, -1, np.int64)
            bi_pos[UBI] = np.arange(len(UBI))
    for a, eps in enumerate(eps_list):
        within = d2e <= eps * eps
        eia, eja = ei[within], ej[within]
        # +1: a point is its own neighbour
        counts = np.bincount(eia, minlength=n) + np.bincount(eja, minlength=n) + 1
        # an edge is core-core for ms iff both endpoint counts reach ms
        edge_min_count = np.minimum(counts[eia], counts[eja])
        for b, ms in enumerate(min_samples_list):
            core = counts >= ms
            ci = np.nonzero(core)[0]
            if len(ci) == 0:
                continue
            remap = np.full(n, -1, np.int64)
            remap[ci] = np.arange(len(ci))  # border adoption indexes by core rank
            ek = edge_min_count >= ms
            ri, rj = remap[eia[ek]], remap[eja[ek]]
            g = coo_matrix((np.ones(len(ri), np.int8), (ri, rj)), shape=(len(ci), len(ci)))
            _, comp = connected_components(g, directed=True, connection="weak")
            out[a, b, ci] = comp
            bi = np.nonzero(~core)[0]
            if len(bi) and nn_part is not None:
                rows_u = bi_pos[bi]  # positions in the union border set
                pref = nn_part[rows_u]  # (m, T) candidate indices
                cand = core[pref] & (nn_d2[rows_u] <= eps * eps)
                has = cand.any(axis=1)
                first = cand.argmax(axis=1)
                r = np.arange(len(bi))
                d_first = nn_d2[rows_u, first]
                pm = nn_pmax[rows_u]
                # conclusive when the chosen core beats the raw prefix max
                ok = has & (d_first < pm)
                owner = pref[r, first]
                out[a, b, bi[ok]] = comp[remap[owner[ok]]]
                # inconclusive rows (boundary tie, or a prefix truncated
                # inside the eps ball): exact full-row adoption
                fb = ~ok & (pm <= eps * eps)
                if fb.any():
                    bif = bi[fb]
                    D2b = D2[bif]
                    Db = np.where(core[None, :] & (D2b <= eps * eps), D2b, np.inf)
                    j = np.argmin(Db, axis=1)
                    hit = np.isfinite(Db[np.arange(len(bif)), j])
                    out[a, b, bif[hit]] = comp[remap[j[hit]]]
    return out


def dbscan_grid(X: np.ndarray, eps: float, min_samples_list: List[int],
                counts: Optional[np.ndarray] = None, tile: int = 4096, max_iter: int = 200
                ) -> np.ndarray:
    """DBSCAN labels for every min_samples at one eps: (B, n) int labels
    (−1 noise) from one batched pass (:func:`_dbscan_batch`).

    The batched pass keeps the full n² boolean adjacency, so beyond
    ``ANOVOS_DBSCAN_BATCH_MAX`` points (default 16384, 268 MB) it falls
    back to per-combo :func:`dbscan_fit`, whose peak memory is O(tile·n)."""
    n = len(X)
    X = np.asarray(X, np.float32)
    X = X - X.mean(axis=0, keepdims=True)  # f32 distance bits follow the spread
    if counts is None:
        counts = neighbor_counts(X, eps, tile)
    if n > int(os.environ.get("ANOVOS_DBSCAN_BATCH_MAX", 16384)):
        return np.stack([dbscan_fit(X, eps, ms, tile, max_iter, counts) for ms in min_samples_list])
    out = np.full((len(min_samples_list), n), -1, np.int64)
    if not min_samples_list:
        return out
    coreB = np.stack([counts >= ms for ms in min_samples_list])
    # one cell-clique seed serves every labeling: same-cell points are
    # pairwise within eps, so same-label core points are always connected
    seed = _cell_clique_seed(X, eps)
    dev = get_runtime().device
    lab0B = torch.from_numpy(np.broadcast_to(seed, (len(min_samples_list), n)).copy()).to(dev)
    labB, done = _dbscan_batch(_device_f32(X), _eps2(eps), torch.from_numpy(coreB).to(dev), lab0B,
                               tile, max_iter)
    if not done:
        warnings.warn(f"dbscan_grid: label propagation hit max_iter={max_iter} without converging")
    labB_h = labB.cpu().numpy()
    for b in range(len(min_samples_list)):
        lab = labB_h[b]
        hit = lab >= 0
        if hit.any():
            out[b, hit] = np.unique(lab[hit], return_inverse=True)[1].reshape(-1)
    return out


def dbscan_fit(X: np.ndarray, eps: float, min_samples: int, tile: int = 4096, max_iter: int = 200,
               counts: Optional[np.ndarray] = None) -> np.ndarray:
    """DBSCAN labels (−1 = noise).

    Core components by min-label propagation over the within-eps core
    graph (O(n) memory, tiled O(n²) distance sweeps); border points adopt
    their nearest within-eps core neighbour's cluster.  ``counts`` lets a
    hyperparameter grid reuse one neighbour-count pass for every
    min_samples at the same eps."""
    n = len(X)
    X = np.asarray(X, np.float32)
    X = X - X.mean(axis=0, keepdims=True)  # f32 distance bits follow the spread
    if counts is None:
        counts = neighbor_counts(X, eps, tile)
    core = counts >= min_samples
    labels = np.full(n, -1, np.int64)
    core_idx = np.nonzero(core)[0]
    if len(core_idx) == 0:
        return labels
    eps2 = _eps2(eps)
    Xd = _device_f32(X)
    Xc = Xd[torch.from_numpy(core_idx).to(Xd.device)]
    seed = _cell_clique_seed(X[core_idx], eps)
    lab, done = _propagate_labels(Xc, eps2, tile, max_iter, torch.from_numpy(seed).to(Xd.device))
    if not done:
        warnings.warn(f"dbscan_fit: label propagation hit max_iter={max_iter} without converging")
    comp = np.unique(lab.cpu().numpy(), return_inverse=True)[1].reshape(-1)
    labels[core_idx] = comp
    border_idx = np.nonzero(~core)[0]
    if len(border_idx):
        Xb = Xd[torch.from_numpy(border_idx).to(Xd.device)]
        tiles = [_nearest_core_tile(Xb[s:s + tile], Xc, eps2) for s in range(0, len(border_idx), tile)]
        owner = torch.cat([o for o, _ in tiles]).cpu().numpy()
        hit = torch.cat([h for _, h in tiles]).cpu().numpy()
        labels[border_idx[hit]] = comp[owner[hit]]
    return labels
