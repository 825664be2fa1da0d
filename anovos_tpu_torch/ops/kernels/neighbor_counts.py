"""Within-eps neighbour counts of a point set (kernel
``csrc/neighbor_counts.cu``, replacing ``neighbor_counts_pallas``) and
their plain PyTorch version.

The kernel splits the queries and the sources over a 2-D grid and adds
partial counts with integer atomics; a pack kernel before it zeroes the
counts and writes the points with their thresholds into a scratch buffer
that the wrapper allocates.  :func:`launch_plan` reports the grid.

The squared distance of points q and x is the expansion
``(|q|² − 2·(q·x)) + |x|²`` in f32, every product and sum rounded on its
own and the sums over coordinates taken in index order.  The kernel and
:func:`sq_dist` compute the same bits, and ``ops/cluster.py`` takes every
DBSCAN distance from :func:`sq_dist`, so counts, adjacency and border
adoption agree on one device.  (XLA on the CPU contracts the sums into
FMAs, so the JAX package's bits differ from these by an ulp of the terms;
the parity tests allow for the pairs that rounding can move across eps².)
"""

from __future__ import annotations

import ctypes

import torch

from anovos_tpu_torch.ops import kernels
from anovos_tpu_torch.ops.kernels import build

# query rows per step of the plain version (ops/cluster.py's tile)
TILE_ROWS = 4096
# widths the kernel is built for
MAX_DIM = 8


def row_sq_norms(X: torch.Tensor) -> torch.Tensor:
    """(n, d) → (n,) squared norms, products rounded one by one and summed
    in index order."""
    if X.shape[1] == 0:
        return X.new_zeros(X.shape[0])
    acc = X[:, 0] * X[:, 0]
    for k in range(1, X.shape[1]):
        acc = acc + X[:, k] * X[:, k]
    return acc


def sq_dist(Xq: torch.Tensor, Xs: torch.Tensor, nq: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """(tq, d) queries and (m, d) sources with their squared norms → the
    (tq, m) f32 squared distances, in the kernel's order of operations."""
    dot = None
    for k in range(Xq.shape[1]):
        prod = Xq[:, k, None] * Xs[None, :, k]
        dot = prod if dot is None else dot.add_(prod)
    if dot is None:
        dot = Xq.new_zeros((Xq.shape[0], Xs.shape[0]))
    # -2·dot is exact, so (-2·dot + |q|²) rounds as (|q|² - 2·dot) does
    return dot.mul_(-2.0).add_(nq[:, None]).add_(ns[None, :])


def neighbor_counts_plain(X: torch.Tensor, eps2: float, tile: int = TILE_ROWS) -> torch.Tensor:
    """(n, d) f32 points → (n,) int32 count of the points within ``eps2``
    (squared), self included, over query tiles of ``tile`` rows."""
    X = X.to(torch.float32)
    norms = row_sq_norms(X)
    out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    for s in range(0, X.shape[0], tile):
        D = sq_dist(X[s:s + tile], X, norms[s:s + tile], norms)
        out[s:s + tile] = (D <= eps2).sum(dim=1)
    return out


def neighbor_counts_rows(X: torch.Tensor, eps2: float, tile: int = TILE_ROWS) -> torch.Tensor:
    """Kernel wrapper: X (n, d) f32 contiguous, ``eps2`` an f32 value →
    (n,) int32 counts.  ``tile`` is the plain version's query tile."""
    if X.dim() != 2:
        raise ValueError(f"neighbor_counts: X must be (n, d), got {tuple(X.shape)}")
    if X.device.type == "cpu":
        return neighbor_counts_plain(X, eps2, tile)
    if X.device.type != "cuda":
        raise ValueError(f"neighbor_counts: unsupported device {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"neighbor_counts: X must be float32, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("neighbor_counts: X must be contiguous")
    if not 1 <= X.shape[1] <= MAX_DIM:
        raise ValueError(f"neighbor_counts: need 1 <= d <= {MAX_DIM}, got {X.shape[1]}")
    n, d = X.shape
    if n > build.C_INT_MAX:
        raise ValueError(f"neighbor_counts: at most {build.C_INT_MAX} points")
    counts = torch.empty(n, dtype=torch.int32, device=X.device)
    if n == 0:
        return counts
    lib = build.load()["neighbor_counts"]
    scratch = torch.empty(lib.anovos_neighbor_counts_scratch(n, d), dtype=torch.float32,
                          device=X.device)
    build.check(lib.anovos_neighbor_counts(X.data_ptr(), float(eps2), scratch.data_ptr(),
                                           counts.data_ptr(), n, d, X.device.index,
                                           build.stream_of(X)),
                "neighbor_counts")
    kernels.LAUNCHES["neighbor_counts"] += 1
    return counts


def launch_plan(n: int, d: int, device: torch.device) -> tuple:
    """(query tiles, source splits, points a split, query rows a tile) of
    the kernel's launch for ``n`` > 0 points of width ``d`` on the CUDA
    ``device``."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    out = (ctypes.c_int * 4)()
    build.check(build.load()["neighbor_counts"].anovos_neighbor_counts_plan(
        n, d, index, ctypes.addressof(out)), "neighbor_counts plan")
    return tuple(out)
