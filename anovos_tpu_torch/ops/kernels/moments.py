"""Single-pass masked moments (kernel ``csrc/moments.cu``, replacing
``moments_pallas``) and their plain PyTorch version.

Both return the (8, k) f32 accumulator [n, mean, M2, M3, M4, min, max,
nonzero]; ``ops/reductions.finalize_moments`` finalizes it."""

from __future__ import annotations

import torch

from anovos_tpu_torch.ops import kernels
from anovos_tpu_torch.ops.kernels import build

# the Pallas kernel's row tile and empty-min/max sentinel
TILE_ROWS = 2048
BIG = 3.4e38


def _chan_merge(acc, tile):
    """The Pallas kernel's merge of one tile into the running accumulator,
    operation for operation."""
    na, nb = acc[0], tile[0]
    n = na + nb
    s = torch.clamp_min(n, 1.0)
    delta = tile[1] - acc[1]
    mean = acc[1] + delta * nb / s
    M2 = acc[2] + tile[2] + delta * delta * na * nb / s
    M3 = (acc[3] + tile[3]
          + delta * delta * delta * na * nb * (na - nb) / (s * s)
          + 3 * delta * (na * tile[2] - nb * acc[2]) / s)
    M4 = (acc[4] + tile[4]
          + (delta * delta) * (delta * delta) * na * nb * (na * na - na * nb + nb * nb) / (s * s * s)
          + 6 * (delta * delta) * (na * na * tile[2] + nb * nb * acc[2]) / (s * s)
          + 4 * delta * (na * tile[3] - nb * acc[3]) / s)
    return torch.stack([n, mean, M2, M3, M4, torch.minimum(acc[5], tile[5]),
                        torch.maximum(acc[6], tile[6]), acc[7] + tile[7]])


def masked_moments_plain(Xc: torch.Tensor, Mc: torch.Tensor) -> torch.Tensor:
    """(k, rows) values and mask → (8, k) accumulator, following the Pallas
    kernel: per 2048-row tile a two-pass centered sum, tiles Chan-merged in
    row order."""
    k, rows = Xc.shape
    x = Xc.to(torch.float32)
    pad = (-rows) % TILE_ROWS
    if pad:
        x = torch.cat([x, x.new_zeros((k, pad))], dim=1)
        Mc = torch.cat([Mc, Mc.new_zeros((k, pad))], dim=1)
    ntiles = x.shape[1] // TILE_ROWS
    x = x.view(k, ntiles, TILE_ROWS)
    m = Mc.view(k, ntiles, TILE_ROWS)
    n_t = m.sum(dim=2).to(torch.float32)
    mean_t = torch.where(m, x, 0.0).sum(dim=2) / torch.clamp_min(n_t, 1.0)
    d = torch.where(m, x - mean_t[:, :, None], 0.0)
    d2 = d * d
    tiles = torch.stack([
        n_t, mean_t, d2.sum(dim=2), (d2 * d).sum(dim=2), (d2 * d2).sum(dim=2),
        torch.where(m, x, BIG).amin(dim=2), torch.where(m, x, -BIG).amax(dim=2),
        (m & (x != 0)).sum(dim=2).to(torch.float32),
    ])  # (8, k, ntiles)
    if ntiles == 0:
        acc = torch.zeros((8, k), dtype=torch.float32, device=x.device)
        acc[5], acc[6] = BIG, -BIG
        return acc
    acc = tiles[:, :, 0]
    for i in range(1, ntiles):
        acc = _chan_merge(acc, tiles[:, :, i])
    return acc


def masked_moments_cols(Xc: torch.Tensor, Mc: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: Xc (k, rows) f32 and Mc (k, rows) bool, both
    contiguous → (8, k) f32 accumulator."""
    if Xc.dim() != 2 or Mc.shape != Xc.shape:
        raise ValueError(f"masked_moments: X {tuple(Xc.shape)} and M {tuple(Mc.shape)} "
                         "must be the same (k, rows) shape")
    if Xc.device.type == "cpu":
        return masked_moments_plain(Xc, Mc)
    if Xc.device.type != "cuda":
        raise ValueError(f"masked_moments: unsupported device {Xc.device}")
    if Xc.dtype != torch.float32 or Mc.dtype != torch.bool:
        raise TypeError(f"masked_moments: X must be float32 and M bool; got {Xc.dtype}, {Mc.dtype}")
    if not (Xc.is_contiguous() and Mc.is_contiguous()):
        raise ValueError("masked_moments: X and M must be contiguous")
    if Mc.device != Xc.device:
        raise ValueError("masked_moments: X and M must be on one device")
    k, rows = Xc.shape
    if k > build.C_INT_MAX:
        raise ValueError(f"masked_moments: at most {build.C_INT_MAX} columns a launch")
    out = torch.empty((8, k), dtype=torch.float32, device=Xc.device)
    if k == 0:
        return out
    Xc, Mc = build.aligned(Xc), build.aligned(Mc)
    lib = build.load()["moments"]
    # one partial a work item: [n, reference, mean, M2, M3, M4, min, max, nonzero]
    part = torch.empty((k * lib.anovos_moments_items(rows), 9), dtype=torch.float32,
                       device=Xc.device)
    # one ticket a column, zeroed by the entry point
    tickets = torch.empty(k, dtype=torch.int32, device=Xc.device)
    build.check(lib.anovos_moments(Xc.data_ptr(), Mc.data_ptr(), part.data_ptr(),
                                   tickets.data_ptr(), out.data_ptr(), rows, k, Xc.device.index,
                                   build.stream_of(Xc)),
                "masked_moments")
    kernels.LAUNCHES["masked_moments"] += 1
    return out
