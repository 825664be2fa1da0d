"""Masked alternating least squares (counterpart of
``anovos_tpu/ops/als.py`` ``als_impute``): the (rows, k) block with its
missing cells is the ratings matrix, factorized as U Vᵀ by alternating
ridge solves, all rows of a side in one batched Cholesky solve."""

from __future__ import annotations

import math
import torch

from anovos_tpu_torch.ops.mxu import true_f32


def _solve_side(Y: torch.Tensor, F: torch.Tensor, M: torch.Tensor, reg: float) -> torch.Tensor:
    """For each row i of Y (n, k): argmin_u Σ_j m_ij (y_ij − f_j·u)² +
    reg·max(n_i, 1)·|u|², F (k, r) fixed, n_i the row's observed count →
    (n, r)."""
    r = F.shape[1]
    Mf = M.to(torch.float32)
    outer = (F[:, :, None] * F[:, None, :]).reshape(F.shape[0], r * r)
    with true_f32():
        A = (Mf @ outer).reshape(-1, r, r)
        b = torch.where(M, Y, 0.0) @ F
    ridge = reg * torch.clamp_min(Mf.sum(dim=1), 1.0)
    A = A + ridge[:, None, None] * torch.eye(r, dtype=A.dtype, device=A.device)
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[:, :, None], L)[:, :, 0]


def init_factors(X: torch.Tensor, M: torch.Tensor, rank: int, seed: int) -> torch.Tensor:
    """Starting column factors V (k, rank): normal draws from a
    ``torch.Generator`` seeded with ``seed``, scaled by
    √(mean |observed value| / rank + 1e-6).  (The first round solves the
    row factors from V, so none are drawn for them.)"""
    scale = math.sqrt(float(torch.abs(torch.where(M, X, 0.0)).mean()) / max(rank, 1) + 1e-6)
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((X.shape[1], rank), generator=gen) * scale).to(X.device)


def als_impute(X: torch.Tensor, M: torch.Tensor, rank: int = 10, iters: int = 20, reg: float = 0.01,
               seed: int = 0) -> torch.Tensor:
    """X (rows, k) f32 with mask M → the completed matrix U Vᵀ after
    ``iters`` rounds (U given V, then V given U) from
    :func:`init_factors`.  The ridge term scales with each row's /
    column's observed count (MLlib's ALS-WR)."""
    V = init_factors(X, M, rank, seed)
    Xt, Mt = X.t(), M.t()
    for _ in range(iters):
        U = _solve_side(X, V, M, reg)
        V = _solve_side(Xt, U, Mt, reg)
    with true_f32():
        return U @ V.t()
