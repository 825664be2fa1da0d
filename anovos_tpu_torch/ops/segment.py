"""Distinct counts, categorical code counting, lookups and row hashes (the
parts of ``anovos_tpu/ops/segment.py`` the port uses)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from anovos_tpu_torch.obs.timed import timed

_U32 = 0xFFFFFFFF


@timed("ops.masked_nunique")
def masked_nunique(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Exact distinct count per column of the valid entries: X (rows, k)
    of any numeric dtype, M (rows, k) bool → (k,) int64.  Integer inputs
    are cast to f32 first, as the JAX package casts them, so the counts
    are its counts on the same data (ints above 2^24 can merge)."""
    dt = X.dtype if X.dtype in (torch.float32, torch.float64) else torch.float32
    rows, k = X.shape
    if rows == 0:
        return torch.zeros(k, dtype=torch.int64, device=X.device)
    Xs = torch.sort(torch.where(M, X.to(dt), torch.finfo(dt).max), dim=0).values
    n = M.sum(dim=0)
    trans = torch.cat([torch.ones((1, k), dtype=torch.bool, device=X.device), Xs[1:] != Xs[:-1]])
    valid = torch.arange(rows, device=X.device)[:, None] < n[None, :]
    return (trans & valid).sum(dim=0)


@timed("ops.vocab_lookup")
def vocab_lookup(lut_host, codes: torch.Tensor) -> torch.Tensor:
    """Per-code lookup through a small host-built table; codes are clipped,
    callers keep their own null masking."""
    lut = torch.as_tensor(np.asarray(lut_host), device=codes.device)
    return lut[torch.clamp(codes.to(torch.int64), 0, len(lut) - 1)]


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant c <
    2^32, with every partial product below 2^63 (c split in 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def row_signature(Xcodes: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Two 32-bit hashes per row over all columns of an int32 block (rows,
    k), nulls hashed as the sentinel −2, for duplicate detection: (rows, 2)
    int64 holding the JAX package's uint32 ``row_signature`` bit for bit."""
    vals = torch.where(M, Xcodes.to(torch.int64), -2) & _U32
    h1 = torch.zeros(Xcodes.shape[0], dtype=torch.int64, device=Xcodes.device)
    h2 = torch.zeros_like(h1)
    for j in range(Xcodes.shape[1]):
        v = vals[:, j]
        h1 = _mul_u32(h1, 1000003) ^ ((v + 0x9E3779B9) & _U32)
        h2 = _mul_u32(h2, 69069) ^ ((_mul_u32(v, 2654435761) + (j + 1)) & _U32)
    return torch.stack([h1, h2], dim=1)


def bucket_segments_pow2(n: int) -> int:
    """2^k size classes (min 8) for a padded per-column dimension."""
    return max(8, 1 << (max(n, 1) - 1).bit_length())


def cat_valid_mask(codes: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """mask & (code >= 0): the categorical null rule."""
    return M & (codes >= 0)


@timed("ops.code_counts")
def code_counts(codes: torch.Tensor, M: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Frequency of each code 0..vocab_size-1 of ONE categorical column
    (codes (rows,) with -1 for null) as f32."""
    valid = cat_valid_mask(codes, M)
    return torch.bincount(codes[valid].to(torch.int64), minlength=vocab_size)[:vocab_size].to(torch.float32)


@timed("ops.code_label_counts")
def code_label_counts(codes: torch.Tensor, M: torch.Tensor, y: torch.Tensor,
                      vocab_size: int) -> torch.Tensor:
    """Per-code sum of a row weight or 0/1 label y (rows,) over the valid
    rows of ONE categorical column: (vocab_size,) float64, so event counts
    stay exact past 2^24 rows a code."""
    valid = cat_valid_mask(codes, M)
    return torch.bincount(codes[valid].to(torch.int64), weights=y[valid].to(torch.float64),
                          minlength=vocab_size)[:vocab_size]


def code_histograms(C: torch.Tensor, M: torch.Tensor, nbins: int) -> torch.Tensor:
    """Categorical codes (rows, k), −1 null → (k, nbins) f32 counts."""
    k = C.shape[1]
    valid = M & (C >= 0)
    offset = torch.arange(k, device=C.device)[None, :] * nbins
    flat = torch.where(valid, C.to(torch.int64) + offset, k * nbins)
    counts = torch.bincount(flat.reshape(-1), minlength=k * nbins + 1)[: k * nbins]
    return counts.view(k, nbins).to(torch.float32)


def mode_from_counts(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(argmax code, count) of a (vocab,) count vector; ties → lowest code."""
    return torch.argmax(counts), counts.max()
