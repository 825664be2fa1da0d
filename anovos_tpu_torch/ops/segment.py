"""Categorical code counting (the parts of ``anovos_tpu/ops/segment.py`` the
port's slice uses)."""

from __future__ import annotations

from typing import Tuple

import torch


def bucket_segments_pow2(n: int) -> int:
    """2^k size classes (min 8) for a padded per-column dimension."""
    return max(8, 1 << (max(n, 1) - 1).bit_length())


def cat_valid_mask(codes: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """mask & (code >= 0): the categorical null rule."""
    return M & (codes >= 0)


def code_counts(codes: torch.Tensor, M: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Frequency of each code 0..vocab_size-1 of ONE categorical column
    (codes (rows,) with -1 for null) as f32."""
    valid = cat_valid_mask(codes, M)
    return torch.bincount(codes[valid].to(torch.int64), minlength=vocab_size)[:vocab_size].to(torch.float32)


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
