"""Row-keep masks for sampling (counterpart of ``anovos_tpu/ops/sampling.py``).

Uniform draws from a ``torch.Generator`` on the table's device, seeded
with the caller's seed: deterministic for a seed on one device, but not
the rows ``jax.random`` keeps for the same seed (a divergence by design).
"""

from __future__ import annotations

import torch


def uniform(seed: int, n: int, device) -> torch.Tensor:
    """``n`` f32 draws in [0, 1) from a generator on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(n, generator=gen, device=device)


def sample_mask(seed: int, n: int, fraction: float, device) -> torch.Tensor:
    """Row-keep mask of a simple random sample: each row kept with
    probability ``fraction`` (compared in f32, as the JAX package does)."""
    return uniform(seed, n, device) < torch.tensor(fraction, dtype=torch.float32, device=device)


def stratified_mask(seed: int, codes: torch.Tensor, fractions: torch.Tensor) -> torch.Tensor:
    """Per-stratum keep mask: ``codes`` (rows,) int stratum ids, −1 = null
    stratum (dropped); ``fractions`` (n_strata,) keep probability each."""
    u = uniform(seed, codes.shape[0], codes.device)
    f = torch.where(codes >= 0, fractions.to(codes.device)[torch.clamp_min(codes.to(torch.int64), 0)],
                    0.0)
    return u < f
