"""Chunked moments and their float64 merge (the moment-merge part of
``anovos_tpu/ops/streaming.py``).

``_chunk_stats`` takes the statistics of every chunk of every column in
one launch of the moments kernel over a column-major (chunks, rows) view;
``_pairwise_merge`` combines chunk partials in float64 on the host with
Chan et al.'s formulas, as a balanced tree (a linear fold would let the
error grow with the chunk count).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols

_FIELDS = ("n", "mean", "M2", "M3", "M4", "min", "max", "nonzero")


def _chunk_stats(Xc: torch.Tensor, Mc: torch.Tensor) -> Dict[str, np.ndarray]:
    """Per-row statistics of a contiguous (chunks, rows) f32 block and its
    bool mask: float64 host arrays n, mean, M2, M3, M4 (central sums about
    each chunk's own mean), min, max, nonzero.  A chunk with no valid value
    has n = 0, mean and central sums 0 (the merge's identity) and the
    kernel's ±3.4e38 min/max sentinels."""
    acc = masked_moments_cols(Xc, Mc).to(torch.float64).cpu().numpy()
    out = dict(zip(_FIELDS, acc))
    empty = out["n"] == 0
    for f in ("mean", "M2", "M3", "M4"):
        out[f] = np.where(empty, 0.0, out[f])
    return out


def _combine(a: dict, b: dict) -> dict:
    """Chan et al. pairwise moment combination (numerically stable merge)."""
    n = a["n"] + b["n"]
    safe = np.maximum(n, 1.0)
    delta = b["mean"] - a["mean"]
    na, nb = a["n"], b["n"]
    mean = a["mean"] + delta * nb / safe
    M2 = a["M2"] + b["M2"] + delta**2 * na * nb / safe
    M3 = (
        a["M3"] + b["M3"]
        + delta**3 * na * nb * (na - nb) / safe**2
        + 3 * delta * (na * b["M2"] - nb * a["M2"]) / safe
    )
    M4 = (
        a["M4"] + b["M4"]
        + delta**4 * na * nb * (na**2 - na * nb + nb**2) / safe**3
        + 6 * delta**2 * (na**2 * b["M2"] + nb**2 * a["M2"]) / safe**2
        + 4 * delta * (na * b["M3"] - nb * a["M3"]) / safe
    )
    return {
        "n": n, "mean": mean, "M2": M2, "M3": M3, "M4": M4,
        "min": np.minimum(a["min"], b["min"]),
        "max": np.maximum(a["max"], b["max"]),
        "nonzero": a["nonzero"] + b["nonzero"],
    }


def _pairwise_merge(parts: List[dict]) -> dict:
    """Tree-reduce chunk partials: neighbours merge pairwise, level by
    level, an odd last one carried up."""
    while len(parts) > 1:
        parts = [
            _combine(parts[i], parts[i + 1]) if i + 1 < len(parts) else parts[i]
            for i in range(0, len(parts), 2)
        ]
    return parts[0]
