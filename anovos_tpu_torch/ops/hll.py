"""HyperLogLog distinct-count sketches (counterpart of
``anovos_tpu/ops/hll.py``), with registers equal to the JAX package's bit
for bit.

Each value's 32-bit pattern goes through the same multiply-xorshift
avalanche; the top ``p`` bits pick the register, the leading zeros of the
rest (plus one) are its rank, and a register keeps the largest rank it
sees.  torch has little uint32 arithmetic, so the hash runs in int64
lanes masked to 32 bits after every step.  Memory for the registers is
O(k·2^p), whatever the row count.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from anovos_tpu_torch.obs.timed import timed
from anovos_tpu_torch.ops.segment import _U32, _mul_u32

# values (rows × columns) a pass, so a pass's int64 hash lanes stay near 128 MB
_PASS_VALUES = 1 << 24


def precision_for_rsd(rsd: float) -> int:
    """p such that 1.04/sqrt(2^p) ≤ rsd, floored at 4 and capped at 16
    (≈0.41% error); a binding cap warns."""
    if rsd <= 0:
        raise ValueError("rsd must be > 0")
    p = int(math.ceil(math.log2((1.04 / rsd) ** 2)))
    if p > 16:
        warnings.warn(
            f"rsd={rsd} needs precision {p}; clamped to 16 (actual rsd ≈ {1.04 / math.sqrt(1 << 16):.4f})")
    return max(4, min(16, p))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit values held in int64 lanes: 32 − the
    exponent frexp gives (exact in float64; frexp(0) gives 0, so 32)."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def _ranks(X: torch.Tensor, M: torch.Tensor, p: int):
    """(bucket, rank) int64 of a (rows, k) block; rank 0 where masked."""
    if X.dtype in (torch.float32, torch.float64):
        # +0.0 turns −0.0 into +0.0 before the bits are read
        bits = (X.to(torch.float32) + 0.0).view(torch.int32)
    else:
        bits = X.to(torch.int32)
    h = bits.to(torch.int64) & _U32
    h = _mul_u32(h, 0xCC9E2D51)
    h = h ^ (h >> 15)
    h = _mul_u32(h, 0x1B873593)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0x9E3779B1)
    h = h ^ (h >> 16)
    bucket = h >> (32 - p)
    rest = ((h << p) & _U32) | (1 << (p - 1))  # the sentinel bit caps the rank at 33 − p
    return bucket, torch.where(M, _clz32(rest) + 1, 0)


@timed("ops.hll_registers")
def hll_registers(X: torch.Tensor, M: torch.Tensor, p: int) -> torch.Tensor:
    """Per-column HLL registers: X (rows, k) values (floats by their f32
    bit pattern, integers by their int32 value), M (rows, k) → (k, 2^p)
    int32.  Registers merge across row blocks by elementwise max."""
    rows, k = X.shape
    m = 1 << p
    regs = torch.zeros(k * m, dtype=torch.int64, device=X.device)
    offset = torch.arange(k, device=X.device)[None, :] * m
    step = max(1, _PASS_VALUES // max(k, 1))
    for s in range(0, rows, step):
        bucket, rank = _ranks(X[s:s + step], M[s:s + step], p)
        regs.scatter_reduce_(0, (bucket + offset).reshape(-1), rank.reshape(-1), "amax")
    return regs.view(k, m).to(torch.int32)


def hll_estimate(registers: np.ndarray) -> np.ndarray:
    """Distinct-count estimates from (k, m) registers: classic HLL with the
    linear-counting small-range and the 2^32 large-range corrections."""
    registers = np.asarray(registers)
    k, m = registers.shape
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    est = alpha * m * m / np.sum(np.power(2.0, -registers), axis=1)
    zeros = (registers == 0).sum(axis=1)
    small = est <= 2.5 * m
    with np.errstate(divide="ignore"):
        linear = m * np.log(m / np.maximum(zeros, 1))
    est = np.where(small & (zeros > 0), linear, est)
    big = est > (1 / 30) * (1 << 32)
    return np.where(big, -(1 << 32) * np.log1p(-est / (1 << 32)), est)


def approx_nunique(X: torch.Tensor, M: torch.Tensor, rsd: float = 0.05) -> np.ndarray:
    """Per-column approximate distinct counts at relative standard
    deviation ``rsd``."""
    regs = hll_registers(X, M, precision_for_rsd(rsd))
    return hll_estimate(regs.cpu().numpy())
