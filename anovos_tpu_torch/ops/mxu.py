"""Guarded matmul sites (counterpart of ``anovos_tpu/ops/mxu.py``).

Quadratic expansions (raw-moment covariance, pairwise distances) lose
their bits to reduced-precision matmul inputs, so every product here is
true f32: on Hopper that means TF32 off for the call, whatever the
caller set globally.  Only products whose inputs are pre-centred (the
correlation and covariance sums) may opt into bf16 inputs with f32
accumulation, through ``ANOVOS_TPU_BF16=1``, read per call.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

__all__ = ["bf16_sweep", "mm", "true_f32"]


def bf16_sweep() -> bool:
    """True when ``ANOVOS_TPU_BF16=1``: the guarded sites take bf16 inputs
    and accumulate in f32."""
    return os.environ.get("ANOVOS_TPU_BF16", "0") == "1"


_PIN_LOCK = threading.Lock()
_PIN = {"depth": 0, "prev": None}


@contextlib.contextmanager
def true_f32():
    """f32 matmuls run in IEEE f32 (no TF32) inside the block; the caller's
    setting is restored after it.  Uses the ``fp32_precision`` API only:
    reading the legacy ``allow_tf32`` flag raises once both APIs were
    used in a process.  The setting is process-wide and the concurrent
    runner enters blocks from several threads, so it is pinned by the
    first block in and restored by the last one out."""
    m = torch.backends.cuda.matmul
    with _PIN_LOCK:
        if _PIN["depth"] == 0:
            _PIN["prev"] = m.fp32_precision
            m.fp32_precision = "ieee"
        _PIN["depth"] += 1
    try:
        yield
    finally:
        with _PIN_LOCK:
            _PIN["depth"] -= 1
            if _PIN["depth"] == 0:
                m.fp32_precision = _PIN["prev"]


def mm(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """One guarded matmul, f32 out.  ``bf16``: inputs rounded to bf16 (the
    products of two bf16 values are exact in f32), f32 accumulation;
    otherwise true f32."""
    if bf16:
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    with true_f32():
        return torch.matmul(a, b)
