"""Hand-written Hopper kernels of the port (the counterpart of
``anovos_tpu/ops/pallas_kernels.py``) and their wrappers.

The moments and histogram wrappers take column-major (k, rows) blocks,
the neighbour-count wrapper an (n, d) point set.  On a CUDA tensor each
launches its kernel or raises; on a CPU tensor, and only there, it runs
the kernel's plain PyTorch version, which sits in the same module.  Every
launch of a kernel adds one to its entry in :data:`LAUNCHES` through
:func:`count_launch`, under a lock (the concurrent runner launches from
several worker threads), so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import threading
from typing import Dict

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"masked_moments": 0, "binned_histograms": 0, "neighbor_counts": 0}
_LAUNCH_LOCK = threading.Lock()

# what chip_smoke.py reports for each kernel: its source and the TPU kernel
# it replaces
KERNELS = {
    "masked_moments": {
        "route": "cuda",
        "source": "anovos_tpu_torch/ops/kernels/csrc/moments.cu",
        "replaces": "anovos_tpu/ops/pallas_kernels.py:149",
    },
    "binned_histograms": {
        "route": "cuda",
        "source": "anovos_tpu_torch/ops/kernels/csrc/histogram.cu",
        "replaces": "anovos_tpu/ops/pallas_kernels.py:64",
    },
    "neighbor_counts": {
        "route": "cuda",
        "source": "anovos_tpu_torch/ops/kernels/csrc/neighbor_counts.cu",
        "replaces": "anovos_tpu/ops/pallas_kernels.py:203",
    },
}


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` (a wrapper calls this where it
    launches, and nowhere else)."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
