"""Hand-written Hopper kernels of the port (the counterpart of
``anovos_tpu/ops/pallas_kernels.py``) and their wrappers.

Each wrapper takes column-major (k, rows) blocks.  On a CUDA tensor it
launches its kernel or raises; on a CPU tensor, and only there, it runs
the kernel's plain PyTorch version, which sits in the same module.  Every
launch of a kernel adds one to its entry in :data:`LAUNCHES`, so a run can
show that it went through the kernels.
"""

from __future__ import annotations

from typing import Dict

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"masked_moments": 0, "binned_histograms": 0}

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
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
