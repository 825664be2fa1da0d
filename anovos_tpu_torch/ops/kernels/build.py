"""Build and load the port's CUDA kernels.

All sources under ``csrc/`` are built by one
``torch.utils.cpp_extension.load`` call into one extension module: the
kernels (``*.cu``, plain C interface, compiled by ``nvcc`` for ``sm_90a``)
and ``bindings.cpp``, the only source that includes PyTorch's headers.
ninja compiles the sources in parallel.

The build goes to ``build/anovos_tpu_torch_kernels/<digest>/`` at the root
of the checkout; the digest covers the sources, the flags and the PyTorch
version, so an edited source is rebuilt and a stale module is never loaded.
Nothing is built or loaded when this module is imported: only the first
launch of a kernel on a CUDA tensor, or :func:`load`, does it.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("histogram.cu", "moments.cu", "bindings.cpp")
# an explicit -gencode keeps cpp_extension from adding its own arch flags
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3"]

_LOCK = threading.Lock()
_MODULE = None


def _digest() -> str:
    import torch

    h = hashlib.sha256(torch.__version__.encode())
    for name in SOURCES:
        h.update(name.encode() + (CSRC / name).read_bytes())
    h.update(" ".join(CUDA_FLAGS + CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "anovos_tpu_torch_kernels" / _digest()


def load(verbose: bool = False):
    """The extension module of every kernel, built first if needed.
    ``verbose`` shows the compiler's output (``-Xptxas -v`` prints
    registers, shared memory and spills per kernel)."""
    global _MODULE
    with _LOCK:
        if _MODULE is None:
            from torch.utils.cpp_extension import load as cpp_load

            out = build_dir()
            out.mkdir(parents=True, exist_ok=True)
            _MODULE = cpp_load(
                name=f"anovos_tpu_torch_kernels_{out.name}",
                sources=[str(CSRC / s) for s in SOURCES],
                extra_cflags=CXX_FLAGS,
                extra_cuda_cflags=CUDA_FLAGS,
                build_directory=str(out),
                verbose=verbose,
            )
        return _MODULE
