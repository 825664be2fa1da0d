"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` (``*.cu``, a plain C interface, no
PyTorch headers) is compiled by its own ``nvcc`` for ``sm_90a`` into a
shared library, all of them at once, and loaded with ``ctypes``.  The
wrappers pass each tensor as its device pointer, the stream as PyTorch's
current stream handle and the device as its index; every entry point
returns the CUDA error code of its launch, and :func:`check` raises on any
other than 0.

The libraries go to ``build/anovos_tpu_torch_kernels/<digest>/`` at the root
of the checkout; the digest covers the sources, the shared header and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built or loaded when this module is imported: only the first
launch of a kernel on a CUDA tensor, or :func:`load`, does it.

A wrapper's scratch tensors may be freed when it returns, before its
kernel has run: PyTorch's allocator gives their memory only to work queued
later on the same stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("histogram.cu", "moments.cu", "neighbor_counts.cu")
HEADERS = ("columns.cuh",)
# -Xptxas -v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each library's C entry points: name -> (return type, argument types);
# pointers and the stream go as c_void_p, so they are never cut to 32 bits
ENTRY_POINTS = {
    "moments": {
        "anovos_moments_items": (_I, [_LL]),
        # x, m, part, tickets, out, rows, k, device, stream
        "anovos_moments": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _P]),
    },
    "histogram": {
        # x, m, cuts, scratch, out, rows, k, nbins, device, stream
        "anovos_histograms": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P]),
    },
    "neighbor_counts": {
        "anovos_neighbor_counts_scratch": (_LL, [_I, _I]),
        # n, d, device, out (4 ints)
        "anovos_neighbor_counts_plan": (_I, [_I, _I, _I, _P]),
        # x, eps2, scratch, counts, n, d, device, stream
        "anovos_neighbor_counts": (_I, [_P, ctypes.c_float, _P, _P, _I, _I, _I, _P]),
    },
}

# the largest count (columns, points) an entry point takes, as a C int
C_INT_MAX = 2**31 - 1

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# what nvcc printed for each source in this process's build (registers,
# shared memory and spills of each kernel)
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` where ``CUDA_HOME`` is
    set, else ``nvcc`` on the PATH, else the toolkit's usual place."""
    if os.environ.get("CUDA_HOME"):
        return str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + (CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "anovos_tpu_torch_kernels" / _digest()


def _build(out: Path) -> None:
    """Compile every source whose library is missing, one nvcc each, all
    started together; raise with the compiler's output if one fails."""
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        lib = out / f"lib{Path(src).stem}.so"
        if lib.exists():
            continue
        tmp = out / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[src] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load() -> Dict[str, ctypes.CDLL]:
    """Every kernel library by name (``moments``, ``histogram``,
    ``neighbor_counts``), built first if needed."""
    with _LOCK:
        if not _LIBS:
            out = build_dir()
            _build(out)
            libs = {}
            for name, fns in ENTRY_POINTS.items():
                lib = ctypes.CDLL(str(out / f"lib{name}.so"))
                for fn, (restype, argtypes) in fns.items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = argtypes
                libs[name] = lib
            _LIBS.update(libs)
        return _LIBS


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t):
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary: the moments and histogram kernels read 16-byte vectors from
    column starts they align themselves, relative to the tensor's start.
    PyTorch's allocator aligns every new tensor; only a view can be off."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        import torch

        raise RuntimeError(f"{what}: kernel launch failed: {torch.cuda.CudaError(err)}")
