"""Device choice for the port (counterpart of ``anovos_tpu/shared/runtime.py``
``init_runtime`` / ``get_runtime``).

The port runs eagerly on one device, so the runtime is only that device:
no mesh, no sharding and no shape buckets.  It is ``cuda`` unless the
caller asks for ``cpu``; asking for ``cuda`` where there is none raises
and never falls back to the CPU.  The one way a run leaves the card is
the backend failover (``resilience/failover.py``), whose flip is itself an
``init_runtime("cpu")``.  Every ``init_runtime`` bumps
:func:`runtime_generation`: whatever holds a device (the scheduler's
worker streams, a df version on the card) reads the counter to see that
its device is stale.  :func:`pinned_runtime` keeps one thread on the
runtime it started with (the scheduler pins each node attempt), so a node
in flight at a flip finishes on the card and only the attempts that start
after it compute on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Runtime:
    device: torch.device

    @property
    def n_devices(self) -> int:
        """Devices the runtime computes on: always one (the JAX runtime's
        mesh size; multi-device is ROADMAP.md Queue A, multi-device)."""
        return 1


_RUNTIME: Optional[Runtime] = None
# bumped by every init_runtime, the failover's flip to the CPU included
_RUNTIME_GEN = 0
# a thread's pinned runtime (pinned_runtime), which init_runtime leaves alone
_PINNED = threading.local()


def init_runtime(device: Union[str, torch.device] = "cuda") -> Runtime:
    """Set the process-wide device every Table and kernel input lives on."""
    global _RUNTIME, _RUNTIME_GEN
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_runtime: CUDA device requested but torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"init_runtime: unsupported device {dev}")
    _RUNTIME = Runtime(device=dev)
    _RUNTIME_GEN += 1
    return _RUNTIME


def get_runtime() -> Runtime:
    """The current runtime (this thread's pinned one, else the process's);
    the first call without init_runtime picks cuda."""
    rt = getattr(_PINNED, "runtime", None) or _RUNTIME
    if rt is None:
        return init_runtime()
    return rt


def peek_runtime() -> Optional[Runtime]:
    """The current runtime (this thread's pinned one, else the process's),
    or None before any ``init_runtime`` (never picks a device)."""
    return getattr(_PINNED, "runtime", None) or _RUNTIME


@contextlib.contextmanager
def pinned_runtime():
    """For the block, this thread computes on the current runtime,
    whatever ``init_runtime`` does meanwhile."""
    prev = getattr(_PINNED, "runtime", None)
    _PINNED.runtime = peek_runtime()
    try:
        yield
    finally:
        _PINNED.runtime = prev


def runtime_generation() -> int:
    """Monotonic counter bumped by every :func:`init_runtime` (the
    failover's flip included): a holder of a device compares it with the
    value it saw when it took the device."""
    return _RUNTIME_GEN
