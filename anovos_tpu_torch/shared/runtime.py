"""Device choice for the port (counterpart of ``anovos_tpu/shared/runtime.py``
``init_runtime`` / ``get_runtime``).

The port runs eagerly on one device, so the runtime is only that device:
no mesh, no sharding and no shape buckets.  It is ``cuda`` unless the
caller asks for ``cpu``; asking for ``cuda`` where there is none raises
and never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Runtime:
    device: torch.device

    @property
    def n_devices(self) -> int:
        """Devices the runtime computes on: always one (the JAX runtime's
        mesh size; multi-device is ROADMAP.md Queue A item 5)."""
        return 1


_RUNTIME: Optional[Runtime] = None


def init_runtime(device: Union[str, torch.device] = "cuda") -> Runtime:
    """Set the process-wide device every Table and kernel input lives on."""
    global _RUNTIME
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
    return _RUNTIME


def get_runtime() -> Runtime:
    """The current runtime; the first call without init_runtime picks cuda."""
    if _RUNTIME is None:
        return init_runtime()
    return _RUNTIME


def peek_runtime() -> Optional[Runtime]:
    """The current runtime, or None before any ``init_runtime`` (never
    picks a device)."""
    return _RUNTIME
