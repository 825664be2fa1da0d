"""Declarative node placement: where a scheduler node's device work runs
(counterpart of ``anovos_tpu/parallel/placement.py``).

Every registration of the runner declares a :class:`Placement`, as the
JAX runner's do, and the declaration is kept on the node:

* ``mesh`` — the node's work spans every device (on a multi-device
  runtime, programs with collectives);
* ``submesh:N`` — the same over N devices;
* ``device`` — the node's work stays on one device;
* ``host`` — the node touches no device (report rendering, CSV work).

The port runs on one card, so ``mesh``, ``submesh:N`` and ``device`` all
mean that card, and the scheduler holds no device leases: it only tells
a device node (which runs on a CUDA stream of its own) from a host node
(which takes no stream).  The multi-device lanes that read the rest of
the declaration are ROADMAP.md Queue A, multi-device.
"""

from __future__ import annotations

import dataclasses
from typing import Union

__all__ = ["Placement", "parse_placement"]

_KINDS = ("mesh", "submesh", "device", "host")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one node's device work is allowed to run.

    ``kind`` is one of ``mesh`` / ``submesh`` / ``device`` / ``host``;
    ``n_devices`` is the sub-mesh width request (``submesh`` only).
    """

    kind: str = "host"
    n_devices: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"placement kind must be one of {_KINDS}, got {self.kind!r}")
        if self.kind == "submesh" and self.n_devices < 1:
            raise ValueError("submesh placement needs n_devices >= 1")

    @property
    def on_device(self) -> bool:
        """True when the node's work runs on the card (every kind but
        ``host``)."""
        return self.kind != "host"

    def describe(self) -> str:
        if self.kind == "submesh":
            return f"submesh:{self.n_devices}"
        return self.kind


HOST = Placement("host")


def parse_placement(spec: Union[None, str, Placement]) -> Placement:
    """``None`` (unplaced library nodes) → ``host``; strings are
    ``"mesh"`` / ``"device"`` / ``"host"`` / ``"submesh:N"``."""
    if spec is None:
        return HOST
    if isinstance(spec, Placement):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"placement must be a string or Placement, got {spec!r}")
    if spec.startswith("submesh:"):
        try:
            n = int(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad submesh placement {spec!r} (submesh:N)")
        return Placement("submesh", n)
    return Placement(spec)
