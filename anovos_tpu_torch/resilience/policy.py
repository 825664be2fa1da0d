"""Error policies, deterministic backoff and the degradation registry
(counterpart of ``anovos_tpu/resilience/policy.py``).

``on_error`` accepts ``"raise"``, ``"continue"``, ``"retry:N"``,
``"retry:N:degrade"``, ``"retry:N:continue"`` or an :class:`ErrorPolicy`.
Its readers are the DAG scheduler (``parallel/scheduler.py``) and the
ingest guard's retry loop (``data_ingest/guard.py``).  Jitter is
hash-derived from (name, attempt), not ``random``: two runs back off
identically.

The degradation registry is the one record of what a run lost: the
runner's nodes that exhausted their retries and degraded, and the parts
the ingest guard quarantined (``ingest/<file>``).  ``workflow.main``
resets it per run; the concurrent runner records from several threads,
under the registry's lock.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, Union

__all__ = [
    "ErrorPolicy",
    "parse_policy",
    "backoff_delay",
    "record_degraded",
    "degraded_sections",
    "reset_degraded",
]


@dataclasses.dataclass(frozen=True)
class ErrorPolicy:
    """What the scheduler does when a node's attempt fails or times out.

    ``mode`` is the base behavior (``raise`` | ``continue`` | ``retry``);
    with ``retry``, up to ``retries`` re-executions follow the first
    attempt, then ``on_exhausted`` applies.  ``timeout_factor`` is the
    watchdog escalation multiplier: on a node's FIRST timeout the attempt
    is interrupted and the bound raised by this factor before the error
    policy applies at all — spine nodes default higher (they are
    load-bearing and legitimately slow under treatment), read-only
    fan-out nodes lower (a stuck analyzer should fail over to
    degradation quickly)."""

    mode: str = "raise"              # raise | continue | retry
    retries: int = 0                 # re-executions after the first attempt
    on_exhausted: str = "raise"      # raise | degrade | continue
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    timeout_factor: float = 1.5

    def __post_init__(self):
        if self.mode not in ("raise", "continue", "retry"):
            raise ValueError(f"policy mode must be raise|continue|retry, got {self.mode!r}")
        if self.on_exhausted not in ("raise", "degrade", "continue"):
            raise ValueError(
                f"on_exhausted must be raise|degrade|continue, got {self.on_exhausted!r}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")

    def describe(self) -> str:
        if self.mode != "retry":
            return self.mode
        return f"retry:{self.retries}:{self.on_exhausted}"


def parse_policy(on_error: Union[str, ErrorPolicy]) -> ErrorPolicy:
    """The scheduler's ``on_error`` argument → an :class:`ErrorPolicy`.

    Accepts ``"raise"``, ``"continue"``, ``"retry:N"``,
    ``"retry:N:degrade"``, ``"retry:N:continue"`` or an already-built
    policy (passed through unchanged)."""
    if isinstance(on_error, ErrorPolicy):
        return on_error
    if on_error in ("raise", "continue"):
        return ErrorPolicy(mode=on_error)
    if isinstance(on_error, str) and on_error.startswith("retry"):
        parts = on_error.split(":")
        if len(parts) in (2, 3) and parts[0] == "retry":
            try:
                retries = int(parts[1])
            except ValueError:
                raise ValueError(f"on_error {on_error!r}: retry count must be an int")
            exhausted = parts[2] if len(parts) == 3 else "raise"
            return ErrorPolicy(mode="retry", retries=retries, on_exhausted=exhausted)
    raise ValueError(
        f"on_error must be 'raise', 'continue', 'retry:N[:degrade|:continue]' "
        f"or an ErrorPolicy, got {on_error!r}")


def backoff_delay(name: str, attempt: int, policy: ErrorPolicy) -> float:
    """Exponential backoff with deterministic jitter.

    ``base * 2^(attempt-1)``, capped, scaled by a [0.5, 1.0) factor
    hash-derived from (name, attempt) — reproducible across runs (no
    shared RNG state), decorrelated across sibling nodes retrying at the
    same instant (they won't re-dispatch in lockstep against a backend
    that is still recovering)."""
    raw = policy.backoff_base_s * (2.0 ** max(attempt - 1, 0))
    capped = min(raw, policy.backoff_cap_s)
    h = hashlib.sha256(f"{name}:{attempt}".encode()).digest()
    jitter = 0.5 + (h[0] / 255.0) * 0.5
    return capped * jitter


# -- degradation registry ---------------------------------------------------
# per-run state: workflow.main resets it
_DEGRADED: Dict[str, str] = {}
_DEGRADED_LOCK = threading.Lock()


def record_degraded(node: str, reason: str) -> None:
    with _DEGRADED_LOCK:
        _DEGRADED[node] = reason
    from anovos_tpu_torch.obs import get_metrics

    get_metrics().counter(
        "degraded_nodes_total",
        "nodes that exhausted retries and degraded instead of aborting",
    ).inc(node=node)


def degraded_sections() -> Dict[str, str]:
    """node name -> failure reason for every degraded node this run."""
    with _DEGRADED_LOCK:
        return dict(_DEGRADED)


def reset_degraded() -> None:
    with _DEGRADED_LOCK:
        _DEGRADED.clear()
