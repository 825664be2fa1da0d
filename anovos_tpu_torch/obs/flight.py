"""The flight recorder's event ring (counterpart of the ring half of
``anovos_tpu/obs/flight.py``).

A bounded in-memory ring of recent lifecycle events: every write-ahead
journal append (``cache/journal.py``), every chaos injection
(``resilience/chaos.py``) and every part the ingest guard quarantines
(``data_ingest/guard.py``).  The continuum's alerts attach the ring's
tail (``continuum/alerts.py``), so an alert carries the events that led
up to it.  ``ANOVOS_TPU_FLIGHTREC=0`` disables recording; any other
integer sets the ring's bound (default 256, at least 16).

The postmortem dumps (``dump``, ``build_snapshot``) are not ported
(ROADMAP.md Queue A item 3): their triggers are the scheduler's
escalations and abandonments and the backend failover (item 4).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["configure", "enabled", "record", "reset", "snapshot_events"]

_DEFAULT_EVENTS = 256

_LOCK = threading.Lock()
_RING: Optional[deque] = None   # None until configure(); disabled when env=0


def _ring_bound() -> int:
    raw = os.environ.get("ANOVOS_TPU_FLIGHTREC", "")
    if raw == "0":
        return 0
    try:
        n = int(raw) if raw else _DEFAULT_EVENTS
    except ValueError:
        n = _DEFAULT_EVENTS
    return max(n, 16) if n else 0


def enabled() -> bool:
    with _LOCK:
        return _RING is not None


def configure(obs_dir: Optional[str]) -> None:
    """Arm the recorder with a fresh ring for the run whose telemetry goes
    to ``obs_dir``; a falsy ``obs_dir`` or ``ANOVOS_TPU_FLIGHTREC=0``
    disarms it."""
    global _RING
    bound = _ring_bound()
    with _LOCK:
        _RING = deque(maxlen=bound) if obs_dir and bound else None


def reset() -> None:
    """Disarm and drop state (tests)."""
    configure(None)


def record(kind: str, /, **fields) -> None:
    """Append one lifecycle event to the ring (a no-op when disarmed).  The
    event type lands under ``ev``, so a payload field named ``kind`` never
    collides."""
    with _LOCK:
        if _RING is None:
            return
        _RING.append({"t_unix": round(time.time(), 3), "ev": kind, **fields})


def snapshot_events() -> List[dict]:
    """The current ring, oldest first (empty when disarmed)."""
    with _LOCK:
        return list(_RING) if _RING is not None else []
