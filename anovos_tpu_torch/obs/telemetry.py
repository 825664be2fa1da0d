"""Service heartbeats (counterpart of the heartbeat registry of
``anovos_tpu/obs/telemetry.py``).

The continuum's ``run`` loop beats before and after each step and its
fold refreshes the beat per committed partition, so a watcher that dies
shows a beat going stale.  A one-shot ``step`` never registers one (a
beat nothing refreshes would read as a dead service).

The HTTP plane that reads the beats (``acquire``/``release``,
``/metrics``, ``/healthz``, ``/statusz``, ``ANOVOS_TPU_TELEMETRY``) is
not ported (ROADMAP.md Queue A item 2).  :data:`UNPORTED_KNOBS` lists
every knob the JAX runner, scheduler or renderer reads whose layer the
port still lacks, each with the ROADMAP item that ports it, and
:func:`check_unported_knobs` raises where a user sets one instead of
ignoring it (``workflow.run``/``main`` check them all, the continuum's
``run`` its two service knobs).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, Optional

__all__ = ["beat", "check_unported_knobs", "clear_heartbeat", "heartbeat_ages",
           "refresh_heartbeat"]

_LOCK = threading.Lock()
_HEARTBEATS: Dict[str, dict] = {}

# knobs of layers the port does not have yet: what each asks for and the
# ROADMAP.md Queue A item that ports it
UNPORTED_KNOBS = {
    "ANOVOS_TPU_TELEMETRY": ("the telemetry HTTP plane", 2),
    "ANOVOS_TPU_SLO_ERROR_BUDGET": ("the telemetry plane's SLO windows", 2),
    "ANOVOS_TPU_TRACE_ROTATE": ("trace rotation", 2),
    "ANOVOS_TPU_FLIGHTREC": ("the flight recorder's dumps", 2),
    "ANOVOS_PERF_LEDGER": ("the report's Perf Ledger tab", 2),
    "ANOVOS_RUN_DIFF_BASELINE": ("the report's Run Diff tab", 2),
    "ANOVOS_TPU_HEALTH_TIMEOUT": ("the backend failover's health probe", 3),
    "ANOVOS_TPU_PLACEMENT": ("multi-device placement", 4),
}

# the two knobs of the service plane, which the continuum's run checks
SERVICE_KNOBS = ("ANOVOS_TPU_TELEMETRY", "ANOVOS_TPU_TRACE_ROTATE")


def check_unported_knobs(knobs: Optional[Iterable[str]] = None) -> None:
    """Raise ``NotImplementedError`` when a knob of an unported layer
    (``knobs``, default all of :data:`UNPORTED_KNOBS`) is set to anything
    but off (unset, ``0``, ``false``, ``off``), instead of ignoring the
    request."""
    for knob in (UNPORTED_KNOBS if knobs is None else knobs):
        what, item = UNPORTED_KNOBS[knob]
        if os.environ.get(knob, "").strip().lower() not in ("", "0", "false", "off"):
            raise NotImplementedError(
                f"{knob} asks for {what}, which is not ported to anovos_tpu_torch yet; "
                f"see ROADMAP.md Queue A item {item}")


def beat(name: str, interval_s: float = 30.0,
         stale_after_s: Optional[float] = None) -> None:
    """Record a service heartbeat; it counts as stale past
    ``stale_after_s`` (default 3× the expected interval, at least 1 s)."""
    stale = float(stale_after_s if stale_after_s is not None
                  else max(3.0 * interval_s, 1.0))
    with _LOCK:
        _HEARTBEATS[name] = {
            "t_mono": time.monotonic(),
            "t_unix": round(time.time(), 3),
            "interval_s": float(interval_s),
            "stale_after_s": stale,
        }


def refresh_heartbeat(name: str) -> None:
    """Re-beat ``name`` only if it is already registered: the keepalive of
    a long step, which never registers a beat for a one-shot caller."""
    with _LOCK:
        hb = _HEARTBEATS.get(name)
        if hb is not None:
            hb["t_mono"] = time.monotonic()
            hb["t_unix"] = round(time.time(), 3)


def clear_heartbeat(name: Optional[str] = None) -> None:
    """Drop one heartbeat (or all: tests, service shutdown)."""
    with _LOCK:
        if name is None:
            _HEARTBEATS.clear()
        else:
            _HEARTBEATS.pop(name, None)


def heartbeat_ages(now: Optional[float] = None) -> Dict[str, dict]:
    """``{name: {age_s, interval_s, stale_after_s, stale, last_unix}}``."""
    now = time.monotonic() if now is None else now
    with _LOCK:
        beats = {k: dict(v) for k, v in _HEARTBEATS.items()}
    out: Dict[str, dict] = {}
    for name, hb in sorted(beats.items()):
        age = max(0.0, now - hb["t_mono"])
        out[name] = {
            "age_s": round(age, 3),
            "interval_s": hb["interval_s"],
            "stale_after_s": hb["stale_after_s"],
            "stale": age > hb["stale_after_s"],
            "last_unix": hb["t_unix"],
        }
    return out
