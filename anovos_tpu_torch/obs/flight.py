"""The flight recorder (counterpart of ``anovos_tpu/obs/flight.py``): a
bounded ring of recent lifecycle events and, at a postmortem trigger, a
synchronous dump of everything the process knows.

The ring holds every write-ahead journal append (``cache/journal.py``),
every chaos injection (``resilience/chaos.py``), every part the ingest
guard quarantines (``data_ingest/guard.py``), the scheduler's retries and
a journal-less run's backend failover (``resilience/failover.py``).
The continuum's alerts attach its tail (``continuum/alerts.py``).

The scheduler dumps at the JAX package's four triggers: a watchdog
**timeout escalation**, an **abandonment** (and the fatal timeout after
an escalated bound), a **fatal error** of a raise-mode node, and a
**backend failover** (``resilience/failover.py`` flipped the runtime to
the CPU, on a node's failure or at the watchdog's forced probe; the dump
carries the card's state before the flip as ``pre_flip``).  The feature
server (``serving/server.py``) dumps at **serve_fatal**, a micro-batch
whose apply failed after its retry.  A dump goes to
``<obs_dir>/flightrec_<node>.json`` by tmp file, fsync and rename, never
through the async writer (the process may be about to die), and never
over an earlier dump of the same node (``_2``, ``_3``, ...).  It holds the
trigger and node, the in-flight node set with each node's live devprof
tally, the ready-queue depth, each card's memory, the event ring, the
tracer's last spans, the finished devprof split, the perf doctor's
comparison with the previous run (``doctor``) and a metrics snapshot.
:func:`build_snapshot` assembles that document for the dumps and for the
live plane's ``/statusz`` alike.

``ANOVOS_TPU_FLIGHTREC=0`` disarms the recorder; any other integer sets
the ring's bound (default 256, at least 16).  A clean run dumps nothing.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import List, Optional

logger = logging.getLogger("anovos_tpu_torch.obs.flight")

__all__ = ["build_snapshot", "configure", "destination", "dump", "dump_paths", "enabled", "record",
           "reset", "snapshot_events"]

FLIGHTREC_VERSION = 1
_DEFAULT_EVENTS = 256
_SPAN_TAIL = 200  # tracer spans in a snapshot

_LOCK = threading.Lock()
_RING: Optional[deque] = None   # None until configure(); disarmed when env=0
_DIR: Optional[str] = None      # dump destination (the run's obs/ dir)
_DUMPS: List[str] = []          # paths written since configure()
# the previous completed run's manifest in this obs dir, read when the
# recorder is armed (before this run overwrites it): the doctor's baseline
_BASELINE_MANIFEST: Optional[dict] = None


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
        return _RING is not None and _DIR is not None


def destination() -> Optional[str]:
    """The obs directory dumps go to while armed, else None: what a caller
    passes back to :func:`configure` to re-arm the recorder where it was."""
    with _LOCK:
        return _DIR if _RING is not None else None


def configure(obs_dir: Optional[str]) -> None:
    """Arm the recorder for one run: a fresh ring, dumps to ``obs_dir``,
    and the previous run's ``run_manifest.json`` there as the doctor's
    baseline.  A falsy ``obs_dir`` or ``ANOVOS_TPU_FLIGHTREC=0`` disarms
    it."""
    global _RING, _DIR, _BASELINE_MANIFEST
    bound = _ring_bound()
    baseline = None
    if obs_dir and bound != 0:
        try:
            path = os.path.join(os.path.abspath(obs_dir), "run_manifest.json")
            if os.path.isfile(path):
                with open(path) as f:
                    baseline = json.load(f)
        except Exception:
            baseline = None  # a torn or foreign file is no baseline
    with _LOCK:
        _DUMPS.clear()
        _BASELINE_MANIFEST = baseline
        if not obs_dir or bound == 0:
            _RING, _DIR = None, None
            return
        _RING = deque(maxlen=bound)
        _DIR = os.path.abspath(obs_dir)


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


def dump_paths() -> List[str]:
    """Dump files written since the last :func:`configure`."""
    with _LOCK:
        return list(_DUMPS)


def snapshot_events() -> List[dict]:
    """The current ring, oldest first (empty when disarmed)."""
    with _LOCK:
        return list(_RING) if _RING is not None else []


def _doctor_summary() -> Optional[dict]:
    """The perf doctor's ``live_node_summary`` of this run's devprof state
    against the baseline manifest; None without a baseline, and never
    raises."""
    with _LOCK:
        baseline = _BASELINE_MANIFEST
    if baseline is None:
        return None
    try:
        from anovos_tpu_torch.obs import devprof
        from anovos_tpu_torch.obs.diffing import live_node_summary

        return live_node_summary(baseline, devprof.results(), devprof.active_frames())
    except Exception:
        logger.exception("perf-doctor live summary failed")
        return None


def _safe_name(node: str) -> str:
    out = "".join(c if (c.isalnum() or c in "._-") else "_" for c in node)
    return out or "run"


def _span_tail() -> List[dict]:
    try:
        from anovos_tpu_torch.obs.tracing import get_tracer

        return [{"name": sp.name, "cat": sp.cat, "thread": sp.thread,
                 "start_ms": round(sp.start_ns / 1e6, 3), "dur_ms": round(sp.dur_ns / 1e6, 3),
                 "args": {k: v for k, v in sp.args.items() if isinstance(v, (str, int, float, bool))}}
                for sp in get_tracer().snapshot()[-_SPAN_TAIL:]]
    except Exception:
        return []


def _backend() -> Optional[str]:
    """The runtime's device type (``cuda`` or ``cpu``), None before any
    runtime: the JAX package's ``jax.default_backend()``."""
    try:
        from anovos_tpu_torch.shared.runtime import peek_runtime

        rt = peek_runtime()
        return rt.device.type if rt is not None else None
    except Exception:
        return None


def build_snapshot(trigger: str, node: str = "", inflight: Optional[List[dict]] = None,
                   queue_depth: Optional[int] = None, rendezvous_holders: Optional[List[str]] = None,
                   extra: Optional[dict] = None, events: Optional[List[dict]] = None) -> dict:
    """The flight-recorder document, one code path for :func:`dump` and the
    live ``/statusz``: the in-flight nodes with their live devprof tally,
    the ready-queue depth, the rendezvous holders (none on one card), each
    card's memory, the event ring, the span tail, the finished devprof
    split, the doctor's comparison and a metrics snapshot.  Works with the
    recorder disarmed (the ring is empty then)."""
    from anovos_tpu_torch.obs import devprof
    from anovos_tpu_torch.obs.metrics import get_metrics, memory_by_device

    if events is None:
        events = snapshot_events()
    active = devprof.active_frames()
    inflight_out = []
    for entry in (inflight or []):
        live = active.get(entry.get("node", ""))
        inflight_out.append({**entry, "devprof": live} if live else entry)
    doc = {
        "flightrec_version": FLIGHTREC_VERSION,
        "trigger": trigger,
        "node": node,
        "t_unix": round(time.time(), 3),
        "pid": os.getpid(),
        "backend": _backend(),
        "inflight": inflight_out,
        "queue_depth": queue_depth,
        "rendezvous_holders": list(rendezvous_holders or []),
        "hbm": {dev: {k: stats.get(k) for k in ("bytes_in_use", "peak_bytes_in_use") if k in stats}
                for dev, stats in memory_by_device().items()},
        "events": events,
        "spans_tail": _span_tail(),
        "devprof_finished": devprof.results(),
        "doctor": _doctor_summary(),
        "metrics": get_metrics().snapshot(),
    }
    if extra:
        doc["extra"] = extra
    return doc


def dump(trigger: str, node: str = "", inflight: Optional[List[dict]] = None,
         queue_depth: Optional[int] = None, rendezvous_holders: Optional[List[str]] = None,
         extra: Optional[dict] = None) -> Optional[str]:
    """Write the postmortem for ``trigger``; returns its path, or None when
    disarmed or failed (a recorder must never take the run down)."""
    with _LOCK:
        ring, out_dir = _RING, _DIR
        events = list(ring) if ring is not None else []
    if ring is None or out_dir is None:
        return None
    try:
        doc = build_snapshot(trigger, node=node, inflight=inflight, queue_depth=queue_depth,
                             rendezvous_holders=rendezvous_holders, extra=extra, events=events)
        os.makedirs(out_dir, exist_ok=True)
        # never over an earlier dump of this node, this run's or a crashed
        # earlier run's in the same dir; the path is claimed under the lock
        base = f"flightrec_{_safe_name(node)}"
        with _LOCK:
            taken = set(_DUMPS)
            path = os.path.join(out_dir, base + ".json")
            n = 1
            while path in taken or os.path.exists(path):
                n += 1
                path = os.path.join(out_dir, f"{base}_{n}.json")
            _DUMPS.append(path)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, sort_keys=True, indent=1, separators=(",", ": "))
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            with _LOCK:
                if path in _DUMPS:
                    _DUMPS.remove(path)
            raise
        logger.warning("flight recorder: %s on node %r — postmortem written to %s", trigger, node, path)
        return path
    except Exception:
        logger.exception("flight-recorder dump for %r (%s) failed", node, trigger)
        return None
