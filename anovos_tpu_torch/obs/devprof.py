"""Per-node device-time attribution: where a scheduler node's wall went
(counterpart of ``anovos_tpu/obs/devprof.py``).

A node's wall holds four different costs on the card:

* **device time** — the card still computing when the node's host code
  is done;
* **dispatch** — host wall inside ``@timed`` op calls (kernels are
  launched asynchronously, so this is enqueue time, not compute time:
  ``obs.timed``'s caveat);
* **transfer** — host↔device movement at the ``Table`` materialisation
  boundaries (h2d in ``shared/table.host_to_column``, d2h in
  ``Table.to_pandas``, ``Column.exact_host`` and the concatenate), with
  exact byte counts;
* **host** — everything else (pandas/pyarrow work, CSV writes, Python
  orchestration), computed as the remainder.

Mechanism:

* ``node_bracket(name)`` wraps one scheduler node.  On entry it samples
  each card's allocated bytes (``torch.cuda.memory_stats``); on exit it
  books the node's **drain**: the timed ``synchronize()`` of the CUDA
  stream the node ran on, less a floor (one sync of an idle stream,
  measured at :func:`reset`).  A stream runs its kernels in enqueue order,
  so that wall is the device work still in flight at the node's end.  The
  scheduler makes the drain the sync it performs anyway: in the
  concurrent mode the worker stream's sync at the end of each attempt
  (``parallel/scheduler._on_stream``), in the sequential mode a sync of
  the caller's current stream at the end of each attempt.  Either way the
  sync runs inside the attempt, so a CUDA error that surfaces there fails
  the node under its error policy.  A direct caller's bracket drains the
  current stream at its exit.  On a CPU runtime the drain is 0 and no
  sync is made.  (A d2h copy is itself a completion barrier, so device
  tail consumed by a materialising fetch lands in ``transfer_s``: the
  attribution is "what the host was waiting on", not a hardware counter.)
* ``dispatch_bracket(label)`` is entered by every ``timed()`` op; only
  the OUTERMOST bracket on a thread books its wall (nested timed ops
  would double-count), and only ``execute``-phase walls count as
  dispatch (first-call walls hold first-use costs: host work, left in
  the remainder).
* ``transfer_bracket(direction, nbytes)`` wraps the materialisation
  choke points and books wall and bytes into both the active frame and
  the process-wide ``transfer_{h2d,d2h}_bytes_total`` counters.

Attribution is clamped so ``device_time_s + dispatch_s + transfer_s +
host_s ≤ wall`` always holds: components that exceed the wall (overlap
between categories) are scaled down proportionally and the frame is
marked ``clamped``.

Everything lands in (a) the run manifest's ``devprof`` section (stripped
by ``stable_view``: telemetry), (b) ``devprof_*`` metric families, and
(c) a ``devprof:<node>`` tracer instant next to the node span.
``ANOVOS_TPU_DEVPROF=0`` disables the brackets; in the concurrent mode
the drain is booked only under ``ANOVOS_TPU_DEVPROF=full`` and only for
nodes that run on a worker stream (host nodes take none), else
``device_time_s`` stays 0 and the device share lands in whichever
category waited on it.  Under ``ANOVOS_PROFILE`` the node bracket also
opens ``torch.profiler.record_function(name)``, so the profiler trace
puts each kernel under its pipeline node.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from anovos_tpu_torch.obs.metrics import get_metrics, memory_by_device

logger = logging.getLogger("anovos_tpu_torch.obs.devprof")

__all__ = [
    "enabled",
    "reset",
    "current_node",
    "current_frame",
    "node_bracket",
    "dispatch_bracket",
    "drain_stream",
    "transfer_bracket",
    "record_transfer",
    "record_decode",
    "results",
    "active_frames",
]

_LOCK = threading.Lock()
_RESULTS: Dict[str, dict] = {}     # node name -> finished attribution
_ACTIVE: Dict[str, "_Frame"] = {}  # node name -> in-flight frame
_TL = threading.local()            # .frame (current _Frame), .dispatch_depth

# wall of one sync of an idle stream (the least of three, measured at
# reset); subtracted from each drain so an idle card attributes ~0
# device time
_PROBE_FLOOR = 0.0


def enabled() -> bool:
    """Brackets active unless ``ANOVOS_TPU_DEVPROF=0``."""
    return os.environ.get("ANOVOS_TPU_DEVPROF", "1") != "0"


def _cuda_device():
    """The runtime's card, or None on a CPU runtime (or none at all)."""
    if sys.modules.get("torch") is None:
        return None
    from anovos_tpu_torch.shared.runtime import peek_runtime

    rt = peek_runtime()
    return rt.device if rt is not None and rt.device.type == "cuda" else None


class _Frame:
    __slots__ = ("name", "t0", "dispatch_s", "transfer_s", "device_s", "drained",
                 "h2d_bytes", "d2h_bytes", "dispatches", "transfers",
                 "decode_s", "decode_bytes", "decodes",
                 "last_op", "hbm0", "lane", "devices", "_lock")

    def __init__(self, name: str, lane: Optional[str] = None,
                 devices: Optional[list] = None):
        self.name = name
        # the lane the scheduler ran this node on and its device labels
        self.lane = lane
        self.devices = list(devices or [])
        self.t0 = time.perf_counter()
        self.dispatch_s = 0.0
        self.transfer_s = 0.0
        self.device_s = 0.0
        self.drained = False   # the scheduler booked this node's drain
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.dispatches = 0
        self.transfers = 0
        # part-file decode (streaming ingest): booked from prefetch-pool
        # threads too, so it can overlap the node wall; an informational
        # sub-attribution kept OUT of the clamped ≤ wall invariant
        self.decode_s = 0.0
        self.decode_bytes = 0
        self.decodes = 0
        self.last_op: Optional[str] = None
        self.hbm0 = _hbm_in_use()
        # transfer and dispatch hooks fire from the node's worker thread,
        # decode hooks from prefetch threads: accumulate under a lock
        self._lock = threading.Lock()

    def add_dispatch(self, seconds: float, label: str) -> None:
        with self._lock:
            self.dispatch_s += seconds
            self.dispatches += 1
            self.last_op = label

    def add_drain(self, seconds: float) -> None:
        with self._lock:
            self.device_s += max(seconds - _PROBE_FLOOR, 0.0)
            self.drained = True

    def add_transfer(self, direction: str, nbytes: int, seconds: float,
                     label: str) -> None:
        with self._lock:
            self.transfer_s += seconds
            self.transfers += 1
            if direction == "h2d":
                self.h2d_bytes += nbytes
            elif direction == "d2h":
                self.d2h_bytes += nbytes
            self.last_op = label

    def add_decode(self, seconds: float, nbytes: int, label: str) -> None:
        with self._lock:
            self.decode_s += seconds
            self.decode_bytes += nbytes
            self.decodes += 1
            self.last_op = label

    def snapshot(self) -> dict:
        """In-flight view (read mid-node)."""
        with self._lock:
            return {
                "lane": self.lane,
                "devices": list(self.devices),
                "elapsed_s": round(time.perf_counter() - self.t0, 4),
                "dispatch_s": round(self.dispatch_s, 4),
                "transfer_s": round(self.transfer_s, 4),
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "decode_s": round(self.decode_s, 4),
                "decode_bytes": self.decode_bytes,
                "last_op": self.last_op,
            }

    def finish(self, drain: bool = True) -> dict:
        wall = time.perf_counter() - self.t0
        if not drain:
            self.device_s = 0.0
        hbm1 = _hbm_in_use()
        hbm_delta = {dev: int(hbm1.get(dev, 0) - b0) for dev, b0 in self.hbm0.items()}
        clamped = False
        attributed = self.device_s + self.dispatch_s + self.transfer_s
        if attributed > wall > 0.0:
            scale = wall / attributed
            self.device_s *= scale
            self.dispatch_s *= scale
            self.transfer_s *= scale
            clamped = True
        # round the wall and the three attributed components first, then
        # derive host from the rounded values; any rounding excess comes
        # off the largest component, so the sum never passes the wall
        wall_r = round(wall, 6)
        dev_r = round(self.device_s, 6)
        disp_r = round(self.dispatch_s, 6)
        xfer_r = round(self.transfer_s, 6)
        excess = round(dev_r + disp_r + xfer_r - wall_r, 6)
        if excess > 0:
            if dev_r >= disp_r and dev_r >= xfer_r:
                dev_r = round(max(dev_r - excess, 0.0), 6)
            elif disp_r >= xfer_r:
                disp_r = round(max(disp_r - excess, 0.0), 6)
            else:
                xfer_r = round(max(xfer_r - excess, 0.0), 6)
        host_r = round(max(wall_r - dev_r - disp_r - xfer_r, 0.0), 6)
        out = {
            "wall_s": wall_r,
            "device_time_s": dev_r,
            "dispatch_s": disp_r,
            "transfer_s": xfer_r,
            "host_s": host_r,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "dispatches": self.dispatches,
            "transfers": self.transfers,
            "last_op": self.last_op,
            "clamped": clamped,
        }
        if self.decodes:
            out["decode_s"] = round(self.decode_s, 6)
            out["decode_bytes"] = self.decode_bytes
            out["decodes"] = self.decodes
        if self.lane is not None:
            out["lane"] = self.lane
            out["devices"] = list(self.devices)
        if any(hbm_delta.values()):
            out["hbm_delta_bytes"] = hbm_delta
        return out


def _hbm_in_use() -> Dict[str, int]:
    """{device label: allocated bytes} for every card (empty on a CPU
    runtime)."""
    out: Dict[str, int] = {}
    for dev, stats in memory_by_device().items():
        in_use = stats.get("bytes_in_use")
        if in_use is not None:
            out[dev] = int(in_use)
    return out


def _drain_wall(stream=None) -> float:
    """Synchronize ``stream`` (default: the runtime card's current stream)
    and return the wall it took; 0.0 without a sync on a CPU runtime.  A
    CUDA error the sync surfaces propagates to the caller."""
    if stream is None:
        dev = _cuda_device()
        if dev is None:
            return 0.0
        import torch

        stream = torch.cuda.current_stream(dev)
    t0 = time.perf_counter()
    stream.synchronize()
    return time.perf_counter() - t0


def drain_stream(stream, book: bool = True) -> float:
    """The scheduler's end-of-attempt sync of ``stream``, timed: with
    ``book`` (and devprof on) its wall less the floor is this thread's
    node's device time.  Always syncs, whatever ``book`` says (the sync is
    the scheduler's, devprof only times it); errors propagate."""
    dt = _drain_wall(stream)
    frame = getattr(_TL, "frame", None)
    if book and frame is not None:
        frame.add_drain(dt)
    return dt


def reset() -> None:
    """Per-run reset (``workflow.main``): drop prior results and measure
    the drain floor on the runtime card's idle current stream."""
    global _PROBE_FLOOR
    with _LOCK:
        _RESULTS.clear()
        _ACTIVE.clear()
    _PROBE_FLOOR = 0.0
    if enabled() and _cuda_device() is not None:
        _drain_wall()  # waits out whatever the caller had queued
        _PROBE_FLOOR = min(_drain_wall() for _ in range(3))


@contextmanager
def node_bracket(name: str, drain: Optional[bool] = None,
                 lane: Optional[str] = None,
                 devices: Optional[list] = None):
    """Attribute one scheduler node; results land in :func:`results`.

    ``drain`` says whether the node's device time is booked.  A sync
    waits out everything queued on its stream, so the scheduler passes
    ``drain=False`` for nodes whose stream other nodes share while they
    run (the concurrent mode, unless ``ANOVOS_TPU_DEVPROF=full``); the
    scheduler books the drain itself (:func:`drain_stream`) inside each
    attempt.  ``None`` (direct callers) means drain: the bracket then
    syncs the current stream at its exit, unless something booked a
    drain already.  Exceptions of the wrapped work and of that sync
    propagate."""
    if not enabled():
        yield None
        return
    if drain is None:
        drain = True
    frame = _Frame(name, lane=lane, devices=devices)
    prev = getattr(_TL, "frame", None)
    _TL.frame = frame
    with _LOCK:
        _ACTIVE[name] = frame
    profile_ctx = None
    if os.environ.get("ANOVOS_PROFILE", ""):
        import torch

        # the profiler trace then puts this node's kernels under its name
        profile_ctx = torch.profiler.record_function(name)
        profile_ctx.__enter__()
    try:
        yield frame
        if drain and not frame.drained:
            frame.add_drain(_drain_wall())
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
        _TL.frame = prev
        try:
            out = frame.finish(drain=drain)
        except Exception:  # bookkeeping only: the node's own outcome stands
            logger.exception("devprof finish for node %r failed", name)
            out = None
        with _LOCK:
            _ACTIVE.pop(name, None)
            if out is not None:
                _RESULTS[name] = out
        if out is not None:
            _emit(name, out)


def _emit(name: str, out: dict) -> None:
    reg = get_metrics()
    for key, fam, help_ in (
        ("device_time_s", "devprof_device_seconds", "attributed device-queue drain per node"),
        ("dispatch_s", "devprof_dispatch_seconds", "host wall inside jitted-op calls per node"),
        ("transfer_s", "devprof_transfer_seconds", "host<->device materialization wall per node"),
        ("host_s", "devprof_host_seconds", "unattributed host wall per node"),
    ):
        reg.histogram(fam, help_).observe(out[key], node=name)
    from anovos_tpu_torch.obs.tracing import get_tracer

    get_tracer().instant(
        f"devprof:{name}", cat="devprof",
        device_time_s=out["device_time_s"], dispatch_s=out["dispatch_s"],
        transfer_s=out["transfer_s"], host_s=out["host_s"],
        h2d_bytes=out["h2d_bytes"], d2h_bytes=out["d2h_bytes"],
    )


@contextmanager
def dispatch_bracket(label: str, phase: str = "execute"):
    """Wrap one op call (entered by ``obs.timed``).

    Only the outermost bracket on a thread books dispatch wall, and only
    for ``execute``-phase calls; every bracket still stamps ``last_op``
    so a node's record names the op it was last in."""
    depth = getattr(_TL, "dispatch_depth", 0)
    _TL.dispatch_depth = depth + 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _TL.dispatch_depth = depth
        frame = getattr(_TL, "frame", None)
        if frame is not None:
            if depth == 0 and phase == "execute":
                frame.add_dispatch(dt, label)
            else:
                with frame._lock:
                    frame.last_op = label


def record_transfer(direction: str, nbytes: int, seconds: float,
                    label: str = "") -> None:
    """Book one host↔device movement (``direction`` ∈ {"h2d", "d2h",
    "d2d"}).  Quiet under ``ANOVOS_TPU_DEVPROF=0``, like every bracket."""
    if direction not in ("h2d", "d2h", "d2d"):
        raise ValueError(f"direction must be h2d|d2h|d2d, got {direction!r}")
    if not enabled():
        return
    get_metrics().counter(
        f"transfer_{direction}_bytes_total",
        "bytes moved %s at Table materialization/placement boundaries"
        % {"h2d": "host->device", "d2h": "device->host",
           "d2d": "device->device (placement re-lays)"}[direction],
    ).inc(nbytes)
    frame = getattr(_TL, "frame", None)
    if frame is None:
        # a writer-pool thread materialising a queued artifact belongs to
        # the node that submitted it, but only the global counters see it
        # (the per-node split stays a lower bound)
        return
    frame.add_transfer(direction, nbytes, seconds, label or direction)


@contextmanager
def transfer_bracket(direction: str, nbytes: int, label: str = ""):
    """Time and book one materialisation boundary.

    The wall is the host's: a pageable copy returns when its data has
    landed, while a ``non_blocking=True`` copy from pinned memory returns
    at enqueue, so its wall is the enqueue and the copy's own time falls
    to whatever later waits on it.  The bytes are exact either way.  No
    sync is added."""
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_transfer(direction, int(nbytes), time.perf_counter() - t0, label)


def record_decode(seconds: float, nbytes: int, label: str = "decode",
                  frame=None) -> None:
    """Book one part-file decode (wall and input bytes).

    ``frame`` lets prefetch-pool worker threads attribute their decode to
    the consuming node's frame (captured with :func:`current_frame` when
    the pool was made).  Quiet under ``ANOVOS_TPU_DEVPROF=0``."""
    if not enabled():
        return
    reg = get_metrics()
    reg.counter("stream_decode_seconds_total",
                "host wall spent decoding part files in streaming passes").inc(seconds)
    reg.counter("stream_decode_bytes_total",
                "part-file bytes decoded in streaming passes").inc(nbytes)
    fr = frame if frame is not None else getattr(_TL, "frame", None)
    if fr is not None:
        fr.add_decode(seconds, int(nbytes), label)


def current_frame():
    """The in-flight devprof frame of THIS thread (None outside a node
    bracket or with devprof disabled)."""
    return getattr(_TL, "frame", None)


def current_node() -> "Optional[str]":
    """Name of the scheduler node executing on THIS thread (None outside a
    node bracket, or when devprof is disabled)."""
    fr = getattr(_TL, "frame", None)
    return fr.name if fr is not None else None


def results() -> Dict[str, dict]:
    """Finished per-node attributions of the current run (name → dict)."""
    with _LOCK:
        return {k: dict(v) for k, v in sorted(_RESULTS.items())}


def active_frames() -> Dict[str, dict]:
    """In-flight nodes' live attribution."""
    with _LOCK:
        frames = dict(_ACTIVE)
    return {name: fr.snapshot() for name, fr in frames.items()}
