"""Thread-safe span tracing with Chrome-trace-format export (counterpart of
``anovos_tpu/obs/tracing.py``).

The concurrent executor makes "what did this run actually do" a parallel
question: which nodes overlapped, which worker lane ran what, and how long
a node sat queued behind its dependencies.  This module records nestable
spans from any thread at small cost (one ``perf_counter_ns`` pair and a
deque append under a lock) and exports them as Chrome-trace JSON loadable
in ``chrome://tracing`` or Perfetto (https://ui.perfetto.dev).

Always-on recording, gated export: spans accumulate in a bounded ring
(``ANOVOS_TPU_TRACE_BUFFER`` spans, default 200,000) whatever the
configuration; a trace FILE is written only when ``ANOVOS_TPU_TRACE`` is
set (``1`` → ``<run output>/obs/trace.json``, any other value → that
path).  Everything here is stdlib-only.

Span events use the Trace Event Format "complete" phase (``ph: "X"``) with
microsecond ``ts``/``dur``; worker threads appear as separate lanes via
``tid`` plus ``thread_name`` metadata events, so per-lane span sums can be
checked against the scheduler's reported wall time.  These are host
walls: kernels that a span's body enqueues on a CUDA stream may still run
after the span closes (``ANOVOS_PROFILE`` gives the device's own trace).

Trace rotation (``ANOVOS_TPU_TRACE_ROTATE``): a :class:`TraceRotator`
exports and clears the ring into numbered segments (``trace_0001.json``,
...) on wall time or span count, from a thread named
``anovos-torch-trace-rotator``.  ``Tracer.drain`` keeps the epoch, so the
segments share one timeline and their union equals one uninterrupted
export; a failed segment export puts its spans back (``requeue``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger("anovos_tpu_torch.obs.tracing")

__all__ = ["Span", "TraceRotator", "Tracer", "buffer_size", "get_tracer", "maybe_rotator", "rotation_spec", "span",
           "trace_destination", "write_chrome_trace"]

# the rotator's thread; never the JAX package's name (anovos-trace-rotator),
# so a process running both packages can tell them apart
ROTATOR_THREAD = "anovos-torch-trace-rotator"
_DROPPED_HELP = ("spans evicted from the tracer ring at maxlen (raise "
                 "ANOVOS_TPU_TRACE_BUFFER or enable ANOVOS_TPU_TRACE_ROTATE)")

# ring bound: ~200k spans is tens of MB of export, far beyond a
# configs_full run (hundreds of spans) but a hard cap for a long-lived
# caller of traced ops
_DEFAULT_BUFFER = 200_000


def buffer_size() -> int:
    """The ring bound ``ANOVOS_TPU_TRACE_BUFFER`` asks for (default
    200,000).  A malformed value warns and gives the default: the
    module-level tracer is built at import, which must not fail."""
    raw = os.environ.get("ANOVOS_TPU_TRACE_BUFFER", "")
    try:
        return int(raw) if raw else _DEFAULT_BUFFER
    except ValueError:
        import warnings

        warnings.warn(f"ANOVOS_TPU_TRACE_BUFFER={raw!r} is not an integer; "
                      f"using the default {_DEFAULT_BUFFER}")
        return _DEFAULT_BUFFER


class Span:
    """One finished span: wall-clock interval + attributes, immutable."""

    __slots__ = ("name", "cat", "start_ns", "dur_ns", "thread", "tid", "args")

    def __init__(self, name: str, cat: str, start_ns: int, dur_ns: int,
                 thread: str, tid: int, args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.thread = thread
        self.tid = tid
        self.args = args or {}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={self.dur_ns / 1e6:.3f}ms, thread={self.thread!r})")


class Tracer:
    """Collects spans from any thread; nesting is tracked per thread.

    ``span()`` is a context manager; the parent span's name is recorded in
    the child's ``args["parent"]`` via a thread-local stack, so exported
    traces keep their logical nesting even across identically-timed events.
    """

    def __init__(self, buffer: Optional[int] = None):
        if buffer is None:
            buffer = buffer_size()
        self._spans: "deque[Span]" = deque(maxlen=max(buffer, 1))
        self._dropped = 0
        self._warned_wrap = False
        self._lock = threading.Lock()
        self._local = threading.local()
        # chrome ts fields are offsets from this epoch; clear() re-bases
        self._epoch_ns = time.perf_counter_ns()

    # -- recording -------------------------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, cat: str = "anovos", **attrs):
        """Record ``name`` spanning the ``with`` body.  Exceptions propagate
        (the span still lands, flagged ``error``)."""
        stack = self._stack()
        if stack:
            attrs.setdefault("parent", stack[-1])
        stack.append(name)
        t0 = time.perf_counter_ns()
        try:
            yield self
        except BaseException as e:
            attrs["error"] = type(e).__name__
            raise
        finally:
            dur = time.perf_counter_ns() - t0
            stack.pop()
            th = threading.current_thread()
            self._record(Span(name, cat, t0 - self._epoch_ns, dur, th.name, th.ident or 0, attrs))

    def instant(self, name: str, cat: str = "anovos", **attrs) -> None:
        """A zero-duration marker event."""
        th = threading.current_thread()
        self._record(Span(name, cat, time.perf_counter_ns() - self._epoch_ns, 0,
                          th.name, th.ident or 0, attrs))

    def _record(self, sp: Span) -> None:
        dropped = warn = False
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
                dropped = True
                if not self._warned_wrap:
                    self._warned_wrap = warn = True
            self._spans.append(sp)
        if dropped:
            # ring overflow books every evicted span and warns once, so the
            # loss shows in the metrics instead of the trace silently
            # missing its start
            from anovos_tpu_torch.obs.metrics import get_metrics

            get_metrics().counter("trace_spans_dropped_total", _DROPPED_HELP).inc()
            if warn:
                logger.warning("tracer ring wrapped at maxlen=%d — older spans are being "
                               "dropped; raise ANOVOS_TPU_TRACE_BUFFER or set "
                               "ANOVOS_TPU_TRACE_ROTATE to export-and-clear segments", self._spans.maxlen)

    # -- reading / lifecycle --------------------------------------------
    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def span_count(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def maxlen(self) -> int:
        return self._spans.maxlen or 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self, buffer: Optional[int] = None) -> None:
        """Start a fresh timeline (``workflow.main`` calls this per run,
        with ``buffer`` the ring bound the run's environment asks for)."""
        with self._lock:
            if buffer is not None:
                self._spans = deque(maxlen=max(int(buffer), 1))
            self._spans.clear()
            self._dropped = 0
            self._warned_wrap = False
            self._epoch_ns = time.perf_counter_ns()

    def drain(self) -> List[Span]:
        """Copy and clear the ring in one step WITHOUT re-basing the epoch:
        rotation's primitive, so successive drains partition one timeline."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def requeue(self, spans: List[Span]) -> None:
        """Put drained spans back at the FRONT of the ring (a failed segment
        export must not lose them).  What passes the bound falls off the
        old end and is booked as dropped, as the ring itself would."""
        with self._lock:
            merged = list(spans) + list(self._spans)
            self._spans.clear()
            bound = self._spans.maxlen or len(merged)
            overflow = len(merged) - bound
            if overflow > 0:
                self._dropped += overflow
            self._spans.extend(merged[-bound:])
        if overflow > 0:
            from anovos_tpu_torch.obs.metrics import get_metrics

            get_metrics().counter("trace_spans_dropped_total", _DROPPED_HELP).inc(overflow)

    # -- export ----------------------------------------------------------
    def to_chrome(self, spans: Optional[Iterable[Span]] = None) -> dict:
        """Trace Event Format document (the ``chrome://tracing`` schema)."""
        if spans is None:
            spans = self.snapshot()
        pid = os.getpid()
        events: List[dict] = []
        seen_tids: Dict[int, str] = {}
        for sp in spans:
            if sp.tid not in seen_tids:
                seen_tids[sp.tid] = sp.thread
            ev = {
                "name": sp.name,
                "cat": sp.cat,
                "ph": "X" if sp.dur_ns else "i",
                "ts": sp.start_ns / 1e3,   # microseconds
                "pid": pid,
                "tid": sp.tid,
            }
            if sp.dur_ns:
                ev["dur"] = sp.dur_ns / 1e3
            else:
                ev["s"] = "t"  # instant scope: thread
            if sp.args:
                ev["args"] = {k: _jsonable(v) for k, v in sp.args.items()}
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": tname}}
                for tid, tname in sorted(seen_tids.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str, spans: Optional[Iterable[Span]] = None) -> str:
        """Write the Chrome-trace JSON; returns the path written."""
        doc = self.to_chrome(spans)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer (scheduler, writer, ops and I/O share it)."""
    return _TRACER


def span(name: str, cat: str = "anovos", **attrs):
    """Shortcut: a span on the process-wide tracer."""
    return _TRACER.span(name, cat=cat, **attrs)


def trace_destination(default_dir: str = ".") -> Optional[str]:
    """Resolve ``ANOVOS_TPU_TRACE`` to an export path, or None when unset.

    ``1``/``true`` → ``<default_dir>/obs/trace.json``; any other non-empty
    value is used verbatim as the path.
    """
    val = os.environ.get("ANOVOS_TPU_TRACE", "")
    if not val or val.lower() in ("0", "false"):
        return None
    if val.lower() in ("1", "true"):
        return os.path.join(default_dir, "obs", "trace.json")
    return val


def write_chrome_trace(path: str) -> str:
    """Export the process-wide tracer's ring to ``path``."""
    return _TRACER.export(path)


# ---------------------------------------------------------------------------
# trace segment rotation (ANOVOS_TPU_TRACE_ROTATE)
# ---------------------------------------------------------------------------

def rotation_spec() -> Optional[Tuple[str, float]]:
    """``ANOVOS_TPU_TRACE_ROTATE`` parsed to ``("secs", s)`` or
    ``("spans", n)``, or None when off.  A value with an ``s`` suffix
    rotates on wall time (``"30s"``, ``"1.5s"``), a bare integer when the
    ring holds that many spans; ``0``, unset or garbage is off (garbage
    warns)."""
    raw = os.environ.get("ANOVOS_TPU_TRACE_ROTATE", "").strip().lower()
    if not raw or raw in ("0", "false", "off"):
        return None
    try:
        if raw.endswith("s") and raw[:-1]:
            secs = float(raw[:-1])
            return ("secs", secs) if secs > 0 else None
        n = int(raw)
        return ("spans", float(n)) if n > 0 else None
    except ValueError:
        logger.warning("ANOVOS_TPU_TRACE_ROTATE=%r is neither '<secs>s' nor "
                       "a span count; rotation off", raw)
        return None


class TraceRotator:
    """Periodic export-and-clear of the tracer ring into numbered
    Chrome-trace segments next to ``dest`` (``trace.json`` →
    ``trace_0001.json``, ...), so a long service run keeps a complete trace
    bounded on disk.  With ``submit`` (the run's ``AsyncArtifactWriter``)
    the segment writes ride the async queue under one key; otherwise they
    are written on the rotator's own thread.  :meth:`close` stops and
    joins the thread and flushes the last segment."""

    def __init__(self, dest: str, tracer: Optional[Tracer] = None,
                 spec: Optional[Tuple[str, float]] = None, submit=None):
        self.dest = dest
        self.tracer = tracer or get_tracer()
        self.spec = spec if spec is not None else rotation_spec()
        self.submit = submit
        self.segments: List[str] = []
        self._n = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last = time.monotonic()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self.spec is not None

    def segment_path(self, n: int) -> str:
        base = self.dest[:-5] if self.dest.endswith(".json") else self.dest
        return f"{base}_{n:04d}.json"

    def start(self) -> "TraceRotator":
        if not self.active or self._thread is not None:
            return self
        kind, val = self.spec
        poll = min(1.0, val / 4.0) if kind == "secs" else 0.25
        self._thread = threading.Thread(target=self._loop, args=(max(poll, 0.05),),
                                        name=ROTATOR_THREAD, daemon=True)
        self._thread.start()
        return self

    def _loop(self, poll: float) -> None:
        while not self._stop.wait(poll):
            try:
                self.maybe_rotate()
            except Exception:
                logger.exception("trace segment export failed; spans requeued into the ring, "
                                 "retrying next period")

    def _due(self) -> bool:
        kind, val = self.spec
        if kind == "secs":
            return time.monotonic() - self._last >= val
        return self.tracer.span_count() >= val

    def maybe_rotate(self, force: bool = False) -> Optional[str]:
        """Export and clear one segment when due (or ``force``); returns its
        path, or None when nothing rotated.  A failed direct export
        requeues the drained spans and records no segment."""
        if not self.active:
            return None
        with self._lock:
            if not force and not self._due():
                return None
            self._last = time.monotonic()
            spans = self.tracer.drain()
            if not spans:
                return None
            self._n += 1
            path = self.segment_path(self._n)
        if self.submit is not None:
            # one writer key for every segment: a key per segment would add
            # an artifact_writes_total series per rotation
            self.submit("obs:trace_seg", self.tracer.export, path, spans)
        else:
            try:
                self.tracer.export(path, spans)
            except Exception:
                with self._lock:
                    self._n -= 1
                self.tracer.requeue(spans)
                raise
        with self._lock:
            self.segments.append(path)
        return path

    def close(self) -> List[str]:
        """Stop and join the thread, flush the final segment; returns every
        segment path written.  Idempotent."""
        if not self.active:
            return []
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
        self.maybe_rotate(force=True)
        return list(self.segments)


def maybe_rotator(default_dir: str, submit=None, tracer: Optional[Tracer] = None) -> Optional[TraceRotator]:
    """A started :class:`TraceRotator` when ``ANOVOS_TPU_TRACE_ROTATE`` is
    set, else None (no thread).  Rotation implies export: the segments
    take their names from ``ANOVOS_TPU_TRACE``'s path when it is set, else
    from ``<default_dir>/obs/trace.json``."""
    spec = rotation_spec()
    if spec is None:
        return None
    dest = trace_destination(default_dir) or os.path.join(default_dir, "obs", "trace.json")
    return TraceRotator(dest, tracer=tracer, spec=spec, submit=submit).start()
