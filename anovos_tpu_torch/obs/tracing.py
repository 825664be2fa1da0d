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

Trace rotation (``TraceRotator``, ``ANOVOS_TPU_TRACE_ROTATE``) waits for
the live plane (ROADMAP.md Queue A item 3).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

logger = logging.getLogger("anovos_tpu_torch.obs.tracing")

__all__ = ["Span", "Tracer", "buffer_size", "get_tracer", "span", "trace_destination", "write_chrome_trace"]

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

            get_metrics().counter(
                "trace_spans_dropped_total",
                "spans evicted from the tracer ring at maxlen (raise "
                "ANOVOS_TPU_TRACE_BUFFER)",
            ).inc()
            if warn:
                logger.warning("tracer ring wrapped at maxlen=%d — older spans are being "
                               "dropped; raise ANOVOS_TPU_TRACE_BUFFER", self._spans.maxlen)

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
