"""``timed()`` — op-level wall-time wrapper that separates a signature's
first call from its steady-state calls (counterpart of
``anovos_tpu/obs/timed.py``).

``timed`` keeps a per-wrapper set of abstract call signatures it has
already seen and books each call's wall under ``op_compile_seconds`` (the
first call at a signature) or ``op_execute_seconds`` (a later one), with
an ``op_cache_hit_total`` counter of the later calls, under the JAX
package's metric names.  Eager torch compiles no program, so the
"compile" phase of a signature's first call holds first-use costs
instead: the hand kernels' build and load (``ops/kernels/build.py``), the
cuBLAS handle's set-up, the caching allocator's growth to the new shapes.

The signature key is *abstract*: tensors and arrays contribute (shape,
dtype), ints, bools and strings their value, floats their type, other
objects their type name, so a second call at the same shapes counts as a
steady-state call even with other data.  Key derivation never raises; an
unkeyable argument degrades to its type name.

CAVEAT — asynchronous launches: a CUDA kernel launch returns when the
kernel is queued, so on the card an ``execute``-phase wall is ENQUEUE
time, not device time; the device tail lands in whichever later host
fetch or stream sync waits on it (``obs.devprof`` books the node-end sync
as device time).  ``timed`` adds no synchronisation: a sync here would
serialise the overlap the concurrent executor's streams exist for.  The
walls that do measure work are ops that fetch to the host themselves
(``kmeans_elbow``, ``dbscan_fit``, ``describe_streaming``) and every call
on a CPU runtime.  For device time per kernel, run under
``ANOVOS_PROFILE=<dir>`` (``torch.profiler``).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Optional

from anovos_tpu_torch.obs import devprof
from anovos_tpu_torch.obs.metrics import get_metrics
from anovos_tpu_torch.obs.tracing import get_tracer

__all__ = ["timed"]


def _abstract(v, depth: int = 0):
    """Abstract signature of one argument (cheap, total)."""
    try:
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is not None and dtype is not None:
            return ("arr", tuple(shape), str(dtype))
        if isinstance(v, (bool, int)):
            # ints and bools are mostly sizes and flags (k, iters, nbins),
            # which pick a different first-use path for each value
            return ("static", type(v).__name__, v)
        if isinstance(v, float):
            return ("scalar", "float")
        if isinstance(v, (str, bytes)) or v is None:
            return v
        if isinstance(v, (tuple, list)) and depth < 3:
            return ("seq", tuple(_abstract(x, depth + 1) for x in v[:16]), len(v))
        if isinstance(v, dict) and depth < 3:
            return ("map", tuple(sorted(
                (str(k), _abstract(x, depth + 1)) for k, x in list(v.items())[:16])))
        return type(v).__name__
    except Exception:
        return type(v).__name__


def timed(name: Optional[str] = None):
    """Decorator: trace and meter calls to an op.

    Emits a span per call (cat ``op``, ``args.phase`` ∈ {``compile``,
    ``execute``}) and books wall time into the process metrics registry.
    ``name`` defaults to ``module.qualname`` minus the package prefix.
    """

    def deco(fn):
        label = name or f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"
        seen: set = set()
        lock = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                key = (tuple(_abstract(a) for a in args),
                       tuple(sorted((k, _abstract(v)) for k, v in kwargs.items())))
                hash(key)
            except TypeError:
                key = None  # unhashable exotic args: treat every call as first
            with lock:
                first = key is None or key not in seen
                if key is not None:
                    seen.add(key)
            phase = "compile" if first else "execute"
            reg = get_metrics()
            t0 = time.perf_counter()
            # the devprof bracket books execute-phase wall as this node's
            # dispatch time (outermost bracket only) and stamps last_op
            with get_tracer().span(label, cat="op", phase=phase), \
                    devprof.dispatch_bracket(label, phase=phase):
                out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            if first:
                reg.histogram("op_compile_seconds",
                              "first-call (trace+compile+execute) wall time"
                              ).observe(dt, op=label)
            else:
                reg.counter("op_cache_hit_total",
                            "op calls that replayed a cached executable").inc(op=label)
                reg.histogram("op_execute_seconds",
                              "steady-state op wall time").observe(dt, op=label)
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    return deco
