"""The online feature server: a micro-batching request loop over a bundle
(counterpart of ``anovos_tpu/serving/server.py``).

Request lifecycle:

1. **validate and coerce** (client thread, before anything is enqueued):
   the payload must carry exactly the bundle's required input columns
   with equal-length value lists; numeric columns accept numbers or null,
   categorical columns strings or null, timestamps ISO strings.  Schema
   drift (unknown or missing columns), wrong dtypes, and hostile values
   (±inf and finite floats beyond the f32 range, the ingest guard's
   overflow class, applied at the request boundary) all return a
   STRUCTURED per-request error (a "quarantine response") at once: a
   hostile request can neither poison a shared micro-batch nor crash the
   server, and every refusal books
   ``serve_requests_quarantined_total{reason}``.
2. **micro-batch**: accepted requests queue; the batcher thread drains up
   to ``ANOVOS_SERVE_MAX_BATCH`` rows or ``ANOVOS_SERVE_BATCH_WINDOW_MS``
   of accumulation, concatenates the frames and pads the batch onto the
   row buckets (``ApplyProgram.pad_frame``) that the warm-up drove.
3. **apply**: one pass through the bundle's transformer chain, in a
   tracer span and a ``devprof.node_bracket`` (the chaos site
   ``serve:apply`` sits inside the bracket for the ``serve-fault``
   scenario).  A failed apply retries once, so an injected transient does
   not fail real requests; a second failure is FATAL for the batch: a
   flight-recorder postmortem (trigger ``serve_fatal``) is written
   synchronously, every request in the batch gets a structured error, and
   the loop goes on serving later batches.
4. **respond**: each request's row slice goes back as a JSON-able
   columnar payload; its wall books into ``serve_request_seconds``, the
   rolling windows of the live plane and the bounded latency ring that
   ``stats()`` summarizes as p50/p99/QPS.

:meth:`FeatureServer.close` undoes everything :meth:`~FeatureServer.start`
set up in the process: it joins the batcher thread
(``anovos-torch-serve-batcher``) to its end, closes the trace rotator,
releases the live plane, puts back the ``serving`` provider that was
registered before, and disarms the flight recorder if ``start`` armed it.
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from anovos_tpu_torch.obs.telemetry import RollingWindow
from anovos_tpu_torch.serving.program import ApplyProgram

logger = logging.getLogger("anovos_tpu_torch.serving.server")

__all__ = ["FeatureServer", "coerce_payload", "frame_to_payload"]

# the batcher's thread; never the JAX package's name (anovos-serve-batcher)
BATCHER_THREAD = "anovos-torch-serve-batcher"
PROVIDER = "serving"

# the device numeric plane is f32 (data_ingest.guard's sanitize contract):
# any finite float beyond this becomes ±inf on upload
_F32_MAX = float(np.finfo(np.float32).max)
_LATENCY_RING = 8192


def _error(code: str, detail: str, **extra) -> dict:
    return {"error": {"code": code, "detail": detail, **extra}}


def coerce_payload(input_columns: List[dict], payload: dict,
                   max_rows: int) -> Tuple[Optional[pd.DataFrame], Optional[dict]]:
    """Validate one request payload against the bundle schema and coerce
    it to the canonical frame dtypes (numeric → float64, cat → object str,
    ts → datetime64).  Returns ``(frame, None)`` or ``(None, error)``: the
    error dict IS the response (a per-request quarantine)."""
    if not isinstance(payload, dict) or not isinstance(payload.get("columns"), dict):
        return None, _error("bad_request", 'payload must be {"columns": {name: [values...]}}')
    cols = payload["columns"]
    schema = {c["name"]: c for c in input_columns}
    unknown = sorted(set(cols) - set(schema))
    missing = sorted(set(schema) - set(cols))
    if unknown or missing:
        return None, _error("schema_drift", "request columns do not match the bundle schema",
                            unknown_columns=unknown, missing_columns=missing)
    if any(not isinstance(v, (list, tuple)) for v in cols.values()):
        return None, _error("bad_request", "column values must be lists")
    lengths = {len(v) for v in cols.values()}
    if len(lengths) != 1:
        return None, _error("bad_shape", f"column lengths disagree: {sorted(lengths)}")
    n = lengths.pop()
    if not (1 <= n <= max_rows):
        return None, _error("bad_shape", f"rows must be 1..{max_rows}, got {n}")
    data: Dict[str, object] = {}
    hostile: Dict[str, dict] = {}
    for name in (c["name"] for c in input_columns):
        kind = schema[name]["kind"]
        vals = cols[name]
        if kind in ("cat", "ts"):
            # ISO strings or null only for a timestamp: pd.to_datetime would
            # otherwise read bare numbers as epoch-nanosecond instants
            bad = [v for v in vals if v is not None and not isinstance(v, str)]
            if bad:
                what = ("categorical: values must be strings" if kind == "cat"
                        else "a timestamp: values must be ISO strings")
                return None, _error("wrong_dtype", f"column {name!r} is {what} or null "
                                    f"(got e.g. {bad[0]!r})", column=name)
            if kind == "cat":
                data[name] = np.array(list(vals), dtype=object)
                continue
            try:
                data[name] = pd.to_datetime(pd.Series(vals), errors="raise", utc=False).to_numpy()
            except Exception as e:
                return None, _error("wrong_dtype", f"column {name!r} is a timestamp: {e}", column=name)
            continue
        bad = [v for v in vals
               if v is not None and not (isinstance(v, (int, float)) and not isinstance(v, bool))]
        if bad:
            return None, _error("wrong_dtype", f"column {name!r} is numeric: values must be numbers "
                                f"or null (got e.g. {bad[0]!r})", column=name)
        arr = np.array([np.nan if v is None else float(v) for v in vals], dtype=np.float64)
        pos = int((arr == np.inf).sum())
        neg = int((arr == -np.inf).sum())
        over = int((np.isfinite(arr) & (np.abs(arr) > _F32_MAX)).sum())
        if pos or neg or over:
            hostile[name] = {"posinf": pos, "neginf": neg, "overflow": over}
        data[name] = arr
    if hostile:
        # a value the decode guard would null or clip in batch ingest is a
        # per-request refusal here: the caller is told what was hostile and
        # the batch queue never sees the rows
        return None, _error("hostile_values",
                            "±inf / f32-overflow values refused at the request boundary "
                            "(data_ingest.guard sanitize policy)", columns=hostile)
    return pd.DataFrame(data), None


def frame_to_payload(df: pd.DataFrame) -> Dict[str, list]:
    """Feature frame → JSON-able columnar payload (NaN/NaT → null).  Gives
    the JAX package's payload for numpy and object columns, and takes
    pandas' string dtype (the default for text from pandas 3 on) too."""
    out: Dict[str, list] = {}
    for name in df.columns:
        s = df[name]
        dt = s.dtype
        if pd.api.types.is_datetime64_any_dtype(dt):
            out[name] = [None if pd.isna(v) else pd.Timestamp(v).isoformat() for v in s]
        elif dt == object:
            out[name] = [None if v is None or (isinstance(v, float) and math.isnan(v)) else str(v)
                         for v in s]
        elif isinstance(dt, pd.StringDtype):
            out[name] = [None if pd.isna(v) else str(v) for v in s]
        elif isinstance(dt, np.dtype) and np.issubdtype(dt, np.integer):
            out[name] = [int(v) for v in s]
        else:
            out[name] = [None if pd.isna(v) or not np.isfinite(v) else float(v) for v in s]
    return out


class _Pending:
    __slots__ = ("frame", "rows", "event", "response", "t0", "booked")

    def __init__(self, frame: pd.DataFrame, t0: float):
        self.frame = frame
        self.rows = len(frame)
        self.event = threading.Event()
        self.response: Optional[dict] = None
        self.t0 = t0
        # one request, one SLO sample: whichever side (the client's timeout
        # or the batcher's completion) claims this flag FIRST, under the
        # server lock, books the request; the other side must not
        self.booked = False


class FeatureServer:
    """Threaded micro-batching server over one :class:`ApplyProgram`.

    In-process transport: clients call :meth:`serve` from their own
    threads (the CLI, ``chip_smoke.py`` and the serve-fault scenario all
    drive it this way); the batching and apply loop runs on one background
    thread, so the card's work stays on one lane and devprof's drain
    attribution means something."""

    def __init__(self, program: ApplyProgram, window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None, obs_dir: Optional[str] = None):
        self.program = program
        self.window_s = float(window_ms if window_ms is not None
                              else os.environ.get("ANOVOS_SERVE_BATCH_WINDOW_MS", "5")) / 1000.0
        self.max_batch = int(max_batch if max_batch is not None
                             else os.environ.get("ANOVOS_SERVE_MAX_BATCH", "256"))
        self.obs_dir = obs_dir
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._carry: Optional[_Pending] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._latencies = deque(maxlen=_LATENCY_RING)
        self._lock = threading.Lock()
        self._served = 0
        self._quarantined = 0
        self._failed = 0
        self._t_started: Optional[float] = None
        self.cold_start_s: Optional[float] = None
        # the live plane: rolling SLO windows over the request stream, the
        # in-flight batch /statusz reads, and the last fatal /healthz names
        self.rolling = RollingWindow()
        self._inflight_batch: Optional[dict] = None
        self._last_fatal: Optional[dict] = None
        self._telemetry = None
        self._rotator = None
        # what start() changed in the process, for close() to undo
        self._armed_flight = False
        self._provider_before: Optional[dict] = None
        self._provider_set = False

    # -- lifecycle ------------------------------------------------------------
    def start(self, warm: bool = True) -> "FeatureServer":
        """Arm obs, drive the apply path once a row bucket, start the loop.

        ``cold_start_s`` is the measured server-start wall: the warm-up
        through the first live response.  A start that fails undoes what
        it set up before it raises."""
        t0 = time.perf_counter()
        try:
            self._start(warm)
        except BaseException:
            self.close()
            raise
        self.cold_start_s = round(time.perf_counter() - t0, 3)
        return self

    def _start(self, warm: bool) -> None:
        from anovos_tpu_torch.obs import flight, telemetry
        from anovos_tpu_torch.obs.tracing import maybe_rotator

        if self.obs_dir and not flight.enabled():
            flight.configure(os.path.join(self.obs_dir, "obs"))
            self._armed_flight = flight.enabled()
        # the live plane: join or start the listener (ANOVOS_TPU_TELEMETRY;
        # off gives None and no thread) and register the serving provider
        # either way, so a listener another component owns scrapes it too
        self._telemetry = telemetry.acquire(context="serving")
        self._provider_before = telemetry._providers().get(PROVIDER)
        telemetry.register_provider(PROVIDER, statusz=self._statusz_fragment,
                                    metrics=self._telemetry_gauges, health=self._health_fragment)
        self._provider_set = True
        # trace segment rotation (off by default): a long-lived server's
        # apply spans rotate to disk instead of aging out of the ring
        if self.obs_dir:
            self._rotator = maybe_rotator(self.obs_dir)
        if warm:
            self.program.warm(self.max_batch)
        self._stop.clear()
        self._t_started = time.monotonic()
        self._thread = threading.Thread(target=self._loop, name=BATCHER_THREAD, daemon=True)
        self._thread.start()
        if warm:
            # the cold-start contract is start → FIRST RESPONSE: one live
            # request through the whole queue/batch/apply/serialize path
            first = self.serve({"columns": frame_to_payload(self.program.synthetic_frame(1))})
            if "error" in first:
                raise RuntimeError(f"serving warm probe failed: {first['error']}")

    def close(self) -> None:
        """Stop the loop once the queue is drained and undo what
        :meth:`start` set up in the process.  Safe to call twice."""
        from anovos_tpu_torch.obs import flight, telemetry

        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._rotator is not None:
            self._rotator.close()
            self._rotator = None
        telemetry.release(self._telemetry)
        self._telemetry = None
        if self._provider_set:
            if self._provider_before is not None:
                telemetry.register_provider(PROVIDER, **self._provider_before)
            else:
                telemetry.unregister_provider(PROVIDER)
            self._provider_set, self._provider_before = False, None
        if self._armed_flight:
            flight.reset()
            self._armed_flight = False

    # -- client API -----------------------------------------------------------
    def serve(self, payload: dict, timeout_s: float = 120.0) -> dict:
        """One blocking request: validate, enqueue, await the batch."""
        from anovos_tpu_torch.obs import get_metrics

        t0 = time.perf_counter()
        frame, err = coerce_payload(self.program.input_columns, payload, self.max_batch)
        if err is not None:
            with self._lock:
                self._quarantined += 1
            get_metrics().counter(
                "serve_requests_quarantined_total",
                "requests refused at the serving boundary with a structured per-request error",
            ).inc(reason=err["error"]["code"])
            return err
        pending = _Pending(frame, t0)
        self._queue.put(pending)
        if pending.event.wait(timeout_s):
            return pending.response  # type: ignore[return-value]
        # a timeout is a client-visible FAILURE: it burns error budget in the
        # rolling windows and counts toward the latency tail, or a wedged
        # apply that times every request out would scrape as a healthy
        # server
        if self._book(pending, time.perf_counter() - t0, ok=False):
            get_metrics().counter("serve_requests_timeout_total",
                                  "requests that timed out awaiting their batch").inc()
            return _error("timeout", f"no response within {timeout_s}s")
        # the batch finished in the same instant: its response is valid
        pending.event.wait(5.0)
        if pending.response is not None:
            return pending.response
        return _error("timeout", f"no response within {timeout_s}s")

    # -- batching loop --------------------------------------------------------
    def _next_batch(self) -> List[_Pending]:
        batch: List[_Pending] = []
        rows = 0
        if self._carry is not None:
            batch.append(self._carry)
            rows = self._carry.rows
            self._carry = None
        while not batch:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return []
                continue
            batch.append(first)
            rows = first.rows
        deadline = time.monotonic() + self.window_s
        while rows < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if rows + nxt.rows > self.max_batch:
                self._carry = nxt  # heads the next batch, never dropped
                break
            batch.append(nxt)
            rows += nxt.rows
        return batch

    def _loop(self) -> None:
        while not (self._stop.is_set() and self._queue.empty() and self._carry is None):
            batch = self._next_batch()
            if not batch:
                if self._stop.is_set():
                    return
                continue
            try:
                self._process(batch)
            except Exception:  # the loop must outlive any batch
                logger.exception("serving batch processing failed")
                for p in batch:
                    if p.response is None:
                        p.response = _error("internal", "batch processing failed")
                        p.event.set()

    def _book(self, p: _Pending, latency: float, ok: bool) -> bool:
        """One SLO sample for ``p``, unless the other side (the client's
        timeout or the batcher) booked it first; the claim is decided under
        the lock.  Returns whether this call booked it."""
        from anovos_tpu_torch.obs import get_metrics

        with self._lock:
            claimed = not p.booked
            p.booked = True
            if claimed:
                if ok:
                    self._served += 1
                self._latencies.append(latency)
        if claimed:
            self.rolling.observe(latency, ok=ok)
            get_metrics().histogram("serve_request_seconds",
                                    "request wall from validation to response").observe(latency)
        return claimed

    def _process(self, batch: List[_Pending]) -> None:
        from anovos_tpu_torch.obs import devprof, flight, get_metrics, get_tracer
        from anovos_tpu_torch.resilience.chaos import chaos_point

        reg = get_metrics()
        frames = [p.frame for p in batch]
        n = sum(p.rows for p in batch)
        big = pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]
        bucket = self.program.bucket_rows(n, self.max_batch)
        padded = self.program.pad_frame(big, bucket)
        with self._lock:
            self._inflight_batch = {"rows": n, "requests": len(batch), "bucket": bucket,
                                    "since_unix": round(time.time(), 3)}
        out: Optional[pd.DataFrame] = None
        last: Optional[BaseException] = None
        try:
            for attempt in (1, 2):
                try:
                    with get_tracer().span("serving/apply", cat="serve", rows=n, bucket=bucket,
                                           requests=len(batch), attempt=attempt), \
                            devprof.node_bracket("serving/apply"):
                        chaos_point("serve:apply")
                        out = self.program.apply_frame(padded)
                    break
                except Exception as e:
                    last = e
                    logger.warning("serving apply attempt %d failed (%s: %s): %s", attempt,
                                   type(e).__name__, e, "retrying" if attempt == 1 else "batch is fatal")
        finally:
            with self._lock:
                self._inflight_batch = None
        reg.counter("serve_batches_total", "micro-batches dispatched through the apply program").inc()
        reg.histogram("serve_batch_rows", "rows per dispatched micro-batch",
                      buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)).observe(n)
        if out is None:
            # FATAL for this batch: the postmortem first (synchronous,
            # crash-safe), then structured errors; the server goes on
            err = f"{type(last).__name__}: {str(last)[:300]}"
            with self._lock:
                self._failed += 1
                # /healthz names the failed batch from now on: a fatal apply
                # is a degraded serving plane even after the loop moves on
                self._last_fatal = {"rows": n, "requests": len(batch), "error": err,
                                    "t_unix": round(time.time(), 3)}
            reg.counter("serve_batches_failed_total",
                        "micro-batches whose apply failed after retry (every request got a "
                        "structured error; a flight postmortem was written)").inc()
            flight.dump("serve_fatal", node="serving/apply",
                        extra={"error": f"{type(last).__name__}: {last}", "batch_rows": n,
                               "requests": len(batch)})
            now = time.perf_counter()
            for p in batch:
                p.response = _error("apply_failed", f"feature apply failed after retry: {err}")
                # failed requests count toward the latency tail, which the
                # serve-fault scenario's bounded-p99 gate reads
                self._book(p, now - p.t0, ok=False)
                p.event.set()
            return
        offset = 0
        now = time.perf_counter()
        for p in batch:
            part = out.iloc[offset:offset + p.rows].reset_index(drop=True)
            offset += p.rows
            p.response = {"rows": p.rows, "columns": frame_to_payload(part)}
            self._book(p, now - p.t0, ok=True)
            p.event.set()

    # -- live plane provider callbacks (obs.telemetry; the scrape thread) ----
    def _statusz_fragment(self) -> dict:
        """The serving section of ``/statusz``: the stats, the rolling
        windows, the in-flight batch and the last fatal."""
        with self._lock:
            inflight = dict(self._inflight_batch) if self._inflight_batch else None
            last_fatal = dict(self._last_fatal) if self._last_fatal else None
        return {**self.stats(), "rolling": self.rolling.summary(), "inflight_batch": inflight,
                "last_fatal": last_fatal, "queue_depth": self._queue.qsize()}

    def _telemetry_gauges(self, reg) -> None:
        """The ``/metrics`` serving families, set at scrape time: rolling
        p50/p99/QPS/error-budget burn and the queue depth."""
        for window, s in self.rolling.summary().items():
            # an EMPTY window removes its latency series rather than leaving
            # the last burst's p99 scraping as fresh for hours
            if s["p50_ms"] is not None:
                reg.gauge("serve_rolling_p50_ms", "rolling-window p50 request latency"
                          ).set(s["p50_ms"], window=window)
                reg.gauge("serve_rolling_p99_ms", "rolling-window p99 request latency"
                          ).set(s["p99_ms"], window=window)
            else:
                for fam in ("serve_rolling_p50_ms", "serve_rolling_p99_ms"):
                    inst = reg.peek(fam)  # never create a family on cleanup
                    if inst is not None:
                        inst.remove(window=window)
            reg.gauge("serve_rolling_qps", "rolling-window sustained requests per second"
                      ).set(s["qps"], window=window)
            reg.gauge("serve_rolling_error_budget_burn",
                      "rolling-window error rate over the SLO error budget (1.0 = burning exactly "
                      "at budget)").set(s["error_budget_burn"], window=window)
        reg.gauge("serve_queue_depth", "requests accepted but not yet batched"
                  ).set(float(self._queue.qsize()))

    def _health_fragment(self):
        """The ``/healthz`` fold: a fatal micro-batch degrades the serving
        plane, with the batch named in the reason."""
        with self._lock:
            lf = dict(self._last_fatal) if self._last_fatal else None
        if lf is None:
            return ("ok", [])
        return ("degraded", [f"serving: micro-batch of {lf['rows']} row(s) ({lf['requests']} "
                             f"request(s)) failed after retry: {lf['error']}"])

    # -- stats ----------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            served, quarantined, failed = self._served, self._quarantined, self._failed
        elapsed = (time.monotonic() - self._t_started) if self._t_started else 0.0
        pct = RollingWindow._pct
        return {
            "served": served,
            "quarantined": quarantined,
            "failed_batches": failed,
            "p50_ms": pct(lat, 0.50),
            "p99_ms": pct(lat, 0.99),
            "qps": round(served / elapsed, 2) if elapsed > 0 else None,
            "cold_start_s": self.cold_start_s,
            "window_ms": self.window_s * 1000,
            "max_batch": self.max_batch,
        }
