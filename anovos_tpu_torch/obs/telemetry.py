"""The live telemetry plane (counterpart of ``anovos_tpu/obs/telemetry.py``):
an embedded, pull-based, read-only HTTP endpoint for long runs and
services, off by default.

* ``/metrics``: the Prometheus text of the process-wide
  :class:`~anovos_tpu_torch.obs.metrics.MetricsRegistry`, after the live
  families are set at scrape time: each card's memory, heartbeat ages, the
  scheduler's in-flight nodes and ready-queue depth, and whatever a
  registered provider sets.
* ``/healthz``: ``ok | degraded | unhealthy`` with reasons, folded from
  the degradation registry, the ingest guard's quarantine, the chaos
  wedge flag, heartbeat staleness and the providers' fragments (HTTP 200,
  or 503 when unhealthy).
* ``/statusz``: :func:`anovos_tpu_torch.obs.flight.build_snapshot` served
  on demand, the same document a postmortem dump freezes.

``ANOVOS_TPU_TELEMETRY=<port>`` turns it on; ``0``, unset or garbage is
off, and off starts no thread and opens no socket.  The listener binds
127.0.0.1 only, keeps connections alive (HTTP/1.1, ``TCP_NODELAY``), and
runs on a thread named ``anovos-torch-telemetry`` with one
``anovos-torch-telemetry-conn`` thread a connection; never the JAX
package's thread names.  The last :func:`release` stops it, closes every
open connection and joins every thread it started.  A bind conflict warns
once, books ``telemetry_bind_failures_total`` and lets the run go on.

Components plug in through :func:`register_provider` (``statusz``,
``metrics`` and ``health`` callbacks, called on the scrape thread outside
the components' locks), :func:`beat` (service heartbeats, which
``/healthz`` folds) and :class:`RollingWindow` (sliding-window latency and
error accounting, with error-budget burn against
``ANOVOS_TPU_SLO_ERROR_BUDGET``).  The knobs are telemetry only, so none
is on the node cache's ``KNOWN_ENV_KNOBS``.

:data:`UNPORTED_KNOBS` lists every knob the JAX runner or scheduler reads
whose layer the port still lacks, with the ROADMAP.md Queue A item that
ports it, and :func:`check_unported_knobs` raises where a user sets one
(``workflow.run`` and ``main`` check them all) instead of ignoring it.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger("anovos_tpu_torch.obs.telemetry")

__all__ = ["RollingWindow", "TelemetryServer", "acquire", "beat", "check_unported_knobs",
           "clear_heartbeat", "current", "error_budget", "health", "heartbeat_ages",
           "refresh_heartbeat", "register_provider", "release", "render_metrics", "statusz_doc",
           "telemetry_port", "unregister_provider"]

# the plane's threads; never the JAX package's names (anovos-telemetry)
SERVER_THREAD = "anovos-torch-telemetry"
CONN_THREAD = "anovos-torch-telemetry-conn"

# knobs of layers the port does not have yet: what each asks for and the
# ROADMAP.md Queue A item, by its name, that ports it
UNPORTED_KNOBS = {
    "ANOVOS_TPU_PLACEMENT": ("multi-device placement", "multi-device"),
}

_DEFAULT_WINDOWS = (60.0, 300.0)
_WINDOW_RING = 65536           # samples kept a rolling window
_DEFAULT_ERROR_BUDGET = 0.01   # the SLO's error budget, for the burn rate

_LOCK = threading.Lock()
_START_LOCK = threading.Lock()  # serializes listener creation and stop
_PROVIDERS: Dict[str, Dict[str, Callable]] = {}
_HEARTBEATS: Dict[str, dict] = {}
_SERVER: "Optional[TelemetryServer]" = None
_REFS = 0


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
                f"see ROADMAP.md Queue A, {item}")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def telemetry_port() -> Optional[int]:
    """``ANOVOS_TPU_TELEMETRY`` as a port, or None when off (``0``, unset,
    or a malformed or out-of-range value, which warns)."""
    raw = os.environ.get("ANOVOS_TPU_TELEMETRY", "").strip()
    if not raw or raw in ("0", "false", "off"):
        return None
    try:
        port = int(raw)
    except ValueError:
        logger.warning("ANOVOS_TPU_TELEMETRY=%r is not a port; telemetry off", raw)
        return None
    if not (0 < port < 65536):
        logger.warning("ANOVOS_TPU_TELEMETRY=%r out of range; telemetry off", raw)
        return None
    return port


def error_budget() -> float:
    """``ANOVOS_TPU_SLO_ERROR_BUDGET``, the share of requests allowed to
    fail (default 1%); a malformed or out-of-range value warns and gives
    the default."""
    raw = os.environ.get("ANOVOS_TPU_SLO_ERROR_BUDGET", "")
    if raw:
        try:
            v = float(raw)
        except ValueError:
            logger.warning("ANOVOS_TPU_SLO_ERROR_BUDGET=%r invalid; using %s", raw, _DEFAULT_ERROR_BUDGET)
        else:
            if 0 < v <= 1:
                return v
            logger.warning("ANOVOS_TPU_SLO_ERROR_BUDGET=%r out of range (0, 1]; using %s",
                           raw, _DEFAULT_ERROR_BUDGET)
    return _DEFAULT_ERROR_BUDGET


# ---------------------------------------------------------------------------
# providers and heartbeats
# ---------------------------------------------------------------------------

def register_provider(name: str, statusz: Optional[Callable] = None,
                      metrics: Optional[Callable] = None, health: Optional[Callable] = None) -> None:
    """Register a component's live callbacks (the latest registration
    wins): ``statusz()`` a JSON-able dict, ``metrics(reg)`` sets gauges at
    scrape time, ``health()`` gives ``(status, [reasons])``.  One dict
    insert, no thread."""
    entry = {k: v for k, v in (("statusz", statusz), ("metrics", metrics), ("health", health))
             if v is not None}
    with _LOCK:
        _PROVIDERS[name] = entry


def unregister_provider(name: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(name, None)


def _providers() -> Dict[str, Dict[str, Callable]]:
    with _LOCK:
        return dict(_PROVIDERS)


def beat(name: str, interval_s: float = 30.0, stale_after_s: Optional[float] = None) -> None:
    """Record a service heartbeat.  ``/healthz`` reports it degraded past
    ``stale_after_s`` (default 3× the interval, at least 1 s) and
    unhealthy past 3× that."""
    stale = float(stale_after_s if stale_after_s is not None else max(3.0 * interval_s, 1.0))
    with _LOCK:
        _HEARTBEATS[name] = {"t_mono": time.monotonic(), "t_unix": round(time.time(), 3),
                             "interval_s": float(interval_s), "stale_after_s": stale}


def refresh_heartbeat(name: str) -> None:
    """Re-beat ``name`` only if it is already registered: the keepalive of
    a long step, which never registers a beat for a one-shot caller."""
    with _LOCK:
        hb = _HEARTBEATS.get(name)
        if hb is not None:
            hb["t_mono"] = time.monotonic()
            hb["t_unix"] = round(time.time(), 3)


def clear_heartbeat(name: Optional[str] = None) -> None:
    """Drop one heartbeat (or all), with its scrape-time gauge series: an
    age left behind would scrape as fresh forever."""
    with _LOCK:
        dropped = list(_HEARTBEATS) if name is None else ([name] if name in _HEARTBEATS else [])
        if name is None:
            _HEARTBEATS.clear()
        else:
            _HEARTBEATS.pop(name, None)
    if not dropped:
        return
    from anovos_tpu_torch.obs.metrics import get_metrics

    reg = get_metrics()
    for fam in ("heartbeat_age_seconds", "heartbeat_stale"):
        inst = reg.peek(fam)  # never create an empty family on cleanup
        if inst is not None:
            for n in dropped:
                inst.remove(name=n)


def heartbeat_ages(now: Optional[float] = None) -> Dict[str, dict]:
    """``{name: {age_s, interval_s, stale_after_s, stale, last_unix}}``."""
    now = time.monotonic() if now is None else now
    with _LOCK:
        beats = {k: dict(v) for k, v in _HEARTBEATS.items()}
    out: Dict[str, dict] = {}
    for name, hb in sorted(beats.items()):
        age = max(0.0, now - hb["t_mono"])
        out[name] = {"age_s": round(age, 3), "interval_s": hb["interval_s"],
                     "stale_after_s": hb["stale_after_s"], "stale": age > hb["stale_after_s"],
                     "last_unix": hb["t_unix"]}
    return out


# ---------------------------------------------------------------------------
# rolling SLO windows
# ---------------------------------------------------------------------------

class RollingWindow:
    """Sliding-window latency and error accounting for a request plane.

    ``observe()`` appends ``(t, latency_s, ok)`` to a bounded ring; the
    summary gives, for each trailing window, the count and errors, p50 and
    p99 latency, the QPS over the effective window (never longer than the
    history observed, nor older than the oldest sample kept once the ring
    has evicted), the error rate, and the burn rate (error rate ÷ budget).
    Thread-safe; both entry points take one short lock."""

    def __init__(self, windows: Tuple[float, ...] = _DEFAULT_WINDOWS, maxlen: int = _WINDOW_RING,
                 budget: Optional[float] = None):
        self.windows = tuple(sorted(float(w) for w in windows))
        self.budget = budget
        self._ring: "deque[Tuple[float, float, bool]]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._t_first: Optional[float] = None

    def observe(self, latency_s: float, ok: bool = True, now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        with self._lock:
            if self._t_first is None:
                self._t_first = t
            self._ring.append((t, float(latency_s), bool(ok)))

    @staticmethod
    def _pct(sorted_vals: List[float], p: float) -> Optional[float]:
        if not sorted_vals:
            return None
        i = min(int(p * (len(sorted_vals) - 1)), len(sorted_vals) - 1)
        return round(sorted_vals[i] * 1000.0, 3)

    def summary(self, now: Optional[float] = None) -> Dict[str, dict]:
        """``{"60s": {count, errors, p50_ms, p99_ms, qps, error_rate,
        error_budget_burn}, ...}``."""
        t = time.monotonic() if now is None else now
        budget = self.budget if self.budget is not None else error_budget()
        with self._lock:
            samples = list(self._ring)
            t_first = self._t_first
        out: Dict[str, dict] = {}
        ring_full = len(samples) == self._ring.maxlen
        for w in self.windows:
            cut = t - w
            lat = sorted(s[1] for s in samples if s[0] >= cut)
            errors = sum(1 for s in samples if s[0] >= cut and not s[2])
            n = len(lat)
            start = samples[0][0] if (ring_full and samples) else t_first
            eff = w if start is None else min(w, max(t - start, 1e-9))
            err_rate = (errors / n) if n else 0.0
            out[f"{int(w)}s"] = {
                "count": n,
                "errors": errors,
                "p50_ms": self._pct(lat, 0.50),
                "p99_ms": self._pct(lat, 0.99),
                "qps": round(n / eff, 3) if n else 0.0,
                "error_rate": round(err_rate, 6),
                "error_budget_burn": round(err_rate / budget, 4),
            }
        return out


# ---------------------------------------------------------------------------
# /healthz
# ---------------------------------------------------------------------------

_STATUS_RANK = {"ok": 0, "degraded": 1, "unhealthy": 2}


def health(now: Optional[float] = None) -> dict:
    """The health document: the worst of the degradation registry, the
    quarantine, the chaos wedge flag, heartbeat staleness and every
    provider's fragment.  Never raises: a probe that fails becomes a
    reason.  ``backend.failovers`` is this run's flips to the CPU
    (``resilience.failover.failover_count``); a flip makes the run
    degraded."""
    status = "ok"
    reasons: List[str] = []

    def worsen(new: str, why: str) -> None:
        nonlocal status
        if _STATUS_RANK[new] > _STATUS_RANK[status]:
            status = new
        reasons.append(why)

    doc: dict = {"t_unix": round(time.time(), 3), "pid": os.getpid()}
    try:
        from anovos_tpu_torch.resilience.policy import degraded_sections

        degraded = degraded_sections()
        doc["degraded_sections"] = degraded
        for node, why in sorted(degraded.items()):
            worsen("degraded", f"degraded section {node}: {why}")
    except Exception as e:
        worsen("degraded", f"health probe degraded_sections failed: {type(e).__name__}: {e}")
    try:
        from anovos_tpu_torch.data_ingest import guard

        q = guard.summary()
        doc["quarantine"] = {"parts": q["parts"], "rows_lost": q["rows_lost"]}
        if q["parts"]:
            worsen("degraded", f"{q['parts']} ingest part(s) quarantined ({q['rows_lost']} rows lost)")
    except Exception as e:
        worsen("degraded", f"health probe quarantine failed: {type(e).__name__}: {e}")
    try:
        from anovos_tpu_torch.resilience import chaos
        from anovos_tpu_torch.resilience.failover import failover_count

        wedged = chaos.backend_wedged()
        flips = failover_count()
        doc["backend"] = {"wedged": wedged, "failovers": flips}
        if wedged:
            worsen("unhealthy", "backend wedged (dispatch unresponsive)")
        elif flips:
            worsen("degraded", f"backend failed over to CPU {flips}x this run")
    except Exception as e:
        worsen("degraded", f"health probe backend failed: {type(e).__name__}: {e}")
    beats = heartbeat_ages(now=now)
    doc["heartbeats"] = beats
    for name, hb in beats.items():
        if hb["age_s"] > 3.0 * hb["stale_after_s"]:
            worsen("unhealthy", f"heartbeat {name} silent {hb['age_s']}s "
                                f"(stale after {hb['stale_after_s']}s)")
        elif hb["stale"]:
            worsen("degraded", f"heartbeat {name} stale: {hb['age_s']}s since last beat "
                               f"(expected every {hb['interval_s']}s)")
    for name, prov in sorted(_providers().items()):
        fn = prov.get("health")
        if fn is None:
            continue
        try:
            st, why = fn()
            for w in (why or []):
                worsen(st, w)
            if not why and st != "ok":
                worsen(st, f"provider {name} reports {st}")
        except Exception as e:
            worsen("degraded", f"health provider {name} failed: {type(e).__name__}: {e}")
    doc["status"] = status
    doc["reasons"] = reasons
    return doc


# ---------------------------------------------------------------------------
# /metrics and /statusz
# ---------------------------------------------------------------------------

def _collect_live(reg) -> None:
    """Set the scrape-time families: each card's memory, heartbeat ages,
    and the providers' gauges.  A failing provider costs its own family,
    never the scrape."""
    from anovos_tpu_torch.obs.metrics import record_device_memory

    record_device_memory(reg)  # never raises
    for name, hb in heartbeat_ages().items():
        reg.gauge("heartbeat_age_seconds", "seconds since the named service heartbeat last beat"
                  ).set(hb["age_s"], name=name)
        reg.gauge("heartbeat_stale", "1 when the named heartbeat is past its staleness bound"
                  ).set(1.0 if hb["stale"] else 0.0, name=name)
    for name, prov in sorted(_providers().items()):
        fn = prov.get("metrics")
        if fn is None:
            continue
        try:
            fn(reg)
        except Exception:
            logger.exception("telemetry metrics provider %r failed", name)


def render_metrics() -> str:
    """The ``/metrics`` body: the live families set, then the registry in
    the Prometheus text format (byte-deterministic for a given state)."""
    from anovos_tpu_torch.obs.metrics import get_metrics

    reg = get_metrics()
    _collect_live(reg)
    return reg.expose_text()


def statusz_doc() -> dict:
    """The live flight-recorder snapshot: the scheduler provider's view
    through :func:`~anovos_tpu_torch.obs.flight.build_snapshot`, every other
    provider's fragment, and the heartbeats."""
    from anovos_tpu_torch.obs import flight

    provs = _providers()
    sched: dict = {}
    fn = (provs.get("scheduler") or {}).get("statusz")
    if fn is not None:
        try:
            sched = fn() or {}
        except Exception as e:
            sched = {"error": f"{type(e).__name__}: {e}"}
    doc = flight.build_snapshot("statusz", inflight=sched.get("inflight"),
                                queue_depth=sched.get("queue_depth"),
                                rendezvous_holders=sched.get("rendezvous_holders"))
    extras: Dict[str, object] = {}
    for name, prov in sorted(provs.items()):
        sfn = prov.get("statusz")
        if name == "scheduler" or sfn is None:
            continue
        try:
            extras[name] = sfn()
        except Exception as e:
            extras[name] = {"error": f"{type(e).__name__}: {e}"}
    doc["providers"] = extras
    doc["heartbeats"] = heartbeat_ages()
    return doc


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    server_version = "anovos-telemetry/1"
    # HTTP/1.1 with Content-Length keeps the connection alive across scrapes
    protocol_version = "HTTP/1.1"
    # headers and body go out as separate writes; without TCP_NODELAY the
    # body waits on a delayed ACK (~40 ms) on every keep-alive scrape
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # access logs off stderr
        logger.debug("telemetry: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        from anovos_tpu_torch.obs.metrics import get_metrics

        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        # the label comes from the closed route set, never the raw path: a
        # scanner probing random URLs must not add one series a probe
        endpoint = path if path in ("/", "/metrics", "/healthz", "/statusz") else "other"
        reg = get_metrics()
        t0 = time.perf_counter()
        try:
            if path == "/metrics":
                body = render_metrics().encode()
                code, ctype = 200, "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                doc = health()
                body = (json.dumps(doc, sort_keys=True) + "\n").encode()
                code = 503 if doc["status"] == "unhealthy" else 200
                ctype = "application/json"
            elif path == "/statusz":
                body = (json.dumps(statusz_doc(), sort_keys=True, default=str) + "\n").encode()
                code, ctype = 200, "application/json"
            elif path == "/":
                body = (b"anovos-tpu telemetry\n"
                        b"/metrics  prometheus exposition\n"
                        b"/healthz  ok|degraded|unhealthy + reasons\n"
                        b"/statusz  live flight-recorder snapshot\n")
                code, ctype = 200, "text/plain; charset=utf-8"
            else:
                body = b"not found\n"
                code, ctype = 404, "text/plain; charset=utf-8"
        except Exception as e:
            logger.exception("telemetry handler for %s failed", path)
            body = (json.dumps({"error": f"{type(e).__name__}: {e}"}) + "\n").encode()
            code, ctype = 500, "application/json"
            reg.counter("telemetry_scrape_errors_total", "telemetry requests that failed server-side"
                        ).inc(endpoint=endpoint)
        reg.counter("telemetry_scrapes_total", "telemetry endpoint requests served").inc(endpoint=endpoint)
        reg.histogram("telemetry_scrape_seconds", "telemetry request handling wall"
                      ).observe(time.perf_counter() - t0, endpoint=endpoint)
        try:
            self._send(code, body, ctype)
        except (BrokenPipeError, ConnectionResetError):
            logger.debug("telemetry client for %s went away mid-response", path)


class _Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` whose connection threads are named, tracked
    and joined: :meth:`close_connections` shuts every open connection's
    socket down (a keep-alive client blocks its thread in a read until
    then) and joins the threads."""

    daemon_threads = True

    def __init__(self, addr, handler):
        super().__init__(addr, handler)
        self._conns: Dict[threading.Thread, socket.socket] = {}
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        t = threading.Thread(target=self._serve, args=(request, client_address), name=CONN_THREAD,
                             daemon=True)
        with self._conns_lock:
            self._conns[t] = request
        t.start()

    def _serve(self, request, client_address):
        try:
            self.process_request_thread(request, client_address)
        finally:
            with self._conns_lock:
                self._conns.pop(threading.current_thread(), None)

    def close_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns.items())
        for _, sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t, _ in conns:
            t.join(timeout=10)


class TelemetryServer:
    """One embedded HTTP listener on 127.0.0.1, served from a thread named
    ``anovos-torch-telemetry``.  ``port=0`` takes an ephemeral port; the
    bound port is on ``.port``."""

    def __init__(self, port: int):
        self._requested = int(port)
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> "TelemetryServer":
        httpd = _Server(("127.0.0.1", self._requested), _Handler)
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
                                        name=SERVER_THREAD, daemon=True)
        self._thread.start()
        logger.info("telemetry plane listening on http://127.0.0.1:%d (/metrics /healthz /statusz)",
                    self.port)
        return self

    def stop(self) -> None:
        """Stop serving, close the listener and every open connection, and
        join every thread the server started."""
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            httpd.close_connections()
        if thread is not None:
            thread.join(timeout=10)


# ---------------------------------------------------------------------------
# the process-wide server, reference-counted
# ---------------------------------------------------------------------------

def acquire(context: str = "", port: Optional[int] = None) -> Optional[TelemetryServer]:
    """Start (or join) the process-wide server.  ``port=None`` reads
    ``ANOVOS_TPU_TELEMETRY``: off returns None with no thread and no
    socket.  An explicit ``port`` overrides (``0`` = ephemeral).  A bind
    conflict warns, books ``telemetry_bind_failures_total`` and returns
    None.  Pair every acquire with :func:`release`."""
    global _SERVER, _REFS
    if port is None:
        port = telemetry_port()
        if port is None:
            return None
    with _START_LOCK:
        with _LOCK:
            if _SERVER is not None:
                _REFS += 1
                return _SERVER
        server = TelemetryServer(port)
        try:
            server.start()
        except OSError as e:
            logger.warning("telemetry plane could not bind 127.0.0.1:%s (%s) — continuing WITHOUT "
                           "live telemetry (%s)", port, e, context or "unnamed surface")
            from anovos_tpu_torch.obs.metrics import get_metrics

            get_metrics().counter("telemetry_bind_failures_total",
                                  "telemetry listeners that failed to bind (run continued)").inc()
            return None
        with _LOCK:
            _SERVER = server
            _REFS = 1
        return server


def release(server: Optional[TelemetryServer]) -> None:
    """Release one :func:`acquire` hold (None-safe); the last holder's
    release stops the server, under the start lock, so a concurrent
    acquire on the same fixed port waits for the socket to close."""
    global _SERVER, _REFS
    if server is None:
        return
    with _START_LOCK:
        with _LOCK:
            if server is not _SERVER:
                return  # already stopped
            _REFS -= 1
            if _REFS > 0:
                return
            _SERVER = None
            _REFS = 0
        server.stop()


def current() -> Optional[TelemetryServer]:
    """The live server, if any."""
    with _LOCK:
        return _SERVER
