"""The port's live telemetry plane (``anovos_tpu_torch/obs/telemetry.py``,
``MetricsRegistry.expose_text`` and trace rotation) against the JAX
package's, case by case as ``tests/test_telemetry.py`` holds the JAX one
(its ``FeatureServer`` timeout case is in ``tests/test_torch_serving.py``):

* the Prometheus text: deterministic, escaped, and byte-equal to JAX's
  for the same instrument calls, through ``expose_text`` and
  ``render_metrics``;
* the endpoint's life: off starts no thread, a bind conflict degrades
  loudly, acquire/release count holders, 404 and ``/statusz``;
* ``RollingWindow.summary``, ``health`` and ``heartbeat_ages`` equal to
  JAX's on one synthetic stream, with an explicit ``now`` and no sleep,
  under ``ANOVOS_TPU_SLO_ERROR_BUDGET`` too;
* trace rotation: ``rotation_spec`` as JAX parses it, the union of the
  segments equal to one uninterrupted export, a failed export requeued;
* the continuum loop and the runner with ``ANOVOS_TPU_TELEMETRY`` and
  ``ANOVOS_TPU_TRACE_ROTATE`` set, against the JAX runner's segments;
* a live ``FeatureServer``'s serving provider on ``/metrics``,
  ``/statusz`` and ``/healthz``, healthy and after a fatal micro-batch.

Ports come from the OS (port 0).  Every test leaves no thread behind
(``_no_thread_left``), and the plane's threads never take a JAX thread's
name.
"""

import copy
import json
import logging
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_no_thread_left, free_port, thread_names, torch_cpu_runtime  # noqa: F401
from anovos_tpu_torch.obs import telemetry
from anovos_tpu_torch.obs.metrics import MetricsRegistry, get_metrics
from anovos_tpu_torch.obs.tracing import Tracer, TraceRotator, rotation_spec

JAX_THREADS = {"anovos-telemetry", "anovos-trace-rotator"}


@pytest.fixture(autouse=True)
def _no_thread_left(monkeypatch):
    """Each test starts with no heartbeats, providers or degraded sections
    in either package and the knobs unset, and leaves no thread behind."""
    from anovos_tpu.obs import telemetry as jtel
    from anovos_tpu.resilience.policy import reset_degraded as jreset
    from anovos_tpu_torch.resilience.policy import reset_degraded

    for knob in ("ANOVOS_TPU_TELEMETRY", "ANOVOS_TPU_TRACE_ROTATE", "ANOVOS_TPU_SLO_ERROR_BUDGET"):
        monkeypatch.delenv(knob, raising=False)
    for tel, reset in ((telemetry, reset_degraded), (jtel, jreset)):
        tel.clear_heartbeat()
        reset()
    before = thread_names()
    yield
    for tel, reset in ((telemetry, reset_degraded), (jtel, jreset)):
        for name in list(tel._providers()):
            tel.unregister_provider(name)
        tel.clear_heartbeat()
        reset()
        srv = tel.current()
        if srv is not None:  # a failed test must not leak the listener
            tel.release(srv)
    assert_no_thread_left(before)


def _get(port, path, timeout=10):
    """(status, body): a 4xx or 5xx is still a served response."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _instrument_calls(reg):
    """One set of instrument calls: counters, a gauge with a high-water
    mark, histograms with and without labels, and a label and help text
    that need escaping."""
    reg.counter("b_total", "counter").inc(2, kind="x")
    reg.counter("a_total", "other").inc(1)
    reg.counter("a_total", "other").inc(0.25)
    reg.gauge("g", "gauge").set(1.5, device="cuda:0")
    reg.gauge("hw", "high water").set_max(3.0)
    reg.gauge("hw", "high water").set_max(2.0)
    reg.histogram("h_seconds", "hist").observe(0.02, node="n1")
    reg.histogram("h_seconds", "hist").observe(7.5, node="n1")
    reg.histogram("plain_seconds", "").observe(0.0004)
    reg.counter("c_total", "help with\nnewline and \\ slash").inc(1, lbl='va"l\nue\\x')


# ---------------------------------------------------------------------------
# the exposition format
# ---------------------------------------------------------------------------

def test_exposition_double_render_byte_identical():
    reg = MetricsRegistry()
    _instrument_calls(reg)
    assert reg.expose_text() == reg.expose_text()
    names = [ln.split()[2] for ln in reg.expose_text().splitlines() if ln.startswith("# TYPE")]
    assert names == sorted(names)


def test_exposition_equals_jax_byte_for_byte():
    from anovos_tpu.obs.metrics import MetricsRegistry as JRegistry

    reg, jreg = MetricsRegistry(), JRegistry()
    for r in (reg, jreg):
        _instrument_calls(r)
    assert reg.expose_text() == jreg.expose_text()
    assert reg.peek("a_total") is not None and reg.peek("absent") is None
    assert reg.peek("g").series() == jreg.peek("g").series()


def test_exposition_label_escaping_newline_quote_backslash():
    reg = MetricsRegistry()
    reg.counter("c_total", "help with\nnewline and \\ slash").inc(1, lbl='va"l\nue\\x')
    text = reg.expose_text()
    assert 'lbl="va\\"l\\nue\\\\x"' in text
    assert "# HELP c_total help with\\nnewline and \\\\ slash" in text
    assert len(text.splitlines()) == 3


def test_render_metrics_equals_jax():
    """``render_metrics`` of both packages after the same calls, a provider
    that sets a gauge and one that raises: the same bytes (the CPU runtime
    has no device memory gauges in either)."""
    from anovos_tpu.obs import telemetry as jtel
    from anovos_tpu.obs.metrics import get_metrics as jget

    def provider(reg):
        reg.gauge("serve_rolling_qps", "qps").set(42.5, window="60s")

    def broken(reg):
        raise RuntimeError("provider broke")

    for tel, reg in ((telemetry, get_metrics()), (jtel, jget())):
        reg.reset()
        _instrument_calls(reg)
        tel.register_provider("serving", metrics=provider)
        tel.register_provider("broken", metrics=broken)
    text = telemetry.render_metrics()
    assert text == jtel.render_metrics()
    assert 'serve_rolling_qps{window="60s"} 42.5' in text


def test_counter_monotonic_across_scrapes():
    srv = telemetry.acquire("test", port=0)
    try:
        get_metrics().counter("tel_test_total", "t").inc(3)

        def value(body, prefix):
            for line in body.splitlines():
                if line.startswith(prefix):
                    return float(line.rsplit(" ", 1)[1])
            return 0.0

        _, b1 = _get(srv.port, "/metrics")
        get_metrics().counter("tel_test_total", "t").inc(2)
        _, b2 = _get(srv.port, "/metrics")
        assert value(b1, "tel_test_total") == 3.0 and value(b2, "tel_test_total") == 5.0
        scrapes = 'telemetry_scrapes_total{endpoint="/metrics"}'
        assert value(b2, scrapes) > value(b1, scrapes)
    finally:
        telemetry.release(srv)


# ---------------------------------------------------------------------------
# the endpoint's life
# ---------------------------------------------------------------------------

def test_telemetry_off_means_no_thread():
    before = thread_names()
    assert telemetry.telemetry_port() is None
    assert telemetry.acquire("test") is None
    assert thread_names() == before


def test_env_port_parsing_equals_jax(monkeypatch, caplog):
    from anovos_tpu.obs import telemetry as jtel

    for raw, exp in (("0", None), ("off", None), ("not-a-port", None), ("70000", None), ("9138", 9138)):
        monkeypatch.setenv("ANOVOS_TPU_TELEMETRY", raw)
        with caplog.at_level(logging.WARNING):
            assert telemetry.telemetry_port() == jtel.telemetry_port() == exp


def test_bind_conflict_degrades_loudly_never_crashes(caplog):
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    before = get_metrics().counter("telemetry_bind_failures_total").value()
    try:
        with caplog.at_level(logging.WARNING, "anovos_tpu_torch.obs.telemetry"):
            assert telemetry.acquire("test", port=port) is None
        assert any("could not bind" in r.message for r in caplog.records)
        assert get_metrics().counter("telemetry_bind_failures_total").value() == before + 1
    finally:
        blocker.close()


def test_acquire_release_refcount_and_thread_names():
    a = telemetry.acquire("one", port=0)
    b = telemetry.acquire("two", port=0)
    assert a is b
    names = thread_names()
    assert "anovos-torch-telemetry" in names and not names & JAX_THREADS
    telemetry.release(a)
    code, _ = _get(a.port, "/healthz")  # one holder left
    assert code == 200
    telemetry.release(b)
    assert telemetry.current() is None
    with pytest.raises(Exception):
        urllib.request.urlopen(f"http://127.0.0.1:{a.port}/healthz", timeout=2)


def test_stop_closes_an_idle_keep_alive_connection():
    """A scraper that keeps its connection open does not keep a thread:
    the last release shuts the connection down and joins its thread."""
    import http.client

    srv = telemetry.acquire("test", port=0)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    try:
        for _ in range(3):  # one connection, three scrapes
            conn.request("GET", "/metrics")
            r = conn.getresponse()
            assert r.status == 200 and r.read()
        assert "anovos-torch-telemetry-conn" in thread_names()
    finally:
        telemetry.release(srv)
        conn.close()
    assert "anovos-torch-telemetry-conn" not in thread_names()


def test_unknown_path_404_and_statusz_live():
    srv = telemetry.acquire("test", port=0)
    try:
        assert _get(srv.port, "/nope")[0] == 404
        telemetry.register_provider(
            "scheduler", statusz=lambda: {"inflight": [{"node": "x", "state": "running"}],
                                          "queue_depth": 3, "rendezvous_holders": []})
        telemetry.register_provider("widget", statusz=lambda: {"n": 7})
        code, body = _get(srv.port, "/statusz")
        doc = json.loads(body)
        assert code == 200 and doc["trigger"] == "statusz" and doc["queue_depth"] == 3
        assert doc["inflight"][0]["node"] == "x" and doc["providers"]["widget"] == {"n": 7}
        assert "metrics" in doc and "spans_tail" in doc and doc["backend"] == "cpu"
        assert _get(srv.port, "/")[1].startswith("anovos-tpu telemetry")
    finally:
        telemetry.release(srv)


def test_broken_provider_costs_its_family_not_the_scrape():
    def boom(reg):
        raise RuntimeError("provider broke")

    telemetry.register_provider("broken", metrics=boom, statusz=lambda: 1 / 0)
    srv = telemetry.acquire("test", port=0)
    try:
        code, body = _get(srv.port, "/metrics")
        assert code == 200 and "telemetry_scrapes_total" in body
        code, body = _get(srv.port, "/statusz")
        assert code == 200 and "ZeroDivisionError" in json.loads(body)["providers"]["broken"]["error"]
    finally:
        telemetry.release(srv)


# ---------------------------------------------------------------------------
# rolling SLO windows, health and heartbeats against the JAX package
# ---------------------------------------------------------------------------

def _stream(w):
    """200 requests over 2 s, latencies 1..200 ms, every 20th an error,
    after one old error outside the 60 s window."""
    w.observe(1.0, ok=False, now=900.0)
    for i in range(200):
        w.observe((i + 1) / 1000.0, ok=(i % 20 != 0), now=1000.0 + i * 0.01)


@pytest.mark.parametrize("budget_env", [None, "0.05", "2", "garbage"])
def test_rolling_window_summary_equals_jax(budget_env, monkeypatch, caplog):
    """``ANOVOS_TPU_SLO_ERROR_BUDGET`` (unset, valid, out of range,
    malformed) gives both packages the same budget and summary."""
    from anovos_tpu.obs import telemetry as jtel

    if budget_env is not None:
        monkeypatch.setenv("ANOVOS_TPU_SLO_ERROR_BUDGET", budget_env)
    with caplog.at_level(logging.WARNING):
        assert telemetry.error_budget() == jtel.error_budget()
    for maxlen in (65536, 100):
        w = telemetry.RollingWindow(windows=(60.0, 300.0, 1.0), maxlen=maxlen)
        jw = jtel.RollingWindow(windows=(60.0, 300.0, 1.0), maxlen=maxlen)
        _stream(w)
        _stream(jw)
        for now in (1002.0, 1030.5, 1400.0):
            assert w.summary(now=now) == jw.summary(now=now)


def test_rolling_window_math_synthetic_stream():
    w = telemetry.RollingWindow(windows=(60.0,), budget=0.01)
    for i in range(200):
        w.observe((i + 1) / 1000.0, ok=(i % 20 != 0), now=1000.0 + i * 0.01)
    s = w.summary(now=1002.0)["60s"]
    assert s["count"] == 200 and s["errors"] == 10
    assert s["p50_ms"] == pytest.approx(100.0, abs=2.0)
    assert s["p99_ms"] == pytest.approx(198.0, abs=3.0)
    assert s["qps"] == pytest.approx(100.0, rel=0.01)
    assert s["error_rate"] == pytest.approx(0.05)
    assert s["error_budget_burn"] == pytest.approx(5.0)


def test_rolling_window_full_ring_does_not_deflate_qps():
    w = telemetry.RollingWindow(windows=(60.0,), maxlen=100, budget=0.01)
    for i in range(1000):
        w.observe(0.001, ok=True, now=2000.0 + i * 0.001)
    s = w.summary(now=2001.0)["60s"]
    assert s["count"] == 100 and s["qps"] == pytest.approx(1000.0, rel=0.05)


def test_rolling_window_ages_out_old_samples():
    w = telemetry.RollingWindow(windows=(60.0,), budget=0.01)
    w.observe(1.0, ok=False, now=100.0)
    for i in range(10):
        w.observe(0.010, ok=True, now=500.0 + i)
    s = w.summary(now=510.0)["60s"]
    assert s["count"] == 10 and s["errors"] == 0 and s["p99_ms"] == pytest.approx(10.0)


def _beats(tel, t0):
    """Three heartbeats at fixed monotonic times: fresh, stale, silent."""
    for name, interval, stale in (("fresh", 1.0, None), ("stale", 0.1, 0.5), ("silent", 0.1, 0.2)):
        tel.beat(name, interval_s=interval, stale_after_s=stale)
    with tel._LOCK:
        for name, t in (("fresh", t0 - 0.5), ("stale", t0 - 0.75), ("silent", t0 - 5.0)):
            tel._HEARTBEATS[name]["t_mono"] = t
            tel._HEARTBEATS[name]["t_unix"] = 1.5


def test_health_and_heartbeat_ages_equal_jax():
    """One synthetic stream of beats, a degraded section and a provider's
    fragment in both packages: ``heartbeat_ages(now)`` equal, and
    ``health(now)`` equal but for its clock and pid."""
    from anovos_tpu.obs import telemetry as jtel
    from anovos_tpu.resilience.policy import record_degraded as jrecord
    from anovos_tpu_torch.resilience.policy import record_degraded

    t0 = 10_000.0
    docs = []
    for tel, rec in ((telemetry, record_degraded), (jtel, jrecord)):
        _beats(tel, t0)
        assert tel.heartbeat_ages(now=t0)["silent"]["age_s"] == 5.0
        docs.append(tel.health(now=t0))
        rec("quality_checker/outliers", "synthetic failure")
        tel.register_provider("serving", health=lambda: ("degraded", ["micro-batch of 9 row(s) failed"]))
        docs.append(tel.health(now=t0))
    assert telemetry.heartbeat_ages(now=t0) == jtel.heartbeat_ages(now=t0)
    for d in docs:
        d.pop("t_unix"), d.pop("pid")
    assert docs[0] == docs[2] and docs[1] == docs[3]
    assert docs[0]["status"] == "unhealthy"
    assert any("micro-batch of 9" in r for r in docs[1]["reasons"])


def test_health_ok_then_degraded_section():
    from anovos_tpu_torch.resilience.policy import record_degraded

    doc = telemetry.health()
    assert doc["status"] == "ok" and doc["reasons"] == []
    record_degraded("quality_checker/outliers", "synthetic failure")
    doc = telemetry.health()
    assert doc["status"] == "degraded"
    assert any("quality_checker/outliers" in r for r in doc["reasons"])


def test_refresh_heartbeat_only_touches_registered_beats():
    import time

    telemetry.refresh_heartbeat("svc")  # nothing registered: a no-op
    assert "svc" not in telemetry.heartbeat_ages()
    telemetry.beat("svc", interval_s=0.01, stale_after_s=0.2)
    assert telemetry.heartbeat_ages(now=time.monotonic() + 1.0)["svc"]["stale"] is True
    with telemetry._LOCK:
        telemetry._HEARTBEATS["svc"]["t_mono"] -= 1.0
    telemetry.refresh_heartbeat("svc")
    hb = telemetry.heartbeat_ages()["svc"]
    assert hb["stale"] is False and hb["stale_after_s"] == 0.2


def test_unhealthy_heartbeat_answers_503():
    import time

    _beats(telemetry, time.monotonic())
    srv = telemetry.acquire("test", port=0)
    try:
        code, body = _get(srv.port, "/healthz")
        assert code == 503 and json.loads(body)["status"] == "unhealthy"
    finally:
        telemetry.release(srv)


def test_metrics_scrape_renders_provider_gauges_and_heartbeats():
    telemetry.beat("svc", interval_s=30.0)
    telemetry.register_provider(
        "serving", metrics=lambda reg: reg.gauge("serve_rolling_qps", "qps").set(42.5, window="60s"))
    srv = telemetry.acquire("test", port=0)
    try:
        _, body = _get(srv.port, "/metrics")
        assert 'serve_rolling_qps{window="60s"} 42.5' in body
        assert 'heartbeat_age_seconds{name="svc"}' in body
        assert 'heartbeat_stale{name="svc"} 0.0' in body
    finally:
        telemetry.release(srv)


def test_cleared_heartbeat_drops_its_gauge_series():
    telemetry.beat("gone_svc", interval_s=30.0)
    srv = telemetry.acquire("test", port=0)
    try:
        assert 'heartbeat_age_seconds{name="gone_svc"}' in _get(srv.port, "/metrics")[1]
        telemetry.clear_heartbeat("gone_svc")
        assert 'name="gone_svc"' not in _get(srv.port, "/metrics")[1]
    finally:
        telemetry.release(srv)


def test_feature_server_provider_on_the_live_plane(tmp_path, monkeypatch):
    """A server started under ANOVOS_TPU_TELEMETRY holds the listener and
    serves its provider: the serving families in /metrics, its section of
    /statusz, and /healthz ok, then degraded naming a micro-batch that failed
    after its retry (with its serve_fatal dump); close() lets all of it go."""
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import chaos
    from anovos_tpu_torch.serving import ApplyProgram, FeatureServer, fit_bundle, frame_to_payload
    from anovos_tpu_torch.serving.demo import DEMO_CHAIN, demo_frame
    from anovos_tpu_torch.shared.table import Table

    flight.reset()  # a runner's run earlier in this worker leaves it armed elsewhere
    df = demo_frame(200, seed=5)
    bundle = fit_bundle(Table.from_pandas(df, device="cpu"), DEMO_CHAIN)
    program = ApplyProgram(type(bundle)(doc=bundle.doc, version=bundle.version))
    payload = {"columns": frame_to_payload(df[bundle.input_names].iloc[:3])}
    monkeypatch.setenv("ANOVOS_TPU_TELEMETRY", str(free_port()))
    server = FeatureServer(program, window_ms=2, max_batch=16, obs_dir=str(tmp_path))
    server.start(warm=False)
    try:
        srv = telemetry.current()
        assert srv is not None and srv.port == int(os.environ["ANOVOS_TPU_TELEMETRY"])
        for _ in range(3):
            assert "error" not in server.serve(payload)
        _, body = _get(srv.port, "/metrics")
        for fam in ("serve_batches_total", 'serve_rolling_qps{window="60s"}', 'serve_rolling_p99_ms{window="60s"}',
                    "serve_queue_depth 0.0", "serve_request_seconds_bucket"):
            assert fam in body, fam
        code, body = _get(srv.port, "/statusz")
        section = json.loads(body)["providers"]["serving"]
        assert code == 200 and section["served"] == 3 and section["rolling"]["60s"]["count"] == 3
        assert section["inflight_batch"] is None and section["last_fatal"] is None
        code, body = _get(srv.port, "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        chaos.install("exc@serve:apply:n=2")
        assert server.serve(payload)["error"]["code"] == "apply_failed"
        doc = json.loads(_get(srv.port, "/healthz")[1])
        assert doc["status"] == "degraded"
        assert any(r.startswith("serving: micro-batch of 3 row(s) (1 request(s)) failed after retry")
                   for r in doc["reasons"])
        section = json.loads(_get(srv.port, "/statusz")[1])["providers"]["serving"]
        assert section["failed_batches"] == 1 and section["last_fatal"]["rows"] == 3
        assert [os.path.basename(p) for p in flight.dump_paths()] == ["flightrec_serving_apply.json"]
    finally:
        chaos.reset()
        server.close()
    assert telemetry.current() is None and "serving" not in telemetry._providers()
    assert not flight.enabled()
    assert (tmp_path / "obs" / "flightrec_serving_apply.json").is_file()


# ---------------------------------------------------------------------------
# trace rotation and the ring's overflow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["30s", "1.5s", "200000", "", "0", "false", "garbage", "-3", "0s", "s"])
def test_rotation_spec_equals_jax(raw, monkeypatch):
    from anovos_tpu.obs.tracing import rotation_spec as jspec

    monkeypatch.setenv("ANOVOS_TPU_TRACE_ROTATE", raw)
    assert rotation_spec() == jspec()


def _segment_names(paths):
    return [e["name"] for p in paths for e in json.load(open(p))["traceEvents"] if e.get("ph") == "X"]


def test_trace_rotation_union_equals_uninterrupted_export(tmp_path):
    tr = Tracer(buffer=10_000)
    rot = TraceRotator(str(tmp_path / "trace.json"), tracer=tr, spec=("spans", 37))
    expected = []
    for i in range(150):
        with tr.span(f"op{i:03d}", idx=i):
            pass
        expected.append(f"op{i:03d}")
        rot.maybe_rotate()
    segments = rot.close()
    assert len(segments) >= 3 and [os.path.basename(p) for p in segments][0] == "trace_0001.json"
    last_end = None
    for p in segments:
        evs = [e for e in json.load(open(p))["traceEvents"] if e.get("ph") == "X"]
        start = min(e["ts"] for e in evs)
        if last_end is not None:
            assert start >= last_end - 1e3  # one shared epoch across segments
        last_end = max(e["ts"] for e in evs)
    assert _segment_names(segments) == expected
    assert tr.span_count() == 0


def test_rotation_secs_mode_and_thread_lifecycle(tmp_path):
    import time

    tr = Tracer(buffer=10_000)
    rot = TraceRotator(str(tmp_path / "t.json"), tracer=tr, spec=("secs", 0.15)).start()
    names = thread_names()
    assert "anovos-torch-trace-rotator" in names and not names & JAX_THREADS
    for i in range(20):
        with tr.span(f"s{i}"):
            pass
        time.sleep(0.02)
    segments = rot.close()
    assert "anovos-torch-trace-rotator" not in thread_names()
    assert len(segments) >= 2
    assert sorted(_segment_names(segments)) == sorted(f"s{i}" for i in range(20))


def test_rotation_failed_export_requeues_spans_no_phantom_segment(tmp_path):
    tr = Tracer(buffer=1000)
    rot = TraceRotator(str(tmp_path / "blocked" / "trace.json"), tracer=tr, spec=("spans", 1))
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    (tmp_path / "blocked").write_text("not a directory")  # the export fails
    with pytest.raises(Exception):
        rot.maybe_rotate(force=True)
    assert rot.segments == [] and tr.span_count() == 5
    (tmp_path / "blocked").unlink()
    path = rot.maybe_rotate(force=True)
    assert path and rot.segments == [path]
    assert _segment_names([path]) == [f"s{i}" for i in range(5)]


def test_requeue_past_the_bound_books_dropped_spans():
    before = get_metrics().counter("trace_spans_dropped_total").value()
    tr = Tracer(buffer=8)
    for i in range(6):
        with tr.span(f"a{i}"):
            pass
    drained = tr.drain()
    for i in range(5):
        with tr.span(f"b{i}"):
            pass
    tr.requeue(drained)
    assert [s.name for s in tr.snapshot()] == ["a3", "a4", "a5", "b0", "b1", "b2", "b3", "b4"]
    assert tr.dropped == 3
    assert get_metrics().counter("trace_spans_dropped_total").value() == before + 3


def test_tracer_ring_overflow_counts_and_warns_once(caplog):
    before = get_metrics().counter("trace_spans_dropped_total").value()
    tr = Tracer(buffer=16)
    with caplog.at_level(logging.WARNING, "anovos_tpu_torch.obs.tracing"):
        for _ in range(40):
            with tr.span("x"):
                pass
    assert tr.dropped == 24
    assert get_metrics().counter("trace_spans_dropped_total").value() == before + 24
    assert len([r for r in caplog.records if "ring wrapped" in r.message]) == 1


# ---------------------------------------------------------------------------
# the continuum loop and the runner with the service knobs set
# ---------------------------------------------------------------------------

def _feed(tmp_path, days, seed=5):
    feed = tmp_path / "feed"
    feed.mkdir()
    rng = np.random.default_rng(seed)
    for day in days:
        pd.DataFrame({"a": rng.normal(0, 1, 40)}).to_parquet(feed / f"day-{day:02d}.parquet", index=False)
    return feed


def test_continuum_step_sets_gauges_but_no_oneshot_heartbeat(tmp_path):
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig, step

    feed = _feed(tmp_path, (1,))
    cfg = ContinuumConfig(dataset_path=str(feed), state_dir=str(tmp_path / "state"),
                          output_path=str(tmp_path / "out"), poll_s=0.5)
    assert step(cfg)["folded"] == ["day-01.parquet"]
    assert "continuum_watcher" not in telemetry.heartbeat_ages()
    snap = get_metrics().snapshot()
    lag = list(snap["continuum_arrival_artifact_lag_seconds"]["series"].values())
    assert lag and lag[0] >= 0
    assert list(snap["continuum_fold_backlog"]["series"].values())[0] == 0.0


def test_continuum_run_serves_telemetry_and_rotates(tmp_path, monkeypatch):
    """``run`` holds the plane on the knob's port and the rotator: /metrics
    answers with the fold families during the loop, /healthz shows the
    loop's heartbeat, the segments land under ``<output>/obs``, and both
    are gone after the loop."""
    import time

    from anovos_tpu_torch.continuum.watcher import ContinuumConfig, run

    feed = _feed(tmp_path, (1, 2))
    port = free_port()
    monkeypatch.setenv("ANOVOS_TPU_TELEMETRY", str(port))
    monkeypatch.setenv("ANOVOS_TPU_TRACE_ROTATE", "1")  # rotate every span
    cfg = ContinuumConfig(dataset_path=str(feed), state_dir=str(tmp_path / "state"),
                          output_path=str(tmp_path / "out"), poll_s=0.05)
    scraped = {}

    def poll():
        for _ in range(400):
            try:
                code, body = _get(port, "/metrics", timeout=2)
                if code == 200 and "continuum_fold_backlog" in body:
                    scraped["metrics"] = True
                    doc = json.loads(_get(port, "/healthz", timeout=2)[1])
                    scraped["healthz"] = doc["status"]
                    if "continuum_watcher" in doc["heartbeats"]:
                        scraped["heartbeat"] = True
                        return
            except Exception:
                pass
            time.sleep(0.01)

    t = threading.Thread(target=poll, name="test-poller")
    t.start()
    steps = run(cfg, max_iterations=3)
    t.join(timeout=10)
    assert len(steps) == 3
    assert scraped.get("metrics") is True and scraped.get("heartbeat") is True
    assert scraped.get("healthz") in ("ok", "degraded")
    assert telemetry.current() is None and "continuum_watcher" not in telemetry.heartbeat_ages()
    segs = sorted((tmp_path / "out" / "obs").glob("trace_*.json"))
    assert segs and len(_segment_names(segs)) >= 3


def test_continuum_run_crash_keeps_heartbeat(tmp_path):
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig, run

    feed = _feed(tmp_path, (1,))
    cfg = ContinuumConfig(dataset_path=str(feed), state_dir=str(tmp_path / "state"),
                          output_path=str(tmp_path / "out"),
                          outlier_model_path=str(tmp_path / "no_such_model"), poll_s=0.05)
    with pytest.raises(Exception):
        run(cfg, max_iterations=1)
    assert "continuum_watcher" in telemetry.heartbeat_ages()


def test_runner_with_the_service_knobs_equals_jax(tmp_path, monkeypatch):
    """Both runners on the mini config, sequential, with
    ``ANOVOS_TPU_TELEMETRY``, ``ANOVOS_TPU_TRACE_ROTATE`` and
    ``ANOVOS_TPU_TRACE`` set: the rotated segments hold the same node
    spans in both, no trace.json is written beside them, and neither a
    listener nor a thread is left (the scrape during a run is
    ``chip_smoke.py`` phase 18's)."""
    from anovos_tpu import workflow as jwf
    from anovos_tpu.obs import telemetry as jtel
    from anovos_tpu_torch import workflow as pwf
    from test_torch_obs import mini_cfg, mini_parquet

    cfg = mini_cfg(mini_parquet(tmp_path))
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    monkeypatch.setenv("ANOVOS_TPU_TRACE", "1")
    monkeypatch.setenv("ANOVOS_TPU_TRACE_ROTATE", "5")
    spans = {}
    for name, wf, tel in (("port", pwf, telemetry), ("jax", jwf, jtel)):
        port = free_port()
        monkeypatch.setenv("ANOVOS_TPU_TELEMETRY", str(port))
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        wf.main(copy.deepcopy(cfg), "local")
        assert tel.current() is None
        obs_dir = d / "report_stats" / "obs"
        segs = sorted(obs_dir.glob("trace_*.json"))
        assert segs and not (obs_dir / "trace.json").exists()
        spans[name] = sorted(n for n in _segment_names(segs) if "/" in n or n in ("join_dataset",))
    assert spans["port"] == spans["jax"] and spans["port"]
