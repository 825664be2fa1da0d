"""CLI of the serving subsystem (the commands of ``python -m
anovos_tpu.serving``).

``python -m anovos_tpu_torch.serving export --data <dataset> --chain <yaml> --cache <dir>``
    Fit the chain on the dataset, commit the versioned bundle into the CAS
    store at ``--cache``, print ``{"bundle_version": ...}``.

``python -m anovos_tpu_torch.serving smoke [--rows N] [--clients C] [--requests R] [--telemetry]``
    The end-to-end proof: fit and export the demo bundle, reload it from
    the store, boot a :class:`FeatureServer` (the warm-up of every row
    bucket), run a concurrent-client mixed-width load, check a parity
    sample byte for byte against the batch apply, and print one JSON line
    with ``serve_qps`` / ``serve_p50_ms`` / ``serve_p99_ms`` /
    ``serve_cold_start_s``.  ``--telemetry`` adds the live plane's
    overhead legs (``telemetry_overhead_pct``, ``scrape_p99_ms``).

Both run on the card: without one they exit at ``init_runtime`` (a caller
that set up a runtime first, as the tests do with ``init_runtime("cpu")``,
keeps it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

_T0 = time.perf_counter()  # process-start anchor for the cold-start record

# mixed request widths for the smoke load: single rows through half-batches
SMOKE_WIDTHS = (1, 3, 8, 17, 32)
# the telemetry leg's scrape cadence: one scrape a client an interval, 20-60x
# faster than a production Prometheus cadence (5-15 s)
SCRAPE_INTERVAL_S = 0.25
SCRAPER_THREAD = "anovos-torch-serve-scraper"
# repeats of the load in each overhead leg: a wall delta of a few percent
# needs legs of seconds, or the host's noise swamps it
OVERHEAD_REPS = 4


def _emit(doc: dict) -> None:
    sys.stdout.write(json.dumps(doc, sort_keys=True) + "\n")
    sys.stdout.flush()


def _runtime():
    """The runtime the caller set up, else the card's."""
    from anovos_tpu_torch.shared.runtime import get_runtime

    return get_runtime()


def _cmd_export(ns) -> int:
    import yaml

    from anovos_tpu_torch.data_ingest import data_ingest
    from anovos_tpu_torch.serving.bundle import fit_bundle, save_bundle

    _runtime()
    with open(ns.chain) as f:
        chain_spec = yaml.safe_load(f)
    idf = data_ingest.read_dataset(ns.data, ns.file_type)
    bundle = fit_bundle(idf, chain_spec, source=os.path.abspath(ns.data))
    version = save_bundle(bundle, ns.cache)
    _emit({"bundle_version": version, "cache_root": os.path.abspath(ns.cache),
           "stages": [s["family"] for s in bundle.chain], "input_columns": bundle.input_names})
    return 0


def smoke_payloads(src, n: int) -> list:
    """``n`` request payloads over consecutive rows of ``src``, widths
    cycling :data:`SMOKE_WIDTHS`."""
    from anovos_tpu_torch.serving.server import frame_to_payload

    payloads, off = [], 0
    for i in range(n):
        w = SMOKE_WIDTHS[i % len(SMOKE_WIDTHS)]
        if off + w > len(src):
            off = 0
        payloads.append({"columns": frame_to_payload(src.iloc[off:off + w])})
        off += w
    return payloads


def drive(server, payloads: list, clients: int, reps: int = 1) -> tuple:
    """``clients`` threads each send their share of ``payloads`` (client c
    the c-th of ``clients`` equal slices), ``reps`` times over; returns
    (wall s, the last rep's responses in payload order)."""
    per = len(payloads) // clients
    results: list = [None] * len(payloads)

    def client(cid: int) -> None:
        for _ in range(reps):
            for i in range(cid * per, (cid + 1) * per):
                results[i] = server.serve(payloads[i])

    threads = [threading.Thread(target=client, args=(c,), name=f"anovos-torch-serve-client-{c}")
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, results


def _cmd_smoke(ns) -> int:
    from anovos_tpu_torch.serving.bundle import load_bundle
    from anovos_tpu_torch.serving.demo import build_demo_bundle, demo_frame
    from anovos_tpu_torch.serving.program import ApplyProgram
    from anovos_tpu_torch.serving.server import FeatureServer, coerce_payload, frame_to_payload

    workdir = ns.workdir or tempfile.mkdtemp(prefix="anovos_serve_smoke_")
    cache = ns.cache or os.path.join(workdir, "cache")
    rt = _runtime()
    version = build_demo_bundle(cache, rows=ns.rows)

    # the server's boot: the measured cold start
    t_boot = time.perf_counter()
    bundle = load_bundle(cache, version)
    program = ApplyProgram(bundle)
    server = FeatureServer(program, obs_dir=workdir)
    server.start(warm=True)
    cold_start_s = round(time.perf_counter() - t_boot, 3)
    try:
        src = demo_frame(ns.rows, seed=11)[bundle.input_names]
        payloads = smoke_payloads(src, ns.clients * ns.requests)
        load_wall, results = drive(server, payloads, ns.clients)
        errors = [r for r in results if r is None or "error" in r]
        # parity sample: one request a width, byte-compared against the
        # batch apply of exactly those rows
        parity_ok = True
        for i in range(min(len(payloads), len(SMOKE_WIDTHS))):
            frame, err = coerce_payload(program.input_columns, payloads[i], server.max_batch)
            ref = frame_to_payload(program.apply_frame(frame))
            if err is not None or results[i] is None or results[i].get("columns") != ref:
                parity_ok = False
        # the serve_* figures describe the first load only, taken before the
        # telemetry legs push their own load through the same server
        stats = server.stats()
        telemetry_fields = _telemetry_leg(server, payloads, ns) if ns.telemetry else {}
    finally:
        server.close()
    _emit({
        **telemetry_fields,
        "serve_qps": round(len(payloads) / load_wall, 2),
        "serve_p50_ms": stats["p50_ms"],
        "serve_p99_ms": stats["p99_ms"],
        "serve_cold_start_s": cold_start_s,
        "serve_requests": len(payloads),
        "serve_clients": ns.clients,
        "serve_errors": len(errors),
        "serve_parity_ok": parity_ok,
        "serve_warm": program.warm_stats,
        "bundle_version": version,
        "backend": rt.device.type,
        "proc_wall_s": round(time.perf_counter() - _T0, 3),
    })
    return 0 if (parity_ok and not errors) else 1


def _telemetry_leg(server, payloads, ns) -> dict:
    """The live plane's overhead legs of the smoke, back to back:

    * A: the warm load x :data:`OVERHEAD_REPS` with the plane off (no
      listener thread);
    * B: the same load with the listener up and two scrapers polling
      ``/metrics`` and ``/healthz`` every :data:`SCRAPE_INTERVAL_S` over
      keep-alive connections; the A/B wall delta is
      ``telemetry_overhead_pct``;
    * C: the load once more with saturating back-to-back scrapers, for the
      scrape latency tail under serving load (``scrape_p99_ms``).

    A failed scrape lands as a count, not a dead smoke."""
    import http.client

    from anovos_tpu_torch.obs import telemetry

    scrape_lat: list = []
    scrape_failures = [0]
    port = [None]

    def scrape_loop(stop: threading.Event, interval: float, offset: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port[0], timeout=10)
        i = offset
        while not stop.is_set():
            path = "/metrics" if i % 2 == 0 else "/healthz"
            t0 = time.perf_counter()
            try:
                conn.request("GET", path)
                conn.getresponse().read()
                scrape_lat.append(time.perf_counter() - t0)
            except Exception:
                scrape_failures[0] += 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port[0], timeout=10)
            i += 1
            if interval and stop.wait(interval):
                break
        conn.close()

    def load_leg(n_scrapers: int, interval: float, reps: int = 1):
        stop = threading.Event()
        scrapers = [threading.Thread(target=scrape_loop, args=(stop, interval, k), name=SCRAPER_THREAD)
                    for k in range(n_scrapers)]
        for t in scrapers:
            t.start()
        try:
            wall, results = drive(server, payloads, ns.clients, reps)
        finally:
            stop.set()
            for t in scrapers:
                t.join()
        return wall, sum(1 for r in results if r is None or "error" in r)

    # A: the plane-off baseline.  Where ANOVOS_TPU_TELEMETRY is set the
    # server's start() already holds a listener, so the baseline is "the
    # listener idle", and it says so
    baseline_mode = "off" if telemetry.current() is None else "listener-idle"
    wall_off, errors_a = load_leg(0, 0.0, OVERHEAD_REPS)
    srv = telemetry.acquire(context="serve-smoke", port=0)
    if srv is None:
        return {"telemetry_error": "telemetry listener failed to bind"}
    try:
        port[0] = srv.port
        wall_on, errors_b = load_leg(2, SCRAPE_INTERVAL_S, OVERHEAD_REPS)
        cadence_scrapes = len(scrape_lat)
        scrape_lat.clear()
        _wall_c, errors_c = load_leg(2, 0.0)
        healthz_status = None
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
            conn.request("GET", "/healthz")
            healthz_status = json.loads(conn.getresponse().read().decode()).get("status")
            conn.close()
        except Exception as e:
            scrape_failures[0] += 1
            healthz_status = f"scrape failed: {type(e).__name__}"
    finally:
        telemetry.release(srv)
    lat = sorted(scrape_lat)
    pct = telemetry.RollingWindow._pct  # one percentile rule in the whole package
    overhead = max(0.0, (wall_on - wall_off) / wall_off * 100.0) if wall_off > 0 else None
    return {
        "telemetry_overhead_pct": None if overhead is None else round(overhead, 3),
        "telemetry_baseline": baseline_mode,
        "serve_wall_off_s": round(wall_off, 4),
        "serve_wall_on_s": round(wall_on, 4),
        "scrape_interval_s": SCRAPE_INTERVAL_S,
        "scrape_cadence_count": cadence_scrapes,
        "scrape_count": len(lat),
        "scrape_failures": scrape_failures[0],
        "scrape_p50_ms": pct(lat, 0.50),
        "scrape_p99_ms": pct(lat, 0.99),
        "healthz_status": healthz_status,
        "serve_errors_baseline_leg": errors_a,
        "serve_errors_with_telemetry": errors_b + errors_c,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m anovos_tpu_torch.serving",
                                 description="versioned feature bundles and online feature serving")
    sub = ap.add_subparsers(dest="cmd", required=True)

    exp = sub.add_parser("export", help="fit a chain, commit a versioned bundle")
    exp.add_argument("--data", required=True, help="input dataset path")
    exp.add_argument("--file-type", default="parquet", dest="file_type")
    exp.add_argument("--chain", required=True, help="YAML list of {name, config} transformer stages")
    exp.add_argument("--cache", required=True, help="CAS store root")
    exp.set_defaults(fn=_cmd_export)

    smk = sub.add_parser("smoke", help="end-to-end serve smoke load")
    smk.add_argument("--rows", type=int, default=2000)
    smk.add_argument("--clients", type=int, default=4)
    smk.add_argument("--requests", type=int, default=25, help="requests per client")
    smk.add_argument("--cache", help="CAS store root (default: <workdir>/cache)")
    smk.add_argument("--workdir", help="obs/flight destination (default: a new temporary directory)")
    smk.add_argument("--json", action="store_true", help="(always JSON; kept for symmetry)")
    smk.add_argument("--telemetry", action="store_true",
                     help="the load again with the live plane off, then on with scrapers attached; "
                          "emits telemetry_overhead_pct / scrape_p99_ms")
    smk.set_defaults(fn=_cmd_smoke)

    ns = ap.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
