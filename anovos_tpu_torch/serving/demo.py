"""Demo material and the serve-fault scenario of the serving subsystem
(counterpart of ``anovos_tpu/serving/demo.py``, with the port's copy of
the JAX package's ``tools/chaos_run.py`` ``serve-fault`` scenario).

One synthetic income-shaped dataset and one FULL-COVERAGE transformer
chain (every servable family fires at least once), shared by the
``python -m anovos_tpu_torch.serving smoke`` CLI, ``chip_smoke.py`` and
:func:`run_serve_fault`, which must agree on shape.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import List, Tuple

import numpy as np
import pandas as pd

__all__ = ["demo_frame", "DEMO_CHAIN", "build_demo_bundle", "SERVE_FAULT_SPEC", "run_serve_fault"]


def demo_frame(rows: int = 2000, seed: int = 7) -> pd.DataFrame:
    """Income-shaped synthetic rows with nulls in both planes."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "age": rng.normal(40, 9, rows).round(1),
        "fnlwgt": rng.normal(2e5, 4e4, rows).round(0),
        "hours": rng.integers(1, 99, rows).astype(float),
        "workclass": rng.choice(["private", "gov", "self", "never"], rows),
        "education": rng.choice(["hs", "college", "ba", "ms", "phd"], rows),
        "label": rng.choice(["0", "1"], rows),
    })
    df.loc[rng.choice(rows, rows // 20, replace=False), "age"] = np.nan
    df.loc[rng.choice(rows, rows // 25, replace=False), "workclass"] = None
    return df


# every servable family at least once; later stages consume earlier
# stages' outputs (fnlwgt_binned), so the chain's threading is exercised,
# not just each stage's state
DEMO_CHAIN: List[Tuple[str, dict]] = [
    ("imputation_MMM", {"list_of_cols": ["age", "workclass"], "method_type": "median"}),
    ("attribute_binning", {"list_of_cols": ["fnlwgt"], "bin_size": 8, "output_mode": "append"}),
    ("outlier_categories", {"list_of_cols": ["education"], "coverage": 0.9, "max_category": 5}),
    ("cat_to_num_supervised", {"list_of_cols": ["workclass"], "label_col": "label",
                               "event_label": "1", "output_mode": "append"}),
    ("cat_to_num_unsupervised", {"list_of_cols": ["workclass", "education"],
                                 "method_type": "label_encoding"}),
    ("z_standardization", {"list_of_cols": ["age"]}),
    ("IQR_standardization", {"list_of_cols": ["hours"], "output_mode": "append"}),
    ("normalization", {"list_of_cols": ["fnlwgt"]}),
    ("boxcox_transformation", {"list_of_cols": ["hours"]}),
    ("feature_transformation", {"list_of_cols": ["fnlwgt_binned"], "method_type": "sq",
                                "output_mode": "append"}),
]


def build_demo_bundle(cache_dir: str, rows: int = 2000, seed: int = 7) -> str:
    """Fit the demo chain on the runtime's device and commit the bundle;
    returns its version."""
    from anovos_tpu_torch.serving.bundle import fit_bundle, save_bundle
    from anovos_tpu_torch.shared.table import Table

    idf = Table.from_pandas(demo_frame(rows, seed))
    bundle = fit_bundle(idf, DEMO_CHAIN, source="serving-demo")
    return save_bundle(bundle, cache_dir)


# the serve-fault plan: the hang is listed FIRST, so the first batch
# attempt sleeps 0.5 s and then hits the exception; the retry hits the
# second exception, so that batch is fatal (a flight dump and structured
# errors) while every later batch serves normally
SERVE_FAULT_SPEC = "seed=7;hang@serve:apply:secs=0.5:n=1;exc@serve:apply:n=2"
SERVE_FAULT_P99_BOUND_MS = 10_000.0


def _flight_dumps(root: str) -> list:
    """(path, trigger, node) of every flight-recorder dump under ``root``."""
    out = []
    for p in sorted(glob.glob(os.path.join(root, "**", "flightrec_*.json"), recursive=True)):
        try:
            with open(p) as f:
                doc = json.load(f)
            out.append((p, doc.get("trigger", ""), doc.get("node", "")))
        except (OSError, ValueError):
            out.append((p, "<unreadable>", ""))
    return out


def run_serve_fault(workdir: str, rows: int = 1500) -> dict:
    """The online-serving fault gate.

    Clean leg: boot a server from the demo bundle, serve mixed-width
    requests, every response byte-identical to the batch apply, no flight
    dump.  Chaos leg: install :data:`SERVE_FAULT_SPEC`, lead with a victim
    request (hang and exception, the retry's exception: a fatal batch),
    then interleave clean and hostile requests.  Gates: the victim got a
    structured ``apply_failed`` error, a ``serve_fatal`` flight dump
    exists, the hostile payloads got structured quarantine responses,
    every clean response stayed byte-identical (no corrupted response),
    p99 stayed under :data:`SERVE_FAULT_P99_BOUND_MS`, the server went on
    serving, three injections fired, and the live plane answered every
    scrape: ``/healthz`` ok on the clean leg and degraded naming the failed
    batch on the chaos leg, two scrapes answered while the hang was in
    flight, the serving families in ``/metrics``.

    Runs on the runtime the caller set up (the card without one), in a
    process whose live plane reports ok (no degraded section, quarantined
    part, wedge or stale heartbeat left by earlier work: the gates read
    ``/healthz``); raises ``RuntimeError`` otherwise.  Leaves the chaos
    plan cleared, the flight recorder armed where it was before, and no
    thread, listener or provider of its own behind."""
    import urllib.error
    import urllib.request

    from anovos_tpu_torch.obs import flight, telemetry
    from anovos_tpu_torch.resilience import chaos
    from anovos_tpu_torch.serving.bundle import load_bundle
    from anovos_tpu_torch.serving.program import ApplyProgram
    from anovos_tpu_torch.serving.server import FeatureServer, coerce_payload, frame_to_payload
    from anovos_tpu_torch.shared.runtime import get_runtime

    get_runtime()
    before = telemetry.health()
    if before["status"] != "ok":
        raise RuntimeError(f"serve-fault needs a process whose /healthz is ok to start; it reports "
                           f"{before['status']}: {before['reasons']}")
    result = {"scenario": "serve-fault", "spec": SERVE_FAULT_SPEC}
    cache = os.path.join(workdir, "cache")
    version = build_demo_bundle(cache, rows=rows)
    bundle = load_bundle(cache, version)
    src = demo_frame(rows, seed=11)[bundle.input_names]
    widths = (1, 3, 8, 17)
    payloads, off = [], 0
    for i in range(16):
        w = widths[i % len(widths)]
        payloads.append({"columns": frame_to_payload(src.iloc[off:off + w])})
        off += w
    hostile = [
        {"columns": {**payloads[0]["columns"], "age": [float("inf")]}},
        {"columns": {**payloads[0]["columns"], "age": [1e39]}},
        {"columns": {**{k: v for k, v in payloads[0]["columns"].items() if k != "age"},
                     "bogus_col": [1.0]}},
        {"columns": {**payloads[0]["columns"], "age": ["not-a-number"]}},
    ]
    prior_flight = flight.destination()

    def reference(program, payload):
        frame, err = coerce_payload(program.input_columns, payload, 256)
        assert err is None, err
        return frame_to_payload(program.apply_frame(frame))

    def run_leg(leg: str, spec: str) -> dict:
        obs_dir = os.path.join(workdir, leg)
        os.makedirs(obs_dir, exist_ok=True)
        flight.configure(os.path.join(obs_dir, "obs"))
        # the live plane rides the leg on an ephemeral port: the gate
        # scrapes /metrics and /healthz WHILE the fault is in flight
        tele = telemetry.acquire(context=f"chaos-{leg}", port=0)
        scrape_failures = [0]
        server = None

        def scrape(path: str):
            """(status, body): a 503 is still a served scrape; only a dead
            or deaf listener counts as a failure."""
            if tele is None:
                scrape_failures[0] += 1
                return None, "telemetry listener failed to bind"
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{tele.port}{path}", timeout=10) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()
            except Exception as e:
                scrape_failures[0] += 1
                return None, f"{type(e).__name__}: {e}"

        try:
            program = ApplyProgram(load_bundle(cache, version))
            server = FeatureServer(program, obs_dir=obs_dir)
            t0 = time.monotonic()
            server.start(warm=True)
            # faults target steady-state serving: the plan lands after the
            # boot, so the warm probe is not the victim
            chaos.install(spec or None)
            out: dict = {"cold_start_s": round(time.monotonic() - t0, 3)}
            victim = None
            midfault_ok = 0
            if spec:
                # the victim from a side thread, scraped MID-FAULT: the 0.5 s
                # hang is in flight while /metrics and /healthz must answer
                box: list = []
                vt = threading.Thread(target=lambda: box.append(server.serve(payloads[-1])),
                                      name="anovos-torch-serve-fault-victim")
                vt.start()
                time.sleep(0.15)
                for path in ("/metrics", "/healthz"):
                    code, _body = scrape(path)
                    if code is not None:
                        midfault_ok += 1
                vt.join()
                victim = box[0] if box else None
            clean_bad, hostile_bad = [], []
            for i, p in enumerate(payloads[:12]):
                resp = server.serve(p)
                if "error" in resp or resp.get("columns") != reference(program, p):
                    clean_bad.append(i)
                if spec and i % 3 == 0:
                    if "error" not in server.serve(hostile[(i // 3) % len(hostile)]):
                        hostile_bad.append(i)
            _code, health_body = scrape("/healthz")
            try:
                health_doc = json.loads(health_body) if health_body else {}
            except ValueError:
                health_doc = {}
            _mcode, metrics_body = scrape("/metrics")
            stats = server.stats()
            server.close()
            plan = chaos.plan()
            out.update({
                "victim": victim,
                "clean_corrupted": clean_bad,
                "hostile_unrefused": hostile_bad,
                "stats": stats,
                "flightrec": [{"file": os.path.basename(p), "trigger": t, "node": n}
                              for p, t, n in _flight_dumps(obs_dir)],
                "injections": plan.injection_count() if plan else 0,
                "midfault_scrapes_ok": midfault_ok,
                "scrape_failures": scrape_failures[0],
                "healthz_status": health_doc.get("status"),
                "healthz_reasons": health_doc.get("reasons", []),
                "metrics_has_serve_families": bool(metrics_body and "serve_batches_total" in metrics_body
                                                   and "serve_rolling_qps" in metrics_body),
            })
            return out
        finally:
            # a leg that dies mid-body leaks neither the batcher, the
            # listener, the chaos plan nor the recorder's arming
            if server is not None:
                server.close()
            telemetry.release(tele)
            chaos.reset()
            flight.configure(prior_flight)

    clean = run_leg("clean", "")
    result.update({"clean_flightrec": len(clean["flightrec"]), "clean_corrupted": clean["clean_corrupted"],
                   "clean_p99_ms": clean["stats"]["p99_ms"], "clean_wall_s": clean["cold_start_s"],
                   "clean_healthz": clean["healthz_status"],
                   "clean_scrape_failures": clean["scrape_failures"]})
    leg = run_leg("chaos", SERVE_FAULT_SPEC)
    result.update({"injections": leg["injections"], "chaos_p99_ms": leg["stats"]["p99_ms"],
                   "chaos_corrupted": leg["clean_corrupted"], "hostile_unrefused": leg["hostile_unrefused"],
                   "flightrec": leg["flightrec"], "quarantined": leg["stats"]["quarantined"],
                   "served_after_fatal": leg["stats"]["served"],
                   "midfault_scrapes_ok": leg["midfault_scrapes_ok"],
                   "chaos_scrape_failures": leg["scrape_failures"], "chaos_healthz": leg["healthz_status"],
                   "chaos_healthz_reasons": leg["healthz_reasons"], "chaos_cold_start_s": leg["cold_start_s"]})

    victim_ok = ((leg["victim"] or {}).get("error") or {}).get("code") == "apply_failed"
    fatal_dumped = any(d["trigger"] == "serve_fatal" for d in leg["flightrec"])
    health_flipped = (leg["healthz_status"] == "degraded"
                      and any("serving" in r and "failed after retry" in r for r in leg["healthz_reasons"]))
    telemetry_ok = (clean["healthz_status"] == "ok" and clean["scrape_failures"] == 0
                    and clean["metrics_has_serve_families"] and leg["scrape_failures"] == 0
                    and leg["midfault_scrapes_ok"] >= 2 and health_flipped)
    bounded = (leg["stats"]["p99_ms"] or np.inf) <= SERVE_FAULT_P99_BOUND_MS
    served_on = leg["stats"]["served"] >= 12
    result.update({"telemetry_ok": telemetry_ok, "p99_bound_ms": SERVE_FAULT_P99_BOUND_MS,
                   "parity": not (clean["clean_corrupted"] or leg["clean_corrupted"])})
    gates = {
        "parity": result["parity"],
        "victim_apply_failed": victim_ok,
        "serve_fatal_dumped": fatal_dumped,
        "p99_bounded": bounded,
        "telemetry": telemetry_ok,
        "hostile_refused": not leg["hostile_unrefused"],
        "served_after_fatal": served_on,
        "three_injections": result["injections"] >= 3,
        "clean_leg_no_dump": result["clean_flightrec"] == 0,
    }
    result["gates"] = gates
    result["ok"] = all(gates.values())
    if not result["ok"]:
        reasons = [name for name, passed in gates.items() if not passed]
        if not health_flipped:
            reasons.append(f"/healthz {leg['healthz_status']!r}: {leg['healthz_reasons']}")
        if not victim_ok:
            reasons.append(f"victim {leg['victim']}")
        result["error"] = "failed gates: " + "; ".join(reasons)
    return result
