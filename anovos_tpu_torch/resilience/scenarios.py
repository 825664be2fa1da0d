"""Workflow chaos scenarios: run a config clean and under fault injection,
and verify the recovery (the port's copy of ``tools/chaos_run.py``'s
``exc``, ``hang``, ``wedge`` and ``full`` scenarios and their gates).

    python -m anovos_tpu_torch.resilience.scenarios --scenario full [--json]
        [--workdir DIR] [--device cuda|cpu]

A scenario runs ``workflow.main`` on :func:`synthetic_config` (whose
nodes cover every site: the stats fan-out, the quality spine, drift)
once clean and once under its ``ANOVOS_TPU_CHAOS`` plan, both in the
concurrent mode, the chaos run under a ``NODE_TIMEOUT`` of 5 s (so that a
hang escalates quickly), and passes when

* the chaos run completes (no injected fault escaped recovery);
* its artifact tree (``obs/`` left out) has the parity below;
* the manifest's ``resilience`` section books the expected recovery
  (retries for ``exc``, an escalation and a timeout re-execution for
  ``hang``, a backend failover for ``wedge``), nothing degraded, the
  plan fired, and the expected flight dumps name their nodes and lanes,
  while the clean run dumps nothing.

Parity.  On the CPU both runs compute on one device and the gate is the
JAX package's: the chaos tree is byte-equal to the clean tree.  On the
card a ``wedge`` flips the runtime to the CPU mid-run, and the nodes that
run after the flip compute on the CPU.  Each file of the chaos tree must
then be byte-equal to the clean card run's copy, or, when a node that ran
after the flip wrote it (or the runner wrote it after the run: the final
dataset), to the copy of a clean run of the port on the CPU
(``init_runtime("cpu")``).  The chaos run keeps a node cache in
``<workdir>/chaos_cache`` so that its run journal names those nodes (a
``node_begin`` after the ``backend_failover`` record) and the store names
their files; ``cpu_parity_files`` counts the files the second rule took.
A scenario leaves the process on the runtime it found.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import fnmatch
import glob
import hashlib
import json
import os
import pathlib
import sys
import tempfile
import time
from typing import Dict, Optional

SCENARIOS = {
    "exc": "seed=7;exc@node:stats_generator/*",
    "hang": "seed=7;hang@node:quality_checker/*:secs=600",
    "wedge": "seed=7;wedge@node:drift_detector/*",
    "full": ("seed=7;exc@node:stats_generator/*;"
             "hang@node:quality_checker/*:secs=600;"
             "wedge@node:drift_detector/*"),
}

# manifest resilience counters that must be > 0 a scenario
EXPECT = {
    "exc": ("retries",),
    "hang": ("timeout_escalations", "timeout_retries"),
    "wedge": ("failovers",),
    "full": ("retries", "timeout_escalations", "timeout_retries", "failovers"),
}

# the flight dumps the chaos run must write, as (trigger, node glob); a
# clean run writes none
EXPECT_FLIGHT = {
    "exc": (),  # an absorbed retry is not a postmortem trigger
    "hang": (("timeout_escalation", "quality_checker/*"),),
    "wedge": (("backend_failover", "drift_detector/*"),),
    "full": (("timeout_escalation", "quality_checker/*"),
             ("backend_failover", "drift_detector/*")),
}

# the chaos run's ANOVOS_TPU_NODE_TIMEOUT (the clean runs get 600 s)
NODE_TIMEOUT = "5"

# the knobs a leg sets, unset or restores around workflow.main
_LEG_KNOBS = ("ANOVOS_TPU_CHAOS", "ANOVOS_TPU_EXECUTOR", "ANOVOS_TPU_NODE_TIMEOUT", "ANOVOS_TPU_CACHE",
              "ANOVOS_TPU_FLIGHTREC")


def flight_dumps(root) -> list:
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


def _artifacts(root):
    root = pathlib.Path(root)
    for p in sorted(root.rglob("*")):
        if p.is_file() and "obs" not in p.parts:
            yield str(p.relative_to(root)), p


def tree_hash(root) -> str:
    """sha256 over (relpath, bytes) of every artifact; the ``obs/``
    telemetry varies from run to run by design and is left out."""
    h = hashlib.sha256()
    for rel, p in _artifacts(root):
        h.update(rel.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def tree_files(root) -> Dict[str, str]:
    """{relpath: sha256 of its bytes} of every artifact (``obs/`` left out)."""
    return {rel: hashlib.sha256(p.read_bytes()).hexdigest() for rel, p in _artifacts(root)}


def synthetic_config(workdir: str) -> dict:
    """A small self-contained config whose node set covers every scenario
    site (stats fan-out, quality spine, drift), on the JAX gate's 1,500
    rows, written once under ``workdir/data``."""
    import numpy as np
    import pandas as pd

    data = os.path.join(workdir, "data")
    if not os.path.isdir(data):
        os.makedirs(data)
        rng = np.random.default_rng(7)
        df = pd.DataFrame({
            "age": rng.normal(40, 9, 1500).round(1),
            "fnlwgt": rng.normal(2e5, 4e4, 1500).round(0),
            "workclass": rng.choice(["private", "gov", "self"], 1500),
            "income": rng.choice(["<=50K", ">50K"], 1500),
        })
        df.to_parquet(os.path.join(data, "part-0.parquet"), index=False)
    return {
        "input_dataset": {"read_dataset": {"file_path": data, "file_type": "parquet"}},
        "stats_generator": {
            "metric": ["global_summary", "measures_of_counts", "measures_of_cardinality"],
            "metric_args": {"list_of_cols": "all", "drop_cols": []},
        },
        "quality_checker": {
            "duplicate_detection": {"list_of_cols": "all", "drop_cols": [], "treatment": True},
            "IDness_detection": {"list_of_cols": "all", "drop_cols": [], "treatment": True,
                                 "treatment_threshold": 0.9},
        },
        "drift_detector": {"drift_statistics": {
            "configs": {"list_of_cols": "all", "drop_cols": [], "method_type": "PSI", "threshold": 0.1},
            "source_dataset": {"read_dataset": {"file_path": data, "file_type": "parquet"}},
        }},
        "report_preprocessing": {"master_path": "report_stats"},
        "write_main": {"file_path": "output", "file_type": "parquet", "file_configs": {"mode": "overwrite"}},
    }


@contextlib.contextmanager
def _knobs(values: dict):
    """Set (a value) or unset (None) each of ``_LEG_KNOBS`` for the block,
    and put every one back after it."""
    saved = {k: os.environ.get(k) for k in _LEG_KNOBS}
    try:
        for k in _LEG_KNOBS:
            if values.get(k) is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = values[k]
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_leg(cfg: dict, rundir: str, chaos_spec: str, node_timeout: str, cache_dir: Optional[str] = None) -> dict:
    """One ``workflow.main`` run in ``rundir`` in the concurrent mode (the
    flight recorder armed, ``cache_dir`` the node cache or none); returns
    its manifest."""
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.obs import load_manifest

    os.makedirs(rundir, exist_ok=True)
    prev_cwd = os.getcwd()
    # the flight gate needs the recorder armed: an ambient
    # ANOVOS_TPU_FLIGHTREC=0 would fail it spuriously
    with _knobs({"ANOVOS_TPU_CHAOS": chaos_spec or None, "ANOVOS_TPU_EXECUTOR": "concurrent",
                 "ANOVOS_TPU_NODE_TIMEOUT": node_timeout, "ANOVOS_TPU_CACHE": cache_dir}):
        try:
            os.chdir(rundir)
            workflow.main(copy.deepcopy(cfg), "local")
            return load_manifest(workflow.LAST_MANIFEST_PATH)
        finally:
            os.chdir(prev_cwd)


def post_flip_files(rundir: str, cache_dir: str, config: Optional[dict] = None) -> dict:
    """The nodes of a run in ``rundir`` that began an attempt after its
    ``backend_failover`` journal record, and the artifact files (relative
    to ``rundir``) the node cache in ``cache_dir`` committed for them, with
    the final dataset of ``config``'s ``write_main``, which the runner
    writes after the last node from the df version the last spine node
    produced: ``{"nodes": [...], "files": [...]}``.  Empty without a
    flip."""
    from anovos_tpu_torch.cache import CacheStore, read_journal

    paths = glob.glob(os.path.join(rundir, "**", "obs", "run_journal.jsonl"), recursive=True)
    records = read_journal(paths[0]) if paths else []
    begins = [i for i, r in enumerate(records) if r.get("event") == "run_begin"]
    records = records[begins[-1]:] if begins else records
    flip = next((i for i, r in enumerate(records) if r.get("event") == "backend_failover"), None)
    if flip is None:
        return {"nodes": [], "files": []}
    nodes = sorted({r["node"] for r in records[flip:] if r.get("event") == "node_begin"})
    store = CacheStore(cache_dir)
    files = set()
    for r in records[flip:]:
        if r.get("event") == "node_commit" and r.get("node") in nodes:
            manifest = store.lookup(r["fp"]) or {}
            for e in manifest.get("files", ()):
                p = e["path"] if not e.get("portable") else os.path.join(rundir, e["path"])
                files.add(os.path.relpath(p, rundir))
    final = ((config or {}).get("write_main") or {}).get("file_path")
    if final:
        files.update(rel for rel, _ in _artifacts(rundir)
                     if rel.startswith(os.path.join(final, "final_dataset") + os.sep))
    return {"nodes": nodes, "files": sorted(files)}


def parity(chaos: Dict[str, str], card: Dict[str, str], cpu: Optional[Dict[str, str]] = None,
           post_flip=()) -> dict:
    """The per-file parity of a chaos tree (``tree_files``) against the
    clean run on its device and, for the files in ``post_flip``, the clean
    CPU run: ``{"parity", "cpu_parity_files", "differ"}``."""
    post_flip = set(post_flip)
    differ, on_cpu = [], 0
    for rel in sorted(set(chaos) | set(card)):
        if chaos.get(rel) is not None and chaos.get(rel) == card.get(rel):
            continue
        if cpu is not None and rel in post_flip and chaos.get(rel) is not None and chaos.get(rel) == cpu.get(rel):
            on_cpu += 1
            continue
        differ.append(rel)
    return {"parity": not differ, "cpu_parity_files": on_cpu, "differ": differ}


def run_scenario(scenario: str, workdir: str) -> dict:
    """Clean and chaos runs, the parity and counter checks; the result
    record (``ok`` and a field a check) without exiting.  On the card a
    clean CPU run of the port is the second parity reference."""
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime

    cfg = synthetic_config(workdir)
    chaos_spec = SCENARIOS[scenario]
    result = {"scenario": scenario, "spec": chaos_spec}
    device = get_runtime().device
    result["device"] = str(device)
    # the clean runs get a generous bound, so that a slow node on a loaded
    # host neither escalates nor dumps
    clean_timeout = "600"
    try:
        t0 = time.monotonic()
        clean_manifest = run_leg(cfg, os.path.join(workdir, "clean"), "", clean_timeout)
        result["clean_wall_s"] = round(time.monotonic() - t0, 3)
        result["clean_quarantined_parts"] = (
            ((clean_manifest.get("resilience") or {}).get("quarantine") or {}).get("parts", 0))
        card_tree = tree_files(os.path.join(workdir, "clean"))
        result["clean_flightrec"] = len(flight_dumps(os.path.join(workdir, "clean")))
        cpu_tree = None
        if device.type == "cuda":
            init_runtime("cpu")
            try:
                t0 = time.monotonic()
                run_leg(cfg, os.path.join(workdir, "clean_cpu"), "", clean_timeout)
                result["clean_cpu_wall_s"] = round(time.monotonic() - t0, 3)
            finally:
                init_runtime(device)
            cpu_tree = tree_files(os.path.join(workdir, "clean_cpu"))
            result["clean_flightrec"] += len(flight_dumps(os.path.join(workdir, "clean_cpu")))
        t0 = time.monotonic()
        cache_dir = os.path.join(workdir, "chaos_cache")
        try:
            manifest = run_leg(cfg, os.path.join(workdir, "chaos"), chaos_spec, NODE_TIMEOUT, cache_dir=cache_dir)
        except Exception as e:
            result["ok"] = False
            result["error"] = f"chaos run DIED (recovery failed): {type(e).__name__}: {e}"
            return result
        result["chaos_wall_s"] = round(time.monotonic() - t0, 3)
        result["runtime_after"] = str(get_runtime().device)
    finally:
        if get_runtime().device != device:
            init_runtime(device)
    res = manifest.get("resilience") or {}
    result["resilience"] = {k: v for k, v in res.items() if k != "chaos"}
    result["injections"] = (res.get("chaos") or {}).get("injections", 0)
    result["failovers"] = res.get("failovers", 0)
    flipped = post_flip_files(os.path.join(workdir, "chaos"), cache_dir, cfg)
    result["post_flip_nodes"] = flipped["nodes"]
    par = parity(tree_files(os.path.join(workdir, "chaos")), card_tree, cpu_tree, flipped["files"])
    result.update(par)
    missing = [k for k in EXPECT.get(scenario, ()) if not res.get(k)]
    result["missing_counters"] = missing
    result["degraded"] = sorted(set(res.get("degraded") or []) | set((res.get("degraded_sections") or {}).keys()))
    quar = res.get("quarantine") or {}
    result["quarantined_parts"] = quar.get("parts", 0)
    quarantine_ok = result["clean_quarantined_parts"] == 0 and result["quarantined_parts"] == 0
    dumps = flight_dumps(os.path.join(workdir, "chaos"))
    result["flightrec"] = [{"file": os.path.basename(p), "trigger": trig, "node": node} for p, trig, node in dumps]
    flight_missing = [f"{trig}@{pat}" for trig, pat in EXPECT_FLIGHT.get(scenario, ())
                      if not any(t == trig and fnmatch.fnmatchcase(n, pat) for _, t, n in dumps)]
    result["flightrec_missing"] = flight_missing
    # each dump names its node's lane among the in-flight nodes
    lanes_ok = True
    if EXPECT_FLIGHT.get(scenario, ()):
        lanes_ok = False
        for p, _, node in dumps:
            try:
                with open(p) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if any(e.get("node") == node and e.get("lane") for e in doc.get("inflight", [])):
                lanes_ok = True
        result["flightrec_lanes_ok"] = lanes_ok
    result["ok"] = bool(result["parity"] and not missing and not result["degraded"] and quarantine_ok
                        and result["injections"] > 0 and not flight_missing and lanes_ok
                        and result["clean_flightrec"] == 0)
    if not result["ok"]:
        reasons = []
        if not result["parity"]:
            reasons.append(f"artifacts differ from the clean runs: {result['differ'][:8]}")
        if missing:
            reasons.append(f"expected recovery counters missing: {missing}")
        if result["degraded"]:
            reasons.append(f"degraded sections {result['degraded']}")
        if not quarantine_ok:
            reasons.append("a leg quarantined input parts")
        if result["injections"] == 0:
            reasons.append("chaos plan fired nothing (site names drifted?)")
        if flight_missing:
            reasons.append(f"expected flight-recorder dump(s) missing: {flight_missing} "
                           f"(got {result['flightrec']})")
        if not lanes_ok:
            reasons.append("flight dumps carry no lane for the triggering node")
        if result["clean_flightrec"]:
            reasons.append(f"{result['clean_flightrec']} flight-recorder dump(s) on a clean run")
        result["error"] = "; ".join(reasons)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a config under a chaos scenario; exit nonzero unless "
                                             "recovery and artifact parity hold")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="full")
    ap.add_argument("--workdir", help="run directory (default: a fresh temporary directory)")
    ap.add_argument("--device", default="cuda", help="the runtime's device (default cuda; cpu to run there)")
    ap.add_argument("--json", action="store_true", help="print the result as one JSON object")
    ns = ap.parse_args(argv)

    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime(ns.device)
    workdir = ns.workdir or tempfile.mkdtemp(prefix="anovos_chaos_")
    result = run_scenario(ns.scenario, workdir)
    if ns.json:
        print(json.dumps(result, sort_keys=True))
    else:
        print(f"scenarios[{ns.scenario}]: {'OK' if result['ok'] else 'FAIL'} — "
              f"injections={result.get('injections')} parity={result.get('parity')} "
              f"resilience={result.get('resilience')}")
        if not result["ok"]:
            print("scenarios: " + result.get("error", "unknown failure"), file=sys.stderr)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
