"""Chaos scenarios: run a config clean and under fault injection, and
verify the recovery (the port's copy of ``tools/chaos_run.py``: every
scenario and gate there but ``hang-collective``).

    python -m anovos_tpu_torch.resilience.scenarios --scenario full [--json]
        [--workdir DIR] [--device cuda|cpu] [--config cfg.yaml]
        [--spec SPEC] [--node-timeout SECS]

The workflow scenarios (``exc``, ``hang``, ``wedge``, ``full``,
``corrupt-ingest``) run ``workflow.main`` on :func:`synthetic_config`
(whose nodes cover every site: the stats fan-out, the quality spine,
drift; ``corrupt-ingest`` splits its rows into four part files) once
clean and once under the scenario's ``ANOVOS_TPU_CHAOS`` plan, both in
the concurrent mode, the chaos run under a ``NODE_TIMEOUT`` of 5 s (so
that a hang escalates quickly), and pass when

* the chaos run completes (no injected fault escaped recovery);
* its artifact tree (``obs/`` left out) has the parity below, unless the
  scenario is one of :data:`EXPECT_DEGRADED`, whose degraded sections'
  artifacts are absent by design: then the chaos wall must stay within
  2 x the clean wall + 90 s instead;
* the manifest's ``resilience`` section books the expected recovery
  (retries for ``exc``, an escalation and a timeout re-execution for
  ``hang``, a backend failover for ``wedge``), exactly the degraded
  sections of :data:`EXPECT_DEGRADED`, exactly the quarantine records of
  :data:`EXPECT_QUARANTINE` (in the manifest and in the on-disk
  ``quarantine_manifest.json``) and none on the clean leg, the plan
  fired, and the expected flight dumps name their nodes and lanes, while
  the clean run dumps nothing.

Three scenarios run no workflow: ``serve-fault`` (the serving gate,
``serving/demo.run_serve_fault``), ``slowread-stream``
(:func:`run_slowread_stream`: the prefetch pool absorbs six slow parts of
eight) and ``feed-30d`` (:func:`run_feed_30d`: the continuum's day-by-day
leg byte-equal to a batch leg over the 30-day feed of
``resilience/feed.py``).  ``hang-collective`` needs a mesh of several
devices and raises :class:`NotImplementedError`.

Parity.  On the CPU both runs compute on one device and the gate is the
JAX package's: the chaos tree is byte-equal to the clean tree.  On the
card a ``wedge`` flips the runtime to the CPU mid-run, and the nodes that
run after the flip compute on the CPU.  Each file of the chaos tree must
then be byte-equal to the clean card run's copy, or, when a node that ran
after the flip wrote it (or the runner wrote it after the run: the final
dataset), to the copy of a clean run of the port on the CPU
(``init_runtime("cpu")``), which runs only for a plan that holds a
``wedge``.  The chaos run keeps a node cache in ``<workdir>/chaos_cache``
so that its run journal names those nodes (a ``node_begin`` after the
``backend_failover`` record) and the store names their files;
``cpu_parity_files`` counts the files the second rule took.  A scenario
leaves the process on the runtime it found, with no chaos plan, no
quarantine record, no degraded section and the flight recorder disarmed.
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
import shutil
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
    # a collective (mesh-placed) node hangs on every attempt on a mesh of
    # several devices; the port has no mesh yet (ROADMAP.md Queue A)
    "hang-collective": "seed=7;hang@node:drift_detector/*:secs=600:n=99",
    # the data plane: two of the four input parts fail to decode on every
    # attempt (a 'corrupt' and a 'truncate', two error classes in the
    # quarantine manifest), a third reads slowly.  The ingest guard
    # retries, quarantines exactly those two parts with their row counts,
    # and the run completes degraded over the surviving rows
    "corrupt-ingest": ("seed=7;corrupt@io:*part-00001.parquet:n=99;"
                       "truncate@io:*part-00002.parquet:n=99;"
                       "slowread@io:*part-00003.parquet:secs=0.2"),
    # online serving: the hang first, so that the first batch attempt
    # sleeps 0.5 s and then meets the exception, its retry the second one
    "serve-fault": ("seed=7;hang@serve:apply:secs=0.5:n=1;"
                    "exc@serve:apply:n=2"),
    # streaming ingest: six of eight parts read slowly (0.6 s a read, both
    # describe passes: 7.2 s of serial decode), which the prefetch pool
    # must absorb
    "slowread-stream": "seed=7;slowread@io:*part-0000[0-5].parquet:secs=0.6:n=99",
    # the continuum: no plan, the faults are in the 30-day feed itself
    # (resilience/feed.py)
    "feed-30d": "",
}

# the input part files a scenario's synthetic data is split into
SCENARIO_PARTS = {"corrupt-ingest": 4}

# the exact quarantine records (basename -> rows lost) a scenario's chaos
# run must write; every clean run quarantines nothing
EXPECT_QUARANTINE = {
    "corrupt-ingest": {"part-00001.parquet": 375, "part-00002.parquet": 375},
}

# manifest resilience counters that must be > 0 a scenario
EXPECT = {
    "exc": ("retries",),
    "hang": ("timeout_escalations", "timeout_retries"),
    "wedge": ("failovers",),
    "full": ("retries", "timeout_escalations", "timeout_retries", "failovers"),
    "hang-collective": ("timeout_escalations", "timeout_retries"),
    "corrupt-ingest": (),  # the recovery is below the scheduler: the
                           # quarantine gate is the check
}

# the scenarios whose faults exhaust recovery by design: exactly these
# sections degrade, parity is waived (their artifacts are absent) and the
# chaos wall is bounded by the clean wall instead
EXPECT_DEGRADED = {
    "hang-collective": ("drift_detector/drift_statistics",),
    "corrupt-ingest": ("ingest/part-00001.parquet", "ingest/part-00002.parquet"),
}

# the scenarios that need a mesh of several devices
REQUIRE_MULTIDEV = {"hang-collective"}

# the flight dumps the chaos run must write, as (trigger, node glob); a
# clean run writes none
EXPECT_FLIGHT = {
    "exc": (),  # an absorbed retry is not a postmortem trigger
    "hang": (("timeout_escalation", "quality_checker/*"),),
    "wedge": (("backend_failover", "drift_detector/*"),),
    "full": (("timeout_escalation", "quality_checker/*"),
             ("backend_failover", "drift_detector/*")),
    "hang-collective": (("timeout_escalation", "drift_detector/*"),
                        ("node_abandoned", "drift_detector/*")),
    "corrupt-ingest": (),  # a quarantined part is degradation, not a postmortem
}

# what a scenario that needs a mesh raises
MULTIDEV_MISSING = ("scenario {!r} needs a mesh of several devices, which the port does not have yet: "
                    "ROADMAP.md Queue A, Multi-device and multi-host")

# slowread-stream: the parts, their rows, the slow parts and their delay,
# the decode workers; the chaos wall may exceed the clean wall by at most
# SLOWREAD_SHARE of the serial penalty
SLOWREAD_PARTS = 8
SLOWREAD_ROWS = 2048
SLOWREAD_SLOW_PARTS = 6
SLOWREAD_SECS = 0.6
SLOWREAD_WORKERS = "4"
SLOWREAD_SHARE = 0.6

# feed-30d's size (the JAX gate's) and the most day 30's fold may take as
# a multiple of day 2's
FEED_DAYS = 30
FEED_ROWS_PER_DAY = 500
FEED_FOLD_RATIO = 2.0

# the chaos run's default ANOVOS_TPU_NODE_TIMEOUT (the clean runs get at
# least 600 s)
NODE_TIMEOUT = "5"


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


def synthetic_config(workdir: str, parts: int = 1) -> dict:
    """A small self-contained config whose node set covers every scenario
    site (stats fan-out, quality spine, drift), on the JAX gate's 1,500
    rows, written once under ``workdir/data``, or split into ``parts``
    part files ``part-{i:05d}.parquet`` under ``workdir/data{parts}``."""
    import numpy as np
    import pandas as pd

    data = os.path.join(workdir, "data" if parts == 1 else f"data{parts}")
    if not os.path.isdir(data):
        os.makedirs(data)
        rng = np.random.default_rng(7)
        df = pd.DataFrame({
            "age": rng.normal(40, 9, 1500).round(1),
            "fnlwgt": rng.normal(2e5, 4e4, 1500).round(0),
            "workclass": rng.choice(["private", "gov", "self"], 1500),
            "income": rng.choice(["<=50K", ">50K"], 1500),
        })
        if parts == 1:
            df.to_parquet(os.path.join(data, "part-0.parquet"), index=False)
        else:
            for i, idx in enumerate(np.array_split(np.arange(len(df)), parts)):
                df.iloc[idx].to_parquet(os.path.join(data, f"part-{i:05d}.parquet"), index=False)
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


def survivors_config(workdir: str, dest: str) -> dict:
    """``corrupt-ingest``'s synthetic config (its parts under ``workdir``)
    over a copy in ``dest`` of only the parts that its plan leaves readable
    (none of :data:`EXPECT_QUARANTINE`'s): the clean run whose tree its
    chaos run's must equal, as quarantine takes out exactly the lost rows."""
    cfg = synthetic_config(workdir, parts=SCENARIO_PARTS["corrupt-ingest"])
    src = cfg["input_dataset"]["read_dataset"]["file_path"]
    os.makedirs(dest, exist_ok=True)
    for name in sorted(os.listdir(src)):
        if name not in EXPECT_QUARANTINE["corrupt-ingest"]:
            shutil.copy2(os.path.join(src, name), os.path.join(dest, name))
    cfg["input_dataset"]["read_dataset"]["file_path"] = dest
    cfg["drift_detector"]["drift_statistics"]["source_dataset"]["read_dataset"]["file_path"] = dest
    return cfg


@contextlib.contextmanager
def _knobs(values: dict):
    """Set (a value) or unset (None) each environment knob of ``values``
    for the block, and put every one back after it."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k in values:
            if values[k] is None:
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
                 "ANOVOS_TPU_NODE_TIMEOUT": node_timeout, "ANOVOS_TPU_CACHE": cache_dir,
                 "ANOVOS_TPU_FLIGHTREC": None}):
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


def reset_planes(disarm: bool = True) -> None:
    """No chaos plan, quarantine record or degraded section left, the
    flight recorder disarmed (unless not ``disarm``): what a scenario
    leaves behind."""
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import chaos, policy

    chaos.reset()
    guard.reset()
    policy.reset_degraded()
    if disarm:
        flight.reset()


def _quarantine_check(scenario: str, quar: dict, chaos_dir: str, result: dict) -> bool:
    """The data-plane gate of a chaos leg: exactly the records of
    :data:`EXPECT_QUARANTINE` (none for another scenario), in the manifest
    and in the on-disk ``quarantine_manifest.json``."""
    expected = EXPECT_QUARANTINE.get(scenario)
    if expected is None:
        return result["quarantined_parts"] == 0
    got = {os.path.basename(r["file"]): r["rows_lost"] for r in quar.get("records", [])}
    result["quarantine_records"] = got
    ok = got == expected
    on_disk = glob.glob(os.path.join(chaos_dir, "**", "quarantine_manifest.json"), recursive=True)
    if not on_disk:
        result["quarantine_manifest_missing"] = True
        return False
    with open(on_disk[0]) as f:
        disk = {os.path.basename(r["file"]): r["rows_lost"] for r in json.load(f).get("records", [])}
    if disk != expected:
        result["quarantine_disk_records"] = disk
        ok = False
    return ok


def run_scenario(scenario: str, workdir: str, config: Optional[dict] = None, spec: Optional[str] = None,
                 node_timeout: str = NODE_TIMEOUT) -> dict:
    """Clean and chaos runs of ``config`` (default: :func:`synthetic_config`)
    under ``spec`` (default: the scenario's plan), the parity, quarantine,
    degradation and counter checks; the result record (``ok`` and a field a
    check) without exiting.  On the card, for a plan that holds a
    ``wedge``, a clean CPU run of the port is the second parity
    reference."""
    from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime

    if scenario in REQUIRE_MULTIDEV:
        raise NotImplementedError(MULTIDEV_MISSING.format(scenario))
    cfg = config if config is not None else synthetic_config(workdir, parts=SCENARIO_PARTS.get(scenario, 1))
    chaos_spec = spec if spec is not None else SCENARIOS[scenario]
    result = {"scenario": scenario, "spec": chaos_spec}
    device = get_runtime().device
    result["device"] = str(device)
    # the clean runs get a generous bound, so that a slow node on a loaded
    # host neither escalates nor dumps
    clean_timeout = str(max(float(node_timeout), 600.0))
    try:
        t0 = time.monotonic()
        clean_manifest = run_leg(cfg, os.path.join(workdir, "clean"), "", clean_timeout)
        result["clean_wall_s"] = round(time.monotonic() - t0, 3)
        result["clean_quarantined_parts"] = (
            ((clean_manifest.get("resilience") or {}).get("quarantine") or {}).get("parts", 0))
        card_tree = tree_files(os.path.join(workdir, "clean"))
        result["clean_flightrec"] = len(flight_dumps(os.path.join(workdir, "clean")))
        cpu_tree = None
        if device.type == "cuda" and "wedge@" in chaos_spec:
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
            manifest = run_leg(cfg, os.path.join(workdir, "chaos"), chaos_spec, node_timeout, cache_dir=cache_dir)
        except Exception as e:
            result["ok"] = False
            result["error"] = f"chaos run DIED (recovery failed): {type(e).__name__}: {e}"
            return result
        result["chaos_wall_s"] = round(time.monotonic() - t0, 3)
        result["runtime_after"] = str(get_runtime().device)
    finally:
        if get_runtime().device != device:
            init_runtime(device)
        reset_planes()
    res = manifest.get("resilience") or {}
    result["resilience"] = {k: v for k, v in res.items() if k != "chaos"}
    result["injections"] = (res.get("chaos") or {}).get("injections", 0)
    result["failovers"] = res.get("failovers", 0)
    expected_degraded = sorted(EXPECT_DEGRADED.get(scenario, ()))
    flipped = post_flip_files(os.path.join(workdir, "chaos"), cache_dir, cfg)
    result["post_flip_nodes"] = flipped["nodes"]
    par = parity(tree_files(os.path.join(workdir, "chaos")), card_tree, cpu_tree, flipped["files"])
    result.update(par)
    # a scenario that degrades by design waives parity: its degraded
    # sections' artifacts are absent from the chaos tree
    if expected_degraded:
        result["parity"] = True
    missing = [k for k in EXPECT.get(scenario, ()) if not res.get(k)]
    result["missing_counters"] = missing
    # the scheduler's degraded nodes and the registry's degraded sections
    # (quarantined parts, best-effort fallbacks)
    result["degraded"] = sorted(set(res.get("degraded") or []) | set((res.get("degraded_sections") or {}).keys()))
    degraded_ok = result["degraded"] == expected_degraded
    quar = res.get("quarantine") or {}
    result["quarantined_parts"] = quar.get("parts", 0)
    result["quarantine_rows"] = quar.get("rows_lost", 0)
    quarantine_ok = (result["clean_quarantined_parts"] == 0
                     and _quarantine_check(scenario, quar, os.path.join(workdir, "chaos"), result))
    # a run that degrades stays within a bounded multiple of the clean wall
    bounded_ok = True
    if expected_degraded:
        result["chaos_wall_bound_s"] = round(result["clean_wall_s"] * 2 + 90, 1)
        bounded_ok = result["chaos_wall_s"] <= result["clean_wall_s"] * 2 + 90
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
    result["ok"] = bool(result["parity"] and not missing and degraded_ok and bounded_ok and quarantine_ok
                        and result["injections"] > 0 and not flight_missing and lanes_ok
                        and result["clean_flightrec"] == 0)
    if not result["ok"]:
        reasons = []
        if not result["parity"]:
            reasons.append(f"artifacts differ from the clean runs: {result['differ'][:8]}")
        if not quarantine_ok:
            reasons.append(f"quarantine gate failed: expected {EXPECT_QUARANTINE.get(scenario)} got "
                           f"{result.get('quarantine_records', result['quarantined_parts'])} (clean leg "
                           f"quarantined {result['clean_quarantined_parts']} part(s))")
        if missing:
            reasons.append(f"expected recovery counters missing: {missing}")
        if not degraded_ok:
            reasons.append(f"degraded sections {result['degraded']} != expected {expected_degraded}")
        if not bounded_ok:
            reasons.append(f"chaos wall {result['chaos_wall_s']} s exceeded the bound "
                           f"{result['chaos_wall_bound_s']} s")
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


def slowread_data(workdir: str) -> str:
    """The slow-read scenario's input, written once: SLOWREAD_PARTS parquet
    parts of SLOWREAD_ROWS rows, two numeric columns, seed 7."""
    import numpy as np
    import pandas as pd

    data = os.path.join(workdir, "stream_data")
    if not os.path.isdir(data):
        os.makedirs(data)
        rng = np.random.default_rng(7)
        for i in range(SLOWREAD_PARTS):
            pd.DataFrame({
                "a": rng.normal(i, 2.0, SLOWREAD_ROWS),
                "b": rng.exponential(5.0, SLOWREAD_ROWS),
            }).to_parquet(os.path.join(data, f"part-{i:05d}.parquet"), index=False)
    return data


def run_slowread_stream(workdir: str) -> dict:
    """The streaming-ingest fault gate (no workflow run).

    Clean leg: ``describe_streaming`` over :func:`slowread_data` with the
    prefetch pool on (``ANOVOS_STREAM_INFLIGHT=auto``, 4 decode workers).
    Chaos leg: the ``slowread-stream`` plan delays six of the eight parts
    by 0.6 s a read (both passes: 7.2 s of serial decode).  Gates: equal
    stats frames, no quarantine on either leg, the chaos wall within the
    clean wall plus 0.6 of the serial penalty (a synchronous pipeline pays
    all of it), at least 12 injections and a decode/compute overlap of at
    least 0.3 on the chaos leg."""
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.ops.streaming import describe_streaming, last_stream_summary
    from anovos_tpu_torch.resilience import chaos

    spec = SCENARIOS["slowread-stream"]
    result = {"scenario": "slowread-stream", "spec": spec}
    data = slowread_data(workdir)
    # a real pool: the gate measures the pool's absorption, not the host's
    # CPU count
    with _knobs({"ANOVOS_STREAM_INFLIGHT": "auto", "ANOVOS_STREAM_DECODE_WORKERS": SLOWREAD_WORKERS}):
        try:
            guard.reset()
            chaos.reset()
            t0 = time.monotonic()
            clean = describe_streaming(data, "parquet", chunk_rows=SLOWREAD_ROWS)
            result["clean_wall_s"] = round(time.monotonic() - t0, 3)
            result["clean_quarantined_parts"] = len(guard.records())
            chaos.install(spec)
            t0 = time.monotonic()
            slow = describe_streaming(data, "parquet", chunk_rows=SLOWREAD_ROWS)
            result["chaos_wall_s"] = round(time.monotonic() - t0, 3)
            plan = chaos.plan()
            result["injections"] = plan.injection_count() if plan else 0
            result["quarantined_parts"] = len(guard.records())
            ss = last_stream_summary()
            result["stream_overlap_pct"] = ss.get("overlap_pct")
            result["stream_workers"] = ss.get("workers")
        finally:
            reset_planes(disarm=False)
    serial_penalty = SLOWREAD_SLOW_PARTS * SLOWREAD_SECS * 2  # parts x secs x passes
    bound = result["clean_wall_s"] + SLOWREAD_SHARE * serial_penalty
    result["serial_penalty_s"] = serial_penalty
    result["chaos_wall_bound_s"] = round(bound, 2)
    result["parity"] = bool(clean.equals(slow))
    bounded = result["chaos_wall_s"] <= bound
    overlapped = (result["stream_overlap_pct"] or 0) >= 0.3
    result["ok"] = bool(result["parity"] and bounded and overlapped and result["injections"] >= 12
                        and result["quarantined_parts"] == 0 and result["clean_quarantined_parts"] == 0)
    if not result["ok"]:
        reasons = []
        if not result["parity"]:
            reasons.append("slow-read stats frame differs from the clean run")
        if not bounded:
            reasons.append(f"chaos wall {result['chaos_wall_s']} s exceeded the bound "
                           f"{result['chaos_wall_bound_s']} s: the pool serialized the slow parts")
        if not overlapped:
            reasons.append(f"overlap {result['stream_overlap_pct']} < 0.3: the compute stalled for the decode")
        if result["injections"] < 12:
            reasons.append(f"chaos plan fired {result['injections']} (< 12: io site names drifted?)")
        if result["quarantined_parts"] or result["clean_quarantined_parts"]:
            reasons.append("slowread must delay, never quarantine")
        result["error"] = "; ".join(reasons)
    return result


def feed_alerts(workdir: str) -> list:
    """The drift alerts of the incremental leg of :func:`run_feed_30d`, read
    back from its ``inc/out/obs/continuum_alerts.jsonl``."""
    path = os.path.join(workdir, "inc", "out", "obs", "continuum_alerts.jsonl")
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") == "drift":
                    out.append(rec)
    return out


def run_feed_30d(workdir: str) -> dict:
    """The continuum byte-parity gate (no workflow run, no chaos plan: the
    30-day feed's faults are in its files).  ``feed.run_feed`` takes one
    ``continuum.watcher.step`` a day and one over the union from empty
    state; the gate wants byte-equal trees (``obs/`` left out),
    ``day-20.parquet`` quarantined on both legs, day 30's fold within
    :data:`FEED_FOLD_RATIO` (2) x day 2's, a drift alert on or after the
    shift day, and flight context on the drift alerts.  The flight
    recorder that the steps arm is disarmed afterwards when it was not
    armed before."""
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import feed

    result = {"scenario": "feed-30d", "spec": ""}
    armed = flight.enabled()
    try:
        r = feed.run_feed(days=FEED_DAYS, rows_per_day=FEED_ROWS_PER_DAY, workdir=workdir)
    except Exception as e:
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        return result
    finally:
        reset_planes(disarm=not armed)
    result.update({k: v for k, v in r.items() if k != "workdir"})
    result["parity"] = r["continuum_parity"]
    shift_alerts = feed_alerts(workdir)
    with_context = [a for a in shift_alerts if a.get("flight")]
    result["drift_alerts"] = len(shift_alerts)
    result["drift_alerts_with_flight_context"] = len(with_context)
    corrupt = f"day-{feed.CORRUPT_DAY:02d}.parquet"
    quarantine_ok = r["continuum_quarantined"] == [corrupt] and r["continuum_batch_quarantined"] == [corrupt]
    history_flat = r["continuum_day30_vs_day2"] <= FEED_FOLD_RATIO
    result["ok"] = bool(r["continuum_parity"] and quarantine_ok and history_flat
                        and r["continuum_shift_alert_day"] is not None and with_context)
    if not result["ok"]:
        reasons = []
        if not r["continuum_parity"]:
            reasons.append("incremental artifacts differ from the from-scratch batch run over the union")
        if not quarantine_ok:
            reasons.append(f"quarantine mismatch: inc={r['continuum_quarantined']} "
                           f"batch={r['continuum_batch_quarantined']} (want {corrupt} on both)")
        if not history_flat:
            reasons.append(f"day-30 fold {r['continuum_day30_fold_s']} s is {r['continuum_day30_vs_day2']}x "
                           "day 2's: the fold wall grew with the history")
        if r["continuum_shift_alert_day"] is None:
            reasons.append("no drift alert fired on or after the shift day")
        elif not with_context:
            reasons.append("drift alerts carry no flight-recorder context")
        result["error"] = "; ".join(reasons)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a config under a chaos scenario; exit nonzero unless "
                                             "recovery and artifact parity hold")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default="full")
    ap.add_argument("--config", help="YAML config (default: the built-in synthetic one)")
    ap.add_argument("--spec", help="an explicit ANOVOS_TPU_CHAOS plan instead of the scenario's")
    ap.add_argument("--workdir", help="run directory (default: a fresh temporary directory)")
    ap.add_argument("--node-timeout", default=NODE_TIMEOUT,
                    help="the chaos run's ANOVOS_TPU_NODE_TIMEOUT (seconds; small so that a hang escalates "
                         "quickly); the clean run's is at least 600")
    ap.add_argument("--device", default="cuda", help="the runtime's device (default cuda; cpu to run there)")
    ap.add_argument("--json", action="store_true", help="print the result as one JSON object")
    ns = ap.parse_args(argv)

    if ns.scenario in REQUIRE_MULTIDEV:
        raise NotImplementedError(MULTIDEV_MISSING.format(ns.scenario))
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime(ns.device)
    cfg = None
    if ns.config:
        import yaml

        with open(ns.config) as f:
            cfg = yaml.load(f, yaml.SafeLoader)
    workdir = ns.workdir or tempfile.mkdtemp(prefix="anovos_chaos_")
    if ns.scenario == "serve-fault":
        # --node-timeout is a workflow knob; the serving gate bounds p99
        from anovos_tpu_torch.serving.demo import run_serve_fault

        result = run_serve_fault(workdir)
    elif ns.scenario == "slowread-stream":
        result = run_slowread_stream(workdir)
    elif ns.scenario == "feed-30d":
        result = run_feed_30d(workdir)
    else:
        result = run_scenario(ns.scenario, workdir, config=cfg, spec=ns.spec, node_timeout=ns.node_timeout)
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
