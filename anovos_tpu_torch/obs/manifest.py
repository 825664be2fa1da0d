"""Run manifest: the machine-readable record of one ``workflow.main`` run
(counterpart of ``anovos_tpu/obs/manifest.py``).

``obs/run_manifest.json`` lands next to the run's other artifacts: the
executor mode, the critical path, every node's span and state, each
block's wall, the metrics snapshot, the per-node device-time split
(``devprof``) and the resilience record.  The report's Run Timings tab
reads it, and two manifests compare under ``stable_view``, which strips
the timestamp- and history-valued fields first.

Determinism contract: ``write_manifest`` serializes with sorted keys and
fixed separators, and every non-timing field (config hash, node names,
dependency lists, metric names, data-volume counters) is a pure function
of the config and the input data, so two sequential-mode runs of one
config give manifests equal under ``stable_view``.

Same keys as the JAX manifest: ``compile_census`` is always ``None``
(eager torch compiles nothing; ``obs/compile_census.py`` is a TPU
workaround left unported) and ``cache`` is ``None`` until the node cache
lands (ROADMAP.md Queue A item 1); ``backend`` is the runtime's device
type (``"cuda"`` or ``"cpu"``).  The port's scheduler summary has one
key the JAX one lacks, each node's ``stream``: telemetry, which
``stable_view`` strips by name (:data:`PORT_ONLY_NODE_FIELDS`).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

MANIFEST_VERSION = 1

__all__ = [
    "MANIFEST_VERSION",
    "PORT_ONLY_NODE_FIELDS",
    "STABLE_TOP_FIELDS",
    "config_hash",
    "build_manifest",
    "write_manifest",
    "load_manifest",
    "stable_view",
]


def _env_section(all_configs: dict) -> Optional[dict]:
    """The fingerprint inputs a run comparison diffs: code version, the
    audited env knobs (their values, so a knob difference names the knob),
    and the dataset and env fingerprints.  Telemetry, stripped by
    ``stable_view`` (knob values embed chaos specs and temporary paths;
    the dataset signature embeds mtimes)."""
    from anovos_tpu_torch.cache.fingerprint import (
        KNOWN_ENV_KNOBS,
        dataset_fingerprint,
        env_fingerprint,
    )
    from anovos_tpu_torch.version import __version__

    return {
        "code_version": __version__,
        "knobs": {k: os.environ[k] for k in KNOWN_ENV_KNOBS if os.environ.get(k) not in (None, "")},
        "env_fingerprint": env_fingerprint(),
        "dataset_fingerprint": dataset_fingerprint(
            all_configs.get("input_dataset") if isinstance(all_configs, dict) else None),
    }


def config_hash(all_configs: dict) -> str:
    """sha256 of the canonical-JSON config: identifies WHAT ran."""
    blob = json.dumps(all_configs, sort_keys=True, default=str, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _backend() -> Optional[str]:
    """The runtime's device type, or None before any ``init_runtime``."""
    from anovos_tpu_torch.shared.runtime import peek_runtime

    rt = peek_runtime()
    return rt.device.type if rt is not None else None


def build_manifest(
    all_configs: dict,
    summary: dict,
    metrics_snapshot: dict,
    run_type: str = "local",
    block_times: Optional[dict] = None,
    trace_path: Optional[str] = None,
    generated_unix: Optional[float] = None,
    compile_census: Optional[dict] = None,
    cache: Optional[dict] = None,
    resilience: Optional[dict] = None,
    devprof: Optional[dict] = None,
) -> dict:
    """Assemble the manifest dict from the scheduler summary and metrics.

    ``summary`` is ``DagScheduler.run()``'s return value (mode, wall,
    critical path, per-node spans) and is embedded verbatim under
    ``scheduler``."""
    return {
        "manifest_version": MANIFEST_VERSION,
        "config_hash": config_hash(all_configs),
        "run_type": run_type,
        "executor": {
            "mode": summary.get("mode"),
            "workers": summary.get("workers"),
        },
        "critical_path": list(summary.get("critical_path", [])),
        "scheduler": summary,
        "block_seconds": {k: round(v, 4) for k, v in sorted((block_times or {}).items())},
        "metrics": metrics_snapshot,
        "compile_census": compile_census,
        "cache": cache,
        # recovery record: retries, timeout escalations, degraded sections
        # (node -> failure reason), quarantined parts and the chaos plan
        "resilience": resilience,
        # per-node device-time split (obs.devprof)
        "devprof": devprof,
        "env": _env_section(all_configs),
        "trace_path": trace_path,
        "backend": _backend(),
        "generated_unix": round(time.time() if generated_unix is None else generated_unix, 3),
    }


def write_manifest(manifest: dict, path: str) -> str:
    """Serialize deterministically (sorted keys, fixed separators, LF)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifest, f, sort_keys=True, indent=1, separators=(",", ": "))
        f.write("\n")
    return path


def load_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# per-node fields whose values are wall-clock or history derived and so
# differ between two otherwise-identical runs
_VOLATILE_NODE_FIELDS = ("start_s", "end_s", "dur_s", "queue_wait_s", "thread",
                         "cached", "devices", "attempts", "escalated", "degraded")

# per-node fields the port's scheduler adds to the JAX summary: whether a
# node ran on a worker's CUDA stream, telemetry of the concurrent
# executor, stripped by name
PORT_ONLY_NODE_FIELDS = ("stream",)

# Every key build_manifest writes is in exactly one of the two lists:
# STABLE (run identity, equal across two sequential runs of one config)
# or VOLATILE (stripped: wall-clock, history or environment derived).
STABLE_TOP_FIELDS = (
    "manifest_version",
    "config_hash",
    "run_type",
    "executor",
    "scheduler",
    "metrics",
)

_VOLATILE_TOP_FIELDS = (
    "generated_unix", "block_seconds", "trace_path", "backend",
    # the longest chain BY MEASURED DURATION: jitter can pick another
    "critical_path",
    "compile_census",
    "cache",
    "resilience",
    "devprof",
    "env",
)


def stable_view(manifest: dict) -> dict:
    """The manifest minus timestamp/duration-valued fields.

    What survives is the run's *identity*: config hash, executor mode, the
    node set with states and dependency edges, metric names, and the
    rows-ingested counter.  Two sequential-mode runs of one config compare
    equal under this view."""
    out = {k: v for k, v in manifest.items() if k not in _VOLATILE_TOP_FIELDS}
    sched = dict(out.get("scheduler") or {})
    for k in ("wall_s", "serial_s", "critical_path_s", "parallel_speedup",
              "critical_path", "cache", "resilience", "multidev_overlap"):
        sched.pop(k, None)
    sched["nodes"] = {
        name: {k: v for k, v in node.items()
               if k not in _VOLATILE_NODE_FIELDS and k not in PORT_ONLY_NODE_FIELDS}
        for name, node in (sched.get("nodes") or {}).items()
    }
    out["scheduler"] = sched
    metrics = {}
    for name, m in (out.get("metrics") or {}).items():
        if name.startswith(("op_", "device_", "xla_", "cache_", "devprof_", "transfer_")):
            # op first-call state depends on PROCESS history, device
            # memory on the backend, devprof/transfer on durations: none
            # of them is run identity
            continue
        # rows_ingested is the one data-volume counter that is run
        # identity; the others keep only their series names
        keep_values = name == "rows_ingested_total"
        metrics[name] = {
            "type": m.get("type"),
            "series": (m.get("series") if keep_values else sorted((m.get("series") or {}).keys())),
        }
    out["metrics"] = metrics
    return out
