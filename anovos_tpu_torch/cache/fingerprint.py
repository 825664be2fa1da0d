"""Node fingerprints: the cache key of one scheduler node's outputs
(counterpart of ``anovos_tpu/cache/fingerprint.py``).

A node's artifacts are a pure function of the input dataset, its config
slice, the code version, the runtime knobs that change numerics and the
outputs of the nodes it reads through RAW edges.  The fingerprint is the
sha256 over exactly those parts:

``H(base ∥ node name ∥ canonical(config slice) ∥ writes-set ∥ RAW-dep
fingerprints)`` where ``base = H(version ∥ package ∥ env knobs and
backend ∥ dataset fingerprint ∥ global path config)``.

``canonical``, ``digest``, ``dataset_fingerprint`` and
``node_fingerprint`` give the JAX package's digest byte for byte on the
same inputs.  ``base_material`` folds in one part the JAX package's lacks,
the package name: both packages are version 0.1.0 and both default
``--resume`` to ``.anovos_cache``, and their artifacts differ at the f32
level by design, so a root the two share must never hand one package's
results to the other.

``KNOWN_ENV_KNOBS`` lists the environment variables that can change a
node's artifacts: the JAX package's list and the port's two own knobs,
``ANOVOS_GEOCODE_TABLE`` and ``ANOVOS_AE_COMPUTE`` (which the JAX list
leaves out although it moves the autoencoder's latents).  ``EXEMPT_ENV_KNOBS`` lists those a node body
reads that cannot, each with its reason.  ``tests/test_torch_cache.py``
parses the port's sources and holds every node-reachable read to the two
lists (the JAX package's graftcheck rule GC008 does it there)."""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Iterable, Optional

__all__ = [
    "KNOWN_ENV_KNOBS",
    "EXEMPT_ENV_KNOBS",
    "canonical",
    "digest",
    "dataset_fingerprint",
    "env_fingerprint",
    "base_material",
    "node_fingerprint",
]

# Environment variables whose value changes node ARTIFACTS.  Pure
# performance/telemetry knobs (worker counts, timeouts, trace paths, probe
# budgets, and the obs knobs ANOVOS_TPU_DEVPROF / ANOVOS_TPU_FLIGHTREC /
# ANOVOS_PERF_LEDGER / ANOVOS_TPU_TELEMETRY / ANOVOS_TPU_TRACE_ROTATE /
# ANOVOS_TPU_SLO_ERROR_BUDGET — the live telemetry plane and trace
# rotation only READ run state, and their outputs live under the
# parity-excluded obs/ subtree) deliberately stay off the list — they
# must NOT invalidate the cache.
# The serving knobs (ANOVOS_SERVE_BATCH_WINDOW_MS, ANOVOS_SERVE_MAX_BATCH,
# ANOVOS_SERVE_BF16) are a deliberate exemption too: they are read only by
# anovos_tpu_torch/serving/, which never executes as a scheduler node — no
# node artifact can depend on them, so they must not invalidate workflow
# cache entries.  None changes outputs in the port: ANOVOS_SERVE_BF16=1
# raises there (the JAX package sets ANOVOS_TPU_BF16 for its process).
# ANOVOS_SHAPE_BUCKETS is on it defensively: bucketed-vs-exact parity is
# tested byte-identical, but the knob exists precisely to flip compiled
# program shapes, and a false invalidation is cheap while a false hit is
# not.  ANOVOS_FUSE_BLOCKS follows the same policy (fused-vs-eager parity
# is byte-tested, tests/test_fuse_blocks.py, but the knob flips program
# structure wholesale).  graftcheck GC008 audits node bodies against this
# list.
KNOWN_ENV_KNOBS = (
    # continuum feed knobs (anovos_tpu/continuum): the alert gate changes
    # what the arrival loop EMITS (obs/continuum_alerts.jsonl + journal
    # alert_emitted lines), and the poll interval is read inside the
    # node-reachable watcher — both ride the audited list per the
    # GC008/GC012 policy (a false invalidation on knobs nobody flips
    # mid-project is cheap, an unauditable env read is not).  The
    # continuum node itself is uncacheable (cross-run state), so these
    # never cost a recompute in practice.
    "ANOVOS_CONTINUUM_ALERTS",
    "ANOVOS_CONTINUUM_POLL_S",
    # whole-block fusion (ops/fuse.py): =0 restores the eager glue chains
    "ANOVOS_FUSE_BLOCKS",
    # hardened-ingest policy knobs (data_ingest/guard.py): what happens to
    # a corrupt part (quarantine drops its rows vs raise), a schema-
    # drifted part (reconcile null-fills/widens vs strict crash) and a
    # hostile value (mask vs clip vs keep) all change the DATA a run
    # computes over, so runs under different policies must never share
    # cache entries.  ANOVOS_INGEST_RETRIES stays off the list — a
    # successful re-read is byte-identical (same policy as
    # ANOVOS_TPU_RETRIES).
    "ANOVOS_INGEST_ON_CORRUPT",
    "ANOVOS_INGEST_SANITIZE",
    "ANOVOS_INGEST_SCHEMA_DRIFT",
    "ANOVOS_MATMUL_PRECISION",
    "ANOVOS_REPLICATE_MAX_BYTES",
    "ANOVOS_REREAD_FROM_DISK",
    "ANOVOS_SHAPE_BUCKETS",
    # streaming prefetch pool (data_ingest/prefetch.py): decode worker
    # count and the spill-tier staging directory.  Both are pure
    # performance knobs — chunk assembly is ORDERED regardless of worker
    # count, and a spilled frame round-trips exactly — but like
    # ANOVOS_STREAM_INFLIGHT below they are read inside the node-reachable
    # streaming path, and the env-read audit (GC008/GC012) wants every
    # such knob on the audited list; a false invalidation on knobs nobody
    # flips mid-project is cheap, an unauditable env read is not.
    "ANOVOS_STREAM_DECODE_WORKERS",
    # streaming backpressure depth (ops/streaming.py); since round 12
    # ``auto`` (the default) lets the controller resize it from the
    # decode-vs-drain split.  Drain order is FIFO at any window so
    # committed artifacts do not change — but the knob is read inside the
    # node-reachable streaming path, and the env-read audit (GC008/GC012)
    # wants every such knob on the audited list; a false invalidation on
    # a knob nobody flips mid-project is cheap, an unauditable env read
    # is not.
    "ANOVOS_STREAM_INFLIGHT",
    "ANOVOS_STREAM_SPILL_DIR",
    # bf16 mixed-precision sweep (ops/mxu.py): routes the MXU-safe
    # pre-centered matmuls (corr/cov/PCA) through bf16 inputs with f32
    # accumulation — artifacts change within the tested tolerance bands,
    # so bf16 and f32 runs must never share cache entries.  Distance
    # expansions stay f32 unconditionally (the PERF.md corruption class).
    "ANOVOS_TPU_BF16",
    # the chaos harness can change artifacts (an injected fault that
    # exhausts retries leaves a DEGRADED section with missing stats), so
    # a chaos run must never share cache entries with a clean one.  The
    # resilience PERFORMANCE knobs (ANOVOS_TPU_RETRIES, ANOVOS_TPU_DEGRADE,
    # ANOVOS_TPU_HEALTH_TIMEOUT) stay off the list: successful recovery is
    # byte-identical by contract (tests/test_resilience.py)
    "ANOVOS_TPU_CHAOS",
    # node placement changes float artifacts (a device-placed analyzer and
    # its mesh-placed twin reduce in different layouts); the per-node
    # placement string is also folded into each node's key material, but
    # the global override must invalidate runs wholesale too
    "ANOVOS_TPU_PLACEMENT",
    # whole-program (cross-module) env-read audit additions: knobs the
    # interprocedural GC008 scan proved reachable from scheduler node
    # bodies and whose value changes ARTIFACTS, not just speed.
    # compensated-vs-plain moment accumulation flips the float tails the
    # knob exists to control
    "ANOVOS_COMPENSATED_MOMENTS",
    # hyperparameter-search subsample for the DBSCAN grid: a different
    # sample is a different (eps, min_samples) verdict
    "ANOVOS_DBSCAN_GRID_SAMPLE",
    # exact-sort-vs-histogram-sketch quantile cutoff: the sketch carries
    # error ≤ range/2048, so the two paths bin differently at the margin
    "ANOVOS_EXACT_QUANTILE_CELLS",
    # elbow-scan iteration budget and subsample both move the inertia
    # curve, i.e. potentially the chosen k and every downstream label
    "ANOVOS_KMEANS_ELBOW_ITERS",
    "ANOVOS_KMEANS_ELBOW_SAMPLE",
    # Pallas kernel backend: alternative lowerings change float artifacts
    # (same policy as ANOVOS_MATMUL_PRECISION)
    "ANOVOS_USE_PALLAS",
    # the port's own: the offline city table reverse_geocoding reads
    # (data_transformer/geospatial.py); another table names other cities
    "ANOVOS_GEOCODE_TABLE",
    # the port's own: the autoencoder's matmul precision (bf16 inputs with
    # f32 sums, or f32) moves its latents; the JAX list leaves it out, so a
    # bf16 run there restores an f32 run's latents
    "ANOVOS_AE_COMPUTE",
)

# Environment variables that node-reachable code READS but that cannot
# change artifacts, each with its reason (the JAX package's list, less the
# knobs of layers the port does not read).  A name here is a reviewed
# claim: a knob that starts to change artifacts moves to KNOWN_ENV_KNOBS.
EXEMPT_ENV_KNOBS = {
    "ANOVOS_ARTIFACT_STORE":
        "selects WHERE artifacts persist (store backend override), never "
        "their bytes",
    "ANOVOS_DBSCAN_BATCH_MAX":
        "memory bound splitting the min_samples sweep into independent "
        "fits; per-fit results are unchanged and stacked in input order",
    "ANOVOS_DBSCAN_HOST_CC_MAX":
        "picks host vs on-device connected-components propagation; "
        "cluster labels are exact graph connectivity either way",
    "ANOVOS_INGEST_RETRIES":
        "retry budget: a successful re-read is byte-identical (same "
        "policy as ANOVOS_TPU_RETRIES)",
    "ANOVOS_PLOTLY_JS":
        "chart-runtime embedding choice (inline plotly.min.js vs CDN "
        "tag): a rendering asset, not a computed statistic",
    "ANOVOS_TPU_CACHE":
        "cache-store root: selects where node artifacts persist, not "
        "their contents",
    "ANOVOS_TPU_DEVPROF":
        "device-time attribution telemetry toggle; outputs live under "
        "the parity-excluded obs/ subtree",
    "ANOVOS_TPU_FLIGHTREC":
        "flight-recorder telemetry toggle; outputs live under the "
        "parity-excluded obs/ subtree",
    "ANOVOS_PERF_LEDGER":
        "gates the report's Perf Ledger obs tab; obs-tab bytes are "
        "parity-excluded by policy (ledger lives in the repo, not under "
        "master_path)",
    "ANOVOS_RUN_DIFF_BASELINE":
        "gates the report's Run Diff obs tab against a prior manifest; "
        "obs-tab bytes are parity-excluded by policy",
}


def canonical(obj) -> str:
    """Deterministic JSON of a config slice; ``None``-valued dict entries
    are dropped recursively (the runner ignores them)."""

    def strip(o):
        if isinstance(o, dict):
            return {str(k): strip(v) for k, v in o.items() if v is not None}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        return o

    return json.dumps(strip(obj), sort_keys=True, default=str, separators=(",", ":"))


def digest(*parts: str) -> str:
    """sha256 hex of the parts, each followed by a NUL byte (an
    unambiguous part boundary); str parts are UTF-8 encoded."""
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode() if isinstance(p, str) else p)
        h.update(b"\x00")
    return h.hexdigest()


def _stat_sig(path: str) -> str:
    st = os.stat(path)
    return f"{path}:{st.st_size}:{st.st_mtime_ns}"


def dataset_fingerprint(spec: Optional[dict]) -> str:
    """Fingerprint of an input-dataset spec: the canonical spec plus a
    (path, size, mtime_ns) signature of every file under its read path.
    Stat-based, not content-hashed: a touch without a content change
    costs one spurious recompute, never a wrong hit."""
    spec = spec or {}
    sigs = []
    path = ((spec.get("read_dataset") or {}).get("file_path")
            if isinstance(spec.get("read_dataset"), dict) else None)
    if path and os.path.isdir(path):
        for dirpath, dirs, files in os.walk(path):
            dirs.sort()
            for f in sorted(files):
                try:
                    sigs.append(_stat_sig(os.path.join(dirpath, f)))
                except OSError:
                    pass
    elif path and os.path.isfile(path):
        try:
            sigs.append(_stat_sig(path))
        except OSError:
            pass
    return digest(canonical(spec), *sigs)


def env_fingerprint() -> str:
    """The audited runtime knobs (KNOWN_ENV_KNOBS) plus the backend and
    device count.  The backend is the runtime's device type (``"cuda"`` or
    ``"cpu"``) and the count ``torch.cuda.device_count()`` on a CUDA
    runtime, 1 on a CPU one, both read through ``peek_runtime`` (never
    initialising a runtime for a hash); no runtime gives ``""`` and 0, as
    the JAX package gives when jax is not loaded."""
    backend = ""
    n_devices = 0
    if sys.modules.get("torch") is not None:
        try:
            from anovos_tpu_torch.shared.runtime import peek_runtime

            rt = peek_runtime()
            if rt is not None:
                backend = rt.device.type
                n_devices = rt.n_devices
        except Exception:
            backend, n_devices = "", 0
    knobs = {k: os.environ.get(k, "") for k in KNOWN_ENV_KNOBS}
    return digest(canonical(knobs), backend, str(n_devices))


def base_material(all_configs: dict, run_type: str = "local") -> str:
    """The run-wide part of every node fingerprint: code version, package,
    audited env knobs and backend, the input dataset, and the global
    output-path config (a changed write destination must recompute: the
    capture recorded the old destinations)."""
    from anovos_tpu_torch.version import __version__

    global_slice = {
        "run_type": run_type,
        "write_main": all_configs.get("write_main"),
        "write_intermediate": all_configs.get("write_intermediate"),
        "write_stats": all_configs.get("write_stats"),
        "report_preprocessing": {
            "master_path": (all_configs.get("report_preprocessing") or {}).get("master_path")
        },
    }
    return digest(
        __version__,
        "anovos_tpu_torch",  # the package part, which the JAX package's base lacks
        env_fingerprint(),
        dataset_fingerprint(all_configs.get("input_dataset")),
        canonical(global_slice),
    )


def node_fingerprint(
    base: str,
    name: str,
    config_slice,
    writes: Iterable[str] = (),
    dep_fingerprints: Iterable[str] = (),
) -> str:
    """Fold one node's identity: run base, node name, its canonicalized
    config slice, its declared writes-set, and the fingerprints of the
    nodes it reads through RAW edges."""
    return digest(base, name, canonical(config_slice),
                  canonical(sorted(writes)), *sorted(dep_fingerprints))
