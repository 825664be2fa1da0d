"""Config-driven pipeline runner (counterpart of ``anovos_tpu/workflow.py``).

Same YAML schema and the same reflection dispatch: top-level keys are
module blocks, nested keys are function names resolved by ``getattr``.
``stats_args`` injects previously saved stats CSVs into downstream
functions; ``save`` checkpoints intermediates.  The ``run_type`` axis
routes through the artifact store (``shared/artifact_store.py``).

Execution model, as in the JAX runner: the YAML walk REGISTERS each block
as a node on the DAG scheduler (``parallel/scheduler.py``).  Blocks that
change ``df`` (the concatenate and the join, the quality checks, the
transformers, ts auto-detection) form the spine: each reads ``df``
version N and writes version N+1.  Read-only analyzers (stats metrics,
associations, drift, stability, geo, ts inspection, the basic report,
the charts) fan out from the version current at their YAML position, and
``report_generation`` waits on every artifact registered before it.  The
streaming passes and the continuum step read their own part files and
stand aside from the spine.  Stats CSVs, chart JSONs and checkpoints go
through an async write queue (``shared.artifact_store.AsyncArtifactWriter``,
``ANOVOS_TPU_WRITER_WORKERS`` threads, default 2) that a reader waits on
by key and that drains before ``main()`` returns.

``ANOVOS_TPU_EXECUTOR=sequential`` runs the nodes in registration order
on the caller's thread with synchronous writes (the YAML walk);
``concurrent`` runs them on a worker pool (``ANOVOS_TPU_EXECUTOR_WORKERS``),
each device node on its worker's CUDA stream; unset means ``concurrent``
wherever the process may use more than one CPU.  The two modes write the
same files.  ``ANOVOS_TPU_NODE_TIMEOUT`` (seconds, default 900) is the
per-node hang watchdog of the concurrent mode.  Spine nodes retry
``ANOVOS_TPU_RETRIES`` times (default 1) and then abort the run; fan-out
nodes retry and then degrade: the run goes on without the section's
files and the degradation registry (``resilience/policy.py``, read by
:func:`degraded_sections` and the report's Degraded Sections tab) names
it (``ANOVOS_TPU_DEGRADE=0``: they abort too).  Each run installs the
chaos plan of ``ANOVOS_TPU_CHAOS`` (``node:<name>`` sites fire before
each node), re-arms the backend failover (``resilience/failover.py``),
resets the degradation registry and the ingest guard, and points the
guard's quarantine manifest at ``<master_path or write_main path>/obs``.
After a flip to the CPU, a df version committed on the card reaches its
next reader moved to the CPU (``Table.to``); a node in flight at the flip
finishes, and settles its stream, on the card.  :func:`main` and
:func:`run` raise ``NotImplementedError`` on a knob of a layer the port
does not have yet (``obs/telemetry.UNPORTED_KNOBS``: the multi-device
knob).

The run record, as in the JAX runner: every run resets the metrics
registry, the tracer (whose ring ``ANOVOS_TPU_TRACE_BUFFER`` bounds) and
the devprof results, and writes ``obs/run_manifest.json`` (the schedule,
block walls, metrics snapshot, per-node devprof split and resilience
record) through the async writer after the last node;
:data:`LAST_MANIFEST_PATH` names it.  ``ANOVOS_TPU_TRACE`` exports the
tracer's Chrome trace (``1``: ``obs/trace.json``), also when the run
fails.  :func:`run` under ``ANOVOS_PROFILE=<dir>`` records a
``torch.profiler`` trace of the whole run (CPU and CUDA activity on the
card) into ``<dir>``, with each node's kernels under its name.  Around
the scheduled run :func:`main` holds the live plane
(``ANOVOS_TPU_TELEMETRY=<port>``: ``/metrics``, ``/healthz``,
``/statusz``) and the trace rotator (``ANOVOS_TPU_TRACE_ROTATE``, whose
segments ride the async writer), and arms the flight recorder, whose
dumps the manifest names under ``resilience.flight_dumps``.

``resume=True`` resumes the ``streaming_analysis`` passes from their
chunk checkpoints (``obs/stream_ckpt/<sub-analysis>``); without
``ANOVOS_TPU_CACHE`` every other block runs again, as in the JAX runner.
A config without ``input_dataset`` but with ``streaming_analysis`` or
``continuous_analysis`` reads no Table.  A ``transformers`` step resolves
its function on ``data_transformer.transformers`` by ``getattr``, so a
name that module lacks (a geospatial transformer) raises
``AttributeError``.  ``write_feast_features`` adds its two timestamp
columns before the final write and then writes the Feast repository file.
Each block's wall time is logged under the JAX runner's labels and kept
for :func:`block_times`; :data:`LAST_RUN_SUMMARY` holds the schedule's
summary (critical path, serial seconds, speedup).

The node cache, as in the JAX runner: ``ANOVOS_TPU_CACHE=<dir>`` opts
in.  Each registration passes its config slice (``cache_slice``, the JAX
runner's slices; ``None`` keeps a node uncacheable: the continuum step,
the report, and any block that loads a pre-existing model or source); the
slice, folded with the run's base (version, package, audited env knobs,
dataset fingerprint, output paths) and by the scheduler with the
RAW-dep fingerprints, is the node's key.  A hit restores the node's
files and skips its body.  A spine node also checkpoints its output df
version into the store's payload (``shared.table.save_table``, exact);
a hit hands downstream nodes that version as a :class:`_LazyTable`,
loaded and uploaded to the card at its first read.  The run journal
``obs/run_journal.jsonl`` (append-only across runs) records run and node
events, the manifest's ``cache`` section the counts and ``resumed_from``,
and ``ANOVOS_TPU_CACHE_MAX_BYTES`` sweeps the store at the end of the run.
``resume=True`` with the cache on restores a killed run's committed
nodes and resumes the streaming passes from their chunk checkpoints.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import logging
import os
import threading
import time
from typing import Optional

import pandas as pd

from anovos_tpu_torch.cache import (
    CacheStore,
    NodeCachePolicy,
    RunJournal,
    base_material,
    cache_root,
    committed_fingerprints,
    dataset_fingerprint,
    node_fingerprint,
    read_journal,
)
from anovos_tpu_torch.cache import capture as cache_capture
from anovos_tpu_torch.cache.store import parse_bytes
from anovos_tpu_torch.data_analyzer import association_evaluator, quality_checker, stats_generator
from anovos_tpu_torch.data_ingest import data_ingest
from anovos_tpu_torch.data_ingest import guard as ingest_guard
from anovos_tpu_torch.data_ingest.ts_auto_detection import ts_preprocess
from anovos_tpu_torch.data_report.basic_report_generation import (
    ARGS_TO_STATSFUNC,
    CHECKER_STATS_ARGS,
    anovos_basic_report,
)
from anovos_tpu_torch.data_report.report_generation import anovos_report
from anovos_tpu_torch.data_report.report_preprocessing import charts_to_objects, save_stats
from anovos_tpu_torch.data_transformer import transformers
from anovos_tpu_torch.drift_stability import drift_detector as ddetector
from anovos_tpu_torch.drift_stability import stability as dstability
from anovos_tpu_torch.feature_store import feast_exporter
from anovos_tpu_torch.obs import devprof, flight, get_metrics, get_tracer, telemetry
from anovos_tpu_torch.obs.manifest import build_manifest, config_hash, write_manifest
from anovos_tpu_torch.obs.metrics import record_cache_stats, record_device_memory
from anovos_tpu_torch.obs.tracing import buffer_size, maybe_rotator, trace_destination, write_chrome_trace
from anovos_tpu_torch.parallel.scheduler import DagScheduler, available_cpus
from anovos_tpu_torch.resilience import chaos
from anovos_tpu_torch.resilience import failover as res_failover
from anovos_tpu_torch.resilience import policy as res_policy
from anovos_tpu_torch.resilience.policy import ErrorPolicy
from anovos_tpu_torch.shared.artifact_store import AsyncArtifactWriter, for_run_type
from anovos_tpu_torch.shared.runtime import get_runtime, peek_runtime
from anovos_tpu_torch.shared.table import Table, load_table, save_table

logger = logging.getLogger("anovos_tpu_torch.workflow")

# scheduler summary (mode, wall/serial/critical-path seconds, speedup,
# per-node spans) of the most recent main() run
LAST_RUN_SUMMARY: dict = {}
# obs/run_manifest.json of the most recent main() run
LAST_MANIFEST_PATH: str = ""

# stats CSVs each downstream function reads (via stats_args):
# CHECKER_STATS_ARGS is the shared wiring table (one copy, used by the
# basic report too); the workflow path additionally routes stats into
# transformers and charts
MAINFUNC_TO_ARGS = {
    **CHECKER_STATS_ARGS,
    "charts_to_objects": ["stats_unique"],
    "cat_to_num_unsupervised": ["stats_unique"],
    "PCA_latentFeatures": ["stats_missing"],
    "autoencoder_latentFeatures": ["stats_missing"],
}

_BLOCK_TIMES: dict = {}
_BLOCK_LOCK = threading.Lock()


def _log_block_time(label: str, start: float) -> None:
    """Add one block's wall seconds to its label (labels that recur, as
    ``timeseries_analyzer`` does, accumulate; concurrent nodes add under a
    lock)."""
    secs = round(time.monotonic() - start, 4)
    with _BLOCK_LOCK:
        _BLOCK_TIMES[label] = round(_BLOCK_TIMES.get(label, 0.0) + secs, 4)
    get_metrics().counter("anovos_block_seconds",
                          "per-block wall time of the most recent workflow.main run",
                          ).inc(secs, block=label)
    # device-memory high-water marks sampled at every block boundary
    record_device_memory()
    logger.info(f"{label}: execution time (in secs) = {secs}")


def block_times() -> dict:
    """Per-block wall seconds of the most recent ``main()`` run."""
    with _BLOCK_LOCK:
        return dict(_BLOCK_TIMES)


def degraded_sections() -> dict:
    """{section: reason} of what the most recent ``main()`` run lost: the
    fan-out nodes that exhausted their retries (and the ts and geo
    sections, which catch their own failure), under the JAX runner's node
    names, and the parts the ingest guard quarantined (``ingest/<file>``)."""
    return res_policy.degraded_sections()


def ETL(args: dict) -> Table:
    """read_dataset + chained column ops by reflection."""
    read_args = args.get("read_dataset", None)
    if not read_args:
        raise TypeError("Invalid input for reading dataset")
    df = data_ingest.read_dataset(**read_args)
    for key, value in args.items():
        if key != "read_dataset" and value is not None:
            f = getattr(data_ingest, key)
            df = f(df, **value) if isinstance(value, dict) else f(df, value)
    return df


def _settle() -> None:
    """Wait for the work this thread queued on its CUDA stream (a node on
    a worker's stream, before a Table it produced goes to the writer
    thread or a df version it read may be freed).  A node attempt is
    pinned to the runtime it started on, so one in flight at a flip to the
    CPU still settles its card's stream."""
    rt = peek_runtime()
    if rt is not None and rt.device.type == "cuda":
        import torch

        torch.cuda.current_stream(rt.device).synchronize()


def _on_live_device(table: Optional[Table]) -> Optional[Table]:
    """``table`` on the runtime's device: a Table committed on the card
    before a flip to the CPU is moved there (an exact copy); any other
    comes back as it is."""
    if table is None:
        return None
    rt = peek_runtime()
    return table if rt is None or table.device == rt.device else table.to(rt.device)


def save(data, write_configs: Optional[dict], folder_name: str, reread: bool = False,
         writer: Optional[AsyncArtifactWriter] = None, key: Optional[str] = None):
    """Write a Table (or stats frame) under the write config's path and
    return the in-memory data; no write config → the data untouched.

    With ``writer`` the write is queued under ``key`` and the data returns
    at once.  ``reread`` callers get the in-memory data too (a Table is
    already materialized); ``ANOVOS_REREAD_FROM_DISK=1`` makes them read
    the checkpoint back instead, synchronously."""
    if not write_configs:
        return data
    if "file_path" not in write_configs:
        raise TypeError("file path missing for writing data")
    write = copy.deepcopy(write_configs)
    write.pop("mlflow_run_id", "")
    write.pop("log_mlflow", False)
    write["file_path"] = os.path.join(write["file_path"], folder_name)
    from_disk = reread and os.environ.get("ANOVOS_REREAD_FROM_DISK", "0") == "1"
    frame = isinstance(data, pd.DataFrame)

    def _write():
        data_ingest.write_dataset(Table.from_pandas(data) if frame else data, **write)

    if writer is not None and not from_disk:
        if not frame:
            _settle()
        writer.submit(key or f"ckpt:{folder_name}", _write)
        return data
    _write()
    if from_disk:
        back = data_ingest.read_dataset(write["file_path"], write.get("file_type", "csv"),
                                        _clean_read_cfg(write.get("file_configs")))
        return back.to_pandas() if frame else back
    return data


def _clean_read_cfg(cfg):
    cfg = copy.deepcopy(cfg) if cfg else {}
    cfg.pop("repartition", None)
    cfg.pop("mode", None)
    return cfg


def stats_args(
    all_configs: dict, func: str, run_type: str = "local", auth_key: str = "NA"
) -> dict:
    """Wire cached stats CSVs into downstream kwargs.

    The configured ``master_path`` may be remote (s3://, wasbs://) on
    emr/ak8s, but the consumers read with the local reader, so the path is
    resolved through the run_type store's staging dir, which is where
    ``save_stats`` wrote the same CSV."""
    stats_configs = all_configs.get("stats_generator", None)
    write_configs = all_configs.get("write_stats", None)
    report_configs = all_configs.get("report_preprocessing", None)
    report_input_path = ""
    if report_configs is not None:
        if "master_path" not in report_configs:
            raise TypeError("Master path missing for saving report statistics")
        report_input_path = report_configs.get("master_path")
    result = {}
    if not stats_configs:
        return result
    if report_input_path:
        store = for_run_type(run_type, auth_key)
        configured = report_input_path
        report_input_path = store.staging_dir(report_input_path)
        # split-job runs (stats produced by an earlier job on another
        # cluster) find an empty staging dir: pull the remote contents
        # down before handing consumers a local path
        if report_input_path != configured and not (
            os.path.isdir(report_input_path) and os.listdir(report_input_path)
        ):
            try:
                report_input_path = store.pull_dir(configured, report_input_path)
            except Exception as e:  # nothing remote yet: same-process flow
                logger.warning("stats pull from %s failed (%s); using staging", configured, e)
    for arg in MAINFUNC_TO_ARGS.get(func, []):
        if report_input_path:
            result[arg] = {
                "file_path": os.path.join(report_input_path, ARGS_TO_STATSFUNC[arg] + ".csv"),
                "file_type": "csv",
                "file_configs": {"header": True, "inferSchema": True},
            }
        elif write_configs:
            read = copy.deepcopy(write_configs)
            read["file_configs"] = _clean_read_cfg(read.get("file_configs"))
            read["file_path"] = os.path.join(
                read["file_path"], "data_analyzer/stats_generator", ARGS_TO_STATSFUNC[arg]
            )
            result[arg] = read
    return result


def _stats_deps(all_configs: dict, func: str) -> tuple:
    """Scheduler resources ``func`` reads through ``stats_args``: the
    ``stats:<metric>`` CSVs the configured stats_generator produces.  Only
    resources some node writes become edges."""
    stats_configs = all_configs.get("stats_generator") or {}
    if not stats_configs:
        return ()
    if not (all_configs.get("report_preprocessing") or all_configs.get("write_stats")):
        return ()
    metrics = set(stats_configs.get("metric", []) or [])
    return tuple(
        f"stats:{ARGS_TO_STATSFUNC[a]}"
        for a in MAINFUNC_TO_ARGS.get(func, [])
        if ARGS_TO_STATSFUNC[a] in metrics
    )


def _auth_key(auth_key_val: Optional[dict]) -> str:
    """The SAS token is the last value of the auth dict."""
    return list(auth_key_val.values())[-1] if auth_key_val else "NA"


def _clean_spec(d: Optional[dict]) -> dict:
    """Spec comparison form: None-valued keys are ignored by ETL, so they
    are ignored by equality too."""
    return {k: v for k, v in (d or {}).items() if v is not None}


def _drift_source_matches_input(all_configs: dict) -> bool:
    """True when drift_statistics will diff the dataset against itself,
    the only case worth keeping the pre-treatment ingest Table for."""
    dd = (all_configs.get("drift_detector") or {}).get("drift_statistics") or {}
    if (dd.get("configs") or {}).get("pre_existing_source", False):
        return False
    src = dd.get("source_dataset")
    return bool(src) and _clean_spec(src) == _clean_spec(all_configs.get("input_dataset"))


def _uses_preexisting(cfg) -> bool:
    """True when a config subtree loads pre-existing models or sources from
    disk: state the cache key cannot see, so such nodes stay uncacheable
    rather than risk a stale hit."""
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            if k in ("pre_existing_model", "pre_existing_source") and bool(v):
                return True
            if _uses_preexisting(v):
                return True
    elif isinstance(cfg, (list, tuple)):
        return any(_uses_preexisting(v) for v in cfg)
    return False


def _slice_or_none(slice_: dict, *gate_cfgs) -> Optional[dict]:
    """The cache slice, or None (uncacheable) when any gate config pulls
    pre-existing on-disk state into the computation."""
    if any(_uses_preexisting(g) for g in gate_cfgs):
        return None
    return slice_


def _node_policies() -> tuple:
    """(spine policy, fan-out policy) of this run's registrations: both
    retry ``ANOVOS_TPU_RETRIES`` times (default 1); a spine node that
    still fails aborts the run (its df version is every later node's
    input) and escalates its watchdog bound 2x, a fan-out node degrades
    (``ANOVOS_TPU_DEGRADE=0``: aborts) and escalates 1.5x."""
    retries = int(os.environ.get("ANOVOS_TPU_RETRIES", "1"))
    degrade = os.environ.get("ANOVOS_TPU_DEGRADE", "1") != "0"
    spine = ErrorPolicy(mode="retry", retries=retries, on_exhausted="raise", timeout_factor=2.0)
    fanout = ErrorPolicy(mode="retry", retries=retries,
                         on_exhausted="degrade" if degrade else "raise", timeout_factor=1.5)
    return spine, fanout


class _LazyTable:
    """A df version restored from the cache, loaded at its first read.

    On a fully cached run only the final version is ever read (by the
    ``write_main`` save), so every intermediate checkpoint stays on disk;
    an incremental run loads exactly the versions its re-executing cone
    reads.  Two fan-out nodes on different worker streams may race for the
    first read: the lock holds the second until the first has loaded the
    Table and its upload on the first node's stream is complete on the
    card."""

    __slots__ = ("_path", "_table", "_lock")

    def __init__(self, path: str):
        self._path = path
        self._table = None
        self._lock = threading.Lock()

    def get(self) -> Table:
        with self._lock:
            if self._table is None:
                table = load_table(self._path)
                _settle()
                self._table = table
            return self._table


def _write_frame_csv(df: pd.DataFrame, path: str) -> None:
    """Async-writer body for a streaming stats frame (one CSV file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    df.to_csv(path, index=False)


class _PipelineRun:
    """Per-run registrar: turns the YAML walk into scheduler nodes.

    Spine nodes thread ``df`` through explicit versions (``df:N`` →
    ``df:N+1``); fan-out nodes pin the version current at their YAML
    position, so a later spine change never leaks backwards into a
    concurrently running analyzer.  A version is dropped once its last
    registered reader releases it, so peak memory is the live working set,
    not the version history.  A body settles its CUDA stream before it
    releases the version it read.

    With ``cache_base`` set (``ANOVOS_TPU_CACHE``), registrations that pass
    a ``cache_slice`` get a ``NodeCachePolicy``: the slice folded with the
    run base and the node's placement, name and writes (the scheduler
    folds the RAW-dep fingerprints on top).  Spine nodes also checkpoint
    their output df version into the store's payload, so a hit hands the
    table downstream as a :class:`_LazyTable`."""

    def __init__(self, sched: DagScheduler, writer: AsyncArtifactWriter, df0: Optional[Table],
                 cache_base: Optional[str] = None):
        self.sched = sched
        self.writer = writer
        self.cache_base = cache_base
        self.spine_policy, self.fanout_policy = _node_policies()
        self._versions = {0: df0}
        self._planned_readers: dict = {}
        self._ver = 0
        self._lock = threading.Lock()
        self.artifact_keys: list = []  # registration-ordered unique resources

    # -- df version store ------------------------------------------------
    def _claim(self, v: int) -> None:
        self._planned_readers[v] = self._planned_readers.get(v, 0) + 1

    def _release(self, v: int) -> None:
        _settle()
        with self._lock:
            self._planned_readers[v] -= 1
            if self._planned_readers[v] <= 0 and v != self._ver:
                self._versions.pop(v, None)

    def _resolve(self, v: int) -> Optional[Table]:
        df = self._versions[v]
        df = df.get() if isinstance(df, _LazyTable) else df
        live = _on_live_device(df)
        if live is not df:
            # moved once: later readers of the version take the copy
            with self._lock:
                if self._versions.get(v) is not None:
                    self._versions[v] = live
        return live

    def current_df(self) -> Optional[Table]:
        return self._resolve(self._ver)

    def _track(self, writes) -> None:
        for w in writes:
            if w not in self.artifact_keys:
                self.artifact_keys.append(w)

    # -- cache wiring ------------------------------------------------------
    def _policy(self, name, cache_slice, writes, placement="mesh", payload_write=None, on_hit=None):
        if self.cache_base is None or cache_slice is None:
            return None
        # the placement is part of the node's identity, as in the JAX runner
        return NodeCachePolicy(
            key_material=node_fingerprint(self.cache_base, name,
                                          {"placement": placement, "slice": cache_slice}, writes),
            flush=self.writer.wait, payload_write=payload_write, on_hit=on_hit)

    def _save_df(self, v: int, payload_dir: str) -> None:
        """Checkpoint a spine node's output version into the cache payload,
        exactly (``shared.table.save_table``)."""
        save_table(self._resolve(v), os.path.join(payload_dir, "df"))

    # -- node registration -------------------------------------------------
    def spine(self, name, fn, reads=(), writes=(), timed=None, cache_slice=None, on_error=None,
              placement="mesh") -> None:
        """``fn(df) -> df`` changes the table: df version N → N+1."""
        v, out_v = self._ver, self._ver + 1
        self._ver = out_v
        self._claim(v)
        reads = tuple(reads)

        def body():
            self.writer.wait(reads)
            df_in = self._resolve(v)
            t0 = time.monotonic()
            df_out = fn(df_in)
            if timed:
                _log_block_time(timed, t0)
            self._versions[out_v] = df_out if df_out is not None else df_in
            self._release(v)

        def on_hit(payload_dir, v=v, out_v=out_v):
            # the skipped body's output version, from its checkpoint
            if payload_dir is None:  # an entry committed without its df is unusable
                raise RuntimeError("spine cache entry has no df payload")
            self._versions[out_v] = _LazyTable(os.path.join(payload_dir, "df"))
            self._release(v)

        self.sched.add(name, body, reads=(f"df:{v}",) + reads, writes=(f"df:{out_v}",) + tuple(writes),
                       on_error=on_error if on_error is not None else self.spine_policy,
                       placement=placement,
                       cache=self._policy(name, cache_slice, writes, placement=placement,
                                          payload_write=lambda d: self._save_df(out_v, d), on_hit=on_hit))
        self._track(writes)

    def aside(self, name, fn, reads=(), writes=(), timed=None, cache_slice=None, on_error=None,
              placement="host") -> None:
        """``fn()`` never touches the df spine (a streaming pass or the
        continuum step reads its own part files), so the scheduler may
        overlap it with the whole spine."""
        reads = tuple(reads)

        def body():
            self.writer.wait(reads)
            t0 = time.monotonic()
            fn()
            if timed:
                _log_block_time(timed, t0)

        self.sched.add(name, body, reads=reads, writes=tuple(writes),
                       on_error=on_error if on_error is not None else self.fanout_policy,
                       placement=placement, cache=self._policy(name, cache_slice, writes, placement=placement))
        self._track(writes)

    def fanout(self, name, fn, reads=(), writes=(), timed=None, cache_slice=None, on_error=None,
               placement="mesh") -> None:
        """``fn(df)`` only reads the table: pinned to the current version."""
        v = self._ver
        self._claim(v)
        reads = tuple(reads)

        def body():
            self.writer.wait(reads)
            df_in = self._resolve(v)
            t0 = time.monotonic()
            fn(df_in)
            if timed:
                _log_block_time(timed, t0)
            self._release(v)

        self.sched.add(name, body, reads=(f"df:{v}",) + reads, writes=tuple(writes),
                       on_error=on_error if on_error is not None else self.fanout_policy,
                       placement=placement,
                       cache=self._policy(name, cache_slice, writes, placement=placement,
                                          on_hit=lambda _pdir, v=v: self._release(v)))
        self._track(writes)


def _register_streaming(pipe: _PipelineRun, writer: AsyncArtifactWriter, args: dict,
                        report_input_path: str, write_main, write_stats, resume: bool) -> None:
    """The ``streaming_analysis`` block: one aside node a sub-analysis,
    each streaming the part files under ``file_path`` (the table never
    materializes), checkpointed chunk by chunk under ``<master_path or
    write_main path>/obs/stream_ckpt/<sub-analysis>``, its frame queued as
    ``stream_<name>.csv`` under ``output_path`` (else the master path, else
    write_stats' path, else ``stream_stats``)."""
    from anovos_tpu_torch.ops.streaming import describe_streaming

    s_path = args.get("file_path")
    if not s_path:
        raise TypeError("streaming_analysis requires file_path")
    s_type = args.get("file_type", "parquet")
    s_chunk = int(args.get("chunk_rows", 1_000_000) or 1_000_000)
    s_fcfg = args.get("file_configs")
    out_dir = (args.get("output_path") or report_input_path or (write_stats or {}).get("file_path")
               or "stream_stats")
    ckpt_base = os.path.join(report_input_path or (write_main or {}).get("file_path") or ".",
                             "obs", "stream_ckpt")
    fp_of = lambda path: dataset_fingerprint({"read_dataset": {"file_path": path}})  # noqa: E731
    s_fp = fp_of(s_path)
    # (name, output file, function, positional arguments, keyword
    # arguments, extra resources written, placement, the cache slice's
    # extra entries)
    runs = []
    for name, file, fn, place in (("describe", "stream_describe.csv", describe_streaming, "device"),
                                  ("quality_missing", "stream_missing.csv",
                                   quality_checker.missing_stats_streaming, "host")):
        # an empty dict means "enabled with the defaults" (the YAML `describe: {}`)
        if args.get(name) is not None and args.get(name) is not False:
            runs.append((name, file, fn, (s_path, s_type),
                         args[name] if isinstance(args[name], dict) else {}, (), place, {}))
    if args.get("quality_outlier"):
        o_cfg = dict(args["quality_outlier"])
        o_model = o_cfg.pop("model_path", None)
        if not o_model:
            raise TypeError("streaming_analysis.quality_outlier requires model_path "
                            "(pre-fitted outlier bounds)")
        runs.append(("quality_outlier", "stream_outlier.csv", quality_checker.outlier_stats_streaming,
                     (s_path, s_type, o_model), o_cfg, (), "device", {"model_fp": fp_of(o_model)}))
    if args.get("drift"):
        dr_cfg = dict(args["drift"])
        dr_src = dr_cfg.pop("source_file_path", None)
        runs.append(("drift", "stream_drift.csv", ddetector.statistics_streaming, (s_path, s_type, dr_src),
                     dr_cfg, ("drift:model",), "device", {"source_fp": fp_of(dr_src)}))
    for name, file, fn, fn_args, cfg, extra, place, slice_extra in runs:
        key = "stats:" + file[:-len(".csv")]

        def _stream(name=name, file=file, fn=fn, fn_args=fn_args, cfg=cfg, key=key):
            odf = fn(*fn_args, chunk_rows=s_chunk, file_configs=s_fcfg,
                     checkpoint_dir=os.path.join(ckpt_base, name), resume=resume, **cfg)
            writer.submit(key, _write_frame_csv, odf, os.path.join(out_dir, file))

        pipe.aside(f"streaming_analysis/{name}", _stream, writes=(key,) + extra,
                   timed=f"streaming_analysis, {name}", placement=place,
                   cache_slice={name: cfg, "chunk_rows": s_chunk, "dataset_fp": s_fp, **slice_extra})


def main(all_configs: dict, run_type: str = "local", auth_key_val: Optional[dict] = None,
         resume: bool = False) -> None:
    global LAST_RUN_SUMMARY, LAST_MANIFEST_PATH
    telemetry.check_unported_knobs()
    start_main = time.monotonic()
    with _BLOCK_LOCK:
        _BLOCK_TIMES.clear()
    # per-run accounting: the metrics registry and the trace ring describe
    # the most recent run; the ops' first-call signature sets persist, so a
    # warm run's manifest books steady-state calls
    get_metrics().reset()
    get_tracer().clear(buffer=buffer_size())
    LAST_RUN_SUMMARY = {}
    LAST_MANIFEST_PATH = ""
    # per-run resilience state: the chaos plan of ANOVOS_TPU_CHAOS (inert
    # when unset), a re-armed failover (a new run may probe and flip
    # again), an empty degradation registry and quarantine registry
    chaos.install_from_env()
    res_failover.reset()
    res_policy.reset_degraded()
    ingest_guard.reset()
    auth_key = _auth_key(auth_key_val)
    basic_report_flag = (all_configs.get("anovos_basic_report", {}) or {}).get("basic_report", False)
    if all_configs.get("input_dataset") is None and (
            all_configs.get("streaming_analysis") or all_configs.get("continuous_analysis")):
        # out-of-core / continuum mode: the dataset never materializes as
        # a Table; the streaming passes and the continuum step read their
        # own part files
        df = None
    else:
        with get_tracer().span("input_dataset/ETL", cat="node"):
            df = ETL(all_configs.get("input_dataset"))
    # the pre-treatment ingest Table, kept only when drift_statistics will
    # diff the dataset against itself
    base_df = df if (df is not None and _drift_source_matches_input(all_configs)) else None

    write_main = all_configs.get("write_main", None)
    write_intermediate = all_configs.get("write_intermediate", None)
    write_stats = all_configs.get("write_stats", None)

    mlflow_config = all_configs.get("mlflow", None)
    mlflow_ctx = contextlib.nullcontext()
    if mlflow_config is not None:
        try:  # pragma: no cover - optional dependency
            import mlflow

            mlflow.set_tracking_uri(mlflow_config["tracking_uri"])
            mlflow.set_experiment(mlflow_config["experiment"])
            mlflow_ctx = mlflow.start_run()
        except ImportError:
            logger.warning("mlflow configured but not installed; skipping tracking")

    report_input_path = ""
    report_configs = all_configs.get("report_preprocessing", None)
    if report_configs is not None:
        if "master_path" not in report_configs:
            raise TypeError("Master path missing for saving report statistics")
        report_input_path = report_configs.get("master_path")
    # the quarantine manifest goes to the run's obs/ subtree (parts the
    # ETL read set aside are written now); a clean run writes nothing
    obs_base = report_input_path or (write_main or {}).get("file_path") or "."
    obs_store = for_run_type(run_type, auth_key)
    obs_root = obs_store.staging_dir(obs_base)
    obs_dir = os.path.join(obs_root, "obs")
    trace_dest = trace_destination(obs_root)
    manifest_path = os.path.abspath(os.path.join(obs_dir, "run_manifest.json"))
    ingest_guard.configure(obs_dir)
    # arm the flight recorder: a fresh ring (the continuum's alerts carry
    # its tail), dumps into obs/, and the previous run's manifest there as
    # the perf doctor's baseline, read before this run overwrites it
    flight.configure(obs_dir)

    # executor: ANOVOS_TPU_EXECUTOR wins; else concurrent wherever a second
    # CPU exists (worker threads on one core only timeshare it)
    mode = os.environ.get("ANOVOS_TPU_EXECUTOR", "") or (
        "concurrent" if available_cpus() > 1 else "sequential")
    writer = AsyncArtifactWriter(workers=int(os.environ.get("ANOVOS_TPU_WRITER_WORKERS", "2")),
                                 sync=(mode == "sequential"))
    # the node cache: ANOVOS_TPU_CACHE=<dir> opts in; the registrations
    # below pass their config slices, the scheduler folds the RAW-edge
    # fingerprints and restores the nodes whose results are committed
    cache_store = cache_base = None
    if cache_root():
        cache_store = CacheStore(cache_root())
        cache_base = base_material(all_configs, run_type)
    elif resume:
        logger.warning("--resume requested but ANOVOS_TPU_CACHE is unset; "
                       "nothing to resume from — executing every node")
    sched = DagScheduler(name="workflow", cache_store=cache_store)
    pipe = _PipelineRun(sched, writer, df, cache_base=cache_base)

    def _stats_out(df_stats, name, folder):
        """A stats frame to the master path (``stats:<name>``), else to
        write_stats' folder."""
        if report_input_path:
            save_stats(df_stats, report_input_path, name, run_type=run_type, auth_key=auth_key,
                       async_writer=writer, async_key=f"stats:{name}")
        else:
            save(df_stats, write_stats, folder, reread=True, writer=writer, key=f"stats:{name}")

    with mlflow_ctx:
        for key, args in all_configs.items():
            if key == "concatenate_dataset" and args is not None:
                def _concat(df, args=args):
                    idfs = [df] + [ETL(args[k]) for k in args if k not in ("method", "method_type")]
                    out = data_ingest.concatenate_dataset(
                        *idfs, method_type=args.get("method", args.get("method_type", "name")))
                    return save(out, write_intermediate, "data_ingest/concatenate_dataset",
                                reread=True, writer=writer)
                pipe.spine("concatenate_dataset", _concat, timed="concatenate_dataset",
                           cache_slice={"concatenate_dataset": args, "dataset_fps": [
                               dataset_fingerprint(args[k]) for k in args if k not in ("method", "method_type")]})
                continue

            if key == "join_dataset" and args is not None:
                def _join(df, args=args):
                    idfs = [df] + [ETL(args[k]) for k in args if k not in ("join_type", "join_cols")]
                    out = data_ingest.join_dataset(
                        *idfs, join_cols=args.get("join_cols"), join_type=args.get("join_type"))
                    return save(out, write_intermediate, "data_ingest/join_dataset",
                                reread=True, writer=writer)
                pipe.spine("join_dataset", _join, timed="join_dataset",
                           cache_slice={"join_dataset": args, "dataset_fps": [
                               dataset_fingerprint(args[k]) for k in args if k not in ("join_type", "join_cols")]})
                continue

            if key == "timeseries_analyzer" and args is not None:
                # omit None-valued config keys so callee defaults apply
                opt = {k: v for k, v in args.items() if v is not None}
                if opt.get("auto_detection", False):
                    # best-effort, as in the JAX runner: a detection failure
                    # keeps the raw table and is recorded, not retried
                    def _ts_auto(df, opt=opt):
                        try:
                            return ts_preprocess(df, opt.get("id_col"), output_path=report_input_path or ".",
                                                 tz_offset=opt.get("tz_offset", "local"), run_type=run_type)
                        except Exception as e:
                            logger.exception("ts auto-detection failed; continuing with the raw table")
                            res_policy.record_degraded("timeseries_analyzer/auto_detection",
                                                       f"{type(e).__name__}: {e}")
                            return df
                    pipe.spine("timeseries_analyzer/auto_detection", _ts_auto,
                               writes=("report:ts_autodetect",), timed="timeseries_analyzer",
                               cache_slice={"timeseries_analyzer": opt, "mode": "auto"})
                if opt.get("inspection", False):
                    def _ts_inspect(df, opt=opt):
                        from anovos_tpu_torch.data_analyzer.ts_analyzer import ts_analyzer

                        try:
                            kw = {k: opt[k] for k in ("max_days", "tz_offset") if k in opt}
                            if "analysis_level" in opt:
                                kw["output_type"] = opt["analysis_level"]
                            ts_analyzer(df, opt.get("id_col"), output_path=report_input_path or ".",
                                        run_type=run_type, **kw)
                        except Exception as e:
                            logger.exception("ts inspection failed; continuing without ts analysis")
                            res_policy.record_degraded("timeseries_analyzer/inspection",
                                                       f"{type(e).__name__}: {e}")
                    pipe.fanout("timeseries_analyzer/inspection", _ts_inspect,
                                writes=("report:ts_inspection",), timed="timeseries_analyzer",
                                cache_slice={"timeseries_analyzer": opt, "mode": "inspect"})
                continue

            if key == "geospatial_controller" and args is not None:
                ga = args.get("geospatial_analyzer", {}) or {}
                if ga.get("auto_detection_analyzer", False):
                    kw = {k: ga[k] for k in ("max_analysis_records", "top_geo_records", "max_cluster",
                                             "eps", "min_samples", "global_map_box_val")
                          if ga.get(k) is not None}

                    def _geo(df, ga=ga, kw=kw):
                        from anovos_tpu_torch.data_analyzer.geospatial_analyzer import (
                            geospatial_autodetection)

                        try:
                            geospatial_autodetection(df, ga.get("id_col"), report_input_path or ".",
                                                     run_type=run_type, **kw)
                        except Exception as e:
                            logger.exception("geospatial_analyzer failed; continuing without geo analysis")
                            res_policy.record_degraded("geospatial_controller", f"{type(e).__name__}: {e}")
                    pipe.fanout("geospatial_controller", _geo, writes=("report:geo",),
                                timed="geospatial_controller", cache_slice={"geospatial_controller": ga})
                continue

            if key == "anovos_basic_report" and args is not None and args.get("basic_report", False):
                def _basic(df, args=args):
                    anovos_basic_report(df, **args.get("report_args", {}), run_type=run_type,
                                        auth_key=auth_key)
                pipe.fanout("anovos_basic_report", _basic, writes=("report:basic",), timed="Basic Report",
                            cache_slice={"anovos_basic_report": args})
                continue

            if basic_report_flag:
                continue

            if key == "stats_generator" and args is not None:
                # a repeated metric in a hand-edited YAML runs once
                for m in dict.fromkeys(args["metric"]):
                    def _stat(df, m=m, args=args):
                        _stats_out(getattr(stats_generator, m)(df, **args["metric_args"]), m,
                                   "data_analyzer/stats_generator/" + m)
                    pipe.fanout(f"stats_generator/{m}", _stat, writes=(f"stats:{m}",),
                                timed=f"stats_generator, {m}", placement="device",
                                cache_slice={"metric": m, "metric_args": args["metric_args"]})

            if key == "quality_checker" and args is not None:
                for subkey, value in args.items():
                    if value is None:
                        continue

                    def _qc(df, subkey=subkey, value=value, args=args):
                        extra_args = stats_args(all_configs, subkey, run_type, auth_key)
                        if subkey == "nullColumns_detection":
                            # upstream treatments invalidate the cached missing stats
                            if (args.get("invalidEntries_detection") or {}).get("treatment"):
                                extra_args["stats_missing"] = {}
                            outlier = args.get("outlier_detection") or {}
                            if outlier.get("treatment") and outlier.get("treatment_method") == "null_replacement":
                                extra_args["stats_missing"] = {}
                        df_out, df_stats = getattr(quality_checker, subkey)(df, **value, **extra_args)
                        df_out = save(df_out, write_intermediate,
                                      "data_analyzer/quality_checker/" + subkey + "/dataset",
                                      reread=True, writer=writer)
                        _stats_out(df_stats, subkey, "data_analyzer/quality_checker/" + subkey)
                        return df_out
                    # the slice is the whole block: the other checks'
                    # treatment flags feed this node's stats_args
                    pipe.spine(f"quality_checker/{subkey}", _qc, reads=_stats_deps(all_configs, subkey),
                               writes=(f"stats:{subkey}",), timed=f"quality_checker, {subkey}",
                               cache_slice=_slice_or_none({"quality_checker": args}, value))

            if key == "association_evaluator" and args is not None:
                for subkey, value in args.items():
                    if value is None:
                        continue

                    def _assoc(df, subkey=subkey, value=value):
                        extra_args = stats_args(all_configs, subkey, run_type, auth_key)
                        df_in = df
                        cat_params = all_configs.get("cat_to_num_transformer", None)
                        if subkey == "correlation_matrix" and cat_params:
                            df_in = transformers.cat_to_num_transformer(df, **cat_params)
                        _stats_out(getattr(association_evaluator, subkey)(df_in, **value, **extra_args),
                                   subkey, "data_analyzer/association_evaluator/" + subkey)
                    assoc_slice = {subkey: value}
                    if subkey == "correlation_matrix":
                        assoc_slice["cat_to_num_transformer"] = all_configs.get("cat_to_num_transformer")
                    pipe.fanout(f"association_evaluator/{subkey}", _assoc,
                                reads=_stats_deps(all_configs, subkey), writes=(f"stats:{subkey}",),
                                timed=f"{key}, {subkey}", placement="device",
                                cache_slice=_slice_or_none(assoc_slice, value))

            if key == "drift_detector" and args is not None:
                for subkey, value in args.items():
                    if value is None or subkey not in ("drift_statistics", "stability_index"):
                        continue

                    if subkey == "drift_statistics":
                        def _drift(df, value=value):
                            source = None
                            if not value["configs"].get("pre_existing_source", False):
                                src_spec = value.get("source_dataset")
                                # an identical source spec reuses the ingested
                                # base table instead of reading it again
                                if base_df is not None and src_spec and \
                                        _clean_spec(src_spec) == _clean_spec(all_configs.get("input_dataset")):
                                    source = _on_live_device(base_df)
                                else:
                                    source = ETL(src_spec)
                            # statistics() also persists the drift frequency
                            # model (the charts' drift tab reads it)
                            _stats_out(ddetector.statistics(df, source, **value["configs"]),
                                       "drift_statistics", "drift_detector/drift_statistics")
                        # the source files are a second input dataset
                        pipe.fanout("drift_detector/drift_statistics", _drift,
                                    writes=("stats:drift_statistics", "drift:model"),
                                    timed=f"{key}, drift_statistics",
                                    cache_slice=_slice_or_none(
                                        {"drift_statistics": value,
                                         "source_fp": dataset_fingerprint(value.get("source_dataset"))},
                                        value))
                    else:
                        def _stability(df, value=value):
                            idfs = [ETL(value[k]) for k in value if k != "configs"]
                            df_stats = dstability.stability_index_computation(*idfs, **value["configs"])
                            if report_input_path:
                                save_stats(df_stats, report_input_path, "stability_index", run_type=run_type,
                                           auth_key=auth_key, async_writer=writer,
                                           async_key="stats:stability_index")
                                amp = value["configs"].get("appended_metric_path", "")
                                if amp:
                                    metrics = data_ingest.read_dataset(amp, "csv", {"header": True})
                                    save_stats(metrics.to_pandas(), report_input_path, "stabilityIndex_metrics",
                                               run_type=run_type, auth_key=auth_key, async_writer=writer,
                                               async_key="stats:stabilityIndex_metrics")
                            else:
                                save(df_stats, write_stats, "drift_detector/stability_index", reread=True,
                                     writer=writer, key="stats:stability_index")
                        stab_cfg = value.get("configs") or {}
                        # the metric paths are appended to across runs: a
                        # retry after a partial append could double-book a
                        # window, so this node is not re-executed
                        stab_retry = None
                        if stab_cfg.get("appended_metric_path") or stab_cfg.get("existing_metric_path"):
                            stab_retry = "raise"
                        # the metric paths are cross-run state: their on-disk
                        # signature is part of the key
                        metric_paths = (stab_cfg.get("appended_metric_path", ""),
                                        stab_cfg.get("existing_metric_path", ""))
                        pipe.fanout("drift_detector/stability_index", _stability,
                                    writes=("stats:stability_index", "stats:stabilityIndex_metrics"),
                                    timed=f"{key}, stability_index", on_error=stab_retry, placement="device",
                                    cache_slice=_slice_or_none(
                                        {"stability_index": value,
                                         "dataset_fps": {k: dataset_fingerprint(value[k])
                                                         for k in sorted(value) if k != "configs"},
                                         "metric_path_fps": [
                                             dataset_fingerprint({"read_dataset": {"file_path": p}})
                                             for p in metric_paths if p]},
                                        value))

            if key == "transformers" and args is not None:
                for subkey, value in args.items():
                    if value is None:
                        continue
                    for fn, fn_args in value.items():
                        if fn_args is None:
                            continue

                        def _tf(df, fn=fn, fn_args=fn_args):
                            extra_args = stats_args(all_configs, fn, run_type, auth_key)
                            df_out = getattr(transformers, fn)(df, **fn_args, **extra_args)
                            return save(df_out, write_intermediate, "data_transformer/transformers/" + fn,
                                        reread=True, writer=writer)
                        pipe.spine(f"transformers/{fn}", _tf, reads=_stats_deps(all_configs, fn),
                                   timed=f"{key}, {fn}", cache_slice=_slice_or_none({fn: fn_args}, fn_args))

            if key == "streaming_analysis" and args is not None:
                _register_streaming(pipe, writer, args, report_input_path, write_main, write_stats, resume)
                continue

            if key == "continuous_analysis" and args is not None:
                # one continuum step over the section's feed (a retry resumes
                # from the partitions the failed attempt committed);
                # uncacheable: its output depends on the fold frontier, cross-
                # run state the node fingerprint cannot see
                def _continuum_step(c_args=dict(args)):
                    from anovos_tpu_torch.continuum.watcher import ContinuumConfig
                    from anovos_tpu_torch.continuum.watcher import step as continuum_step

                    base = report_input_path or (write_main or {}).get("file_path") or "."
                    summary = continuum_step(ContinuumConfig.from_dict(c_args, base_dir=base))
                    logger.info("continuous_analysis: folded=%d quarantined=%d alerts=%d partitions=%d",
                                len(summary["folded"]), len(summary["quarantined"]), summary["alerts"],
                                summary["partitions"])
                pipe.aside("continuous_analysis/step", _continuum_step, timed="continuous_analysis",
                           placement="device")
                continue

            if key == "report_preprocessing" and args is not None:
                for subkey, value in args.items():
                    if subkey == "charts_to_objects" and value is not None:
                        chart_reads = _stats_deps(all_configs, subkey)
                        if value.get("drift_detector", False):
                            # the drift tab reuses the frequency model the
                            # drift_statistics node persists
                            chart_reads = chart_reads + ("drift:model",)

                        def _charts(df, subkey=subkey, value=value):
                            extra_args = stats_args(all_configs, subkey, run_type, auth_key)
                            charts_to_objects(df, **value, **extra_args, master_path=report_input_path,
                                              run_type=run_type, auth_key=auth_key, async_writer=writer,
                                              async_key="charts:objects")
                        pipe.fanout(f"report_preprocessing/{subkey}", _charts, reads=chart_reads,
                                    writes=("charts:objects",), timed=f"{key}, {subkey}",
                                    cache_slice={"charts_to_objects": value})

            if key == "report_generation" and args is not None:
                # the report reads the whole master_path subtree: it waits
                # on every artifact registered so far and on their queued
                # writes; the run's product is retried, never degraded
                def _report(df, args=args):
                    anovos_report(**args, run_type=run_type, auth_key=auth_key)
                pipe.fanout("report_generation", _report, reads=tuple(pipe.artifact_keys),
                            timed=f"{key}, full_report", placement="host",
                            on_error=ErrorPolicy(mode="retry", retries=1, on_exhausted="raise",
                                                 timeout_factor=2.0))

        # a fresh devprof result set and this run's drain floor
        devprof.reset()
        journal = None
        resumed_from = 0
        if cache_store is not None:
            journal_path = os.path.join(obs_dir, "run_journal.jsonl")
            # the journal is append-only across runs: a killed run's
            # committed frontier is still here when --resume re-runs
            if resume:
                resumed_from = len(committed_fingerprints(read_journal(journal_path)))
                logger.info("resume: journal at %s records %d previously committed node result(s); "
                            "matching nodes will restore from %s", journal_path, resumed_from,
                            cache_store.root)
            journal = RunJournal(journal_path, writer)
            journal.append("run_begin", config_hash=config_hash(all_configs), cache_root=cache_store.root,
                           resume=bool(resume), executor=mode)
            sched.journal = journal
            # parts quarantined from here on also land in the journal
            ingest_guard.set_journal(journal)
            cache_capture.install_open_hook()
        # the live plane and trace rotation, both off by default (no
        # thread); acquired right before the try whose finally releases them
        telemetry_handle = telemetry.acquire(context="workflow")
        trace_rotator = maybe_rotator(obs_root, submit=writer.submit)
        run_err = None
        try:
            summary = sched.run(mode=mode)
            if journal is not None:
                journal.append("run_end", hits=summary["cache"]["hits"], misses=summary["cache"]["misses"])
            # barrier before the metrics snapshot: every queued write has
            # landed and booked its counters
            writer.drain()
            record_device_memory()
            record_cache_stats(cache_store)
            chaos_plan = chaos.plan()
            manifest = build_manifest(
                all_configs, summary, get_metrics().snapshot(), run_type=run_type,
                block_times=block_times(), trace_path=trace_dest and os.path.abspath(trace_dest),
                cache={"enabled": True, "root": cache_store.root, "resumed_from": resumed_from,
                       **summary["cache"]} if cache_store is not None else None,
                resilience={
                    **summary.get("resilience", {}),
                    "degraded_sections": res_policy.degraded_sections(),
                    "quarantine": ingest_guard.summary(),
                    "chaos": chaos_plan.summary() if chaos_plan else None,
                    # the postmortems written this run (none on a clean run)
                    "flight_dumps": [os.path.basename(p) for p in flight.dump_paths()],
                },
                devprof=devprof.results() or None,
            )
            # the manifest rides the async write queue; close() drains it
            writer.submit("obs:run_manifest", write_manifest, manifest, manifest_path)
        except BaseException as e:
            run_err = e
            raise
        finally:
            if trace_rotator is not None:
                # the final segment rides the writer: rotate before close()
                try:
                    trace_rotator.close()
                except Exception:
                    logger.exception("trace rotator close failed")
            try:
                writer.close()  # drain: surface any queued-write failure
            except Exception as close_err:
                if run_err is None:
                    raise
                # an aborted run's close() failure must not mask the node's
                # exception: log it and chain it onto the propagating one
                logger.exception("async artifact writes failed during aborted run")
                if run_err.__context__ is None:
                    if close_err.__context__ is run_err:
                        close_err.__context__ = None
                    run_err.__context__ = close_err
            if cache_store is not None:
                cache_capture.uninstall_open_hook()
                if run_err is None:
                    # load a restored final df before the sweep can evict
                    # its payload: the final write below reads it
                    pipe.current_df()
                _sweep(cache_store)
            if trace_dest and trace_rotator is None:
                # exported on failure too: an aborted run's trace is what
                # its post-mortem needs; a failed export must not mask the
                # run's own outcome (with rotation the rotator's final
                # flush already drained the ring into its last segment)
                try:
                    logger.info("chrome trace written to %s (open it in Perfetto or "
                                "chrome://tracing)", write_chrome_trace(os.path.abspath(trace_dest)))
                except Exception:
                    logger.exception("chrome trace export to %s failed", trace_dest)
            elif trace_rotator is not None and trace_rotator.segments:
                logger.info("chrome trace rotated into %d segment(s) next to %s",
                            len(trace_rotator.segments), trace_rotator.dest)
            telemetry.release(telemetry_handle)
        LAST_MANIFEST_PATH = manifest_path
        try:  # remote run_types publish the manifest next to the staged stats
            obs_store.push(manifest_path, os.path.join(obs_base, "obs"))
        except Exception:
            logger.exception("manifest push failed; local copy kept at %s", manifest_path)
        LAST_RUN_SUMMARY = summary
        logger.info(DagScheduler.format_summary(summary))
        df = pipe.current_df()
        if df is None and (write_main or all_configs.get("write_feast_features")):
            raise ValueError("write_main/write_feast_features require input_dataset — a "
                             "streaming-only run has no materialized table to write")

        # the feast export adds its timestamp columns before the one final
        # write, its config checked first; the repo file names the written part
        write_feast = all_configs.get("write_feast_features", None)
        if write_feast is not None:
            if write_main is None:
                raise ValueError("write_feast_features requires write_main")
            repartition_count = (write_main.get("file_configs") or {}).get("repartition", -1)
            feast_exporter.check_feast_configuration(write_feast, repartition_count)
            df = feast_exporter.add_timestamp_columns(df, write_feast["file_source"])
        if write_main:
            save(df, write_main, "final_dataset")
        if write_feast is not None:
            files = glob.glob(os.path.join(write_main["file_path"], "final_dataset", "part*"))
            feast_exporter.generate_feature_description(df.dtypes(), write_feast, files[0] if files else "")
    logger.info(f"execution time w/o report (in sec) = {round(time.monotonic() - start_main, 4)}")


def _sweep(store: CacheStore) -> None:
    """The end-of-run capacity bound: under ``ANOVOS_TPU_CACHE_MAX_BYTES``
    the store's LRU ``gc`` (the gc CLI's sweep); a failed sweep leaves the
    store as it is."""
    max_bytes = os.environ.get("ANOVOS_TPU_CACHE_MAX_BYTES", "")
    if not max_bytes:
        return
    try:
        stats = store.gc(parse_bytes(max_bytes))
    except Exception:
        logger.exception("cache gc failed; store left as-is")
        return
    if stats["evicted_nodes"] or stats["evicted_xla_files"]:
        logger.info("cache gc: %d node entr(ies) + %d xla file(s) evicted (%d -> %d bytes)",
                    len(stats["evicted_nodes"]), stats["evicted_xla_files"], stats["before_bytes"],
                    stats["after_bytes"])


def run(config_path: str, run_type: str = "local", auth_key_val: Optional[dict] = None,
        resume: bool = False) -> None:
    """Load the YAML config (pulled through the run_type store) → main.
    ``resume=True`` (the CLI's ``--resume``) re-runs a killed config in the
    same output directory: with ``ANOVOS_TPU_CACHE`` (the CLI defaults it)
    the nodes it committed restore instead of executing, and the streaming
    passes resume from their chunk checkpoints."""
    import yaml

    telemetry.check_unported_knobs()
    store = for_run_type(run_type, _auth_key(auth_key_val))
    if run_type == "ak8s" and not auth_key_val:
        raise ValueError("Invalid auth key for run_type")
    # remote configs (e.g. s3:// for emr) are pulled before reading
    config_file = store.pull(config_path, "config.yaml")
    with open(config_file, "r") as f:
        all_configs = yaml.load(f, yaml.SafeLoader)
    profile_dir = os.environ.get("ANOVOS_PROFILE", "")
    with (_profiled(profile_dir) if profile_dir else contextlib.nullcontext()):
        main(all_configs, run_type, auth_key_val, resume=resume)


@contextlib.contextmanager
def _profiled(profile_dir: str):
    """``torch.profiler`` over the block (the JAX runner's
    ``jax.profiler.trace``): CPU activity of every thread (the concurrent
    mode's nodes run on worker threads), and CUDA activity on a CUDA
    runtime, exported as a Chrome-format trace into ``profile_dir``
    (``anovos_torch_profile_<pid>.json``), on failure too.  The node
    brackets' ``record_function`` ranges put each kernel under its node."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    # the runtime main would take at its first Table: the CLI sets none
    rt = get_runtime()
    activities = [ProfilerActivity.CPU]
    if rt.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.__enter__()
    try:
        yield prof
    finally:
        if rt.device.type == "cuda":
            torch.cuda.synchronize(rt.device)
        prof.__exit__(None, None, None)
        path = os.path.join(profile_dir, f"anovos_torch_profile_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
