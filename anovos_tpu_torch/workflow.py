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
each node), resets the degradation registry and the ingest guard, and
points the guard's quarantine manifest at ``<master_path or write_main
path>/obs``.  :func:`main` and :func:`run` raise ``NotImplementedError``
on a knob of a layer the port does not have yet
(``obs/telemetry.UNPORTED_KNOBS``: the node cache, telemetry plane,
failover and multi-device knobs).

The run record, as in the JAX runner: every run resets the metrics
registry, the tracer (whose ring ``ANOVOS_TPU_TRACE_BUFFER`` bounds) and
the devprof results, and writes ``obs/run_manifest.json`` (the schedule,
block walls, metrics snapshot, per-node devprof split and resilience
record) through the async writer after the last node;
:data:`LAST_MANIFEST_PATH` names it.  ``ANOVOS_TPU_TRACE`` exports the
tracer's Chrome trace (``1``: ``obs/trace.json``), also when the run
fails.  :func:`run` under ``ANOVOS_PROFILE=<dir>`` records a
``torch.profiler`` trace of the whole run (CPU and CUDA activity on the
card) into ``<dir>``, with each node's kernels under its name.

``resume=True`` resumes only the ``streaming_analysis`` passes from their
chunk checkpoints (``obs/stream_ckpt/<sub-analysis>``) and runs every
other block again, as the JAX runner does without ``ANOVOS_TPU_CACHE``.
A config without ``input_dataset`` but with ``streaming_analysis`` or
``continuous_analysis`` reads no Table.  A ``transformers`` step resolves
its function on ``data_transformer.transformers`` by ``getattr``, so a
name that module lacks (a geospatial transformer) raises
``AttributeError``.  ``write_feast_features`` adds its two timestamp
columns before the final write and then writes the Feast repository file.
Each block's wall time is logged under the JAX runner's labels and kept
for :func:`block_times`; :data:`LAST_RUN_SUMMARY` holds the schedule's
summary (critical path, serial seconds, speedup).
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
from anovos_tpu_torch.obs.manifest import build_manifest, write_manifest
from anovos_tpu_torch.obs.metrics import record_device_memory
from anovos_tpu_torch.obs.tracing import buffer_size, trace_destination, write_chrome_trace
from anovos_tpu_torch.parallel.scheduler import DagScheduler, available_cpus
from anovos_tpu_torch.resilience import chaos
from anovos_tpu_torch.resilience import policy as res_policy
from anovos_tpu_torch.resilience.policy import ErrorPolicy
from anovos_tpu_torch.shared.artifact_store import AsyncArtifactWriter, for_run_type
from anovos_tpu_torch.shared.runtime import get_runtime, peek_runtime
from anovos_tpu_torch.shared.table import Table

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
    thread or a df version it read may be freed)."""
    rt = peek_runtime()
    if rt is not None and rt.device.type == "cuda":
        import torch

        torch.cuda.current_stream(rt.device).synchronize()


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
    releases the version it read."""

    def __init__(self, sched: DagScheduler, writer: AsyncArtifactWriter, df0: Optional[Table]):
        self.sched = sched
        self.writer = writer
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

    def current_df(self) -> Optional[Table]:
        return self._versions[self._ver]

    def _track(self, writes) -> None:
        for w in writes:
            if w not in self.artifact_keys:
                self.artifact_keys.append(w)

    # -- node registration -------------------------------------------------
    def spine(self, name, fn, reads=(), writes=(), timed=None, on_error=None,
              placement="mesh") -> None:
        """``fn(df) -> df`` changes the table: df version N → N+1."""
        v, out_v = self._ver, self._ver + 1
        self._ver = out_v
        self._claim(v)
        reads = tuple(reads)

        def body():
            self.writer.wait(reads)
            df_in = self._versions[v]
            t0 = time.monotonic()
            df_out = fn(df_in)
            if timed:
                _log_block_time(timed, t0)
            self._versions[out_v] = df_out if df_out is not None else df_in
            self._release(v)

        self.sched.add(name, body, reads=(f"df:{v}",) + reads, writes=(f"df:{out_v}",) + tuple(writes),
                       on_error=on_error if on_error is not None else self.spine_policy,
                       placement=placement)
        self._track(writes)

    def aside(self, name, fn, reads=(), writes=(), timed=None, on_error=None,
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
                       placement=placement)
        self._track(writes)

    def fanout(self, name, fn, reads=(), writes=(), timed=None, on_error=None,
               placement="mesh") -> None:
        """``fn(df)`` only reads the table: pinned to the current version."""
        v = self._ver
        self._claim(v)
        reads = tuple(reads)

        def body():
            self.writer.wait(reads)
            df_in = self._versions[v]
            t0 = time.monotonic()
            fn(df_in)
            if timed:
                _log_block_time(timed, t0)
            self._release(v)

        self.sched.add(name, body, reads=(f"df:{v}",) + reads, writes=tuple(writes),
                       on_error=on_error if on_error is not None else self.fanout_policy,
                       placement=placement)
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
    # (name, output file, function, positional arguments, keyword
    # arguments, extra resources written, placement)
    runs = []
    for name, file, fn, place in (("describe", "stream_describe.csv", describe_streaming, "device"),
                                  ("quality_missing", "stream_missing.csv",
                                   quality_checker.missing_stats_streaming, "host")):
        # an empty dict means "enabled with the defaults" (the YAML `describe: {}`)
        if args.get(name) is not None and args.get(name) is not False:
            runs.append((name, file, fn, (s_path, s_type),
                         args[name] if isinstance(args[name], dict) else {}, (), place))
    if args.get("quality_outlier"):
        o_cfg = dict(args["quality_outlier"])
        o_model = o_cfg.pop("model_path", None)
        if not o_model:
            raise TypeError("streaming_analysis.quality_outlier requires model_path "
                            "(pre-fitted outlier bounds)")
        runs.append(("quality_outlier", "stream_outlier.csv", quality_checker.outlier_stats_streaming,
                     (s_path, s_type, o_model), o_cfg, (), "device"))
    if args.get("drift"):
        dr_cfg = dict(args["drift"])
        dr_src = dr_cfg.pop("source_file_path", None)
        runs.append(("drift", "stream_drift.csv", ddetector.statistics_streaming, (s_path, s_type, dr_src),
                     dr_cfg, ("drift:model",), "device"))
    for name, file, fn, fn_args, cfg, extra, place in runs:
        key = "stats:" + file[:-len(".csv")]

        def _stream(name=name, file=file, fn=fn, fn_args=fn_args, cfg=cfg, key=key):
            odf = fn(*fn_args, chunk_rows=s_chunk, file_configs=s_fcfg,
                     checkpoint_dir=os.path.join(ckpt_base, name), resume=resume, **cfg)
            writer.submit(key, _write_frame_csv, odf, os.path.join(out_dir, file))

        pipe.aside(f"streaming_analysis/{name}", _stream, writes=(key,) + extra,
                   timed=f"streaming_analysis, {name}", placement=place)


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
    # when unset), an empty degradation registry and quarantine registry
    chaos.install_from_env()
    res_policy.reset_degraded()
    ingest_guard.reset()
    auth_key = _auth_key(auth_key_val)
    basic_report_flag = (all_configs.get("anovos_basic_report", {}) or {}).get("basic_report", False)
    if resume:
        logger.warning("--resume requested but ANOVOS_TPU_CACHE is unset; "
                       "nothing to resume from — executing every node")

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
    # a fresh flight-recorder ring per run (the continuum's alerts carry
    # its tail)
    flight.configure(obs_dir)

    # executor: ANOVOS_TPU_EXECUTOR wins; else concurrent wherever a second
    # CPU exists (worker threads on one core only timeshare it)
    mode = os.environ.get("ANOVOS_TPU_EXECUTOR", "") or (
        "concurrent" if available_cpus() > 1 else "sequential")
    writer = AsyncArtifactWriter(workers=int(os.environ.get("ANOVOS_TPU_WRITER_WORKERS", "2")),
                                 sync=(mode == "sequential"))
    sched = DagScheduler(name="workflow")
    pipe = _PipelineRun(sched, writer, df)

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
                pipe.spine("concatenate_dataset", _concat, timed="concatenate_dataset")
                continue

            if key == "join_dataset" and args is not None:
                def _join(df, args=args):
                    idfs = [df] + [ETL(args[k]) for k in args if k not in ("join_type", "join_cols")]
                    out = data_ingest.join_dataset(
                        *idfs, join_cols=args.get("join_cols"), join_type=args.get("join_type"))
                    return save(out, write_intermediate, "data_ingest/join_dataset",
                                reread=True, writer=writer)
                pipe.spine("join_dataset", _join, timed="join_dataset")
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
                               writes=("report:ts_autodetect",), timed="timeseries_analyzer")
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
                                writes=("report:ts_inspection",), timed="timeseries_analyzer")
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
                                timed="geospatial_controller")
                continue

            if key == "anovos_basic_report" and args is not None and args.get("basic_report", False):
                def _basic(df, args=args):
                    anovos_basic_report(df, **args.get("report_args", {}), run_type=run_type,
                                        auth_key=auth_key)
                pipe.fanout("anovos_basic_report", _basic, writes=("report:basic",), timed="Basic Report")
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
                                timed=f"stats_generator, {m}", placement="device")

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
                    pipe.spine(f"quality_checker/{subkey}", _qc, reads=_stats_deps(all_configs, subkey),
                               writes=(f"stats:{subkey}",), timed=f"quality_checker, {subkey}")

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
                    pipe.fanout(f"association_evaluator/{subkey}", _assoc,
                                reads=_stats_deps(all_configs, subkey), writes=(f"stats:{subkey}",),
                                timed=f"{key}, {subkey}", placement="device")

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
                                    source = base_df
                                else:
                                    source = ETL(src_spec)
                            # statistics() also persists the drift frequency
                            # model (the charts' drift tab reads it)
                            _stats_out(ddetector.statistics(df, source, **value["configs"]),
                                       "drift_statistics", "drift_detector/drift_statistics")
                        pipe.fanout("drift_detector/drift_statistics", _drift,
                                    writes=("stats:drift_statistics", "drift:model"),
                                    timed=f"{key}, drift_statistics")
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
                        pipe.fanout("drift_detector/stability_index", _stability,
                                    writes=("stats:stability_index", "stats:stabilityIndex_metrics"),
                                    timed=f"{key}, stability_index", on_error=stab_retry, placement="device")

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
                                   timed=f"{key}, {fn}")

            if key == "streaming_analysis" and args is not None:
                _register_streaming(pipe, writer, args, report_input_path, write_main, write_stats, resume)
                continue

            if key == "continuous_analysis" and args is not None:
                # one continuum step over the section's feed (a retry resumes
                # from the partitions the failed attempt committed)
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
                                    writes=("charts:objects",), timed=f"{key}, {subkey}")

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
        run_err = None
        try:
            summary = sched.run(mode=mode)
            # barrier before the metrics snapshot: every queued write has
            # landed and booked its counters
            writer.drain()
            record_device_memory()
            chaos_plan = chaos.plan()
            manifest = build_manifest(
                all_configs, summary, get_metrics().snapshot(), run_type=run_type,
                block_times=block_times(), trace_path=trace_dest and os.path.abspath(trace_dest),
                resilience={
                    **summary.get("resilience", {}),
                    "degraded_sections": res_policy.degraded_sections(),
                    "quarantine": ingest_guard.summary(),
                    "chaos": chaos_plan.summary() if chaos_plan else None,
                    # the flight recorder's dumps are not ported
                    "flight_dumps": [],
                },
                devprof=devprof.results() or None,
            )
            # the manifest rides the async write queue; close() drains it
            writer.submit("obs:run_manifest", write_manifest, manifest, manifest_path)
        except BaseException as e:
            run_err = e
            raise
        finally:
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
            if trace_dest:
                # exported on failure too: an aborted run's trace is what
                # its post-mortem needs; a failed export must not mask the
                # run's own outcome
                try:
                    logger.info("chrome trace written to %s (open it in Perfetto or "
                                "chrome://tracing)", write_chrome_trace(os.path.abspath(trace_dest)))
                except Exception:
                    logger.exception("chrome trace export to %s failed", trace_dest)
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


def run(config_path: str, run_type: str = "local", auth_key_val: Optional[dict] = None,
        resume: bool = False) -> None:
    """Load the YAML config (pulled through the run_type store) → main.
    ``resume=True`` (the CLI's ``--resume``) resumes the streaming passes
    of a killed run from their chunk checkpoints."""
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
