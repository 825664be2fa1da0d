"""Config-driven pipeline runner (counterpart of ``anovos_tpu/workflow.py``).

Same YAML schema and the same reflection dispatch: top-level keys are
module blocks, nested keys are function names resolved by ``getattr``.
``stats_args`` injects previously saved stats CSVs into downstream
functions; ``save`` checkpoints intermediates.  The ``run_type`` axis
routes through the artifact store (``shared/artifact_store.py``).

The port runs the blocks one after the other in the YAML's order, on the
caller's thread, and writes every artifact before the next block starts
(the JAX runner's ``ANOVOS_TPU_EXECUTOR=sequential`` mode).  Each run
installs the chaos plan of ``ANOVOS_TPU_CHAOS``, resets the degradation
registry and the ingest guard, and points the guard's quarantine manifest
at ``<master_path or write_main path>/obs``.  It has no DAG scheduler,
node cache store, failover or obs run manifest, so ``resume=True``
resumes only the ``streaming_analysis`` passes from their chunk
checkpoints (``obs/stream_ckpt/<sub-analysis>``) and runs every other
block again, as the JAX runner does without ``ANOVOS_TPU_CACHE``.  A
config without ``input_dataset`` but with ``streaming_analysis`` or
``continuous_analysis`` reads no Table: each streaming pass reads its own
part files, and ``continuous_analysis`` runs one continuum step
(``continuum/watcher.step``: scan the feed directory, fold the partitions
that landed, re-finalize the artifacts and re-render the report
sections that changed).  A ``transformers`` step resolves its function on
``data_transformer.transformers`` by ``getattr``, as the JAX runner does,
so a name that module lacks (a geospatial transformer) raises
``AttributeError``.  ``write_feast_features`` adds its two timestamp
columns before the final write and then writes the Feast repository file.

Each block's wall time is logged under the JAX runner's labels and kept
for :func:`block_times`.  A fan-out section (an analyzer, stats metric,
association measure, drift, stability, the continuum step or the charts)
follows the JAX runner's fan-out policy: after a failure it runs again
``ANOVOS_TPU_RETRIES`` times (default 1) with the policy's backoff, then
it is logged, recorded in the degradation registry
(``resilience/policy.py``, read by :func:`degraded_sections`, beside the
parts the guard quarantined) and skipped (``ANOVOS_TPU_DEGRADE=0``: it
raises).  A failing ingest, quality, transformer, streaming or report
block ends the run.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import logging
import os
import time
from typing import Optional

import pandas as pd

from anovos_tpu_torch.data_analyzer import association_evaluator, quality_checker, stats_generator
from anovos_tpu_torch.data_analyzer.geospatial_analyzer import geospatial_autodetection
from anovos_tpu_torch.data_analyzer.ts_analyzer import ts_analyzer
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
from anovos_tpu_torch.obs import flight
from anovos_tpu_torch.resilience import chaos
from anovos_tpu_torch.resilience import policy as res_policy
from anovos_tpu_torch.shared.artifact_store import for_run_type
from anovos_tpu_torch.shared.table import Table

logger = logging.getLogger("anovos_tpu_torch.workflow")

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


def _log_block_time(label: str, start: float) -> None:
    """Add one block's wall seconds to its label (labels that recur, as
    ``timeseries_analyzer`` does, accumulate)."""
    secs = round(time.monotonic() - start, 4)
    _BLOCK_TIMES[label] = round(_BLOCK_TIMES.get(label, 0.0) + secs, 4)
    logger.info(f"{label}: execution time (in secs) = {secs}")


def block_times() -> dict:
    """Per-block wall seconds of the most recent ``main()`` run."""
    return dict(_BLOCK_TIMES)


def degraded_sections() -> dict:
    """{section: reason} of what the most recent ``main()`` run lost: the
    best-effort sections (see ``_best_effort``) that failed and were
    skipped, as the JAX runner skips them, under its section names, and
    the parts the ingest guard quarantined (``ingest/<file>``)."""
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


def save(data, write_configs: Optional[dict], folder_name: str):
    """Write a Table (or stats frame) under the write config's path and
    return the in-memory data; no write config → the data untouched."""
    if not write_configs:
        return data
    if "file_path" not in write_configs:
        raise TypeError("file path missing for writing data")
    write = copy.deepcopy(write_configs)
    write.pop("mlflow_run_id", "")
    write.pop("log_mlflow", False)
    write["file_path"] = os.path.join(write["file_path"], folder_name)
    table = Table.from_pandas(data) if isinstance(data, pd.DataFrame) else data
    data_ingest.write_dataset(table, **write)
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


def _best_effort(section: str, fn, *args, **kwargs):
    """``fn(...)`` under the JAX runner's policy for its fan-out sections
    (ts detection and inspection, the geo analyzer, each stats metric,
    each association measure, drift, stability, the continuum step and
    the charts): a failed call runs again ``ANOVOS_TPU_RETRIES`` times
    (default 1) after the policy's backoff; then the failure is logged
    and recorded, and the run goes on without the section's files (None),
    or it raises under ``ANOVOS_TPU_DEGRADE=0``."""
    pol = res_policy.ErrorPolicy(
        mode="retry", retries=int(os.environ.get("ANOVOS_TPU_RETRIES", "1")),
        on_exhausted="raise" if os.environ.get("ANOVOS_TPU_DEGRADE", "1") == "0" else "degrade")
    for attempt in range(1, pol.retries + 2):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if attempt <= pol.retries:
                logger.warning("%s failed (%r); running it again", section, e)
                time.sleep(res_policy.backoff_delay(section, attempt, pol))
                continue
            if pol.on_exhausted == "raise":
                raise
            logger.exception("%s failed after %d attempt(s); continuing without it", section, attempt)
            res_policy.record_degraded(section, f"{type(e).__name__}: {e}")
            return None


def _save_stats_or_write(df_stats, report_input_path, name, write_stats, folder, run_type, auth_key):
    if report_input_path:
        save_stats(df_stats, report_input_path, name, run_type=run_type, auth_key=auth_key)
    else:
        save(df_stats, write_stats, folder)


def _write_frame_csv(df: pd.DataFrame, path: str) -> None:
    """A streaming stats frame as one CSV file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    df.to_csv(path, index=False)


def _streaming_analysis(args: dict, report_input_path: str, write_main, write_stats,
                        resume: bool) -> None:
    """The ``streaming_analysis`` block: each enabled sub-analysis streams
    the part files under ``file_path`` (the table never materializes),
    checkpointed chunk by chunk under ``<master_path or write_main
    path>/obs/stream_ckpt/<sub-analysis>``, and writes its frame as
    ``stream_<name>.csv`` under ``output_path`` (else the master path,
    else write_stats' path, else ``stream_stats``)."""
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
    # (name, file, function, positional arguments, keyword arguments)
    runs = []
    for name, file, fn in (("describe", "stream_describe.csv", describe_streaming),
                           ("quality_missing", "stream_missing.csv", quality_checker.missing_stats_streaming)):
        # an empty dict means "enabled with the defaults" (the YAML `describe: {}`)
        if args.get(name) is not None and args.get(name) is not False:
            runs.append((name, file, fn, (s_path, s_type), args[name] if isinstance(args[name], dict) else {}))
    if args.get("quality_outlier"):
        o_cfg = dict(args["quality_outlier"])
        o_model = o_cfg.pop("model_path", None)
        if not o_model:
            raise TypeError("streaming_analysis.quality_outlier requires model_path "
                            "(pre-fitted outlier bounds)")
        runs.append(("quality_outlier", "stream_outlier.csv", quality_checker.outlier_stats_streaming,
                     (s_path, s_type, o_model), o_cfg))
    if args.get("drift"):
        dr_cfg = dict(args["drift"])
        dr_src = dr_cfg.pop("source_file_path", None)
        runs.append(("drift", "stream_drift.csv", ddetector.statistics_streaming, (s_path, s_type, dr_src),
                     dr_cfg))
    for name, file, fn, fn_args, cfg in runs:
        t0 = time.monotonic()
        odf = fn(*fn_args, chunk_rows=s_chunk, file_configs=s_fcfg,
                 checkpoint_dir=os.path.join(ckpt_base, name), resume=resume, **cfg)
        _write_frame_csv(odf, os.path.join(out_dir, file))
        _log_block_time(f"streaming_analysis, {name}", t0)


def _continuous_analysis(args: dict, base_dir: str) -> None:
    """The ``continuous_analysis`` block: one continuum step over the
    section's feed (``ContinuumConfig.from_dict(args, base_dir)``), a
    fan-out section ``continuous_analysis/step`` (a retry resumes from the
    partitions the failed attempt committed)."""
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig
    from anovos_tpu_torch.continuum.watcher import step as continuum_step

    summary = _best_effort("continuous_analysis/step",
                           lambda: continuum_step(ContinuumConfig.from_dict(dict(args), base_dir=base_dir)))
    if summary is not None:
        logger.info("continuous_analysis: folded=%d quarantined=%d alerts=%d partitions=%d",
                    len(summary["folded"]), len(summary["quarantined"]), summary["alerts"],
                    summary["partitions"])


def main(all_configs: dict, run_type: str = "local", auth_key_val: Optional[dict] = None,
         resume: bool = False) -> None:
    start_main = time.monotonic()
    _BLOCK_TIMES.clear()
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
    obs_dir = os.path.join(for_run_type(run_type, auth_key).staging_dir(obs_base), "obs")
    ingest_guard.configure(obs_dir)
    # a fresh flight-recorder ring per run (the continuum's alerts carry
    # its tail)
    flight.configure(obs_dir)

    with mlflow_ctx:
        for key, args in all_configs.items():
            if args is None:
                continue
            t0 = time.monotonic()

            if key == "concatenate_dataset":
                idfs = [df] + [ETL(args[k]) for k in args if k not in ("method", "method_type")]
                df = data_ingest.concatenate_dataset(
                    *idfs, method_type=args.get("method", args.get("method_type", "name")))
                df = save(df, write_intermediate, "data_ingest/concatenate_dataset")
                _log_block_time(key, t0)
                continue

            if key == "join_dataset":
                idfs = [df] + [ETL(args[k]) for k in args if k not in ("join_type", "join_cols")]
                df = data_ingest.join_dataset(
                    *idfs, join_cols=args.get("join_cols"), join_type=args.get("join_type"))
                df = save(df, write_intermediate, "data_ingest/join_dataset")
                _log_block_time(key, t0)
                continue

            if key == "timeseries_analyzer":
                # omit None-valued config keys so callee defaults apply
                opt = {k: v for k, v in args.items() if v is not None}
                if opt.get("auto_detection", False):
                    out = _best_effort(
                        "timeseries_analyzer/auto_detection", ts_preprocess, df, opt.get("id_col"),
                        output_path=report_input_path or ".", tz_offset=opt.get("tz_offset", "local"),
                        run_type=run_type)
                    df = df if out is None else out
                    _log_block_time(key, t0)
                if opt.get("inspection", False):
                    t1 = time.monotonic()
                    kw = {k: opt[k] for k in ("max_days", "tz_offset") if k in opt}
                    if "analysis_level" in opt:
                        kw["output_type"] = opt["analysis_level"]
                    _best_effort("timeseries_analyzer/inspection", ts_analyzer, df, opt.get("id_col"),
                                 output_path=report_input_path or ".", run_type=run_type, **kw)
                    _log_block_time(key, t1)
                continue

            if key == "geospatial_controller":
                ga = args.get("geospatial_analyzer", {}) or {}
                if ga.get("auto_detection_analyzer", False):
                    kw = {k: ga[k] for k in ("max_analysis_records", "top_geo_records", "max_cluster",
                                             "eps", "min_samples", "global_map_box_val")
                          if ga.get(k) is not None}
                    _best_effort("geospatial_controller", geospatial_autodetection, df, ga.get("id_col"),
                                 report_input_path or ".", run_type=run_type, **kw)
                    _log_block_time(key, t0)
                continue

            if key == "anovos_basic_report":
                if args.get("basic_report", False):
                    anovos_basic_report(df, **args.get("report_args", {}), run_type=run_type,
                                        auth_key=auth_key)
                    _log_block_time("Basic Report", t0)
                continue

            if basic_report_flag:
                continue

            if key == "stats_generator":
                # a repeated metric in a hand-edited YAML runs once
                for m in dict.fromkeys(args["metric"]):
                    t1 = time.monotonic()

                    def _stat(m=m):
                        df_stats = getattr(stats_generator, m)(df, **args["metric_args"])
                        _save_stats_or_write(df_stats, report_input_path, m, write_stats,
                                             "data_analyzer/stats_generator/" + m, run_type, auth_key)

                    _best_effort(f"stats_generator/{m}", _stat)
                    _log_block_time(f"stats_generator, {m}", t1)

            if key == "quality_checker":
                for subkey, value in args.items():
                    if value is None:
                        continue
                    t1 = time.monotonic()
                    extra_args = stats_args(all_configs, subkey, run_type, auth_key)
                    if subkey == "nullColumns_detection":
                        # upstream treatments invalidate the cached missing stats
                        if (args.get("invalidEntries_detection") or {}).get("treatment"):
                            extra_args["stats_missing"] = {}
                        outlier = args.get("outlier_detection") or {}
                        if outlier.get("treatment") and outlier.get("treatment_method") == "null_replacement":
                            extra_args["stats_missing"] = {}
                    df, df_stats = getattr(quality_checker, subkey)(df, **value, **extra_args)
                    df = save(df, write_intermediate, "data_analyzer/quality_checker/" + subkey + "/dataset")
                    _save_stats_or_write(df_stats, report_input_path, subkey, write_stats,
                                         "data_analyzer/quality_checker/" + subkey, run_type, auth_key)
                    _log_block_time(f"quality_checker, {subkey}", t1)

            if key == "association_evaluator":
                for subkey, value in args.items():
                    if value is None:
                        continue
                    t1 = time.monotonic()

                    def _assoc(subkey=subkey, value=value):
                        extra_args = stats_args(all_configs, subkey, run_type, auth_key)
                        df_in = df
                        cat_params = all_configs.get("cat_to_num_transformer", None)
                        if subkey == "correlation_matrix" and cat_params:
                            df_in = transformers.cat_to_num_transformer(df, **cat_params)
                        df_stats = getattr(association_evaluator, subkey)(df_in, **value, **extra_args)
                        _save_stats_or_write(df_stats, report_input_path, subkey, write_stats,
                                             "data_analyzer/association_evaluator/" + subkey, run_type,
                                             auth_key)

                    _best_effort(f"association_evaluator/{subkey}", _assoc)
                    _log_block_time(f"{key}, {subkey}", t1)

            if key == "drift_detector":
                for subkey, value in args.items():
                    if value is None or subkey not in ("drift_statistics", "stability_index"):
                        continue
                    t1 = time.monotonic()

                    def _drift(value=value):
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
                        # statistics() also persists the drift frequency model
                        # (the charts' drift tab reads it)
                        df_stats = ddetector.statistics(df, source, **value["configs"])
                        _save_stats_or_write(df_stats, report_input_path, "drift_statistics", write_stats,
                                             "drift_detector/drift_statistics", run_type, auth_key)

                    def _stability(value=value):
                        idfs = [ETL(value[k]) for k in value if k != "configs"]
                        df_stats = dstability.stability_index_computation(*idfs, **value["configs"])
                        if report_input_path:
                            save_stats(df_stats, report_input_path, "stability_index",
                                       run_type=run_type, auth_key=auth_key)
                            amp = value["configs"].get("appended_metric_path", "")
                            if amp:
                                metrics = data_ingest.read_dataset(amp, "csv", {"header": True})
                                save_stats(metrics.to_pandas(), report_input_path, "stabilityIndex_metrics",
                                           run_type=run_type, auth_key=auth_key)
                        else:
                            save(df_stats, write_stats, "drift_detector/stability_index")

                    _best_effort(f"{key}/{subkey}", _drift if subkey == "drift_statistics" else _stability)
                    _log_block_time(f"{key}, {subkey}", t1)

            if key == "transformers":
                for subkey, value in args.items():
                    if value is None:
                        continue
                    for fn, fn_args in value.items():
                        if fn_args is None:
                            continue
                        t1 = time.monotonic()
                        extra_args = stats_args(all_configs, fn, run_type, auth_key)
                        df = getattr(transformers, fn)(df, **fn_args, **extra_args)
                        df = save(df, write_intermediate, "data_transformer/transformers/" + fn)
                        _log_block_time(f"{key}, {fn}", t1)

            if key == "streaming_analysis":
                _streaming_analysis(args, report_input_path, write_main, write_stats, resume)
                continue

            if key == "continuous_analysis":
                _continuous_analysis(args, report_input_path or (write_main or {}).get("file_path") or ".")
                _log_block_time("continuous_analysis", t0)
                continue

            if key == "report_preprocessing":
                for subkey, value in args.items():
                    if subkey == "charts_to_objects" and value is not None:
                        t1 = time.monotonic()
                        extra_args = stats_args(all_configs, subkey, run_type, auth_key)
                        _best_effort(f"{key}/{subkey}", charts_to_objects, df, **value, **extra_args,
                                     master_path=report_input_path, run_type=run_type, auth_key=auth_key)
                        _log_block_time(f"{key}, {subkey}", t1)

            if key == "report_generation":
                anovos_report(**args, run_type=run_type, auth_key=auth_key)
                _log_block_time(f"{key}, full_report", t0)

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

    store = for_run_type(run_type, _auth_key(auth_key_val))
    if run_type == "ak8s" and not auth_key_val:
        raise ValueError("Invalid auth key for run_type")
    # remote configs (e.g. s3:// for emr) are pulled before reading
    config_file = store.pull(config_path, "config.yaml")
    with open(config_file, "r") as f:
        all_configs = yaml.load(f, yaml.SafeLoader)
    main(all_configs, run_type, auth_key_val, resume=resume)
