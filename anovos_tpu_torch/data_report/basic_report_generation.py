"""Condensed basic report (counterpart of
``anovos_tpu/data_report/basic_report_generation.py``).

Runs the descriptive stats + quality checks + association measures itself on
the input Table, writes their CSVs into ``output_path``, and renders a
compact HTML through the same renderer as the full report.
"""

from __future__ import annotations

import logging
import os

from anovos_tpu_torch.data_report.report_generation import anovos_report
from anovos_tpu_torch.data_report.report_preprocessing import charts_to_objects, save_stats
from anovos_tpu_torch.shared.artifact_store import for_run_type
from anovos_tpu_torch.shared.table import Table
from anovos_tpu_torch.shared.utils import ends_with

logger = logging.getLogger(__name__)

# the ONE copy of the saved-stats wiring tables (workflow.stats_args builds
# its superset mapping from these)
ARGS_TO_STATSFUNC = {
    "stats_unique": "measures_of_cardinality",
    "stats_mode": "measures_of_centralTendency",
    "stats_missing": "measures_of_counts",
}
CHECKER_STATS_ARGS = {
    "biasedness_detection": ["stats_mode"],
    "IDness_detection": ["stats_unique"],
    "nullColumns_detection": ["stats_unique", "stats_mode", "stats_missing"],
    "variable_clustering": ["stats_mode"],
}

STATS_FUNCS = (
    "global_summary",
    "measures_of_counts",
    "measures_of_centralTendency",
    "measures_of_cardinality",
    "measures_of_dispersion",
    "measures_of_percentiles",
    "measures_of_shape",
)
QUALITY_FUNCS = (
    "duplicate_detection",
    "nullRows_detection",
    "nullColumns_detection",
    "IDness_detection",
    "biasedness_detection",
    "outlier_detection",
    "invalidEntries_detection",
)


def stats_args(path, func) -> dict:
    """Read-spec kwargs pointing a quality-checker function at the basic
    report's pre-saved stats CSVs — {stats_unique/stats_mode/stats_missing:
    read_dataset kwargs} so the checker reuses saved
    cardinality/centralTendency/counts instead of recomputing them."""
    return {
        arg: {
            "file_path": ends_with(path) + ARGS_TO_STATSFUNC[arg] + ".csv",
            "file_type": "csv",
            "file_configs": {"header": True, "inferSchema": True},
        }
        for arg in CHECKER_STATS_ARGS.get(func, [])
    }


def anovos_basic_report(
    idf: Table,
    id_col: str = "",
    label_col: str = "",
    event_label: str = "",
    skip_corr_matrix: bool = False,
    output_path: str = "report_stats",
    run_type: str = "local",
    auth_key: str = "NA",
    mlflow_config=None,
    **_ignored,
) -> str:
    """Compute stats → save CSVs → render basic HTML."""
    from anovos_tpu_torch.data_analyzer import association_evaluator as ae
    from anovos_tpu_torch.data_analyzer import quality_checker as qc
    from anovos_tpu_torch.data_analyzer import stats_generator as sg

    drop = [c for c in [id_col] if c]

    for fn in STATS_FUNCS:
        try:
            save_stats(getattr(sg, fn)(idf, drop_cols=drop), output_path, fn, run_type=run_type, auth_key=auth_key)
        except TypeError as e:
            logger.warning("basic report: %s skipped (%s)", fn, e)

    # checkers reuse the stats CSVs the loop above just saved instead of
    # recomputing counts/cardinality/centralTendency per checker; the
    # store's staging dir is where save_stats wrote them for this run_type
    stats_dir = for_run_type(run_type, auth_key).staging_dir(output_path)
    for fn in QUALITY_FUNCS:
        try:
            # only reference CSVs that actually landed — a stats pass that
            # was skipped above degrades this checker to recomputation
            extra = {
                k: v for k, v in stats_args(stats_dir, fn).items()
                if os.path.exists(v["file_path"])
            }
            _, stats = getattr(qc, fn)(idf, drop_cols=drop, treatment=False, **extra)
            save_stats(stats, output_path, fn, run_type=run_type, auth_key=auth_key)
        except TypeError as e:
            logger.warning("basic report: %s skipped (%s)", fn, e)

    if label_col and not skip_corr_matrix:
        try:
            num_cols = idf.attribute_type_segregation()[0]
            corr = ae.correlation_matrix(idf, [c for c in num_cols if c != id_col])
            save_stats(corr, output_path, "correlation_matrix", run_type=run_type, auth_key=auth_key)
        except TypeError as e:
            logger.warning("basic report: correlation_matrix skipped (%s)", e)
    if label_col:
        try:
            save_stats(
                ae.IV_calculation(idf, drop_cols=drop, label_col=label_col, event_label=event_label),
                output_path,
                "IV_calculation",
                run_type=run_type, auth_key=auth_key,
            )
            save_stats(
                ae.IG_calculation(idf, drop_cols=drop, label_col=label_col, event_label=event_label),
                output_path,
                "IG_calculation",
                run_type=run_type, auth_key=auth_key,
            )
        except TypeError as e:
            logger.warning("basic report: IV/IG skipped (%s)", e)

    charts_to_objects(
        idf, drop_cols=drop, label_col=label_col or None, event_label=event_label,
        master_path=output_path, run_type=run_type, auth_key=auth_key,
    )
    return anovos_report(
        master_path=output_path,
        id_col=id_col,
        label_col=label_col,
        final_report_path=output_path,
        run_type=run_type,
        auth_key=auth_key,
    )
