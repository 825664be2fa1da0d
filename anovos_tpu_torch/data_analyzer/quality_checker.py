"""Data-quality checks and their treatments (counterpart of
``anovos_tpu/data_analyzer/quality_checker.py``).

Every check returns ``(treated_table, stats_frame)`` with the JAX
package's stats schemas.  The row-wise work runs on the table's device:
row hashes narrow duplicate candidates, per-row null counts, the outlier
fences (moments kernel and device sort) and their flags.  String work runs
once per distinct value on the host: the vocabulary of a categorical
column, the sorted distinct values of a numeric one.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import warnings
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_analyzer import stats_generator as sg
from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
from anovos_tpu_torch.data_ingest.data_sampling import data_sample
from anovos_tpu_torch.data_transformer.model_io import load_model_df, save_model_df
from anovos_tpu_torch.data_transformer.imputers import (auto_imputation, imputation_matrixFactorization,
                                                        imputation_sklearn)
from anovos_tpu_torch.data_transformer.transformers import _emit, imputation_MMM
from anovos_tpu_torch.obs.timed import timed
from anovos_tpu_torch.ops.quantiles import masked_quantiles
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.ops.segment import row_signature, vocab_lookup
from anovos_tpu_torch.shared.table import Column, Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)

_R = lambda v: round(float(v), 4)


def _discrete_cols(idf: Table, list_of_cols, drop_cols) -> List[str]:
    num_all, cat_all, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all + cat_all, idf.col_names,
                      drop_cols)
    bad = [c for c in cols if c not in idf.columns]
    if bad or not cols:
        raise TypeError("Invalid input for Column(s)")
    return cols


def _check_bool(treatment) -> bool:
    if str(treatment).lower() == "true":
        return True
    if str(treatment).lower() == "false":
        return False
    raise TypeError("Non-Boolean input for treatment")


def _hash_lanes(col: Column) -> List[torch.Tensor]:
    """int32 lanes whose values identify a column's stored values: the
    exact int64/float64 split in two halves, int32 data as it is, f32 data
    by its bits with -0.0 made +0.0, so that equal values hash equally."""
    if col.exact is not None:
        bits = col.exact if col.exact.dtype == torch.int64 else (col.exact + 0.0).view(torch.int64)
        return [(bits >> 32).to(torch.int32), (bits & 0xFFFFFFFF).to(torch.int32)]
    if col.data.dtype == torch.float32:
        return [(col.data + 0.0).view(torch.int32)]
    return [col.data.to(torch.int32)]


def duplicate_detection(
    idf: Table, list_of_cols="all", drop_cols=[], treatment=False, print_impact=False
) -> Tuple[Table, pd.DataFrame]:
    """Full-row duplicates over the selected columns.  Row signatures on
    the device narrow the candidates to rows whose signature repeats; only
    those rows go to the host for exact ``pandas.duplicated``."""
    cols = _discrete_cols(idf, list_of_cols, drop_cols)
    treatment = _check_bool(treatment)
    sub = idf.select(cols)
    lanes, masks = [], []
    for c in cols:
        ls = _hash_lanes(sub.columns[c])
        lanes.extend(ls)
        masks.extend([sub.columns[c].mask] * len(ls))
    sig = row_signature(torch.stack(lanes, 1), torch.stack(masks, 1))
    # one int64 key a row, a bijection of the two 32-bit hashes
    key = (sig[:, 0] - 2**31) * 2**32 + sig[:, 1]
    _, inv, cnt = torch.unique(key, return_inverse=True, return_counts=True)
    coll_rows = torch.nonzero(cnt[inv] > 1).flatten().cpu().numpy()
    keep = np.ones(idf.nrows, dtype=bool)
    if len(coll_rows):
        host = sub.gather_rows(coll_rows).to_pandas()
        keep[coll_rows] = ~host.duplicated().to_numpy()
    n_unique = int(keep.sum())
    odf = idf.filter_rows(keep) if treatment else idf
    stats = pd.DataFrame(
        [
            ["rows_count", float(idf.nrows)],
            ["unique_rows_count", float(n_unique)],
            ["duplicate_rows", float(idf.nrows - n_unique)],
            ["duplicate_pct", _R((idf.nrows - n_unique) / max(idf.nrows, 1))],
        ],
        columns=["metric", "value"],
    )
    if print_impact:
        logger.info(stats.to_string(index=False))
    return odf, stats


def nullRows_detection(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    treatment=False,
    treatment_threshold: float = 0.8,
    print_impact=False,
) -> Tuple[Table, pd.DataFrame]:
    """Rows whose count of null columns exceeds threshold·ncols (all of
    them at threshold 1): one masked reduction along the column axis and a
    bincount of its result."""
    cols = _discrete_cols(idf, list_of_cols, drop_cols)
    treatment = _check_bool(treatment)
    treatment_threshold = float(treatment_threshold)
    if not (0 <= treatment_threshold <= 1):
        raise TypeError("Invalid input for Treatment Threshold Value")
    k = len(cols)
    null_cnt = k - torch.stack([idf.columns[c].mask for c in cols], 1).sum(dim=1)
    if treatment_threshold == 1:
        flag_of = lambda n: n == k  # noqa: E731
    else:
        flag_of = lambda n: n > k * treatment_threshold  # noqa: E731
    counts = torch.bincount(null_cnt, minlength=k + 1).cpu().numpy()
    present = np.flatnonzero(counts)
    stats = pd.DataFrame({
        "null_cols_count": present.astype(np.int32),
        "row_count": counts[present].astype(np.int64),
        "row_pct": (counts[present] / max(idf.nrows, 1)).round(4),
        "flagged": flag_of(present).astype(int),
    })
    odf = idf
    if treatment:
        odf = idf.filter_rows(~flag_of(null_cnt))
        stats = stats.rename(columns={"flagged": "treated"})
    if print_impact:
        logger.info(stats.to_string(index=False))
    return odf, stats


def nullColumns_detection(
    idf: Table,
    list_of_cols="missing",
    drop_cols=[],
    treatment=False,
    treatment_method: str = "row_removal",
    treatment_configs: dict = {},
    stats_missing: dict = {},
    stats_unique: dict = {},
    stats_mode: dict = {},
    print_impact=False,
) -> Tuple[Table, pd.DataFrame]:
    """Missing values per column, treated by row_removal, column_removal,
    MMM or the model-based imputers: KNN and regression
    (``imputation_sklearn``), MF (``imputation_matrixFactorization``) and
    auto (``auto_imputation``)."""
    if stats_missing:
        stats = read_dataset(**stats_missing).to_pandas()[["attribute", "missing_count", "missing_pct"]]
    else:
        stats = sg.missingCount_computation(idf)
    missing_cols = list(stats.loc[stats["missing_count"] > 0, "attribute"])
    num_all, cat_all, _ = idf.attribute_type_segregation()
    if list_of_cols == "all":
        cols = num_all + cat_all
    elif list_of_cols == "missing":
        cols = missing_cols
    else:
        cols = parse_cols(list_of_cols, idf.col_names, [])
    dropset = set(drop_cols.split("|") if isinstance(drop_cols, str) else drop_cols)
    cols = [c for c in cols if c not in dropset]
    if not cols:
        warnings.warn("No Null Detection - No column(s) to analyze")
        return idf, pd.DataFrame(columns=["attribute", "missing_count", "missing_pct"])
    if any(c not in idf.columns for c in cols):
        raise TypeError("Invalid input for Column(s)")
    treatment = _check_bool(treatment)
    valid_methods = ("row_removal", "column_removal", "KNN", "regression", "MF", "MMM", "auto")
    if treatment_method not in valid_methods:
        raise TypeError("Invalid input for method_type")
    stats = stats[stats["attribute"].isin(cols)].reset_index(drop=True)
    odf = idf
    if treatment:
        threshold = treatment_configs.get("treatment_threshold", None)
        cfg = {k: v for k, v in treatment_configs.items() if k != "treatment_threshold"}
        if treatment_method == "row_removal":
            # 100%-missing columns stay out of the complete-case subset
            # (they would empty the table); a threshold keeps the columns
            # above it
            pct = stats.set_index("attribute")["missing_pct"].astype(float)
            subset = [c for c in cols if pct.get(c, 0.0) < 1.0]
            if threshold is not None:
                subset = [c for c in subset if pct.get(c, 0.0) > float(threshold)]
            if subset:
                M = torch.stack([idf.columns[c].mask for c in subset], 1)
                odf = idf.filter_rows(M.all(dim=1))
        elif treatment_method == "column_removal":
            if threshold is None:
                raise TypeError("Invalid input for column removal threshold")
            odf = idf.drop(list(stats.loc[stats["missing_pct"] > float(threshold), "attribute"]))
        elif treatment_method == "MMM":
            odf = imputation_MMM(idf, list_of_cols=cols, stats_missing=stats_missing, **cfg)
        elif treatment_method in ("KNN", "regression"):
            cfg.setdefault("method_type", treatment_method)
            odf = imputation_sklearn(idf, list_of_cols=[c for c in cols if idf.columns[c].kind == "num"],
                                     **cfg)
        elif treatment_method == "MF":
            odf = imputation_matrixFactorization(
                idf, list_of_cols=[c for c in cols if idf.columns[c].kind == "num"], **cfg)
        else:  # auto
            odf = auto_imputation(idf, list_of_cols=cols, stats_missing=stats_missing, **cfg)
    if print_impact:
        logger.info(stats.to_string(index=False))
    return odf, stats


def _load_outlier_model(model_path: str):
    """Persisted outlier bounds (``outlier_numcols``): {attribute: [lo, hi]}
    (None = open side) and the skewed attributes."""
    dfm = load_model_df(model_path, "outlier_numcols")
    bounds: Dict[str, list] = {}
    skewed: List[str] = []
    for _, r in dfm.iterrows():
        p = list(r["parameters"])
        if "skewed_attribute" in [str(x) for x in p]:
            skewed.append(r["attribute"])
        else:
            bounds[r["attribute"]] = [
                None if x is None or (isinstance(x, float) and np.isnan(x)) else float(x) for x in p
            ]
    return bounds, skewed


_DEFAULT_DETECTION = {"pctile_lower": 0.05, "pctile_upper": 0.95, "stdev_lower": 3.0,
                      "stdev_upper": 3.0, "IQR_lower": 1.5, "IQR_upper": 1.5, "min_validation": 2}


def outlier_detection(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    detection_side: str = "upper",
    detection_configs: dict = _DEFAULT_DETECTION,
    treatment=False,
    treatment_method: str = "value_replacement",
    pre_existing_model: bool = False,
    model_path: str = "NA",
    sample_size: int = 1000000,
    output_mode: str = "replace",
    print_impact=False,
) -> Tuple[Table, pd.DataFrame]:
    """Outlier fences from three detectors voted by ``min_validation``:
    percentiles, mean ± k·stddev and the IQR fences; the bound is the
    n-th tightest candidate.  Columns whose lower and upper percentiles
    coincide (skewed) are left out.  Tables above ``sample_size`` rows fit
    on a random sample of that size (seed 11).  Bounds persist to
    ``<model_path>/outlier_numcols`` as [attribute, parameters]."""
    num_all, _, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, num_all, drop_cols)
    if not cols:
        warnings.warn("No Outlier Detection - No numerical column(s) to analyze")
        return idf, pd.DataFrame(columns=["attribute", "lower_outliers", "upper_outliers"])
    if detection_side not in ("upper", "lower", "both"):
        raise TypeError("Invalid input for detection_side")
    if treatment_method not in ("null_replacement", "row_removal", "value_replacement"):
        raise TypeError("Invalid input for treatment_method")
    treatment = _check_bool(treatment)
    cfg = dict(detection_configs)
    skewed_cols: List[str] = []

    if pre_existing_model:
        bounds, model_skewed = _load_outlier_model(model_path)
        skewed_cols.extend(model_skewed)
        cols = [c for c in cols if c in bounds]
        lower = np.array([bounds[c][0] if bounds[c][0] is not None else -np.inf for c in cols])
        upper = np.array([bounds[c][1] if bounds[c][1] is not None else np.inf for c in cols])
    else:
        lower_m = {m for m in ("pctile", "stdev", "IQR") if f"{m}_lower" in cfg}
        upper_m = {m for m in ("pctile", "stdev", "IQR") if f"{m}_upper" in cfg}
        if detection_side == "both" and lower_m != upper_m:
            raise TypeError(
                "Invalid input for detection_configs: methodologies used on both sides should be the same")
        methodologies = sorted(upper_m if detection_side == "upper" else lower_m,
                               key=["pctile", "stdev", "IQR"].index)
        if not methodologies:
            raise TypeError("Invalid input for detection_configs: no methodology specified")
        n_vote = int(cfg.get("min_validation", len(methodologies)))
        if n_vote > len(methodologies):
            raise TypeError("Invalid input for min_validation of detection_configs.")
        sub = idf
        if idf.nrows > sample_size:
            sub = data_sample(idf, fraction=sample_size / idf.nrows, method_type="random",
                              seed_value=11)
        X, M = sub.numeric_block(cols)
        qs = [cfg.get("pctile_lower", 0.05), cfg.get("pctile_upper", 0.95), 0.25, 0.75]
        Q = masked_quantiles(X, M, qs, interpolation="lower").cpu().numpy()
        mom = masked_moments(X, M)
        mean = mom["mean"].cpu().numpy().astype(np.float64)
        std = mom["stddev"].cpu().numpy().astype(np.float64)
        p_lo, p_hi, q1, q3 = Q[0], Q[1], Q[2], Q[3]
        skew_mask = p_lo == p_hi
        if skew_mask.any():
            skewed_cols = [c for c, s in zip(cols, skew_mask) if s]
            warnings.warn("Columns excluded from outlier detection due to highly skewed distribution: "
                          + ",".join(skewed_cols))
            keepm = ~skew_mask
            cols = [c for c, k in zip(cols, keepm) if k]
            p_lo, p_hi, q1, q3 = p_lo[keepm], p_hi[keepm], q1[keepm], q3[keepm]
            mean, std = mean[keepm], std[keepm]
        cand_lo, cand_hi = [], []
        if "pctile" in methodologies:
            cand_lo.append(p_lo)
            cand_hi.append(p_hi)
        if "stdev" in methodologies:
            cand_lo.append(mean - cfg.get("stdev_lower", 0.0) * std)
            cand_hi.append(mean + cfg.get("stdev_upper", 0.0) * std)
        if "IQR" in methodologies:
            iqr = q3 - q1
            cand_lo.append(q1 - cfg.get("IQR_lower", 0.0) * iqr)
            cand_hi.append(q3 + cfg.get("IQR_upper", 0.0) * iqr)
        # the lower bound is the n-th largest lower candidate, the upper
        # bound the n-th smallest upper one
        lower = np.sort(np.stack(cand_lo, 0), axis=0)[::-1][n_vote - 1]
        upper = np.sort(np.stack(cand_hi, 0), axis=0)[n_vote - 1]
        if detection_side == "upper":
            lower = np.full_like(lower, -np.inf)
        elif detection_side == "lower":
            upper = np.full_like(upper, np.inf)
        if model_path != "NA":
            skew_param = {"lower": ["skewed_attribute", None], "upper": [None, "skewed_attribute"],
                          "both": ["skewed_attribute", "skewed_attribute"]}[detection_side]
            rows = [{"attribute": c,
                     "parameters": [None if not np.isfinite(lo) else str(lo),
                                    None if not np.isfinite(hi) else str(hi)]}
                    for c, lo, hi in zip(cols, lower, upper)]
            rows += [{"attribute": c, "parameters": skew_param} for c in skewed_cols]
            save_model_df(pd.DataFrame(rows), model_path, "outlier_numcols")

    if not cols:
        return idf, pd.DataFrame(columns=["attribute", "lower_outliers", "upper_outliers"])
    X, M = idf.numeric_block(cols)
    dev = X.device
    lo_d = torch.as_tensor(lower.astype(np.float32), device=dev)
    hi_d = torch.as_tensor(upper.astype(np.float32), device=dev)
    # flag: −1 below, +1 above, 0 in range or null
    flag = (M & (X > hi_d)).to(torch.int8) - (M & (X < lo_d)).to(torch.int8)
    stats = pd.DataFrame({"attribute": cols,
                          "lower_outliers": (flag == -1).sum(dim=0).cpu().numpy(),
                          "upper_outliers": (flag == 1).sum(dim=0).cpu().numpy()})
    odf = idf
    if treatment:
        if treatment_method == "row_removal":
            odf = idf.filter_rows((flag == 0).all(dim=1))
        else:
            new_cols: "OrderedDict[str, Column]" = OrderedDict()
            if treatment_method == "value_replacement":
                T = torch.where(M, torch.minimum(torch.maximum(X, lo_d), hi_d), 0.0)
                for i, c in enumerate(cols):
                    new_cols[c] = Column("num", T[:, i], idf.columns[c].mask, dtype_name="double")
            else:  # null_replacement
                ok = M & (flag == 0)
                T = torch.where(ok, X, 0.0)
                for i, c in enumerate(cols):
                    new_cols[c] = Column("num", T[:, i], ok[:, i], dtype_name=idf.columns[c].dtype_name)
            odf = _emit(idf, new_cols, output_mode, "_outliered")
    if print_impact:
        logger.info(stats.to_string(index=False))
    return odf, stats


def IDness_detection(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    treatment=False,
    treatment_threshold: float = 0.8,
    stats_unique: dict = {},
    print_impact=False,
) -> Tuple[Table, pd.DataFrame]:
    """Columns whose IDness (distinct / non-null) reaches the threshold;
    the treatment drops them.  Stats [attribute, unique_values, IDness,
    flagged or treated]."""
    cols = _discrete_cols(idf, list_of_cols, drop_cols)
    treatment = _check_bool(treatment)
    treatment_threshold = float(treatment_threshold)
    if stats_unique:
        stats = read_dataset(**stats_unique).to_pandas()
        stats = stats[stats["attribute"].isin(cols)].reset_index(drop=True)
        if "IDness" not in stats.columns:
            stats = sg.measures_of_cardinality(idf, cols)
    else:
        stats = sg.measures_of_cardinality(idf, cols)
    stats["flagged"] = (stats["IDness"] >= treatment_threshold).astype(int)
    odf = idf
    if treatment:
        odf = idf.drop(list(stats.loc[stats["flagged"] == 1, "attribute"]))
        stats = stats.rename(columns={"flagged": "treated"})
    if print_impact:
        logger.info(stats.to_string(index=False))
    return odf, stats


def biasedness_detection(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    treatment=False,
    treatment_threshold: float = 0.8,
    stats_mode: dict = {},
    print_impact=False,
) -> Tuple[Table, pd.DataFrame]:
    """Columns whose mode share reaches the threshold (a null share is
    flagged too); the treatment drops them.  Stats [attribute, mode,
    mode_rows, mode_pct, flagged or treated]."""
    cols = _discrete_cols(idf, list_of_cols, drop_cols)
    treatment = _check_bool(treatment)
    treatment_threshold = float(treatment_threshold)
    if stats_mode:
        ct = read_dataset(**stats_mode).to_pandas()
        ct = ct[ct["attribute"].isin(cols)].reset_index(drop=True)
    else:
        ct = sg.measures_of_centralTendency(idf, cols)
    stats = ct[["attribute", "mode", "mode_rows", "mode_pct"]].copy()
    pct = pd.to_numeric(stats["mode_pct"], errors="coerce")
    stats["flagged"] = ((pct >= treatment_threshold) | pct.isna()).astype(int)
    odf = idf
    if treatment:
        odf = idf.drop(list(stats.loc[stats["flagged"] == 1, "attribute"]))
        stats = stats.rename(columns={"flagged": "treated"})
    if print_impact:
        logger.info(stats.to_string(index=False))
    return odf, stats


_NULL_VOCAB = ["", " ", "nan", "null", "na", "inf", "n/a", "not defined", "none",
               "undefined", "blank", "unknown"]
_SPECIAL_CHARS = ["&", "$", ";", ":", ".", ",", "*", "#", "@", "_", "?", "%", "!", "^",
                  "(", ")", "-", "/", "'"]
_REPEAT_RE = re.compile(r"\b([a-zA-Z0-9])\1\1+\b")
_AUTO_VOCAB_ARR = np.array(_NULL_VOCAB + _SPECIAL_CHARS)


def _is_invalid_value(e: str, detection_type: str, invalid_entries: List[str],
                      valid_entries: List[str], partial_match: bool) -> bool:
    """Whether one value is invalid: in auto mode a null synonym, a lone
    special character, a token of three or more repeated characters or a
    run of three or more consecutive characters; in manual mode a match of
    ``invalid_entries`` or no match of ``valid_entries``."""
    s = str(e).lower().strip()
    if detection_type in ("auto", "both"):
        if s in _NULL_VOCAB or s in _SPECIAL_CHARS:
            return True
        if _REPEAT_RE.search(s):
            return True
        if len(s) >= 3 and all(ord(s[i]) - ord(s[i - 1]) == 1 for i in range(1, len(s))):
            return True
    if detection_type in ("manual", "both"):
        def hit(rx):
            p = re.compile(rx)
            return (partial_match and p.search(s)) or (not partial_match and p.fullmatch(s))

        if any(hit(rx) for rx in invalid_entries):
            return True
        if valid_entries and not any(hit(rx) for rx in valid_entries):
            return True
    return False


def _is_invalid_values_bulk(values, detection_type: str, invalid_entries: List[str],
                            valid_entries: List[str], partial_match: bool,
                            normalized: bool = False) -> np.ndarray:
    """``_is_invalid_value`` over many distinct values.  In auto mode a
    numpy pre-filter keeps only the values that can be invalid (in the
    vocabulary, three equal adjacent characters, or a whole run of
    consecutive ones) and the per-value check runs on those alone; manual
    lists check every value.  ``normalized``: the values are already
    lowercase and stripped (numeric reprs)."""
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=bool)
    U = np.array(list(map(str, values)), dtype="U")
    if not normalized:
        U = np.char.strip(np.char.lower(U))
    if detection_type in ("manual", "both") and (invalid_entries or valid_entries):
        cand = np.ones(n, dtype=bool)
    elif detection_type not in ("auto", "both"):
        return np.zeros(n, dtype=bool)
    else:
        width = U.dtype.itemsize // 4
        cand = np.isin(U, _AUTO_VOCAB_ARR)
        if width >= 3:
            C = np.ascontiguousarray(U).view(np.uint32).reshape(n, width)
            eq3 = (C[:, 2:] == C[:, 1:-1]) & (C[:, 1:-1] == C[:, :-2]) & (C[:, 2:] != 0)
            cand |= eq3.any(axis=1)
            lens = np.char.str_len(U)
            steps = ((C[:, 1:].astype(np.int64) - C[:, :-1].astype(np.int64)) == 1) & (C[:, 1:] != 0)
            cand |= (lens >= 3) & (steps.sum(axis=1) == lens - 1)
    out = np.zeros(n, dtype=bool)
    for i in np.flatnonzero(cand):
        out[i] = _is_invalid_value(str(U[i]), detection_type, invalid_entries, valid_entries,
                                   partial_match)
    return out


def _unique_sorted(col: Column) -> torch.Tensor:
    """Sorted distinct valid values of a numeric column, on its device.
    Integer columns stay integer (an f32 cast merges ints above 2^24);
    others are f32, as the JAX package compacts them."""
    data = col.data if not col.data.dtype.is_floating_point else col.data.to(torch.float32)
    return torch.unique(data[col.mask], sorted=True)


def invalidEntries_detection(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    detection_type: str = "auto",
    invalid_entries: List[str] = [],
    valid_entries: List[str] = [],
    partial_match: bool = False,
    treatment=False,
    treatment_method: str = "null_replacement",
    treatment_configs: dict = {},
    treatment_threshold=None,
    stats_missing: dict = {},
    stats_unique: dict = {},
    stats_mode: dict = {},
    output_mode: str = "replace",
    print_impact=False,
) -> Tuple[Table, pd.DataFrame]:
    """Invalid entries per column: the checks of ``_is_invalid_value`` run
    once per distinct value (the vocabulary of a categorical column, the
    distinct values of a numeric one, as ``str(int(v))`` or
    ``str(float(v))`` of the stored f32 value), then membership maps back to
    the rows on the device.  Treatments: null_replacement, column_removal,
    MMM.  Stats [attribute, invalid_entries, invalid_count, invalid_pct]."""
    cols = _discrete_cols(idf, list_of_cols, drop_cols)
    treatment = _check_bool(treatment)
    if treatment_method not in ("null_replacement", "column_removal", "MMM"):
        raise TypeError("Invalid input for method_type")
    rows_stats = []
    invalid_masks: Dict[str, torch.Tensor] = {}
    for c in cols:
        col = idf.columns[c]
        if col.kind == "cat":
            bad = _is_invalid_values_bulk(list(col.vocab), detection_type, invalid_entries,
                                          valid_entries, partial_match)
            bad_vals = [str(v) for v in col.vocab[bad]]
            lut = np.zeros(max(len(col.vocab), 1), dtype=bool)
            lut[np.flatnonzero(bad)] = True
            inv = col.mask & (col.data >= 0) & vocab_lookup(lut, col.data)
        else:
            if col.is_wide_int:
                uniq = torch.unique(col.exact[col.mask], sorted=True)
                values = col.exact
            else:
                uniq = _unique_sorted(col)
                values = col.data
            # str() of the Python int or float of each value: an f32 value
            # through tolist() is the float64 holding it, as float(u) gives
            reprs = list(map(str, uniq.cpu().tolist()))
            bad = _is_invalid_values_bulk(reprs, detection_type, invalid_entries, valid_entries,
                                          partial_match, normalized=True)
            bad_vals = [r for r, b in zip(reprs, bad) if b]
            bad_set = uniq[torch.as_tensor(bad, device=uniq.device)]
            inv = col.mask & torch.isin(values.to(uniq.dtype), bad_set)
        cnt = int(inv.sum())
        invalid_masks[c] = inv
        rows_stats.append({"attribute": c, "invalid_entries": "|".join(sorted(bad_vals)),
                           "invalid_count": cnt, "invalid_pct": _R(cnt / max(idf.nrows, 1))})
    stats = pd.DataFrame(rows_stats,
                         columns=["attribute", "invalid_entries", "invalid_count", "invalid_pct"])
    odf = idf
    if treatment:
        if treatment_threshold:
            target_cols = list(stats.loc[stats["invalid_pct"] > float(treatment_threshold), "attribute"])
        else:
            target_cols = cols
        if treatment_method == "column_removal":
            odf = idf.drop(target_cols)
        else:
            odf = _emit(idf, OrderedDict(
                (c, dataclasses.replace(idf.columns[c], mask=idf.columns[c].mask & ~invalid_masks[c]))
                for c in target_cols), output_mode, "_invalid")
            if treatment_method == "MMM":
                cfg = {k: v for k, v in treatment_configs.items() if k != "treatment_threshold"}
                odf = imputation_MMM(odf, list_of_cols=target_cols, **cfg)
    if print_impact:
        logger.info(stats.to_string(index=False))
    return odf, stats


# ---------------------------------------------------------------------------
# out-of-core streaming variants: whole-table quality passes over the
# prefetched chunk iterator (ops/streaming.py), the same stats frames as the
# in-memory checks, with chunk checkpoints so a killed run resumes
# ---------------------------------------------------------------------------
def _outlier_counts_dispatch(lo: torch.Tensor, hi: torch.Tensor):
    """The chunk work of ``outlier_stats_streaming``: the outlier flags
    of the in-memory check (f32 compares against f32 bounds; a value both
    above the upper and below the lower bound flags 0) reduced to two
    int64 (k,) count vectors on the device."""

    def dispatch(Xc: torch.Tensor, Mc: torch.Tensor) -> Dict[str, torch.Tensor]:
        above, below = Xc > hi[:, None], Xc < lo[:, None]
        return {"n_lo": (Mc & below & ~above).sum(dim=1), "n_hi": (Mc & above & ~below).sum(dim=1)}

    return dispatch


@timed("quality_checker.missing_stats_streaming")
def missing_stats_streaming(
    file_path: str,
    file_type: str,
    list_of_cols="all",
    drop_cols=[],
    chunk_rows: int = 1_000_000,
    file_configs: dict = None,
    checkpoint_dir: str = None,
    resume: bool = False,
    print_impact=False,
) -> pd.DataFrame:
    """Streaming ``missingCount_computation``: [attribute, missing_count,
    missing_pct] over a part-file dataset of any size.  The counts are
    host tallies over the raw chunk frames (no device block), exact
    integers; the percentage is rounded to 4 decimals."""
    from anovos_tpu_torch.data_ingest.data_ingest import _resolve_files
    from anovos_tpu_torch.data_ingest.guard import IngestError
    from anovos_tpu_torch.data_ingest.prefetch import StreamController, StreamStats
    from anovos_tpu_torch.ops import streaming as st

    cfg = dict(file_configs or {})
    files = _resolve_files(file_path, file_type)
    schema = st.stream_schema(files, file_type, cfg)
    cols = parse_cols(list_of_cols, [c for c, _k in schema], drop_cols)
    if not cols:
        raise TypeError("Invalid input for Column(s)")
    ctl, stats = StreamController(), StreamStats()
    ckpt = None
    if checkpoint_dir:
        ckpt = st.StreamCheckpoint(
            checkpoint_dir, st._stream_sig(files, file_type, cols, chunk_rows, 0, op="quality_missing"),
            resume=resume)
    skip = ckpt.committed(1) if (ckpt is not None and resume) else frozenset()
    parts = st._run_pass(
        files, file_type, cols, chunk_rows, cfg, pass_no=1,
        dispatch=None, need_block=False,
        host_part=lambda df: {"rows": np.asarray(len(df), np.int64),
                              "valid": df[cols].notna().sum().to_numpy(np.int64)},
        ctl=ctl, stats=stats, ckpt=ckpt, skip_chunks=skip,
        on_file_rows=st.checkpoint_on_file_rows(ckpt))
    if not parts:
        raise IngestError(f"missing_stats_streaming: no readable rows in {len(files)} part file(s) "
                          "(every part quarantined?)")
    total = int(sum(int(p["rows"]) for p in parts.values()))
    valid = np.sum([p["valid"] for p in parts.values()], axis=0).astype(np.int64)
    missing = total - valid
    odf = pd.DataFrame({"attribute": cols, "missing_count": missing,
                        "missing_pct": np.round(missing / max(total, 1), 4)})
    st._publish_stats("missing_stats_streaming", ctl, stats)
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


@timed("quality_checker.outlier_stats_streaming")
def outlier_stats_streaming(
    file_path: str,
    file_type: str,
    model_path: str,
    list_of_cols="all",
    drop_cols=[],
    chunk_rows: int = 1_000_000,
    file_configs: dict = None,
    checkpoint_dir: str = None,
    resume: bool = False,
    print_impact=False,
) -> pd.DataFrame:
    """Streaming outlier counts against pre-fitted bounds (the out-of-core
    twin of ``outlier_detection(pre_existing_model=True)``): [attribute,
    lower_outliers, upper_outliers], exact integer counts summed in int64
    over the chunks."""
    from anovos_tpu_torch.data_ingest.data_ingest import _resolve_files
    from anovos_tpu_torch.data_ingest.guard import IngestError
    from anovos_tpu_torch.data_ingest.prefetch import StreamController, StreamStats
    from anovos_tpu_torch.ops import streaming as st
    from anovos_tpu_torch.shared.runtime import get_runtime

    cfg = dict(file_configs or {})
    files = _resolve_files(file_path, file_type)
    num_all = [c for c, k in st.stream_schema(files, file_type, cfg) if k == "num"]
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, num_all, drop_cols)
    bounds, _skewed = _load_outlier_model(model_path)
    cols = [c for c in cols if c in bounds]
    if not cols:
        return pd.DataFrame(columns=["attribute", "lower_outliers", "upper_outliers"])
    lower = np.array([bounds[c][0] if bounds[c][0] is not None else -np.inf for c in cols])
    upper = np.array([bounds[c][1] if bounds[c][1] is not None else np.inf for c in cols])
    ctl, stats = StreamController(), StreamStats()
    ckpt = None
    if checkpoint_dir:
        ckpt = st.StreamCheckpoint(
            checkpoint_dir,
            st._stream_sig(files, file_type, cols, chunk_rows, 0,
                           op="quality_outlier:" + ",".join(f"{lo}:{hi}" for lo, hi in zip(lower, upper))),
            resume=resume)
    device = get_runtime().device
    lo_d = torch.as_tensor(lower.astype(np.float32), device=device)
    hi_d = torch.as_tensor(upper.astype(np.float32), device=device)
    skip = ckpt.committed(1) if (ckpt is not None and resume) else frozenset()
    parts = st._run_pass(
        files, file_type, cols, chunk_rows, cfg, pass_no=1,
        dispatch=_outlier_counts_dispatch(lo_d, hi_d),
        ctl=ctl, stats=stats, ckpt=ckpt, skip_chunks=skip,
        on_file_rows=st.checkpoint_on_file_rows(ckpt))
    if not parts:
        raise IngestError(f"outlier_stats_streaming: no readable rows in {len(files)} part file(s) "
                          "(every part quarantined?)")
    odf = pd.DataFrame({"attribute": cols, "lower_outliers": st._sum_parts(parts, "n_lo"),
                        "upper_outliers": st._sum_parts(parts, "n_hi")})
    st._publish_stats("outlier_stats_streaming", ctl, stats)
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf
