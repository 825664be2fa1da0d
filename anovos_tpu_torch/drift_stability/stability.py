"""Stability index over time-period datasets (counterpart of
``anovos_tpu/drift_stability/stability.py``).

``stability_index_computation``: per dataset × column mean / stddev /
kurtosis(+3) from ONE masked-moments kernel launch per dataset; the metric
history appends to CSV, and the coefficient of variation across periods
maps to 0-4 scores and a weighted stability index.

``feature_stability_estimation``: first/second-order Taylor propagation of
a derived feature's mean/variance from attribute-level stats via sympy
symbolic derivatives (host only).
"""

from __future__ import annotations

import glob
import logging
import os
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import pandas as pd

from anovos_tpu_torch.drift_stability.validations import (
    check_metric_weightages,
    check_threshold,
    compute_score,
    compute_si,
)
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.shared.table import Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)


def stability_index_computation(
    *idfs: Table,
    list_of_cols="all",
    drop_cols=[],
    metric_weightages: dict = {"mean": 0.5, "stddev": 0.3, "kurtosis": 0.2},
    binary_cols: Union[str, List[str]] = [],
    existing_metric_path: str = "",
    appended_metric_path: str = "",
    threshold: float = 1,
    print_impact: bool = False,
    **_ignored,
) -> pd.DataFrame:
    """[attribute, type, mean_stddev, mean_cv, stddev_cv, kurtosis_cv,
    mean_si, stddev_si, kurtosis_si, stability_index, flagged]."""
    # the reference takes ONE ``idfs`` list argument (stability.py:17);
    # accept that calling convention alongside varargs
    if len(idfs) == 1 and isinstance(idfs[0], (list, tuple)):
        idfs = tuple(idfs[0])
    check_metric_weightages(metric_weightages)
    check_threshold(threshold)
    if isinstance(binary_cols, str):
        binary_cols = [x.strip() for x in binary_cols.split("|") if x.strip()]
    num_all, _, _ = idfs[0].attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, idfs[0].col_names, drop_cols)
    bad = [c for c in cols if c not in num_all]
    if bad or not cols:
        raise TypeError("Invalid input for Column(s)")

    # one batched moments kernel per dataset → (n_idfs, k) metric arrays
    hist_rows = []
    existing = None
    start_idx = 1
    if existing_metric_path:
        files = sorted(glob.glob(os.path.join(existing_metric_path, "*.csv"))) or [existing_metric_path]
        existing = pd.concat([pd.read_csv(f) for f in files], ignore_index=True)
        if len(existing):
            start_idx = int(existing["idx"].astype(int).max()) + 1
    for di, idf in enumerate(idfs):
        X, M = idf.numeric_block(cols)
        mom = masked_moments(X, M)
        mean = mom["mean"].cpu().numpy().astype(np.float64)
        std = mom["stddev"].cpu().numpy().astype(np.float64)
        kurt = mom["kurtosis"].cpu().numpy().astype(np.float64) + 3.0  # the reference adds 3
        for i, c in enumerate(cols):
            hist_rows.append(
                {
                    "idx": start_idx + di,
                    "attribute": c,
                    "type": "Binary" if c in binary_cols else "Numerical",
                    "mean": mean[i],
                    "stddev": std[i],
                    "kurtosis": kurt[i],
                }
            )
    hist = pd.DataFrame(hist_rows)
    if existing is not None and len(existing):
        hist = pd.concat([existing, hist], ignore_index=True)
    if appended_metric_path:
        os.makedirs(appended_metric_path, exist_ok=True)
        hist.sort_values("idx").to_csv(
            os.path.join(appended_metric_path, "part-00000.csv"), index=False
        )

    odf = stability_frame_from_history(
        hist, cols=cols, metric_weightages=metric_weightages,
        threshold=threshold, binary_cols=binary_cols)
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def stability_frame_from_history(
    hist: pd.DataFrame,
    cols: Optional[List[str]] = None,
    metric_weightages: dict = {"mean": 0.5, "stddev": 0.3, "kurtosis": 0.2},
    threshold: float = 1,
    binary_cols: Union[str, List[str]] = [],
) -> pd.DataFrame:
    """The CV→SI tail over an [idx, attribute, mean, stddev, kurtosis]
    metric history."""
    if isinstance(binary_cols, str):
        binary_cols = [x.strip() for x in binary_cols.split("|") if x.strip()]
    if cols is None:
        cols = list(dict.fromkeys(hist["attribute"].astype(str))) if len(hist) else []
    si_fn = compute_si(metric_weightages)
    rows = []
    for c in cols:
        sub = hist[hist["attribute"] == c]
        ctype = "Binary" if c in binary_cols else "Numerical"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mean_std = float(sub["mean"].std(ddof=1))
            mean_cv = mean_std / float(sub["mean"].mean()) if sub["mean"].mean() else np.nan
            stddev_cv = (
                float(sub["stddev"].std(ddof=1)) / float(sub["stddev"].mean())
                if sub["stddev"].mean()
                else np.nan
            )
            kurt_cv = (
                float(sub["kurtosis"].std(ddof=1)) / float(sub["kurtosis"].mean())
                if sub["kurtosis"].mean()
                else np.nan
            )
        mean_si, stddev_si, kurt_si, si = si_fn(ctype, mean_std, mean_cv, stddev_cv, kurt_cv)
        rows.append(
            {
                "attribute": c,
                "type": ctype,
                "mean_stddev": round(mean_std, 4) if mean_std == mean_std else None,
                "mean_cv": round(mean_cv, 4) if mean_cv == mean_cv else None,
                "stddev_cv": round(stddev_cv, 4) if stddev_cv == stddev_cv else None,
                "kurtosis_cv": round(kurt_cv, 4) if kurt_cv == kurt_cv else None,
                "mean_si": mean_si,
                "stddev_si": stddev_si,
                "kurtosis_si": kurt_si,
                "stability_index": si,
                "flagged": 1 if (si is None or si < threshold) else 0,
            }
        )
    return pd.DataFrame(rows)


def feature_stability_estimation(
    attribute_stats: pd.DataFrame,
    attribute_transformation: Dict[str, str],
    metric_weightages: dict = {"mean": 0.5, "stddev": 0.3, "kurtosis": 0.2},
    threshold: float = 1,
    print_impact: bool = False,
) -> pd.DataFrame:
    """Estimate the SI of derived features F = g(X…) from attribute metric
    history WITHOUT recomputing on data (reference :335-578): sympy first/
    second derivatives propagate mean (2nd-order Taylor) and variance
    (1st-order), then CV→SI with kurtosis-free lower/upper bounds."""
    import sympy as sp

    check_metric_weightages(metric_weightages)
    check_threshold(threshold)
    stats = attribute_stats.copy()
    stats["idx"] = stats["idx"].astype(int)
    idx_vals = sorted(stats["idx"].unique())
    rows = []
    for attrs_str, transformation in attribute_transformation.items():
        attrs = [x.strip() for x in attrs_str.split("|")]
        syms = sp.symbols(attrs)
        expr = sp.parse_expr(transformation)
        est_means, est_stddevs = [], []
        for idx in idx_vals:
            sub = stats[stats["idx"] == idx].set_index("attribute")
            if not all(a in sub.index for a in attrs):
                continue
            means = {a: float(sub.loc[a, "mean"]) for a in attrs}
            stds = {a: float(sub.loc[a, "stddev"]) for a in attrs}
            subs_pairs = [(sp.Symbol(a), means[a]) for a in attrs]
            est_mean = float(expr.subs(subs_pairs))
            est_var = 0.0
            for a in attrs:
                d1 = sp.diff(expr, sp.Symbol(a))
                d2 = sp.diff(expr, sp.Symbol(a), 2)
                est_mean += stds[a] ** 2 * float(d2.subs(subs_pairs)) / 2
                est_var += stds[a] ** 2 * float(d1.subs(subs_pairs)) ** 2
            est_means.append(est_mean)
            est_stddevs.append(np.sqrt(max(est_var, 0.0)))
        if len(est_means) < 2:
            warnings.warn(f"feature_stability_estimation: not enough periods for {transformation}")
            continue
        em, es = np.array(est_means), np.array(est_stddevs)
        mean_cv = float(em.std(ddof=1) / em.mean()) if em.mean() else np.nan
        stddev_cv = float(es.std(ddof=1) / es.mean()) if es.mean() else np.nan
        mean_si = compute_score(mean_cv, "cv")
        stddev_si = compute_score(stddev_cv, "cv")
        if mean_si is None or stddev_si is None:
            lower = None
        else:
            lower = round(
                mean_si * metric_weightages.get("mean", 0)
                + stddev_si * metric_weightages.get("stddev", 0),
                4,
            )
        upper = round(lower + 4 * metric_weightages.get("kurtosis", 0), 4) if lower is not None else None
        rows.append(
            {
                "feature_formula": transformation,
                "mean_cv": round(mean_cv, 4) if mean_cv == mean_cv else None,
                "stddev_cv": round(stddev_cv, 4) if stddev_cv == stddev_cv else None,
                "mean_si": mean_si,
                "stddev_si": stddev_si,
                "stability_index_lower_bound": lower,
                "stability_index_upper_bound": upper,
                "flagged_lower": 1 if (lower is None or lower < threshold) else 0,
                "flagged_upper": 1 if (upper is None or upper < threshold) else 0,
            }
        )
    odf = pd.DataFrame(rows)
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf
