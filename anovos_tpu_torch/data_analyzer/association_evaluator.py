"""Association measures (counterpart of
``anovos_tpu/data_analyzer/association_evaluator.py``).

- ``correlation_matrix``: complete-case Pearson from masked matmuls, true
  f32 whatever the caller's TF32 setting (``ops/mxu.py``);
- ``IV_calculation`` / ``IG_calculation``: per-column label counts over the
  column's groups (categories, or the distinct values of its bins) plus a
  null group, counted on the device in int64/float64;
- ``variable_clustering``: device correlation of the label-encoded,
  mean-imputed columns, then the host VarClus
  (``association_eval_varclus.py``).
"""

from __future__ import annotations

import logging
import math
import warnings
from typing import List

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_analyzer.association_eval_varclus import VarClus
from anovos_tpu_torch.data_ingest.data_sampling import data_sample
from anovos_tpu_torch.data_transformer.transformers import (_event_vector, attribute_binning,
                                                            cat_to_num_unsupervised, imputation_MMM,
                                                            monotonic_binning)
from anovos_tpu_torch.ops.correlation import masked_corr_cc
from anovos_tpu_torch.ops.segment import cat_valid_mask, code_label_counts, masked_nunique
from anovos_tpu_torch.shared.table import Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)


def correlation_matrix(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    use_sampling: bool = False,
    sample_size: int = 1000000,
    print_impact: bool = False,
) -> pd.DataFrame:
    """[attribute, <sorted attribute names>] Pearson correlation over the
    rows with no null among the selected columns, rows sorted by
    attribute."""
    num_all, _, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, idf.col_names, drop_cols)
    if any(c not in num_all for c in cols) or not cols:
        raise TypeError("Invalid input for Column(s)")
    if use_sampling and idf.nrows > sample_size:
        warnings.warn(f"Using sampling. Only {sample_size} random sampled rows are considered.")
        idf = data_sample(idf, fraction=float(sample_size) / idf.nrows, method_type="random")
    X, M = idf.numeric_block(cols)
    C = masked_corr_cc(X, M).cpu().numpy()
    odf = pd.DataFrame(C, columns=cols, index=cols)
    odf["attribute"] = odf.index
    odf = odf[["attribute"] + sorted(cols)].sort_values("attribute").reset_index(drop=True)
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def _grouped_label_counts(idf: Table, col: str, y: torch.Tensor, ym: torch.Tensor):
    """(label_0, label_1) float64 count vectors over the groups of ``col``:
    its categories, or the sorted distinct values of a numeric column, then
    one null group (rows whose label is valid and value is not); groups
    with no labelled row are dropped."""
    c = idf.columns[col]
    if c.kind == "cat":
        codes, valid = c.data, cat_valid_mask(c.data, c.mask)
        vsize = max(len(c.vocab), 1)
    else:
        valid = c.mask
        uniq, inv = torch.unique(c.data[valid], return_inverse=True)
        codes = torch.full_like(c.data, -1, dtype=torch.int32)
        codes[valid] = inv.to(torch.int32)
        vsize = max(len(uniq), 1)
    m_eff = valid & ym
    ones = torch.ones_like(y)
    tot = code_label_counts(codes, m_eff, ones, vsize)
    ev = code_label_counts(codes, m_eff, y, vsize)
    null_m = ym & ~valid
    nulls = torch.stack([null_m.sum().to(torch.float64),
                         torch.where(null_m, y.to(torch.float64), 0.0).sum()])
    tot = np.append(tot.cpu().numpy(), float(nulls[0]))
    ev = np.append(ev.cpu().numpy(), float(nulls[1]))
    keep = tot > 0
    label_1 = ev[keep]
    return tot[keep] - label_1, label_1


def _prep_encoded(idf: Table, cols: List[str], label_col, event_label, encoding_configs):
    """The numeric columns binned per ``encoding_configs`` (bin_method,
    bin_size, monotonicity_check)."""
    num_cols = [c for c in cols if idf.columns[c].kind == "num"]
    if not num_cols or not encoding_configs:
        return idf
    bin_method = encoding_configs.get("bin_method", "equal_frequency")
    bin_size = encoding_configs.get("bin_size", 10)
    if encoding_configs.get("monotonicity_check", 0) == 1:
        return monotonic_binning(idf, num_cols, [], label_col=label_col, event_label=event_label,
                                 bin_method=bin_method, bin_size=bin_size)
    return attribute_binning(idf, num_cols, [], method_type=bin_method, bin_size=bin_size)


def _label_cols(idf: Table, list_of_cols, drop_cols, label_col) -> List[str]:
    num_all, cat_all, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all + cat_all,
                      idf.col_names, drop_cols)
    cols = [c for c in cols if c != label_col]
    if not cols:
        raise TypeError("Invalid input for Column(s)")
    return cols


def IV_calculation(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    label_col: str = "label",
    event_label=1,
    encoding_configs={"bin_method": "equal_frequency", "bin_size": 10, "monotonicity_check": 0},
    print_impact: bool = False,
) -> pd.DataFrame:
    """[attribute, iv] Information Value: IV = Σ (%nonevent − %event)·WOE,
    WOE = ln(%nonevent / %event), with a 0.5 continuity correction in a
    group that has no events or no non-events; 4 decimals."""
    cols = _label_cols(idf, list_of_cols, drop_cols, label_col)
    y, ym = _event_vector(idf, label_col, event_label)
    idf_enc = _prep_encoded(idf, cols, label_col, event_label, encoding_configs)
    rows = []
    for c in cols:
        l0, l1 = _grouped_label_counts(idf_enc, c, y, ym)
        t0, t1 = l0.sum(), l1.sum()
        if t0 == 0 or t1 == 0:
            rows.append({"attribute": c, "iv": np.nan})
            continue
        ev_pcr = l1 / t1
        nev_pcr = l0 / t0
        woe = np.where(
            (nev_pcr != 0) & (ev_pcr != 0),
            np.log(np.maximum(nev_pcr, 1e-300) / np.maximum(ev_pcr, 1e-300)),
            np.log(((l0 + 0.5) / t0) / ((l1 + 0.5) / t1)),
        )
        rows.append({"attribute": c, "iv": round(float(np.sum((nev_pcr - ev_pcr) * woe)), 4)})
    odf = pd.DataFrame(rows, columns=["attribute", "iv"])
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def IG_calculation(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    label_col: str = "label",
    event_label=1,
    encoding_configs={"bin_method": "equal_frequency", "bin_size": 10, "monotonicity_check": 0},
    print_impact: bool = False,
) -> pd.DataFrame:
    """[attribute, ig] Information Gain = total entropy − Σ group entropy;
    a group whose event rate is 0 or 1 adds 0; 4 decimals.  The total
    event rate is over all rows (``idf.nrows``), labelled or not."""
    cols = _label_cols(idf, list_of_cols, drop_cols, label_col)
    y, ym = _event_vector(idf, label_col, event_label)
    total_event = float(torch.where(ym, y.to(torch.float64), 0.0).sum()) / max(idf.nrows, 1)
    if total_event in (0.0, 1.0):
        warnings.warn("IG undefined: label has a single class")
        return pd.DataFrame({"attribute": cols, "ig": [np.nan] * len(cols)})
    total_entropy = -(total_event * math.log2(total_event)
                      + (1 - total_event) * math.log2(1 - total_event))
    idf_enc = _prep_encoded(idf, cols, label_col, event_label, encoding_configs)
    rows = []
    for c in cols:
        l0, l1 = _grouped_label_counts(idf_enc, c, y, ym)
        tot = l0 + l1
        seg_pct = tot / max(tot.sum(), 1e-30)
        ev_pct = np.divide(l1, np.maximum(tot, 1e-30))
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = -seg_pct * (ev_pct * np.log2(ev_pct) + (1 - ev_pct) * np.log2(1 - ev_pct))
        ent = np.where((ev_pct > 0) & (ev_pct < 1), ent, np.nan)
        rows.append({"attribute": c, "ig": round(float(total_entropy - np.nansum(ent)), 4)})
    odf = pd.DataFrame(rows, columns=["attribute", "ig"])
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def variable_clustering(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    sample_size: int = 100000,
    stats_unique: dict = {},
    stats_mode: dict = {},
    persist: bool = True,
    print_impact: bool = False,
) -> pd.DataFrame:
    """[Cluster, Attribute, RS_Ratio]: on a random sample of at most about
    ``sample_size`` rows, drop columns with fewer than two distinct values,
    label-encode the categorical ones (most frequent first), impute the
    mean, then VarClus over the complete-case correlation (float64 on the
    host).  Columns whose correlations are all NaN are dropped with a
    warning."""
    num_all, cat_all, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all + cat_all,
                      idf.col_names, drop_cols)
    if not cols:
        raise TypeError("Invalid input for Column(s)")
    if idf.nrows > sample_size:
        idf = data_sample(idf, fraction=float(sample_size) / idf.nrows, method_type="random")
    sub = idf.select(cols)
    X = torch.stack([sub.columns[c].data.to(torch.float32) for c in cols], dim=1)
    M = torch.stack([cat_valid_mask(sub.columns[c].data, sub.columns[c].mask)
                     if sub.columns[c].kind == "cat" else sub.columns[c].mask for c in cols], dim=1)
    nu = masked_nunique(X, M).cpu().numpy()
    cols = [c for c, u in zip(cols, nu) if u >= 2]
    sub = sub.select(cols)
    cat_cols = [c for c in cols if sub.columns[c].kind == "cat"]
    if cat_cols:
        sub = cat_to_num_unsupervised(sub, cat_cols, method_type="label_encoding")
    sub = imputation_MMM(sub, list_of_cols="missing", method_type="mean")
    Xn, Mn = sub.numeric_block(cols)
    C = masked_corr_cc(Xn, Mn).cpu().numpy().astype(np.float64)
    # f32 numerics can leave an all-NaN off-diagonal row (a near-constant
    # column) and a tiny asymmetry; either stops eigh from converging
    offdiag_nan = (~np.isfinite(C)).sum(axis=1) >= max(len(cols) - 1, 1)
    if offdiag_nan.any() and len(cols) > 1:
        warnings.warn("variable_clustering: dropping degenerate column(s) "
                      + ",".join(c for c, bad in zip(cols, offdiag_nan) if bad))
        keepm = ~offdiag_nan
        cols = [c for c, k in zip(cols, keepm) if k]
        C = C[np.ix_(keepm, keepm)]
    if not cols:
        warnings.warn("variable_clustering: no usable columns after degeneracy drop")
        return pd.DataFrame(columns=["Cluster", "Attribute", "RS_Ratio"])
    C = np.where(np.isfinite(C), C, 0.0)
    C = (C + C.T) / 2.0
    np.fill_diagonal(C, 1.0)
    vc = VarClus(pd.DataFrame(C, columns=cols, index=cols), maxeigval2=1.0, maxclus=None)
    rs = vc.fit().rsquare_table()
    odf = pd.DataFrame({"Cluster": rs["Cluster"], "Attribute": rs["Variable"],
                        "RS_Ratio": np.round(rs["RS_Ratio"].to_numpy(), 4)})
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf
