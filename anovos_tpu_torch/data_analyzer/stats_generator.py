"""Descriptive statistics (counterpart of
``anovos_tpu/data_analyzer/stats_generator.py``).

Every function keeps the output schema of the JAX package (column names,
4-decimal rounding, string-typed mode).  All of them draw from one
memoized ``ops/describe.table_describe`` per Table: the moments kernel
plus one sort for the numeric columns, one histogram pass for the
categorical ones.  Returns are host pandas DataFrames.
"""

from __future__ import annotations

import logging
import warnings
from typing import List

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.ops.describe import PCTL_QS, float_order_key, table_describe
from anovos_tpu_torch.ops.hll import approx_nunique
from anovos_tpu_torch.ops.segment import cat_valid_mask
from anovos_tpu_torch.shared.table import Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)

_R = lambda v: np.round(v, 4)

# discrete = categorical + integer columns
_INT_DTYPES = {"int", "bigint", "long", "smallint", "tinyint", "boolean"}


def _validate(idf: Table, cols: List[str], numeric_only: bool = False) -> None:
    bad = [c for c in cols if c not in idf.columns]
    if bad or not cols:
        raise TypeError("Invalid input for Column(s)")
    if numeric_only:
        nonnum = [c for c in cols if idf.columns[c].kind != "num"]
        if nonnum:
            raise TypeError(f"Invalid input for Column(s): non-numerical {nonnum}")


def _desc(idf: Table):
    """Memoized description over ALL of the table's num/cat columns;
    callers index into it for their column subset."""
    num_all, cat_all, _ = idf.attribute_type_segregation()
    num_out, cat_out = table_describe(idf, num_all, cat_all)
    return num_out, cat_out, {c: i for i, c in enumerate(num_all)}, {c: i for i, c in enumerate(cat_all)}


def _fill_count(idf: Table, col: str, num_out, cat_out, ni, ci) -> int:
    if col in ni:
        return int(num_out["count"][ni[col]])
    if col in ci:
        return int(cat_out["count"][ci[col]])
    return int(idf.columns[col].mask.sum())  # ts/other columns: direct mask sum


def _fill_counts_light(idf: Table, cols: List[str]) -> np.ndarray:
    """Valid counts of ``cols`` (categorical null codes excluded): from the
    description when it is cached, else one stacked mask reduction."""
    cache = idf.__dict__.get("_describe_cache")
    if cache:
        for (knum, kcat, _), (num_out, cat_out) in list(cache.items()):  # others may add keys
            ni = {c: i for i, c in enumerate(knum)}
            ci = {c: i for i, c in enumerate(kcat)}
            if all(c in ni or c in ci for c in cols):
                return np.array([_fill_count(idf, c, num_out, cat_out, ni, ci) for c in cols])
    M = torch.stack([
        cat_valid_mask(idf.columns[c].data, idf.columns[c].mask)
        if idf.columns[c].kind == "cat" else idf.columns[c].mask
        for c in cols
    ], dim=1)
    return M.sum(dim=0).cpu().numpy().astype(np.int64)


def global_summary(idf: Table, list_of_cols="all", drop_cols=[], print_impact=False) -> pd.DataFrame:
    """[metric, value] universal summary (reference :33-113)."""
    cols = parse_cols(list_of_cols, idf.col_names, drop_cols)
    _validate(idf, cols)
    sub = idf.select(cols)
    num_cols, cat_cols, other_cols = sub.attribute_type_segregation()
    rows = [
        ["rows_count", str(idf.nrows)],
        ["columns_count", str(len(cols))],
        ["numcols_count", str(len(num_cols))],
        ["numcols_name", ", ".join(num_cols)],
        ["catcols_count", str(len(cat_cols))],
        ["catcols_name", ", ".join(cat_cols)],
        ["othercols_count", str(len(other_cols))],
        ["othercols_name", ", ".join(other_cols)],
    ]
    odf = pd.DataFrame(rows, columns=["metric", "value"])
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def missingCount_computation(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, missing_count, missing_pct] (reference :116-176)."""
    cols = parse_cols(list_of_cols, idf.col_names, drop_cols)
    _validate(idf, cols)
    fill = _fill_counts_light(idf, cols)
    missing = idf.nrows - fill
    odf = pd.DataFrame(
        {
            "attribute": cols,
            "missing_count": missing,
            "missing_pct": _R(missing / max(idf.nrows, 1)),
        }
    )
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def nonzeroCount_computation(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, nonzero_count, nonzero_pct] — numeric cols only
    (reference :179-248; MLlib colStats → one masked reduction)."""
    num_all, _, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, num_all, drop_cols)
    if not cols:
        warnings.warn("No Non-Zero Count Computation - No numerical column(s) to analyze")
        return pd.DataFrame(columns=["attribute", "nonzero_count", "nonzero_pct"])
    _validate(idf, cols, numeric_only=True)
    num_out, _, ni, _ = _desc(idf)
    nz = np.array([num_out["nonzero"][ni[c]] for c in cols]).astype(np.int64)
    odf = pd.DataFrame(
        {
            "attribute": cols,
            "nonzero_count": nz,
            "nonzero_pct": _R(nz / max(idf.nrows, 1)),
        }
    )
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def measures_of_counts(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, fill_count, fill_pct, missing_count, missing_pct,
    nonzero_count, nonzero_pct] (reference :251-325)."""
    cols = parse_cols(list_of_cols, idf.col_names, drop_cols)
    _validate(idf, cols)
    num_cols = [c for c in cols if idf.columns[c].kind == "num"]
    fill = _fill_counts_light(idf, cols)
    odf = pd.DataFrame(
        {
            "attribute": cols,
            "fill_count": fill,
            "fill_pct": _R(fill / max(idf.nrows, 1)),
            "missing_count": idf.nrows - fill,
            "missing_pct": _R(1 - fill / max(idf.nrows, 1)),
        }
    )
    nz = nonzeroCount_computation(idf, num_cols) if num_cols else pd.DataFrame(
        columns=["attribute", "nonzero_count", "nonzero_pct"]
    )
    odf = odf.merge(nz, on="attribute", how="outer")
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def mode_computation(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, mode, mode_rows] (reference :328-421).  mode is
    string-typed for schema parity.  The reference computes a mode for EVERY
    column — floats included (groupBy value counts) — so no discreteness
    filter here; the sorted longest-run kernel handles continuous values."""
    all_cols = [c for c in idf.col_names if idf.columns[c].kind in ("cat", "num")]
    cols = parse_cols(
        list_of_cols if list_of_cols != "all" else all_cols, idf.col_names, drop_cols
    )
    cols = [c for c in cols if c in all_cols]
    if not cols:
        warnings.warn("No Mode Computation - No discrete column(s) to analyze")
        return pd.DataFrame(columns=["attribute", "mode", "mode_rows"])
    num_out, cat_out, ni, ci = _desc(idf)
    modes, counts = [], []
    for c in cols:
        col = idf.columns[c]
        if col.kind == "cat":
            j = ci[c]
            if len(col.vocab) == 0 or cat_out["mode_count"][j] == 0:
                modes.append(None)
                counts.append(0)
            else:
                modes.append(str(col.vocab[int(cat_out["mode_code"][j])]))
                counts.append(int(cat_out["mode_count"][j]))
        else:
            j = ni[c]
            v = num_out["mode_value"][j]
            if np.isnan(v):
                modes.append(None)
            elif idf.columns[c].dtype_name in _INT_DTYPES:
                modes.append(str(int(v)))
            else:
                # float column: string-format the value itself ("36.0"), the
                # way the reference's string-typed mode schema renders it
                modes.append(str(float(v)))
            counts.append(int(num_out["mode_count"][j]))
    odf = pd.DataFrame({"attribute": cols, "mode": modes, "mode_rows": counts})
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def measures_of_centralTendency(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, mean, median, mode, mode_rows, mode_pct]
    (reference :424-527)."""
    num_all, cat_all, _ = idf.attribute_type_segregation()
    cols = parse_cols(
        list_of_cols if list_of_cols != "all" else num_all + cat_all, idf.col_names, drop_cols
    )
    _validate(idf, cols)
    num_out, cat_out, ni, ci = _desc(idf)
    med_row = PCTL_QS.index(0.50)
    dfm = mode_computation(idf, [c for c in cols], [])
    mode_map = dfm.set_index("attribute")[["mode", "mode_rows"]].to_dict("index")
    rows = []
    for c in cols:
        m = mode_map.get(c, {"mode": None, "mode_rows": None})
        cnt = _fill_count(idf, c, num_out, cat_out, ni, ci)
        mode_pct = (
            _R(m["mode_rows"] / cnt) if m.get("mode_rows") not in (None, np.nan) and cnt else None
        )
        rows.append(
            {
                "attribute": c,
                "mean": _R(float(num_out["mean"][ni[c]])) if c in ni else None,
                "median": _R(float(num_out["percentiles"][med_row, ni[c]])) if c in ni else None,
                "mode": m.get("mode"),
                "mode_rows": m.get("mode_rows"),
                "mode_pct": mode_pct,
            }
        )
    odf = pd.DataFrame(rows, columns=["attribute", "mean", "median", "mode", "mode_rows", "mode_pct"])
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def _exact_bits(col) -> torch.Tensor:
    """One int32 lane per value for the HLL sketch, the JAX package's lane:
    an f32 value's bit pattern (−0.0 as +0.0), an integer's value, and for
    a wide column its (hi, lo) int32 key pair mixed as
    hi ^ (lo · −1640531527) mod 2^32, the key being the int64 value or the
    float64 order key, hi = key >> 32 and lo = (key & 0xffffffff) − 2^31."""
    if col.is_wide:
        key = col.exact if col.is_wide_int else float_order_key(col.exact)
        hi = key >> 32
        lo = (key & 0xFFFFFFFF) - (1 << 31)
        mixed = (hi ^ (lo * -1640531527)) & 0xFFFFFFFF
        return (mixed - ((mixed >> 31) << 32)).to(torch.int32)
    if col.data.dtype == torch.float32:
        return (col.data + 0.0).view(torch.int32)
    return col.data.to(torch.int32)


def uniqueCount_computation(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    compute_approx_unique_count: bool = False,
    rsd: float = 0.05,
    print_impact=False,
    **_ignored,
) -> pd.DataFrame:
    """[attribute, unique_values] (reference :529-620).  Exact distinct via
    the shared device sort; ``compute_approx_unique_count=True`` uses the
    HLL sketch (``ops/hll.py``) at the requested ``rsd``."""
    num_all, cat_all, _ = idf.attribute_type_segregation()
    cols = parse_cols(
        list_of_cols if list_of_cols != "all" else num_all + cat_all, idf.col_names, drop_cols
    )
    cols = [c for c in cols if idf.columns[c].kind in ("num", "cat")]
    if not cols:
        warnings.warn("No Unique Count Computation - No discrete column(s) to analyze")
        return pd.DataFrame(columns=["attribute", "unique_values"])
    if rsd is None:
        rsd = 0.05
    if rsd <= 0:
        raise ValueError("rsd value can not be less than 0 (default value is 0.05)")
    if compute_approx_unique_count:
        X = torch.stack([_exact_bits(idf.columns[c]) for c in cols], dim=1)
        M = torch.stack([cat_valid_mask(idf.columns[c].data, idf.columns[c].mask)
                         if idf.columns[c].kind == "cat" else idf.columns[c].mask for c in cols], dim=1)
        nu = np.round(approx_nunique(X, M, rsd)).astype(np.int64)
    else:
        num_out, cat_out, ni, ci = _desc(idf)
        nu = np.array(
            [num_out["nunique"][ni[c]] if c in ni else cat_out["nunique"][ci[c]] for c in cols]
        ).astype(np.int64)
    odf = pd.DataFrame({"attribute": cols, "unique_values": nu})
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def measures_of_cardinality(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    use_approx_unique_count: bool = False,
    rsd: float = 0.05,
    print_impact=False,
    **_ignored,
) -> pd.DataFrame:
    """[attribute, unique_values, IDness]; IDness = unique/(rows − missing)
    (reference :623-733; the approx knobs forward to the HLL path)."""
    uc = uniqueCount_computation(
        idf, list_of_cols, drop_cols,
        compute_approx_unique_count=use_approx_unique_count, rsd=rsd,
    )
    if uc.empty:
        return pd.DataFrame(columns=["attribute", "unique_values", "IDness"])
    mc = missingCount_computation(idf, list(uc["attribute"]))
    odf = uc.merge(mc, on="attribute", how="outer")
    denom = (idf.nrows - odf["missing_count"]).replace(0, np.nan)
    odf["IDness"] = _R(odf["unique_values"] / denom)
    odf = odf[["attribute", "unique_values", "IDness"]]
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def measures_of_dispersion(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, stddev, variance, cov, IQR, range] — numeric only
    (reference :736-829)."""
    num_all, _, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, num_all, drop_cols)
    _validate(idf, cols, numeric_only=True)
    num_out, _, ni, _ = _desc(idf)
    idx = [ni[c] for c in cols]
    std = num_out["stddev"][idx]
    mean = num_out["mean"][idx]
    q1 = num_out["percentiles"][PCTL_QS.index(0.25)][idx]
    q3 = num_out["percentiles"][PCTL_QS.index(0.75)][idx]
    rng = num_out["max"][idx] - num_out["min"][idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = std / mean
    odf = pd.DataFrame(
        {
            "attribute": cols,
            "stddev": _R(std),
            "variance": _R(np.round(std, 4) ** 2),
            "cov": _R(cov),
            "IQR": _R(q3 - q1),
            "range": _R(rng),
        }
    )
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


_PCTL_STATS = ["min", "1%", "5%", "10%", "25%", "50%", "75%", "90%", "95%", "99%", "max"]


def measures_of_percentiles(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, min, 1%, …, 99%, max] — numeric only (reference :832-916).
    Exact device-sort quantiles replace the Greenwald-Khanna sketch."""
    num_all, _, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, num_all, drop_cols)
    _validate(idf, cols, numeric_only=True)
    num_out, _, ni, _ = _desc(idf)
    idx = [ni[c] for c in cols]
    odf = pd.DataFrame({"attribute": cols})
    for i, s in enumerate(_PCTL_STATS):
        odf[s] = _R(num_out["percentiles"][i][idx])
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def measures_of_shape(
    idf: Table, list_of_cols="all", drop_cols=[], print_impact=False
) -> pd.DataFrame:
    """[attribute, skewness, kurtosis] — numeric only (reference :919-1011;
    population skew, excess kurtosis = Spark F.skewness/F.kurtosis)."""
    num_all, _, _ = idf.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all, num_all, drop_cols)
    _validate(idf, cols, numeric_only=True)
    num_out, _, ni, _ = _desc(idf)
    idx = [ni[c] for c in cols]
    odf = pd.DataFrame(
        {
            "attribute": cols,
            "skewness": _R(num_out["skewness"][idx]),
            "kurtosis": _R(num_out["kurtosis"][idx]),
        }
    )
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf
