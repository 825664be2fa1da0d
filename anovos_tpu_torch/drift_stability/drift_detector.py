"""Covariate-drift statistics (counterpart of
``anovos_tpu/drift_stability/drift_detector.py`` ``statistics``).

Bin the source with equal-range or equal-frequency cutoffs (persisted as
the ``attribute_binning`` model), bin the target with the same cutoffs,
build per-column relative frequencies p/q with 0 → 0.0001 smoothing, then
PSI / Hellinger / JSD / KS per column.  Numeric histograms go through the
histogram kernel; the metric arithmetic is host numpy over the small
(cols × bins) arrays.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_transformer.model_io import load_model_df, save_model_df
from anovos_tpu_torch.drift_stability.validations import check_distance_method
from anovos_tpu_torch.ops.drift_kernels import drift_side_full, fit_cutoffs
from anovos_tpu_torch.ops.segment import bucket_segments_pow2
from anovos_tpu_torch.shared.table import Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)

_SMOOTH = 0.0001


def load_frequency_map(model_dir: str, col: str) -> Optional[Dict[str, float]]:
    """{key: probability} from one column's persisted source-frequency CSV
    (``<model_dir>/frequency_counts/<col>/part-00000.csv``), or None when
    absent.  Keys stay verbatim strings."""
    path = os.path.join(model_dir, "frequency_counts", col, "part-00000.csv")
    if not os.path.exists(path):
        return None
    f = pd.read_csv(path, dtype=str)
    kcol = f.columns[0]
    return dict(zip(f[kcol].astype(str), f["p"].astype(float)))


def save_frequency_map(model_dir: str, col: str, keys, p) -> None:
    """Persist one column's source frequencies (the write half of
    :func:`load_frequency_map`, the JAX package's file layout)."""
    d = os.path.join(model_dir, "frequency_counts", col)
    os.makedirs(d, exist_ok=True)
    pd.DataFrame({col: keys, "p": p}).to_csv(os.path.join(d, "part-00000.csv"), index=False)


def _freqs_to_metrics(p: np.ndarray, q: np.ndarray, methods: List[str]) -> dict:
    """Drift metrics over (k, nb) frequency arrays with 0 → 0.0001 smoothing."""
    p = np.where(p <= 0, _SMOOTH, p)
    q = np.where(q <= 0, _SMOOTH, q)
    out = {}
    if "PSI" in methods:
        out["PSI"] = ((p - q) * np.log(p / q)).sum(axis=1)
    if "HD" in methods:
        out["HD"] = np.sqrt(((np.sqrt(p) - np.sqrt(q)) ** 2).sum(axis=1) / 2)
    if "JSD" in methods:
        m = (p + q) / 2
        out["JSD"] = ((p * np.log(p / m)).sum(axis=1) + (q * np.log(q / m)).sum(axis=1)) / 2
    if "KS" in methods:
        out["KS"] = np.abs(np.cumsum(p, axis=1) - np.cumsum(q, axis=1)).max(axis=1)
    return out


def _drop_allnan_cutoffs(cutoffs: np.ndarray, cols: List[str]):
    """Drop columns whose every cutoff is NaN (all-null in source), with a
    warning.  Returns (cutoffs, cols)."""
    cutoffs = np.asarray(cutoffs, np.float64)
    keep = ~np.isnan(cutoffs).all(axis=1)
    if not keep.all():
        dropped = [c for c, k in zip(cols, keep) if not k]
        warnings.warn("Columns contains too much null values. Dropping " + ", ".join(dropped))
    return cutoffs[keep], [c for c, k in zip(cols, keep) if k]


def statistics(
    idf_target: Table,
    idf_source: Optional[Table] = None,
    list_of_cols="all",
    drop_cols=None,
    method_type: str = "PSI",
    bin_method: str = "equal_range",
    bin_size: int = 10,
    threshold: float = 0.1,
    use_sampling: bool = True,
    sample_method: str = "random",
    strata_cols="all",
    stratified_type: str = "population",
    sample_size: int = 100000,
    sample_seed: int = 42,
    pre_existing_source: bool = False,
    source_save: bool = True,
    source_path: str = "NA",
    model_directory: str = "drift_statistics",
    print_impact: bool = False,
    **_ignored,
) -> pd.DataFrame:
    """[attribute, <PSI|HD|JSD|KS…>, flagged] drift between source and target.

    With ``pre_existing_source=True`` the persisted binning model and
    source frequency CSVs under ``source_path/model_directory`` are reused
    and ``idf_source`` may be None.  ``use_sampling=True`` on a table larger
    than ``sample_size`` needs ``data_sampling``, which the port does not
    have yet, and raises NotImplementedError."""
    methods = check_distance_method(method_type)
    drop_cols = drop_cols or []
    num_all, cat_all, _ = idf_target.attribute_type_segregation()
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all + cat_all,
                      idf_target.col_names, drop_cols)
    num_cols = [c for c in cols if idf_target.columns[c].kind == "num"]
    cat_cols = [c for c in cols if idf_target.columns[c].kind == "cat"]
    if source_path == "NA":
        source_path = "intermediate_data"
    model_dir = os.path.join(source_path, model_directory)

    if use_sampling:
        sides = [idf_target] + ([idf_source] if not pre_existing_source and idf_source is not None else [])
        if any(t.nrows > sample_size for t in sides):
            raise NotImplementedError(
                "statistics: use_sampling=True on a table larger than sample_size needs "
                "data_sampling, which the port does not have yet (see ROADMAP.md); "
                "pass use_sampling=False")

    count_target = idf_target.nrows
    device = idf_target.device

    # ---- numeric cutoffs: fit on the source or load the model -------------
    num_cols_eff = list(num_cols)
    cutoffs = None
    if num_cols:
        if pre_existing_source:
            dfm = load_model_df(model_dir, "attribute_binning")
            cut_map = {r["attribute"]: list(r["parameters"]) for _, r in dfm.iterrows()}
            num_cols_eff = [c for c in num_cols if c in cut_map]
            cutoffs = np.array([cut_map[c] for c in num_cols_eff], dtype=np.float64)
        else:
            cuts = _fit_cutoffs_dev(idf_source, num_cols, bin_size, bin_method)
            cutoffs, num_cols_eff = _drop_allnan_cutoffs(cuts.cpu().numpy(), num_cols)

    # ---- union vocabularies for categorical columns -----------------------
    union_vocabs: Dict[str, np.ndarray] = {}
    freq_p: Dict[str, np.ndarray] = {}
    if pre_existing_source:
        for c in cols:
            smap = load_frequency_map(model_dir, c)
            if smap is None:
                warnings.warn(f"drift statistics: no persisted source frequencies for {c}; skipping")
                continue
            if c in num_cols_eff:
                freq_p[c] = np.array([smap.get(str(k), 0.0) for k in range(1, bin_size + 1)])
            elif c in cat_cols:
                tgt_vocab = {str(v) for v in idf_target.columns[c].vocab}
                uni = np.array(sorted(set(smap) | tgt_vocab), dtype=object)
                union_vocabs[c] = uni
                freq_p[c] = np.array([smap.get(str(v), 0.0) for v in uni])
        cat_cols = [c for c in cat_cols if c in union_vocabs]
    else:
        union_vocabs = _union_vocabs_for(idf_source, idf_target, cat_cols)

    # ---- one histogram pass per dataset side ------------------------------
    n_union = max((len(union_vocabs[c]) for c in cat_cols), default=1)
    if num_cols_eff:
        cuts_dev = torch.as_tensor(cutoffs, dtype=torch.float32, device=device)
    else:
        cuts_dev = torch.zeros((0, bin_size - 1), dtype=torch.float32, device=device)

    def side(idf: Table):
        num_h, cat_h = drift_side_full(*_side_args(idf, num_cols_eff, cat_cols, cuts_dev,
                                                   union_vocabs, bin_size, n_union))
        return num_h.cpu().numpy(), cat_h.cpu().numpy()

    tgt_num, tgt_cat = side(idf_target)
    if not pre_existing_source:
        src_num, src_cat = side(idf_source)
        if cutoffs is not None:
            save_model_df(
                pd.DataFrame({"attribute": num_cols_eff,
                              "parameters": [list(map(float, c)) for c in cutoffs]}),
                model_dir, "attribute_binning")

    freq_q: Dict[str, np.ndarray] = {}
    for i, c in enumerate(num_cols_eff):
        freq_q[c] = tgt_num[i] / max(count_target, 1)
    for j, c in enumerate(cat_cols):
        freq_q[c] = tgt_cat[j][: len(union_vocabs[c])] / max(count_target, 1)

    if not pre_existing_source:
        for i, c in enumerate(num_cols_eff):
            freq_p[c] = src_num[i] / max(idf_source.nrows, 1)
        for j, c in enumerate(cat_cols):
            freq_p[c] = src_cat[j][: len(union_vocabs[c])] / max(idf_source.nrows, 1)
        if source_save:
            for c in num_cols_eff + cat_cols:
                keys = list(range(1, bin_size + 1)) if c in num_cols_eff else list(union_vocabs[c])
                save_frequency_map(model_dir, c, keys, freq_p[c])

    odf = _metrics_frame(freq_p, freq_q, cols, methods, threshold)
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf


def _metrics_frame(freq_p: Dict[str, np.ndarray], freq_q: Dict[str, np.ndarray],
                   cols: List[str], methods: List[str], threshold: float) -> pd.DataFrame:
    """Metrics over padded (k, max_bins) arrays, rounded to 4 decimals,
    flagged where any metric exceeds ``threshold``."""
    cols_eff = [c for c in cols if c in freq_p and c in freq_q]
    if not cols_eff:
        return pd.DataFrame(columns=["attribute"] + methods + ["flagged"])
    nb = max(len(freq_p[c]) for c in cols_eff)
    P = np.full((len(cols_eff), nb), _SMOOTH)
    Q = np.full((len(cols_eff), nb), _SMOOTH)
    for i, c in enumerate(cols_eff):
        P[i, : len(freq_p[c])] = freq_p[c]
        q = freq_q[c]
        if len(q) < len(freq_p[c]):  # the persisted source saw more categories
            q = np.concatenate([q, np.zeros(len(freq_p[c]) - len(q))])
        Q[i, : len(q)] = q
    # padding lanes hold equal smoothing on both sides → zero contribution
    mets = _freqs_to_metrics(P, Q, methods)
    odf = pd.DataFrame({"attribute": cols_eff})
    for m in methods:
        odf[m] = np.round(mets[m], 4)
    odf["flagged"] = (odf[methods] > threshold).any(axis=1).astype(int)
    return odf


def _fit_cutoffs_dev(idf_source: Table, num_cols: List[str], bin_size: int, bin_method: str):
    """(k, bin_size-1) f32 cutoffs fitted on the source's columns, on its device."""
    return fit_cutoffs([idf_source.columns[c].data for c in num_cols],
                       [idf_source.columns[c].mask for c in num_cols], bin_size, bin_method)


def _union_vocabs_for(idf_source: Table, idf_target: Table, cat_cols: List[str]):
    """Per-column union vocabulary over both sides (string-keyed, sorted)."""
    return {
        c: np.array(sorted({str(v) for v in idf_source.columns[c].vocab}
                           | {str(v) for v in idf_target.columns[c].vocab}), dtype=object)
        for c in cat_cols
    }


def _lut_for(idf: Table, cat_cols: List[str], union_vocabs: Dict[str, np.ndarray]) -> torch.Tensor:
    """(k, maxv) int32 LUT from each column's LOCAL codes to union indices;
    maxv is the largest local vocab rounded up to a power of two."""
    if not cat_cols:
        return torch.zeros((0, 1), dtype=torch.int32, device=idf.device)
    maxv = bucket_segments_pow2(max(max(len(idf.columns[c].vocab), 1) for c in cat_cols))
    luts = np.zeros((len(cat_cols), maxv), np.int32)
    for j, c in enumerate(cat_cols):
        pos = {v: i for i, v in enumerate(union_vocabs[c])}
        for i, v in enumerate(idf.columns[c].vocab):
            luts[j, i] = pos[str(v)]
    return torch.from_numpy(luts).to(idf.device)


def _side_args(idf: Table, num_cols: List[str], cat_cols: List[str], cuts_dev: torch.Tensor,
               union_vocabs: Dict[str, np.ndarray], bin_size: int, n_union: int):
    """The ``drift_side_full`` argument tuple of one dataset side."""
    return (
        [idf.columns[c].data for c in num_cols],
        [idf.columns[c].mask for c in num_cols],
        cuts_dev,
        [idf.columns[c].data for c in cat_cols],
        [idf.columns[c].mask for c in cat_cols],
        _lut_for(idf, cat_cols, union_vocabs),
        bin_size,
        max(n_union, 1),
    )


def drift_device_args(idf_target: Table, idf_source: Table, bin_size: int = 10,
                      bin_method: str = "equal_range"):
    """``drift_side_full`` argument tuples of both sides, prepared with the
    helpers ``statistics`` uses: the device work of a drift run without its
    model I/O and metric assembly (for timing the device path alone)."""
    num_cols, cat_cols, _ = idf_target.attribute_type_segregation()
    if num_cols:
        cuts = _fit_cutoffs_dev(idf_source, num_cols, bin_size, bin_method)
    else:
        cuts = torch.zeros((0, bin_size - 1), dtype=torch.float32, device=idf_target.device)
    union_vocabs = _union_vocabs_for(idf_source, idf_target, cat_cols)
    n_union = max((len(union_vocabs[c]) for c in cat_cols), default=1)
    return (
        _side_args(idf_target, num_cols, cat_cols, cuts, union_vocabs, bin_size, n_union),
        _side_args(idf_source, num_cols, cat_cols, cuts, union_vocabs, bin_size, n_union),
    )
