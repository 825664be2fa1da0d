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

from anovos_tpu_torch.data_ingest.data_sampling import data_sample
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
    and ``idf_source`` may be None.  With ``use_sampling=True`` each side
    above ``sample_size`` rows is first sampled by ``data_sample`` with
    ``fraction = sample_size / nrows``, ``sample_method``, ``strata_cols``,
    ``stratified_type`` and ``sample_seed``."""
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
        def sample(t: Table) -> Table:
            return data_sample(t, strata_cols=strata_cols, fraction=sample_size / t.nrows,
                               method_type=sample_method, stratified_type=stratified_type,
                               seed_value=sample_seed)

        if idf_target.nrows > sample_size:
            idf_target = sample(idf_target)
        if not pre_existing_source and idf_source is not None and idf_source.nrows > sample_size:
            idf_source = sample(idf_source)

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


# ---------------------------------------------------------------------------
# out-of-core streaming drift: the histogram passes applied chunk by chunk
# over the prefetched iterator (ops/streaming.py).  Source cutoffs come from
# the streamed global bounds (the equal_range tail of fit_cutoffs), numeric
# chunks are binned by the histogram kernel and their counts summed in
# int64, categorical counts are tallied on the host.
# ---------------------------------------------------------------------------
def _drift_side_host_part(df: pd.DataFrame, cat_cols: List[str]) -> dict:
    """Host partial of one raw chunk: its row count and each categorical
    column's value counts, string-keyed."""
    out = {"rows": np.asarray(len(df), np.int64)}
    for j, c in enumerate(cat_cols):
        s = df[c]
        # a string-dtype column's counts drop its nulls already
        vc = s.value_counts() if str(s.dtype) in ("str", "string") else s.dropna().astype(str).value_counts()
        out[f"cat{j}_v"] = vc.index.to_numpy(dtype="U")
        out[f"cat{j}_n"] = vc.to_numpy(np.int64)
    return out


def _merge_side_parts(parts: dict, cat_cols: List[str]):
    """(total rows, a value Counter per categorical column) of a pass'
    chunk partials."""
    from collections import Counter

    rows = 0
    counters = [Counter() for _ in cat_cols]
    for i in sorted(parts):
        p = parts[i]
        rows += int(p["rows"])
        for j in range(len(cat_cols)):
            vals, cnts = p.get(f"cat{j}_v"), p.get(f"cat{j}_n")
            if vals is None:
                continue
            for v, n in zip(vals, cnts):
                counters[j][str(v)] += int(n)
    return rows, counters


def _hist_finish(part: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A chunk's f32 kernel counts (exact below 2^24 a chunk) as int64."""
    return {"hist": part["hist"].astype(np.int64)}


def statistics_streaming(
    file_path: str,
    file_type: str,
    source_file_path: Optional[str] = None,
    list_of_cols="all",
    drop_cols=None,
    method_type: str = "PSI",
    bin_method: str = "equal_range",
    bin_size: int = 10,
    threshold: float = 0.1,
    chunk_rows: int = 1_000_000,
    file_configs: Optional[dict] = None,
    pre_existing_source: bool = False,
    source_save: bool = True,
    source_path: str = "NA",
    model_directory: str = "drift_statistics",
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    print_impact: bool = False,
) -> pd.DataFrame:
    """Streaming ``statistics``: drift between two part-file datasets of
    any size, in three passes (source bounds and categorical counts,
    source histograms, target histograms and categorical counts); device
    memory O(window·chunk_rows·k) throughout.

    The fit needs ``bin_method='equal_range'`` (equal_frequency needs
    whole-table quantiles) and nothing is sampled: the in-memory
    counterpart is ``statistics(..., use_sampling=False)``, and the drift
    model files are the ones it writes.  With ``pre_existing_source=True``
    the persisted binning model and source frequencies are reused and
    only the target streams.  With ``checkpoint_dir``/``resume`` every
    chunk of every pass commits; a cutoff shift (a quarantined source part
    came back) recomputes exactly the histogram passes binned over the
    stale edges."""
    from anovos_tpu_torch.data_ingest.data_ingest import _resolve_files
    from anovos_tpu_torch.data_ingest.guard import IngestError
    from anovos_tpu_torch.data_ingest.prefetch import StreamController, StreamStats
    from anovos_tpu_torch.ops import streaming as st
    from anovos_tpu_torch.ops.drift_kernels import cutoffs_from_bounds
    from anovos_tpu_torch.ops.kernels.histogram import binned_histograms_cols
    from anovos_tpu_torch.shared.runtime import get_runtime

    methods = check_distance_method(method_type)
    drop_cols = drop_cols or []
    cfg = dict(file_configs or {})
    if not pre_existing_source:
        if source_file_path is None:
            raise ValueError("statistics_streaming: source_file_path required unless "
                             "pre_existing_source=True")
        if bin_method != "equal_range":
            raise ValueError("statistics_streaming fits cutoffs from streamed global bounds — only "
                             "bin_method='equal_range' is supported (equal_frequency needs exact "
                             "whole-table quantiles)")
    if source_path == "NA":
        source_path = "intermediate_data"
    model_dir = os.path.join(source_path, model_directory)

    tgt_files = _resolve_files(file_path, file_type)
    src_files = _resolve_files(source_file_path, file_type) if source_file_path else []
    schema = st.stream_schema(tgt_files, file_type, cfg)
    num_all = [c for c, k in schema if k == "num"]
    cat_all = [c for c, k in schema if k == "cat"]
    cols = parse_cols(list_of_cols if list_of_cols != "all" else num_all + cat_all,
                      [c for c, _k in schema], drop_cols)
    num_cols = [c for c in cols if c in num_all]
    cat_cols = [c for c in cols if c in cat_all]

    device = get_runtime().device
    ctl, stats = StreamController(), StreamStats()
    ckpt = None
    if checkpoint_dir:
        ckpt = st.StreamCheckpoint(
            checkpoint_dir,
            st._stream_sig(tgt_files + src_files, file_type, cols, chunk_rows, bin_size,
                           op=f"drift:{method_type}:{bin_method}:{pre_existing_source}"),
            resume=resume)
    # source passes (1, 2) number their chunks over the source files, the
    # target pass (3) over the target files: a shift in one set leaves the
    # other's partials; check_bounds owns a cutoff shift's reach into pass 3
    on_rows_src = st.checkpoint_on_file_rows(ckpt, passes=(1, 2))
    on_rows_tgt = st.checkpoint_on_file_rows(ckpt, passes=(3,))

    def _skip(pass_no):
        return ckpt.committed(pass_no) if (ckpt is not None and resume) else frozenset()

    # ---- numeric cutoffs and source counts --------------------------------
    union_vocabs: Dict[str, np.ndarray] = {}
    freq_p: Dict[str, np.ndarray] = {}
    num_cols_eff = list(num_cols)
    cutoffs = None
    src_rows = 0
    src_counters = None
    if pre_existing_source:
        dfm = load_model_df(model_dir, "attribute_binning")
        cut_map = {r["attribute"]: list(r["parameters"]) for _, r in dfm.iterrows()}
        num_cols_eff = [c for c in num_cols if c in cut_map]
        cutoffs = np.array([cut_map[c] for c in num_cols_eff], dtype=np.float64)
    else:
        parts1 = st._run_pass(
            src_files, file_type, num_cols, chunk_rows, cfg, pass_no=1,
            dispatch=st.moments_dispatch, finish=st.moments_finish,
            host_part=lambda df: _drift_side_host_part(df, cat_cols),
            ctl=ctl, stats=stats, ckpt=ckpt, skip_chunks=_skip(1), on_file_rows=on_rows_src)
        if not parts1:
            raise IngestError(f"statistics_streaming: no readable rows in {len(src_files)} source "
                              "part file(s)")
        src_rows, src_counters = _merge_side_parts(parts1, cat_cols)
        if num_cols:
            agg = st._pairwise_merge([parts1[i] for i in sorted(parts1)])
            # on the runtime's device, as the in-memory fit computes them:
            # the card divides by the bin count as a reciprocal product
            cuts_full = cutoffs_from_bounds(
                *(torch.from_numpy(agg[f].astype(np.float32)).to(device) for f in ("min", "max", "n")),
                bin_size).cpu().numpy()
            cutoffs, num_cols_eff = _drop_allnan_cutoffs(cuts_full, num_cols)
        else:
            num_cols_eff = []

    # the histogram passes are binned over these edges: a shift since the
    # prior run stales every committed histogram chunk
    if ckpt is not None:
        edges = (np.asarray(cutoffs, np.float64) if cutoffs is not None and len(num_cols_eff)
                 else np.zeros((0, max(bin_size - 1, 1))))
        ckpt.check_bounds(edges.astype(np.float32), np.asarray([bin_size], np.float32),
                          passes=(3,) if pre_existing_source else (2, 3))

    cuts_d = (torch.as_tensor(np.asarray(cutoffs, np.float32), device=device).contiguous()
              if num_cols_eff else None)

    def _hist_dispatch(Xc, Mc):
        return {"hist": binned_histograms_cols(Xc, Mc, cuts_d, bin_size)}

    # ---- source histograms (fresh fit only) -------------------------------
    src_num = None
    if not pre_existing_source and num_cols_eff:
        parts2 = st._run_pass(
            src_files, file_type, num_cols_eff, chunk_rows, cfg, pass_no=2,
            dispatch=_hist_dispatch, finish=_hist_finish,
            ctl=ctl, stats=stats, ckpt=ckpt, skip_chunks=_skip(2), on_file_rows=on_rows_src)
        src_num = st._sum_parts(parts2, "hist")

    # ---- target pass ------------------------------------------------------
    parts3 = st._run_pass(
        tgt_files, file_type, num_cols_eff, chunk_rows, cfg, pass_no=3,
        dispatch=_hist_dispatch, finish=_hist_finish,
        host_part=lambda df: _drift_side_host_part(df, cat_cols),
        ctl=ctl, stats=stats, ckpt=ckpt, skip_chunks=_skip(3), on_file_rows=on_rows_tgt)
    if not parts3:
        raise IngestError(f"statistics_streaming: no readable rows in {len(tgt_files)} target "
                          "part file(s)")
    count_target, tgt_counters = _merge_side_parts(parts3, cat_cols)
    tgt_num = st._sum_parts(parts3, "hist") if num_cols_eff else None
    # keyed by name: cat_cols is filtered below
    tgt_cnt = {c: tgt_counters[j] for j, c in enumerate(cat_cols)}
    src_cnt = ({c: src_counters[j] for j, c in enumerate(cat_cols)}
               if src_counters is not None else {})

    # ---- union vocabularies and frequencies -------------------------------
    # counts become f32 before the division, as the JAX package's f32 sums
    # (equal below 2^24 a bin), so the model files are its bytes
    freq_q: Dict[str, np.ndarray] = {}
    if pre_existing_source:
        for c in cols:
            smap = load_frequency_map(model_dir, c)
            if smap is None:
                warnings.warn(f"drift statistics: no persisted source frequencies for {c}; skipping")
                continue
            if c in num_cols_eff:
                freq_p[c] = np.array([smap.get(str(k), 0.0) for k in range(1, bin_size + 1)])
            elif c in cat_cols:
                uni = np.array(sorted(set(smap) | set(tgt_cnt[c])), dtype=object)
                union_vocabs[c] = uni
                freq_p[c] = np.array([smap.get(str(v), 0.0) for v in uni])
        cat_cols = [c for c in cat_cols if c in union_vocabs]
    else:
        for c in cat_cols:
            union_vocabs[c] = np.array(sorted(set(src_cnt[c]) | set(tgt_cnt[c])), dtype=object)
        if cutoffs is not None and len(num_cols_eff):
            save_model_df(pd.DataFrame({"attribute": num_cols_eff,
                                        "parameters": [list(map(float, c)) for c in cutoffs]}),
                          model_dir, "attribute_binning")
        for i, c in enumerate(num_cols_eff):
            freq_p[c] = src_num[i].astype(np.float32) / max(src_rows, 1)
        for c in cat_cols:
            cnt = src_cnt[c]
            freq_p[c] = np.array([cnt.get(str(v), 0) for v in union_vocabs[c]],
                                 np.float32) / max(src_rows, 1)
        if source_save:
            for c in num_cols_eff + cat_cols:
                keys = list(range(1, bin_size + 1)) if c in num_cols_eff else list(union_vocabs[c])
                save_frequency_map(model_dir, c, keys, freq_p[c])

    for i, c in enumerate(num_cols_eff):
        freq_q[c] = tgt_num[i].astype(np.float32) / max(count_target, 1)
    for c in cat_cols:
        cnt = tgt_cnt[c]
        freq_q[c] = np.array([cnt.get(str(v), 0) for v in union_vocabs[c]],
                             np.float32) / max(count_target, 1)

    odf = _metrics_frame(freq_p, freq_q, cols, methods, threshold)
    st._publish_stats("drift_statistics_streaming", ctl, stats)
    if print_impact:
        logger.info(odf.to_string(index=False))
    return odf
