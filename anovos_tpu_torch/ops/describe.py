"""Whole-table description (counterpart of ``anovos_tpu/ops/describe.py``).

- ``describe_numeric``: count/mean/variance/stddev/skewness/kurtosis/
  nonzero from the moments kernel, then one sort per block for min/max,
  the percentile grid, exact distinct counts and the mode.
- ``describe_exact``: the same order statistics over the exact int64 /
  float64 values of wide columns; ``describe_wide_int`` takes int64
  columns as the JAX package's (hi, lo) int32 pairs.
- ``describe_cat``: per-column code histograms, from which count, unique
  count and mode derive;
- ``compensated_moments``: chunked moments merged in float64, whose error
  does not grow with the row count; ``table_describe`` takes its mean,
  variance, stddev, skewness and kurtosis at and above 2^24 rows
  (``ANOVOS_COMPENSATED_MOMENTS``: ``auto``, ``1``, ``0``).

``table_describe`` memoizes per (table, column tuple, compensated mode).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from anovos_tpu_torch.obs.timed import timed
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.ops.segment import cat_valid_mask, code_histograms
from anovos_tpu_torch.ops.streaming import _chunk_stats, _pairwise_merge
from anovos_tpu_torch.shared.table import Table

# the percentile grid every consumer shares (measures_of_percentiles order)
PCTL_QS = (0.0, 0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99, 1.0)

_INT64_MAX = torch.iinfo(torch.int64).max


def _order_stats(Xs: torch.Tensor, n_int: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Distinct count, 'lower' percentile grid and mode of a column-wise
    sorted (rows, k) block whose first n_int[j] entries are valid.  The
    mode is the longest run of equal values; count ties go to the smallest
    value (the first run)."""
    rows, k = Xs.shape
    pos = torch.arange(rows, device=Xs.device)[:, None]
    valid_sorted = pos < n_int[None, :]
    trans = torch.cat([torch.ones((1, k), dtype=torch.bool, device=Xs.device),
                       Xs[1:] != Xs[:-1]], dim=0)
    nunique = (trans & valid_sorted).sum(dim=0)
    n = n_int.to(torch.float32)
    qs = torch.tensor(PCTL_QS, dtype=torch.float32, device=Xs.device)
    q_pos = qs[:, None] * torch.clamp_min(n[None, :] - 1, 0)
    lo_i = torch.minimum(torch.floor(q_pos).to(torch.int64), torch.clamp_min(n_int[None, :] - 1, 0))
    run_start = torch.cummax(torch.where(trans, pos, -1), dim=0).values
    runlen = torch.where(valid_sorted, pos - run_start + 1, 0)
    best = torch.argmax(runlen, dim=0)
    return {
        "nunique": nunique,
        "pctl": torch.gather(Xs, 0, lo_i),
        "mode": torch.gather(Xs, 0, best[None, :])[0],
        "mode_count": torch.gather(runlen, 0, best[None, :])[0],
    }


@timed("ops.describe_numeric")
def describe_numeric(X: torch.Tensor, M: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Moments, percentiles, distinct counts and mode of a (rows, k) block."""
    Xf = X.to(torch.float32)
    n_int = M.sum(dim=0)
    n = n_int.to(torch.float32)
    mom = masked_moments(Xf, M)
    big = torch.finfo(torch.float32).max
    Xs = torch.sort(torch.where(M, Xf, big), dim=0).values
    st = _order_stats(Xs, n_int)
    nan = torch.full_like(n, float("nan"))
    pctls = torch.where(n[None, :] > 0, st["pctl"], float("nan"))
    empty = n_int == 0
    return {
        "count": n_int,
        "mean": mom["mean"],
        "variance": mom["variance"],
        "stddev": mom["stddev"],
        "skewness": mom["skewness"],
        "kurtosis": mom["kurtosis"],
        "min": pctls[0],
        "max": pctls[-1],
        "nonzero": mom["nonzero"],
        "nunique": st["nunique"],
        "percentiles": pctls,  # (len(PCTL_QS), k), 'lower' interpolation
        "mode_value": torch.where(empty, nan, st["mode"]),
        "mode_count": st["mode_count"],
    }


_COMPENSATED_CHUNK = 1 << 16


def chunk_view(X: torch.Tensor, M: torch.Tensor, chunk: int = _COMPENSATED_CHUNK):
    """The column-major chunk view of a (rows, k) block: (k·c, chunk) f32
    values, each column shifted by its first valid finite value, and their
    mask, the tail of each column padded with mask False; and the (k,)
    shift.  Row j·c + i of the view is chunk i of column j."""
    rows, k = X.shape
    Xc, Mc = X.t().to(torch.float32), M.t()
    first = torch.gather(Xc, 1, Mc.to(torch.uint8).argmax(dim=1, keepdim=True))[:, 0]
    shift = torch.where(Mc.any(dim=1) & torch.isfinite(first), first, 0.0)
    c = -(-rows // chunk)
    Xv = torch.zeros((k, c * chunk), dtype=torch.float32, device=X.device)
    Mv = torch.zeros((k, c * chunk), dtype=torch.bool, device=X.device)
    torch.sub(Xc, shift[:, None], out=Xv[:, :rows])
    Mv[:, :rows] = Mc
    return Xv.view(k * c, chunk), Mv.view(k * c, chunk), shift


@timed("ops.compensated_moments")
def compensated_moments(X: torch.Tensor, M: torch.Tensor,
                        chunk: int = _COMPENSATED_CHUNK) -> Dict[str, np.ndarray]:
    """Chunked Chan moments of a (rows, k) block: count, mean, variance
    (sample), stddev, skewness and kurtosis (excess) as float64 host arrays.

    Each column is shifted by its first valid value (exact in f32 for the
    values within a factor of two of it), cut into ``chunk``-row chunks
    (the tail padded with mask False) and laid out as one column-major
    (k·chunks, chunk) block, so one moments-kernel launch centres every
    chunk on its own mean in f32; the chunks then merge pairwise in
    float64 on the host and the shift is added back.  The f32 error stays
    that of one chunk instead of growing with the row count."""
    rows, k = X.shape
    if rows == 0:
        nank = np.full(k, np.nan)
        return {"count": np.zeros(k, np.int64), "mean": nank.copy(), "variance": nank.copy(),
                "stddev": nank.copy(), "skewness": nank.copy(), "kurtosis": nank.copy()}
    Xv, Mv, shift = chunk_view(X, M, chunk)
    c = Xv.shape[0] // k
    parts = {f: v.reshape(k, c) for f, v in _chunk_stats(Xv, Mv).items()}
    agg = _pairwise_merge([{f: v[:, i] for f, v in parts.items()} for i in range(c)])
    n = agg["n"]
    safe_n = np.maximum(n, 1.0)
    m2p = agg["M2"] / safe_n
    with np.errstate(invalid="ignore", divide="ignore"):
        var_samp = np.where(n > 1, agg["M2"] / np.maximum(n - 1.0, 1.0), np.nan)
        skew = np.where(m2p > 0, (agg["M3"] / safe_n) / np.power(np.maximum(m2p, 1e-308), 1.5), np.nan)
        kurt = np.where(m2p > 0, (agg["M4"] / safe_n) / np.maximum(m2p * m2p, 1e-308) - 3.0, np.nan)
    return {
        "count": n.astype(np.int64),
        "mean": np.where(n > 0, agg["mean"] + shift.to(torch.float64).cpu().numpy(), np.nan),
        "variance": var_samp,
        "stddev": np.sqrt(var_samp),
        "skewness": np.where(n > 0, skew, np.nan),
        "kurtosis": np.where(n > 0, kurt, np.nan),
    }


# at and above this many rows the f32 count alone exhausts the significand
_COMPENSATED_AUTO_ROWS = 1 << 24


def _compensated_enabled(rows: int) -> bool:
    """``ANOVOS_COMPENSATED_MOMENTS`` read per call: ``1``/``true``/``always``
    on, ``0``/``false``/``never`` off, otherwise (``auto``) on at and above
    2^24 logical rows."""
    mode = os.environ.get("ANOVOS_COMPENSATED_MOMENTS", "auto").lower()
    if mode in ("1", "true", "always"):
        return True
    if mode in ("0", "false", "never"):
        return False
    return rows >= _COMPENSATED_AUTO_ROWS


def float_order_key(v: torch.Tensor) -> torch.Tensor:
    """float64 → int64 key whose order is the float order (negative floats
    flip every bit but the sign); -0.0 and +0.0 get distinct keys, as in
    the JAX package's wide pairs."""
    b = v.view(torch.int64)
    return b ^ ((b >> 63) & _INT64_MAX)


def float_from_order_key(key: torch.Tensor) -> torch.Tensor:
    return (key ^ ((key >> 63) & _INT64_MAX)).view(torch.float64)


@timed("ops.describe_wide_int")
def describe_exact(E: torch.Tensor, M: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Exact order statistics of wide columns: E (rows, k) int64 or float64,
    M (rows, k).  Returns count, nunique, percentiles (q, k), mode_value and
    mode_count, values in E's dtype.  Timed under the label of the JAX
    function whose work it does, ``describe_wide_int`` (which, in the port,
    only converts (hi, lo) pairs and calls this)."""
    is_float = E.dtype == torch.float64
    keys = float_order_key(E) if is_float else E.to(torch.int64)
    n_int = M.sum(dim=0)
    Ks = torch.sort(torch.where(M, keys, _INT64_MAX), dim=0).values
    st = _order_stats(Ks, n_int)
    back = float_from_order_key if is_float else (lambda t: t)
    return {
        "count": n_int,
        "nunique": st["nunique"],
        "percentiles": back(st["pctl"].contiguous()),
        "mode_value": back(st["mode"].contiguous()),
        "mode_count": st["mode_count"],
    }


def _split_int64(v: torch.Tensor):
    """int64 → the (hi, lo) int32 pair of the JAX package's wide encoding:
    hi = v >> 32, lo = the low 32 bits less 2^31, so that signed (hi, lo)
    order is int64 order."""
    return (v >> 32).to(torch.int32), ((v & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def describe_wide_int(hi: torch.Tensor, lo: torch.Tensor, M: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Exact order statistics of int64 columns given as (hi, lo) int32
    pairs (rows, k) in the JAX package's encoding: the pairs joined into
    int64 and described by ``describe_exact``.  Returns the JAX package's
    keys: count, nunique, pctl_hi/pctl_lo (len(PCTL_QS), k), mode_hi,
    mode_lo and mode_count."""
    v = (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + (1 << 31))
    w = describe_exact(v, M)
    p_hi, p_lo = _split_int64(w["percentiles"])
    m_hi, m_lo = _split_int64(w["mode_value"])
    return {"count": w["count"], "nunique": w["nunique"], "pctl_hi": p_hi, "pctl_lo": p_lo,
            "mode_hi": m_hi, "mode_lo": m_lo, "mode_count": w["mode_count"]}


def describe_cat(C: torch.Tensor, M: torch.Tensor, max_vocab: int) -> Dict[str, torch.Tensor]:
    """Per-column code histograms of (rows, k) codes: counts (k, max_vocab)
    f32 and the count / nunique / mode_code / mode_count derived from it."""
    valid = cat_valid_mask(C, M)
    counts = code_histograms(C, M, max_vocab)
    return {
        "counts": counts,
        "count": valid.sum(dim=0),
        "nunique": (counts > 0).sum(dim=1),
        "mode_code": torch.argmax(counts, dim=1),
        "mode_count": counts.max(dim=1).values,
    }


# above this vocab size a column gets its own histogram instead of widening
# the shared (k, max_vocab) one
_CAT_SHARED_MAX_VOCAB = 1024


_DESCRIBE_LOCK = threading.Lock()


@timed("ops.table_describe")
def table_describe(idf: Table, num_cols: List[str], cat_cols: List[str]) -> Tuple[dict, dict]:
    """Memoized description: (numeric dict of host arrays, cat dict with
    per-column count/nunique/mode_code/mode_count).  The cache lives on
    the Table instance; every transformation makes a new Table.  The
    compensated mode is part of the cache key, so a change of
    ``ANOVOS_COMPENSATED_MOMENTS`` is not served the other mode's
    moments.  Each key is computed once under its own lock: the
    concurrent runner's stats nodes ask for the same description at once,
    and the later ones wait for the first's."""
    compensated = bool(num_cols) and _compensated_enabled(idf.nrows)
    key = (tuple(num_cols), tuple(cat_cols), compensated)
    with _DESCRIBE_LOCK:
        cache = idf.__dict__.setdefault("_describe_cache", {})
        lock = idf.__dict__.setdefault("_describe_locks", {}).setdefault(key, threading.Lock())
    with lock:
        if key not in cache:
            cache[key] = _describe(idf, num_cols, cat_cols, compensated)
        return cache[key]


def _describe(idf: Table, num_cols: List[str], cat_cols: List[str], compensated: bool) -> Tuple[dict, dict]:
    num_out: dict = {}
    if num_cols:
        X, M = idf.numeric_block(num_cols)
        num_out = {k: v.cpu().numpy() for k, v in describe_numeric(X, M).items()}
        if compensated:
            comp = compensated_moments(X, M)
            for kk in ("mean", "variance", "stddev", "skewness", "kurtosis"):
                num_out[kk] = comp[kk]
        wide = [c for c in num_cols if idf.columns[c].is_wide]
        if wide:
            # exact order statistics overwrite the f32 ones; moments stay f32
            for kk in ("percentiles", "min", "max", "mode_value"):
                num_out[kk] = num_out[kk].astype(np.float64)
            for dtype in (torch.int64, torch.float64):
                group = [c for c in wide if idf.columns[c].exact.dtype == dtype]
                if not group:
                    continue
                E = torch.stack([idf.columns[c].exact for c in group], dim=1)
                Mw = torch.stack([idf.columns[c].mask for c in group], dim=1)
                w = {kk: v.cpu().numpy() for kk, v in describe_exact(E, Mw).items()}
                for j, c in enumerate(group):
                    if w["count"][j] == 0:
                        continue  # all-null: keep the NaNs of describe_numeric
                    i = num_cols.index(c)
                    pct = w["percentiles"][:, j].astype(np.float64)
                    num_out["nunique"][i] = w["nunique"][j]
                    num_out["percentiles"][:, i] = pct
                    num_out["min"][i] = pct[0]
                    num_out["max"][i] = pct[-1]
                    num_out["mode_value"][i] = float(w["mode_value"][j])
                    num_out["mode_count"][i] = w["mode_count"][j]
    cat_out: dict = {}
    if cat_cols:
        k = len(cat_cols)
        cat_out = {
            "count": np.zeros(k, np.int64),
            "nunique": np.zeros(k, np.int64),
            "mode_code": np.zeros(k, np.int64),
            "mode_count": np.zeros(k, np.float64),
        }
        small = [c for c in cat_cols if len(idf.columns[c].vocab) <= _CAT_SHARED_MAX_VOCAB]
        groups = [small] if small else []
        groups += [[c] for c in cat_cols if c not in set(small)]
        for cols_g in groups:
            C = torch.stack([idf.columns[c].data for c in cols_g], dim=1)
            Mc = torch.stack([idf.columns[c].mask for c in cols_g], dim=1)
            maxv = max(max(len(idf.columns[c].vocab), 1) for c in cols_g)
            res = {kk: v.cpu().numpy() for kk, v in describe_cat(C, Mc, maxv).items()
                   if kk != "counts"}
            for j, c in enumerate(cols_g):
                i = cat_cols.index(c)
                for kk in cat_out:
                    cat_out[kk][i] = res[kk][j]
    return num_out, cat_out
