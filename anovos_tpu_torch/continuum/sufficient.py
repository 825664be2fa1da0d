"""The mergeable sufficient-statistics contract (``from_chunk`` /
``merge`` / ``finalize``), counterpart of
``anovos_tpu/continuum/sufficient.py``.

Each accumulator family turns ONE partition into a small partial, and
the continuum (``continuum/watcher.py``) folds a newly-landed partition in
O(new rows) without re-reading history:

* ``from_chunk(part, ctx, part_key)`` → a **keyed partial map**
  ``{part_key: {array name: np.ndarray}}``: a pure function of that
  partition's rows and the static fold context;
* ``merge(a, b)`` → keyed union, so the monoid is exactly associative and
  order-insensitive; the same key with different content raises;
* ``finalize(state, ctx)`` → the artifact frame.  The partials reduce in
  canonical (sorted part key) order with a pairwise tree, so an artifact
  is a function of the SET of partials, whatever the arrival order.
  Families whose ``combine`` is exact (register max, integer count sums,
  value-count sums) are also associative at the combine level.

Keyed union rather than eager merging: a retracted or rewritten
partition drops its key, which no eagerly merged max or register could.

The device work runs on the card through the port's existing pieces.
A partition's numeric columns go up once as a column-major (k, rows) f32
block and its bool mask (:class:`PartFrame`), the layout the moments and
histogram kernels read without a transpose, and every family reads that
block:

* ``moments``: one moments-kernel launch (``ops/streaming._chunk_stats``)
  a row block, the block partials merged in float64 on the host (the JAX
  package keeps f32 partials);
* ``hll``: ``ops/hll.hll_registers``, bit-equal to the JAX registers;
* ``outlier``: ``quality_checker._outlier_counts_dispatch``;
* ``drift_target``: one histogram-kernel launch a row block
  (``ops/drift_kernels.binned_histograms``), the counts summed in int64;
* ``missing`` and ``categorical`` count on the host with pandas, as the
  JAX package does.

The moments kernel's count and the histogram kernel's bins are f32, exact
up to 2^24.  A partition folds in row blocks of at most
:data:`FOLD_BLOCK_ROWS` rows, so its counts stay exact at any size (the
JAX package folds a partition in one block, and rounds past 2^24 rows).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

__all__ = [
    "FoldContext",
    "DriftSpec",
    "PartFrame",
    "Accumulator",
    "MomentsAccumulator",
    "MissingAccumulator",
    "HLLAccumulator",
    "CategoricalAccumulator",
    "OutlierAccumulator",
    "DriftTargetAccumulator",
    "ACCUMULATORS",
    "FOLD_BLOCK_ROWS",
    "register_accumulator",
    "active_families",
]

# one partial map: canonical part key -> {array name: np.ndarray}
PartialMap = Dict[str, Dict[str, np.ndarray]]

# rows a kernel launch covers at most: the moments kernel's n and the
# histogram kernel's counts are f32, exact up to 2^24
FOLD_BLOCK_ROWS = 1 << 24

# the moments kernel's empty-min/max sentinel, the identity of min/max
_BIG = 3.4e38
_MOMENT_FIELDS = ("n", "mean", "M2", "M3", "M4", "min", "max", "nonzero")


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Static drift configuration for a continuum feed.

    ``model_dir`` holds the persisted binning model and source frequency
    CSVs in the layout ``drift_stability.drift_detector`` persists
    (``attribute_binning`` parquet + ``frequency_counts/<col>/
    part-00000.csv``), so a model the streaming drift pass fitted is read
    as is.  With no model yet, ``baseline`` (an fnmatch glob over part
    keys) names the partitions the watcher fits one from; baseline
    partitions are the source side and never accumulate target
    histograms."""

    model_dir: str
    bin_size: int = 10
    method_type: str = "PSI"
    threshold: float = 0.1
    baseline: str = ""

    def is_baseline(self, part_key: str) -> bool:
        return bool(self.baseline) and fnmatch.fnmatch(part_key, self.baseline)


@dataclasses.dataclass
class FoldContext:
    """Everything ``from_chunk`` may depend on besides the partition's own
    rows: static feed config, or state derived from config and the
    partition SET (the fitted drift cutoffs), never arrival order."""

    list_of_cols: object = "all"         # "all" | list of names
    drop_cols: Tuple[str, ...] = ()
    hll_p: int = 9                       # precision_for_rsd(0.05)
    outlier_bounds: Optional[Dict[str, Tuple[float, float]]] = None
    drift: Optional[DriftSpec] = None
    # fitted interior cutoffs per numeric column (None until the model
    # exists); loaded from / persisted to ``drift.model_dir``
    drift_cutoffs: Optional[Dict[str, np.ndarray]] = None

    def keep(self, col: str) -> bool:
        if col in self.drop_cols:
            return False
        return self.list_of_cols == "all" or col in self.list_of_cols


class PartFrame:
    """One decoded partition and its device block, built once and shared
    by every numeric family."""

    def __init__(self, frame: pd.DataFrame, ctx: FoldContext):
        self.frame = frame
        self.ctx = ctx
        self.num_cols = [
            str(c) for c in frame.columns
            if ctx.keep(str(c)) and pd.api.types.is_numeric_dtype(frame[c])
        ]
        self.cat_cols = [
            str(c) for c in frame.columns
            if ctx.keep(str(c)) and not pd.api.types.is_numeric_dtype(frame[c])
            and (frame[c].dtype == object or str(frame[c].dtype) in ("string", "str"))
        ]
        self._block = None
        self._cat = None

    def device_block(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, mask): (k, rows) f32 over ``num_cols``, nulls stored as
        0 with mask False, and its bool mask, on the runtime's device."""
        if self._block is None:
            from anovos_tpu_torch.shared.runtime import get_runtime

            k, rows = len(self.num_cols), len(self.frame)
            vals = np.empty((k, rows), np.float32)
            mask = np.empty((k, rows), bool)
            for j, c in enumerate(self.num_cols):
                np.copyto(vals[j], self.frame[c].to_numpy(np.float32, na_value=np.nan))
                np.isnan(vals[j], out=mask[j])
                vals[j][mask[j]] = 0.0
                np.logical_not(mask[j], out=mask[j])
            dev = get_runtime().device
            self._block = (torch.from_numpy(vals).to(dev), torch.from_numpy(mask).to(dev))
        return self._block

    def row_blocks(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The device block cut into contiguous (k, ≤ FOLD_BLOCK_ROWS)
        pieces in row order (the whole block, uncopied, when it fits)."""
        X, M = self.device_block()
        step = FOLD_BLOCK_ROWS
        rows = X.shape[1]
        if rows <= step:
            yield X, M
            return
        for s in range(0, rows, step):
            yield X[:, s:s + step].contiguous(), M[:, s:s + step].contiguous()

    def cat_counts(self) -> Dict[str, np.ndarray]:
        """{"cols", "cat<j>_v", "cat<j>_n"}: each categorical column's value
        counts, sorted by value (a partial must not depend on pandas'
        tie order)."""
        if self._cat is None:
            out = {"cols": np.asarray(self.cat_cols, "U")}
            for j, c in enumerate(self.cat_cols):
                vc = self.frame[c].dropna().astype(str).value_counts().sort_index()
                out[f"cat{j}_v"] = vc.index.to_numpy(dtype="U")
                out[f"cat{j}_n"] = vc.to_numpy(np.int64)
            self._cat = out
        return self._cat


def _assert_same(key: str, a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> None:
    if sorted(a) != sorted(b):
        raise ValueError(f"merge collision on part {key!r}: differing array sets")
    for name in a:
        if not np.array_equal(np.asarray(a[name]), np.asarray(b[name])):
            raise ValueError(
                f"merge collision on part {key!r}: array {name!r} differs — "
                "the same partition key was folded with different content")


ACCUMULATORS: Dict[str, type] = {}
_REGISTRY_LOCK = threading.Lock()


def register_accumulator(cls: type) -> type:
    """Register one accumulator family under ``cls.name``; it must define
    ``from_chunk``, ``merge`` and ``finalize``."""
    if not getattr(cls, "name", ""):
        raise ValueError(f"accumulator {cls.__name__} has no name")
    for attr in ("from_chunk", "merge", "finalize"):
        if not callable(getattr(cls, attr, None)):
            raise TypeError(f"accumulator {cls.__name__} lacks {attr}()")
    with _REGISTRY_LOCK:
        if cls.name in ACCUMULATORS:
            raise ValueError(f"duplicate accumulator family {cls.name!r}")
        ACCUMULATORS[cls.name] = cls
    return cls


class Accumulator:
    """Base contract.  Subclasses implement ``part_stats`` (one partition →
    partial arrays), ``combine`` (the pairwise numeric combination the
    canonical reduce uses) and ``finalize``; ``from_chunk``/``merge``, the
    monoid itself, are shared."""

    name: str = ""

    @classmethod
    def from_chunk(cls, part: PartFrame, ctx: FoldContext, part_key: str) -> PartialMap:
        """The keyed singleton state of one partition."""
        return {part_key: cls.part_stats(part, ctx)}

    @staticmethod
    def merge(a: PartialMap, b: PartialMap) -> PartialMap:
        """Keyed union: exactly associative and order-insensitive."""
        out = dict(a)
        for k, v in b.items():
            if k in out:
                _assert_same(k, out[k], v)
            else:
                out[k] = v
        return out

    @classmethod
    def part_stats(cls, part: PartFrame, ctx: FoldContext) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @classmethod
    def combine(cls, x: Dict[str, np.ndarray], y: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @classmethod
    def reduce(cls, state: PartialMap) -> Optional[Dict[str, np.ndarray]]:
        """Pairwise tree reduce in canonical (sorted part key) order."""
        parts = [state[k] for k in sorted(state)]
        if not parts:
            return None
        while len(parts) > 1:
            parts = [
                cls.combine(parts[i], parts[i + 1]) if i + 1 < len(parts) else parts[i]
                for i in range(0, len(parts), 2)
            ]
        return parts[0]

    @classmethod
    def finalize(cls, state: PartialMap, ctx: FoldContext):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# column-aligned helpers: partials carry their own column list (the schema
# can drift mid-feed), so pairwise combination aligns by NAME over the union
# ---------------------------------------------------------------------------
def _cols_of(p: Dict[str, np.ndarray]) -> List[str]:
    return [str(c) for c in np.asarray(p.get("cols", np.array([], "U1")))]


def _aligned(cols: List[str], part_cols: List[str], arr: np.ndarray, fill) -> np.ndarray:
    """``arr`` (|part_cols|, ...) scattered into (|cols|, ...) with
    ``fill`` rows for absent columns."""
    arr = np.asarray(arr)
    out = np.full((len(cols),) + arr.shape[1:], fill, dtype=arr.dtype)
    pos = {c: i for i, c in enumerate(cols)}
    for j, c in enumerate(part_cols):
        out[pos[c]] = arr[j]
    return out


def _take(part_cols: List[str], want: List[str], arr: np.ndarray) -> np.ndarray:
    idx = [part_cols.index(c) for c in want]
    return np.asarray(arr)[idx]


def _counter_sum(cx: Dict[str, Dict[str, int]], cy: Dict[str, Dict[str, int]],
                 out: Dict[str, np.ndarray], cols_key: str) -> None:
    """Per-column value-count sums of two counter maps into ``out``
    (``cols_key`` plus ``cat<j>_v``/``cat<j>_n``, values sorted)."""
    cols = sorted(set(cx) | set(cy))
    out[cols_key] = np.asarray(cols, "U")
    for j, c in enumerate(cols):
        cnt: Dict[str, int] = dict(cx.get(c, {}))
        for v, n in cy.get(c, {}).items():
            cnt[v] = cnt.get(v, 0) + n
        keys = sorted(cnt)
        out[f"cat{j}_v"] = np.asarray(keys, "U")
        out[f"cat{j}_n"] = np.asarray([cnt[k] for k in keys], np.int64)


def _counters(p: Dict[str, np.ndarray], cols_key: str) -> Dict[str, Dict[str, int]]:
    cols = [str(c) for c in np.asarray(p.get(cols_key, np.array([], "U1")))]
    out = {}
    for j, c in enumerate(cols):
        vals = np.asarray(p.get(f"cat{j}_v", np.array([], "U1")))
        cnts = np.asarray(p.get(f"cat{j}_n", np.array([], np.int64)))
        out[c] = {str(v): int(n) for v, n in zip(vals, cnts)}
    return out


@register_accumulator
class MomentsAccumulator(Accumulator):
    """Masked moments with exact min/max/nonzero per numeric column (the
    ``describe`` family).  A partition's partial is the float64 merge of
    its row blocks' moments-kernel partials (``ops/streaming._chunk_stats``);
    ``combine`` is Chan et al.'s pairwise combination over the column
    union, a column absent on one side passing through, so a column that
    appears mid-feed behaves as all-null before its first partition."""

    name = "moments"

    @classmethod
    def part_stats(cls, part: PartFrame, ctx: FoldContext) -> Dict[str, np.ndarray]:
        from anovos_tpu_torch.ops.streaming import _chunk_stats, _pairwise_merge

        k = len(part.num_cols)
        out = {"cols": np.asarray(part.num_cols, "U"),
               "rows": np.asarray(len(part.frame), np.int64)}
        if not k or not len(part.frame):
            for nm in _MOMENT_FIELDS:
                out[nm] = np.zeros((k,), np.float64)
            out["min"][:], out["max"][:] = _BIG, -_BIG
            return out
        agg = _pairwise_merge([_chunk_stats(X, M) for X, M in part.row_blocks()])
        for nm in _MOMENT_FIELDS:
            out[nm] = np.asarray(agg[nm], np.float64)
        return out

    @classmethod
    def combine(cls, x, y):
        from anovos_tpu_torch.ops.streaming import _combine

        xc, yc = _cols_of(x), _cols_of(y)
        both = [c for c in xc if c in set(yc)]
        fills = {"n": 0.0, "mean": 0.0, "M2": 0.0, "M3": 0.0, "M4": 0.0,
                 "min": _BIG, "max": -_BIG, "nonzero": 0.0}
        cols = sorted(set(xc) | set(yc))
        out = {"cols": np.asarray(cols, "U"), "rows": x["rows"] + y["rows"]}
        merged = _combine({nm: _take(xc, both, x[nm]) for nm in fills},
                          {nm: _take(yc, both, y[nm]) for nm in fills})
        pos = {c: i for i, c in enumerate(cols)}
        for nm, fill in fills.items():
            arr = np.full((len(cols),), fill, np.float64)
            for src_cols, src in ((xc, x), (yc, y)):
                for j, c in enumerate(src_cols):
                    if c not in both:
                        arr[pos[c]] = np.asarray(src[nm])[j]
            for j, c in enumerate(both):
                arr[pos[c]] = np.asarray(merged[nm])[j]
            out[nm] = arr
        return out

    @classmethod
    def finalize(cls, state: PartialMap, ctx: FoldContext) -> pd.DataFrame:
        """[attribute, count, mean, stddev, variance, skewness, kurtosis,
        min, max, nonzero]: ``ops/reductions.finalize_moments`` on float64
        host tensors, rounded as ``describe_streaming`` rounds."""
        from anovos_tpu_torch.ops.reductions import finalize_moments

        agg = cls.reduce(state)
        if agg is None or not len(_cols_of(agg)):
            return pd.DataFrame(columns=[
                "attribute", "count", "mean", "stddev", "variance",
                "skewness", "kurtosis", "min", "max", "nonzero"])
        f64 = {nm: torch.from_numpy(np.asarray(agg[nm], np.float64)) for nm in _MOMENT_FIELDS}
        fin = {k: v.numpy() for k, v in finalize_moments(
            f64["n"], f64["mean"] * f64["n"], f64["M2"], f64["M3"], f64["M4"],
            f64["min"], f64["max"], f64["nonzero"]).items()}
        return pd.DataFrame({
            "attribute": _cols_of(agg),
            "count": agg["n"].astype(np.int64),
            "mean": np.round(fin["mean"], 4),
            "stddev": np.round(fin["stddev"], 4),
            "variance": np.round(fin["variance"], 4),
            "skewness": np.round(fin["skewness"], 4),
            "kurtosis": np.round(fin["kurtosis"], 4),
            "min": fin["min"].astype(np.float32),
            "max": fin["max"].astype(np.float32),
            "nonzero": agg["nonzero"].astype(np.int64),
        })

    @staticmethod
    def part_metrics(p: Dict[str, np.ndarray]) -> pd.DataFrame:
        """[attribute, mean, stddev, kurtosis] of ONE partition's partial:
        the stability index's metric row (kurtosis carries the
        reference's +3, ``drift_stability/stability.py``)."""
        cols = _cols_of(p)
        n = np.asarray(p["n"], np.float64)
        m2 = np.asarray(p["M2"], np.float64)
        m4 = np.asarray(p["M4"], np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            std = np.sqrt(m2 / np.maximum(n - 1.0, 1.0))
            m2p = m2 / np.maximum(n, 1.0)
            kurt = np.where(m2p > 0, (m4 / np.maximum(n, 1.0)) / np.maximum(m2p * m2p, 1e-38) - 3.0,
                            np.nan)
        return pd.DataFrame({
            "attribute": cols,
            "mean": np.asarray(p["mean"], np.float64),
            "stddev": np.where(n > 1, std, np.nan),
            "kurtosis": kurt + 3.0,
        })


@register_accumulator
class MissingAccumulator(Accumulator):
    """Row and per-column valid counts (every configured column).  Missing
    counts are ``total rows − valid`` at finalize, so a column absent from
    early partitions counts their rows as missing."""

    name = "missing"

    @classmethod
    def part_stats(cls, part: PartFrame, ctx: FoldContext) -> Dict[str, np.ndarray]:
        cols = [c for c in part.frame.columns if ctx.keep(str(c))]
        return {
            "cols": np.asarray([str(c) for c in cols], "U"),
            "rows": np.asarray(len(part.frame), np.int64),
            "valid": (part.frame[cols].notna().sum().to_numpy(np.int64)
                      if cols else np.zeros((0,), np.int64)),
        }

    @classmethod
    def combine(cls, x, y):
        xc, yc = _cols_of(x), _cols_of(y)
        cols = sorted(set(xc) | set(yc))
        return {
            "cols": np.asarray(cols, "U"),
            "rows": x["rows"] + y["rows"],
            "valid": _aligned(cols, xc, x["valid"], 0) + _aligned(cols, yc, y["valid"], 0),
        }

    @classmethod
    def finalize(cls, state: PartialMap, ctx: FoldContext) -> pd.DataFrame:
        agg = cls.reduce(state)
        if agg is None:
            return pd.DataFrame(columns=["attribute", "missing_count", "missing_pct"])
        total = int(agg["rows"])
        missing = total - np.asarray(agg["valid"], np.int64)
        return pd.DataFrame({
            "attribute": _cols_of(agg),
            "missing_count": missing,
            "missing_pct": np.round(missing / max(total, 1), 4),
        })


@register_accumulator
class HLLAccumulator(Accumulator):
    """HyperLogLog registers per numeric column (``ops/hll``); the register
    merge, elementwise max, is exactly associative and commutative."""

    name = "hll"

    @classmethod
    def part_stats(cls, part: PartFrame, ctx: FoldContext) -> Dict[str, np.ndarray]:
        from anovos_tpu_torch.ops.hll import hll_registers

        k = len(part.num_cols)
        out = {"cols": np.asarray(part.num_cols, "U"), "p": np.asarray(ctx.hll_p, np.int64)}
        if not k:
            out["registers"] = np.zeros((0, 1 << ctx.hll_p), np.int32)
            return out
        X, M = part.device_block()
        # (rows, k) views of the column-major block: hll_registers' layout
        out["registers"] = hll_registers(X.t(), M.t(), ctx.hll_p).cpu().numpy()
        return out

    @classmethod
    def combine(cls, x, y):
        xc, yc = _cols_of(x), _cols_of(y)
        cols = sorted(set(xc) | set(yc))
        return {
            "cols": np.asarray(cols, "U"),
            "p": x["p"],
            "registers": np.maximum(_aligned(cols, xc, x["registers"], 0),
                                    _aligned(cols, yc, y["registers"], 0)),
        }

    @classmethod
    def finalize(cls, state: PartialMap, ctx: FoldContext) -> pd.DataFrame:
        from anovos_tpu_torch.ops.hll import hll_estimate

        agg = cls.reduce(state)
        if agg is None or not len(_cols_of(agg)):
            return pd.DataFrame(columns=["attribute", "distinct_approx"])
        return pd.DataFrame({
            "attribute": _cols_of(agg),
            "distinct_approx": np.round(hll_estimate(agg["registers"])).astype(np.int64),
        })


@register_accumulator
class CategoricalAccumulator(Accumulator):
    """Per-categorical-column value counts, string-keyed."""

    name = "categorical"

    @classmethod
    def part_stats(cls, part: PartFrame, ctx: FoldContext) -> Dict[str, np.ndarray]:
        return dict(part.cat_counts())

    @classmethod
    def counters(cls, p: Dict[str, np.ndarray]) -> Dict[str, Dict[str, int]]:
        return _counters(p, "cols")

    @classmethod
    def combine(cls, x, y):
        out: Dict[str, np.ndarray] = {}
        _counter_sum(cls.counters(x), cls.counters(y), out, "cols")
        return out

    @classmethod
    def finalize(cls, state: PartialMap, ctx: FoldContext) -> pd.DataFrame:
        """[attribute, distinct, top_value, top_count]: exact distinct
        counts (the counter is the exact sketch); the top value's ties go
        to the smallest value."""
        agg = cls.reduce(state)
        if agg is None or not len(_cols_of(agg)):
            return pd.DataFrame(columns=["attribute", "distinct", "top_value", "top_count"])
        rows = []
        for c, cnt in sorted(cls.counters(agg).items()):
            if cnt:
                top = max(sorted(cnt), key=lambda v: cnt[v])
                rows.append({"attribute": c, "distinct": len(cnt),
                             "top_value": top, "top_count": cnt[top]})
            else:
                rows.append({"attribute": c, "distinct": 0, "top_value": "", "top_count": 0})
        return pd.DataFrame(rows)


@register_accumulator
class OutlierAccumulator(Accumulator):
    """Outlier counts against pre-fitted bounds (the
    ``outlier_stats_streaming`` contract): int64 counts, exactly
    mergeable.  Active only when the fold context carries bounds."""

    name = "outlier"

    @classmethod
    def part_stats(cls, part: PartFrame, ctx: FoldContext) -> Dict[str, np.ndarray]:
        from anovos_tpu_torch.data_analyzer.quality_checker import _outlier_counts_dispatch

        bounds = ctx.outlier_bounds or {}
        cols = [c for c in part.num_cols if c in bounds]
        out = {"cols": np.asarray(cols, "U")}
        if not cols:
            out["n_lo"] = np.zeros((0,), np.int64)
            out["n_hi"] = np.zeros((0,), np.int64)
            return out
        k = len(part.num_cols)
        lo = np.full((k,), -np.inf, np.float32)
        hi = np.full((k,), np.inf, np.float32)
        for j, c in enumerate(part.num_cols):
            if c in bounds:
                b = bounds[c]
                lo[j] = b[0] if b[0] is not None else -np.inf
                hi[j] = b[1] if b[1] is not None else np.inf
        X, _M = part.device_block()
        dispatch = _outlier_counts_dispatch(torch.from_numpy(lo).to(X.device),
                                            torch.from_numpy(hi).to(X.device))
        n_lo = np.zeros((k,), np.int64)
        n_hi = np.zeros((k,), np.int64)
        for Xb, Mb in part.row_blocks():
            got = dispatch(Xb, Mb)
            n_lo += got["n_lo"].cpu().numpy().astype(np.int64)
            n_hi += got["n_hi"].cpu().numpy().astype(np.int64)
        idx = [part.num_cols.index(c) for c in cols]
        out["n_lo"] = n_lo[idx]
        out["n_hi"] = n_hi[idx]
        return out

    @classmethod
    def combine(cls, x, y):
        xc, yc = _cols_of(x), _cols_of(y)
        cols = sorted(set(xc) | set(yc))
        return {
            "cols": np.asarray(cols, "U"),
            "n_lo": _aligned(cols, xc, x["n_lo"], 0) + _aligned(cols, yc, y["n_lo"], 0),
            "n_hi": _aligned(cols, xc, x["n_hi"], 0) + _aligned(cols, yc, y["n_hi"], 0),
        }

    @classmethod
    def finalize(cls, state: PartialMap, ctx: FoldContext) -> pd.DataFrame:
        agg = cls.reduce(state)
        if agg is None:
            return pd.DataFrame(columns=["attribute", "lower_outliers", "upper_outliers"])
        return pd.DataFrame({
            "attribute": _cols_of(agg),
            "lower_outliers": np.asarray(agg["n_lo"], np.int64),
            "upper_outliers": np.asarray(agg["n_hi"], np.int64),
        })


def binned_counts(part: PartFrame, cut_map: Dict[str, np.ndarray], bin_size: int) -> np.ndarray:
    """(k, bin_size) int64 counts of the partition's numeric columns over
    ``cut_map``'s interior cutoffs (a NaN row for a column without any):
    one histogram-kernel launch a row block, summed in int64."""
    from anovos_tpu_torch.ops.drift_kernels import binned_histograms

    X, _M = part.device_block()
    cuts = np.full((len(part.num_cols), bin_size - 1), np.nan, np.float32)
    for j, c in enumerate(part.num_cols):
        if c in cut_map:
            cuts[j] = np.asarray(cut_map[c], np.float32)
    cuts_d = torch.from_numpy(cuts).to(X.device)
    hist = np.zeros((len(part.num_cols), bin_size), np.int64)
    for Xb, Mb in part.row_blocks():
        # (rows, k) views: binned_histograms transposes them back without a copy
        hist += binned_histograms(Xb.t(), Mb.t(), cuts_d, bin_size).cpu().numpy().astype(np.int64)
    return hist


@register_accumulator
class DriftTargetAccumulator(Accumulator):
    """Target-side drift ingredients binned over the FIXED persisted model
    cutoffs: per-column (bin_size,) counts, categorical value counts and
    live rows.  Fixed edges are what make this a monoid (a re-fit would
    stale every prior partial), so the cutoffs come from the persisted
    model and never move.  The watcher keeps baseline partitions out."""

    name = "drift_target"

    @classmethod
    def part_stats(cls, part: PartFrame, ctx: FoldContext) -> Dict[str, np.ndarray]:
        if ctx.drift is None or ctx.drift_cutoffs is None:
            raise RuntimeError("drift_target requires fitted cutoffs in the fold context")
        bin_size = ctx.drift.bin_size
        cut_map = ctx.drift_cutoffs
        cols = [c for c in part.num_cols if c in cut_map]
        out = {"cols": np.asarray(cols, "U"), "rows": np.asarray(len(part.frame), np.int64)}
        if cols:
            hist = binned_counts(part, cut_map, bin_size)
            out["hist"] = hist[[part.num_cols.index(c) for c in cols]]
        else:
            out["hist"] = np.zeros((0, bin_size), np.int64)
        # the categorical target counts ride along, so the family is
        # self-contained (the source side's vocabulary joins at finalize)
        cat = part.cat_counts()
        out["cat_cols"] = cat["cols"]
        for j in range(len(part.cat_cols)):
            out[f"cat{j}_v"] = cat[f"cat{j}_v"]
            out[f"cat{j}_n"] = cat[f"cat{j}_n"]
        return out

    @classmethod
    def _cat_counters(cls, p: Dict[str, np.ndarray]) -> Dict[str, Dict[str, int]]:
        return _counters(p, "cat_cols")

    @classmethod
    def combine(cls, x, y):
        xc, yc = _cols_of(x), _cols_of(y)
        cols = sorted(set(xc) | set(yc))
        hx, hy = np.asarray(x["hist"]), np.asarray(y["hist"])
        nb = hx.shape[1] if hx.ndim == 2 and hx.shape[1] else (
            hy.shape[1] if hy.ndim == 2 and hy.shape[1] else 1)
        if not hx.size:
            hx = np.zeros((len(xc), nb), np.int64)
        if not hy.size:
            hy = np.zeros((len(yc), nb), np.int64)
        out = {
            "cols": np.asarray(cols, "U"),
            "rows": x["rows"] + y["rows"],
            "hist": _aligned(cols, xc, hx, 0) + _aligned(cols, yc, hy, 0),
        }
        _counter_sum(cls._cat_counters(x), cls._cat_counters(y), out, "cat_cols")
        return out

    @classmethod
    def freqs(cls, p: Dict[str, np.ndarray], ctx: FoldContext):
        """(freq_p, freq_q) of ONE partial (a partition's, or the canonical
        reduce's) against the persisted source model, with
        ``drift_detector``'s ``pre_existing_source`` union semantics: per
        categorical column the vocabulary is the persisted source values ∪
        this partial's, source probability 0 for the unseen.  The
        cumulative finalize and the per-arrival alerts share it."""
        num_fp, cat_smaps = _load_source_freqs(ctx)
        rows = max(int(p["rows"]), 1)
        freq_p: Dict[str, np.ndarray] = {}
        freq_q: Dict[str, np.ndarray] = {}
        for j, c in enumerate(_cols_of(p)):
            if c in num_fp:
                freq_p[c] = num_fp[c]
                freq_q[c] = np.asarray(p["hist"])[j].astype(np.float64) / rows
        for c, cnt in cls._cat_counters(p).items():
            smap = cat_smaps.get(c)
            if smap is None:
                continue
            uni = sorted(set(smap) | set(cnt))
            freq_p[c] = np.array([smap.get(v, 0.0) for v in uni])
            freq_q[c] = np.array([cnt.get(v, 0) for v in uni], np.float64) / rows
        return freq_p, freq_q

    @classmethod
    def finalize(cls, state: PartialMap, ctx: FoldContext) -> pd.DataFrame:
        """The cumulative drift frame [attribute, <methods…>, flagged]
        against the persisted source model (``drift_detector``'s
        ``_metrics_frame``)."""
        from anovos_tpu_torch.drift_stability.drift_detector import _metrics_frame
        from anovos_tpu_torch.drift_stability.validations import check_distance_method

        if ctx.drift is None:
            return pd.DataFrame(columns=["attribute", "flagged"])
        methods = check_distance_method(ctx.drift.method_type)
        agg = cls.reduce(state)
        if agg is None:
            return pd.DataFrame(columns=["attribute"] + methods + ["flagged"])
        freq_p, freq_q = cls.freqs(agg, ctx)
        cols = sorted(set(freq_p) & set(freq_q))
        return _metrics_frame(freq_p, freq_q, cols, methods, ctx.drift.threshold)


def _load_source_freqs(ctx: FoldContext):
    """(numeric freq_p per column, categorical source probability map per
    column) from the persisted model, through
    ``drift_detector.load_frequency_map``."""
    from anovos_tpu_torch.drift_stability.drift_detector import load_frequency_map

    num_fp: Dict[str, np.ndarray] = {}
    cat_smaps: Dict[str, Dict[str, float]] = {}
    if ctx.drift is None:
        return num_fp, cat_smaps
    base = os.path.join(ctx.drift.model_dir, "frequency_counts")
    if not os.path.isdir(base):
        return num_fp, cat_smaps
    bin_size = ctx.drift.bin_size
    num_cols = set(ctx.drift_cutoffs or {})
    for c in sorted(os.listdir(base)):
        smap = load_frequency_map(ctx.drift.model_dir, c)
        if smap is None:
            continue
        if c in num_cols:
            num_fp[c] = np.array([smap.get(str(k), 0.0) for k in range(1, bin_size + 1)])
        else:
            cat_smaps[c] = smap
    return num_fp, cat_smaps


def active_families(ctx: FoldContext, part_key: str) -> List[str]:
    """The families one partition folds into under ``ctx``: the base set,
    outliers when bounds exist, and the drift target family when cutoffs
    exist and the partition is not on the baseline (source) side."""
    fams = ["moments", "missing", "hll", "categorical"]
    if ctx.outlier_bounds:
        fams.append("outlier")
    if (ctx.drift is not None and ctx.drift_cutoffs is not None
            and not ctx.drift.is_baseline(part_key)):
        fams.append("drift_target")
    return fams
