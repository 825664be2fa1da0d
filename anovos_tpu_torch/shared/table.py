"""Columnar Table on one torch device (counterpart of
``anovos_tpu/shared/table.py``).

- numeric columns: ``float32``/``int32`` tensors with a bool validity mask
  (NaN in the source becomes mask=False, value 0);
- categorical columns: a host dictionary (``vocab``, the sorted unique
  ``str()`` of the non-null values) and ``int32`` codes on the device,
  null = code -1 with mask=False;
- timestamp columns: ``int32`` epoch seconds and a mask.

A numeric column whose values do not survive a round trip through f32
(int64 outside the int32 range, float64 that f32 rounds) keeps the f32
approximation in ``data`` for the moment kernels and the exact values in
``exact`` (int64 or float64) for distinct counts, modes and percentiles:
the card has 64-bit types, so no (hi, lo) int32 pair is needed.

Tables are not padded: every column has exactly ``nrows`` rows.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.shared.runtime import get_runtime


@dataclasses.dataclass
class Column:
    kind: str  # "num" | "cat" | "ts"
    data: torch.Tensor  # f32/i32 (num), i32 codes (cat), i32 epoch seconds (ts)
    mask: torch.Tensor  # bool, True = valid
    vocab: Optional[np.ndarray] = None  # host strings, cat only
    dtype_name: str = "double"  # Spark-style name for reports
    exact: Optional[torch.Tensor] = None  # int64 / float64 exact values of a wide column

    @property
    def is_wide(self) -> bool:
        return self.exact is not None

    @property
    def is_wide_int(self) -> bool:
        return self.exact is not None and self.exact.dtype == torch.int64

    def exact_host(self) -> np.ndarray:
        """Host values with exactness preserved (int64 / float64 when wide)."""
        src = self.exact if self.exact is not None else self.data
        return src.cpu().numpy()


def _spark_dtype_name(np_dtype) -> str:
    dt = np.dtype(np_dtype)
    if dt.kind in "iu":
        return "bigint" if dt.itemsize > 4 else "int"
    if dt.kind == "f":
        return "double" if dt.itemsize > 4 else "float"
    if dt.kind == "b":
        return "boolean"
    if dt.kind == "M":
        return "timestamp"
    return "string"


def _put(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def host_to_column(arr: np.ndarray, n: int, device: torch.device) -> Column:
    """One host array → a Column on ``device``, with the JAX package's
    encoding rules (``anovos_tpu/shared/table.py`` ``_host_to_column``)."""
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        vals = arr[:n]
        isnull = pd.isna(vals)
        nn_strs = np.array([str(v) for v in vals[~isnull]], dtype=object)
        vocab, codes = np.unique(nn_strs, return_inverse=True)
        code_arr = np.full(n, -1, dtype=np.int32)
        code_arr[~isnull] = codes.astype(np.int32)
        return Column("cat", _put(code_arr, device), _put(~isnull, device),
                      vocab=vocab.astype(object), dtype_name="string")
    if arr.dtype.kind == "M":
        vals = arr[:n].astype("datetime64[s]")
        isnull = np.isnat(vals)
        secs = np.where(isnull, 0, vals.astype("int64")).astype(np.int32)
        return Column("ts", _put(secs, device), _put(~isnull, device), dtype_name="timestamp")
    if arr.dtype.kind == "b":
        return Column("num", _put(arr[:n].astype(np.int32), device),
                      _put(np.ones(n, bool), device), dtype_name="boolean")
    dtn = _spark_dtype_name(arr.dtype)
    vals = arr[:n]
    exact = None
    if vals.dtype.kind == "f":
        isnull = np.isnan(vals)
        host = np.where(isnull, 0.0, vals).astype(np.float32)
        if vals.dtype.itemsize > 4:
            v64 = np.where(isnull, 0.0, vals).astype(np.float64)
            if not np.array_equal(host.astype(np.float64), v64):
                exact = v64
    else:
        isnull = np.zeros(n, dtype=bool)
        if vals.dtype.itemsize > 4:
            lo, hi = vals.min(initial=0), vals.max(initial=0)
            if lo >= np.iinfo(np.int32).min and hi <= np.iinfo(np.int32).max:
                host = vals.astype(np.int32)
            else:
                host = vals.astype(np.float32)
                exact = vals.astype(np.int64)
                dtn = "bigint"
        else:
            host = vals.astype(np.int32) if vals.dtype.kind in "iu" else vals.astype(np.float32)
    return Column("num", _put(host, device), _put(~isnull, device), dtype_name=dtn,
                  exact=None if exact is None else _put(exact, device))


class Table:
    """Columnar table; transformation methods return new Tables."""

    def __init__(self, columns: "OrderedDict[str, Column]", nrows: int):
        self.columns: "OrderedDict[str, Column]" = columns
        self.nrows = int(nrows)

    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray], nrows: Optional[int] = None,
                   device=None) -> "Table":
        """Host column arrays → Table (object → cat, datetime64 → ts,
        numeric → num; NaN/None become nulls)."""
        dev = torch.device(device) if device is not None else get_runtime().device
        cols: "OrderedDict[str, Column]" = OrderedDict()
        if not data:
            return Table(cols, 0)
        n = nrows if nrows is not None else len(next(iter(data.values())))
        for name, arr in data.items():
            cols[name] = host_to_column(np.asarray(arr), n, dev)
        return Table(cols, n)

    @staticmethod
    def from_pandas(df: pd.DataFrame, device=None) -> "Table":
        data = {}
        for name in df.columns:
            s = df[name]
            if s.dtype == object or str(s.dtype) in ("string", "category"):
                data[name] = s.to_numpy(dtype=object)
            else:
                data[name] = s.to_numpy()
        return Table.from_numpy(data, nrows=len(df), device=device)

    @property
    def ncols(self) -> int:
        return len(self.columns)

    @property
    def col_names(self) -> List[str]:
        return list(self.columns.keys())

    @property
    def device(self) -> torch.device:
        if not self.columns:
            return get_runtime().device
        return next(iter(self.columns.values())).data.device

    def dtypes(self) -> List[Tuple[str, str]]:
        return [(k, c.dtype_name) for k, c in self.columns.items()]

    def attribute_type_segregation(self) -> Tuple[List[str], List[str], List[str]]:
        """num_cols, cat_cols, other_cols."""
        num, cat, other = [], [], []
        for k, c in self.columns.items():
            (num if c.kind == "num" else cat if c.kind == "cat" else other).append(k)
        return num, cat, other

    def select(self, names: Sequence[str]) -> "Table":
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise KeyError(f"columns not in table: {missing}")
        return Table(OrderedDict((n, self.columns[n]) for n in names), self.nrows)

    def drop(self, names: Sequence[str]) -> "Table":
        names = set(names)
        return Table(OrderedDict((n, c) for n, c in self.columns.items() if n not in names),
                     self.nrows)

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table(OrderedDict((mapping.get(n, n), c) for n, c in self.columns.items()),
                     self.nrows)

    def with_column(self, name: str, col: Column) -> "Table":
        cols = OrderedDict(self.columns)
        cols[name] = col
        return Table(cols, self.nrows)

    def slice_rows(self, start: int, stop: int) -> "Table":
        """Rows [start, stop) as a new Table (views of the same tensors;
        vocabularies are kept whole)."""
        start, stop = max(0, start), min(self.nrows, stop)
        cols: "OrderedDict[str, Column]" = OrderedDict()
        for name, c in self.columns.items():
            cols[name] = Column(c.kind, c.data[start:stop], c.mask[start:stop], vocab=c.vocab,
                                dtype_name=c.dtype_name,
                                exact=None if c.exact is None else c.exact[start:stop])
        return Table(cols, max(stop - start, 0))

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def numeric_block(self, names: Sequence[str],
                      dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, k) values X and bool mask M of ``names``.

        Stored column-major: X and M are transposed views of contiguous
        (k, rows) stacks, the layout the kernels read, so ``X.t()`` costs
        no copy."""
        if not names:
            empty = torch.empty((0, self.nrows), device=self.device)
            return empty.to(dtype).t(), empty.to(torch.bool).t()
        X = torch.stack([self.columns[n].data.to(dtype) for n in names])
        M = torch.stack([self.columns[n].mask for n in names])
        return X.t(), M.t()

    def to_pandas(self) -> pd.DataFrame:
        out = {}
        n = self.nrows
        for name, c in self.columns.items():
            data = c.data.cpu().numpy()
            mask = c.mask.cpu().numpy()
            if c.kind == "cat":
                vals = np.empty(n, dtype=object)
                valid = mask & (data >= 0)
                vals[valid] = c.vocab[data[valid]]
                vals[~valid] = None
                out[name] = vals
            elif c.kind == "ts":
                s = pd.Series((data.astype("int64") * np.int64(1_000_000_000)).view("datetime64[ns]"))
                s[~mask] = pd.NaT
                out[name] = s
            elif c.exact is not None:
                vals = c.exact_host()
                if c.exact.dtype == torch.float64:
                    vals = vals.copy()
                    vals[~mask] = np.nan
                    out[name] = vals
                elif mask.all():
                    out[name] = vals
                else:
                    out[name] = pd.arrays.IntegerArray(vals, ~mask)
            elif np.issubdtype(data.dtype, np.integer) and mask.all():
                out[name] = data
            else:
                vals = data.astype("float64")
                vals[~mask] = np.nan
                out[name] = vals
        return pd.DataFrame(out, columns=list(self.columns.keys()))

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.kind}" for n, c in self.columns.items())
        return f"Table[{self.nrows} rows]({cols})"
