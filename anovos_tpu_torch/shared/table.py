"""Columnar Table on one torch device (counterpart of
``anovos_tpu/shared/table.py``).

- numeric columns: ``float32``/``int32`` tensors with a bool validity mask
  (NaN in the source becomes mask=False, value 0);
- categorical columns: a host dictionary (``vocab``, the sorted unique
  ``str()`` of the non-null values) and ``int32`` codes on the device,
  null = code -1 with mask=False.  A column of ``str`` values and nulls is
  encoded by the host codec from its UTF-8 buffers (``shared/native.py``),
  any other object column by ``str()`` and ``np.unique``: both give the
  same codes and vocabulary;
- timestamp columns: ``int32`` epoch seconds and a mask.

A numeric column whose values do not survive a round trip through f32
(int64 outside the int32 range, float64 that f32 rounds) keeps the f32
approximation in ``data`` for the moment kernels and the exact values in
``exact`` (int64 or float64) for distinct counts, modes and percentiles:
the card has 64-bit types, so no (hi, lo) int32 pair is needed.

Tables are not padded: every column has exactly ``nrows`` rows.

:func:`save_table` and :func:`load_table` keep a Table on disk exactly as
it is in memory (every column's kind, Spark dtype name, data, mask, exact
values and vocabulary, used or not): the node cache's df checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.obs import devprof
from anovos_tpu_torch.shared import native
from anovos_tpu_torch.shared.native import NativeEncodedStrings
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
        with devprof.transfer_bracket("d2h", src.nbytes, label="column.exact_host"):
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


def _put(arr: np.ndarray, device: torch.device, label: str = "table.host_to_column") -> torch.Tensor:
    """The h2d choke point of Table construction, inside a devprof transfer
    bracket (exact bytes; a pageable copy, so the wall is the copy's)."""
    arr = np.ascontiguousarray(arr)
    with devprof.transfer_bracket("h2d", arr.nbytes, label=label):
        return torch.from_numpy(arr).to(device)


def _cat_column(enc: NativeEncodedStrings, n: int, device: torch.device) -> Column:
    codes = np.ascontiguousarray(enc.codes[:n], np.int32)
    return Column("cat", _put(codes, device), _put(codes >= 0, device), vocab=enc.vocab,
                  dtype_name="string")


def host_to_column(arr, n: int, device: torch.device) -> Column:
    """One host array → a Column on ``device``, with the JAX package's
    encoding rules (``anovos_tpu/shared/table.py`` ``_host_to_column``).
    ``arr``: a numpy array, a pandas extension array, or a string column the
    codec already encoded (:class:`NativeEncodedStrings`)."""
    if isinstance(arr, NativeEncodedStrings):
        return _cat_column(arr, n, device)
    if isinstance(arr, pd.api.extensions.ExtensionArray) or arr.dtype == object or arr.dtype.kind == "U":
        enc = native.dict_encode_strings(arr[:n])
        if enc is not None:
            return _cat_column(enc, n, device)
        arr = np.asarray(arr)
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
            if not isinstance(arr, (NativeEncodedStrings, pd.api.extensions.ExtensionArray)):
                arr = np.asarray(arr)
            cols[name] = host_to_column(arr, n, dev)
        return Table(cols, n)

    @staticmethod
    def from_pandas(df: pd.DataFrame, device=None) -> "Table":
        data = {}
        for name in df.columns:
            s = df[name]
            if native.is_string_dtype(s.dtype):
                data[name] = s.array  # string buffers for the codec
            elif s.dtype == object or str(s.dtype) == "category":
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

    def to(self, device) -> "Table":
        """This Table on ``device``: every column's data, mask and exact
        values copied there, vocabularies shared; itself when it is
        there already.  The backend failover moves the df versions a run
        committed on the card to the CPU with it."""
        dev = torch.device(device)
        if not self.columns or self.device == dev:
            return self
        nbytes = sum(c.data.nbytes + c.mask.nbytes + (0 if c.exact is None else c.exact.nbytes)
                     for c in self.columns.values())
        with devprof.transfer_bracket("d2h" if dev.type == "cpu" else "h2d", nbytes, label="table.to"):
            cols: "OrderedDict[str, Column]" = OrderedDict(
                (name, Column(c.kind, c.data.to(dev), c.mask.to(dev), vocab=c.vocab, dtype_name=c.dtype_name,
                              exact=None if c.exact is None else c.exact.to(dev)))
                for name, c in self.columns.items())
        return Table(cols, self.nrows)

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

    def _take(self, idx: torch.Tensor, valid: Optional[torch.Tensor] = None) -> "Table":
        """Rows ``idx`` (int64 on the table's device, in range) as a new
        Table: one ``index_select`` a tensor; ``valid`` False → mask False."""
        cols: "OrderedDict[str, Column]" = OrderedDict()
        for name, c in self.columns.items():
            mask = c.mask.index_select(0, idx)
            if valid is not None:
                mask = mask & valid
            cols[name] = Column(c.kind, c.data.index_select(0, idx), mask, vocab=c.vocab,
                                dtype_name=c.dtype_name,
                                exact=None if c.exact is None else c.exact.index_select(0, idx))
        return Table(cols, len(idx))

    def gather_rows(self, idx, valid=None) -> "Table":
        """New Table whose row r is this table's row ``idx[r]``
        (``anovos_tpu/shared/table.py`` ``gather_rows``).

        ``idx`` is a host int array; ``idx[r] == -1`` or ``valid[r] == False``
        gives a null row (mask False in every column), as outer joins need.
        Vocabularies are kept whole.  An index out of range raises
        IndexError."""
        idx = np.asarray(idx)
        valid = idx >= 0 if valid is None else np.asarray(valid, bool)
        live = idx[valid]
        if live.size and (live.min() < 0 or live.max() >= self.nrows):
            raise IndexError(f"gather_rows: index out of range [0, {self.nrows}) "
                             f"(min={live.min()}, max={live.max()})")
        dev = self.device
        idx_d = _put(np.where(valid, idx, 0).astype(np.int64), dev, label="table.gather_rows")
        return self._take(idx_d, None if valid.all() else _put(valid, dev, label="table.gather_rows"))

    def filter_rows(self, keep) -> "Table":
        """Rows where the bool ``keep`` (host array or tensor, length
        ``nrows``) is True, in order."""
        if len(keep) != self.nrows:
            raise ValueError(f"filter_rows: keep has length {len(keep)}, expected {self.nrows} (nrows)")
        if isinstance(keep, torch.Tensor):
            return self._take(torch.nonzero(keep.to(self.device)).flatten())
        return self._take(_put(np.flatnonzero(np.asarray(keep, bool)).astype(np.int64), self.device,
                               label="table.filter_rows"))

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
            # d2h materialisation boundary: the copy waits for the kernels
            # that produce the column, so this wall holds the device tail
            # the fetch waits on (devprof books it as transfer)
            with devprof.transfer_bracket("d2h", c.data.nbytes + c.mask.nbytes,
                                          label="table.to_pandas"):
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


_TABLE_META = "table.json"
_TABLE_ARRAYS = "columns.npz"


def save_table(table: Table, path: str) -> None:
    """Write ``table`` into the directory ``path``: ``table.json`` (rows,
    and each column's name, kind, dtype name and which arrays it has) and
    ``columns.npz`` (each column's data, mask and exact values as they are
    on the device, and a categorical vocabulary as its UTF-8 bytes and
    offsets), so :func:`load_table` rebuilds an equal Table."""
    import pyarrow as pa

    os.makedirs(path, exist_ok=True)
    arrays, cols = {}, []
    for i, (name, c) in enumerate(table.columns.items()):
        with devprof.transfer_bracket("d2h", c.data.nbytes + c.mask.nbytes, label="table.save"):
            arrays[f"d{i}"] = c.data.cpu().numpy()
            arrays[f"m{i}"] = c.mask.cpu().numpy()
        if c.exact is not None:
            arrays[f"e{i}"] = c.exact_host()
        if c.vocab is not None:
            strs = pa.array([str(v) for v in c.vocab], type=pa.large_string())
            _, offsets, data = strs.buffers()
            arrays[f"vo{i}"] = np.frombuffer(offsets, np.int64)[:len(strs) + 1]
            arrays[f"vb{i}"] = np.frombuffer(data, np.uint8) if data is not None else np.zeros(0, np.uint8)
        cols.append({"name": name, "kind": c.kind, "dtype_name": c.dtype_name,
                     "exact": c.exact is not None, "vocab": c.vocab is not None})
    with open(os.path.join(path, _TABLE_ARRAYS), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(path, _TABLE_META), "w") as f:
        json.dump({"nrows": table.nrows, "columns": cols}, f)


def load_table(path: str, device=None) -> Table:
    """The Table :func:`save_table` wrote into ``path``, its columns
    uploaded to ``device`` (default: the runtime's)."""
    import pyarrow as pa

    dev = torch.device(device) if device is not None else get_runtime().device
    with open(os.path.join(path, _TABLE_META)) as f:
        meta = json.load(f)
    cols: "OrderedDict[str, Column]" = OrderedDict()
    with np.load(os.path.join(path, _TABLE_ARRAYS), allow_pickle=False) as z:
        for i, m in enumerate(meta["columns"]):
            vocab = None
            if m["vocab"]:
                offsets = z[f"vo{i}"]
                strs = pa.LargeStringArray.from_buffers(
                    len(offsets) - 1, pa.py_buffer(offsets.tobytes()), pa.py_buffer(z[f"vb{i}"].tobytes()))
                vocab = np.asarray(strs.to_numpy(zero_copy_only=False), dtype=object)
            cols[m["name"]] = Column(
                m["kind"], _put(z[f"d{i}"], dev, "table.load"), _put(z[f"m{i}"], dev, "table.load"),
                vocab=vocab, dtype_name=m["dtype_name"],
                exact=_put(z[f"e{i}"], dev, "table.load") if m["exact"] else None)
    return Table(cols, meta["nrows"])
