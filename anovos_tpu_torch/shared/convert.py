"""State carried over from the JAX package: Tables and persisted drift models.

Both take plain host values (numpy arrays, file paths), so the port never
imports the JAX package; a caller that has both packages turns a JAX
Table into the dict this module reads.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from anovos_tpu_torch.data_transformer.model_io import load_model_df
from anovos_tpu_torch.drift_stability.drift_detector import load_frequency_map
from anovos_tpu_torch.shared.runtime import get_runtime
from anovos_tpu_torch.shared.table import Column, Table


def exact_from_pair(hi: np.ndarray, lo: np.ndarray, wide_kind: str) -> np.ndarray:
    """The JAX package's (hi, lo) int32 wide pair → int64 (``wide_kind``
    "int") or float64 ("float"), as its ``Column.exact_host`` does:
    key = hi << 32 + (lo + 2^31), the float kind being the order-preserving
    key of the float64 bit pattern."""
    key = (hi.astype(np.int64) << 32) + (lo.astype(np.int64) + (1 << 31))
    if wide_kind != "float":
        return key
    u = key.view(np.uint64) ^ np.uint64(0x8000000000000000)
    flip = np.where(u >> np.uint64(63), np.uint64(0x8000000000000000),
                    np.uint64(0xFFFFFFFFFFFFFFFF))
    return (u ^ flip).view(np.float64)


def table_from_numpy_columns(
    columns: Dict[str, Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], str,
                             Optional[Tuple[np.ndarray, np.ndarray, str]]]],
    nrows: int,
    device=None,
) -> Table:
    """A port Table from the JAX Table's columns after ``np.asarray``:
    {name: (data, mask, vocab, dtype_name, exact)} with ``exact`` None or
    the (wide_hi, wide_lo, wide_kind) pair.  Row padding past ``nrows`` is
    cut off; the kind follows from vocab (cat) and dtype_name (ts)."""
    dev = torch.device(device) if device is not None else get_runtime().device
    cols: "OrderedDict[str, Column]" = OrderedDict()
    for name, (data, mask, vocab, dtype_name, exact) in columns.items():
        kind = "cat" if vocab is not None else "ts" if dtype_name == "timestamp" else "num"
        ex = None
        if exact is not None:
            hi, lo, wide_kind = exact
            ex = torch.from_numpy(exact_from_pair(np.asarray(hi)[:nrows], np.asarray(lo)[:nrows],
                                                  wide_kind)).to(dev)
        cols[name] = Column(
            kind,
            torch.from_numpy(np.array(np.asarray(data)[:nrows])).to(dev),
            torch.from_numpy(np.array(np.asarray(mask, bool)[:nrows])).to(dev),
            vocab=None if vocab is None else np.asarray(vocab, dtype=object),
            dtype_name=dtype_name,
            exact=ex,
        )
    return Table(cols, nrows)


def load_drift_model(model_dir: str, cols: Iterable[str]):
    """A persisted drift model (``attribute_binning`` + ``frequency_counts``,
    written by either package) → ({numeric column: cutoffs list},
    {column: {key: p}}); columns without persisted frequencies are absent."""
    dfm = load_model_df(model_dir, "attribute_binning")
    cutoffs = {r["attribute"]: [float(v) for v in r["parameters"]] for _, r in dfm.iterrows()}
    freqs = {}
    for c in cols:
        smap = load_frequency_map(model_dir, c)
        if smap is not None:
            freqs[c] = smap
    return cutoffs, freqs
