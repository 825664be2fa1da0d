"""Column transformers (counterpart of ``anovos_tpu/data_transformer/
transformers.py``): so far ``imputation_MMM``, which the quality checks
call, and the output_mode convention it shares with the other transformers.

``imputation_MMM`` fills numeric nulls with the mean (moments kernel) or
the lower median (device sort) and categorical nulls with the mode (code
counts).  Its model artifact is ``<model_path>/imputation_MMM/part-00000.parquet``
[attribute, kind, fill_value (str)], the JAX package's layout, so either
package applies the other's model.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
from anovos_tpu_torch.data_transformer.model_io import load_model_df, save_model_df
from anovos_tpu_torch.ops.quantiles import masked_quantiles
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.ops.segment import code_counts
from anovos_tpu_torch.shared.table import Column, Table
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)


def _emit(idf: Table, new_cols: "OrderedDict[str, Column]", output_mode: str, postfix: str) -> Table:
    """The output_mode convention: replace in place, or append each new
    column as ``name + postfix``."""
    odf = idf
    for name, col in new_cols.items():
        odf = odf.with_column(name if output_mode == "replace" else name + postfix, col)
    return odf


def imputation_MMM(
    idf: Table,
    list_of_cols="missing",
    drop_cols=[],
    method_type: str = "median",
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    stats_missing: dict = {},
    stats_mode: dict = {},
    print_impact: bool = False,
) -> Table:
    """Mean or median (numeric) and mode (categorical) null fill.

    An integer column with an integral fill stays int32; a categorical fill
    absent from the column's vocabulary is appended to it.  Filled columns
    are valid in every row."""
    if method_type not in ("mean", "median"):
        raise TypeError("Invalid input for method_type")
    if list_of_cols == "missing":
        if stats_missing:
            miss = read_dataset(**stats_missing).to_pandas()
            cols = list(miss.loc[miss["missing_count"] > 0, "attribute"])
        else:
            fill = torch.stack([idf.columns[c].mask for c in idf.col_names], 1).sum(dim=0)
            cols = [c for c, f in zip(idf.col_names, fill.cpu().numpy()) if f < idf.nrows]
    else:
        cols = parse_cols(list_of_cols, idf.col_names, [])
    dropset = set(drop_cols if not isinstance(drop_cols, str) else drop_cols.split("|"))
    cols = [c for c in cols if c not in dropset]
    cols = [c for c in cols if c in idf.columns and idf.columns[c].kind in ("num", "cat")]
    if not cols:
        return idf

    num_cols = [c for c in cols if idf.columns[c].kind == "num"]
    cat_cols = [c for c in cols if idf.columns[c].kind == "cat"]
    fills: Dict[str, tuple] = {}
    if pre_existing_model:
        dfm = load_model_df(model_path, "imputation_MMM")
        for _, r in dfm.iterrows():
            fills[r["attribute"]] = (r["kind"], r["fill_value"])
    else:
        if num_cols:
            X, M = idf.numeric_block(num_cols)
            if method_type == "mean":
                vals = masked_moments(X, M)["mean"]
            else:
                vals = masked_quantiles(X, M, [0.5], interpolation="lower")[0]
            for c, v in zip(num_cols, vals.cpu().numpy()):
                fills[c] = ("num", float(v))
        for c in cat_cols:
            col = idf.columns[c]
            cnts = code_counts(col.data, col.mask, max(len(col.vocab), 1)).cpu().numpy()
            fills[c] = ("cat", str(col.vocab[int(np.argmax(cnts))])
                        if len(col.vocab) and cnts.max() > 0 else None)
        if model_path != "NA":
            save_model_df(pd.DataFrame([{"attribute": c, "kind": k, "fill_value": str(v)}
                                        for c, (k, v) in fills.items()]),
                          model_path, "imputation_MMM")

    new_cols: "OrderedDict[str, Column]" = OrderedDict()
    for c in cols:
        if c not in fills:
            continue
        _, v = fills[c]
        col = idf.columns[c]
        everywhere = torch.ones_like(col.mask)
        if col.kind == "num":
            fv = float(v)
            if np.isnan(fv):
                continue
            data = torch.where(col.mask, col.data.to(torch.float32),
                               torch.tensor(fv, dtype=torch.float32, device=col.data.device))
            if col.data.dtype == torch.int32 and fv.is_integer():
                data = data.to(torch.int32)
            new_cols[c] = Column("num", data, everywhere, dtype_name=col.dtype_name)
        else:
            if v is None:
                continue
            hits = np.nonzero(col.vocab == v)[0]
            if len(hits) == 0:
                vocab = np.append(col.vocab, v).astype(object)
                code = len(vocab) - 1
            else:
                vocab, code = col.vocab, int(hits[0])
            data = torch.where(col.mask & (col.data >= 0), col.data, code).to(torch.int32)
            new_cols[c] = Column("cat", data, everywhere, vocab=vocab, dtype_name="string")
    odf = _emit(idf, new_cols, output_mode, "_imputed")
    if print_impact:
        logger.info(f"imputed ({method_type}): {list(new_cols)}")
    return odf
