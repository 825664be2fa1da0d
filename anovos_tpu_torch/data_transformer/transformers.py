"""Column transformers (counterpart of ``anovos_tpu/data_transformer/
transformers.py``): so far binning (``attribute_binning``,
``monotonic_binning``), label and one-hot encoding
(``cat_to_num_unsupervised`` and its dispatcher) and ``imputation_MMM``,
with the output_mode convention they share.

Model artifacts use the JAX package's layouts, so either package applies
the other's model: ``<model_path>/attribute_binning/part-00000.parquet``
[attribute, parameters = interior cutoffs],
``cat_to_num_unsupervised/part-00000.csv`` [attribute, category, index] and
``imputation_MMM/part-00000.parquet`` [attribute, kind, fill_value (str)].
"""

from __future__ import annotations

import logging
import warnings
from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
from anovos_tpu_torch.data_transformer.model_io import load_model_df, save_model_df
from anovos_tpu_torch.ops.histogram import digitize
from anovos_tpu_torch.ops.quantiles import masked_quantiles
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.ops.segment import cat_valid_mask, code_counts, vocab_lookup
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


def _cols_of(idf: Table, kind: str, list_of_cols, drop_cols, extra_drop: Sequence[str] = ()):
    """The ``list_of_cols``/``drop_cols`` selection ("all" = every column of
    ``kind``, "num" or "cat"); a selected column of another kind raises."""
    num_all, cat_all, _ = idf.attribute_type_segregation()
    of_kind = num_all if kind == "num" else cat_all
    cols = parse_cols(list_of_cols if list_of_cols != "all" else of_kind, idf.col_names, drop_cols)
    cols = [c for c in cols if c not in set(extra_drop)]
    bad = [c for c in cols if c not in of_kind]
    if bad:
        name = "numerical" if kind == "num" else "categorical"
        raise TypeError(f"Invalid input for Column(s): non-{name} {bad}")
    return cols


# ----------------------------------------------------------------------
# binning
# ----------------------------------------------------------------------
def attribute_binning(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    method_type: str = "equal_range",
    bin_size: int = 10,
    bin_dtype: str = "numerical",
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """Bucket numeric columns into ``bin_size`` bins.

    equal_range: interior cutoffs at min + j·(max − min)/B from the
    moments kernel's min/max (float64 on the host; all-null columns are
    dropped with a warning); equal_frequency: the 'lower' quantiles at j/B
    (device sort).  Bin ids are 1..B, a value equal to a cutoff going to
    the lower bin, compared against the cutoffs cast to f32.  A masked row
    keeps its mask False and holds the bin of its stored 0.
    ``bin_dtype="categorical"`` gives string labels "<= a", "a-b", "> b"
    (cutoffs rounded to 4 decimals) instead of ids."""
    if method_type not in ("equal_frequency", "equal_range"):
        raise TypeError("Invalid input for method_type")
    if bin_size < 2:
        raise TypeError("Invalid input for bin_size")
    if output_mode not in ("replace", "append"):
        raise TypeError("Invalid input for output_mode")
    cols = _cols_of(idf, "num", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Binning Computation - No numerical column(s) to transform")
        return idf

    if pre_existing_model:
        dfm = load_model_df(model_path, "attribute_binning")
        cut_map = {r["attribute"]: list(r["parameters"]) for _, r in dfm.iterrows()}
        cols = [c for c in cols if c in cut_map]
        cutoffs = np.array([cut_map[c] for c in cols], dtype=np.float64)
    else:
        X, M = idf.numeric_block(cols)
        if method_type == "equal_frequency":
            qs = [j / bin_size for j in range(1, bin_size)]
            cutoffs = masked_quantiles(X, M, qs, interpolation="lower").t().cpu().numpy()
        else:
            mom = masked_moments(X, M)
            lo = mom["min"].cpu().numpy().astype(np.float64)
            hi = mom["max"].cpu().numpy().astype(np.float64)
            keep = ~np.isnan(lo)
            if not keep.all():
                dropped = [c for c, k in zip(cols, keep) if not k]
                warnings.warn("Columns contains too much null values. Dropping " + ", ".join(dropped))
                cols = [c for c, k in zip(cols, keep) if k]
                lo, hi = lo[keep], hi[keep]
            width = (hi - lo) / bin_size
            cutoffs = lo[:, None] + np.arange(1, bin_size)[None, :] * width[:, None]
        if model_path != "NA":
            save_model_df(
                pd.DataFrame({"attribute": cols, "parameters": [list(map(float, c)) for c in cutoffs]}),
                model_path, "attribute_binning")
    if not cols:
        return idf

    X, M = idf.numeric_block(cols)
    nb = cutoffs.shape[1] + 1
    edges = np.concatenate(
        [np.full((len(cols), 1), -np.inf), cutoffs, np.full((len(cols), 1), np.inf)], axis=1)
    bins0 = digitize(X, torch.from_numpy(edges.astype(np.float32)).to(X.device))
    new_cols: "OrderedDict[str, Column]" = OrderedDict()
    for i, c in enumerate(cols):
        mask = idf.columns[c].mask
        if bin_dtype == "numerical":
            new_cols[c] = Column("num", bins0[:, i] + 1, mask, dtype_name="int")
            continue
        cuts = [str(round(float(v), 4)) for v in cutoffs[i]]
        labels = (["<= " + cuts[0]] + [cuts[b - 1] + "-" + cuts[b] for b in range(1, nb - 1)]
                  + ["> " + cuts[-1]])
        new_cols[c] = Column("cat", bins0[:, i], mask, vocab=np.array(labels, dtype=object),
                             dtype_name="string")
    odf = _emit(idf, new_cols, output_mode, "_binned")
    if print_impact:
        from anovos_tpu_torch.data_analyzer.stats_generator import uniqueCount_computation

        out = cols if output_mode == "replace" else [c + "_binned" for c in cols]
        logger.info(uniqueCount_computation(odf, out).to_string(index=False))
    return odf


def monotonic_binning(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    label_col: str = "label",
    event_label=1,
    bin_method: str = "equal_range",
    bin_size: int = 10,
    bin_dtype: str = "numerical",
    output_mode: str = "replace",
) -> Table:
    """Per column, the first bin count n = 20, 19, ..., 3 whose bins' mean
    value and event rate are perfectly monotonic (Spearman ρ = ±1), else
    ``bin_size``; then ``attribute_binning`` with it."""
    from scipy import stats as sps

    cols = _cols_of(idf, "num", list_of_cols, drop_cols, extra_drop=[label_col])
    y, ym = _event_vector(idf, label_col, event_label)
    y64 = y.to(torch.float64)
    odf = idf
    for c in cols:
        chosen = bin_size
        x = idf.columns[c].data.to(torch.float64)
        for n in range(20, 2, -1):
            binned = attribute_binning(idf.select([c]), [c], [], method_type=bin_method, bin_size=n,
                                       output_mode="append")
            bcol = binned[c + "_binned"]
            bm = bcol.mask
            bidx = torch.where(bm, bcol.data - 1, 0).to(torch.int64)
            lab = bm & ym

            def bin_sum(w):
                return torch.bincount(bidx, weights=w, minlength=n)[:n].cpu().numpy()

            cnt = bin_sum(bm.to(torch.float64))
            vals = bin_sum(torch.where(bm, x, 0.0))
            lblcnt = bin_sum(lab.to(torch.float64))
            evs = bin_sum(torch.where(lab, y64, 0.0))
            ok = (cnt > 0) & (lblcnt > 0)
            if ok.sum() < 2:
                continue
            r, _ = sps.spearmanr(vals[ok] / cnt[ok], evs[ok] / lblcnt[ok])
            if abs(r) == 1.0:
                chosen = n
                break
        odf = attribute_binning(odf, [c], [], method_type=bin_method, bin_size=chosen,
                                bin_dtype=bin_dtype, output_mode=output_mode)
    return odf


# ----------------------------------------------------------------------
# categorical encoding
# ----------------------------------------------------------------------
def _event_vector(idf: Table, label_col: str, event_label):
    """(y, mask) of the label column: y = 1.0 where the label is
    ``event_label`` (a categorical label compares its vocabulary with
    ``str(event_label)``, a numeric one compares as f32), else 0.0."""
    if label_col not in idf.columns:
        raise TypeError("Invalid input for Label Column")
    col = idf.columns[label_col]
    if col.kind == "cat":
        hits = np.nonzero(col.vocab == str(event_label))[0]
        code = int(hits[0]) if len(hits) else -2
        y = (col.data == code).to(torch.float32)
    else:
        value = torch.tensor(float(event_label), dtype=torch.float32, device=col.data.device)
        y = (col.data.to(torch.float32) == value).to(torch.float32)
    return y, col.mask


def cat_to_num_transformer(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    method_type: str = "unsupervised",
    encoding: str = "label_encoding",
    label_col=None,
    event_label=None,
    **kwargs,
) -> Table:
    """Dispatcher: "unsupervised" runs ``cat_to_num_unsupervised`` with
    ``encoding``; "supervised" (target encoding) is not ported yet."""
    if method_type == "unsupervised":
        return cat_to_num_unsupervised(idf, list_of_cols, drop_cols, method_type=encoding, **kwargs)
    if method_type == "supervised":
        raise NotImplementedError(
            "cat_to_num_transformer: method_type='supervised' needs cat_to_num_supervised, "
            "which the port does not have yet; see ROADMAP.md")
    raise TypeError("Invalid input for method_type")


def cat_to_num_unsupervised(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    method_type: str = "label_encoding",
    index_order: str = "frequencyDesc",
    cardinality_threshold: int = 50,
    pre_existing_model: bool = False,
    model_path: str = "NA",
    stats_unique: dict = {},
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """Label or one-hot encoding of categorical columns.

    label_encoding: category → index by ``index_order`` (frequencyDesc /
    frequencyAsc, count ties to the lower code; alphabetDesc / alphabetAsc);
    onehot_encoding: ``<col>_<index>`` 0/1 int columns, skipping (with a
    warning) columns of more than ``cardinality_threshold`` categories.
    A category absent from the mapping encodes as null."""
    if method_type not in ("label_encoding", "onehot_encoding"):
        raise TypeError("Invalid input for method_type")
    cols = _cols_of(idf, "cat", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Encoding Computation - No categorical column(s) to transform")
        return idf

    if pre_existing_model:
        dfm = load_model_df(model_path, "cat_to_num_unsupervised", fmt="csv")
        mapping = {c: dict(zip(g["category"].astype(str), g["index"].astype(int)))
                   for c, g in dfm.groupby("attribute")}
    else:
        mapping = {}
        for c in cols:
            col = idf.columns[c]
            vsize = max(len(col.vocab), 1)
            cnts = code_counts(col.data, col.mask, vsize).cpu().numpy()
            if index_order == "frequencyDesc":
                order = np.lexsort((np.arange(vsize), -cnts))
            elif index_order == "frequencyAsc":
                order = np.lexsort((np.arange(vsize), cnts))
            elif index_order == "alphabetDesc":
                order = np.argsort(col.vocab.astype(str))[::-1]
            else:  # alphabetAsc
                order = np.argsort(col.vocab.astype(str))
            mapping[c] = {str(col.vocab[j]): int(i) for i, j in enumerate(order[: len(col.vocab)])}
        if model_path != "NA":
            rows = [{"attribute": c, "category": cat, "index": i}
                    for c, mp in mapping.items() for cat, i in mp.items()]
            save_model_df(pd.DataFrame(rows), model_path, "cat_to_num_unsupervised", fmt="csv")

    new_cols: "OrderedDict[str, Column]" = OrderedDict()
    odf = idf
    for c in cols:
        col = idf.columns[c]
        mp = mapping.get(c, {})
        if method_type == "onehot_encoding" and len(mp) > cardinality_threshold:
            warnings.warn(f"{c} skipped for onehot encoding: cardinality > {cardinality_threshold}")
            continue
        # host code → index table, device gather
        code_map = np.full(max(len(col.vocab), 1), -1, dtype=np.int32)
        for j, v in enumerate(col.vocab):
            code_map[j] = mp.get(str(v), -1)
        idx = torch.where(col.data >= 0, vocab_lookup(code_map, col.data), -1)
        valid = cat_valid_mask(idx, col.mask)
        if method_type == "label_encoding":
            new_cols[c] = Column("num", torch.where(valid, idx, 0), valid, dtype_name="int")
            continue
        for j in range(len(mp)):
            odf = odf.with_column(f"{c}_{j}", Column("num", (idx == j).to(torch.int32), valid,
                                                     dtype_name="int"))
        if output_mode == "replace":
            odf = odf.drop([c])
    if method_type == "label_encoding":
        odf = _emit(idf, new_cols, output_mode, "_index")
    if print_impact:
        logger.info(f"Encoded columns: {cols}")
    return odf
