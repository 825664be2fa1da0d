"""Column transformers (counterpart of ``anovos_tpu/data_transformer/
transformers.py``): binning, label/one-hot and target encoding, the three
scalers, ``imputation_MMM``, the elementwise math ops, the boxcox λ
search, rare-category clubbing, ``expression_parser`` and the serving
state contract (``fitted_state`` / ``from_state``).  The model-based
imputers and the latent features live in sibling modules and are
re-exported here, as the runner dispatches by ``getattr`` on this module.

Model artifacts use the JAX package's layouts, so either package applies
the other's model: ``<model_path>/attribute_binning/part-00000.parquet``
[attribute, parameters = interior cutoffs],
``cat_to_num_unsupervised/part-00000.csv`` [attribute, category, index],
``cat_to_num_supervised/<col>/part-00000.csv`` [<col>, <col>_encoded],
``z_standardization`` [attribute, mean, stddev], ``IQR_standardization``
[attribute, median, iqr], ``normalization`` [attribute, min, max] (parquet),
``outlier_categories/part-00000.csv`` [attribute, parameters] and
``imputation_MMM/part-00000.parquet`` [attribute, kind, fill_value (str)].
"""

from __future__ import annotations

import ast
import logging
import os
import re
import tempfile
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_ingest.data_ingest import read_dataset
from anovos_tpu_torch.data_transformer.model_io import load_model_df, save_model_df
from anovos_tpu_torch.ops.histogram import digitize
from anovos_tpu_torch.ops.quantiles import masked_quantiles
from anovos_tpu_torch.ops.reductions import masked_moments
from anovos_tpu_torch.ops.segment import cat_valid_mask, code_counts, code_label_counts, vocab_lookup
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
    ``encoding``, "supervised" runs ``cat_to_num_supervised`` (target
    encoding) with ``label_col`` and ``event_label``."""
    if method_type == "unsupervised":
        return cat_to_num_unsupervised(idf, list_of_cols, drop_cols, method_type=encoding, **kwargs)
    if method_type == "supervised":
        return cat_to_num_supervised(idf, list_of_cols, drop_cols, label_col=label_col,
                                     event_label=event_label, **kwargs)
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


def cat_to_num_supervised(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    label_col: str = "label",
    event_label=1,
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    print_impact: bool = False,
    **_ignored,
) -> Table:
    """Target encoding: each category → its event rate P(event | category)
    rounded to 4 decimals; a category with no labelled row encodes as null.

    The rates are computed as the JAX package computes them: f32 event and
    row counts, f32 division, ``np.round`` in f32, so the CSV models of the
    two packages are equal.  The apply path (``pre_existing_model``) needs
    no label column.  Model artifact: one CSV per column,
    ``cat_to_num_supervised/<col>`` [<col>, <col>_encoded]."""
    cols = _cols_of(idf, "cat", list_of_cols, drop_cols, extra_drop=[label_col])
    if not cols:
        warnings.warn("No Categorical Encoding - No categorical column(s) to transform")
        return idf
    y = ym = None
    if not pre_existing_model:
        y, ym = _event_vector(idf, label_col, event_label)
    new_cols: "OrderedDict[str, Column]" = OrderedDict()
    model_rows: Dict[str, pd.DataFrame] = {}
    for c in cols:
        col = idf.columns[c]
        vsize = max(len(col.vocab), 1)
        if pre_existing_model:
            dfm = load_model_df(model_path, f"cat_to_num_supervised/{c}", fmt="csv")
            rate_map = dict(zip(dfm[c].astype(str), dfm[c + "_encoded"].astype(float)))
            rates = np.array([rate_map.get(str(v), np.nan) for v in col.vocab], dtype=np.float32)
        else:
            m_eff = col.mask & ym
            tot = code_counts(col.data, m_eff, vsize).cpu().numpy()
            ev = code_label_counts(col.data, m_eff, y, vsize).cpu().numpy().astype(np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                rates = np.round(ev / np.maximum(tot, 1e-30), 4).astype(np.float32)
            rates[tot == 0] = np.nan
            model_rows[c] = pd.DataFrame({c: [str(v) for v in col.vocab],
                                          c + "_encoded": rates.astype(np.float64)})
        known = ~np.isnan(rates) if len(rates) else np.zeros(1, bool)
        ok = cat_valid_mask(col.data, col.mask) & vocab_lookup(known, col.data)
        enc = torch.where(ok, vocab_lookup(np.nan_to_num(rates, nan=0.0), col.data), 0.0)
        new_cols[c] = Column("num", enc.to(torch.float32), ok, dtype_name="double")
    if not pre_existing_model and model_path != "NA":
        for c, dfm in model_rows.items():
            save_model_df(dfm, model_path, f"cat_to_num_supervised/{c}", fmt="csv")
    odf = _emit(idf, new_cols, output_mode, "_encoded")
    if print_impact:
        logger.info(f"Target-encoded columns: {cols}")
    return odf


# ----------------------------------------------------------------------
# rescaling
# ----------------------------------------------------------------------
def _scaler_params(idf: Table, cols, pre_existing_model: bool, model_path: str, name: str,
                   fields: Sequence[str], fit):
    """(cols, a, b): the two f32 parameter vectors of a scaler, read from
    its parquet model [attribute, *fields] or fitted by ``fit(X, M)`` (and
    then saved when ``model_path`` is set)."""
    if pre_existing_model:
        dfm = load_model_df(model_path, name).set_index("attribute")
        cols = [c for c in cols if c in dfm.index]
        return cols, dfm.loc[cols, fields[0]].to_numpy(np.float32), dfm.loc[cols, fields[1]].to_numpy(np.float32)
    X, M = idf.numeric_block(cols)
    a, b = fit(X, M)
    if model_path != "NA":
        save_model_df(pd.DataFrame({"attribute": cols, fields[0]: a.astype(float), fields[1]: b.astype(float)}),
                      model_path, name)
    return cols, a, b


def _affine_apply(idf: Table, cols, center: np.ndarray, scale: np.ndarray, keep: np.ndarray,
                  warning: str, output_mode: str, postfix: str) -> Table:
    """(x − center) / scale in f32 on the columns ``keep`` selects; the
    others are skipped with ``warning`` + their names."""
    skipped = [c for c, k in zip(cols, keep) if not k]
    if skipped:
        warnings.warn(warning + ",".join(skipped))
    cols = [c for c, k in zip(cols, keep) if k]
    if not cols:
        return idf
    X, _ = idf.numeric_block(cols)
    dev = X.device
    Z = (X - torch.from_numpy(center[keep]).to(dev)[None, :]) / torch.from_numpy(scale[keep]).to(dev)[None, :]
    new_cols = OrderedDict((c, Column("num", Z[:, i], idf.columns[c].mask, dtype_name="double"))
                           for i, c in enumerate(cols))
    return _emit(idf, new_cols, output_mode, postfix)


def z_standardization(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """(x − μ) / σ with μ and the sample σ from the moments kernel;
    zero-σ (and all-null) columns are skipped with a warning.  Model
    artifact: parquet [attribute, mean, stddev]."""
    cols = _cols_of(idf, "num", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Standardization Computation - No numerical column(s) to transform")
        return idf

    def fit(X, M):
        mom = masked_moments(X, M)
        return mom["mean"].cpu().numpy().astype(np.float32), mom["stddev"].cpu().numpy().astype(np.float32)

    cols, mean, std = _scaler_params(idf, cols, pre_existing_model, model_path, "z_standardization",
                                     ("mean", "stddev"), fit)
    keep = (std > 0) & ~np.isnan(std)
    odf = _affine_apply(idf, cols, mean, std, keep,
                        "Following columns are dropped from standardization due to zero stddev: ",
                        output_mode, "_scaled")
    if print_impact:
        logger.info(f"z-standardized: {[c for c, k in zip(cols, keep) if k]}")
    return odf


def IQR_standardization(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """(x − median) / (Q3 − Q1) from the exact 'lower' quantiles 0.25, 0.5
    and 0.75; zero-IQR columns are skipped with a warning.  Model artifact:
    parquet [attribute, median, iqr]."""
    cols = _cols_of(idf, "num", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Standardization Computation - No numerical column(s) to transform")
        return idf

    def fit(X, M):
        q = masked_quantiles(X, M, [0.25, 0.5, 0.75], interpolation="lower").cpu().numpy()
        return q[1].astype(np.float32), (q[2] - q[0]).astype(np.float32)

    cols, med, iqr = _scaler_params(idf, cols, pre_existing_model, model_path, "IQR_standardization",
                                    ("median", "iqr"), fit)
    keep = (iqr > 0) & ~np.isnan(iqr)
    odf = _affine_apply(idf, cols, med, iqr, keep,
                        "Following columns are dropped from standardization due to zero IQR: ",
                        output_mode, "_scaled")
    if print_impact:
        logger.info(f"IQR-standardized: {[c for c, k in zip(cols, keep) if k]}")
    return odf


def normalization(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """Min-max scaling to [0, 1] with min/max from the moments kernel;
    zero-range (and all-null) columns are skipped with a warning.  Model
    artifact: parquet [attribute, min, max]."""
    cols = _cols_of(idf, "num", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Normalization Computation - No numerical column(s) to transform")
        return idf

    def fit(X, M):
        mom = masked_moments(X, M)
        return mom["min"].cpu().numpy().astype(np.float32), mom["max"].cpu().numpy().astype(np.float32)

    cols, lo, hi = _scaler_params(idf, cols, pre_existing_model, model_path, "normalization",
                                  ("min", "max"), fit)
    keep = (hi > lo) & ~np.isnan(lo)
    odf = _affine_apply(idf, cols, lo, hi - lo, keep,
                        "Following columns dropped from normalization due to zero range: ",
                        output_mode, "_normalized")
    if print_impact:
        logger.info(f"normalized: {[c for c, k in zip(cols, keep) if k]}")
    return odf


# ----------------------------------------------------------------------
# elementwise math / boxcox
# ----------------------------------------------------------------------
def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root: torch has no ``cbrt``; sign(x)·|x|^(1/3) is within
    a few f32 ulps of it."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_MATH_OPS = {
    "ln": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "exp": torch.exp,
    "powOf2": lambda x: torch.pow(2.0, x),
    "powOf10": lambda x: torch.pow(10.0, x),
    "sqrt": torch.sqrt,
    "cbrt": _cbrt,
    "sq": lambda x: x ** 2,
    "cb": lambda x: x ** 3,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "radians": torch.deg2rad,
    "factorial": lambda x: torch.exp(torch.lgamma(x + 1.0)),
    "mul_inv": lambda x: 1.0 / x,
    "floor": torch.floor,
    "ceil": torch.ceil,
}
_MATH_OPS_N = {
    "powOfN": lambda x, N: torch.pow(float(N), x),
    "toPowerN": lambda x, N: x ** float(N),
    # floored modulo (the divisor's sign), as Python's and jnp's %
    "remainderDivByN": lambda x, N: torch.remainder(x, float(N)),
    # half to even at N decimals, as jnp.round
    "roundN": lambda x, N: torch.round(x, decimals=int(N)),
}


def feature_transformation(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    method_type: str = "sqrt",
    N=None,
    boolean_drop: bool = False,
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """One of 25 elementwise math ops on f32 values.  A non-finite result
    (log of a value ≤ 0, sqrt of a negative, 1/0 ...) becomes a null
    (mask False, value 0).  ``append`` names the column
    ``<col>_<method_type>`` (``<col>_<method_type minus its N><N>`` for
    the ops that take N)."""
    cols = _cols_of(idf, "num", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Transformation Computation - No numerical column(s) to transform")
        return idf
    if method_type in _MATH_OPS_N:
        if N is None:
            raise TypeError(f"N required for method_type {method_type}")
        fn = lambda x: _MATH_OPS_N[method_type](x, N)  # noqa: E731
        postfix = "_" + method_type[:-1] + str(N)
    elif method_type in _MATH_OPS:
        fn = _MATH_OPS[method_type]
        postfix = "_" + method_type
    else:
        raise TypeError("Invalid input for method_type")
    X, M = idf.numeric_block(cols)
    Y = fn(X)
    ok = M & torch.isfinite(Y)
    Y = torch.where(ok, Y, 0.0).to(torch.float32)
    new_cols = OrderedDict((c, Column("num", Y[:, i], ok[:, i], dtype_name="double"))
                           for i, c in enumerate(cols))
    odf = _emit(idf, new_cols, output_mode, postfix)
    if print_impact:
        logger.info(f"{method_type} applied to {cols}")
    return odf


_BOXCOX_LAMBDAS = [1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 0.25, -0.25, 3.0, -3.0, 4.0, -4.0, 5.0, -5.0, 0.0]


def _ks_vs_normal(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Per column of (rows, k) X/M, the KS statistic of the standardized
    valid values (sample σ) against N(0, 1): the largest gap between the
    normal CDF and the empirical CDF on either side of each sorted value."""
    Xc, Mc = X.t(), M.t()  # (k, rows): each column sorts as one contiguous row
    n = Mc.sum(dim=1).to(torch.float32)
    n1 = torch.clamp_min(n, 1.0)
    mean = torch.where(Mc, Xc, 0.0).sum(dim=1) / n1
    d = torch.where(Mc, Xc - mean[:, None], 0.0)
    std = torch.sqrt((d * d).sum(dim=1) / torch.clamp_min(n - 1.0, 1.0))
    Z = torch.where(Mc, (Xc - mean[:, None]) / torch.clamp_min(std, 1e-30)[:, None], float("inf"))
    Zs = torch.sort(Z, dim=1).values
    rows = X.shape[0]
    pos = torch.arange(1, rows + 1, dtype=torch.float32, device=X.device)[None, :]
    cdf = torch.special.ndtr(Zs)
    dev = torch.maximum(torch.abs(cdf - pos / n1[:, None]), torch.abs(cdf - (pos - 1.0) / n1[:, None]))
    valid = torch.arange(rows, device=X.device)[None, :] < n[:, None]
    return torch.where(valid, dev, 0.0).amax(dim=1)


def _boxcox_power(X: torch.Tensor, lam) -> torch.Tensor:
    """ln x at λ = 0, else sign(x)·|x|^λ; ``lam`` a float or a (k,) row."""
    if isinstance(lam, torch.Tensor):
        return torch.where(lam == 0.0, torch.log(X), torch.sign(X) * torch.pow(torch.abs(X), lam))
    return torch.log(X) if lam == 0.0 else torch.sign(X) * torch.pow(torch.abs(X), lam)


def _boxcox_fit_lambdas(X: torch.Tensor, M: torch.Tensor, ncols: int) -> np.ndarray:
    """Per column, the λ of ``_BOXCOX_LAMBDAS`` whose transform (scored on
    its finite values) is closest to a normal by KS; the first λ wins a
    tie."""
    best_ks = np.full(ncols, np.inf)
    lam = np.ones(ncols)
    for lmb in _BOXCOX_LAMBDAS:
        Y = _boxcox_power(X, lmb)
        ok = M & torch.isfinite(Y)
        ks = _ks_vs_normal(torch.where(ok, Y, 0.0), ok).cpu().numpy()[:ncols]
        better = ks < best_ks
        lam = np.where(better, lmb, lam)
        best_ks = np.where(better, ks, best_ks)
    return lam


def boxcox_transformation(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    boxcox_lambda=None,
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """Power transform each column with ``boxcox_lambda`` (one value or one
    per column) or, when it is None, with the λ of the grid closest to a
    normal by KS; λ = 0 is ln x.  Non-finite results become nulls."""
    cols = _cols_of(idf, "num", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Transformation Computation - No numerical column(s) to transform")
        return idf
    X, M = idf.numeric_block(cols)
    if boxcox_lambda is not None:
        if isinstance(boxcox_lambda, (int, float)):
            lam = np.full(len(cols), float(boxcox_lambda))
        else:
            lam = np.array([float(v) for v in boxcox_lambda])
    else:
        lam = _boxcox_fit_lambdas(X, M, len(cols))
    Y = _boxcox_power(X, torch.from_numpy(lam.astype(np.float32)).to(X.device)[None, :])
    ok = M & torch.isfinite(Y)
    Y = torch.where(ok, Y, 0.0).to(torch.float32)
    new_cols = OrderedDict((c, Column("num", Y[:, i], ok[:, i], dtype_name="double"))
                           for i, c in enumerate(cols))
    odf = _emit(idf, new_cols, output_mode, "_bxcx")
    if print_impact:
        logger.info(f"boxcox lambdas: {dict(zip(cols, lam.tolist()))}")
    return odf


# ----------------------------------------------------------------------
# categorical outliers + expressions
# ----------------------------------------------------------------------
def outlier_categories(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    coverage: float = 1.0,
    max_category: int = 50,
    pre_existing_model: bool = False,
    model_path: str = "NA",
    output_mode: str = "replace",
    print_impact: bool = False,
) -> Table:
    """Club rare categories into ``outlier_categories``: per column keep the
    most frequent categories (count ties to the lower code) until their
    cumulative share reaches ``coverage``, at most ``max_category − 1`` of
    them; the new vocabulary is the kept set plus "outlier_categories",
    sorted.  Model artifact: CSV [attribute, parameters = a kept value]."""
    cols = _cols_of(idf, "cat", list_of_cols, drop_cols)
    if not cols:
        warnings.warn("No Outlier Categories Computation - No categorical column(s) to transform")
        return idf
    keep_map: Dict[str, List[str]] = {}
    if pre_existing_model:
        dfm = load_model_df(model_path, "outlier_categories", fmt="csv")
        for c, g in dfm.groupby("attribute"):
            keep_map[c] = list(g["parameters"].astype(str))
    else:
        for c in cols:
            col = idf.columns[c]
            vsize = max(len(col.vocab), 1)
            cnts = code_counts(col.data, col.mask, vsize).cpu().numpy()
            order = np.lexsort((np.arange(vsize), -cnts))
            sorted_cnts = cnts[order]
            cumu = np.cumsum(sorted_cnts / max(sorted_cnts.sum(), 1))
            lag = np.concatenate([[0.0], cumu[:-1]])
            sel = ~((cumu >= coverage) & (lag >= coverage))
            sel &= np.arange(vsize) <= (max_category - 2)
            sel &= sorted_cnts > 0
            keep_map[c] = [str(col.vocab[j]) for j, s in zip(order, sel) if s]
        if model_path != "NA":
            rows = [{"attribute": c, "parameters": v} for c, vs in keep_map.items() for v in vs]
            save_model_df(pd.DataFrame(rows), model_path, "outlier_categories", fmt="csv")
    new_cols: "OrderedDict[str, Column]" = OrderedDict()
    for c in cols:
        col = idf.columns[c]
        new_vocab = np.array(sorted(set(keep_map.get(c, [])) | {"outlier_categories"}), dtype=object)
        lk = {v: i for i, v in enumerate(new_vocab)}
        out_code = lk["outlier_categories"]
        code_map = np.array([lk.get(str(v), out_code) for v in col.vocab] or [out_code], dtype=np.int32)
        data = torch.where(col.data >= 0, vocab_lookup(code_map, col.data), -1).to(torch.int32)
        new_cols[c] = Column("cat", data, col.mask, vocab=new_vocab, dtype_name="string")
    odf = _emit(idf, new_cols, output_mode, "_outliered")
    if print_impact:
        logger.info({c: len(v) for c, v in keep_map.items()})
    return odf


def _tensor_fn(fn, device):
    """``fn`` taking tensors, called with Python numbers turned into f32
    tensors on ``device`` (jnp functions take both)."""
    def call(*args):
        return fn(*[a if isinstance(a, torch.Tensor) else torch.tensor(float(a), device=device)
                    for a in args])
    return call


_EXPR_FUNCS = {
    "log": torch.log,
    "ln": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "exp": torch.exp,
    "sqrt": torch.sqrt,
    "cbrt": _cbrt,
    "abs": torch.abs,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,
    "pow": torch.pow,
    "sign": torch.sign,
    "greatest": torch.maximum,
    "least": torch.minimum,
}


def _validate_expr_ast(src: str, allowed_names) -> None:
    """AST whitelist of ``expression_parser``: arithmetic, comparisons,
    elementwise & | ^ ~, conditional expressions, calls of the whitelisted
    functions by name, numeric constants up to 1e12 and known identifiers.
    Attribute access, keyword arguments, containers, comprehensions,
    lambdas, ``and``/``or`` and constant-only powers (a bignum bomb Python
    would evaluate before any tensor op) raise ValueError."""
    tree = ast.parse(src, mode="eval")
    ok_nodes = (
        ast.Expression, ast.BinOp, ast.UnaryOp, ast.Compare, ast.IfExp,
        ast.Call, ast.Name, ast.Constant, ast.Load,
        ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
        ast.BitAnd, ast.BitOr, ast.BitXor, ast.Invert,
        ast.USub, ast.UAdd, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq,
    )
    for node in ast.walk(tree):
        if not isinstance(node, ok_nodes):
            raise ValueError(f"disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) or node.func.id not in _EXPR_FUNCS:
                raise ValueError("only whitelisted functions may be called")
            if node.keywords:
                raise ValueError("keyword arguments are not allowed")
        if isinstance(node, ast.Name) and node.id not in allowed_names:
            raise ValueError(f"unknown identifier: {node.id}")
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, (int, float, bool)):
                raise ValueError("only numeric constants are allowed")
            if abs(float(node.value)) > 1e12:
                raise ValueError("constant magnitude too large")
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
            if not any(isinstance(x, ast.Name) for x in ast.walk(node)):
                raise ValueError("constant-only exponentiation is not allowed")


def expression_parser(idf: Table, list_of_expr, postfix: str = "", print_impact: bool = False) -> Table:
    """New f32 columns from expressions over the table's columns (a list, or
    one string split at "|"), each named ``expr + postfix``.  Column names,
    special characters included, are matched longest first and replaced by
    safe identifiers; the expression is checked by ``_validate_expr_ast``
    and evaluated with the whitelisted functions only.  A row is null where
    any referenced column is null or the value is not finite."""
    if isinstance(list_of_expr, str):
        list_of_expr = [e.strip() for e in list_of_expr.split("|")]
    dev = idf.device
    funcs = {k: _tensor_fn(f, dev) for k, f in _EXPR_FUNCS.items()}
    odf = idf
    for expr in list_of_expr:
        sub = expr
        namespace: Dict[str, torch.Tensor] = {}
        mask = torch.ones(idf.nrows, dtype=torch.bool, device=dev)
        for name in sorted(idf.col_names, key=len, reverse=True):
            pat = r"(?<![\w])" + re.escape(name) + r"(?![\w])"
            if re.search(pat, sub):
                san = "_c" + str(abs(hash(name)) % 10**8)
                sub = re.sub(pat, san, sub)
                col = idf.columns[name]
                namespace[san] = col.data.to(torch.float32)
                mask = mask & col.mask
        try:
            _validate_expr_ast(sub, set(_EXPR_FUNCS) | set(namespace))
            val = eval(sub, {"__builtins__": {}}, {**funcs, **namespace})  # noqa: S307 (AST-checked)
            val = torch.as_tensor(val, device=dev).to(torch.float32)
        except Exception as e:
            raise ValueError(f"expression_parser: cannot evaluate {expr!r}: {e}")
        if val.ndim == 0:
            val = val.expand(idf.nrows)
        mask = mask & torch.isfinite(val)
        odf = odf.with_column(expr + postfix, Column("num", torch.where(mask, val, 0.0), mask,
                                                     dtype_name="double"))
    if print_impact:
        logger.info(f"expressions added: {list_of_expr}")
    return odf


# ----------------------------------------------------------------------
# serving state: fitted_state() / from_state()
# ----------------------------------------------------------------------
# A fitted transformer's apply-time state as a JSON-able document.  The
# state is the model artifact the batch function persists, lifted verbatim;
# from_state applies through the batch function's pre_existing_model
# branch over that artifact materialized back, so a served apply and a
# batch re-apply run the same code.  The layout is the JAX package's.

SERVABLE_TRANSFORMERS = (
    "attribute_binning",
    "z_standardization",
    "IQR_standardization",
    "normalization",
    "imputation_MMM",
    "cat_to_num_unsupervised",
    "cat_to_num_supervised",
    "outlier_categories",
    "boxcox_transformation",
    "feature_transformation",
)

# the model format each family persists (None: stateless, or exported
# directly)
_STATE_MODEL_FMT = {
    "attribute_binning": "parquet",
    "z_standardization": "parquet",
    "IQR_standardization": "parquet",
    "normalization": "parquet",
    "imputation_MMM": "parquet",
    "cat_to_num_unsupervised": "csv",
    "cat_to_num_supervised": "csv",
    "outlier_categories": "csv",
    "boxcox_transformation": None,
    "feature_transformation": None,
}

# the config keys the apply path reads; the rest is fit-time material
_STATE_APPLY_KEYS = {
    "attribute_binning": ("bin_dtype", "output_mode"),
    "z_standardization": ("output_mode",),
    "IQR_standardization": ("output_mode",),
    "normalization": ("output_mode",),
    "imputation_MMM": ("method_type", "output_mode"),
    "cat_to_num_unsupervised": ("method_type", "cardinality_threshold", "output_mode"),
    "cat_to_num_supervised": ("label_col", "output_mode"),
    "outlier_categories": ("output_mode",),
    "boxcox_transformation": ("output_mode",),
    "feature_transformation": ("method_type", "N", "output_mode"),
}

STATE_VERSION = 1


def _jsonable(v):
    """numpy values → Python values, recursively, so a state json.dumps
    cleanly and its floats round-trip bit for bit."""
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.ndarray):
        return [_jsonable(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def _read_model_tables(model_dir: str, fmt: str) -> Dict[str, dict]:
    """Every model table under ``model_dir`` as a columnar JSON-able dict,
    keyed by its directory relative to ``model_dir``; CSVs read as strings
    (as ``load_model_df`` reads them)."""
    tables: Dict[str, dict] = {}
    for dirpath, _dirs, files in sorted(os.walk(model_dir)):
        parts = sorted(f for f in files if f.endswith("." + fmt))
        if not parts:
            continue
        frames = [pd.read_parquet(os.path.join(dirpath, f)) if fmt == "parquet"
                  else pd.read_csv(os.path.join(dirpath, f), dtype=str) for f in parts]
        df = pd.concat(frames, ignore_index=True)
        rel = os.path.relpath(dirpath, model_dir).replace(os.sep, "/")
        tables[rel] = {c: _jsonable(df[c].tolist()) for c in df.columns}
    return tables


def fitted_state(idf: Table, name: str, config: Optional[dict] = None) -> dict:
    """Fit transformer ``name`` on ``idf`` under ``config`` and return its
    apply-time state: {state_version, family, apply_config, cols, model}.
    The fit runs through the batch function, persisting its model into a
    temporary directory that is lifted into ``model``."""
    if name not in SERVABLE_TRANSFORMERS:
        raise ValueError(f"{name!r} is not a servable transformer (one of {SERVABLE_TRANSFORMERS})")
    config = dict(config or {})
    config.pop("pre_existing_model", None)
    config.pop("model_path", None)
    config.setdefault("print_impact", False)
    apply_config = {k: config[k] for k in _STATE_APPLY_KEYS[name] if k in config}
    state = {"state_version": STATE_VERSION, "family": name, "apply_config": _jsonable(apply_config)}
    list_of_cols = config.get("list_of_cols", "all")
    drop_cols = config.get("drop_cols", [])

    if name == "feature_transformation":
        state["cols"] = _cols_of(idf, "num", list_of_cols, drop_cols)
        state["model"] = None
        return state
    if name == "boxcox_transformation":
        cols = _cols_of(idf, "num", list_of_cols, drop_cols)
        given = config.get("boxcox_lambda")
        if given is not None:
            lam = (np.full(len(cols), float(given)) if isinstance(given, (int, float))
                   else np.array([float(v) for v in given]))
        else:
            X, M = idf.numeric_block(cols)
            lam = _boxcox_fit_lambdas(X, M, len(cols))
        state["cols"] = cols
        state["model"] = {"fmt": None, "tables": {
            "boxcox_lambda": {"attribute": cols, "lambda": [float(v) for v in lam]}}}
        return state

    fmt = _STATE_MODEL_FMT[name]
    with tempfile.TemporaryDirectory(prefix="anovos_fitstate_") as mp:
        globals()[name](idf, **{**config, "model_path": mp})
        tables = _read_model_tables(mp, fmt)
    if not tables:
        raise ValueError(f"{name} fitted no state on this table (no applicable columns?)")
    state["model"] = {"fmt": fmt, "tables": tables}
    if name == "cat_to_num_supervised":
        # one model directory a column: the fit's column order
        state["cols"] = _cols_of(idf, "cat", list_of_cols, drop_cols,
                                 extra_drop=[config.get("label_col", "label")])
    else:
        cols = list(dict.fromkeys(tables[name]["attribute"]))
        if name == "imputation_MMM":
            # the model holds the numeric fills first; apply in the table's
            # order, as the fit did
            in_table = [c for c in idf.col_names if c in set(cols)]
            cols = in_table + [c for c in cols if c not in set(in_table)]
        state["cols"] = cols
    return state


class FittedTransformer:
    """One transformer's apply-only form, rebuilt from a ``fitted_state``
    document: ``apply`` runs the batch function's pre_existing_model branch
    over the model materialized once, at construction."""

    def __init__(self, state: dict):
        if state.get("state_version") != STATE_VERSION:
            raise ValueError(f"fitted_state version {state.get('state_version')!r} != "
                             f"supported {STATE_VERSION}")
        self.family: str = state["family"]
        if self.family not in SERVABLE_TRANSFORMERS:
            raise ValueError(f"unknown transformer family {self.family!r}")
        self.cols: List[str] = list(state["cols"])
        self.apply_config: dict = dict(state.get("apply_config") or {})
        self._lambdas: Optional[List[float]] = None
        self._model_tmp = None
        model = state.get("model")
        if self.family == "boxcox_transformation":
            tab = model["tables"]["boxcox_lambda"]
            by_col = dict(zip(tab["attribute"], tab["lambda"]))
            self._lambdas = [float(by_col[c]) for c in self.cols]
        elif model is not None:
            self._model_tmp = tempfile.TemporaryDirectory(prefix=f"anovos_serve_{self.family}_")
            for rel, columns in model["tables"].items():
                save_model_df(pd.DataFrame(dict(columns)), self._model_tmp.name, rel, fmt=model["fmt"])

    @property
    def model_dir(self) -> Optional[str]:
        return self._model_tmp.name if self._model_tmp is not None else None

    def apply(self, idf: Table) -> Table:
        cfg = self.apply_config
        out_mode = cfg.get("output_mode", "replace")
        if self.family == "feature_transformation":
            return feature_transformation(idf, self.cols, method_type=cfg.get("method_type", "sqrt"),
                                          N=cfg.get("N"), output_mode=out_mode)
        if self.family == "boxcox_transformation":
            return boxcox_transformation(idf, self.cols, boxcox_lambda=self._lambdas, output_mode=out_mode)
        kwargs = {"pre_existing_model": True, "model_path": self.model_dir, "output_mode": out_mode}
        if self.family == "attribute_binning":
            kwargs["bin_dtype"] = cfg.get("bin_dtype", "numerical")
        elif self.family == "imputation_MMM":
            kwargs["method_type"] = cfg.get("method_type", "median")
        elif self.family == "cat_to_num_unsupervised":
            kwargs["method_type"] = cfg.get("method_type", "label_encoding")
            if "cardinality_threshold" in cfg:
                kwargs["cardinality_threshold"] = cfg["cardinality_threshold"]
        elif self.family == "cat_to_num_supervised":
            kwargs["label_col"] = cfg.get("label_col", "label")
        return globals()[self.family](idf, self.cols, **kwargs)


def from_state(state: dict) -> FittedTransformer:
    """The apply-only transformer of a ``fitted_state`` document."""
    return FittedTransformer(state)


# the model-based imputers and the latent features live in sibling modules
# but belong to this namespace, which the runner reads by getattr
from anovos_tpu_torch.data_transformer.imputers import (  # noqa: E402
    auto_imputation,
    imputation_matrixFactorization,
    imputation_sklearn,
)
from anovos_tpu_torch.data_transformer.latent_features import (  # noqa: E402
    PCA_latentFeatures,
    autoencoder_latentFeatures,
)
