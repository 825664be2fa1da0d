"""Dataset reading and column operations (counterpart of
``anovos_tpu/data_ingest/data_ingest.py``).

``read_dataset`` decodes CSV or Parquet part files on the host with
pyarrow, applies whole-dataset schema inference and nulls ±inf and values
beyond the f32 range (the JAX package's default ingest policy), then
dictionary-encodes and uploads the columns to the runtime's device.  Avro,
multi-host ingest, the quarantining guard and prefetch are not ported.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import List, Optional

import numpy as np
import pandas as pd
import pyarrow.csv as pacsv
import torch

from anovos_tpu_torch.shared.table import Column, Table, host_to_column
from anovos_tpu_torch.shared.utils import parse_cols

logger = logging.getLogger(__name__)

_EXTENSIONS = {"csv": (".csv",), "parquet": (".parquet", ".pq")}
_F32_MAX = float(np.finfo(np.float32).max)


def _resolve_files(file_path: str, file_type: str) -> List[str]:
    if os.path.isfile(file_path):
        return [file_path]
    if os.path.isdir(file_path):
        exts = _EXTENSIONS.get(file_type, ())
        files = sorted(
            f for f in glob.glob(os.path.join(file_path, "*"))
            if f.endswith(exts) or (os.path.basename(f).startswith("part-")
                                    and not f.endswith((".crc", "_SUCCESS")))
        )
        files = [f for f in files if not os.path.basename(f).startswith((".", "_"))]
        if files:
            return files
    matched = sorted(glob.glob(file_path))
    if matched:
        out = []
        for m in matched:
            out.extend(_resolve_files(m, file_type))
        return out
    raise FileNotFoundError(f"no {file_type} files at {file_path}")


def _read_one_part(f: str, file_type: str, cfg: dict) -> pd.DataFrame:
    if file_type == "csv":
        delim = str(cfg.get("delimiter", cfg.get("sep", ",")))
        header = str(cfg.get("header", True)).lower() in ("true", "1")
        tbl = pacsv.read_csv(f, read_options=pacsv.ReadOptions(autogenerate_column_names=not header),
                             parse_options=pacsv.ParseOptions(delimiter=delim))
        return tbl.to_pandas()
    return pd.read_parquet(f)


def read_host_frame(files: List[str], file_type: str, cfg: dict) -> pd.DataFrame:
    """Host pandas frame from part files, schema-inferred over all parts."""
    frames = [_read_one_part(f, file_type, cfg) for f in files]
    df = frames[0] if len(frames) == 1 else pd.concat(frames, ignore_index=True)
    if str(cfg.get("inferSchema", True)).lower() in ("true", "1", "none"):
        # a string column whose every non-null value parses as a number is
        # numeric; an all-null column is a numeric NaN column
        for c in df.columns:
            if df[c].dtype == object or str(df[c].dtype) in ("string", "str"):
                nonnull = df[c].notna()
                if nonnull.any():
                    head = df[c][nonnull].iloc[:1024]
                    if pd.to_numeric(head, errors="coerce").isna().any():
                        continue
                    coerced = pd.to_numeric(df[c], errors="coerce")
                    if coerced[nonnull].notna().all():
                        df[c] = coerced
                else:
                    df[c] = pd.to_numeric(df[c], errors="coerce")
    for c in df.columns:
        if df[c].dtype.kind == "f":
            vals = df[c].to_numpy()
            bad = np.isinf(vals) | (np.isfinite(vals) & (np.abs(vals) > _F32_MAX))
            if bad.any():
                df[c] = np.where(bad, np.nan, vals)
    return df


def read_dataset(file_path: str, file_type: str, file_configs: Optional[dict] = None,
                 device=None) -> Table:
    """Read csv/parquet part files into a Table on the runtime's device.

    ``file_configs``: ``header``, ``delimiter``/``sep``, ``inferSchema``.
    Multi-file directories are concatenated on the host before upload."""
    if file_type not in _EXTENSIONS:
        raise NotImplementedError(
            f"read_dataset: file_type={file_type!r} is not ported yet (csv and parquet are); "
            "see ROADMAP.md")
    cfg = dict(file_configs or {})
    df = read_host_frame(_resolve_files(file_path, file_type), file_type, cfg)
    return Table.from_pandas(df, device=device)


def delete_column(idf: Table, list_of_cols, print_impact: bool = False) -> Table:
    odf = idf.drop(parse_cols(list_of_cols, idf.col_names))
    if print_impact:
        logger.info(f"Before: \nNo. of Columns-  {idf.ncols} \n {idf.col_names}")
        logger.info(f"After: \nNo. of Columns-  {odf.ncols} \n {odf.col_names}")
    return odf


def select_column(idf: Table, list_of_cols, print_impact: bool = False) -> Table:
    odf = idf.select(parse_cols(list_of_cols, idf.col_names))
    if print_impact:
        logger.info(f"Before: \nNo. of Columns-  {idf.ncols} \n {idf.col_names}")
        logger.info(f"After: \nNo. of Columns-  {odf.ncols} \n {odf.col_names}")
    return odf


def rename_column(idf: Table, list_of_cols, list_of_newcols, print_impact: bool = False) -> Table:
    if isinstance(list_of_cols, str):
        list_of_cols = [x.strip() for x in list_of_cols.split("|")]
    if isinstance(list_of_newcols, str):
        list_of_newcols = [x.strip() for x in list_of_newcols.split("|")]
    odf = idf.rename(dict(zip(list_of_cols, list_of_newcols)))
    if print_impact:
        logger.info(f"Before: \nNo. of Columns-  {idf.ncols} \n {idf.col_names}")
        logger.info(f"After: \nNo. of Columns-  {odf.ncols} \n {odf.col_names}")
    return odf


_NUM_TARGETS = {"int", "integer", "bigint", "long", "float", "double", "decimal", "smallint"}
_INT_TARGETS = ("int", "integer", "bigint", "long", "smallint")


def _recast_numeric(idf: Table, col: Column, dt: str) -> Column:
    """One column cast to a numeric dtype name."""
    name = dt if dt != "integer" else "int"
    tgt = torch.int32 if dt in _INT_TARGETS else torch.float32
    dev = col.data.device
    if col.kind == "cat":
        # parse the vocab once on the host, gather through it on the device
        parsed = np.full(len(col.vocab) + 1, np.nan, dtype=np.float64)
        for i, v in enumerate(col.vocab):
            try:
                parsed[i] = float(v)
            except (TypeError, ValueError):
                pass
        pv = torch.as_tensor(parsed, dtype=torch.float32, device=dev)
        vals = pv[torch.clamp(col.data.to(torch.int64), 0, len(col.vocab))]
        ok = col.mask & (col.data >= 0) & ~torch.isnan(vals)
        return Column("num", torch.where(ok, vals, 0.0).to(tgt), ok, dtype_name=name)
    if col.is_wide_int:
        if dt in ("bigint", "long"):
            return col  # already exact int64
        if tgt == torch.float32:
            return Column("num", col.data, col.mask, dtype_name=dt)
        v = col.exact_host()
        return host_to_column(np.clip(v, np.iinfo(np.int32).min, np.iinfo(np.int32).max),
                              idf.nrows, dev)
    if col.is_wide and dt in ("double", "float64"):
        return Column("num", col.data, col.mask, dtype_name="double", exact=col.exact)
    if col.is_wide and tgt == torch.int32:
        # truncate the exact double, not its f32 approximation
        v = np.trunc(np.nan_to_num(col.exact_host(), nan=0.0))
        if dt in ("int", "integer", "smallint"):
            v = np.clip(v, np.iinfo(np.int32).min, np.iinfo(np.int32).max)
        else:
            v = np.clip(v, -(2.0 ** 63), 2.0 ** 63 - 1024)
        new = host_to_column(v.astype(np.int64), idf.nrows, dev)
        return Column(new.kind, new.data, new.mask & col.mask, dtype_name=name, exact=new.exact)
    return Column("num", col.data.to(tgt), col.mask, dtype_name=name)


def recast_column(idf: Table, list_of_cols, list_of_dtypes, print_impact: bool = False) -> Table:
    """Cast columns: num↔num changes the storage dtype, cat→num parses the
    vocab, num→string re-encodes to a dictionary, → timestamp parses."""
    if isinstance(list_of_cols, str):
        list_of_cols = [x.strip() for x in list_of_cols.split("|")]
    if isinstance(list_of_dtypes, str):
        list_of_dtypes = [x.strip() for x in list_of_dtypes.split("|")]
    odf = idf
    for name, dt in zip(list_of_cols, list_of_dtypes):
        dt = dt.strip().lower()
        col = idf.columns[name]
        dev = col.data.device
        if dt in _NUM_TARGETS:
            new = _recast_numeric(idf, col, dt)
        elif dt == "string":
            if col.kind == "cat":
                new = col
            else:
                host = col.exact_host()
                mask = col.mask.cpu().numpy()
                vals = np.empty(idf.nrows, dtype=object)
                if np.issubdtype(host.dtype, np.integer):
                    vals[:] = [str(int(v)) for v in host]
                else:
                    vals[:] = [repr(float(v)) for v in host]
                vals[~mask] = None
                new = host_to_column(vals, idf.nrows, dev)
        elif dt == "timestamp":
            host = col.data.cpu().numpy()
            mask = col.mask.cpu().numpy()
            if col.kind == "cat":
                vals = np.empty(idf.nrows, dtype=object)
                valid = mask & (host >= 0)
                vals[valid] = col.vocab[host[valid]]
                ts = pd.to_datetime(pd.Series(vals), errors="coerce")
            else:
                ts = pd.to_datetime(pd.Series(host.astype("int64"), dtype="int64"), unit="s",
                                    errors="coerce")
                ts[~mask] = pd.NaT
            new = host_to_column(ts.to_numpy(), idf.nrows, dev)
        else:
            raise ValueError(f"unsupported recast dtype: {dt}")
        odf = odf.with_column(name, new)
    if print_impact:
        logger.info(f"Before:  {idf.dtypes()}")
        logger.info(f"After:  {odf.dtypes()}")
    return odf
