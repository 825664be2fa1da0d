"""Dataset reading, writing, combination and column operations (counterpart
of ``anovos_tpu/data_ingest/data_ingest.py``).

``read_dataset`` decodes CSV, Parquet, JSON or Avro part files on the host
(pyarrow, pandas, the port's C++ Avro codec), applies whole-dataset schema
inference, each part under the ingest guard (``guard.py``: retry,
quarantine, schema reconciliation, sanitization of ±inf and values beyond
the f32 range), then dictionary-encodes and uploads the columns to the
runtime's device.  ``write_dataset`` writes Spark-style part
files.  ``concatenate_dataset`` and ``join_dataset`` keep the payload on
the device (vocabulary-union code remaps, row gathers); join keys are
matched on the host.  Multi-host ingest is not ported.
"""

from __future__ import annotations

import glob
import gzip
import logging
import os
import shutil
import warnings
from collections import OrderedDict
from typing import List, Optional, Union

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.csv as pacsv
import torch

from anovos_tpu_torch.data_ingest import avro_io, guard
from anovos_tpu_torch.obs import devprof, get_metrics, get_tracer
from anovos_tpu_torch.ops.segment import masked_nunique
from anovos_tpu_torch.shared.native import NativeEncodedStrings
from anovos_tpu_torch.shared.table import Column, Table, host_to_column
from anovos_tpu_torch.shared.utils import pairwise_reduce, parse_cols

logger = logging.getLogger(__name__)

_EXTENSIONS = {"csv": (".csv",), "parquet": (".parquet", ".pq"), "avro": (".avro",),
               "json": (".json", ".json.gz", ".jsonl")}


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


@guard.raw_reader
def _read_one_part(f: str, file_type: str, cfg: dict) -> pd.DataFrame:
    """RAW single-part decode, called only through
    :func:`guard.guarded_part_read`: a decode failure here is the fault
    the guard retries and quarantines."""
    if file_type == "csv":
        delim = str(cfg.get("delimiter", cfg.get("sep", ",")))
        header = str(cfg.get("header", True)).lower() in ("true", "1")
        tbl = pacsv.read_csv(f, read_options=pacsv.ReadOptions(autogenerate_column_names=not header),
                             parse_options=pacsv.ParseOptions(delimiter=delim))
        # pyarrow types undecodable UTF-8 as binary instead of failing:
        # raise the decode error (with its byte offset) so the guard
        # quarantines the part
        bad = [fld.name for fld in tbl.schema
               if pa.types.is_binary(fld.type) or pa.types.is_large_binary(fld.type)]
        if bad:
            for chunk in tbl.column(bad[0]).chunks:
                for v in chunk:
                    b = v.as_py()
                    if b is not None:
                        b.decode("utf-8")
            raise ValueError(f"CSV part {f}: columns {bad} are not valid UTF-8")
        return tbl.to_pandas()
    if file_type == "parquet":
        return pd.read_parquet(f)
    if file_type == "avro":
        dec = avro_io.read_avro(f)
        return pd.DataFrame({k: (v.to_object_array() if isinstance(v, NativeEncodedStrings) else v)
                             for k, v in dec.items()})
    if file_type == "json":
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            return pd.read_json(fh, lines=True)
    raise ValueError(f"unsupported file_type: {file_type}")


def read_host_frame(files: List[str], file_type: str, cfg: dict) -> pd.DataFrame:
    """Host pandas frame from part files, guarded: each part decodes under
    the retry/quarantine policy, schemas reconcile across parts, the
    schema is inferred over all parts, and hostile values are sanitized
    last (``data_ingest/guard.py``)."""
    if file_type not in _EXTENSIONS:
        raise ValueError(f"unsupported file_type: {file_type}")
    pol = guard.policy_from_env()
    frames = []
    for f in files:
        df = guard.guarded_part_read(f, lambda f=f: _read_one_part(f, file_type, cfg),
                                     file_type=file_type, policy=pol)
        if df is not None:
            frames.append((f, df))
    if not frames:
        raise guard.IngestError(
            f"every {file_type} part was quarantined ({len(files)} file(s), first: "
            f"{files[0] if files else '<none>'}) — no schema left to build a frame")
    aligned = guard.reconcile_frames(frames, pol)
    df = aligned[0] if len(aligned) == 1 else pd.concat(aligned, ignore_index=True)
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
    # last, so the columns inference made numeric are sanitized too
    return guard.sanitize_frame(df, pol)


def _coerce_numeric_strings(decoded: dict) -> dict:
    """A codec-decoded string column whose every vocabulary entry parses as
    a number becomes float64, as the JAX package's Avro path does; the
    parse runs over the vocabulary only."""
    out = {}
    for name, arr in decoded.items():
        if isinstance(arr, NativeEncodedStrings) and len(arr.vocab):
            parsed = pd.to_numeric(pd.Series(arr.vocab.astype(str)), errors="coerce")
            if parsed.notna().all():
                lut = parsed.to_numpy(np.float64)
                vals = np.full(len(arr.codes), np.nan)
                valid = arr.codes >= 0
                vals[valid] = lut[arr.codes[valid]]
                out[name] = vals
                continue
        out[name] = arr
    return out


def read_dataset(file_path: str, file_type: str, file_configs: Optional[dict] = None,
                 device=None) -> Table:
    """Read csv, parquet, avro or json part files into a Table on the
    runtime's device.

    ``file_configs``: ``header``, ``delimiter``/``sep``, ``inferSchema``.
    Every part decodes under the ingest guard (a corrupt part is
    quarantined and the read goes on without it).  Multi-file directories
    are concatenated on the host before upload, except avro, whose parts
    each become a Table and are concatenated by name."""
    if file_type not in _EXTENSIONS:
        raise ValueError(f"unsupported file_type: {file_type}")
    cfg = dict(file_configs or {})
    with get_tracer().span("io:read_dataset", cat="io", path=str(file_path), file_type=file_type):
        out = _read_table(file_path, file_type, cfg, device)
    get_metrics().counter("rows_ingested_total", "rows read into device Tables").inc(out.nrows)
    return out


def _read_table(file_path: str, file_type: str, cfg: dict, device) -> Table:
    files = _resolve_files(file_path, file_type)
    out = None
    if file_type == "avro":
        # each part decodes straight to a Table (strings stay dictionary
        # codes); a schema the codec cannot express (an empty decode) takes
        # the pandas route, without the parts the guard set aside
        pol = guard.policy_from_env()
        tables, bad = [], set()
        for f in files:
            decoded = guard.guarded_part_read(f, lambda f=f: avro_io.read_avro(f),
                                              file_type="avro", policy=pol)
            if decoded is None:
                bad.add(f)
                continue
            if not decoded:
                tables = None
                break
            n = len(next(iter(decoded.values())))
            tables.append(Table.from_numpy(_coerce_numeric_strings(decoded), nrows=n, device=device))
        if tables is not None and not tables:
            raise guard.IngestError(
                f"every avro part under {file_path} was quarantined ({len(bad)} part(s)) — "
                "no schema left to build a Table")
        files = [f for f in files if f not in bad]
        if tables:
            out = tables[0] if len(tables) == 1 else concatenate_dataset(*tables, method_type="name")
    if out is None:
        out = Table.from_pandas(read_host_frame(files, file_type, cfg), device=device)
    return out


def write_dataset(
    idf: Table,
    file_path: str,
    file_type: str,
    file_configs: Optional[dict] = None,
    column_order: Optional[List[str]] = None,
) -> None:
    """Write a Table as Spark-style part files ``part-00000.<ext>`` … and
    ``_SUCCESS``.  ``file_configs``: ``repartition`` (number of part
    files), ``mode`` (overwrite, append or error), ``header`` and
    ``delimiter`` (csv)."""
    cfg = dict(file_configs or {})
    mode = cfg.pop("mode", "error")
    repartition = int(cfg.pop("repartition", 1) or 1)
    if column_order:
        idf = idf.select(column_order)
    if os.path.exists(file_path):
        if mode == "overwrite":
            shutil.rmtree(file_path) if os.path.isdir(file_path) else os.remove(file_path)
        elif mode == "error":
            raise FileExistsError(f"{file_path} exists (mode=error)")
    os.makedirs(file_path, exist_ok=True)
    df = idf.to_pandas()
    parts = np.array_split(np.arange(len(df)), max(repartition, 1))
    written = []
    for i, part_idx in enumerate(parts):
        part = df if len(parts) == 1 else df.iloc[part_idx]
        stem = os.path.join(file_path, f"part-{i:05d}")
        written.append(f"{stem}.{file_type}")
        if file_type == "csv":
            header = str(cfg.get("header", True)).lower() in ("true", "1")
            delim = str(cfg.get("delimiter", ","))
            try:
                # pyarrow writes whole-valued floats without ".0", so a
                # null-free integral float column would read back as int:
                # those columns are written as preformatted strings
                part = part.copy(deep=False)
                for c in part.columns:
                    v = part[c].to_numpy()
                    if (v.dtype.kind == "f" and len(v) and not np.isnan(v).any()
                            and np.abs(v).max() < 2**62 and (v == np.trunc(v)).all()):
                        part[c] = np.char.add(v.astype(np.int64).astype(str), ".0").astype(object)
                pacsv.write_csv(pa.Table.from_pandas(part, preserve_index=False), stem + ".csv",
                                write_options=pacsv.WriteOptions(include_header=header,
                                                                 delimiter=delim))
            except pa.ArrowException as e:
                get_metrics().counter(
                    "csv_pandas_fallback_total",
                    "checkpoint CSV parts written by the pandas fallback writer "
                    "(mixed-format directory risk)").inc()
                logger.info("pyarrow CSV writer refused %s (%s: %s); writing it with pandas",
                            stem, type(e).__name__, e)
                part.to_csv(stem + ".csv", index=False, header=header, sep=delim)
        elif file_type == "parquet":
            part.to_parquet(stem + ".parquet", index=False)
        elif file_type == "avro":
            avro_io.write_avro(part, stem + ".avro")
        elif file_type == "json":
            part.to_json(stem + ".json", orient="records", lines=True)
        else:
            raise ValueError(f"unsupported file_type: {file_type}")
    open(os.path.join(file_path, "_SUCCESS"), "w").close()
    reg = get_metrics()
    reg.counter("bytes_written_total", "artifact bytes written to disk"
                ).inc(sum(os.path.getsize(f) for f in written))
    reg.counter("rows_written_total", "rows persisted by write_dataset").inc(len(df))


def _concat_columns(cols: List[Column], name: str) -> Column:
    """One column of a row union.  Categorical: the union vocabulary and
    each part's codes remapped into it.  Numeric: int64/float64 exact
    values stay exact; parts of different dtypes meet in f32."""
    kinds = {c.kind for c in cols}
    if len(kinds) > 1:
        raise TypeError(f"column {name}: mixed kinds {kinds} across concatenated tables")
    kind = kinds.pop()
    dev = cols[0].data.device
    mask = torch.cat([c.mask for c in cols])
    if kind == "cat":
        vocab = np.unique(np.concatenate([c.vocab for c in cols])).astype(object)
        parts = []
        for c in cols:
            remap = torch.as_tensor(np.searchsorted(vocab, c.vocab).astype(np.int32)
                                    if len(c.vocab) else np.zeros(1, np.int32), device=dev)
            parts.append(torch.where(c.data >= 0, remap[torch.clamp(c.data.to(torch.int64), 0,
                                                                     len(remap) - 1)], -1))
        return Column("cat", torch.cat(parts).to(torch.int32), mask, vocab=vocab, dtype_name="string")
    if any(c.is_wide for c in cols):
        if all(c.is_wide_int or c.data.dtype == torch.int32 for c in cols):
            v64 = torch.cat([c.exact if c.is_wide_int else c.data.to(torch.int64) for c in cols])
            v64 = torch.where(mask, v64, 0)
            return Column("num", v64.to(torch.float32), mask, dtype_name="bigint", exact=v64)
        # float-wide, or wide mixed with float parts: float64 semantics
        v = torch.cat([(c.exact if c.is_wide else c.data).to(torch.float64) for c in cols])
        v = torch.where(mask, v, float("nan"))
        # the port concatenates on the device; only this column goes
        # through the host, to take the encoding rules again
        with devprof.transfer_bracket("d2h", v.nbytes, label="data_ingest.concat"):
            v = v.cpu().numpy()
        return host_to_column(v, len(v), dev)
    dtypes = {c.data.dtype for c in cols}
    tgt = torch.float32 if len(dtypes) > 1 else dtypes.pop()
    return Column(kind, torch.cat([c.data.to(tgt) for c in cols]), mask,
                  dtype_name=cols[0].dtype_name)


def concatenate_dataset(*idfs: Table, method_type: str = "name") -> Table:
    """Row union of Tables.  "name": columns follow the first table's names
    and order, each of which every table must have.  "index": by position,
    renamed to the first table's names."""
    if method_type not in ("index", "name"):
        raise TypeError("Invalid input for concatenate_dataset method")
    names = idfs[0].col_names
    aligned = []
    for t in idfs:
        if method_type == "name":
            missing = [c for c in names if c not in t.columns]
            if missing:
                raise ValueError(f"concatenate_dataset: columns {missing} missing")
            aligned.append(t.select(names))
        else:
            if t.ncols != len(names):
                raise ValueError("concatenate_dataset index method: column count mismatch")
            aligned.append(t.rename(dict(zip(t.col_names, names))).select(names))
    cols = OrderedDict((name, _concat_columns([t.columns[name] for t in aligned], name))
                       for name in names)
    return Table(cols, sum(t.nrows for t in aligned))


def _host_keys(t: Table, join_cols: List[str]) -> pd.DataFrame:
    """Join keys as a host frame of decoded values; int64 and float64 keys
    exact."""
    out = {}
    for c in join_cols:
        col = t.columns[c]
        mask = col.mask.cpu().numpy()
        if col.kind == "cat":
            data = col.data.cpu().numpy()
            vals = np.empty(t.nrows, dtype=object)
            valid = mask & (data >= 0)
            vals[valid] = col.vocab[data[valid]]
            vals[~valid] = None
            out[c] = vals
        elif col.is_wide_int:
            out[c] = pd.arrays.IntegerArray(col.exact_host(), ~mask)
        else:
            vals = col.exact_host().astype(np.float64)
            vals[~mask] = np.nan
            out[c] = vals
    return pd.DataFrame(out)


def join_dataset(*idfs: Table, join_cols: Union[str, List[str]], join_type: str) -> Table:
    """Key join of Tables, pairwise: inner, full, left, right, left_semi or
    left_anti.  Keys are matched on the host (a pandas merge of the key
    frames); the payload columns move by row gathers on the device, null
    where an outer join finds no partner."""
    if isinstance(join_cols, str):
        join_cols = [x.strip() for x in join_cols.split("|")]
    all_cols = [c for t in idfs for c in t.col_names]
    nonjoin = [c for c in all_cols if c not in join_cols]
    if len(nonjoin) != len(all_cols) - len(idfs) * len(join_cols):
        raise ValueError("Specified join_cols do not match all the Input Dataframe(s)")
    if len(nonjoin) != len(set(nonjoin)):
        raise ValueError("Duplicate column(s) present in non joining column(s) in Input Dataframe(s)")

    def join2(left: Table, right: Table) -> Table:
        lk = _host_keys(left, join_cols).assign(_li=np.arange(left.nrows))
        rk = _host_keys(right, join_cols).assign(_ri=np.arange(right.nrows))
        how = {"full": "outer", "left_semi": "inner", "left_anti": "left"}.get(join_type, join_type)
        merged = lk.merge(rk, on=join_cols, how=how)
        if join_type == "left_semi":
            return left.gather_rows(np.unique(merged["_li"].to_numpy()))
        if join_type == "left_anti":
            anti = merged[merged["_ri"].isna()]
            return left.gather_rows(np.unique(anti["_li"].to_numpy()).astype(np.int64))
        li, ri = merged["_li"].to_numpy(), merged["_ri"].to_numpy()
        lvalid, rvalid = ~pd.isna(li), ~pd.isna(ri)
        lg = left.gather_rows(np.where(lvalid, li, 0).astype(np.int64), valid=lvalid)
        rg = right.gather_rows(np.where(rvalid, ri, 0).astype(np.int64), valid=rvalid)
        out = OrderedDict()
        for name in left.col_names:
            if name in join_cols:
                # the merged key: the left value, else the right one
                s = merged[name]
                if str(s.dtype) == "Int64":
                    key = s.to_numpy(dtype=np.int64) if not s.isna().any() else s.astype("float64").to_numpy()
                else:
                    key = np.asarray(s.to_numpy())
                out[name] = host_to_column(key, len(merged), left.device)
            else:
                out[name] = lg.columns[name]
        for name in right.col_names:
            if name not in join_cols:
                out[name] = rg.columns[name]
        return Table(out, len(merged))

    return pairwise_reduce(join2, idfs)


def recommend_type(
    idf: Table,
    list_of_cols="all",
    drop_cols=[],
    dynamic_threshold: float = 0.01,
    static_threshold: int = 100,
) -> pd.DataFrame:
    """Form and datatype recommendation from distinct counts: fewer than
    min(static_threshold, rows · dynamic_threshold) distinct values →
    categorical/string, else numerical/double."""
    cols = parse_cols(list_of_cols, idf.col_names, drop_cols)
    if not (0 < dynamic_threshold <= 1):
        raise TypeError("Invalid input for dynamic_threshold: Value need to be between 0 and 1")
    if not cols:
        warnings.warn("No recommend_attributeType analysis - No column(s) to analyze")
        return pd.DataFrame(columns=["attribute", "original_form", "original_dataType",
                                     "recommended_form", "recommended_dataType",
                                     "distinct_value_count"])
    X = torch.stack([idf.columns[c].data.to(torch.float32) for c in cols], 1)
    M = torch.stack([idf.columns[c].mask & (idf.columns[c].data >= 0)
                     if idf.columns[c].kind == "cat" else idf.columns[c].mask for c in cols], 1)
    nu = masked_nunique(X, M).cpu().numpy()
    threshold = min(static_threshold, idf.nrows * dynamic_threshold)
    rows = []
    for c, u in zip(cols, nu):
        col = idf.columns[c]
        r_form = "categorical" if u < threshold else "numerical"
        rows.append({"attribute": c,
                     "original_form": "categorical" if col.kind == "cat" else "numerical",
                     "original_dataType": col.dtype_name,
                     "recommended_form": r_form,
                     "recommended_dataType": "string" if r_form == "categorical" else "double",
                     "distinct_value_count": int(u)})
    return pd.DataFrame(rows)


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
