"""Timestamp auto-detection (counterpart of ``anovos_tpu/data_ingest/
ts_auto_detection.py``).

Candidate columns are triaged by kind and value length ({4, 6, 8, 10, 13},
``ts_loop_cols_pre``), then parsed with the format battery: each DISTINCT
value is parsed once on the host, and a lookup table indexed by the codes
(or by the distinct values' inverse index, for an epoch int column) maps
every row on the device.  Detection stats are written to
``ts_cols_stats.csv``.  The battery below is the JAX package's, copied.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.ops.segment import vocab_lookup
from anovos_tpu_torch.shared.table import Column, Table
from anovos_tpu_torch.shared.utils import ends_with

logger = logging.getLogger(__name__)

_VALID_LENGTHS = {4, 6, 8, 10, 13}
_MIN_PARSE_FRACTION = 0.8

# ---------------------------------------------------------------------------
# format-detection battery (the reference's regex pattern matrix,
# ts_auto_detection.py:95-260, recast as detect-then-parse: each family is a
# full-match regex + explicit strptime format(s); the family that parses the
# LARGEST fraction of distinct values wins, which also resolves the
# dd/mm-vs-mm/dd ambiguity the reference fixes by always assuming day-first)
_Y = r"(?:19[4-9]\d|20[0-3]\d)"  # 1940-2039 (reference year window)
_y = r"\d\d"
_m = r"(?:1[012]|0?[1-9])"
_d = r"(?:3[01]|[12]\d|0?[1-9])"
_H = r"(?:2[0-4]|[01]?\d)"
_MS = r"[0-5]\d"
_B = (
    r"(?:JAN(?:UARY)?|FEB(?:RUARY)?|MAR(?:CH)?|APR(?:IL)?|MAY|JUNE?|JULY?|"
    r"AUG(?:UST)?|SEP(?:T(?:EMBER)?)?|OCT(?:OBER)?|NOV(?:EMBER)?|DEC(?:EMBER)?)"
)
_TH = r"(?:ST|ND|RD|TH)?"
_TIME = rf"(?:[T ]{_H}:{_MS}(?::{_MS}(?:\.\d+)?)?(?: ?(?:Z|UTC|GMT|[+-]\d{{2}}:?\d{{2}}))?)?"
_SEP = r"[/\.\- ]"

# (name, fullmatch regex, strptime formats to try in order, kwargs)
_FORMAT_MATRIX = [
    ("epoch_s", r"\d{10}", None, {"unit": "s"}),
    ("epoch_ms", r"\d{13}", None, {"unit": "ms"}),
    ("YYYYmmdd", r"(?:19[4-9]\d|20[0-3]\d)(?:1[012]|0[1-9])(?:3[01]|[12]\d|0[1-9])",
     ["%Y%m%d"], {}),
    ("yymmdd", r"\d\d(?:1[012]|0[1-9])(?:3[01]|[12]\d|0[1-9])", ["%y%m%d"], {}),
    ("YYYY", _Y, ["%Y"], {}),
    ("iso", rf"{_Y}-{_m}-{_d}{_TIME}", None, {"iso": True}),
    ("YYYY_mm_dd", rf"{_Y}{_SEP}{_m}{_SEP}{_d}{_TIME}", ["%Y/%m/%d", "%Y.%m.%d", "%Y %m %d"], {}),
    ("dd_mm_YYYY", rf"{_d}{_SEP}{_m}{_SEP}{_Y}{_TIME}", None, {"dayfirst": True}),
    ("mm_dd_YYYY", rf"{_m}{_SEP}{_d}{_SEP}{_Y}{_TIME}", None, {"dayfirst": False}),
    ("dd_mm_yy", rf"{_d}{_SEP}{_m}{_SEP}{_y}", None, {"dayfirst": True}),
    ("mm_dd_yy", rf"{_m}{_SEP}{_d}{_SEP}{_y}", None, {"dayfirst": False}),
    ("dd_mmm_YYYY", rf"{_d}{_TH} ?{_SEP}? ?{_B} ?{_SEP}? ?,? ?'?{_Y}{_TIME}", None, {"dayfirst": True}),
    ("dd_mmm_yy", rf"{_d}{_TH} ?{_SEP}? ?{_B} ?{_SEP}? ?,? ?'?{_y}", None, {"dayfirst": True}),
    ("mmm_dd_YYYY", rf"{_B} ?{_SEP}? ?{_d}{_TH} ?,? ?{_Y}{_TIME}", None, {"dayfirst": False}),
    ("mmm_YYYY", rf"{_B} ?{_SEP} ?{_Y}", None, {"dayfirst": False}),
    ("YYYY_mmm_dd", rf"{_Y} ?{_SEP}? ?{_B} ?{_SEP}? ?{_d}{_TH}", None, {"yearfirst": True}),
]
_COMPILED_MATRIX = [
    (name, re.compile(rx, re.IGNORECASE), fmts, kw) for name, rx, fmts, kw in _FORMAT_MATRIX
]


def _parse_family(s: pd.Series, fmts, kw) -> pd.Series:
    if kw.get("unit"):
        return pd.to_datetime(pd.to_numeric(s, errors="coerce"), unit=kw["unit"], errors="coerce")
    if kw.get("iso"):
        try:
            parsed = pd.to_datetime(s, errors="coerce", utc=True)
            return parsed.dt.tz_localize(None)
        except (ValueError, TypeError):
            return pd.to_datetime(pd.Series([None] * len(s)))
    if fmts:
        best = None
        for f in fmts:
            p = pd.to_datetime(s, format=f, errors="coerce")
            if best is None or p.notna().sum() > best.notna().sum():
                best = p
        return best
    try:  # dateutil path with explicit day-/year-first disambiguation
        parsed = pd.to_datetime(
            s, errors="coerce", dayfirst=kw.get("dayfirst", False),
            yearfirst=kw.get("yearfirst", False), format="mixed", utc=True,
        )
        return parsed.dt.tz_localize(None)
    except (ValueError, TypeError):
        return pd.to_datetime(pd.Series([None] * len(s)))


def _try_parse_values(values: np.ndarray, counts: Optional[np.ndarray] = None,
                      sample: Optional[np.ndarray] = None) -> Tuple[Optional[pd.Series], float, str]:
    """Parse distinct values to timestamps via the format matrix.
    Returns (parsed series aligned to input, fraction parsed, family).

    ``counts`` (rows of each value) weights the fraction, and ``sample``
    (default: the first 500 values) is what the families are scored on, so
    that the distinct values of a column give the fraction and the family
    that all its rows in row order would."""
    s = pd.Series(values.astype(str)).str.strip()
    sample = (s.iloc[: min(len(s), 500)] if sample is None
              else pd.Series(np.asarray(sample).astype(str)).str.strip())

    def parsed_fraction(parsed: pd.Series) -> float:
        if counts is None:
            return float(parsed.notna().mean())
        return float((parsed.notna().to_numpy() * counts).sum() / counts.sum())

    scored = []
    for name, rx, fmts, kw in _COMPILED_MATRIX:
        frac = sample.str.fullmatch(rx).mean()
        if frac >= _MIN_PARSE_FRACTION:
            scored.append((frac, name, fmts, kw))
    scored.sort(reverse=True, key=lambda t: t[0])
    best: Optional[pd.Series] = None
    best_frac, best_name = 0.0, ""
    for _, name, fmts, kw in scored[:4]:  # ambiguous families: parse-off
        parsed = _parse_family(s, fmts, kw)
        frac = parsed_fraction(parsed)
        if frac > best_frac:
            best, best_frac, best_name = parsed, frac, name
        if frac == 1.0:
            break
    if best is not None and best_frac >= _MIN_PARSE_FRACTION:
        return best, best_frac, best_name
    # fallback: pandas' own mixed inference (covers free-form strings like
    # "Tue Apr 03 18:00:09 +0000 2012")
    with pd.option_context("mode.chained_assignment", None):
        try:
            parsed = pd.to_datetime(s, errors="coerce", format="mixed")
            if parsed.dtype == object:  # mixed tz offsets → parse as UTC
                raise ValueError("mixed offsets")
        except (ValueError, TypeError):
            try:
                parsed = pd.to_datetime(s, errors="coerce", format="mixed", utc=True).dt.tz_localize(None)
            except (ValueError, TypeError):
                return None, 0.0, ""
    if getattr(parsed.dtype, "tz", None) is not None:
        parsed = parsed.dt.tz_localize(None)
    return parsed, parsed_fraction(parsed), "inferred"


def ts_loop_cols_pre(idf: Table, id_col: Optional[str] = None) -> List[str]:
    """Candidate triage: string columns whose values look date-length-ish,
    plus int columns whose first 1,000 valid values are epoch seconds
    (1e9 .. 2e9)."""
    candidates = []
    for c, col in idf.columns.items():
        if c == id_col or col.kind == "ts":
            continue
        if col.kind == "cat":
            vocab = col.vocab
            if len(vocab) == 0:
                continue
            lengths = {len(str(v)) for v in vocab[: min(len(vocab), 1000)]}
            if lengths & _VALID_LENGTHS or any(
                re.search(r"\d{4}-\d{2}-\d{2}", str(v)) for v in vocab[:50]
            ):
                candidates.append(c)
                continue
            # generic probe: a small vocab sample that pandas parses cleanly
            # (e.g. "Tue Apr 03 18:00:09 +0000 2012")
            sample = pd.Series([str(v) for v in vocab[:20]])
            if sample.str.len().min() >= 8 and sample.str.contains(r"\d").all():
                try:
                    parsed = pd.to_datetime(sample, errors="coerce", format="mixed", utc=True)
                    if parsed.notna().mean() > 0.9:
                        candidates.append(c)
                except (ValueError, TypeError):
                    pass
        elif col.kind == "num" and col.dtype_name in ("int", "bigint", "long"):
            head = min(idf.nrows, 1000)
            vals = col.data[:head].cpu().numpy()[col.mask[:head].cpu().numpy()]
            if len(vals) and np.all((vals >= 1e9) & (vals < 2e9)):
                candidates.append(c)
    return candidates


def _epoch_lut(parsed: pd.Series) -> Tuple[np.ndarray, np.ndarray]:
    """Parsed distinct values → (int32 epoch seconds, parsed) host tables
    (seconds through datetime64[s]: pandas' unit depends on the parse
    path; seconds past 2038 wrap as int32, as in the JAX package)."""
    epoch = parsed.to_numpy().astype("datetime64[s]").astype("int64")
    valid = parsed.notna().to_numpy(copy=True)
    return np.where(valid, epoch, 0).astype(np.int32), valid


def regex_date_time_parser(idf: Table, col: str) -> Tuple[Optional[Column], float, str]:
    """Parse one candidate column through its distinct values: a cat
    column's dictionary, or an int column's distinct values (found on the
    device); the rows are mapped on the device."""
    c = idf.columns[col]
    if c.kind == "cat":
        parsed, frac, fam = _try_parse_values(c.vocab) if len(c.vocab) else (None, 0.0, "")
        if parsed is None or frac < _MIN_PARSE_FRACTION:
            return None, frac, fam
        secs_h, valid_h = _epoch_lut(parsed)
        ok = c.mask & (c.data >= 0) & vocab_lookup(valid_h, c.data)
        secs = torch.where(ok, vocab_lookup(secs_h, c.data), 0)
        return Column("ts", secs, ok, dtype_name="timestamp"), frac, fam
    vals = c.data[c.mask]
    distinct, inverse, counts = torch.unique(vals, return_inverse=True, return_counts=True)
    parsed, frac, fam = _try_parse_values(distinct.cpu().numpy(), counts.cpu().numpy(),
                                          sample=vals[:500].cpu().numpy())
    if parsed is None or frac < _MIN_PARSE_FRACTION:
        return None, frac, fam
    secs_h, valid_h = _epoch_lut(parsed)
    secs = torch.zeros_like(c.data, dtype=torch.int32)
    ok = torch.zeros_like(c.mask)
    secs[c.mask] = torch.where(vocab_lookup(valid_h, inverse), vocab_lookup(secs_h, inverse), 0)
    ok[c.mask] = vocab_lookup(valid_h, inverse)
    return Column("ts", secs, ok, dtype_name="timestamp"), frac, fam


def ts_preprocess(
    idf: Table,
    id_col: Optional[str] = None,
    output_path: str = ".",
    tz_offset: str = "local",
    run_type: str = "local",
    mlflow_config=None,
    auth_key: str = "NA",
    **_ignored,
) -> Table:
    """Detect and convert timestamp columns; write ``ts_cols_stats.csv``."""
    odf = idf
    rows = []
    for c in ts_loop_cols_pre(idf, id_col):
        try:
            new_col, frac, fam = regex_date_time_parser(idf, c)
        except Exception:  # detection must never break the pipeline
            logger.exception("timestamp detection failed on column %s; left as it is", c)
            new_col, frac, fam = None, 0.0, ""
        rows.append({
            "attribute": c,
            "parsed_fraction": round(frac, 4),
            "format_family": fam,
            "status": "converted" if new_col is not None else "skipped",
        })
        if new_col is not None:
            odf = odf.with_column(c, new_col)
    if output_path and output_path != "NA":
        Path(output_path).mkdir(parents=True, exist_ok=True)
        pd.DataFrame(
            rows, columns=["attribute", "parsed_fraction", "format_family", "status"]
        ).to_csv(ends_with(output_path) + "ts_cols_stats.csv", index=False)
    return odf
