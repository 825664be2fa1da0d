"""Guarded ingest: corruption-tolerant, quarantining part-file reads
(counterpart of ``anovos_tpu/data_ingest/guard.py``).

Every part-file decode of ``read_dataset`` and of the streaming passes
runs under four independent layers:

* **retry** — a failed part read re-executes up to ``ANOVOS_INGEST_RETRIES``
  times with the resilience policy's deterministic-jitter backoff;
* **quarantine** — a part that stays unreadable is set aside instead of
  ending the run: the failure (file, error class, byte offset where
  known, rows lost) is recorded in ``obs/quarantine_manifest.json``
  (synchronous tmp+rename), booked as ``quarantined_parts_total`` /
  ``quarantine_rows_lost_total`` metrics and in the flight recorder's
  ring, and entered in the degradation registry as ``ingest/<file>``.  ``ANOVOS_INGEST_ON_CORRUPT=raise``
  restores fail-fast;
* **schema-drift reconciliation** — part files that disagree on schema
  are aligned to the first part's: missing columns null-filled, extra
  ones dropped, numeric dtypes widened, numeric-vs-string conflicts
  coerced.  ``ANOVOS_INGEST_SCHEMA_DRIFT=strict`` raises instead;
* **value sanitization** — ±inf and finite values beyond the f32 range
  are nulled (default), clipped (``=clip``) or kept (``=keep``), with
  per-column counters.

The knobs are read at call time.  The chaos harness injects I/O faults
at the guarded read sites (``corrupt@io:<glob>``, ``truncate@io:...``,
``slowread@io:...:secs=S``; ``resilience/chaos.py``).  Raw decode
functions carry the :func:`raw_reader` mark and are called only through
:func:`guarded_part_read`.  On clean, schema-uniform data every layer is
a no-op.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)

__all__ = [
    "IngestError",
    "IngestPolicy",
    "QuarantineRecord",
    "policy_from_env",
    "raw_reader",
    "guarded_part_read",
    "reconcile_frames",
    "sanitize_frame",
    "quarantine",
    "records",
    "summary",
    "configure",
    "reset",
    "manifest_path",
    "estimate_rows",
]

QUARANTINE_MANIFEST = "quarantine_manifest.json"

# the device numeric plane is float32: any finite float64 beyond this
# magnitude becomes ±inf on upload — the overflow class sanitization stops
_F32_MAX = float(np.finfo(np.float32).max)


class IngestError(RuntimeError):
    """A part-file read failure the guard could not absorb (retries
    exhausted under ``on_corrupt=raise``, or every part of a dataset
    quarantined — there is no schema left to build a Table from)."""


@dataclasses.dataclass(frozen=True)
class IngestPolicy:
    """What the guard does at each of its four layers.

    Defaults come from the environment knobs (``policy_from_env``);
    tests and embedding applications may pass explicit instances."""

    retries: int = 1                 # re-reads after the first failed attempt
    on_corrupt: str = "quarantine"   # quarantine | raise
    schema_drift: str = "reconcile"  # reconcile | strict
    sanitize: str = "mask"           # mask | clip | keep
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0

    def __post_init__(self):
        if self.on_corrupt not in ("quarantine", "raise"):
            raise ValueError(f"on_corrupt must be quarantine|raise, got {self.on_corrupt!r}")
        if self.schema_drift not in ("reconcile", "strict"):
            raise ValueError(
                f"schema_drift must be reconcile|strict, got {self.schema_drift!r}")
        if self.sanitize not in ("mask", "clip", "keep"):
            raise ValueError(f"sanitize must be mask|clip|keep, got {self.sanitize!r}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")


def policy_from_env() -> IngestPolicy:
    """The run's ingest policy, read from the environment at call time:
    ``ANOVOS_INGEST_RETRIES`` (default 1), ``ANOVOS_INGEST_ON_CORRUPT``
    (quarantine), ``ANOVOS_INGEST_SCHEMA_DRIFT`` (reconcile) and
    ``ANOVOS_INGEST_SANITIZE`` (mask)."""
    return IngestPolicy(
        retries=int(os.environ.get("ANOVOS_INGEST_RETRIES", "1") or 1),
        on_corrupt=os.environ.get("ANOVOS_INGEST_ON_CORRUPT", "quarantine") or "quarantine",
        schema_drift=os.environ.get("ANOVOS_INGEST_SCHEMA_DRIFT", "reconcile") or "reconcile",
        sanitize=os.environ.get("ANOVOS_INGEST_SANITIZE", "mask") or "mask",
    )


def raw_reader(fn: Callable) -> Callable:
    """Marks ``fn`` as a designated RAW decode function, to be invoked
    only through :func:`guarded_part_read`."""
    fn.__anovos_raw_reader__ = True
    return fn


# ----------------------------------------------------------------------
# quarantine registry (per-run, thread-safe, crash-safe manifest)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One part set aside: everything the postmortem needs to find it."""

    file: str
    error_class: str
    error: str
    stage: str                       # read | schema | stream
    rows_lost: Optional[int]         # None when genuinely unknowable
    rows_estimated: bool             # True when rows_lost is a line-count guess
    byte_offset: Optional[int]       # known for e.g. UnicodeDecodeError

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


_LOCK = threading.Lock()
_RECORDS: List[QuarantineRecord] = []
_MANIFEST_DIR: Optional[str] = None
_JOURNAL = None  # the run's WAL journal, when one exists (set_journal)


def reset() -> None:
    """Per-run reset (workflow.main): records, destination and journal
    cleared."""
    global _MANIFEST_DIR, _JOURNAL
    with _LOCK:
        _RECORDS.clear()
        _MANIFEST_DIR = None
        _JOURNAL = None


def set_journal(journal) -> None:
    """Attach a journal (``cache.journal.RunJournal``): each quarantine
    then also appends a ``part_quarantined`` event."""
    global _JOURNAL
    with _LOCK:
        _JOURNAL = journal


def configure(obs_dir: str) -> None:
    """Point the quarantine manifest at this run's ``obs/`` subtree.  Any
    records quarantined BEFORE the destination was known (ingest runs
    before the workflow resolves its output paths) are flushed now."""
    global _MANIFEST_DIR
    with _LOCK:
        _MANIFEST_DIR = obs_dir
        pending = bool(_RECORDS)
    if pending:
        _write_manifest()


def manifest_path() -> Optional[str]:
    with _LOCK:
        if _MANIFEST_DIR is None:
            return None
        return os.path.join(_MANIFEST_DIR, QUARANTINE_MANIFEST)


def records() -> List[QuarantineRecord]:
    with _LOCK:
        return list(_RECORDS)


def summary() -> dict:
    """The quarantine manifest's content: exact part names and row
    counts, and their totals."""
    with _LOCK:
        recs = list(_RECORDS)
    rows = [r.rows_lost for r in recs if r.rows_lost is not None]
    return {
        "parts": len(recs),
        "rows_lost": int(sum(rows)) if rows else 0,
        "rows_unknown_parts": sum(1 for r in recs if r.rows_lost is None),
        "records": [r.to_json() for r in recs],
    }


def _write_manifest() -> None:
    """Synchronous tmp+rename dump: the quarantine record must survive a
    crash immediately after the event."""
    path = manifest_path()
    if path is None:
        return
    doc = summary()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _byte_offset_of(exc: BaseException) -> Optional[int]:
    """A byte offset for the record, where the exception chain exposes
    one (UnicodeDecodeError carries the exact failing byte)."""
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, UnicodeDecodeError):
            return int(cur.start)
        cur = cur.__cause__ or cur.__context__
    return None


def estimate_rows(path: str, file_type: str) -> Tuple[Optional[int], bool]:
    """(rows lost, estimated?) for a quarantined part — best effort.

    Parquet metadata gives the exact count when the footer survives (the
    chaos-injected corruption case: the file itself is intact); line-
    oriented formats fall back to a newline count (estimated).  A part
    too damaged to measure reports ``(None, False)`` — the manifest says
    "unknown" rather than guessing."""
    try:
        if file_type == "parquet":
            import pyarrow.parquet as pq

            return int(pq.read_metadata(path).num_rows), False
        if file_type in ("csv", "json"):
            import gzip

            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                lines = sum(chunk.count(b"\n") for chunk in iter(lambda: f.read(1 << 20), b""))
            # CSV parts carry a header line; JSONL does not
            return max(lines - (1 if file_type == "csv" else 0), 0), True
    except Exception:
        pass
    return None, False


def quarantine(path: str, exc: BaseException, file_type: str = "",
               stage: str = "read",
               rows_lost: Optional[int] = None) -> QuarantineRecord:
    """Set one part aside: record + manifest + metrics + degradation
    registry.  Returns the record (callers drop the part and continue)."""
    if rows_lost is None:
        rows_lost, estimated = estimate_rows(path, file_type)
    else:
        estimated = False
    rec = QuarantineRecord(
        file=os.path.abspath(path),
        error_class=type(exc).__name__,
        error=str(exc)[:500],
        stage=stage,
        rows_lost=rows_lost,
        rows_estimated=estimated,
        byte_offset=_byte_offset_of(exc),
    )
    with _LOCK:
        # one record per part: a file that fails at several stages (schema
        # probe, then the data pass) is still ONE quarantined part — the
        # manifest's parts/rows accounting must stay exact
        for prior in _RECORDS:
            if prior.file == rec.file:
                return prior
        _RECORDS.append(rec)
    logger.error(
        "QUARANTINED part %s (%s: %s) — %s row(s) lost; the run continues "
        "without it", path, rec.error_class, rec.error,
        "unknown" if rows_lost is None else rows_lost)
    try:
        from anovos_tpu_torch.obs import flight, get_metrics

        reg = get_metrics()
        reg.counter(
            "quarantined_parts_total",
            "part files set aside by the ingest guard instead of killing the run",
        ).inc(stage=stage)
        if rows_lost:
            reg.counter(
                "quarantine_rows_lost_total",
                "data rows lost to quarantined parts",
            ).inc(rows_lost)
        flight.record("quarantine", file=os.path.basename(path),
                      error_class=rec.error_class, rows_lost=rows_lost)
        journal = _JOURNAL
        if journal is not None:
            journal.append("part_quarantined", file=os.path.basename(path),
                           error_class=rec.error_class, stage=stage,
                           rows_lost=rows_lost)
    except Exception:  # telemetry must never turn a survivable fault fatal
        logger.exception("quarantine telemetry failed for %s", path)
    try:
        from anovos_tpu_torch.resilience.policy import record_degraded

        lost = "unknown" if rows_lost is None else str(rows_lost)
        record_degraded(
            f"ingest/{os.path.basename(path)}",
            f"part quarantined ({rec.error_class}): {lost} row(s) lost")
    except Exception:
        logger.exception("degradation registry unavailable for %s", path)
    _write_manifest()
    return rec


# ----------------------------------------------------------------------
# the guarded read
# ----------------------------------------------------------------------
def guarded_part_read(path: str, reader: Callable[[], "object"],
                      file_type: str = "", stage: str = "read",
                      policy: Optional[IngestPolicy] = None):
    """Run one raw part decode under the guard.

    Each attempt passes the ``io:<path>`` chaos site first (where the
    harness injects ``corrupt``/``truncate``/``slowread`` faults), then
    calls ``reader()``.  A failure retries with the resilience package's
    deterministic-jitter backoff; exhaustion quarantines (returns
    ``None``) or raises :class:`IngestError` per policy."""
    from anovos_tpu_torch.resilience.chaos import chaos_point
    from anovos_tpu_torch.resilience.policy import ErrorPolicy, backoff_delay

    pol = policy or policy_from_env()
    bpol = ErrorPolicy(mode="retry", retries=pol.retries,
                       on_exhausted="continue",
                       backoff_base_s=pol.backoff_base_s,
                       backoff_cap_s=pol.backoff_cap_s)
    last: Optional[BaseException] = None
    for attempt in range(pol.retries + 1):
        try:
            chaos_point(f"io:{path}")
            return reader()
        except Exception as e:
            last = e
            if attempt < pol.retries:
                delay = backoff_delay(os.path.basename(path), attempt + 1, bpol)
                logger.warning(
                    "part read failed (%s: %s) at %s — retry %d/%d in %.2fs",
                    type(e).__name__, e, path, attempt + 1, pol.retries, delay)
                try:
                    from anovos_tpu_torch.obs import get_metrics

                    get_metrics().counter(
                        "ingest_retries_total",
                        "guarded part-read re-executions after a failed attempt",
                    ).inc()
                except Exception:
                    pass
                time.sleep(delay)
    if pol.on_corrupt == "raise":
        raise IngestError(
            f"part read failed after {pol.retries + 1} attempt(s): {path} "
            f"({type(last).__name__}: {last})") from last
    quarantine(path, last, file_type=file_type, stage=stage)
    return None


# ----------------------------------------------------------------------
# schema-drift reconciliation
# ----------------------------------------------------------------------
def reconcile_frames(frames: Sequence[Tuple[str, pd.DataFrame]],
                     policy: Optional[IngestPolicy] = None) -> List[pd.DataFrame]:
    """Align every part frame to the FIRST part's schema.

    * identical schemas (the overwhelmingly common case): returned as-is,
      zero-copy — clean-input byte parity rides on this short-circuit;
    * a column missing from a later part: null-filled (NaN → mask=False
      on device) and counted;
    * a column a later part has that the reference does not: dropped with
      a warning and counted;
    * numeric dtype disagreement (int part vs float part): left for
      ``pd.concat``'s widening promotion, counted;
    * numeric reference vs object part: coerced ``to_numeric`` with the
      unparseable values nulled and counted;
    * string reference vs numeric part: stringified toward the reference
      schema and counted (a zero-padded code like ``"00501"`` is
      unrecoverable from ``501`` — the values drifted, not just the
      dtype — but a uniformly string-typed column keeps downstream
      vocab building deterministic).

    ``schema_drift=strict`` raises :class:`IngestError` on the first
    mismatch instead (the legacy crash-on-drift behavior)."""
    pol = policy or policy_from_env()
    if not frames:
        return []
    ref_path, ref = frames[0]
    ref_cols = list(ref.columns)
    ref_isnum = {c: pd.api.types.is_numeric_dtype(ref[c]) for c in ref_cols}
    out = [ref]
    counter = None

    def _count(kind: str, n: int = 1):
        nonlocal counter
        if counter is None:
            try:
                from anovos_tpu_torch.obs import get_metrics

                counter = get_metrics().counter(
                    "ingest_schema_drift_total",
                    "schema-drift repairs applied while reconciling part files")
            except Exception:
                counter = False
        if counter:
            counter.inc(n, kind=kind)

    for path, df in frames[1:]:
        if list(df.columns) == ref_cols and all(
                df[c].dtype == ref[c].dtype for c in ref_cols):
            out.append(df)
            continue
        missing = [c for c in ref_cols if c not in df.columns]
        extra = [c for c in df.columns if c not in ref_cols]
        widened = [
            c for c in ref_cols
            if c in df.columns and df[c].dtype != ref[c].dtype
            and ref_isnum[c] and pd.api.types.is_numeric_dtype(df[c])
        ]
        retyped = [
            c for c in ref_cols
            if c in df.columns
            and ref_isnum[c] != pd.api.types.is_numeric_dtype(df[c])
        ]
        if pol.schema_drift == "strict":
            raise IngestError(
                f"schema drift at {path} (strict mode): missing={missing} "
                f"extra={extra} widened={widened} retyped={retyped}")
        if extra:
            logger.warning(
                "schema drift at %s: dropping %d column(s) absent from the "
                "reference part %s: %s", path, len(extra), ref_path, extra)
            _count("extra_col", len(extra))
            df = df.drop(columns=extra)
        if missing:
            logger.warning(
                "schema drift at %s: null-filling %d missing column(s): %s",
                path, len(missing), missing)
            _count("missing_col", len(missing))
            df = df.copy(deep=False)
            for c in missing:
                df[c] = None if not ref_isnum[c] else np.nan
        if widened:
            _count("widened", len(widened))  # pd.concat promotes int→float
        for c in ref_cols:
            if ref_isnum[c] and df[c].dtype == object:
                coerced = pd.to_numeric(df[c], errors="coerce")
                bad = int((coerced.isna() & df[c].notna()).sum())
                if bad:
                    logger.warning(
                        "schema drift at %s: column %r carried %d value(s) the "
                        "numeric reference schema cannot parse — nulled", path, c, bad)
                    _count("unparseable", bad)
                df = df.copy(deep=False)
                df[c] = coerced
            elif not ref_isnum[c] and pd.api.types.is_numeric_dtype(df[c]):
                logger.warning(
                    "schema drift at %s: numeric column %r stringified to "
                    "match the string-typed reference schema", path, c)
                _count("retyped", 1)
                df = df.copy(deep=False)
                df[c] = np.array(
                    [None if pd.isna(v) else str(v) for v in df[c]],
                    dtype=object)
        out.append(df[ref_cols])
    return out


# ----------------------------------------------------------------------
# value sanitization at the decode boundary
# ----------------------------------------------------------------------
def sanitize_frame(df: pd.DataFrame,
                   policy: Optional[IngestPolicy] = None) -> pd.DataFrame:
    """Stop hostile float values before they reach device kernels.

    ±inf and finite values beyond the f32 range (which would silently
    become ±inf on upload) are nulled (``mask``, default), clipped to
    the f32 range (``clip``) or passed through (``keep``), with exact
    per-column counters.  NaN is NOT counted — it is the null
    representation every masked kernel already understands.  Clean
    frames return unchanged (identity, not a copy)."""
    pol = policy or policy_from_env()
    if pol.sanitize == "keep":
        return df
    counter = None
    touched = False
    for c in df.columns:
        s = df[c]
        if s.dtype.kind != "f":
            continue
        vals = s.to_numpy()
        # one-pass clean-column gate (the overwhelmingly common case):
        # nanmax(|v|) is NaN for all-null columns and ≤ f32max for clean
        # ones — both comparisons below come out False and we skip the
        # 3-mask scan entirely (measured ~3x cheaper on clean reads)
        if len(vals) == 0:
            continue
        mx = np.fmax.reduce(np.abs(vals))  # NaN-ignoring max, no warnings
        if not (mx > _F32_MAX) and not np.isinf(mx):
            continue
        pos = vals == np.inf
        neg = vals == -np.inf
        over = np.isfinite(vals) & (np.abs(vals) > _F32_MAX)
        n_pos, n_neg, n_over = int(pos.sum()), int(neg.sum()), int(over.sum())
        if not (n_pos or n_neg or n_over):
            continue
        if counter is None:
            try:
                from anovos_tpu_torch.obs import get_metrics

                counter = get_metrics().counter(
                    "ingest_sanitized_values_total",
                    "hostile values (inf/overflow) sanitized at the decode boundary")
            except Exception:
                counter = False
        if counter:
            for kind, n in (("posinf", n_pos), ("neginf", n_neg), ("overflow", n_over)):
                if n:
                    counter.inc(n, column=str(c), kind=kind)
        if not touched:
            df = df.copy(deep=False)
            touched = True
        fixed = vals.astype(np.float64, copy=True)
        if pol.sanitize == "clip":
            fixed[pos | (over & (vals > 0))] = _F32_MAX
            fixed[neg | (over & (vals < 0))] = -_F32_MAX
        else:  # mask: the value becomes a null (device mask=False)
            fixed[pos | neg | over] = np.nan
        df[c] = fixed
        logger.warning(
            "sanitized column %r at the decode boundary: %d +inf, %d -inf, "
            "%d f32-overflow value(s) → %s", c, n_pos, n_neg, n_over,
            "clipped" if pol.sanitize == "clip" else "nulled")
    return df
