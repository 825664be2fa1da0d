"""Out-of-core statistics over part-file datasets (counterpart of
``anovos_tpu/ops/streaming.py``).

A dataset larger than device memory is described by streaming row
chunks to the card and merging per-chunk partials on the host; the table
never sits on the device whole:

- moments (count, mean, M2, M3, M4, min, max, nonzero): one launch of the
  moments kernel a chunk, partials merged pairwise in float64 with Chan
  et al.'s formulas (``_pairwise_merge``);
- quantiles: a second pass bins every chunk against the global min/max of
  the first (``_chunk_hist``, plain torch ops), the int64 counts summed on
  the host; error at most range/nbins.

The pipeline (``_run_pass``): a decode pool (``data_ingest/prefetch.py``)
reads part files ahead through the ingest guard (``data_ingest/guard.py``:
a corrupt part is quarantined and the stream goes on over the others);
the consumer cuts the frames into chunks and writes each chunk's numeric
columns column-major, (k, rows) with the live k only, into a pinned
staging buffer; the block goes up with ``non_blocking=True``, the chunk's
kernel is launched, its tiny partial is copied back into pinned memory
and a CUDA event recorded.  Chunks drain a window behind
(``ANOVOS_STREAM_INFLIGHT``): the consumer waits on the oldest chunk's
event only, and its staging buffer is reused only after that event.

With ``checkpoint_dir`` every drained chunk's partial commits to disk
(``StreamCheckpoint``: tmp+rename ``.npz`` files and a journal);
``resume=True`` after a crash re-reads only the files that feed undone
chunks and gives exactly the uninterrupted result.  The partials are
float64/int64 (the JAX package's are f32), and the stream signature names
this package, so neither package resumes the other's checkpoints.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from anovos_tpu_torch.data_ingest.guard import IngestError, guarded_part_read, policy_from_env, raw_reader
from anovos_tpu_torch.data_ingest.prefetch import DecodePool, StreamController, StreamStats, plan_file_skips
from anovos_tpu_torch.ops.kernels.moments import masked_moments_cols
from anovos_tpu_torch.ops.quantiles import quantiles_from_histogram

logger = logging.getLogger(__name__)

_FIELDS = ("n", "mean", "M2", "M3", "M4", "min", "max", "nonzero")

# the most recent streaming pass' instrumentation (pure telemetry, never an
# input)
_LAST_STREAM: Dict[str, object] = {}
_LAST_STREAM_LOCK = threading.Lock()


def last_stream_summary() -> dict:
    """Window, workers and the decode/fetch-wait/drain-wait split of the
    most recent streaming call in this process."""
    with _LAST_STREAM_LOCK:
        return dict(_LAST_STREAM)


def _publish_stats(op: str, ctl: StreamController, stats: StreamStats) -> None:
    with _LAST_STREAM_LOCK:
        _LAST_STREAM.clear()
        _LAST_STREAM.update({"op": op, "window": ctl.window, "workers": ctl.workers,
                             "resizes": ctl.resizes, **stats.summary()})


def _chunk_partial(acc: np.ndarray) -> Dict[str, np.ndarray]:
    """The moments kernel's (8, k) accumulator → float64 fields n, mean,
    M2, M3, M4 (central sums about the chunk's own mean), min, max,
    nonzero.  A chunk with no valid value has n = 0, mean and central sums
    0 (the merge's identity) and the kernel's ±3.4e38 min/max sentinels."""
    out = dict(zip(_FIELDS, np.asarray(acc, np.float64)))
    empty = out["n"] == 0
    for f in ("mean", "M2", "M3", "M4"):
        out[f] = np.where(empty, 0.0, out[f])
    return out


def _chunk_stats(Xc: torch.Tensor, Mc: torch.Tensor) -> Dict[str, np.ndarray]:
    """Per-row statistics of a contiguous (rows, cols) f32 block and its
    bool mask, each row one chunk of one column, in one moments-kernel
    launch: float64 host fields (see ``_chunk_partial``)."""
    return _chunk_partial(masked_moments_cols(Xc, Mc).cpu().numpy())


def _combine(a: dict, b: dict) -> dict:
    """Chan et al. pairwise moment combination (numerically stable merge)."""
    n = a["n"] + b["n"]
    safe = np.maximum(n, 1.0)
    delta = b["mean"] - a["mean"]
    na, nb = a["n"], b["n"]
    mean = a["mean"] + delta * nb / safe
    M2 = a["M2"] + b["M2"] + delta**2 * na * nb / safe
    M3 = (
        a["M3"] + b["M3"]
        + delta**3 * na * nb * (na - nb) / safe**2
        + 3 * delta * (na * b["M2"] - nb * a["M2"]) / safe
    )
    M4 = (
        a["M4"] + b["M4"]
        + delta**4 * na * nb * (na**2 - na * nb + nb**2) / safe**3
        + 6 * delta**2 * (na**2 * b["M2"] + nb**2 * a["M2"]) / safe**2
        + 4 * delta * (na * b["M3"] - nb * a["M3"]) / safe
    )
    return {
        "n": n, "mean": mean, "M2": M2, "M3": M3, "M4": M4,
        "min": np.minimum(a["min"], b["min"]),
        "max": np.maximum(a["max"], b["max"]),
        "nonzero": a["nonzero"] + b["nonzero"],
    }


def _pairwise_merge(parts: List[dict]) -> dict:
    """Tree-reduce chunk partials: neighbours merge pairwise, level by
    level, an odd last one carried up."""
    while len(parts) > 1:
        parts = [
            _combine(parts[i], parts[i + 1]) if i + 1 < len(parts) else parts[i]
            for i in range(0, len(parts), 2)
        ]
    return parts[0]


def _chunk_hist(Xc: torch.Tensor, Mc: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                nbins: int) -> torch.Tensor:
    """(k, nbins) int64 counts of one (k, rows) chunk against fixed global
    edges: bin ``int((x - lo) / width * nbins)`` clipped, the f32
    operations of the JAX package in its order, ``width = max(hi - lo,
    1e-30)``; masked values go to a dump bin past the last.  Plain torch
    ops (the JAX package's is a jitted ``segment_sum``, not a Pallas
    kernel), in place where they can be, so a chunk's temporaries stay
    near two of its f32 blocks."""
    k = Xc.shape[0]
    width = torch.clamp_min(hi - lo, 1e-30)
    t = Xc - lo[:, None]
    t.div_(width[:, None]).mul_(nbins)
    idx = t.to(torch.int32)
    del t
    idx.clamp_(0, nbins - 1)
    idx.add_(torch.arange(k, dtype=torch.int32, device=Xc.device)[:, None] * nbins)
    idx.masked_fill_(~Mc, k * nbins)
    return torch.bincount(idx.view(-1), minlength=k * nbins + 1)[: k * nbins].view(k, nbins)


def _sum_parts(parts: Dict[int, Dict[str, np.ndarray]], key: str) -> Optional[np.ndarray]:
    """int64 sum of one count field over the chunk partials, in chunk
    order (the JAX package adds f32 counts, which round past 2^24 a bin)."""
    if not parts:
        return None
    out = None
    for i in sorted(parts):
        h = np.asarray(parts[i][key], np.int64)
        out = h if out is None else out + h
    return out


def _iter_chunks(
    files: List[str], file_type: str, chunk_rows: int, cfg: dict,
    skip_chunks: frozenset = frozenset(),
    file_rows: Optional[dict] = None,
    on_file_rows=None,
    pool: Optional[DecodePool] = None,
    stats: Optional[StreamStats] = None,
) -> Iterator[Tuple[int, Optional[pd.DataFrame]]]:
    """(chunk index, raw chunk frame of at most ``chunk_rows`` rows) in
    file order; the frame is None for a chunk in ``skip_chunks`` (committed
    by a prior run: the caller loads its partial).

    When ``file_rows`` (the prior run's per-file row counts) proves that a
    whole file feeds only committed chunks and ends on a chunk boundary
    (or is the last file), the file is not read at all.  Files straddling
    into an undone chunk are read again.  ``on_file_rows(path, nrows,
    at_chunk)`` reports each file's decoded row count and returns True
    when it differs from the prior run's record: the chunks from
    ``at_chunk`` on then cover shifted rows, and the local skip set and the
    pool's skip plan forget them.  A part the guard quarantines counts 0
    rows and the stream goes on over the others; under
    ``ANOVOS_INGEST_ON_CORRUPT=raise`` its error propagates."""

    def _fetch(fi: int, f: str) -> pd.DataFrame:
        if pool is not None:
            return pool.fetch(fi, f)
        # synchronous decode on the consuming thread (late bind: tests
        # monkeypatch read_host_frame to count reads)
        from anovos_tpu_torch.data_ingest import data_ingest as di

        t0 = time.perf_counter()
        try:
            return di.read_host_frame([f], file_type, cfg)
        finally:
            dt = time.perf_counter() - t0
            try:
                nbytes = os.path.getsize(f)
            except OSError:
                nbytes = 0
            if stats is not None:
                stats.add_decode(dt, nbytes)
                stats.add_fetch_wait(dt)

    buf: List[pd.DataFrame] = []
    nbuf = 0
    idx = 0  # next chunk index; the buffer holds rows idx*chunk_rows + ...
    for fi, f in enumerate(files):
        known = (file_rows or {}).get(f)
        if known is not None and known > 0 and nbuf == 0 and skip_chunks:
            # empty buffer: the stream sits exactly on chunk boundary idx
            start = idx * chunk_rows
            last = (start + known - 1) // chunk_rows
            if all(c in skip_chunks for c in range(idx, last + 1)) and (
                    (start + known) % chunk_rows == 0 or fi == len(files) - 1):
                for c in range(idx, last + 1):
                    yield c, None
                idx = last + 1
                continue
        try:
            df = _fetch(fi, f)
        except IngestError:
            if policy_from_env().on_corrupt == "raise":
                raise
            # quarantined (the guard recorded it): later chunk boundaries
            # shift up by the lost rows
            if on_file_rows is not None and on_file_rows(f, 0, idx):
                skip_chunks = frozenset(c for c in skip_chunks if c < idx)
                if pool is not None:
                    pool.cancel_skip_plan()
            continue
        if on_file_rows is not None and on_file_rows(f, len(df), idx):
            skip_chunks = frozenset(c for c in skip_chunks if c < idx)
            if pool is not None:
                pool.cancel_skip_plan()
        buf.append(df)
        nbuf += len(df)
        while nbuf >= chunk_rows:
            cat = pd.concat(buf, ignore_index=True) if len(buf) > 1 else buf[0]
            yield idx, (None if idx in skip_chunks else cat.iloc[:chunk_rows])
            idx += 1
            rest = cat.iloc[chunk_rows:]
            buf, nbuf = ([rest] if len(rest) else []), len(rest)
    if nbuf:
        cat = pd.concat(buf, ignore_index=True) if len(buf) > 1 else buf[0]
        yield idx, (None if idx in skip_chunks else cat)


class _Staging:
    """Host staging of column-major chunk blocks on their way to the
    device.  On the card each slot is a pair of pinned buffers (values,
    mask) of ``k × chunk_rows``; a slot goes back to the free list only
    when the event of the chunk that used it has completed, so a block is
    never overwritten while its copy may still be in flight.  On the CPU
    the slots are plain numpy buffers the plain kernels read at once."""

    def __init__(self, k: int, chunk_rows: int, device: torch.device):
        self.k, self.chunk_rows = k, chunk_rows
        self.cuda = device.type == "cuda"
        self._free: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def _new(self) -> Tuple[torch.Tensor, torch.Tensor]:
        size = self.k * self.chunk_rows
        return (torch.empty(size, dtype=torch.float32, pin_memory=self.cuda),
                torch.empty(size, dtype=torch.bool, pin_memory=self.cuda))

    def fill(self, frame: pd.DataFrame, cols: List[str]):
        """The frame's numeric ``cols`` as a (k, rows) f32 block, nulls
        stored as 0 with mask False: (slot, values, mask) host tensors."""
        slot = self._free.pop() if self._free else self._new()
        n = len(frame)
        xv = slot[0][: self.k * n].view(self.k, n)
        mv = slot[1][: self.k * n].view(self.k, n)
        xn, mn = xv.numpy(), mv.numpy()
        for j, c in enumerate(cols):
            np.copyto(xn[j], frame[c].to_numpy(np.float32, na_value=np.nan))
            np.isnan(xn[j], out=mn[j])
            xn[j][mn[j]] = 0.0
            np.logical_not(mn[j], out=mn[j])
        return slot, xv, mv

    def release(self, slot) -> None:
        self._free.append(slot)


def _open_pool(files: List[str], file_type: str, cfg: dict, ctl: StreamController,
               stats: StreamStats, ckpt: Optional["StreamCheckpoint"], skip_chunks: frozenset,
               chunk_rows: int) -> Optional[DecodePool]:
    """A decode pool for one pass (None when decode is pinned to the
    consumer's thread).  Files a resume will skip are not decoded ahead."""
    if ctl.workers <= 0:
        return None
    plan = frozenset()
    if ckpt is not None and skip_chunks:
        plan = plan_file_skips(files, ckpt.file_rows, skip_chunks, chunk_rows)
    return DecodePool(files, file_type, cfg, ctl, skip_plan=plan, stats=stats,
                      journal=ckpt.journal if ckpt is not None else None)


def _run_pass(
    files: List[str], file_type: str, cols: List[str], chunk_rows: int, cfg: dict, *,
    pass_no: int,
    dispatch: Callable,
    ctl: StreamController,
    stats: StreamStats,
    ckpt: Optional["StreamCheckpoint"] = None,
    skip_chunks: frozenset = frozenset(),
    on_file_rows=None,
    host_part: Optional[Callable] = None,
    finish: Optional[Callable] = None,
    need_block: bool = True,
) -> Dict[int, Dict[str, np.ndarray]]:
    """One windowed streaming pass.  Each chunk's ``cols`` go to the
    device as a (k, rows) block and ``dispatch(Xc, Mc) -> {name: device
    tensor}`` launches its work; the partial comes back a window behind,
    is turned into host arrays (``finish(part)``, optional), joined with
    ``host_part(raw_frame) -> {name: array}`` (categorical counts, row
    tallies) and committed to the checkpoint.  Returns {chunk index: host
    partial}; the committed chunks of a resumed run load from disk without
    decode or device work.  ``need_block=False`` (host tallies only)
    builds no block and dispatches nothing.

    ``dispatch`` must not wait for the device: the drain synchronises on
    each chunk's event, a window behind."""
    from anovos_tpu_torch.shared.runtime import get_runtime

    device = get_runtime().device
    need_block = need_block and bool(cols)
    staging = _Staging(len(cols), chunk_rows, device) if need_block else None
    pool = _open_pool(files, file_type, cfg, ctl, stats, ckpt, skip_chunks, chunk_rows)
    pending: deque = deque()
    parts: Dict[int, Dict[str, np.ndarray]] = {}
    t_pass = time.perf_counter()
    last_drain_t = t_pass

    def _launch(frame: pd.DataFrame):
        """Upload the chunk's block, launch its work, start the copy of
        its partial home: (partial tensors, event, staging slot)."""
        slot, xv, mv = staging.fill(frame, cols)
        xd = xv.to(device, non_blocking=True)
        md = mv.to(device, non_blocking=True)
        dev = dispatch(xd, md)
        if not staging.cuda:
            return dev, None, slot
        home = {}
        for name, t in dev.items():
            home[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            home[name].copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return home, ev, slot

    def _drain_oldest():
        nonlocal last_drain_t
        i, home, ev, slot, host = pending.popleft()
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        part = {k: np.array(t.numpy()) for k, t in home.items()}
        if slot is not None:
            staging.release(slot)
        now = time.perf_counter()
        stats.add_drain_wait(now - t0)
        if finish is not None and part:
            part = finish(part)
        if host:
            part.update(host)
        parts[i] = part
        if ckpt is not None:
            ckpt.commit(pass_no, i, part)
        stats.chunks += 1
        fetch_w, drain_w = stats.take_chunk_signals()
        ctl.observe(fetch_w, drain_w, now - last_drain_t)
        last_drain_t = now
        if pool is not None:
            pool.maybe_grow()

    try:
        for idx, frame in _iter_chunks(
                files, file_type, chunk_rows, cfg, skip_chunks=skip_chunks,
                file_rows=ckpt.file_rows if ckpt is not None else None,
                on_file_rows=on_file_rows, pool=pool, stats=stats):
            if frame is None:
                parts[idx] = ckpt.load(pass_no, idx)
                continue
            if ckpt is not None:
                ckpt.begin(pass_no, idx)
            host = host_part(frame) if host_part is not None else None
            home, ev, slot = _launch(frame) if need_block else ({}, None, None)
            pending.append((idx, home, ev, slot, host))
            stats.high_water = max(stats.high_water, len(pending))
            while len(pending) >= max(1, ctl.window):
                _drain_oldest()
        while pending:
            _drain_oldest()
    finally:
        if pool is not None:
            pool.close()
        stats.wall_s = round(stats.wall_s + time.perf_counter() - t_pass, 4)
    return parts


@raw_reader
def _read_schema_kinds_raw(f: str) -> List[Tuple[str, str]]:
    """RAW parquet schema read (the footer only): every column with its
    coarse kind, ``num`` | ``cat`` | ``other`` — guarded callers only."""
    import pyarrow.parquet as pq
    import pyarrow.types as pat

    out = []
    for fld in pq.read_schema(f):
        if pat.is_integer(fld.type) or pat.is_floating(fld.type) or pat.is_decimal(fld.type):
            kind = "num"
        elif pat.is_string(fld.type) or pat.is_large_string(fld.type):
            kind = "cat"
        else:
            kind = "other"
        out.append((fld.name, kind))
    return out


def stream_schema(files: List[str], file_type: str,
                  cfg: Optional[dict] = None) -> List[Tuple[str, str]]:
    """[(column, num|cat|other)] of a part-file dataset without reading
    row data where the format allows: the parquet footer of the first
    readable part (a corrupt head part is quarantined and the next one
    asked).  Other formats decode their first part."""
    if file_type == "parquet":
        for f in files:
            kinds = guarded_part_read(f, lambda f=f: _read_schema_kinds_raw(f),
                                      file_type="parquet", stage="schema")
            if kinds is not None:
                return kinds
        raise IngestError(f"no parquet part with a readable footer among {len(files)} file(s)")
    from anovos_tpu_torch.data_ingest import data_ingest as di

    head = di.read_host_frame(files[:1], file_type, dict(cfg or {}))
    out = []
    for c in head.columns:
        if pd.api.types.is_numeric_dtype(head[c]):
            kind = "num"
        elif head[c].dtype == object or str(head[c].dtype) in ("string", "str"):
            kind = "cat"
        else:
            kind = "other"
        out.append((str(c), kind))
    return out


def _parquet_numeric_cols(files: List[str]) -> List[str]:
    """Numeric column names from the first part whose footer is readable
    (integer, floating and decimal fields)."""
    return [c for c, k in stream_schema(files, "parquet") if k == "num"]


class StreamCheckpoint:
    """Per-chunk progress of a resumable streaming computation.

    Under ``root``: ``stream_manifest.json`` (the stream signature, the
    per-file row counts and the committed chunks, tmp+rename),
    ``pass<p>_chunk_<i>.npz`` partials (tmp+rename, fsynced: the
    durability point) and ``stream_journal.jsonl`` (``run_begin``,
    ``chunk_begin``/``chunk_commit``, ``chunks_invalidated``,
    ``chunk_spilled``).  A manifest of another stream (files, chunk_rows,
    columns or bins changed) is not resumed: the stream starts afresh."""

    MANIFEST = "stream_manifest.json"

    def __init__(self, root: str, sig: str, resume: bool = False):
        from anovos_tpu_torch.cache.journal import RunJournal

        self.root = os.path.abspath(root)
        self.sig = sig
        os.makedirs(self.root, exist_ok=True)
        self.file_rows: Dict[str, int] = {}
        # pass number -> committed chunk indices
        self._committed: Dict[int, set] = defaultdict(set)
        mpath = os.path.join(self.root, self.MANIFEST)
        prior = None
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    prior = json.load(f)
            except (OSError, ValueError):
                prior = None  # a torn manifest restarts the stream
        if prior is not None and prior.get("sig") == sig:
            if resume:
                self.file_rows = dict(prior.get("file_rows", {}))
                # the .npz files are the durability point, not the list
                for pk, idxs in (prior.get("committed", {}) or {}).items():
                    p = int(pk)
                    self._committed[p] = {i for i in idxs if os.path.exists(self._part_path(p, i))}
        elif prior is not None:
            logger.warning("stream checkpoint at %s belongs to a different stream "
                           "(files/params changed) — starting fresh", self.root)
        self.journal = RunJournal(os.path.join(self.root, "stream_journal.jsonl"))
        self.journal.append("run_begin", stream=sig[:16], resume=bool(resume),
                            committed_p1=len(self._committed[1]),
                            committed_p2=len(self._committed[2]))

    def _part_path(self, pass_no: int, idx: int) -> str:
        return os.path.join(self.root, f"pass{pass_no}_chunk_{idx}.npz")

    def committed(self, pass_no: int) -> frozenset:
        return frozenset(self._committed[pass_no])

    def record_file_rows(self, path: str, n: int) -> bool:
        """Record ``path``'s decoded row count.  True when a prior run
        recorded a different count: the file's readability changed, so
        every chunk downstream of it covers other rows now."""
        prior = self.file_rows.get(path)
        if prior == n:
            return False
        self.file_rows[path] = int(n)
        self._flush_manifest()
        return prior is not None

    def _drop_committed(self, pass_no: int, from_idx: int) -> int:
        """Uncommit and unlink the chunks of ``pass_no`` at/after ``from_idx``."""
        n = 0
        for c in sorted(c for c in self._committed[pass_no] if c >= from_idx):
            self._committed[pass_no].discard(c)
            try:
                os.unlink(self._part_path(pass_no, c))
            except OSError:
                pass
            n += 1
        return n

    def invalidate_from(self, idx: int, passes: Optional[Tuple[int, ...]] = None) -> None:
        """Drop every committed chunk at/after ``idx`` of ``passes`` (None:
        all), those whose chunks are numbered over the file set that
        shifted."""
        dropped = sum(self._drop_committed(p, idx)
                      for p in sorted(passes if passes is not None else self._committed))
        if dropped:
            logger.warning("stream checkpoint: a part's readability changed since the prior run — "
                           "%d committed chunk(s) from index %d on cover shifted rows and will "
                           "recompute", dropped, idx)
            self.journal.append("chunks_invalidated", stream=self.sig[:16], from_chunk=idx,
                                dropped=dropped)
            self._flush_manifest()

    def check_bounds(self, lo: np.ndarray, hi: np.ndarray, passes: Tuple[int, ...] = (2,)) -> None:
        """The partials of ``passes`` are counts binned over edges derived
        from ``lo``/``hi``: if those differ bit for bit from the prior
        run's, every committed chunk of those passes recomputes."""
        bpath = os.path.join(self.root, "pass2_bounds.npz")
        prior = None
        if os.path.exists(bpath):
            try:
                with np.load(bpath) as z:
                    prior = (z["lo"], z["hi"])
            except (OSError, ValueError):
                prior = None
        if (prior is not None and prior[0].shape == lo.shape
                and np.array_equal(prior[0], lo) and np.array_equal(prior[1], hi)):
            return
        dropped = sum(self._drop_committed(p, 0) for p in passes)
        if dropped:
            self.journal.append("chunks_invalidated", stream=self.sig[:16], from_chunk=0,
                                dropped=dropped, phase=passes[0])
            self._flush_manifest()
        tmp = bpath + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, lo=lo, hi=hi)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, bpath)

    def begin(self, pass_no: int, idx: int) -> None:
        self.journal.append("chunk_begin", stream=self.sig[:16], phase=pass_no, chunk=idx)

    def commit(self, pass_no: int, idx: int, arrays: Dict[str, np.ndarray]) -> None:
        path = self._part_path(pass_no, idx)
        tmp = path + ".tmp.npz"  # np.savez appends .npz to bare names
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._committed[pass_no].add(idx)
        self.journal.append("chunk_commit", stream=self.sig[:16], phase=pass_no, chunk=idx)
        self._flush_manifest()

    def load(self, pass_no: int, idx: int) -> Dict[str, np.ndarray]:
        with np.load(self._part_path(pass_no, idx)) as z:
            return {k: z[k] for k in z.files}

    def _flush_manifest(self) -> None:
        mpath = os.path.join(self.root, self.MANIFEST)
        tmp = mpath + ".tmp"
        doc = {"sig": self.sig, "file_rows": self.file_rows,
               "committed": {str(p): sorted(s) for p, s in self._committed.items()}}
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, mpath)


def _stream_sig(files: List[str], file_type: str, cols: List[str], chunk_rows: int, nbins: int,
                op: str = "describe") -> str:
    """Identity of one streaming computation: this package, the operation,
    the exact file set (stat signatures) and the chunking and binning
    parameters.  Any change invalidates checkpointed progress wholesale."""
    from anovos_tpu_torch.cache.fingerprint import digest

    sigs = []
    for f in files:
        try:
            st = os.stat(f)
            sigs.append(f"{f}:{st.st_size}:{st.st_mtime_ns}")
        except OSError:
            sigs.append(f"{f}:gone")
    return digest("anovos_tpu_torch", op, file_type, ",".join(cols), str(chunk_rows), str(nbins),
                  *sigs)


def checkpoint_on_file_rows(ckpt: Optional[StreamCheckpoint], passes: Optional[Tuple[int, ...]] = None):
    """The ``on_file_rows`` hook of a checkpointed stream: a readability
    change drops the prior partials of ``passes`` from that chunk on."""
    if ckpt is None:
        return None

    def _on_file_rows(path, n, at_chunk):
        if ckpt.record_file_rows(path, n):
            ckpt.invalidate_from(at_chunk, passes=passes)
            return True
        return False

    return _on_file_rows


def moments_dispatch(Xc: torch.Tensor, Mc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A chunk's moments: one launch of the moments kernel."""
    return {"acc": masked_moments_cols(Xc, Mc)}


def moments_finish(part: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return _chunk_partial(part["acc"])


def describe_streaming(
    file_path: str,
    file_type: str,
    list_of_cols: Optional[List[str]] = None,
    chunk_rows: int = 1_000_000,
    nbins: int = 2048,
    file_configs: Optional[dict] = None,
    quantiles: Tuple[float, ...] = (0.01, 0.05, 0.10, 0.25, 0.50, 0.75, 0.90, 0.95, 0.99),
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
) -> pd.DataFrame:
    """Two-pass streaming description of a part-file dataset of any size:
    [attribute, count, mean, stddev, variance, skewness, kurtosis, min,
    max, nonzero, <quantiles…>].

    Pass 1 launches the moments kernel once a chunk and merges the
    partials in float64; pass 2 bins every chunk against the global
    min/max (``_chunk_hist``) and the quantiles come from the summed
    counts (error at most range/nbins).  Device memory is
    O(window·chunk_rows·k) whatever the row count.  With
    ``checkpoint_dir`` each chunk's partial commits; ``resume=True``
    after a crash skips every committed chunk and gives exactly the
    uninterrupted result."""
    from anovos_tpu_torch.data_ingest.data_ingest import _resolve_files
    from anovos_tpu_torch.obs import get_metrics
    from anovos_tpu_torch.ops.reductions import finalize_moments
    from anovos_tpu_torch.shared.runtime import get_runtime

    cfg = dict(file_configs or {})
    files = _resolve_files(file_path, file_type)
    if list_of_cols is None:
        if file_type == "parquet":
            list_of_cols = _parquet_numeric_cols(files)
        else:
            list_of_cols = [c for c, k in stream_schema(files, file_type, cfg) if k == "num"]
    cols = list(list_of_cols)
    if not cols:
        raise ValueError("describe_streaming: no numeric columns")

    ctl = StreamController()
    stats = StreamStats()
    inflight_gauge = get_metrics().gauge(
        "stream_inflight_high_water", "max dispatched-but-undrained chunks (device-residency bound)")
    ckpt = None
    if checkpoint_dir:
        ckpt = StreamCheckpoint(checkpoint_dir, _stream_sig(files, file_type, cols, chunk_rows, nbins),
                                resume=resume)
    on_rows = checkpoint_on_file_rows(ckpt)

    def _skip(pass_no):
        return ckpt.committed(pass_no) if (ckpt is not None and resume) else frozenset()

    parts = _run_pass(files, file_type, cols, chunk_rows, cfg, pass_no=1,
                      dispatch=moments_dispatch, finish=moments_finish,
                      ctl=ctl, stats=stats, ckpt=ckpt, skip_chunks=_skip(1), on_file_rows=on_rows)
    if not parts:
        raise IngestError(f"describe_streaming: no readable rows in {len(files)} part file(s) "
                          "(every part quarantined?)")
    agg = _pairwise_merge([parts[i] for i in sorted(parts)])

    # the global bounds are f32 data values (min and max are exact)
    lo = agg["min"].astype(np.float32)
    hi = agg["max"].astype(np.float32)
    if ckpt is not None:
        # every pass-2 partial was binned over the prior run's bounds
        ckpt.check_bounds(lo, hi)
    device = get_runtime().device
    lo_d, hi_d = torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)
    parts2 = _run_pass(files, file_type, cols, chunk_rows, cfg, pass_no=2,
                       dispatch=lambda Xc, Mc: {"hist": _chunk_hist(Xc, Mc, lo_d, hi_d, nbins)},
                       ctl=ctl, stats=stats, ckpt=ckpt, skip_chunks=_skip(2), on_file_rows=on_rows)
    hist = _sum_parts(parts2, "hist")
    inflight_gauge.set_max(float(stats.high_water), window=ctl.label)
    _publish_stats("describe_streaming", ctl, stats)

    f64 = {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in agg.items()}
    fin = {k: v.numpy() for k, v in finalize_moments(
        f64["n"], f64["mean"] * f64["n"], f64["M2"], f64["M3"], f64["M4"], f64["min"], f64["max"],
        f64["nonzero"]).items()}
    out = {
        "attribute": cols,
        "count": agg["n"].astype(np.int64),
        "mean": np.round(fin["mean"], 4),
        "stddev": np.round(fin["stddev"], 4),
        "variance": np.round(fin["variance"], 4),
        "skewness": np.round(fin["skewness"], 4),
        "kurtosis": np.round(fin["kurtosis"], 4),
        "min": fin["min"].astype(np.float32),
        "max": fin["max"].astype(np.float32),
        "nonzero": agg["nonzero"].astype(np.int64),
    }
    width = (hi - lo) / np.float32(nbins)
    qvals = quantiles_from_histogram(hist, lo, width, quantiles)
    for i, q in enumerate(quantiles):
        out[f"{int(q * 100)}%"] = np.round(qvals[i], 4)
    return pd.DataFrame(out)
