"""Prefetching input pipeline of the streaming passes: a background
decode pool and an autotuned in-flight window (counterpart of
``anovos_tpu/data_ingest/prefetch.py``).

* :class:`DecodePool` — daemon threads decode part files in order through
  the guarded reader (``data_ingest.read_host_frame`` per part: retry,
  quarantine, schema reconciliation, sanitization).  Claims are
  slot-backed: a worker reserves a staging slot before it claims the
  next file, so at most ``window`` decoded-but-unconsumed frames exist
  and the pool cannot deadlock against its consumer.  Frames that outrun
  the in-memory window spill to a disk tier (``ANOVOS_STREAM_SPILL_DIR``)
  instead of blocking the decoders.  Files a resumed stream will skip
  (``plan_file_skips``) are never decoded ahead.  The workers only make
  pandas frames: they never touch the device.

* :class:`StreamController` — ``ANOVOS_STREAM_INFLIGHT=auto`` (the
  default) starts at a window of 2 and steers from the per-chunk split
  the consumer reports: time blocked on decode grows the worker count
  first, then the window (up to 8); time blocked on the device drain
  with a quiet pool shrinks the window back.  An integer pins the
  window; ``ANOVOS_STREAM_DECODE_WORKERS`` pins the workers (0: decode
  on the consumer's thread).  Results are the same at any setting
  (ordered assembly, FIFO drain).

* :class:`StreamStats` — per-pass decode, fetch-wait and drain-wait
  tallies (``ops/streaming.last_stream_summary``).

The window bounds the dispatched-but-undrained chunks on the device
(O(window·chunk_rows·k)); the pool bounds host staging to ``window``
in-memory frames plus the spill tier.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "StreamController",
    "StreamStats",
    "DecodePool",
    "stream_window_spec",
    "decode_workers_spec",
    "spill_dir_spec",
    "plan_file_skips",
]

# auto-window bounds: the floor gives decode/compute overlap, the cap is
# the documented O(window·chunk_rows·k) residency bound's multiplier
_AUTO_WINDOW_MIN = 2
_AUTO_WINDOW_CAP = 8
# a pool never grows past this many decode threads (pyarrow releases the
# GIL, but each live decode holds one frame of scratch memory)
_WORKER_CAP = 8
# fraction of a chunk's wall the consumer may spend blocked on decode
# before the controller calls the pool starved
_STARVED_FRAC = 0.10
# consecutive unstarved chunks before an auto window shrinks one step
_QUIET_CHUNKS = 4


def stream_window_spec() -> Optional[int]:
    """``ANOVOS_STREAM_INFLIGHT``: explicit window, or None for ``auto``
    (the default: the controller picks)."""
    raw = (os.environ.get("ANOVOS_STREAM_INFLIGHT", "auto") or "auto").strip()
    if raw.lower() in ("auto", ""):
        return None
    try:
        return max(1, int(raw))
    except ValueError:
        return None


def decode_workers_spec() -> Optional[int]:
    """``ANOVOS_STREAM_DECODE_WORKERS``: explicit decode thread count
    (0 = fully synchronous, no pool), or None for auto."""
    raw = (os.environ.get("ANOVOS_STREAM_DECODE_WORKERS", "") or "").strip()
    if not raw or raw.lower() == "auto":
        return None
    try:
        return max(0, int(raw))
    except ValueError:
        return None


def spill_dir_spec() -> Optional[str]:
    """``ANOVOS_STREAM_SPILL_DIR``: root for the disk staging tier (unset
    = decoders block at the window instead of spilling)."""
    return os.environ.get("ANOVOS_STREAM_SPILL_DIR") or None


def available_cpus() -> int:
    """CPUs this process may run on, cgroup/cpuset-aware where the
    platform supports it (``os.cpu_count()`` reports the host's cores even
    in a container pinned to fewer)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


def _default_workers() -> int:
    cpus = available_cpus()
    return max(1, min(4, cpus - 1, _WORKER_CAP)) if cpus > 1 else 1


class StreamController:
    """Window + worker schedule for one streaming computation.

    Thread-safe; the consumer calls :meth:`observe` once per drained
    chunk, the pool polls :attr:`workers` / :attr:`window`.  Fixed specs
    (integer env values) never move."""

    def __init__(self, window_spec: Optional[int] = None,
                 workers_spec: Optional[int] = None):
        if window_spec is None:
            window_spec = stream_window_spec()
        if workers_spec is None:
            workers_spec = decode_workers_spec()
        self._fixed_window = window_spec is not None
        self.window = window_spec if self._fixed_window else _AUTO_WINDOW_MIN
        self.window_cap = self.window if self._fixed_window else _AUTO_WINDOW_CAP
        # the gauge label names what the USER configured, so tests that
        # pin ANOVOS_STREAM_INFLIGHT=N read their own label back
        self.label = str(window_spec) if self._fixed_window else "auto"
        self._fixed_workers = workers_spec is not None
        self.workers = workers_spec if self._fixed_workers else _default_workers()
        self.worker_cap = (self.workers if self._fixed_workers
                           else max(self.workers, min(_WORKER_CAP,
                                                      _default_workers() * 2)))
        self._quiet = 0
        self.resizes = 0
        self._lock = threading.Lock()

    def observe(self, fetch_wait_s: float, drain_wait_s: float,
                chunk_wall_s: float) -> None:
        """One drained chunk's split: consumer wall blocked on decode
        (``fetch_wait_s``), on the device drain (``drain_wait_s``), and
        the chunk's total wall."""
        if self._fixed_window and self._fixed_workers:
            return
        starved = fetch_wait_s > _STARVED_FRAC * max(chunk_wall_s, 1e-6)
        with self._lock:
            if starved:
                self._quiet = 0
                if not self._fixed_workers and self.workers < self.worker_cap:
                    self.workers += 1
                    self.resizes += 1
                elif (not self._fixed_window and self.workers > 0
                      and self.window < self.window_cap):
                    # a deeper window only helps when a pool exists to
                    # fill it; synchronous decode gains nothing from it
                    self.window += 1
                    self.resizes += 1
            else:
                self._quiet += 1
                device_bound = drain_wait_s > _STARVED_FRAC * max(chunk_wall_s, 1e-6)
                if (not self._fixed_window and device_bound
                        and self._quiet >= _QUIET_CHUNKS
                        and self.window > _AUTO_WINDOW_MIN):
                    # device is the bottleneck and the pool keeps up: a
                    # deeper window only buys residency, give it back
                    self.window -= 1
                    self.resizes += 1
                    self._quiet = 0
        self._emit()

    def _emit(self) -> None:
        try:
            from anovos_tpu_torch.obs import get_metrics

            reg = get_metrics()
            reg.gauge("stream_window",
                      "current streaming in-flight window").set(
                float(self.window), mode=self.label)
            reg.gauge("stream_decode_workers",
                      "current streaming decode worker count").set(
                float(self.workers), mode=self.label)
        except Exception:
            pass


@dataclasses.dataclass
class StreamStats:
    """Per-pass instrumentation the controller and ``last_stream_summary`` read."""

    decode_s: float = 0.0
    decode_bytes: int = 0
    decodes: int = 0
    fetch_wait_s: float = 0.0
    drain_wait_s: float = 0.0
    spilled: int = 0
    chunks: int = 0
    high_water: int = 0
    wall_s: float = 0.0
    # deltas since the controller last looked (take_chunk_signals)
    _last_fetch_wait: float = 0.0
    _last_drain_wait: float = 0.0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def add_decode(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.decode_s += seconds
            self.decode_bytes += int(nbytes)
            self.decodes += 1

    def add_fetch_wait(self, seconds: float) -> None:
        with self._lock:
            self.fetch_wait_s += seconds

    def add_drain_wait(self, seconds: float) -> None:
        with self._lock:
            self.drain_wait_s += seconds

    def add_spill(self) -> None:
        with self._lock:
            self.spilled += 1

    def take_chunk_signals(self) -> Tuple[float, float]:
        """(fetch wait, drain wait) accrued since the previous call."""
        with self._lock:
            fw = self.fetch_wait_s - self._last_fetch_wait
            dw = self.drain_wait_s - self._last_drain_wait
            self._last_fetch_wait = self.fetch_wait_s
            self._last_drain_wait = self.drain_wait_s
        return fw, dw

    def overlap_pct(self) -> Optional[float]:
        """Share of decode wall that OVERLAPPED consumer progress: 1 −
        (consumer blocked-on-decode / total decode wall).  None until a
        decode happened.  ~0 on a synchronous pipeline, →1 when the pool
        fully hides decode behind device compute."""
        if self.decode_s <= 0:
            return None
        return round(max(0.0, 1.0 - self.fetch_wait_s / self.decode_s), 4)

    def summary(self) -> dict:
        return {
            "decode_s": round(self.decode_s, 4),
            "decode_bytes": self.decode_bytes,
            "decodes": self.decodes,
            "fetch_wait_s": round(self.fetch_wait_s, 4),
            "drain_wait_s": round(self.drain_wait_s, 4),
            "spilled": self.spilled,
            "chunks": self.chunks,
            "high_water": self.high_water,
            "wall_s": round(self.wall_s, 4),
            "overlap_pct": self.overlap_pct(),
        }


def plan_file_skips(files: List[str], file_rows: Dict[str, int],
                    skip_chunks: frozenset, chunk_rows: int) -> frozenset:
    """File indices a resumed stream will provably never decode.

    Replicates ``_iter_chunks``' whole-file-skip arithmetic against the
    PRIOR run's recorded row counts: a file is skippable iff the stream
    sits exactly on a chunk boundary when it starts, its recorded rows
    cover only committed chunks, and it ends on a boundary (or is the
    last file).  The pool must not speculatively decode these — that
    read is exactly what resume exists to avoid.  If any decode later
    DISAGREES with the prior row counts (a part's readability changed),
    the consumer abandons the plan and requests the file anyway; the
    pool then decodes it on demand (correctness never rides the plan)."""
    if not skip_chunks or not file_rows:
        return frozenset()
    out = set()
    nbuf = 0
    idx = 0
    for fi, f in enumerate(files):
        known = file_rows.get(f)
        if known is None:
            # unknown row count: boundaries downstream are unknowable
            break
        if known > 0 and nbuf == 0:
            start = idx * chunk_rows
            hi = (start + known - 1) // chunk_rows
            if all(c in skip_chunks for c in range(idx, hi + 1)) and (
                    (start + known) % chunk_rows == 0 or fi == len(files) - 1):
                out.add(fi)
                idx = hi + 1
                continue
        nbuf += known
        while nbuf >= chunk_rows:
            idx += 1
            nbuf -= chunk_rows
    return frozenset(out)


# staging-slot multiplier for the spill tier: with a spill dir the pool
# may run this many windows of frames ahead (disk-resident beyond the
# in-memory window) before decoders block
_SPILL_WINDOWS = 3


class DecodePool:
    """Ordered speculative part-file decode behind a streaming consumer.

    ``fetch(fi, f)`` is the drop-in for ``_iter_chunks``' synchronous
    read: it returns the decoded frame for file index ``fi`` (or raises
    the ``IngestError`` the guarded read raised, in file order — the
    consumer's quarantine/raise handling is untouched).  Workers claim
    file indices strictly in order, each claim backed by a staging slot,
    so claimed indices always complete and the consumer (which drains
    the lowest index) can never deadlock against a full window."""

    def __init__(self, files: List[str], file_type: str, cfg: dict,
                 controller: StreamController,
                 skip_plan: frozenset = frozenset(),
                 stats: Optional[StreamStats] = None,
                 journal=None):
        self._files = list(files)
        self._file_type = file_type
        self._cfg = dict(cfg or {})
        self._ctl = controller
        self._skip_plan = set(skip_plan)
        self._plan_live = bool(skip_plan)
        self._stats = stats
        self._journal = journal
        self._cv = threading.Condition()
        self._next = 0                      # next unclaimed file index
        self._consumed = 0                  # lowest index not yet consumed
        self._claimed: set = set()
        self._done: Dict[int, Tuple[str, object]] = {}  # idx -> (kind, payload)
        self._in_mem = 0
        self._closed = False
        self._spill_root = spill_dir_spec()
        self._spill_dir: Optional[str] = None
        self._threads: List[threading.Thread] = []
        if controller.workers > 0:
            self._spawn(controller.workers)

    # -- workers -----------------------------------------------------------
    def _spawn(self, n: int) -> None:
        for _ in range(n):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name="anovos-decode")
            t.start()
            self._threads.append(t)

    def maybe_grow(self) -> None:
        """Spawn workers up to the controller's current target (called by
        the consumer between chunks — autotune grows the pool live)."""
        with self._cv:
            want = self._ctl.workers - len(self._threads)
        if want > 0:
            self._spawn(want)

    def _capacity(self) -> int:
        base = max(1, self._ctl.window)
        return base * (_SPILL_WINDOWS + 1) if self._spill_root else base

    def _claim_next(self) -> Optional[int]:
        """Next decodable index under the slot bound, or None to exit."""
        with self._cv:
            while True:
                if self._closed:
                    return None
                while (self._plan_live and self._next in self._skip_plan
                       and self._next < len(self._files)):
                    self._next += 1
                if self._next >= len(self._files):
                    return None
                # slot-backed claims: indices claimed or staged but not yet
                # consumed — the bound that makes the pool deadlock-free
                outstanding = sum(1 for i in self._claimed if i >= self._consumed) \
                    + sum(1 for i in self._done if i >= self._consumed)
                if outstanding < self._capacity():
                    i = self._next
                    self._next += 1
                    self._claimed.add(i)
                    return i
                self._cv.wait(timeout=0.5)

    def _worker(self) -> None:
        while True:
            i = self._claim_next()
            if i is None:
                return
            kind, payload = self._decode(i)
            with self._cv:
                if self._closed:
                    self._claimed.discard(i)
                    self._cv.notify_all()
                    return
                # decide to spill under the lock; WRITE outside it — a
                # multi-hundred-MB pickle inside _cv would stall the
                # consumer's fetch of already-staged frames and every
                # worker's next claim for the whole write
                want_spill = (kind == "mem"
                              and self._in_mem >= max(1, self._ctl.window)
                              and self._spill_root and i > self._consumed)
            if want_spill:
                spilled = self._spill(i, payload)
                if spilled is not None:
                    kind, payload = "spill", spilled
            with self._cv:
                if self._closed:
                    self._claimed.discard(i)
                    self._cv.notify_all()
                    return
                if kind == "mem":
                    self._in_mem += 1
                self._done[i] = (kind, payload)
                self._claimed.discard(i)
                self._cv.notify_all()

    def _decode(self, i: int) -> Tuple[str, object]:
        from anovos_tpu_torch.data_ingest import data_ingest as di
        from anovos_tpu_torch.data_ingest.guard import IngestError

        f = self._files[i]
        t0 = time.perf_counter()
        try:
            # late module-attribute bind: tests monkeypatch read_host_frame
            # to count resume re-reads, and the pool must count identically
            df = di.read_host_frame([f], self._file_type, self._cfg)
            return "mem", df
        except IngestError as e:
            return "exc", e
        except BaseException as e:  # surfaced to the consumer in order
            return "exc", e
        finally:
            dt = time.perf_counter() - t0
            try:
                nbytes = os.path.getsize(f)
            except OSError:
                nbytes = 0
            if self._stats is not None:
                self._stats.add_decode(dt, nbytes)

    # -- spill tier --------------------------------------------------------
    def _spill(self, i: int, df) -> Optional[str]:
        """Stage a decoded frame on disk (exact pickle round trip); None
        on any failure — the frame then stays in memory."""
        try:
            if self._spill_dir is None:
                root = self._spill_root or tempfile.gettempdir()
                self._spill_dir = os.path.join(
                    root, f"anovos_spill_{os.getpid()}_{uuid.uuid4().hex[:8]}")
                os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(self._spill_dir, f"frame_{i}.pkl")
            df.to_pickle(path)
        except Exception:
            logger.exception("spill of frame %d failed; keeping in memory", i)
            return None
        if self._stats is not None:
            self._stats.add_spill()
        try:
            from anovos_tpu_torch.obs import get_metrics

            get_metrics().counter(
                "stream_spilled_frames_total",
                "decoded frames staged to the disk spill tier",
            ).inc()
        except Exception:
            pass
        if self._journal is not None:
            try:
                self._journal.append("chunk_spilled", file_index=i)
            except Exception:
                pass
        return path

    @staticmethod
    def _unspill(path: str):
        import pandas as pd

        try:
            return pd.read_pickle(path)
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- consumer ----------------------------------------------------------
    def cancel_skip_plan(self) -> None:
        """A decode disagreed with the prior run's row counts: chunk
        boundaries shifted, planned skips are void — decode everything
        still ahead."""
        with self._cv:
            if not self._plan_live:
                return
            self._plan_live = False
            self._skip_plan.clear()
            self._cv.notify_all()

    def fetch(self, fi: int, f: str):
        """Decoded frame for file index ``fi`` (consumer thread, called in
        strictly increasing ``fi`` order).  Raises what the guarded read
        raised."""
        t0 = time.perf_counter()
        inline = False
        with self._cv:
            self._consumed = fi + 1
            while True:
                if fi in self._done:
                    kind, payload = self._done.pop(fi)
                    if kind == "mem":
                        self._in_mem -= 1
                    self._cv.notify_all()
                    break
                if fi not in self._claimed:
                    # neither staged nor being decoded: no worker will
                    # ever produce it (skip-planned file after a plan
                    # cancel, workers already past it, or the pool's
                    # claim cursor exhausted) — claim + decode inline.
                    # Bumping the cursor is safe: the consumer runs in
                    # strictly increasing order, so every index below fi
                    # was already consumed or whole-file-skipped.
                    self._skip_plan.discard(fi)
                    self._next = max(self._next, fi + 1)
                    inline = True
                    kind, payload = None, None
                    break
                self._cv.wait(timeout=0.5)
        if inline:
            kind, payload = self._decode(fi)
            with self._cv:
                self._cv.notify_all()
        wait = time.perf_counter() - t0
        if self._stats is not None:
            self._stats.add_fetch_wait(wait)
        if kind == "spill":
            payload = self._unspill(payload)
            kind = "mem"
        if kind == "exc":
            raise payload
        return payload

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._done.clear()
            self._cv.notify_all()
        if self._spill_dir is not None:
            try:
                for name in os.listdir(self._spill_dir):
                    try:
                        os.unlink(os.path.join(self._spill_dir, name))
                    except OSError:
                        pass
                os.rmdir(self._spill_dir)
            except OSError:
                pass
            self._spill_dir = None
