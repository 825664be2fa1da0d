"""Per-node artifact capture: which files did THIS node create?
(counterpart of ``anovos_tpu/cache/capture.py``)

The cache must restore exactly the files a node produced, but artifact
writes are scattered (pandas ``to_csv``, ``json.dump`` chart objects,
pyarrow part files, model blobs).  Capture uses two mechanisms:

* a **thread-local recorder**: the scheduler pushes a :class:`Recorder`
  around the node body; anything that runs on that thread (or on an
  async-writer thread carrying a propagated recorder) can book paths via
  :func:`record_artifact` and async-write keys via :func:`record_key`;
* an **open() hook**: while any recorder is installed, ``builtins.open``
  is wrapped so every WRITE-mode open on a recording thread books its
  path automatically — this catches ``to_csv``/``json.dump``/plotly
  writers without touching each call site.  Writers that bypass the
  builtin book explicitly at their call sites: every part that
  ``data_ingest.write_dataset`` writes (pyarrow's C++ CSV writer among
  them), and the ``np.savez`` model files, which zipfile opens through
  ``io.open``.

Recorders are per-node, so concurrent scheduler workers capture
independently; ``AsyncArtifactWriter.submit`` snapshots the submitting
thread's recorder and re-enters it on the writer thread, keeping queued
writes attributed to the node that queued them.

Everything here is stdlib-only and inert (zero per-open overhead) until
:func:`install_open_hook` is called — i.e. unless ``ANOVOS_TPU_CACHE``
is set.
"""

from __future__ import annotations

import builtins
import os
import threading
from contextlib import contextmanager
from typing import Optional, Set

__all__ = [
    "Recorder",
    "current",
    "recording",
    "record_artifact",
    "record_key",
    "install_open_hook",
    "uninstall_open_hook",
]

_LOCAL = threading.local()
_HOOK_LOCK = threading.Lock()
_HOOK_DEPTH = 0
_ORIG_OPEN = None

_WRITE_MODE_CHARS = frozenset("wax+")


class Recorder:
    """One node's captured effects: created file paths + submitted async-
    writer keys.  Thread-safe — the node thread and writer threads book
    into the same recorder concurrently.

    ``appended`` is the subset of ``paths`` first seen through an
    append-mode open: those files carried pre-existing content, so the
    scheduler's retry path must NOT unlink them when discarding a failed
    attempt's partial artifacts (deleting an appended-to metrics CSV
    would destroy prior-run data, a worse outcome than the double-append
    it is avoiding)."""

    __slots__ = ("paths", "keys", "appended", "_lock")

    def __init__(self):
        self.paths: Set[str] = set()
        self.keys: Set[str] = set()
        self.appended: Set[str] = set()
        self._lock = threading.Lock()

    def add_path(self, path, mode: str = "w") -> None:
        try:
            p = os.path.abspath(os.fspath(path))
        except TypeError:  # non-path file argument (fd int, buffer)
            return
        with self._lock:
            self.paths.add(p)
            if "a" in mode:
                self.appended.add(p)

    def discardable_paths(self) -> Set[str]:
        """Paths safe to unlink when a failed attempt retries: everything
        this attempt created, minus append-mode files (pre-existing
        content) — re-execution overwrites write-mode files anyway."""
        with self._lock:
            return self.paths - self.appended

    def add_key(self, key: str) -> None:
        with self._lock:
            self.keys.add(str(key))


def current() -> Optional[Recorder]:
    """The recorder active on THIS thread, if any."""
    return getattr(_LOCAL, "recorder", None)


@contextmanager
def recording(rec: Optional[Recorder]):
    """Bind ``rec`` as this thread's recorder for the block (``None`` is a
    no-op passthrough, so call sites need no conditional)."""
    if rec is None:
        yield None
        return
    prev = getattr(_LOCAL, "recorder", None)
    _LOCAL.recorder = rec
    try:
        yield rec
    finally:
        _LOCAL.recorder = prev


def record_artifact(path) -> None:
    """Book one created file into the active recorder (no-op otherwise).
    The explicit API for writers the open() hook cannot see (pyarrow)."""
    rec = current()
    if rec is not None:
        rec.add_path(path)


def record_key(key: str) -> None:
    """Book an async-writer key so the commit barrier can wait on it."""
    rec = current()
    if rec is not None:
        rec.add_key(key)


def _hooked_open(file, mode="r", *args, **kwargs):
    f = _ORIG_OPEN(file, mode, *args, **kwargs)
    if _WRITE_MODE_CHARS.intersection(mode):
        rec = current()
        if rec is not None and not isinstance(file, int):
            rec.add_path(file, mode)
    return f


def install_open_hook() -> None:
    """Wrap ``builtins.open`` (refcounted; idempotent per caller pair).

    The original ``open`` is captured ONCE, ever, and never re-captured:
    if another tool (coverage, pyfakefs) wrapped ``builtins.open`` on top
    of the hook and is still installed, re-capturing would make the hook
    delegate into a chain that ends back at itself.  With the chain
    intact the hook still sees every open (it sits downstream of the
    foreign wrapper); a foreign tool that REPLACED ``open`` outright is
    logged — capture could then miss its writes."""
    global _HOOK_DEPTH, _ORIG_OPEN
    with _HOOK_LOCK:
        if _HOOK_DEPTH == 0:
            if _ORIG_OPEN is None:
                _ORIG_OPEN = builtins.open
                builtins.open = _hooked_open
            elif builtins.open is _ORIG_OPEN:
                builtins.open = _hooked_open
            elif builtins.open is not _hooked_open:
                import logging

                logging.getLogger(__name__).warning(
                    "builtins.open was re-bound by another tool; artifact "
                    "capture rides the existing hook chain and may miss "
                    "writes routed around it")
        _HOOK_DEPTH += 1


def uninstall_open_hook() -> None:
    global _HOOK_DEPTH, _ORIG_OPEN
    with _HOOK_LOCK:
        if _HOOK_DEPTH == 0:
            return
        _HOOK_DEPTH -= 1
        if _HOOK_DEPTH == 0 and _ORIG_OPEN is not None:
            if builtins.open is _hooked_open:
                builtins.open = _ORIG_OPEN
            # else: someone re-patched ON TOP of the hook (coverage tools,
            # pyfakefs) and captured _hooked_open as their downstream.
            # Either way _ORIG_OPEN stays set: the hook (or the foreign
            # chain through it) keeps delegating, and a later install
            # must never re-capture a chain that contains _hooked_open.
