"""``anovos_tpu_torch.cache``: content-addressed incremental recompute
(counterpart of ``anovos_tpu/cache``).

The workflow is a config-driven DAG re-run constantly with small config
deltas.  Each scheduler node declares the resources it reads and writes,
so its artifacts are a pure function of (input fingerprint, config slice,
code version, upstream fingerprints): a cache key.  Four pieces:

* **fingerprint**: canonical config-slice hashing, the audited
  ``KNOWN_ENV_KNOBS`` list, dataset and per-node fingerprints folded over
  RAW edges;
* **capture**: per-node artifact recording (a thread-local recorder and a
  write-mode ``open()`` hook), so a miss knows which files it created;
* **store**: the content-addressed on-disk store (atomic tmp+rename
  commits, LRU eviction, ``python -m anovos_tpu_torch.cache.gc``);
* **journal**: the append-only ``obs/run_journal.jsonl`` that lets
  ``--resume`` pick up a killed run's committed frontier.

Opt-in through ``ANOVOS_TPU_CACHE=<dir>`` (``python -m anovos_tpu_torch
... --resume`` defaults it to ``.anovos_cache``).  The streaming
checkpoints and the continuum's snapshots use the journal and the store
too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from anovos_tpu_torch.cache import capture
from anovos_tpu_torch.cache.fingerprint import (
    KNOWN_ENV_KNOBS,
    base_material,
    canonical,
    dataset_fingerprint,
    digest,
    env_fingerprint,
    node_fingerprint,
)
from anovos_tpu_torch.cache.journal import RunJournal, committed_fingerprints, read_journal
from anovos_tpu_torch.cache.store import CacheStore, cache_root, enabled

__all__ = [
    "KNOWN_ENV_KNOBS",
    "NodeCachePolicy",
    "CacheStore",
    "RunJournal",
    "base_material",
    "cache_root",
    "canonical",
    "capture",
    "committed_fingerprints",
    "dataset_fingerprint",
    "digest",
    "enabled",
    "env_fingerprint",
    "node_fingerprint",
    "read_journal",
]


@dataclass
class NodeCachePolicy:
    """What the scheduler needs to cache one node.

    ``key_material`` is the node-local fingerprint part (run base + name
    + config slice + writes); the scheduler folds RAW-dep fingerprints on
    top at registration.  ``flush(keys)`` blocks until the node's queued
    async writes have landed (the commit barrier).  ``payload_write(dir)``
    serializes non-file state (a spine node's output df version) into the
    store's payload dir at commit; ``on_hit(payload_dir)`` re-creates that
    state on restore (and releases whatever the skipped body would have
    released)."""

    key_material: str
    flush: Optional[Callable] = None
    payload_write: Optional[Callable[[str], None]] = None
    on_hit: Optional[Callable[[Optional[str]], None]] = None
