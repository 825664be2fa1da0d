"""Append-only write-ahead journal (counterpart of
``anovos_tpu/cache/journal.py`` ``RunJournal`` and ``read_journal``).

One JSON line per event, ``{"event": ..., "t": ..., **fields}`` with
sorted keys.  The streaming checkpoints (``ops/streaming.StreamCheckpoint``)
write ``run_begin``, ``chunk_begin``, ``chunk_commit``,
``chunks_invalidated`` and ``chunk_spilled`` into their own
``stream_journal.jsonl``; the ingest guard adds ``part_quarantined`` when
a journal is attached; the continuum's state writes its own
(``continuum/state.py``).  Every append also lands in the flight
recorder's ring (``obs/flight.py``).  The journal is the record of what
committed and when; the durability point is each checkpoint file's
tmp+rename.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List

from anovos_tpu_torch.obs import flight

__all__ = ["RunJournal", "read_journal"]


class RunJournal:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def append(self, event: str, **fields) -> None:
        rec = {"event": event, "t": round(time.time(), 3), **fields}
        line = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        flight.record("journal", event=event, **fields)
        # appends serialize on the lock, so concurrent decode workers never
        # interleave partial lines
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()


def read_journal(path: str) -> List[dict]:
    """All parseable records (a torn final line from a kill is skipped)."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
