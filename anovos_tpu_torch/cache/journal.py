"""Append-only write-ahead journal (counterpart of
``anovos_tpu/cache/journal.py``).

One JSON line per event, ``{"event": ..., "t": ..., **fields}`` with
sorted keys.  The runner's ``obs/run_journal.jsonl`` records the node
cache's lifecycle: ``run_begin``, ``node_begin`` (a miss, about to
execute), ``node_commit`` (artifacts committed to the store),
``node_restored`` (a hit), ``node_failed``, ``run_end``, the ingest
guard's ``part_quarantined``, and the resilience records: ``node_retry``
(``kind`` tells a policy retry from the escalated-timeout and the
post-failover re-execution), ``node_degraded``, and ``backend_failover``
(the mid-run flip to the CPU: the committed frontier above this line is
what the rest of the run keeps).  The streaming checkpoints
(``ops/streaming.StreamCheckpoint``) write ``run_begin``, ``chunk_begin``,
``chunk_commit``, ``chunks_invalidated`` and ``chunk_spilled`` into their
own ``stream_journal.jsonl``; the continuum's state writes its own
(``continuum/state.py``).  Every append also lands in the flight
recorder's ring (``obs/flight.py``).

The journal is append-only across runs in the same output directory, so
a killed run's committed frontier is still on disk when ``--resume``
re-runs the config: resumed nodes hit the store (whose tmp+rename commit
is the durability point; the journal is the record of what committed and
when, and what a resume started from).  With a writer
(``shared.artifact_store.AsyncArtifactWriter``) the appends ride its queue
under ``obs:run_journal``, drained at the run's barrier; appends serialize
on a lock, so concurrent workers never interleave partial lines.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from anovos_tpu_torch.obs import flight

__all__ = ["RunJournal", "read_journal", "committed_fingerprints"]

JOURNAL_KEY = "obs:run_journal"


class RunJournal:
    def __init__(self, path: str, writer=None):
        self.path = os.path.abspath(path)
        self._writer = writer
        self._lock = threading.Lock()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def _append_line(self, line: str) -> None:
        with self._lock, open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()

    def append(self, event: str, **fields) -> None:
        rec = {"event": event, "t": round(time.time(), 3), **fields}
        line = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        flight.record("journal", event=event, **fields)
        if self._writer is not None:
            self._writer.submit(JOURNAL_KEY, self._append_line, line)
        else:
            self._append_line(line)


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


def committed_fingerprints(records: List[dict],
                           since_run: Optional[str] = None) -> List[str]:
    """Fingerprints with a commit or restore record (the resumable
    frontier), first occurrence order.  ``since_run`` restricts to the
    records at or after that run id's last ``run_begin``."""
    if since_run is not None:
        start = 0
        for i, r in enumerate(records):
            if r.get("event") == "run_begin" and r.get("run_id") == since_run:
                start = i
        records = records[start:]
    out, seen = [], set()
    for r in records:
        if r.get("event") in ("node_commit", "node_restored"):
            fp = r.get("fp", "")
            if fp and fp not in seen:
                seen.add(fp)
                out.append(fp)
    return out
