"""Where the ``feed-30d`` incremental leg's fold wall goes, day by day.

    python -m anovos_tpu_torch.resilience.feed_probe [--reps 4] [--days 30]
        [--rows-per-day 500] [--device cuda|cpu] [--json PATH]

Runs the incremental leg of :func:`~anovos_tpu_torch.resilience.feed.run_feed`
(the 30-day feed, one ``continuum.watcher.step`` per arriving day) ``reps``
times, each in a fresh temporary directory, and splits each day's fold wall
(the step's ``fold_wall_s``, which the ``feed-30d`` gate compares) into:

* ``fetch``: waiting on the decode of the day's part;
* ``partials``: the device work of the fold (``ContinuumState.part_partials``);
* ``commit``: the npz, the journal line and the manifest
  (``ContinuumState.commit_part``);
* ``fsync``: the fsyncs inside the fold (the npz's, part of ``commit``).

Each rep prints day 2's and the last day's fold, their ratio (the gate's
``continuum_day30_vs_day2``), the median and the slowest fold, and every fold
above 1.3x the median with its split, in milliseconds.  The instruments are
put back when the leg ends.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, Iterator, List

SPIKE = 1.3


@contextlib.contextmanager
def instrumented(acc: Dict[str, float]) -> Iterator[None]:
    """Add the seconds spent in each split of a fold to ``acc`` while in
    the block; the fsyncs are counted only inside a fold."""
    from anovos_tpu_torch.continuum import state, watcher
    from anovos_tpu_torch.data_ingest import prefetch

    in_fold = [False]
    saved = [(os, "fsync", os.fsync), (watcher, "_fold_keys", watcher._fold_keys),
             (state.ContinuumState, "part_partials", state.ContinuumState.part_partials),
             (state.ContinuumState, "commit_part", state.ContinuumState.commit_part),
             (prefetch.DecodePool, "fetch", prefetch.DecodePool.fetch)]

    def timed(fn, key, fold=False):
        def call(*args, **kwargs):
            if key == "fsync" and not in_fold[0]:
                return fn(*args, **kwargs)
            if fold:
                in_fold[0] = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
                if fold:
                    in_fold[0] = False
        return call

    os.fsync = timed(os.fsync, "fsync")
    watcher._fold_keys = timed(watcher._fold_keys, "folds", fold=True)
    state.ContinuumState.part_partials = timed(state.ContinuumState.part_partials, "partials")
    state.ContinuumState.commit_part = timed(state.ContinuumState.commit_part, "commit")
    prefetch.DecodePool.fetch = timed(prefetch.DecodePool.fetch, "fetch")
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def incremental_leg(days: int, rows_per_day: int, workdir: str) -> List[dict]:
    """One incremental leg over the feed built under ``workdir``: for each
    day, its fold wall and the split of it (milliseconds)."""
    from anovos_tpu_torch.continuum.watcher import step
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.obs import flight
    from anovos_tpu_torch.resilience import feed

    src = feed.build_feed_30d(os.path.join(workdir, "alldays"), days=days, rows_per_day=rows_per_day)
    cfg = feed.feed_config(workdir, "inc", os.path.join(workdir, "inc", "feed"))
    os.makedirs(cfg.dataset_path, exist_ok=True)
    armed = flight.enabled()
    guard.reset()
    rows = []
    try:
        for day, name in enumerate(sorted(os.listdir(src)), start=1):
            shutil.copy2(os.path.join(src, name), os.path.join(cfg.dataset_path, name))
            acc: Dict[str, float] = {}
            with instrumented(acc):
                s = step(cfg)
            rows.append({"day": day, "fold": round(s["fold_wall_s"] * 1e3, 2),
                         **{k: round(acc.get(k, 0.0) * 1e3, 2) for k in ("fetch", "partials", "commit", "fsync")}})
    finally:
        guard.reset()
        if not armed:
            flight.reset()
    return rows


def summary(rows: List[dict]) -> dict:
    """Day 2's and the last day's fold, their ratio, the median and the
    slowest fold, and the folds over :data:`SPIKE` x the median (the first
    day, which fits the drift model, and a quarantined day, which folds
    nothing, are left out of the median and the spikes)."""
    day2, last = rows[1]["fold"], rows[-1]["fold"]
    usual = [r for r in rows[1:] if r["partials"] > 0]
    med = statistics.median(r["fold"] for r in usual)
    return {"day2_ms": day2, "last_ms": last, "ratio": round(last / max(day2, 1e-9), 3), "median_ms": med,
            "max_ms": max(r["fold"] for r in usual), "spikes": [r for r in usual if r["fold"] > SPIKE * med]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--days", type=int, default=30)
    ap.add_argument("--rows-per-day", type=int, default=500)
    ap.add_argument("--device", default="cuda", help="the runtime's device (default cuda; cpu to run there)")
    ap.add_argument("--json", help="write every rep's rows here")
    ns = ap.parse_args(argv)

    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime(ns.device)
    reps = []
    for rep in range(ns.reps):
        workdir = tempfile.mkdtemp(prefix="anovos_feed_probe_")
        try:
            rows = incremental_leg(ns.days, ns.rows_per_day, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        s = summary(rows)
        print(f"rep {rep}: day 2 {s['day2_ms']} ms, day {ns.days} {s['last_ms']} ms ({s['ratio']}x); median "
              f"{s['median_ms']} ms, slowest {s['max_ms']} ms", flush=True)
        for r in s["spikes"]:
            print("  spike " + json.dumps(r), flush=True)
        reps.append(rows)
    if ns.json:
        with open(ns.json, "w") as f:
            json.dump(reps, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
