"""The 30-day continuum feed and its two legs (the port's copy of
``tools/continuum_bench.py``'s builder and legs, which the ``feed-30d``
scenario of ``resilience/scenarios.py`` gates).

The feed is a month of daily parquet partitions with three planted
events: schema drift on day 15 (a ``late_feature`` column appears), a
corrupt day 20 (its file is garbage bytes) and a distribution shift on
day 25 (``amount``'s mean moves by half a standard deviation).
:func:`run_feed` folds it twice through ``continuum.watcher.step``:

* the incremental leg copies one day at a time into its feed directory
  and takes one step per arrival, recording each step's fold wall;
* the batch leg takes one step over the whole union from empty state.

Both legs run the same sufficient-statistics code, so the byte parity of
their artifact trees is the order-insensitivity of the fold, and the
corrupt day must be quarantined by both.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import tempfile
import time

SHIFT_DAY = 25
CORRUPT_DAY = 20
SCHEMA_DRIFT_DAY = 15


def build_feed_30d(root: str, days: int = 30, rows_per_day: int = 2000, seed: int = 13) -> str:
    """The 30-day feed under ``root``: one parquet per day with the three
    planted events.  Skips the build when ``root`` already holds files."""
    import numpy as np
    import pandas as pd

    if os.path.isdir(root) and os.listdir(root):
        return root
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(1, days + 1):
        shift = 6.0 if i >= SHIFT_DAY else 0.0
        df = pd.DataFrame({
            "amount": rng.normal(100.0 + shift, 12.0, rows_per_day),
            "score": rng.exponential(3.0, rows_per_day),
            "segment": rng.choice(["retail", "corp", "gov"], rows_per_day, p=[0.6, 0.3, 0.1]),
        })
        if i >= SCHEMA_DRIFT_DAY:  # schema drift mid-month: a new column
            df["late_feature"] = rng.normal(0.0, 1.0, rows_per_day)
        path = os.path.join(root, f"day-{i:02d}.parquet")
        df.to_parquet(path, index=False)
        if i == CORRUPT_DAY:  # one corrupt day: not parquet at all
            with open(path, "wb") as f:
                f.write(b"\x00CORRUPTED-DAY\x00" * 256)
    return root


def feed_config(workdir: str, tag: str, feed_dir: str):
    """The continuum config of one leg: the feed in ``feed_dir``, state and
    artifacts under ``workdir/tag``, PSI drift against day 1."""
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig

    return ContinuumConfig.from_dict({
        "dataset_path": feed_dir,
        "state_dir": os.path.join(workdir, tag, "state"),
        "output_path": os.path.join(workdir, tag, "out"),
        "drift": {"baseline": "day-01*", "threshold": 0.2},
    }, base_dir=workdir)


def run_feed(days: int = 30, rows_per_day: int = 2000, workdir: str = None) -> dict:
    """The incremental and the batch leg over the feed built under
    ``workdir/alldays``; returns the ``continuum_*`` fields of the legs
    (walls, day 2's and the last day's fold, parity, both quarantine lists,
    the first day on or after :data:`SHIFT_DAY` that alerted)."""
    from anovos_tpu_torch.continuum.watcher import step
    from anovos_tpu_torch.data_ingest import guard
    from anovos_tpu_torch.resilience.scenarios import tree_hash

    workdir = workdir or tempfile.mkdtemp(prefix="anovos_continuum_feed_")
    src = build_feed_30d(os.path.join(workdir, "alldays"), days=days, rows_per_day=rows_per_day)
    day_files = sorted(os.listdir(src))

    # the incremental leg: one arrival a day
    inc_cfg = feed_config(workdir, "inc", os.path.join(workdir, "inc", "feed"))
    os.makedirs(inc_cfg.dataset_path, exist_ok=True)
    guard.reset()
    fold_walls = []
    alerts = 0
    shift_alert_day = None
    t_inc = time.monotonic()
    for i, fn in enumerate(day_files, start=1):
        shutil.copy2(os.path.join(src, fn), os.path.join(inc_cfg.dataset_path, fn))
        s = step(inc_cfg)
        fold_walls.append(s["fold_wall_s"])
        alerts += s["alerts"]
        if s["alerts"] and i >= SHIFT_DAY and shift_alert_day is None:
            shift_alert_day = i
    inc_wall = round(time.monotonic() - t_inc, 3)
    with open(os.path.join(inc_cfg.state_dir, "state_manifest.json")) as f:
        inc_quar = sorted(k for k, e in json.load(f)["parts"].items() if e.get("quarantined"))

    # the batch leg: the union, one step from empty state
    bat_cfg = feed_config(workdir, "bat", src)
    guard.reset()
    t_bat = time.monotonic()
    sb = step(bat_cfg)
    batch_wall = round(time.monotonic() - t_bat, 3)

    parity = tree_hash(inc_cfg.output_path) == tree_hash(bat_cfg.output_path)
    med_fold = round(statistics.median(fold_walls), 4)
    day2 = fold_walls[1] if len(fold_walls) > 1 else fold_walls[0]
    day_last = fold_walls[-1]
    return {
        "e2e_continuum_fold_s": med_fold,
        "e2e_continuum_vs_batch_ratio": round(med_fold / max(batch_wall, 1e-9), 4),
        "e2e_continuum_alerts": alerts,
        "continuum_days": days,
        "continuum_rows_per_day": rows_per_day,
        "continuum_incremental_wall_s": inc_wall,
        "continuum_batch_wall_s": batch_wall,
        "continuum_day2_fold_s": round(day2, 4),
        "continuum_day30_fold_s": round(day_last, 4),
        "continuum_day30_vs_day2": round(day_last / max(day2, 1e-9), 3),
        "continuum_parity": parity,
        "continuum_quarantined": inc_quar,
        "continuum_batch_quarantined": sorted(sb["quarantined"]),
        "continuum_shift_alert_day": shift_alert_day,
        "workdir": workdir,
    }
