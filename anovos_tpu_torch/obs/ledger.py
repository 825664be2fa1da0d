"""The perf ledger's reader (counterpart of ``load`` and ``field_trends``
in ``tools/perf_ledger.py``, which imports the JAX package's diff engine
and so cannot be shared).

A ledger is a JSON-lines file, one bench entry a line (``source``,
``round``, ``backend``, ``backend_class``, ``fields``, ``regressions``,
...).  :func:`field_trends` gives one row a tracked field with a unicode
sparkline of one glyph a ledger entry, which the report's Perf Ledger tab
renders, and the perf doctor's ledger mode (``python -m
anovos_tpu_torch.obs.diffing --entry-baseline ... --entry-candidate ...``)
diffs two entries of it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["GAP_MARK", "TRACKED_FIELDS", "field_trends", "ledger_path", "load"]

LEDGER_ENV = "ANOVOS_PERF_LEDGER"

# field -> (direction, relative noise band): which way is better, and how
# far worse than its baseline a value may go before the gate flags it
TRACKED_FIELDS: Dict[str, Tuple[str, float]] = {
    "value": ("higher", 0.35),                        # PSI rows/s headline
    "psi_steady_rows_per_sec": ("higher", 0.35),
    "psi_steady_gbps": ("higher", 0.35),
    "e2e_cold_s": ("lower", 0.50),
    "e2e_warm_s": ("lower", 0.40),
    "e2e_warm_rows_per_sec_per_chip": ("higher", 0.40),
    "e2e_cold_compiles": ("lower", 0.15),
    "e2e_distinct_programs": ("lower", 0.15),
    "e2e_cold_compile_wall_s": ("lower", 0.50),
    "e2e_cached_wall_s": ("lower", 0.60),
    "e2e_incremental_wall_s": ("lower", 0.60),
    "e2e_chaos_overhead_s": ("lower", 0.80),
    "e2e_device_time_s": ("lower", 0.60),
    "e2e_dispatch_s": ("lower", 0.60),
    # multi-device concurrent executor (the MULTICHIP dryrun's executor
    # pass): measured node overlap on the mesh must not collapse back to
    # sequential-in-disguise, and the concurrent wall must hold its line
    "e2e_multidev_overlap": ("higher", 0.40),
    "e2e_multidev_wall_s": ("lower", 0.60),
    "e2e_multidev_seq_wall_s": ("lower", 0.60),
    # online serving (round 11): sustained QPS + request-latency tail from
    # the concurrent-client smoke load, and the bounded cold start the
    # persistent XLA cache buys.  Generous ±60% bands: the shared CI box
    # timeshares the 4 client threads with whatever else runs there.
    "e2e_serve_qps": ("higher", 0.60),
    "e2e_serve_p50_ms": ("lower", 0.60),
    "e2e_serve_p99_ms": ("lower", 0.60),
    "e2e_serve_cold_start_s": ("lower", 0.60),
    # out-of-core streaming (round 12): the prefetched whole-table pass
    # must hold its throughput, its window-bounded RSS ceiling, and its
    # decode/compute overlap.  ±60% walls (shared box), ±50% on the RSS
    # ceiling (allocator noise), ±40% on overlap share.
    "e2e_oocore_wall_s": ("lower", 0.60),
    "e2e_oocore_rows_per_s": ("higher", 0.60),
    "e2e_oocore_peak_rss_mb": ("lower", 0.50),
    "e2e_stream_overlap_pct": ("higher", 0.40),
    # continuum feed (round 13): per-day incremental fold wall and its
    # ratio to a from-scratch batch run (tiny walls on a shared box →
    # wide ±60% bands); the alert count is a correctness level — dropping
    # to zero from the expected shift-day alerts is a regression, so it
    # rides "higher" with the same generous band.
    "e2e_continuum_fold_s": ("lower", 0.60),
    "e2e_continuum_vs_batch_ratio": ("lower", 0.60),
    "e2e_continuum_alerts": ("higher", 0.60),
    # telemetry plane (round 14): the A/B overhead percentage hovers near
    # zero and is noise-dominated on a shared box, so its band is very
    # wide (the <1% acceptance bar is enforced by bench itself, loudly);
    # the scrape tail rides the usual shared-box latency band.
    "e2e_telemetry_overhead_pct": ("lower", 3.00),
    "e2e_scrape_p99_ms": ("lower", 0.60),
    # static analysis (graftcheck engine v2): the warm incremental re-scan
    # wall — the cost every tier-1 run pays once the cache is populated.
    # A very wide band (interpreter start + AST parse on a timeshared
    # box), but a blown cache shows up as a multiple, not a percentage.
    "e2e_graftcheck_incr_s": ("lower", 1.00),
}


def ledger_path() -> Optional[str]:
    """``ANOVOS_PERF_LEDGER``, or None when unset."""
    return os.environ.get(LEDGER_ENV) or None


def load(path: str) -> List[dict]:
    """All parseable entries of the ledger at ``path``, in file (append)
    order; a torn last line is skipped, a missing file gives []."""
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
                continue  # a torn tail from a killed append
    return out


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"
# explicit gap marker for an entry that does not carry the field: every
# trend string has one glyph PER LEDGER ENTRY, so sparklines stay aligned
# against run ids (silently skipping an entry shifted everything after it
# left — the HTML ledger tab was misattributing values to rounds)
GAP_MARK = "·"


def field_trends(entries: List[dict]) -> List[dict]:
    """Per-tracked-field trajectory rows (the ONE source for the CLI trend
    text and the HTML report's ledger tab): ``{field, trend (unicode
    sparkline, one glyph per ledger entry with ``·`` marking entries that
    lack the field), latest, min, max, n, gaps, better, noise_band}``,
    fields with fewer than two data points omitted."""
    rows: List[dict] = []
    for field in sorted({f for e in entries for f in (e.get("fields") or {})}):
        spec = TRACKED_FIELDS.get(field)
        if spec is None:
            continue
        pts: List[Optional[float]] = []
        for e in entries:
            v = (e.get("fields") or {}).get(field)
            pts.append(float(v) if isinstance(v, (int, float))
                       and not isinstance(v, bool) else None)
        vals = [v for v in pts if v is not None]
        if len(vals) < 2:
            continue
        lo, hi = min(vals), max(vals)
        span = (hi - lo) or 1.0
        spark = "".join(
            GAP_MARK if v is None
            else _SPARK_BLOCKS[int((v - lo) / span * (len(_SPARK_BLOCKS) - 1))]
            for v in pts)
        direction, band = spec
        rows.append({"field": field, "trend": spark, "latest": vals[-1],
                     "min": lo, "max": hi, "n": len(vals),
                     "gaps": len(pts) - len(vals),
                     "better": direction, "noise_band": f"{int(band * 100)}%"})
    return rows
