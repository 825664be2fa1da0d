"""Threshold-crossing alerts for the continuum feed (counterpart of
``anovos_tpu/continuum/alerts.py``).

Alerts are evaluated PER ARRIVAL — the newly-folded partition's own
sufficient-stat partial against the persisted drift model / quality
thresholds — because a one-day distribution shift dilutes to invisibility
inside a month of cumulative frequencies.  The cumulative artifacts still
re-finalize every step; the alert stream is the operator's early signal.

Each alert is one structured JSON object (``kind`` ∈ ``drift`` |
``quality_missing`` | ``quarantine``) carrying the metric, value,
threshold, partition, and a **flight-recorder context** — the tail of the
obs flight ring (``obs.flight.snapshot_events``): the WAL events, chaos
injections and quarantines leading up to the crossing.  Alerts append to
``<output>/obs/continuum_alerts.jsonl`` (one line per alert, obs/ subtree
— arrival cadence is run-varying by design, so the artifact parity gate
never sees them), journal as ``alert_emitted``, and count into
``continuum_alerts_total{kind=}``.

``ANOVOS_CONTINUUM_ALERTS=0`` disables emission wholesale.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["alerts_enabled", "evaluate_part", "quarantine_alert", "emit"]

_EMIT_LOCK = threading.Lock()
_FLIGHT_TAIL = 16           # ring events attached to each alert
_DEFAULT_MISSING_PCT = 0.5  # a partition majority-null on a column alerts


def alerts_enabled() -> bool:
    return os.environ.get("ANOVOS_CONTINUUM_ALERTS", "1") != "0"


def _flight_context() -> List[dict]:
    from anovos_tpu_torch.obs import flight

    # snapshot_events is total (lock + list copy; [] when disarmed)
    return flight.snapshot_events()[-_FLIGHT_TAIL:]


def evaluate_part(part_key: str, partials: Dict[str, Dict[str, np.ndarray]],
                  ctx, thresholds: Optional[dict] = None) -> List[dict]:
    """Alerts raised by ONE partition's partials.

    * **drift** — the partition's own frequencies against the persisted
      source model cross ``DriftSpec.threshold`` on any configured
      metric (the same ``_metrics_frame`` arithmetic as the cumulative
      artifact, so the alert and the artifact cannot disagree on a
      value);
    * **quality_missing** — a column's missing share within the
      partition crosses ``thresholds["missing_pct"]`` (default 0.5).
    """
    th = dict(thresholds or {})
    out: List[dict] = []

    drift_partial = partials.get("drift_target")
    if drift_partial is not None and ctx.drift is not None:
        from anovos_tpu_torch.continuum.sufficient import DriftTargetAccumulator
        from anovos_tpu_torch.drift_stability.drift_detector import _metrics_frame
        from anovos_tpu_torch.drift_stability.validations import check_distance_method

        methods = check_distance_method(ctx.drift.method_type)
        freq_p, freq_q = DriftTargetAccumulator.freqs(drift_partial, ctx)
        frame = _metrics_frame(freq_p, freq_q, sorted(set(freq_p) & set(freq_q)),
                               methods, ctx.drift.threshold)
        for _, r in frame[frame["flagged"] == 1].iterrows():
            metric = max(methods, key=lambda m: float(r[m]))
            out.append({
                "kind": "drift",
                "partition": part_key,
                "attribute": str(r["attribute"]),
                "metric": metric,
                "value": float(r[metric]),
                "threshold": float(ctx.drift.threshold),
                "all_metrics": {m: float(r[m]) for m in methods},
            })

    missing = partials.get("missing")
    if missing is not None:
        limit = float(th.get("missing_pct", _DEFAULT_MISSING_PCT))
        rows = max(int(missing["rows"]), 1)
        cols = [str(c) for c in np.asarray(missing.get("cols", ()))]
        valid = np.asarray(missing.get("valid", np.zeros(len(cols))), np.int64)
        for c, v in zip(cols, valid):
            pct = (rows - int(v)) / rows
            if pct >= limit:
                out.append({
                    "kind": "quality_missing",
                    "partition": part_key,
                    "attribute": c,
                    "metric": "missing_pct",
                    "value": round(pct, 4),
                    "threshold": limit,
                })
    return out


def quarantine_alert(part_key: str, reason: str) -> dict:
    """A corrupt partition was set aside — the data-plane alert (the
    degradation registry names it too, as ``ingest/<file>``, through the
    ingest guard)."""
    return {
        "kind": "quarantine",
        "partition": part_key,
        "metric": "rows_lost",
        "reason": reason[:300],
    }


def emit(alerts: List[dict], obs_dir: str, journal=None) -> List[dict]:
    """Stamp, attach flight context, append to the alert stream, journal
    and meter.  Returns the emitted records (empty when disabled)."""
    if not alerts or not alerts_enabled():
        return []
    os.makedirs(obs_dir, exist_ok=True)
    path = os.path.join(obs_dir, "continuum_alerts.jsonl")
    emitted = []
    with _EMIT_LOCK, open(path, "a") as f:
        for a in alerts:
            rec = {"t_unix": round(time.time(), 3), **a,
                   "flight": _flight_context()}
            f.write(json.dumps(rec, sort_keys=True, default=str,
                               separators=(",", ":")) + "\n")
            emitted.append(rec)
        f.flush()
        os.fsync(f.fileno())
    for rec in emitted:
        logger.warning("continuum alert [%s] partition=%s attribute=%s %s=%s",
                       rec["kind"], rec.get("partition"), rec.get("attribute"),
                       rec.get("metric"), rec.get("value"))
        if journal is not None:
            journal.append("alert_emitted", kind=rec["kind"],
                           part=rec.get("partition"),
                           attribute=rec.get("attribute"),
                           metric=rec.get("metric"), value=rec.get("value"))
    from anovos_tpu_torch.obs import get_metrics

    counter = get_metrics().counter(
        "continuum_alerts_total",
        "threshold-crossing alerts emitted by the continuum feed")
    for rec in emitted:
        counter.inc(kind=rec["kind"])
    return emitted
