"""Process-wide metrics registry: counters and gauges (counterpart of
``anovos_tpu/obs/metrics.py``).

The ingest guard, the prefetch pool, the streaming passes and
``read_dataset`` book their counters and gauges here:
``quarantined_parts_total``, ``rows_ingested_total``,
``stream_inflight_high_water`` and the others.  Stdlib-only, thread-safe,
and cheap enough to stay always-on: one lock acquisition and a float add
per observation.  ``snapshot()`` gives a deterministic JSON-able dict
(sorted metric names, sorted label series).

Labels are kwargs at observation time (``counter.inc(1, block="ETL")``);
each distinct label combination is an independent series.  The JAX
package's histograms and text exposition have no reader in the port yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

__all__ = ["Counter", "Gauge", "MetricsRegistry", "get_metrics"]


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition-format label-value escaping (backslash,
    double-quote, newline), as the JAX package's snapshot writes them."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: "Dict[Tuple[Tuple[str, str], ...], float]" = {}

    def series(self) -> dict:
        """``{label_string: value}`` snapshot."""
        with self._lock:
            return {_label_str(k): round(float(v), 6) for k, v in sorted(self._series.items())}


class Counter(_Instrument):
    """Monotonically increasing sum per label series."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Instrument):
    """Last-set value per label series; ``set_max`` keeps a high-water mark."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def set_max(self, value: float, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            prev = self._series.get(k)
            if prev is None or value > prev:
                self._series[k] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            v = self._series.get(_label_key(labels))
            return None if v is None else float(v)


class MetricsRegistry:
    """Name → instrument map with get-or-create registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, _Instrument]" = OrderedDict()

    def _get(self, name: str, cls, help: str):
        with self._lock:
            inst = self._metrics.get(name)
            if inst is None:
                inst = self._metrics[name] = cls(name, help)
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as {inst.kind}, "
                                f"requested {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def snapshot(self) -> dict:
        """Deterministic dict: sorted names, sorted series, rounded floats."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: {"type": inst.kind, "help": inst.help, "series": inst.series()}
                for name, inst in sorted(metrics)}

    def reset(self) -> None:
        """Drop every instrument (per-run accounting)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY
