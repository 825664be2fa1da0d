"""Process-wide metrics registry: counters, gauges, histograms (counterpart
of ``anovos_tpu/obs/metrics.py``).

The pipeline's quantitative signals in one place: node wall time, queue
wait, rows ingested, bytes written, h2d/d2h transfer bytes, device-memory
high-water marks, op first-call vs steady-state walls.  Stdlib-only,
thread-safe, and cheap enough to stay always-on: one lock acquisition and
a float add per observation.  ``snapshot()`` gives a deterministic
JSON-able dict (sorted metric names, sorted label series) that the run
manifest embeds.

Labels are kwargs at observation time (``counter.inc(1, block="ETL")``);
each distinct label combination is an independent series.  The JAX
package's Prometheus text exposition and ``record_cache_stats`` wait for
their first readers, the live plane and the node cache (ROADMAP.md Queue A
items 3 and 1).
"""

from __future__ import annotations

import bisect
import sys
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "get_metrics",
           "memory_by_device", "record_device_memory"]

# wall-time histogram bounds (seconds): sub-ms ops through multi-minute
# blocks; one shared default keeps every duration metric comparable
_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    30.0, 60.0, 300.0)


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
        self._series: "Dict[Tuple[Tuple[str, str], ...], object]" = {}

    def series(self) -> dict:
        """``{label_string: value}`` snapshot (values are plain numbers or,
        for histograms, dicts)."""
        with self._lock:
            return {_label_str(k): self._export(v) for k, v in sorted(self._series.items())}

    def _export(self, v):
        return round(float(v), 6)


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


class Histogram(_Instrument):
    """Cumulative-bucket histogram with count/sum/min/max per series."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets: Optional[Tuple[float, ...]] = None):
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(buckets or _DEFAULT_BUCKETS)

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = {
                    "count": 0, "sum": 0.0,
                    "min": float("inf"), "max": float("-inf"),
                    "bucket_counts": [0] * (len(self.buckets) + 1),
                }
            s["count"] += 1
            s["sum"] += float(value)
            s["min"] = min(s["min"], float(value))
            s["max"] = max(s["max"], float(value))
            s["bucket_counts"][bisect.bisect_left(self.buckets, value)] += 1

    def _export(self, v):
        return {
            "count": v["count"],
            "sum": round(v["sum"], 6),
            "min": round(v["min"], 6),
            "max": round(v["max"], 6),
            "buckets": [list(b) for b in zip(
                [str(b) for b in self.buckets] + ["+Inf"], v["bucket_counts"])],
        }


class MetricsRegistry:
    """Name → instrument map with get-or-create registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, _Instrument]" = OrderedDict()

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._metrics.get(name)
            if inst is None:
                inst = self._metrics[name] = cls(name, *args)
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as {inst.kind}, "
                                f"requested {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(name, Histogram, help, buckets)

    def snapshot(self) -> dict:
        """Deterministic dict: sorted names, sorted series, rounded floats."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: {"type": inst.kind, "help": inst.help, "series": inst.series()}
                for name, inst in sorted(metrics)}

    def reset(self) -> None:
        """Drop every instrument (``workflow.main``: per-run accounting)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


def memory_by_device() -> Dict[str, dict]:
    """``{"cuda:<i>": torch.cuda.memory_stats(i)}`` for every visible card.

    Empty when the runtime is the CPU (or unset), when torch is not loaded,
    or when CUDA is not initialised yet: this never initialises a CUDA
    context, as the JAX package's never initialises a backend.  The stats
    are the caching allocator's, so ``bytes_in_use`` is
    ``allocated_bytes.all.current`` and ``peak_bytes_in_use`` its peak
    (tensors, not the allocator's reserved segments).  Never raises."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        from anovos_tpu_torch.shared.runtime import peek_runtime

        rt = peek_runtime()
        if rt is None or rt.device.type != "cuda" or not torch.cuda.is_initialized():
            return {}
        n = torch.cuda.device_count()
    except Exception:
        return {}
    out: Dict[str, dict] = {}
    for i in range(n):
        try:
            raw = torch.cuda.memory_stats(i)
        except Exception:
            continue
        if raw:
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
            }
    return out


def record_device_memory(registry: Optional[MetricsRegistry] = None) -> None:
    """Record device-memory usage and high-water marks for every visible
    card: per-device labelled gauges plus the sum over all of them (the
    JAX package's ``device_mesh_*`` gauges).  Records nothing on a CPU
    runtime.  Never raises."""
    per_dev = memory_by_device()
    if not per_dev:
        return
    reg = registry or _REGISTRY
    mesh_in_use = 0.0
    for label, stats in sorted(per_dev.items()):
        in_use = stats.get("bytes_in_use")
        if in_use is not None:
            mesh_in_use += float(in_use)
            reg.gauge("device_bytes_in_use", "current device memory allocation"
                      ).set(float(in_use), device=label)
            reg.gauge("device_bytes_high_water", "max observed device memory allocation"
                      ).set_max(float(in_use), device=label)
        peak = stats.get("peak_bytes_in_use")
        if peak is not None:
            reg.gauge("device_peak_bytes", "allocator-reported peak device memory"
                      ).set_max(float(peak), device=label)
    reg.gauge("device_mesh_bytes_in_use",
              "current device memory allocation summed over all local devices"
              ).set(mesh_in_use)
    reg.gauge("device_mesh_bytes_high_water",
              "max observed mesh-wide device memory allocation"
              ).set_max(mesh_in_use)
