"""Observability of the port: the process-wide metrics registry
(``obs/metrics.py``), the flight recorder's event ring (``obs/flight.py``)
and service heartbeats (``obs/telemetry.py``).  The JAX package's tracer,
device profiler and ``@timed`` (ROADMAP.md Queue A item 1), and its flight
dumps and telemetry HTTP plane (item 4) are not ported."""

from anovos_tpu_torch.obs.metrics import Counter, Gauge, MetricsRegistry, get_metrics

__all__ = ["Counter", "Gauge", "MetricsRegistry", "get_metrics"]
