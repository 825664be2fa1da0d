"""Observability of the port: the process-wide metrics registry
(``obs/metrics.py``).  The JAX package's tracer, flight recorder, device
profiler and ``@timed`` are not ported (ROADMAP.md Queue A item 6)."""

from anovos_tpu_torch.obs.metrics import Counter, Gauge, MetricsRegistry, get_metrics

__all__ = ["Counter", "Gauge", "MetricsRegistry", "get_metrics"]
