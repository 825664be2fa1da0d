"""Observability of the port (counterpart of ``anovos_tpu/obs``).

* **Tracing** (``obs.tracing``): a thread-safe :class:`Tracer` with
  nestable ``span()`` context managers and a Chrome-trace exporter (open
  the JSON in Perfetto or ``chrome://tracing``).  The DAG scheduler emits
  a span per node (worker lane, queue wait, deps), the ops emit
  first-call vs steady-state spans through :func:`timed`, and the async
  artifact writer spans its writes and its drain.
* **Metrics** (``obs.metrics``): the process-wide :class:`MetricsRegistry`
  of counters, gauges and histograms, with a deterministic JSON snapshot.
* **Run manifest** (``obs.manifest``): ``workflow.main`` writes
  ``obs/run_manifest.json`` next to the run's artifacts (config hash,
  executor mode, critical path, per-node spans, metrics snapshot, the
  devprof split); the report's Run Timings tab reads it.
* **Device-time attribution** (``obs.devprof``): each scheduler node's
  wall split into device, dispatch, transfer and host time, with exact
  h2d/d2h bytes.
* **Flight ring** (``obs.flight``) and **heartbeats** (``obs.telemetry``).

Recording is always on; trace-file export is gated by
``ANOVOS_TPU_TRACE=<path|1>``, attribution by ``ANOVOS_TPU_DEVPROF``, a
``torch.profiler`` trace of ``workflow.run`` by ``ANOVOS_PROFILE=<dir>``.
Not ported: the compile census (an XLA compile counter), the Prometheus
exposition, trace rotation, flight dumps, the telemetry HTTP plane and
the perf doctor (ROADMAP.md Queue A item 3), and ``record_cache_stats``
(item 1).
"""

from anovos_tpu_torch.obs import devprof, flight, telemetry
from anovos_tpu_torch.obs.manifest import (
    MANIFEST_VERSION,
    STABLE_TOP_FIELDS,
    build_manifest,
    config_hash,
    load_manifest,
    stable_view,
    write_manifest,
)
from anovos_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_metrics,
    memory_by_device,
    record_device_memory,
)
from anovos_tpu_torch.obs.timed import timed
from anovos_tpu_torch.obs.tracing import (
    Span,
    Tracer,
    get_tracer,
    span,
    trace_destination,
    write_chrome_trace,
)

__all__ = [
    "devprof",
    "flight",
    "telemetry",
    "memory_by_device",
    "MANIFEST_VERSION",
    "STABLE_TOP_FIELDS",
    "build_manifest",
    "config_hash",
    "load_manifest",
    "stable_view",
    "write_manifest",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_metrics",
    "record_device_memory",
    "timed",
    "Span",
    "Tracer",
    "get_tracer",
    "span",
    "trace_destination",
    "write_chrome_trace",
]
