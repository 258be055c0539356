"""The port's host planes: metrics, tracing, flight recorder, in-flight
tickets and partition heat.

Port of the core of ``mosaic_tpu.obs``:

* ``obs.metrics`` — process-global registry of counters, gauges and
  exponential-bucket histograms.
* ``obs.tracer`` — span timer feeding per-stage histograms and a span
  event ring; the raster provenance helpers; ``device_trace``, a
  ``torch.profiler`` Chrome trace.
* ``obs.context`` — query-scoped :class:`TraceContext`
  (contextvar-propagated; threads inherit it once a caller runs
  :func:`install_thread_propagation`).
* ``obs.recorder`` — the always-on flight recorder: a bounded
  structured event ring with ``dump()`` bundles and a dump on an
  unhandled error.
* ``obs.inflight`` — the in-flight query registry: per-query
  :class:`QueryTicket`, cooperative cancellation and deadlines raising
  :class:`QueryCancelled` at chunk boundaries.
* ``obs.heat`` — decayed per-partition access statistics of the chip
  store.

The memory and device planes, the profiler, accounting, time series
and SLOs are ROADMAP §A9b; the history, exporters, dashboard and fleet
are §A9c.  The tracer and registry are off by default and cost one
attribute check per instrumented site until enabled via
``MOSAIC_TPU_TRACE=1`` / ``MOSAIC_TPU_METRICS=1``, the
``mosaic.trace.enabled`` / ``mosaic.metrics.enabled`` conf keys, or
``tracer.enable()`` / ``metrics.enable()``.  The flight recorder is
**on** by default (``MOSAIC_TPU_RECORDER=0`` disables it) at the same
one-check quiescent cost.
"""

from .context import (TraceContext, current_trace, current_trace_id,
                      install_thread_propagation, link_traceparent,
                      make_traceparent, new_trace, parse_traceparent,
                      root_trace, traced)
from .heat import HeatTracker, heat
from .inflight import (InflightRegistry, QueryCancelled, QueryTicket,
                       checkpoint, inflight)
from .metrics import Histogram, MetricsRegistry, metrics
from .recorder import FlightRecorder, install_excepthook, recorder
from .tracer import (SpanEvent, Tracer, device_trace, record_command,
                     record_error, tracer)

__all__ = [
    "Histogram", "MetricsRegistry", "metrics",
    "Tracer", "tracer", "SpanEvent",
    "record_command", "record_error", "device_trace",
    "TraceContext", "new_trace", "root_trace", "current_trace",
    "current_trace_id", "traced", "install_thread_propagation",
    "parse_traceparent", "make_traceparent", "link_traceparent",
    "FlightRecorder", "recorder", "install_excepthook",
    "HeatTracker", "heat",
    "InflightRegistry", "QueryCancelled", "QueryTicket", "inflight",
    "checkpoint",
    "configure",
]

# Process-wide one-time install: an unhandled crash leaves a flight
# bundle.  The port starts no thread of its own, so the thread
# propagation is left to a caller that spawns workers under a trace.
install_excepthook()


def configure(config) -> None:
    """Apply a ``MosaicConfig``'s observability switches (idempotent).

    ``trace_enabled`` turns the tracer (and with it the registry) on;
    ``metrics_enabled`` turns just the registry on.  Neither flag ever
    turns an already-enabled instrument off — env vars and explicit
    ``enable()`` calls win."""
    if getattr(config, "trace_enabled", False):
        tracer.enable()
    if getattr(config, "metrics_enabled", False):
        metrics.enable()
