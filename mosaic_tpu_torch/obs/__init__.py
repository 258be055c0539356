"""The port's host planes: metrics, tracing, flight recorder, in-flight
tickets, partition heat, and the memory and device planes.

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
* ``obs.timeseries`` — bounded per-metric time series and the
  :class:`Sampler` (``mosaic.obs.sample.ms``) that feeds them, folds
  devices, evaluates SLOs and writes the spool.
* ``obs.slo`` — declarative objectives with multi-window burn rates.
* ``obs.jaxmon`` — device memory watermarks from ``torch.cuda`` (the
  JAX package's compile listener has no counterpart: no jit, C14).
* ``obs.memwatch`` — the live device-buffer ledger, the memory budget
  and the leak sentinel.
* ``obs.devicemon`` — per-device busy time, rows and memory.
* ``obs.profiler`` — the sampling host profiler and the kernel ledger.
* ``obs.accounting`` — per-principal meters and the audit log.
* ``obs.spool`` / ``obs.fleet`` — the per-process telemetry spool and
  the aggregator that merges N spools into one exact fleet view
  (counter sums, fresh-worker gauge max, bucket-wise histograms), with
  stale-worker degrade, fleet SLO evaluation and cross-process trace
  stitching.
* ``obs.history`` — the durable workload history: one record per
  completed query in rotating on-disk segments under
  ``mosaic.history.dir``, compacted into exact per-window summaries.
* ``obs.chrometrace`` — Perfetto-loadable JSON of the host spans.
* ``obs.openmetrics`` / ``obs.dashboard`` — the Prometheus text
  exposition, its ``serve_metrics(port)`` scrape endpoint, and the ops
  dashboard (``serve_dashboard(port)``).

The tracer and registry are off by default and cost one
attribute check per instrumented site until enabled via
``MOSAIC_TPU_TRACE=1`` / ``MOSAIC_TPU_METRICS=1``, the
``mosaic.trace.enabled`` / ``mosaic.metrics.enabled`` conf keys, or
``tracer.enable()`` / ``metrics.enable()``.  The flight recorder is
**on** by default (``MOSAIC_TPU_RECORDER=0`` disables it) at the same
one-check quiescent cost.
"""

import os as _os

from .accounting import (AuditLog, PrincipalMeter, accounted, audit,
                         complete, meter)
from .chrometrace import chrome_trace_events, export_chrome_trace
from .context import (TraceContext, current_trace, current_trace_id,
                      install_thread_propagation, link_traceparent,
                      make_traceparent, new_trace, parse_traceparent,
                      root_trace, traced)
from .dashboard import serve_dashboard
from .devicemon import DeviceMonitor, devicemon, mesh_device_keys
from .fleet import (FleetAggregator, FleetStore, WorkerState,
                    aggregator_for, merge_history)
from .heat import HeatTracker, heat
from .history import (HISTORY_VERSION, HistoryStore, history,
                      window_diff)
from .history import report as history_report
from .inflight import (InflightRegistry, QueryCancelled, QueryTicket,
                       checkpoint, inflight)
from .jaxmon import device_capacity, last_watermarks, sample_memory
from .memwatch import (DeviceMemoryLedger, MemoryBudget, device_keys_of,
                       mem_budget, memwatch)
from .metrics import Histogram, MetricsRegistry, metrics
from .openmetrics import (ServerHandle, fleet_to_openmetrics,
                          serve_metrics, to_openmetrics)
from .profiler import (HostProfiler, KernelLedger, capture_snapshot,
                       configure_profiler, ledger, maybe_device_capture,
                       profiler, start_profiler, stop_profiler)
from .recorder import FlightRecorder, install_excepthook, recorder
from .slo import (SLObjective, SLOMonitor, default_objectives,
                  evaluate_fleet, monitor, principal_objectives)
from .spool import (SPOOL_VERSION, SpoolError, read_spool,
                    spool_snapshot, write_spool)
from .timeseries import (Sampler, TimeSeriesStore, configure_sampler,
                         sampler, start_sampler, stop_sampler,
                         timeseries)
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
    "sample_memory", "last_watermarks", "device_capacity",
    "chrome_trace_events", "export_chrome_trace",
    "to_openmetrics", "serve_metrics", "ServerHandle",
    "TimeSeriesStore", "timeseries", "Sampler", "start_sampler",
    "stop_sampler", "sampler", "configure_sampler",
    "SLObjective", "SLOMonitor", "monitor", "default_objectives",
    "principal_objectives", "evaluate_fleet",
    "SPOOL_VERSION", "SpoolError", "read_spool", "spool_snapshot",
    "write_spool",
    "FleetAggregator", "FleetStore", "WorkerState", "aggregator_for",
    "fleet_to_openmetrics", "merge_history",
    "HISTORY_VERSION", "HistoryStore", "history", "history_report",
    "window_diff",
    "serve_dashboard",
    "HeatTracker", "heat",
    "DeviceMonitor", "devicemon", "mesh_device_keys",
    "HostProfiler", "KernelLedger", "ledger", "profiler",
    "start_profiler", "stop_profiler", "configure_profiler",
    "capture_snapshot", "maybe_device_capture",
    "InflightRegistry", "QueryCancelled", "QueryTicket", "inflight",
    "checkpoint",
    "AuditLog", "PrincipalMeter", "accounted", "audit", "complete",
    "meter",
    "DeviceMemoryLedger", "MemoryBudget", "memwatch", "mem_budget",
    "device_keys_of",
    "configure",
]

# Process-wide one-time install: an unhandled crash leaves a flight
# bundle.  The port's executor starts no thread of its own, so the
# thread propagation is left to a caller that spawns workers under a
# trace.
install_excepthook()

# Env-pinned telemetry sampler: MOSAIC_TPU_OBS_SAMPLE_MS=<ms> starts
# the background sampler at import (and pins the cadence against conf
# changes — see timeseries.configure_sampler).  Implies the registry:
# a sampler over a disabled registry would record nothing.
_env_ms = _os.environ.get("MOSAIC_TPU_OBS_SAMPLE_MS", "").strip()
if _env_ms:
    try:
        _ms = float(_env_ms)
    except ValueError:
        _ms = 0.0
    if _ms > 0:
        metrics.enable()
        start_sampler(_ms)

# Env-pinned host profiler: MOSAIC_TPU_PROFILE_HZ=<hz> starts the
# sampling profiler at import (and pins the rate against conf changes
# — see profiler.configure_profiler).
_env_hz = _os.environ.get("MOSAIC_TPU_PROFILE_HZ", "").strip()
if _env_hz:
    try:
        _hz = float(_env_hz)
    except ValueError:
        _hz = 0.0
    if _hz > 0:
        start_profiler(_hz)


def configure(config) -> None:
    """Apply a ``MosaicConfig``'s observability switches (idempotent).

    ``trace_enabled`` turns the tracer (and with it the registry) on;
    ``metrics_enabled`` turns just the registry on.  Neither flag ever
    turns an already-enabled instrument off — env vars and explicit
    ``enable()`` calls win.  ``obs_sample_ms`` drives the telemetry
    sampler lifecycle and ``obs_profile_hz`` the host profiler's
    (change-detecting; the env vars pin them — see
    ``timeseries.configure_sampler``, ``profiler.configure_profiler``)."""
    if getattr(config, "trace_enabled", False):
        tracer.enable()
    if getattr(config, "metrics_enabled", False):
        metrics.enable()
    ms = getattr(config, "obs_sample_ms", None)
    if ms is not None:
        if ms > 0:        # a sampler over a disabled registry records
            metrics.enable()   # nothing — the cadence implies metrics
        configure_sampler(ms)
    hz = getattr(config, "obs_profile_hz", None)
    if hz is not None:
        configure_profiler(hz)
