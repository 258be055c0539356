"""The port's host planes: the metrics registry and partition heat.

Port of the part of ``mosaic_tpu.obs`` that the chip store and the
store-fed join record into: ``obs.metrics`` (counters, gauges,
exponential-bucket histograms) and ``obs.heat`` (decayed per-partition
access statistics).  The JAX package's tracer, flight recorder,
in-flight registry, memory ledger, device monitor, history and
exporters are not ported yet (ROADMAP §A9).
"""

from .metrics import Histogram, MetricsRegistry, metrics

__all__ = ["Histogram", "MetricsRegistry", "metrics"]
