"""Metrics registry: counters, gauges, exponential-bucket histograms.

Port copy of ``mosaic_tpu.obs.metrics``: the same instruments, names and
switches, so a counter reads the same in either package.  The
process-global registry the rest of the port records into holds three
instrument kinds:

* **counter** — monotonically accumulating float (bytes moved, rejects,
  recompiles).
* **gauge** — last-value or max-tracked float (shard skew, HBM peak).
* **histogram** — exponential buckets, 4 per power of two (~19% relative
  bucket width), so p50/p95/p99 are derivable to within one bucket.

Everything is thread-safe and costs one attribute check per call when
the registry is disabled.  Enable with ``MOSAIC_TPU_METRICS=1`` (or
``MOSAIC_TPU_TRACE=1``, which implies it) or ``metrics.enable()``.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, List, Optional

__all__ = ["Histogram", "MetricsRegistry", "metrics"]

_NBUCKETS = 128
_PER_OCTAVE = 4           # buckets per power of two
_DEF_SCALE = 1e-6         # upper bound of bucket 0 (1 us for seconds)
_LOG2 = math.log(2.0)


def _bucket_of(value: float, scale: float) -> int:
    if value <= scale:
        return 0
    i = int(math.log(value / scale) / _LOG2 * _PER_OCTAVE) + 1
    return i if i < _NBUCKETS else _NBUCKETS - 1


def _bucket_upper(i: int, scale: float) -> float:
    return scale * 2.0 ** (i / _PER_OCTAVE)


class Histogram:
    """Fixed-size exponential-bucket histogram.

    With 128 buckets at 4/octave and the default 1 us scale the range
    covers 1 us .. ~4300 s before the overflow bucket — every host span
    this package times.  ``scale`` can be raised for non-time units.
    """

    __slots__ = ("name", "scale", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, scale: float = _DEF_SCALE):
        self.name = name
        self.scale = scale
        self.counts: List[int] = [0] * _NBUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[_bucket_of(v, self.scale)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` (percent), exact to one bucket width."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(self.count * q / 100.0))
        run = 0
        for i, c in enumerate(self.counts):
            run += c
            if run >= target:
                return min(_bucket_upper(i, self.scale), self.max)
        return self.max

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Process-global counters / gauges / histograms, thread-safe,
    one attribute check per call when disabled."""

    def __init__(self):
        self._enabled = bool(os.environ.get("MOSAIC_TPU_METRICS")
                             or os.environ.get("MOSAIC_TPU_TRACE"))
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- switches
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- counters
    def count(self, name: str, value: float = 1.0) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    # -- gauges
    def gauge(self, name: str, value: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_max(self, name: str, value: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            prev = self._gauges.get(name)
            if prev is None or value > prev:
                self._gauges[name] = float(value)

    def gauge_value(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    # -- histograms
    def observe(self, name: str, value: float,
                scale: float = _DEF_SCALE) -> None:
        if not self._enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, scale)
            h.observe(value)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            h = self._hists.get(name)
        return h.percentile(q) if h is not None else 0.0

    def histograms(self) -> Dict[str, Histogram]:
        """Live histogram objects by name (the OpenMetrics exporter
        needs raw bucket counts, not the percentile snapshot)."""
        with self._lock:
            return dict(self._hists)

    # -- export
    def to_openmetrics(self) -> str:
        """Prometheus/OpenMetrics text exposition of the registry: the
        exporter (``obs/openmetrics.py``) is not ported yet."""
        raise NotImplementedError(
            "to_openmetrics needs obs/openmetrics.py, which the port has "
            "not got yet (ROADMAP §A9)")

    # -- reporting
    def report(self) -> Dict[str, object]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {n: h.snapshot()
                               for n, h in self._hists.items()},
            }

    def full_snapshot(self) -> Dict[str, object]:
        """Consistent raw-state copy (the fleet spool's form): unlike
        :meth:`report` the histograms carry their BUCKET COUNTS, so an
        aggregator can merge N processes bucket-wise and reproduce
        p50/p95/p99 exactly (identical exponential buckets everywhere
        — same ``_NBUCKETS``/``_PER_OCTAVE``; only ``scale`` varies
        per histogram and travels in the snapshot).  One lock hold for
        the whole copy: no torn counter-vs-histogram view."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    n: {"scale": h.scale,
                        "counts": list(h.counts),
                        "count": h.count,
                        "sum": h.sum,
                        "min": h.min if h.count else 0.0,
                        "max": h.max}
                    for n, h in self._hists.items()},
            }


metrics = MetricsRegistry()
