"""Bounded in-process metric time-series with multi-resolution rollups.

Port copy of ``mosaic_tpu.obs.timeseries``: the same store, rollups,
sampler and env pin, so a reader finds each counterpart and the
bundles' ``timeseries`` entries compare.  A small process-local store
answers "what did shard skew do over the last five minutes" without any
scrape infrastructure; the SLO evaluator (``obs.slo``) and the device
monitor (``obs.devicemon``) read from here, and flight-recorder bundles
embed a snapshot.

Layout per series — three chained resolutions, strictly partitioned
in time (a point lives in exactly one level at any moment):

* **raw** — the newest ``RAW_CAP`` ``(ts, value)`` points, exact;
* **mid** — when raw overflows, the oldest ``FOLD`` raw points fold
  into one :class:`Bucket` (count/sum/min/max/first/last — lossless
  for every windowed stat except exact quantiles);
* **coarse** — when mid overflows, the oldest ``FOLD`` mid buckets
  merge into one coarse bucket; when coarse overflows the oldest
  bucket is dropped (the only true loss, counted in ``dropped``).

The :class:`Sampler` is a daemon thread that, every
``mosaic.obs.sample.ms`` (env ``MOSAIC_TPU_OBS_SAMPLE_MS`` pins it),
snapshots every registry counter/gauge (+ histogram count/sum) into
the store, folds per-device memory watermarks via ``obs.devicemon``,
drives the SLO evaluator and writes the telemetry spool
(``obs.spool``).  Cadence 0 (the default) means no thread exists;
:meth:`Sampler.tick` runs one pass on the caller's thread.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Bucket", "Series", "TimeSeriesStore", "timeseries",
           "Sampler", "start_sampler", "stop_sampler", "sampler",
           "configure_sampler", "DEFAULT_SAMPLE_MS"]

RAW_CAP = 500            # exact points per series (multiple of FOLD)
BUCKET_CAP = 512         # buckets per rollup level
FOLD = 10                # raw points per mid bucket; mids per coarse
MAX_SERIES = 2048        # distinct series names before drops

#: cadence used when the sampler is enabled without an explicit value
DEFAULT_SAMPLE_MS = 500.0


class Bucket(NamedTuple):
    """One rollup bucket: count/sum/min/max are lossless under
    merging; first/last keep rate() exact across resolutions."""
    ts0: float
    ts1: float
    count: int
    sum: float
    min: float
    max: float
    first: float
    last: float


def _fold_points(pts: List[Tuple[float, float]]) -> Bucket:
    vs = [v for _, v in pts]
    return Bucket(pts[0][0], pts[-1][0], len(vs), sum(vs),
                  min(vs), max(vs), vs[0], vs[-1])


def _merge_buckets(bs: List[Bucket]) -> Bucket:
    return Bucket(bs[0].ts0, bs[-1].ts1,
                  sum(b.count for b in bs), sum(b.sum for b in bs),
                  min(b.min for b in bs), max(b.max for b in bs),
                  bs[0].first, bs[-1].last)


class Series:
    """One named series: raw ring + two rollup levels.  Not
    thread-safe on its own — the store serializes access."""

    __slots__ = ("name", "raw", "mid", "coarse", "dropped")

    def __init__(self, name: str):
        self.name = name
        self.raw: "collections.deque[Tuple[float, float]]" = \
            collections.deque()
        self.mid: "collections.deque[Bucket]" = collections.deque()
        self.coarse: "collections.deque[Bucket]" = collections.deque()
        self.dropped = 0          # coarse buckets lost off the far end

    def append(self, ts: float, value: float) -> None:
        self.raw.append((ts, value))
        if len(self.raw) > RAW_CAP:
            self.mid.append(_fold_points(
                [self.raw.popleft() for _ in range(FOLD)]))
            if len(self.mid) > BUCKET_CAP:
                self.coarse.append(_merge_buckets(
                    [self.mid.popleft() for _ in range(FOLD)]))
                if len(self.coarse) > BUCKET_CAP:
                    self.coarse.popleft()
                    self.dropped += 1

    def __len__(self) -> int:
        return (len(self.raw) + sum(b.count for b in self.mid)
                + sum(b.count for b in self.coarse))

    # -- windowed reads ----------------------------------------------
    def _window(self, cutoff: float):
        """(points, buckets) at/after ``cutoff`` — disjoint by
        construction (levels partition time).  A bucket straddling the
        cutoff is included whole: windowed stats are exact to one
        bucket of slack past the raw horizon, exact to the point
        within it."""
        pts = [(t, v) for t, v in self.raw if t >= cutoff]
        bks = [b for dq in (self.coarse, self.mid) for b in dq
               if b.ts1 >= cutoff]
        return pts, bks

    def window_stats(self, seconds: float,
                     now: Optional[float] = None) -> Dict[str, float]:
        now = time.time() if now is None else now
        pts, bks = self._window(now - seconds)
        count = len(pts) + sum(b.count for b in bks)
        if not count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        s = sum(v for _, v in pts) + sum(b.sum for b in bks)
        lo = min([v for _, v in pts] + [b.min for b in bks])
        hi = max([v for _, v in pts] + [b.max for b in bks])
        return {"count": count, "sum": s, "min": lo, "max": hi,
                "mean": s / count}

    def rate(self, seconds: float,
             now: Optional[float] = None) -> float:
        """(last - first) / elapsed over the window — the counter
        rate.  0.0 with fewer than two observations."""
        now = time.time() if now is None else now
        pts, bks = self._window(now - seconds)
        if bks:                       # oldest observation in window
            t0, first = bks[0].ts0, bks[0].first
        elif pts:
            t0, first = pts[0]
        else:
            return 0.0
        if pts:                       # newest observation in window
            tl, last = pts[-1]
        else:
            tl, last = bks[-1].ts1, bks[-1].last
        dt = tl - t0
        return (last - first) / dt if dt > 0 else 0.0

    def max_over_window(self, seconds: float,
                        now: Optional[float] = None) -> float:
        return self.window_stats(seconds, now)["max"]

    def quantile_over_window(self, q: float, seconds: float,
                             now: Optional[float] = None) -> float:
        """Value at percentile ``q`` over the window — exact while the
        window sits inside the raw ring; past it, each rollup bucket
        contributes its (min, max, mean×(count−2)) weighted spread."""
        now = time.time() if now is None else now
        pts, bks = self._window(now - seconds)
        weighted: List[Tuple[float, int]] = [(v, 1) for _, v in pts]
        for b in bks:
            if b.count == 1:
                weighted.append((b.sum, 1))
                continue
            weighted.append((b.min, 1))
            weighted.append((b.max, 1))
            if b.count > 2:
                mean = (b.sum - b.min - b.max) / (b.count - 2)
                weighted.append((mean, b.count - 2))
        if not weighted:
            return 0.0
        weighted.sort(key=lambda w: w[0])
        total = sum(w for _, w in weighted)
        target = max(1, math.ceil(total * q / 100.0))
        run = 0
        for v, w in weighted:
            run += w
            if run >= target:
                return v
        return weighted[-1][0]

    def fraction_over(self, threshold: float, seconds: float,
                      now: Optional[float] = None) -> Tuple[int, int]:
        """(points above threshold, total points) over the window.
        Exact on raw; rollup buckets interpolate linearly between
        min and max (whole bucket counts when min > threshold, none
        when max <= threshold)."""
        now = time.time() if now is None else now
        pts, bks = self._window(now - seconds)
        bad = sum(1 for _, v in pts if v > threshold)
        total = len(pts)
        for b in bks:
            total += b.count
            if b.min > threshold:
                bad += b.count
            elif b.max > threshold:
                span = b.max - b.min
                frac = (b.max - threshold) / span if span > 0 else 0.5
                bad += max(1, int(round(b.count * frac)))
        return bad, total

    # -- persistence -------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        return {
            "raw": [[t, v] for t, v in self.raw],
            "mid": [list(b) for b in self.mid],
            "coarse": [list(b) for b in self.coarse],
            "dropped": self.dropped,
        }

    @classmethod
    def from_snapshot(cls, name: str, snap: Dict[str, object]) -> "Series":
        s = cls(name)
        s.raw.extend((float(t), float(v)) for t, v in snap.get("raw", []))
        s.mid.extend(Bucket(*b) for b in snap.get("mid", []))
        s.coarse.extend(Bucket(*b) for b in snap.get("coarse", []))
        s.dropped = int(snap.get("dropped", 0))
        return s


class TimeSeriesStore:
    """Thread-safe map of name -> :class:`Series`.  Recording into an
    unknown name creates it (up to ``MAX_SERIES``; beyond that new
    names are counted in ``names_dropped`` and ignored — bounded
    memory is the contract)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: Dict[str, Series] = {}
        self.names_dropped = 0

    def record(self, name: str, value: float,
               ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if len(self._series) >= MAX_SERIES:
                    self.names_dropped += 1
                    return
                s = self._series[name] = Series(name)
            s.append(ts, float(value))

    def series(self, name: str) -> Optional[Series]:
        with self._lock:
            return self._series.get(name)

    def names(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(n for n in self._series if n.startswith(prefix))

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self.names_dropped = 0

    # windowed reads proxy to the series (0/empty when absent)
    def window_stats(self, name: str, seconds: float,
                     now: Optional[float] = None) -> Dict[str, float]:
        s = self.series(name)
        return s.window_stats(seconds, now) if s is not None else \
            {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0, "mean": 0.0}

    def rate(self, name: str, seconds: float,
             now: Optional[float] = None) -> float:
        s = self.series(name)
        return s.rate(seconds, now) if s is not None else 0.0

    def max_over_window(self, name: str, seconds: float,
                        now: Optional[float] = None) -> float:
        s = self.series(name)
        return s.max_over_window(seconds, now) if s is not None else 0.0

    def quantile_over_window(self, name: str, q: float, seconds: float,
                             now: Optional[float] = None) -> float:
        s = self.series(name)
        return s.quantile_over_window(q, seconds, now) \
            if s is not None else 0.0

    def fraction_over(self, name: str, threshold: float, seconds: float,
                      now: Optional[float] = None) -> Tuple[int, int]:
        s = self.series(name)
        return s.fraction_over(threshold, seconds, now) \
            if s is not None else (0, 0)

    # -- persistence (flight-recorder bundles) -----------------------
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"version": 1, "ts": time.time(),
                    "series": {n: s.snapshot()
                               for n, s in self._series.items()}}

    def restore(self, snap: Dict[str, object]) -> int:
        """Replace series present in ``snap``; returns how many were
        restored.  Unknown versions restore nothing (degrade, never
        raise — same contract as the planner's stats file)."""
        if not isinstance(snap, dict) or snap.get("version") != 1:
            return 0
        loaded = {}
        for n, s in (snap.get("series") or {}).items():
            try:
                loaded[n] = Series.from_snapshot(n, s)
            except (TypeError, ValueError, KeyError):
                continue
        with self._lock:
            self._series.update(loaded)
        return len(loaded)


#: the process-global store everything records into
timeseries = TimeSeriesStore()


# ------------------------------------------------------------ sampler

class Sampler:
    """Background thread snapshotting the metrics registry into the
    store every ``interval_ms`` — plus the devicemon fold and the SLO
    evaluation, so alerting runs even while no queries execute."""

    def __init__(self, interval_ms: float, store: TimeSeriesStore,
                 registry=None):
        from .metrics import metrics as _metrics
        self.interval_ms = max(10.0, float(interval_ms))
        self.store = store
        self.registry = registry if registry is not None else _metrics
        self.ticks = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mosaic-obs-sampler", daemon=True)

    def start(self) -> "Sampler":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_ms / 1e3):
            try:
                self.tick()
            except Exception:
                pass              # a sampling hiccup must never kill
                                  # the thread (next tick retries)

    def tick(self, now: Optional[float] = None) -> None:
        """One sampling pass (callable directly from tests)."""
        now = time.time() if now is None else now
        # devicemon first: it refreshes mem/* gauges so the registry
        # pass below snapshots this tick's values, not last tick's
        try:
            from .devicemon import devicemon
            devicemon.sample(self.store, now=now)
        except Exception:
            pass
        rep = self.registry.report()
        for name, v in rep["counters"].items():
            self.store.record(name, v, now)
        for name, v in rep["gauges"].items():
            self.store.record(name, v, now)
        for name, h in rep["histograms"].items():
            self.store.record(f"{name}:count", h["count"], now)
            self.store.record(f"{name}:sum", h["sum"], now)
        try:
            from .slo import monitor
            monitor.evaluate(now=now)
        except Exception:
            pass
        # fleet spool: export this process's telemetry for the
        # aggregator.  write_spool() is a no-op when mosaic.obs.fleet.
        # dir is unset and swallows its own I/O errors, but the tick
        # must survive even an import-time surprise
        try:
            from .spool import write_spool
            write_spool(now=now)
        except Exception:
            pass
        self.ticks += 1

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


_sampler_lock = threading.Lock()
_active_sampler: Optional[Sampler] = None
_conf_ms: Optional[float] = None     # last cadence applied via conf


def sampler() -> Optional[Sampler]:
    """The running sampler, or None."""
    return _active_sampler


def start_sampler(interval_ms: Optional[float] = None,
                  store: Optional[TimeSeriesStore] = None,
                  registry=None) -> Sampler:
    """(Re)start the process sampler; stops a previous one first."""
    global _active_sampler
    with _sampler_lock:
        if _active_sampler is not None:
            _active_sampler.close()
        _active_sampler = Sampler(
            interval_ms if interval_ms is not None else DEFAULT_SAMPLE_MS,
            store if store is not None else timeseries,
            registry).start()
        return _active_sampler


def stop_sampler() -> None:
    global _active_sampler
    with _sampler_lock:
        if _active_sampler is not None:
            _active_sampler.close()
            _active_sampler = None


def configure_sampler(conf_ms: float) -> None:
    """Conf-driven lifecycle (``mosaic.obs.sample.ms`` via
    ``set_default_config``): >0 starts/retunes, 0 stops.  Change-
    detecting — repeated configs with the same value are no-ops, so a
    programmatically-started sampler survives unrelated ``SET``
    statements.  The env var ``MOSAIC_TPU_OBS_SAMPLE_MS`` pins the
    cadence: conf values are ignored while it is set."""
    global _conf_ms
    if os.environ.get("MOSAIC_TPU_OBS_SAMPLE_MS"):
        return
    ms = float(conf_ms)
    with _sampler_lock:
        # check-and-set under the lock: two concurrent SETs reading
        # the same prev would both decide to start/stop
        prev = _conf_ms
        if prev is not None and ms == prev:
            return
        _conf_ms = ms
    if ms > 0:
        start_sampler(ms)
    elif prev:              # only stop what a conf actually started —
        stop_sampler()      # a programmatic start_sampler() survives
                            # unrelated SET statements
