"""Fleet aggregator: N per-process spools -> one exact telemetry view.

Port copy of ``mosaic_tpu.obs.fleet``.  :class:`FleetAggregator` reads
every ``worker-*.json`` spool under one directory (:mod:`.spool`; the
JAX package writes the same format, so a directory holding spools of
both packages merges the same way in either aggregator) and merges them
with fixed, loss-free rules:

* **counters** — summed over every readable spool, stale included: a
  crashed worker's completed work does not un-happen.
* **gauges** — max over fresh workers only, annotated with the owning
  worker pid.
* **histograms** — bucket-wise sums.  Every process uses the same
  exponential bucket layout (``metrics._NBUCKETS``/``_PER_OCTAVE``), so
  the merged p50/p95/p99 are exactly what one registry fed every
  sample would report.  A scale mismatch between workers cannot merge
  exactly and degrades: ``fleet_merge_error`` event, histogram skipped.
* **staleness** — a spool whose mtime is older than
  ``mosaic.obs.fleet.stale.ms`` flags its worker stale
  (``fleet_worker_stale`` event, once per transition); it never
  raises.  Torn JSON and alien versions likewise: ``fleet_merge_error``
  and skip.

:class:`FleetStore` re-hydrates each worker's spooled series tails into
:class:`~.timeseries.Series` objects behind the windowed-read API of
:class:`~.timeseries.TimeSeriesStore`, so :meth:`SLObjective.evaluate`
runs over the fleet unchanged.  A fleet counter rate is the sum of the
per-worker rates.

:func:`FleetAggregator.stitched_traces` reunites cross-process traces:
every ``trace_link`` event maps a worker-local trace id to the W3C
trace id it served, and every ``span`` event under a linked local trace
joins that W3C trace's tree (``context.link_traceparent``).
"""

from __future__ import annotations

import glob
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import Histogram, metrics
from .recorder import recorder
from .spool import SpoolError, read_spool
from .timeseries import Series

__all__ = ["WorkerState", "FleetStore", "FleetAggregator",
           "aggregator_for", "merge_history"]


class WorkerState:
    """One spool file's disposition in a scan."""

    __slots__ = ("pid", "path", "ts", "age_s", "stale", "error",
                 "snapshot")

    def __init__(self, pid: int, path: str):
        self.pid = pid
        self.path = path
        self.ts = 0.0            # spool mtime
        self.age_s = 0.0
        self.stale = False
        self.error: Optional[str] = None
        self.snapshot: Optional[Dict[str, Any]] = None

    @property
    def readable(self) -> bool:
        return self.snapshot is not None

    @property
    def fresh(self) -> bool:
        return self.readable and not self.stale

    def summary(self) -> Dict[str, Any]:
        return {"pid": self.pid, "path": self.path,
                "ts": self.ts, "age_s": round(self.age_s, 3),
                "stale": self.stale, "error": self.error}


class FleetStore:
    """Per-worker series with the TimeSeriesStore windowed-read API
    (duck-typed — ``SLObjective.evaluate`` takes any store).  Built
    from spool snapshots by :meth:`FleetAggregator.fleet_store`."""

    def __init__(self, series_by_worker: Dict[int, Dict[str, Series]]):
        self._workers = series_by_worker

    def _series(self, name: str) -> List[Series]:
        return [ss[name] for ss in self._workers.values()
                if name in ss]

    def names(self, prefix: str = "") -> List[str]:
        out = set()
        for ss in self._workers.values():
            out.update(n for n in ss if n.startswith(prefix))
        return sorted(out)

    def window_stats(self, name: str, seconds: float,
                     now: Optional[float] = None) -> Dict[str, float]:
        now = time.time() if now is None else now
        parts = [s.window_stats(seconds, now)
                 for s in self._series(name)]
        parts = [p for p in parts if p["count"]]
        if not parts:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        count = sum(p["count"] for p in parts)
        total = sum(p["sum"] for p in parts)
        return {"count": count, "sum": total,
                "min": min(p["min"] for p in parts),
                "max": max(p["max"] for p in parts),
                "mean": total / count}

    def rate(self, name: str, seconds: float,
             now: Optional[float] = None) -> float:
        # fleet rate = sum of per-worker counter rates; cumulative
        # counters from different processes must never interleave
        now = time.time() if now is None else now
        return sum(s.rate(seconds, now) for s in self._series(name))

    def max_over_window(self, name: str, seconds: float,
                        now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        vals = [s.max_over_window(seconds, now)
                for s in self._series(name)]
        return max(vals) if vals else 0.0

    def quantile_over_window(self, name: str, q: float, seconds: float,
                             now: Optional[float] = None) -> float:
        """Weighted merge across workers — the same (min, max,
        mean-weighted) bucket spread Series.quantile_over_window uses,
        pooled over every worker's window."""
        import math
        now = time.time() if now is None else now
        weighted: List[Tuple[float, int]] = []
        for s in self._series(name):
            pts, bks = s._window(now - seconds)
            weighted.extend((v, 1) for _, v in pts)
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

    def fraction_over(self, name: str, threshold: float, seconds: float,
                      now: Optional[float] = None) -> Tuple[int, int]:
        now = time.time() if now is None else now
        bad = total = 0
        for s in self._series(name):
            b, t = s.fraction_over(threshold, seconds, now)
            bad += b
            total += t
        return bad, total


class FleetView:
    """One scan's merged result.  ``histograms`` holds live
    :class:`Histogram` objects (exact percentiles on demand);
    :meth:`payload` renders the JSON-able form."""

    def __init__(self, ts: float, directory: str,
                 workers: List[WorkerState]):
        self.ts = ts
        self.directory = directory
        self.workers = workers
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Dict[str, Any]] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.slo_active: List[Dict[str, Any]] = []
        self.slo_breaches = 0
        self.inflight: List[Dict[str, Any]] = []
        self.merge_errors = 0

    def payload(self) -> Dict[str, Any]:
        return {
            "ts": self.ts,
            "dir": self.directory,
            "workers": [w.summary() for w in self.workers],
            "stale": sorted(w.pid for w in self.workers if w.stale),
            "counters": dict(sorted(self.counters.items())),
            "gauges": {n: dict(g) for n, g in
                       sorted(self.gauges.items())},
            "histograms": {n: h.snapshot() for n, h in
                           sorted(self.histograms.items())},
            "slo": {"active": self.slo_active,
                    "breaches": self.slo_breaches},
            "inflight": self.inflight,
            "merge_errors": self.merge_errors,
        }


class FleetAggregator:
    """Scans one spool directory; owns per-worker stale-episode state
    so each stale transition records exactly one event."""

    def __init__(self, directory: str,
                 stale_ms: Optional[float] = None):
        self.directory = directory
        self._stale_ms = stale_ms
        self._lock = threading.Lock()
        self._stale_pids: set = set()

    def _stale_after_s(self) -> float:
        if self._stale_ms is not None:
            return self._stale_ms / 1e3
        from .. import config as _config
        return _config.default_config().obs_fleet_stale_ms / 1e3

    def _merge_error(self, view: FleetView, worker: WorkerState,
                     why: str) -> None:
        worker.error = why
        view.merge_errors += 1
        recorder.record("fleet_merge_error", pid=worker.pid,
                        path=worker.path, why=why[:300])
        if metrics.enabled:
            metrics.count("fleet/merge_errors")

    # -- the scan
    def scan(self, now: Optional[float] = None) -> FleetView:
        """Read every spool and merge.  Never raises for a bad spool:
        torn/alien/stale files degrade the view and say so."""
        now = time.time() if now is None else now
        stale_after = self._stale_after_s()
        workers: List[WorkerState] = []
        for path in sorted(glob.glob(
                os.path.join(self.directory, "worker-*.json"))):
            stem = os.path.basename(path)[len("worker-"):-len(".json")]
            try:
                pid = int(stem)
            except ValueError:
                continue
            workers.append(WorkerState(pid, path))
        view = FleetView(now, self.directory, workers)
        for w in workers:
            try:
                w.ts = os.path.getmtime(w.path)
            except OSError as e:       # raced a worker's os.replace
                self._merge_error(view, w, f"stat: {e}")
                continue
            w.age_s = max(0.0, now - w.ts)
            w.stale = w.age_s > stale_after
            try:
                w.snapshot = read_spool(w.path)
            except (SpoolError, OSError) as e:
                self._merge_error(view, w, str(e))
                continue
            self._merge_worker(view, w)
        self._note_stale_transitions(view)
        if metrics.enabled:
            metrics.gauge("fleet/workers", float(len(workers)))
            metrics.gauge("fleet/stale_workers",
                          float(sum(1 for w in workers if w.stale)))
        return view

    def _merge_worker(self, view: FleetView, w: WorkerState) -> None:
        snap = w.snapshot or {}
        reg = snap.get("metrics", {})
        for name, v in reg.get("counters", {}).items():
            view.counters[name] = view.counters.get(name, 0.0) \
                + float(v)
        if w.fresh:
            for name, v in reg.get("gauges", {}).items():
                cur = view.gauges.get(name)
                if cur is None or float(v) > cur["value"]:
                    view.gauges[name] = {"value": float(v),
                                         "worker": w.pid}
        for name, h in reg.get("histograms", {}).items():
            try:
                self._merge_histogram(view, w, name, h)
            except (KeyError, TypeError, ValueError) as e:
                self._merge_error(view, w,
                                  f"histogram {name}: {e}")
        slo = snap.get("slo", {})
        for alert in slo.get("active", []):
            view.slo_active.append(dict(alert, worker=w.pid))
        view.slo_breaches += int(slo.get("breaches", 0))
        for q in snap.get("inflight", []):
            view.inflight.append(dict(q, worker=w.pid))

    def _merge_histogram(self, view: FleetView, w: WorkerState,
                         name: str, h: Dict[str, Any]) -> None:
        scale = float(h["scale"])
        counts = [int(c) for c in h["counts"]]
        merged = view.histograms.get(name)
        if merged is None:
            merged = view.histograms[name] = Histogram(name, scale)
        elif merged.scale != scale:
            # different unit bases: bucket-wise addition would be a
            # lie, and exactness is the whole contract
            self._merge_error(view, w,
                              f"histogram {name}: scale "
                              f"{scale} != {merged.scale}")
            return
        if len(counts) != len(merged.counts):
            self._merge_error(view, w,
                              f"histogram {name}: {len(counts)} "
                              f"buckets != {len(merged.counts)}")
            return
        for i, c in enumerate(counts):
            merged.counts[i] += c
        n = int(h["count"])
        merged.count += n
        merged.sum += float(h["sum"])
        if n:
            merged.min = min(merged.min, float(h["min"]))
            merged.max = max(merged.max, float(h["max"]))

    def _note_stale_transitions(self, view: FleetView) -> None:
        now_stale = {w.pid for w in view.workers if w.stale}
        with self._lock:
            newly = now_stale - self._stale_pids
            self._stale_pids = now_stale
        for w in view.workers:
            if w.pid in newly:
                recorder.record("fleet_worker_stale", pid=w.pid,
                                age_s=round(w.age_s, 3),
                                path=w.path)
                if metrics.enabled:
                    metrics.count("fleet/stale_transitions")

    # -- series / SLO
    def fleet_store(self, view: Optional[FleetView] = None
                    ) -> FleetStore:
        """Per-worker Series re-hydrated from the spool tails."""
        view = view if view is not None else self.scan()
        by_worker: Dict[int, Dict[str, Series]] = {}
        for w in view.workers:
            if not w.readable:
                continue
            ss: Dict[str, Series] = {}
            for name, snap in (w.snapshot or {}).get("series",
                                                     {}).items():
                try:
                    ss[name] = Series.from_snapshot(name, snap)
                except (TypeError, ValueError) as e:
                    self._merge_error(view, w, f"series {name}: {e}")
            by_worker[w.pid] = ss
        return FleetStore(by_worker)

    def evaluate_slo(self, view: Optional[FleetView] = None,
                     objectives=None,
                     now: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
        """Fleet-level burn-rate evaluation over the merged series
        (stateless — alerting episodes stay per-worker)."""
        from .slo import evaluate_fleet
        view = view if view is not None else self.scan()
        return evaluate_fleet(self.fleet_store(view),
                              objectives=objectives,
                              now=now if now is not None else view.ts)

    # -- cross-process traces
    def stitched_traces(self, view: Optional[FleetView] = None
                        ) -> Dict[str, Dict[str, Any]]:
        """W3C trace id -> the stitched cross-process tree: every
        worker-local trace that recorded a ``trace_link`` to that id
        contributes its spans (tagged with worker + local trace id);
        ``links`` carries each hop's parent span for tree layout."""
        view = view if view is not None else self.scan()
        traces: Dict[str, Dict[str, Any]] = {}
        for w in view.workers:
            if not w.readable:
                continue
            events = (w.snapshot or {}).get("events", [])
            links = {}           # local trace id -> link event
            for ev in events:
                if ev.get("kind") == "trace_link" and ev.get("trace"):
                    links[ev["trace"]] = ev
            if not links:
                continue
            for local, link in links.items():
                t = traces.setdefault(link["w3c_trace"], {
                    "workers": [], "links": [], "spans": []})
                if w.pid not in t["workers"]:
                    t["workers"].append(w.pid)
                t["links"].append({
                    "worker": w.pid, "local_trace": local,
                    "parent_span": link.get("w3c_parent"),
                    "name": link.get("name")})
            for ev in events:
                if ev.get("kind") != "span":
                    continue
                link = links.get(ev.get("trace"))
                if link is None:
                    continue
                traces[link["w3c_trace"]]["spans"].append({
                    "worker": w.pid,
                    "local_trace": ev["trace"],
                    "name": ev.get("name"),
                    "span": ev.get("span"),
                    "parent": ev.get("parent"),
                    "dur_s": ev.get("dur_s"),
                    "ts": ev.get("ts"),
                    **({"error": ev["error"]} if "error" in ev
                       else {}),
                })
        return traces

    # -- the fleet bundle
    def bundle(self, view: Optional[FleetView] = None
               ) -> Dict[str, Any]:
        """Self-contained fleet post-mortem: merged view + fleet SLO
        evaluation + stitched traces + every worker's recent events."""
        view = view if view is not None else self.scan()
        return {
            "reason": "fleet",
            "ts": view.ts,
            "fleet": view.payload(),
            "slo_fleet": self.evaluate_slo(view),
            "traces": self.stitched_traces(view),
            "events_by_worker": {
                w.pid: (w.snapshot or {}).get("events", [])
                for w in view.workers if w.readable},
        }


_agg_lock = threading.Lock()
_aggregators: Dict[str, FleetAggregator] = {}


def aggregator_for(directory: str) -> FleetAggregator:
    """The process-wide aggregator for a spool dir (cached: stale
    transitions are episodes, and episodes need a memory)."""
    with _agg_lock:
        agg = _aggregators.get(directory)
        if agg is None:
            agg = _aggregators[directory] = FleetAggregator(directory)
        return agg


def merge_history(directories: List[str],
                  window_ms: Optional[float] = None
                  ) -> Dict[str, Any]:
    """Fleet-wide workload history: every worker's history dir merged
    window by window with the same exactness discipline as spool
    merging — histogram buckets sum, so fleet percentiles are computed
    from the union, never averaged from per-worker percentiles.  An
    unreadable directory degrades (``fleet_merge_error`` event +
    ``fleet/merge_errors`` counter) and the rest still merge."""
    # NB: ``from . import history`` would resolve to the package's
    # re-exported HistoryFeed singleton, not the submodule
    from .history import (_resolve_window_ms, merge_summary,
                          merged_windows, new_summary, summary_payload)
    windows: Dict[int, Dict[str, Any]] = {}
    merged_dirs: List[str] = []
    errors = 0
    for d in directories:
        try:
            per = merged_windows(d, window_ms)
        except (OSError, ValueError, TypeError, KeyError) as e:
            errors += 1
            recorder.record("fleet_merge_error", pid=0, path=d,
                            error=f"history: {e}")
            if metrics.enabled:
                metrics.count("fleet/merge_errors")
            continue
        merged_dirs.append(d)
        for wid, s in per.items():
            cur = windows.get(wid)
            if cur is None:
                windows[wid] = s
            else:
                try:
                    merge_summary(cur, s)
                except (KeyError, TypeError, ValueError) as e:
                    errors += 1
                    recorder.record("fleet_merge_error", pid=0,
                                    path=d,
                                    error=f"history window {wid}: {e}")
                    if metrics.enabled:
                        metrics.count("fleet/merge_errors")
    totals = new_summary(None, _resolve_window_ms(window_ms))
    for wid in sorted(windows):
        try:
            merge_summary(totals, windows[wid])
        except (KeyError, TypeError, ValueError):
            pass
    return {
        "dirs": merged_dirs,
        "errors": errors,
        "windows": [summary_payload(windows[w])
                    for w in sorted(windows)],
        "totals": summary_payload(totals),
    }
