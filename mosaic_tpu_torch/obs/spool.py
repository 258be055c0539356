"""Per-process telemetry spool: the worker half of the fleet plane.

Port copy of ``mosaic_tpu.obs.spool``, the same file format
(``SPOOL_VERSION`` 1), so a spool the port writes reads as the JAX
package's.  A spool is one atomic, versioned JSON file per process —
``worker-<pid>.json`` under ``mosaic.obs.fleet.dir`` — rewritten in place
on every sampler tick (``timeseries.Sampler.tick``), so the file's mtime
doubles as the process's heartbeat.  The aggregator that merges the
spools is ``obs/fleet.py``.

Contents:

* ``metrics`` — the registry's raw state via
  :meth:`MetricsRegistry.full_snapshot` (histograms with their bucket
  counts: every process uses identical buckets, so a bucket-wise sum
  reproduces fleet percentiles exactly);
* ``series`` — per-series raw/rollup tails within
  ``mosaic.obs.fleet.window.ms``, in ``Series.snapshot()`` shape;
* ``slo`` — active alerts + cumulative breach count;
* ``inflight`` — currently running query summaries;
* ``events`` — the last ``mosaic.obs.fleet.events`` flight-recorder
  events.

Writes are atomic (tmp + ``os.replace``) so a reader never observes a
torn file from a live process.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

__all__ = ["SPOOL_VERSION", "spool_path", "spool_snapshot",
           "write_spool", "read_spool", "SpoolError"]

SPOOL_VERSION = 1

_write_lock = threading.Lock()


class SpoolError(ValueError):
    """A spool file could not be used (torn JSON, wrong version,
    missing sections).  Raised by :func:`read_spool`; the aggregator
    catches it and degrades."""


def spool_path(directory: str, pid: Optional[int] = None) -> str:
    """The spool file for ``pid`` (default: this process)."""
    return os.path.join(directory,
                        f"worker-{pid or os.getpid()}.json")


def _windowed_series(window_s: float,
                     now: float) -> Dict[str, Dict[str, Any]]:
    """Per-series snapshots clipped to the spool window.  Reads the
    live Series objects the way the store's own windowed reads do
    (fetch under the store lock, iterate unlocked); a concurrent
    append can at worst race us into the except arm for one series."""
    from .timeseries import timeseries
    cutoff = now - window_s
    out: Dict[str, Dict[str, Any]] = {}
    for name in timeseries.names():
        s = timeseries.series(name)
        if s is None:
            continue
        try:
            out[name] = {
                "raw": [[t, v] for t, v in s.raw if t >= cutoff],
                "mid": [list(b) for b in s.mid if b.ts1 >= cutoff],
                "coarse": [list(b) for b in s.coarse
                           if b.ts1 >= cutoff],
                "dropped": s.dropped,
            }
        except RuntimeError:
            continue          # deque resized mid-iteration; next tick
    return out


def spool_snapshot(now: Optional[float] = None,
                   window_s: Optional[float] = None,
                   events_cap: Optional[int] = None) -> Dict[str, Any]:
    """Assemble this process's spool record (pure read — no I/O)."""
    from .. import config as _config
    from .inflight import inflight
    from .metrics import metrics
    from .recorder import recorder
    from .slo import monitor
    cfg = _config.default_config()
    now = time.time() if now is None else now
    if window_s is None:
        window_s = cfg.obs_fleet_window_ms / 1e3
    if events_cap is None:
        events_cap = cfg.obs_fleet_events
    evs = recorder.events()
    return {
        "version": SPOOL_VERSION,
        "pid": os.getpid(),
        "ts": now,
        "metrics": metrics.full_snapshot(),
        "series": _windowed_series(window_s, now),
        "slo": {"active": monitor.active_alerts(),
                "breaches": monitor.breach_count()},
        "inflight": inflight.list_active(),
        "events": evs[-events_cap:] if events_cap else [],
    }


def write_spool(directory: Optional[str] = None,
                now: Optional[float] = None) -> Optional[str]:
    """Write this process's spool atomically; returns the path, or
    None when spooling is off (no directory configured).  Failures
    never propagate past the metrics counter — a full disk must not
    take the sampler thread (or a query) down with it."""
    from .. import config as _config
    from .metrics import metrics
    directory = directory if directory is not None \
        else _config.default_config().obs_fleet_dir
    if not directory:
        return None
    path = spool_path(directory)
    try:
        snap = spool_snapshot(now=now)
        blob = json.dumps(snap)
        with _write_lock:
            os.makedirs(directory, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(blob)
            os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        if metrics.enabled:
            metrics.count("fleet/spool_write_errors")
        return None
    if metrics.enabled:
        metrics.count("fleet/spool_writes")
    return path


def read_spool(path: str) -> Dict[str, Any]:
    """Parse + validate one spool file.  Raises :class:`SpoolError`
    for anything unusable (torn JSON, version from a different build,
    non-dict payload) — the aggregator's degrade paths key off it."""
    try:
        with open(path, encoding="utf-8") as fh:
            snap = json.load(fh)
    except ValueError as e:
        raise SpoolError(f"torn spool {path}: {e}") from None
    if not isinstance(snap, dict):
        raise SpoolError(f"spool {path}: not an object")
    if snap.get("version") != SPOOL_VERSION:
        raise SpoolError(f"spool {path}: version "
                         f"{snap.get('version')!r} != {SPOOL_VERSION}")
    if not isinstance(snap.get("metrics"), dict):
        raise SpoolError(f"spool {path}: missing metrics section")
    return snap
