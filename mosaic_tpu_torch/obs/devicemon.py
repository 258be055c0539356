"""Continuous per-device attribution: memory, rows, busy-time.

Port of ``mosaic_tpu.obs.devicemon``.  The monitor attributes **wall
time to devices by observed load share**: a sharded operator that ran
``seconds`` of wall clock with per-shard matched-row counts ``w``
charges device ``i`` with ``seconds * w[i] / sum(w)``.  The weights come
from readbacks the sharded joins already perform on the
``mosaic.shard.skew.refresh`` cadence; no extra host sync.

Feeds, all folded here:

* ``attribute(op, seconds, weights, devices, keep)`` — sharded join /
  overlay wall time, split per device (also kept per operator);
* ``observe_rows(site, counts, devices, keep)`` — per-device row counts
  from the overlay exchange (``device/rows/<dev>`` counters);
* ``sample(store)`` — the sampler-tick fold: refreshes the
  ``jaxmon.sample_memory`` watermarks (so ``mem/*`` gauges populate
  continuously), then writes per-device busy/peak series and a
  ``device/util/<dev>`` utilization gauge (busy share since the previous
  tick, clamped to [0, 1]).

The JAX package's ``mesh_device_keys(mesh)`` lists a mesh's devices; the
port's takes a ``torch.distributed`` group and a device type and lists
the group's rank devices, ``<type>:<rank>`` in rank order: one device a
rank, as under ``torchrun`` on one host, where a rank's CUDA index is its
local rank.  ``group=None`` is the one device the caller runs on.

In a group each rank is its own process and holds only its own device's
share: the sharded sites pass ``keep=`` the rank's key, and every other
share is dropped.  The JAX package, in one process over the whole mesh,
holds all D shares; the union of the D ranks' reports is that report
(ROADMAP C11).

Everything is a no-op while the metrics registry is disabled — the same
one-check contract as the rest of ``obs``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence

from .metrics import metrics

__all__ = ["DeviceMonitor", "devicemon", "mesh_device_keys",
           "format_device_ms"]


def mesh_device_keys(group, device) -> List[str]:
    """``<type>:<rank>`` keys of a process group's rank devices in rank
    order (the shard order of the sharded paths); ``group=None`` gives
    ``[<type>:<index>]`` of ``device`` itself."""
    import torch
    dev = torch.device(device)
    if group is None:
        return [f"{dev.type}:{dev.index or 0}"]
    from ..parallel import collectives as coll
    return [f"{dev.type}:{r}" for r in range(coll.group_size(group))]


def _default_keys(n: int) -> List[str]:
    """Device keys when the caller names none: positional
    ``shard:<i>``."""
    return [f"shard:{i}" for i in range(n)]


class DeviceMonitor:
    """Process-global per-device busy-time / row / memory fold."""

    def __init__(self):
        self._lock = threading.Lock()
        self._busy: Dict[str, float] = {}          # dev -> seconds
        self._op_dev: Dict[str, Dict[str, float]] = {}  # op -> dev -> s
        self._rows: Dict[str, float] = {}          # dev -> rows routed
        self._last_tick: Optional[float] = None
        self._last_busy: Dict[str, float] = {}

    def reset(self) -> None:
        with self._lock:
            self._busy.clear()
            self._op_dev.clear()
            self._rows.clear()
            self._last_tick = None
            self._last_busy.clear()

    # -- attribution feeds -------------------------------------------
    def attribute(self, op: str, seconds: float,
                  weights: Optional[Sequence[float]] = None,
                  devices: Optional[Sequence[str]] = None,
                  keep: Optional[str] = None) -> None:
        """Charge ``seconds`` of wall time to devices proportional to
        ``weights`` (uniform when None/degenerate).  With ``keep`` set,
        only that device's share is held (a rank of a group)."""
        if not metrics.enabled or seconds <= 0:
            return
        if weights is None and devices is None:
            devices = _default_keys(1)
        if devices is None:
            devices = _default_keys(len(weights))
        ws = [max(0.0, float(w)) for w in weights] \
            if weights is not None else [1.0] * len(devices)
        if len(ws) != len(devices) or not devices:
            return
        total = sum(ws)
        if total <= 0:
            ws = [1.0] * len(devices)
            total = float(len(devices))
        with self._lock:
            per_op = self._op_dev.setdefault(op, {})
            for dev, w in zip(devices, ws):
                if keep is not None and dev != keep:
                    continue
                share = seconds * w / total
                self._busy[dev] = self._busy.get(dev, 0.0) + share
                per_op[dev] = per_op.get(dev, 0.0) + share

    def observe_rows(self, site: str, counts: Sequence[float],
                     devices: Optional[Sequence[str]] = None,
                     keep: Optional[str] = None) -> None:
        """Per-device routed-row counts from an exchange (the overlay
        accounting's hash-destination bincount); with ``keep`` set, only
        that device's count is held."""
        if not metrics.enabled:
            return
        if devices is None:
            devices = _default_keys(len(counts))
        pairs = [(dev, float(c)) for dev, c in zip(devices, counts)
                 if keep is None or dev == keep]
        with self._lock:
            for dev, c in pairs:
                self._rows[dev] = self._rows.get(dev, 0.0) + c
        for dev, c in pairs:
            metrics.count(f"device/rows/{dev}", c)

    # -- reads --------------------------------------------------------
    def op_device_totals(self) -> Dict[str, Dict[str, float]]:
        """op -> device -> attributed seconds (cumulative)."""
        with self._lock:
            return {op: dict(d) for op, d in self._op_dev.items()}

    def busy_by_device(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._busy)

    # -- the sampler-tick fold ---------------------------------------
    def sample(self, store=None, now: Optional[float] = None) -> None:
        """One fold pass: refresh memory watermarks, emit per-device
        series + utilization gauges.  Never initializes CUDA
        (``jaxmon.sample_memory`` reads CUDA only once it is)."""
        if not metrics.enabled:
            return
        now = time.time() if now is None else now
        if store is None:
            from .timeseries import timeseries as store
        from .jaxmon import sample_memory
        for dev, st in sample_memory().items():
            store.record(f"device/peak_bytes/{dev}",
                         float(st.get("peak_bytes") or 0.0), now)
        with self._lock:
            busy = dict(self._busy)
            rows = dict(self._rows)
            last_tick, last_busy = self._last_tick, dict(self._last_busy)
            self._last_tick = now
            self._last_busy = dict(busy)
        for dev, s in busy.items():
            store.record(f"device/busy_s/{dev}", s, now)
        for dev, r in rows.items():
            store.record(f"device/rows/{dev}", r, now)
        if last_tick is not None and now > last_tick:
            dt = now - last_tick
            for dev, s in busy.items():
                util = (s - last_busy.get(dev, 0.0)) / dt
                metrics.gauge(f"device/util/{dev}",
                              min(1.0, max(0.0, util)))

    def report(self) -> Dict[str, object]:
        with self._lock:
            busy = dict(self._busy)
            rows = dict(self._rows)
            ops = {op: dict(d) for op, d in self._op_dev.items()}
        gauges = metrics.report()["gauges"]
        from .memwatch import memwatch
        live = memwatch.live_by_device() if memwatch.enabled else {}
        devs = sorted(set(busy) | set(rows) | set(live))
        return {
            "devices": {
                dev: {
                    "busy_s": busy.get(dev, 0.0),
                    "rows": rows.get(dev, 0.0),
                    "util": gauges.get(f"device/util/{dev}", 0.0),
                    "peak_bytes": gauges.get(f"mem/peak_bytes/{dev}"),
                    # ledger-attributed live bytes + pressure (the
                    # allocator peak above is the backend's view; this
                    # is what the ledger can name a holder for)
                    "live_bytes": int(live.get(dev, 0)),
                    "pressure": gauges.get(f"mem/pressure/{dev}", 0.0),
                } for dev in devs
            },
            "ops": ops,
        }


#: the process-global monitor
devicemon = DeviceMonitor()


def format_device_ms(delta: Mapping[str, float]) -> str:
    """Render a per-device seconds delta as an EXPLAIN ANALYZE
    ``device_ms`` cell: ``"cuda:0=1.2 cuda:1=1.1"`` (ms), ``"-"`` when
    nothing was attributed."""
    parts = [f"{dev}={delta[dev] * 1e3:.1f}"
             for dev in sorted(delta) if delta[dev] > 0]
    return " ".join(parts) if parts else "-"
