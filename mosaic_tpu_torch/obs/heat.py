"""Per-partition access heat: time-decayed store-cell statistics.

Port copy of ``mosaic_tpu.obs.heat``.  Skew-aware placement (the
LocationSpark scheduler/executor argument, arxiv 1907.03736) is only as
good as the access statistics behind it.  :class:`HeatTracker` keeps
those statistics live, keyed by store grid cell:

* **feeds** — :meth:`~..store.reader.ChipStore.iter_chunks` /
  :meth:`~..store.reader.ChipStore.read_partition` touch each scanned
  partition with its rows read; the store-fed join's staged-bytes
  ledger (``run.staged_bytes_by_partition``) charges the bytes each
  partition actually staged to a device.  A bbox-pruned
  partition is never touched — it stays cold, provably.
* **decay** — every accumulator halves per ``mosaic.heat.halflife.ms``
  of wall time (0 = no decay), applied lazily per cell on touch and
  read, so heat tracks the workload's present, not its history.
* **report** — :meth:`HeatTracker.report` ranks the top-K hot
  partitions (rows, scans, bytes, bytes/row) and derives the hot/cold
  skew ratio (hottest cell's decayed rows over the mean).
* **prior** — :meth:`HeatTracker.prior` folds cell heat into the
  ``nbins``×``nbins`` density lattice a
  :class:`~..parallel.placement.SkewRebalancer` packs from, and
  :meth:`SkewRebalancer.prime` seeds placement with it
  (``mosaic.heat.prior``).  Strictly a placement hint: placement only
  moves which device computes which rows, so a primed run's outputs
  are bit-for-bit identical to an unprimed one.

Always on: one dict update per touched partition span, no
configuration needed to collect (only to *use* the prior).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .metrics import metrics

__all__ = ["HeatTracker", "heat"]


class _CellHeat:
    __slots__ = ("scans", "rows", "bytes", "ts")

    def __init__(self, ts: float):
        self.scans = 0.0
        self.rows = 0.0
        self.bytes = 0.0
        self.ts = ts


class HeatTracker:
    """Process-global decayed per-cell access accumulators."""

    def __init__(self, halflife_ms: Optional[float] = None):
        self._halflife_ms = halflife_ms
        self._lock = threading.Lock()
        self._cells: Dict[int, _CellHeat] = {}

    def _halflife_s(self) -> float:
        if self._halflife_ms is not None:
            return float(self._halflife_ms) / 1e3
        from .. import config as _config
        return float(getattr(_config.default_config(),
                             "heat_halflife_ms", 300_000.0)) / 1e3

    def _decay_locked(self, e: _CellHeat, now: float) -> None:
        hl = self._halflife_s()
        if hl > 0 and now > e.ts:
            f = 0.5 ** ((now - e.ts) / hl)
            e.scans *= f
            e.rows *= f
            e.bytes *= f
        e.ts = max(e.ts, now)

    # -- feeds --------------------------------------------------------
    def touch(self, cell: int, rows: int = 0, nbytes: int = 0,
              scans: int = 1, now: Optional[float] = None) -> None:
        """Charge one access to a store cell (rows read, bytes staged,
        scan count — any subset)."""
        now = time.time() if now is None else now
        with self._lock:
            e = self._cells.get(int(cell))
            if e is None:
                e = self._cells[int(cell)] = _CellHeat(now)
            self._decay_locked(e, now)
            e.scans += float(scans)
            e.rows += float(rows)
            e.bytes += float(nbytes)
            tracked = len(self._cells)
        if metrics.enabled:
            metrics.count("heat/touches")
            metrics.gauge("heat/partitions_tracked", float(tracked))

    # -- reads --------------------------------------------------------
    def _snapshot(self, now: float) -> List[Tuple[int, _CellHeat]]:
        with self._lock:
            for e in self._cells.values():
                self._decay_locked(e, now)
            return [(c, e) for c, e in self._cells.items()]

    def report(self, top: int = 10,
               now: Optional[float] = None) -> Dict[str, Any]:
        """Top-K hot partitions + hot/cold skew.  ``skew`` is the
        hottest cell's decayed rows over the mean (1.0 = perfectly
        even; large = one partition carries the workload)."""
        now = time.time() if now is None else now
        cells = self._snapshot(now)
        ranked = sorted(cells, key=lambda ce: (-ce[1].rows,
                                               -ce[1].scans, ce[0]))
        rows = [e.rows for _, e in cells]
        mean = (sum(rows) / len(rows)) if rows else 0.0
        return {
            "tracked": len(cells),
            "total_rows": round(sum(rows), 3),
            "total_bytes": round(sum(e.bytes for _, e in cells), 3),
            "skew": round(max(rows) / mean, 3) if mean > 0 else 1.0,
            "cells": [{
                "cell": c,
                "scans": round(e.scans, 3),
                "rows": round(e.rows, 3),
                "bytes": round(e.bytes, 3),
                "bytes_per_row": round(e.bytes / e.rows, 3)
                if e.rows > 0 else 0.0,
            } for c, e in ranked[:max(0, int(top))]],
        }

    def prior(self, nbins: int, bbox,
              centers: Dict[int, Tuple[float, float]],
              now: Optional[float] = None) -> Optional[np.ndarray]:
        """The ``nbins``×``nbins`` density lattice (flattened, the
        :class:`SkewRebalancer` layout) implied by current heat:
        each tracked cell's decayed rows land in the lattice bin its
        bbox centroid falls in.  None when no tracked cell maps into
        ``centers`` — the rebalancer then starts cold, as before."""
        now = time.time() if now is None else now
        nb = max(2, int(nbins))
        bb = np.asarray(bbox, np.float64)
        span = np.maximum(bb[2:] - bb[:2], 1e-9)
        dens = np.zeros(nb * nb, np.float64)
        hit = False
        for c, e in self._snapshot(now):
            xy = centers.get(c)
            if xy is None or e.rows <= 0:
                continue
            ij = ((np.asarray(xy, np.float64) - bb[:2]) / span
                  * nb).astype(np.int64)
            ij = np.clip(ij, 0, nb - 1)
            dens[ij[0] * nb + ij[1]] += e.rows
            hit = True
        return dens if hit else None

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()


#: the process-global tracker the store read paths feed
heat = HeatTracker()
