"""Skew-aware chip→device placement for the sharded join.

Row-order sharding (``P("data")`` splits the batch into D contiguous
blocks) is only balanced when matched work is uncorrelated with row
order.  Real point feeds are usually sorted by something spatial
(zone, tile, ingest region), so one shard ends up holding most of the
matched candidates while the rest grind padding — the classic
distributed-spatial-join skew problem (LocationSpark, arxiv
1907.03736; the partition-parallel join blueprint of arxiv 1908.11740
makes the same observation for partition assignment).

:class:`SkewRebalancer` is the placement pass the sharded streamed
join consults per chunk:

* **observe** — every consumed chunk feeds back which coarse grid
  cells (a ``nbins``×``nbins`` lattice over the observed extent) its
  matched candidates landed in; densities decay exponentially so the
  placement tracks drift.
* **rebalance** — every ``refresh`` observations (the
  ``mosaic.shard.skew.refresh`` conf key's cadence) the bins are
  re-packed greedily: bins in descending density order, each to the
  currently least-loaded shard.  Recomputed, not first-call-only.
* **place** — :func:`placement_slots` turns the per-row shard
  preference into slot indices inside the padded device buffer: each
  shard's block holds at most ``cap`` rows, overflow spills to shards
  with spare capacity, and padding fills the rest.  The inverse is a
  plain gather, so rebalancing never changes results — only which
  device computes which row.

Pure numpy; one branch when no stats have been observed yet (identity
placement — arrival order).

Port copy of ``mosaic_tpu.parallel.placement``, unchanged.  Under a
``torch.distributed`` group every rank owns one of these and observes the
same gathered chunk, so all ranks compute the same slots."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["SkewRebalancer", "placement_slots"]


def placement_slots(pref: Optional[np.ndarray], n: int, n_shards: int,
                    cap: int) -> np.ndarray:
    """Slot index inside a ``[n_shards * cap]``-row padded buffer for
    each of ``n`` rows.

    ``pref`` is the preferred shard per row (or None for identity
    placement: rows fill shard blocks in arrival order).  Each shard's
    block is ``[s * cap, (s + 1) * cap)``; rows keep their relative
    order inside a block (stable), and rows preferring a full shard
    spill to the shards with free capacity.  Requires
    ``n <= n_shards * cap``; every returned slot is unique."""
    if n > n_shards * cap:
        raise ValueError(f"{n} rows exceed {n_shards}x{cap} capacity")
    if pref is None:
        return np.arange(n, dtype=np.int64)

    def ranks(shard):
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=n_shards)
        starts = np.zeros(n_shards, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - starts[shard[order]]
        return rank, counts

    shard = np.asarray(pref, np.int64).copy()
    rank, counts = ranks(shard)
    over = rank >= cap
    if over.any():
        free = cap - np.minimum(counts, cap)
        targets = np.repeat(np.arange(n_shards), free)[:int(over.sum())]
        shard[over] = targets
        rank, _ = ranks(shard)
    return shard * cap + rank


class SkewRebalancer:
    """Greedy bin-packing of coarse grid cells onto shards by observed
    matched-candidate density (see module docstring)."""

    def __init__(self, n_shards: int, refresh: int = 16,
                 nbins: int = 16, decay: float = 0.5):
        self.n_shards = int(n_shards)
        self.refresh = max(1, int(refresh))
        self.nbins = max(2, int(nbins))
        self.decay = float(decay)
        self._bbox: Optional[np.ndarray] = None   # x0, y0, x1, y1
        self._density: Optional[np.ndarray] = None
        self._assign: Optional[np.ndarray] = None  # bin -> shard
        self._loads: Optional[np.ndarray] = None
        self.observations = 0
        self.rebalances = 0

    # -- binning -------------------------------------------------------
    def _bins(self, pts: np.ndarray) -> np.ndarray:
        bb = self._bbox
        nb = self.nbins
        span = np.maximum(bb[2:] - bb[:2], 1e-9)
        ij = ((pts[:, :2] - bb[:2]) / span * nb).astype(np.int64)
        ij = np.clip(ij, 0, nb - 1)
        return ij[:, 0] * nb + ij[:, 1]

    # -- feedback ------------------------------------------------------
    def observe(self, pts64: np.ndarray,
                matched: np.ndarray) -> None:
        """Feed back one consumed chunk: which bins its matched rows
        (zone >= 0) landed in.  Every ``refresh``-th observation
        triggers a greedy re-pack."""
        pts = np.asarray(pts64)[:, :2]
        if self._bbox is None:
            lo, hi = pts.min(axis=0), pts.max(axis=0)
            pad = np.maximum((hi - lo) * 0.01, 1e-6)
            self._bbox = np.concatenate([lo - pad, hi + pad])
        cnt = np.bincount(self._bins(pts)[np.asarray(matched, bool)],
                          minlength=self.nbins * self.nbins
                          ).astype(np.float64)
        if self._density is None:
            self._density = cnt
        else:
            self._density = self.decay * self._density + cnt
        self.observations += 1
        if self.observations % self.refresh == 0:
            self.rebalance()

    def prime(self, bbox, density) -> None:
        """Seed the lattice from an external heat prior (the decayed
        per-partition access heat ``obs.heat`` folds into this bin
        layout) and pack immediately, so the very first chunk places
        skew-aware instead of identity.  A pure placement hint: only
        *where* rows compute changes, never what they compute —
        subsequent ``observe`` feedback decays the prior like any
        other observation."""
        d = np.asarray(density, np.float64).ravel()
        if d.size != self.nbins * self.nbins:
            raise ValueError(f"prior has {d.size} bins, lattice needs "
                             f"{self.nbins * self.nbins}")
        self._bbox = np.asarray(bbox, np.float64).copy()
        self._density = d.copy()
        self.rebalance()

    def rebalance(self) -> None:
        """Greedy bin-packing: bins in descending density order, each
        onto the currently least-loaded shard."""
        dens = self._density
        if dens is None or dens.sum() <= 0:
            return
        assign = np.zeros(len(dens), np.int64)
        loads = np.zeros(self.n_shards)
        for b in np.argsort(dens, kind="stable")[::-1]:
            s = int(np.argmin(loads))
            assign[b] = s
            loads[s] += dens[b]
        self._assign = assign
        self._loads = loads
        self.rebalances += 1

    # -- placement -----------------------------------------------------
    @property
    def armed(self) -> bool:
        return self._assign is not None

    def preferred(self, pts64: np.ndarray) -> Optional[np.ndarray]:
        """Preferred shard per row under the current bin→shard
        assignment, or None before the first rebalance (identity
        placement)."""
        if self._assign is None:
            return None
        return self._assign[self._bins(np.asarray(pts64)[:, :2])]

    def planned_skew(self) -> float:
        """max/mean of the per-shard packed density — the placement's
        own estimate of residual imbalance (1.0 = perfectly even)."""
        if self._loads is None:
            return 1.0
        mean = float(self._loads.mean())
        return float(self._loads.max()) / mean if mean else 1.0

    def contiguous_skew(self) -> float:
        """max/mean the observed density would load shards with under
        naive contiguous-block bin placement — the unrebalanced
        spatial-partition baseline the greedy pack is cut against."""
        if self._density is None:
            return 1.0
        blocks = np.array_split(self._density, self.n_shards)
        loads = np.asarray([b.sum() for b in blocks])
        mean = float(loads.mean())
        return float(loads.max()) / mean if mean else 1.0
