"""Learned store-layout advisor: pick the grid from the workload.

``mosaic.store.grid.res`` has been a hand-picked constant since the
chip store landed — SOLAR (arxiv 2504.01292) argues the system's own
run statistics should pick it instead, and this repo already persists
exactly the statistics that need: the partition-heat plane
(``obs/heat.py``, decayed rows/scans per store cell plus the hot/cold
skew ratio), the workload-history windows (``obs/history.py``,
partition columns per completed query), and the store manifest itself
(rows, partitions, current resolution).

:func:`advise_layout` folds that evidence into one recommendation:

* **target occupancy** — ``mosaic.layout.rows.per.cell`` rows per
  occupied cell.  Occupied-cell count scales like ``res ** d`` where
  the exponent ``d`` comes from the observed heat skew: a uniform
  workload (skew 1) fills area (``d -> 2``), a heavily skewed one
  concentrates on a corridor (``d -> 1``), so the same row count
  justifies a deeper grid.
* **shard size** — a pow2 multiple of the streamed executor's chunk
  (``mosaic.stream.chunk.rows``), at least the per-cell target, capped
  by the configured ``mosaic.store.shard.rows``: every full shard then
  feeds whole jit size classes downstream.
* **clamp** — the result never strays outside
  ``mosaic.layout.{min,max}.res``.

Consumers: ``StoreWriter(grid_res="auto")`` resolves through here at
construction time (workload evidence only — the writer hasn't seen
its data yet), ``mosaicstat layout`` prints the recommendation from
the outside, and :func:`rewrite_store` re-buckets an existing store
onto the advised grid and PROVES read-back bit-parity (byte-exact
row-multiset comparison over every column) before reporting success.

Port copy of ``mosaic_tpu.sql.layout``: the same advice from the same
heat, history, manifest and conf, and every recommendation a
``layout_advice`` flight-recorder event with its evidence.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["LayoutAdvice", "advise_layout", "rewrite_store"]


@dataclasses.dataclass(frozen=True)
class LayoutAdvice:
    """One store-layout recommendation plus its provenance."""

    grid_res: int             # recommended mosaic.store.grid.res
    shard_rows: int           # recommended mosaic.store.shard.rows
    reason: str               # human-readable derivation
    evidence: Dict[str, Any]  # the stats the numbers came from


def _pow2(n: float, lo: int, hi: int) -> int:
    """Nearest power of two to ``n``, clamped to [lo, hi] (both
    assumed powers of two)."""
    n = max(float(n), 1.0)
    exp = int(round(math.log2(n)))
    return int(min(max(1 << max(exp, 0), lo), hi))


def advise_layout(store_root: Optional[str] = None, *,
                  total_rows: Optional[int] = None,
                  partitions: Optional[int] = None,
                  current_res: Optional[int] = None,
                  history_dir: Optional[str] = None,
                  record: bool = True) -> LayoutAdvice:
    """Recommend ``(grid_res, shard_rows)`` for a dataset.

    Evidence resolution, most direct first: an existing store's
    manifest (``store_root``) supplies rows / partition count /
    current resolution; explicit keyword overrides beat it; with
    neither, the heat plane's decayed row totals stand in (the
    ``grid_res="auto"`` writer path — the data hasn't been seen yet,
    so the workload that WILL read it is the only evidence there is).
    The heat skew always shapes the occupancy exponent; a history
    directory (argument, else the configured ``mosaic.history.dir``)
    contributes its touched-partition count as corroborating evidence,
    and a failed read of it is ignored.  With ``record`` the
    recommendation lands in the flight recorder as a ``layout_advice``
    event.

    With no evidence at all the configured ``mosaic.store.grid.res``
    comes back unchanged, reason ``"no evidence"`` — auto mode never
    degrades below the static default."""
    from .. import config as _config
    from ..obs.heat import heat
    from ..perf.bucketing import pow2_bucket

    cfg = _config.default_config()
    target = max(1, int(cfg.layout_rows_per_cell))
    lo = max(1, int(cfg.layout_min_res))
    hi = max(lo, int(cfg.layout_max_res))

    evidence: Dict[str, Any] = {}
    if store_root:
        from ..store.manifest import Manifest
        man = Manifest.load(store_root)
        if total_rows is None:
            total_rows = int(man.total_rows)
        if partitions is None:
            partitions = len(man.partitions)
        if current_res is None:
            current_res = int(man.grid_res)
        evidence["manifest"] = {"root": str(store_root),
                                "total_rows": int(man.total_rows),
                                "partitions": len(man.partitions),
                                "grid_res": int(man.grid_res)}

    rep = heat.report(top=1)
    skew = max(1.0, float(rep.get("skew", 1.0)))
    evidence["heat"] = {"tracked": int(rep.get("tracked", 0)),
                        "total_rows": float(rep.get("total_rows", 0.0)),
                        "skew": skew}
    if total_rows is None and rep.get("tracked"):
        total_rows = int(rep["total_rows"])

    hist_dir = history_dir or cfg.history_dir
    if hist_dir:
        try:
            from ..obs.history import report as _hreport
            totals = _hreport(hist_dir, None)["totals"]
            hist_parts = len(totals.get("partitions", {}))
            evidence["history"] = {"queries": int(totals["queries"]),
                                   "partitions": hist_parts}
            if partitions is None and hist_parts:
                partitions = hist_parts
        except Exception:
            pass                    # corroboration only, never a gate

    chunk = pow2_bucket(int(cfg.stream_chunk_rows), floor=64)
    shard_cap = pow2_bucket(int(cfg.store_shard_rows), floor=chunk)
    shard_rows = min(max(chunk, pow2_bucket(target, floor=64)),
                     shard_cap)

    if not total_rows:
        adv = LayoutAdvice(int(cfg.store_grid_res), shard_rows,
                           "no evidence: configured default", evidence)
    else:
        # occupied cells ~ res ** d; skewed workloads concentrate on a
        # corridor (d -> 1), uniform ones fill area (d -> 2)
        d = 1.0 + 1.0 / skew
        if partitions and current_res:
            # rescale the OBSERVED occupancy from the current grid:
            # occupied(res) = partitions * (res / current_res) ** d
            res_f = current_res * (total_rows /
                                   (target * partitions)) ** (1.0 / d)
        else:
            res_f = (total_rows / target) ** (1.0 / d)
        res = _pow2(res_f, lo, hi)
        adv = LayoutAdvice(
            res, shard_rows,
            f"{total_rows} rows / {target} per cell at skew "
            f"{skew:.2f} (d={d:.2f}) -> res {res}", evidence)

    if record:
        from ..obs.recorder import recorder
        recorder.record("layout_advice", grid_res=adv.grid_res,
                        shard_rows=adv.shard_rows, reason=adv.reason,
                        evidence=adv.evidence)
    return adv


def _canonical_rows(cols: Dict[str, np.ndarray]) -> np.ndarray:
    """Byte-exact sortable view of a column dict's row multiset:
    rows packed into one record array, viewed as raw bytes (void), and
    sorted — NaN payloads and signed zeros compare by bit pattern, so
    equality here IS bit-parity, not value-parity."""
    names = sorted(cols)
    n = int(cols[names[0]].shape[0]) if names else 0
    packed = np.empty(n, dtype=[(c, cols[c].dtype) for c in names])
    for c in names:
        packed[c] = np.ascontiguousarray(cols[c])
    flat = np.ascontiguousarray(packed).view(
        [("", f"V{max(packed.dtype.itemsize, 1)}")]).ravel()
    return np.sort(flat)


def rewrite_store(src_root: str, dst_root: str, *,
                  grid_res: Optional[int] = None,
                  shard_rows: Optional[int] = None,
                  advice: Optional[LayoutAdvice] = None
                  ) -> Tuple["object", LayoutAdvice]:
    """Re-bucket an existing store onto an advised layout, with proof.

    Streams every partition of ``src_root`` (one partition's columns
    in memory at a time) into a fresh :class:`~..store.writer.
    StoreWriter` at ``dst_root`` using ``advice`` (computed from the
    source store when not supplied; explicit ``grid_res`` /
    ``shard_rows`` override it).  Before returning, reads BOTH stores
    back in full and compares their row multisets byte-for-byte over
    every column — a mismatch raises ``AssertionError`` and the
    destination should be discarded.  Returns ``(manifest, advice)``.

    Row order is the one thing a re-bucket legitimately changes (rows
    regroup under new cells), which is why the proof is multiset
    parity; within a destination partition, source order is preserved
    (the writer's stable bucketing sort)."""
    from ..obs import metrics
    from ..store.reader import ChipStore
    from ..store.writer import StoreWriter

    src = ChipStore(src_root)
    if advice is None:
        advice = advise_layout(store_root=src_root)
    res = int(grid_res or advice.grid_res)
    rows = int(shard_rows or advice.shard_rows)
    xcol, ycol = src.point_cols
    w = StoreWriter(dst_root, grid_res=res, shard_rows=rows,
                    point_cols=src.point_cols)
    moved = 0
    for part in src.partitions:
        cols = src.read_partition(part)
        pts = np.stack([cols.pop(xcol), cols.pop(ycol)], axis=1)
        moved += w.append(pts, cols or None)
    man = w.finalize()

    # read-back bit-parity proof: every row of the source must come
    # back from the destination byte-identical (as a multiset)
    dst = ChipStore(dst_root)
    a = _canonical_rows(src.read_columns())
    b = _canonical_rows(dst.read_columns())
    if a.shape != b.shape or not np.array_equal(a, b):
        raise AssertionError(
            f"rewrite_store parity proof failed: {src_root} !~ "
            f"{dst_root} ({a.shape[0]} vs {b.shape[0]} rows)")
    if metrics.enabled:
        metrics.count("layout/rows_rewritten", float(moved))
    return man, advice
