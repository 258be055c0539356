"""Ingest into a chip store: grid-bucketed, row-sharded column files.

:class:`StoreWriter` accepts point blocks incrementally (so a source
larger than RAM streams straight through), buckets each block onto the
fixed world grid, and appends every bucket's rows to that partition's
current shard temp file — rolling to a new shard whenever the current
one reaches ``mosaic.store.shard.rows``.  :meth:`StoreWriter.finalize`
renames every temp shard into place and writes the manifest LAST, so
a crash at any earlier point leaves no readable store (see
:mod:`.manifest`).

Within a partition, rows keep their ingest order (the bucketing sort
is stable), so a store round-trip is bit-reproducible: read the
partitions in manifest order and each partition's rows come back
exactly as appended.

``write_store`` is the one-shot array path; ``write_store_from_chunks``
adapts any iterable of point blocks — e.g. a loop over the io codecs'
decoded tiles — to the incremental writer.

Port copy of ``mosaic_tpu.store.writer``: the same files, byte for byte,
from the same points.  The ``store.write`` fault probes are not ported
(ROADMAP C11).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..obs import metrics
from .manifest import (MANIFEST_VERSION, Manifest, PARTS_DIR, Partition,
                       grid_cells, shard_path)

__all__ = ["StoreWriter", "write_store", "write_store_from_chunks"]


class StoreWriter:
    """Incremental grid-partitioned ingest; call :meth:`append` any
    number of times, then :meth:`finalize` exactly once."""

    def __init__(self, root: str, *, grid_res=None,
                 shard_rows: Optional[int] = None,
                 point_cols: Tuple[str, str] = ("x", "y")):
        from .. import config as _config
        cfg = _config.default_config()
        self.root = str(root)
        if isinstance(grid_res, str):
            # learned layout: resolve "auto" through the advisor
            # (sql/layout.py) — heat workload evidence, else
            # the configured default.  shard_rows follows the advice
            # unless pinned explicitly.
            if grid_res != "auto":
                raise ValueError(
                    f"grid_res={grid_res!r} invalid: an int or 'auto'")
            from ..sql.layout import advise_layout
            adv = advise_layout()
            grid_res = adv.grid_res
            if shard_rows is None:
                shard_rows = adv.shard_rows
        self.grid_res = int(grid_res or cfg.store_grid_res)
        self.shard_rows = int(shard_rows or cfg.store_shard_rows)
        self.point_cols = (str(point_cols[0]), str(point_cols[1]))
        # partition state: cell -> {"rows", "shards": [rows...],
        # "bbox": [xmin, ymin, xmax, ymax]}
        self._parts: Dict[int, dict] = {}
        self._columns: Dict[str, np.dtype] = {}   # fixed at 1st append
        self._bytes = 0
        self._done = False
        os.makedirs(os.path.join(self.root, PARTS_DIR), exist_ok=True)

    # -- ingest ------------------------------------------------------
    def append(self, points: np.ndarray,
               columns: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Bucket one ``(n, 2)`` float64 point block (plus optional
        equal-length payload columns) onto the grid and append it to
        the partition shard files.  Returns rows written."""
        if self._done:
            raise ValueError("StoreWriter already finalized")
        pts = np.asarray(points, np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"points must be (n, 2); got {pts.shape}")
        n = pts.shape[0]
        cols: Dict[str, np.ndarray] = {
            self.point_cols[0]: np.ascontiguousarray(pts[:, 0]),
            self.point_cols[1]: np.ascontiguousarray(pts[:, 1]),
        }
        for name, arr in (columns or {}).items():
            if name in cols:
                raise ValueError(f"column {name!r} collides with a "
                                 "point column")
            a = np.asarray(arr)
            if a.shape[0] != n:
                raise ValueError(f"column {name!r} has {a.shape[0]} "
                                 f"rows, points have {n}")
            cols[name] = np.ascontiguousarray(a)
        if not self._columns:
            self._columns = {k: v.dtype for k, v in cols.items()}
        elif set(cols) != set(self._columns):
            raise ValueError(
                f"column set changed mid-ingest: {sorted(cols)} vs "
                f"{sorted(self._columns)}")
        if n == 0:
            return 0
        cells = grid_cells(pts[:, 0], pts[:, 1], self.grid_res)
        # stable sort: rows within a cell keep ingest order, so the
        # read-back order is a pure function of (data, grid), not of
        # block boundaries' interleaving
        order = np.argsort(cells, kind="stable")
        sorted_cells = cells[order]
        uniq, starts = np.unique(sorted_cells, return_index=True)
        bounds = np.append(starts, n)
        for ci, cell in enumerate(uniq):
            sel = order[bounds[ci]:bounds[ci + 1]]
            self._append_cell(int(cell), {k: v[sel]
                                          for k, v in cols.items()})
        if metrics.enabled:
            metrics.count("store/rows_ingested", n)
        return n

    def _append_cell(self, cell: int,
                     cols: Dict[str, np.ndarray]) -> None:
        part = self._parts.get(cell)
        xs = cols[self.point_cols[0]]
        ys = cols[self.point_cols[1]]
        if part is None:
            part = self._parts[cell] = {
                "rows": 0, "shards": [0],
                "bbox": [float(xs.min()), float(ys.min()),
                         float(xs.max()), float(ys.max())]}
        else:
            bb = part["bbox"]
            bb[0] = min(bb[0], float(xs.min()))
            bb[1] = min(bb[1], float(ys.min()))
            bb[2] = max(bb[2], float(xs.max()))
            bb[3] = max(bb[3], float(ys.max()))
        n = xs.shape[0]
        off = 0
        while off < n:
            k = len(part["shards"]) - 1
            room = self.shard_rows - part["shards"][k]
            if room <= 0:
                part["shards"].append(0)
                continue
            take = min(room, n - off)
            for name, arr in cols.items():
                seg = np.ascontiguousarray(arr[off:off + take])
                with open(shard_path(self.root, cell, k, name) + ".tmp",
                          "ab") as f:
                    f.write(memoryview(seg).cast("B"))
                self._bytes += seg.nbytes
            part["shards"][k] += take
            part["rows"] += take
            off += take

    # -- commit ------------------------------------------------------
    def finalize(self) -> Manifest:
        """Rename every shard into place and write the manifest last.
        The store becomes visible to readers atomically at the
        manifest rename; until then it does not exist."""
        if self._done:
            raise ValueError("StoreWriter already finalized")
        partitions = []
        for cell in sorted(self._parts):
            part = self._parts[cell]
            for k in range(len(part["shards"])):
                for name in self._columns:
                    p = shard_path(self.root, cell, k, name)
                    os.replace(p + ".tmp", p)
            partitions.append(Partition(
                cell=cell, bbox=tuple(part["bbox"]),
                rows=part["rows"], shards=tuple(part["shards"])))
        if partitions:
            bbox = (min(p.bbox[0] for p in partitions),
                    min(p.bbox[1] for p in partitions),
                    max(p.bbox[2] for p in partitions),
                    max(p.bbox[3] for p in partitions))
        else:
            bbox = (0.0, 0.0, 0.0, 0.0)
        man = Manifest(
            grid_res=self.grid_res, point_cols=self.point_cols,
            columns={k: np.dtype(v).str
                     for k, v in self._columns.items()},
            total_rows=sum(p.rows for p in partitions),
            bbox=bbox, partitions=partitions,
            version=MANIFEST_VERSION)
        man.save(self.root)
        if metrics.enabled:
            metrics.count("store/bytes_written", self._bytes)
        self._done = True
        return man


def write_store(root: str, points: np.ndarray,
                columns: Optional[Dict[str, np.ndarray]] = None,
                **kw) -> Manifest:
    """One-shot array ingest (the in-memory path's mirror image)."""
    w = StoreWriter(root, **kw)
    w.append(points, columns)
    return w.finalize()


def write_store_from_chunks(root: str, chunks: Iterable,
                            **kw) -> Manifest:
    """Ingest from any iterable of blocks — each item either a
    ``(n, 2)`` point array or a ``(points, columns dict)`` pair — so a
    codec read loop (or any generator) streams to disk without ever
    holding the whole dataset."""
    w = StoreWriter(root, **kw)
    for item in chunks:
        if isinstance(item, tuple) and len(item) == 2 and \
                isinstance(item[1], dict):
            w.append(item[0], item[1])
        else:
            w.append(item)
    return w.finalize()
