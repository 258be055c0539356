"""Fixed world-grid partitioning + the store's versioned manifest.

The grid is global and resolution-keyed, never data-fitted: ``res x
res`` cells spanning lon [-180, 180) x lat [-90, 90), cell id ``iy *
res + ix``.  Two stores written at the same resolution therefore share
cell identities — the substrate for partition-aligned merges later.
Only non-empty cells materialize as partitions, so a clustered dataset
on a fine grid stays cheap.

The manifest is the store's single source of truth: schema (column
dtypes), total rows, the dataset bbox, and per-partition ``(cell,
bbox, rows, shard row counts)``.  It is written LAST, via tmp+rename —
a crash mid-ingest leaves shard temp files but no manifest, so a
half-written store is indistinguishable from no store (readers only
trust what the manifest names).  The per-partition bbox is the ACTUAL
data extent (tighter than the cell), so pruning discards cells whose
points cluster away from a query box even when the cell itself
overlaps it.

Port copy of ``mosaic_tpu.store.manifest``: the on-disk format (manifest
keys, dtype strings, shard file names, ``MANIFEST_VERSION``) is the JAX
package's byte for byte, so a store written by either package reads in
the other.  Its fault sites are the JAX package's: ``store.write`` before
the manifest's rename, ``store.read`` before it is loaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..resilience import faults
from ..resilience.ingest import CodecError, decode_guard

__all__ = ["MANIFEST_VERSION", "Manifest", "Partition", "grid_cells",
           "cell_bbox", "bbox_intersects", "shard_path"]

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"
PARTS_DIR = "parts"


def grid_cells(x: np.ndarray, y: np.ndarray, res: int) -> np.ndarray:
    """Cell id per point on the fixed ``res x res`` world grid.

    Points outside the valid lon/lat range clip into the edge cells
    (degrade, not die — the partition bbox still records their true
    extent, so pruning stays correct for them)."""
    cw = 360.0 / res
    ch = 180.0 / res
    ix = np.clip(np.floor((np.asarray(x, np.float64) + 180.0) / cw)
                 .astype(np.int64), 0, res - 1)
    iy = np.clip(np.floor((np.asarray(y, np.float64) + 90.0) / ch)
                 .astype(np.int64), 0, res - 1)
    return iy * np.int64(res) + ix


def cell_bbox(cell: int, res: int) -> Tuple[float, float, float, float]:
    """Grid-aligned ``(xmin, ymin, xmax, ymax)`` of one cell."""
    cw = 360.0 / res
    ch = 180.0 / res
    iy, ix = divmod(int(cell), res)
    return (-180.0 + ix * cw, -90.0 + iy * ch,
            -180.0 + (ix + 1) * cw, -90.0 + (iy + 1) * ch)


def bbox_intersects(a, b) -> bool:
    """Closed-interval bbox overlap — boundary contact counts as
    overlap, so pruning against strict (< / >) predicates can only
    over-scan, never drop a matching row."""
    return not (a[2] < b[0] or b[2] < a[0] or
                a[3] < b[1] or b[3] < a[1])


def shard_path(root: str, cell: int, k: int, col: str) -> str:
    """``<root>/parts/p<cell>.s<k>.<col>`` — raw little-endian values
    of the manifest's dtype for ``col``, nothing else (offsets are
    pure arithmetic, so a torn tail is detectable from file size)."""
    return os.path.join(root, PARTS_DIR, f"p{cell:012d}.s{k}.{col}")


@dataclasses.dataclass(frozen=True)
class Partition:
    """One non-empty grid cell: where its data lives and what it spans."""

    cell: int
    bbox: Tuple[float, float, float, float]   # actual data extent
    rows: int
    shards: Tuple[int, ...]                   # rows per shard file


@dataclasses.dataclass
class Manifest:
    """The store's catalog — everything pruning needs, no data bytes."""

    grid_res: int
    point_cols: Tuple[str, str]               # (x column, y column)
    columns: Dict[str, str]                   # name -> numpy dtype str
    total_rows: int
    bbox: Tuple[float, float, float, float]
    partitions: List[Partition]
    version: int = MANIFEST_VERSION

    # -- serialization -----------------------------------------------
    def to_obj(self) -> dict:
        return {
            "version": self.version,
            "grid_res": self.grid_res,
            "point_cols": list(self.point_cols),
            "columns": dict(self.columns),
            "total_rows": self.total_rows,
            "bbox": [float(v) for v in self.bbox],
            "partitions": [
                {"cell": p.cell,
                 "bbox": [float(v) for v in p.bbox],
                 "rows": p.rows,
                 "shards": list(p.shards)}
                for p in self.partitions],
        }

    @classmethod
    def from_obj(cls, obj: dict, path: str = None) -> "Manifest":
        with decode_guard(path=path, feature="manifest"):
            version = int(obj["version"])
            if version > MANIFEST_VERSION:
                raise CodecError(
                    f"manifest version {version} is newer than this "
                    f"build understands (<= {MANIFEST_VERSION})",
                    path=path, feature="manifest")
            parts = [Partition(cell=int(p["cell"]),
                               bbox=tuple(float(v) for v in p["bbox"]),
                               rows=int(p["rows"]),
                               shards=tuple(int(s)
                                            for s in p["shards"]))
                     for p in obj["partitions"]]
            for p in parts:
                if sum(p.shards) != p.rows:
                    raise CodecError(
                        f"partition {p.cell}: shard rows "
                        f"{sum(p.shards)} != partition rows {p.rows}",
                        path=path, feature=f"partition {p.cell}")
            columns = {str(k): str(np.dtype(v).str)
                       for k, v in obj["columns"].items()}
            pc = tuple(str(c) for c in obj["point_cols"])
            if len(pc) != 2 or any(c not in columns for c in pc):
                raise CodecError(
                    f"point_cols {pc!r} must name two schema columns "
                    f"(have {sorted(columns)})",
                    path=path, feature="manifest")
            return cls(grid_res=int(obj["grid_res"]),
                       point_cols=pc, columns=columns,
                       total_rows=int(obj["total_rows"]),
                       bbox=tuple(float(v) for v in obj["bbox"]),
                       partitions=parts, version=version)

    # -- disk --------------------------------------------------------
    def save(self, root: str) -> str:
        """Atomic write: serialize to ``manifest.json.tmp``, fsync,
        rename — a crash before the rename leaves the old manifest (or
        none) intact.  The ``store.write`` fault site fires before the
        rename."""
        path = os.path.join(root, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_obj(), f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        faults.maybe_fail("store.write")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, root: str) -> "Manifest":
        path = os.path.join(root, MANIFEST_NAME)
        faults.maybe_fail("store.read")
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raise CodecError("no manifest (not a chip store, or an "
                             "ingest that never finalized)",
                             path=path, feature="manifest") from None
        with decode_guard(path=path, feature="manifest"):
            obj = json.loads(raw.decode("utf-8"))
        return cls.from_obj(obj, path=path)
