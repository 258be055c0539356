"""The raster_to_grid pipeline: files → grid-cell measures.

Port of ``mosaic_tpu.io.raster_grid``.  ``raster_to_grid`` runs on a
device (CUDA unless the caller passes ``device="cpu"``): each tile's
ownership pass through the grid's ``point_to_cell_device`` (on H3 one
launch of the cell kernel) and the combine of overlapping tiles on the
tile combine kernel; the grouping, the per-cell windows and the per-cell
reduce stay on the host, as in the JAX package.  A tile whose srid is not
the grid's CRS is first warped into it on the host (``rops.warp``,
bilinear), as in the JAX package.

Reference counterpart: datasource/multiread/RasterAsGridReader.scala:36-110
— spark.read.format("gdal") with retile_on_read → rst_asformat →
rst_tessellate → groupBy(cell) → rst_combineavg_agg →
rst_rastertogrid<combiner> → optional k-ring interpolation.  The result
is a columnar (cell_id, measure) table ready to join against vector
chips.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .._device import DeviceLike, resolve_device
from ..core.index.base import IndexSystem
from ..core.raster import rops
from ..core.raster.gtiff import read_gtiff
from ..core.raster.tile import RasterTile

__all__ = ["raster_to_grid", "read_gtiff_files"]


def read_gtiff_files(paths: Sequence[str],
                     size_mb: Optional[float] = None,
                     strategy: str = "in_memory") -> List:
    """GeoTIFF paths → tiles, under one of the reference's read
    strategies (datasource/gdal/ReadStrategy.scala:11-81):

    - "in_memory":      decode now, tiles carry pixel arrays;
    - "retile_on_read": decode + subdivide to ``size_mb`` (default 8)
                        bounded tiles (ReTileOnRead.localSubdivide);
    - "as_path":        defer decode — returns wire records
                        {"raster": path, "metadata": {...}} resolvable
                        with core.raster.checkpoint.deserialize_tile
                        (ReadAsPath: tile = path through the shuffle).
    """
    if strategy == "as_path":
        return [{"cell_id": None, "raster": p, "metadata": {"path": p}}
                for p in paths]
    if strategy == "retile_on_read" and size_mb is None:
        size_mb = 8.0
    elif strategy not in ("in_memory", "retile_on_read"):
        raise ValueError(f"unknown read strategy {strategy!r}")
    tiles = []
    for p in paths:
        with open(p, "rb") as f:
            t = read_gtiff(f.read())
        t.meta["path"] = p
        if size_mb is not None:
            tiles.extend(rops.subdivide(t, size_mb))
        else:
            tiles.append(t)
    return tiles


def _reduce_cell(tile: RasterTile, band: int, combiner: str):
    """The cell tile's valid ``band`` pixels reduced by ``combiner``, or
    None when it has none."""
    m = tile.valid_mask()[band]
    if not m.any():
        return None
    v = np.asarray(tile.data[band], np.float64)[m]
    if combiner == "avg":
        return float(v.mean())
    if combiner == "min":
        return float(v.min())
    if combiner == "max":
        return float(v.max())
    if combiner == "median":
        return float(np.median(v))
    if combiner == "count":
        return int(v.size)
    raise ValueError(f"unknown combiner {combiner!r}")


def raster_to_grid(tiles: Sequence[RasterTile], res: int,
                   grid: IndexSystem, combiner: str = "avg",
                   band: int = 0, kring_interpolate: int = 0,
                   device: DeviceLike = None) -> Dict[int, float]:
    """Tiles → {cell_id: combined measure} at grid resolution ``res``.

    Stages mirror RasterAsGridReader.load (:52-110):
      1. tessellate every tile to per-cell clipped tiles (the ownership
         pass on ``device``)
      2. group by cell id; combine overlapping tiles per cell (avg, on
         ``device``)
      3. reduce each cell tile's valid band pixels by ``combiner``
      4. optional k-ring smoothing: each cell value is replaced by the
         mean of its k-ring neighbourhood values (:81-110 interpolation)
    """
    dev = resolve_device(device)
    per_cell: Dict[int, List[RasterTile]] = {}
    for t in tiles:
        if t.srid != grid.crs_id:
            # reference projects every tile into the index CRS before
            # clipping (retile/RasterTessellate.scala:34 via RasterProject)
            t = rops.warp(t, grid.crs_id)
        for ct in rops.tessellate_raster(t, res, grid, device=dev):
            per_cell.setdefault(int(ct.cell_id), []).append(ct)

    out: Dict[int, float] = {}
    for cell, group in per_cell.items():
        tile = group[0] if len(group) == 1 else \
            rops.combine_avg(group, device=dev)
        value = _reduce_cell(tile, band, combiner)
        if value is not None:
            out[cell] = value

    if kring_interpolate > 0 and out:
        cells = np.asarray(sorted(out), np.int64)
        vals = np.asarray([out[int(c)] for c in cells])
        rings = grid.k_ring(cells, kring_interpolate)   # [N, K]
        idx = {int(c): i for i, c in enumerate(cells)}
        smoothed = {}
        for i, c in enumerate(cells):
            neigh = [idx[int(n)] for n in rings[i] if int(n) in idx]
            smoothed[int(c)] = float(vals[neigh].mean())
        out = smoothed
    return out
