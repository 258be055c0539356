"""MosaicAnalyzer: pick a tessellation resolution from the data.

Port copy of ``mosaic_tpu.analyzer`` (pure numpy).

Reference counterpart: sql/MosaicAnalyzer.scala:10-39 — samples the
geometry column, measures mean geometry area, and returns the resolution
whose cells subdivide an average geometry into a workable number of
chips (too coarse → no pruning power; too fine → chip explosion).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .core.geometry.array import GeometryArray
from .core.index.base import IndexSystem

__all__ = ["get_optimal_resolution", "optimal_resolution_report"]


def _mean_geometry_area(geoms: GeometryArray, sample: int,
                        seed: int = 7) -> float:
    """Mean |area| of (a sample of) the batch, in CRS units²."""
    from .core.geometry.clip import geometry_rings, ring_signed_area
    n = len(geoms)
    idx = np.arange(n)
    if n > sample:
        idx = np.random.default_rng(seed).choice(n, sample,
                                                 replace=False)
    areas = []
    for gi in idx:
        a = sum(ring_signed_area(r)
                for r in geometry_rings(geoms, int(gi)))
        if abs(a) > 0:
            areas.append(abs(a))
    if not areas:
        raise ValueError("no areal geometries to analyze")
    return float(np.mean(areas))


def _cell_area_units(grid: IndexSystem, res: int) -> float:
    """Average cell area at ``res`` in the grid's CRS units² (sampled —
    the IndexSystem.cell_area contract may use km² for geographic
    grids, which is the wrong unit to compare against degree²
    geometry areas)."""
    rng = np.random.default_rng(11)
    # sample cells around the CRS domain center-ish
    from .core.geometry.crs import crs_bounds
    try:
        b = crs_bounds(grid.crs_id, reprojected=True)
    except ValueError:
        b = (-180.0, -90.0, 180.0, 90.0)
    pts = np.stack([rng.uniform(b[0], b[2], 32),
                    rng.uniform(b[1], b[3], 32)], -1)
    cells = np.unique(grid.point_to_cell(pts, res))
    verts, counts = grid.cell_boundary(cells)
    k = np.arange(verts.shape[1])[None, :]
    valid = k < counts[:, None]
    x = np.where(valid, verts[..., 0], 0.0)
    y = np.where(valid, verts[..., 1], 0.0)
    nxt = np.where(k + 1 >= counts[:, None], 0, k + 1)
    x2 = np.take_along_axis(x, nxt, axis=1)
    y2 = np.take_along_axis(y, nxt, axis=1)
    areas = np.abs(0.5 * np.sum((x * y2 - x2 * y) * valid, axis=1))
    return float(np.mean(areas))


def get_optimal_resolution(geoms: GeometryArray, grid: IndexSystem,
                           cells_per_geometry: float = 16.0,
                           sample: int = 256) -> int:
    """Resolution whose cells split a mean geometry into about
    ``cells_per_geometry`` chips (reference default regime: enough
    cells for join pruning, few enough that the chip table stays
    small)."""
    mean_area = _mean_geometry_area(geoms, sample)
    best, best_err = None, np.inf
    for res in grid.resolutions():
        try:
            ca = _cell_area_units(grid, res)
        except Exception:
            continue
        if ca <= 0:
            continue
        err = abs(np.log(mean_area / ca / cells_per_geometry))
        if err < best_err:
            best, best_err = res, err
    if best is None:
        raise ValueError("no usable resolution for this grid")
    return int(best)


def optimal_resolution_report(geoms: GeometryArray, grid: IndexSystem,
                              sample: int = 256) -> dict:
    """Diagnostics: mean geometry area + cells-per-geometry at every
    resolution (the reference exposes similar 'metrics' helpers)."""
    mean_area = _mean_geometry_area(geoms, sample)
    out = {"mean_geometry_area": mean_area, "per_resolution": {}}
    for res in grid.resolutions():
        try:
            ca = _cell_area_units(grid, res)
        except Exception:
            continue
        out["per_resolution"][int(res)] = mean_area / ca
    return out
