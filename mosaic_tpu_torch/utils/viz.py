"""Result export: GeoJSON for kepler.gl, and a standalone SVG.

Port copy of ``mosaic_tpu.utils.viz`` over the port's ``ChipSet``,
``IndexSystem`` and ``GeometryArray``: for equal inputs the strings are
the JAX package's, byte for byte.  (a) kepler-ready GeoJSON of chips and
cells — drop the file into kepler.gl or any GIS tool — and (b) a
dependency-free SVG renderer for quick visual checks.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

from ..core.geometry.array import GeometryArray
from ..core.index.base import IndexSystem
from ..types import ChipSet

__all__ = ["chips_to_geojson", "cells_to_geojson", "render_svg"]


def chips_to_geojson(chips: ChipSet) -> str:
    """ChipSet -> FeatureCollection with is_core/cell_id/geom_id
    properties (the kepler view of grid_tessellateexplode output)."""
    from ..core.geometry.geojson import write_geojson
    feats = []
    gj = write_geojson(chips.geoms)
    for i in range(len(chips)):
        feats.append({
            "type": "Feature",
            "geometry": json.loads(gj[i]),
            "properties": {
                "cell_id": format(int(chips.cell_id[i]) &
                                  0xFFFFFFFFFFFFFFFF, "x"),
                "geom_id": int(chips.geom_id[i]),
                "is_core": bool(chips.is_core[i]),
            }})
    return json.dumps({"type": "FeatureCollection", "features": feats})


def cells_to_geojson(cells: np.ndarray, grid: IndexSystem,
                     values: Optional[Dict[int, float]] = None) -> str:
    """Cell ids (+ optional per-cell measure) -> boundary polygons —
    the raster_to_grid / zone-histogram view."""
    cells = np.asarray(cells, np.int64)
    verts, counts = grid.cell_boundary(cells)
    feats = []
    for i, c in enumerate(cells):
        ring = verts[i, :counts[i]].tolist()
        ring.append(ring[0])
        props = {"cell_id": format(int(c) & 0xFFFFFFFFFFFFFFFF, "x")}
        if values is not None:
            props["value"] = values.get(int(c))
        feats.append({"type": "Feature",
                      "geometry": {"type": "Polygon",
                                   "coordinates": [ring]},
                      "properties": props})
    return json.dumps({"type": "FeatureCollection", "features": feats})


def render_svg(geoms: GeometryArray,
               values: Optional[Sequence[float]] = None,
               width: int = 640, stroke: str = "#333") -> str:
    """Dependency-free SVG of a geometry batch, optionally choropleth-
    colored by ``values`` (linear blue→red)."""
    bb = geoms.bboxes()
    ok = ~np.any(np.isnan(bb), axis=1)
    if not ok.any():
        return f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}"' \
               f' height="{width}"></svg>'
    x0, y0 = bb[ok, 0].min(), bb[ok, 1].min()
    x1, y1 = bb[ok, 2].max(), bb[ok, 3].max()
    w = max(x1 - x0, 1e-12)
    h = max(y1 - y0, 1e-12)
    height = int(width * h / w)
    sx = width / w

    if values is not None:
        v = np.asarray(values, np.float64)
        lo, hi = np.nanmin(v), np.nanmax(v)
        span = (hi - lo) or 1.0

    def color(i):
        if values is None:
            return "#9ecae1"
        t = (values[i] - lo) / span
        r = int(70 + 180 * t)
        b = int(250 - 180 * t)
        return f"rgb({r},90,{b})"

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" viewBox="0 0 {width} {height}">']
    for gi in range(len(geoms)):
        _, gparts = geoms.geom_slices(gi)
        path = []
        for rings in gparts:
            for ring in rings:
                if len(ring) < 2:
                    continue
                pts = np.asarray(ring)[:, :2]
                px = (pts[:, 0] - x0) * sx
                py = (y1 - pts[:, 1]) * sx
                d = "M" + " L".join(f"{a:.2f},{b:.2f}"
                                    for a, b in zip(px, py)) + " Z"
                path.append(d)
        if path:
            parts.append(f'<path d="{" ".join(path)}" fill="{color(gi)}"'
                         f' fill-opacity="0.55" stroke="{stroke}" '
                         f'stroke-width="0.6" fill-rule="evenodd"/>')
    parts.append("</svg>")
    return "".join(parts)
