"""Hard vector-geometry ops: buffer, simplify, hulls, validity.

Port copy of ``mosaic_tpu.core.geometry.ops`` (pure numpy), over the
port's boolean engine in ``clip.py``.

Reference counterpart: MosaicGeometry.buffer/simplify/convexHull/
concaveHull/isValid (core/geometry/MosaicGeometry.scala:125-160), which
delegate to JTS.  Here:

- ``buffer`` is built ON TOP of the validated even-odd boolean engine
  (clip.py): the offset region of a polygon is the union of the polygon
  with one rectangle per boundary edge and one disc per vertex
  (Minkowski sum with a disc, decomposed); negative buffers subtract
  the same boundary neighbourhood.  This trades speed for reuse of the
  one exactness-audited overlay kernel — the Pallas/C++ fast path can
  replace it without changing semantics.
- ``simplify`` is Douglas–Peucker per ring.
- ``convex_hull`` is Andrew's monotone chain (vectorized sort).
- ``is_valid`` checks ring simplicity + ring-pair crossings with the
  shared proper-crossing primitive.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from .array import GeometryArray, GeometryBuilder, GeometryType
from .clip import (_normalize_rings, _pip_rings, geometry_rings,
                   proper_crossings, ring_signed_area, rings_boolean,
                   rings_to_array, unary_union_rings)

__all__ = ["buffer_geometry", "simplify_ring", "simplify_geometry",
           "convex_hull_points", "is_valid_rings", "buffer_rings"]

#: segments per quarter circle in buffer arcs (JTS default
#: quadrantSegments = 8, BufferParameters)
QUAD_SEGS = 8


def _disc(center: np.ndarray, r: float, segs: int) -> np.ndarray:
    th = np.linspace(0, 2 * np.pi, 4 * segs, endpoint=False)
    return center[None, :] + r * np.stack([np.cos(th), np.sin(th)], -1)


def _edge_box(a: np.ndarray, b: np.ndarray, r: float) -> Optional[np.ndarray]:
    d = b - a
    ln = float(np.hypot(*d))
    if ln == 0:
        return None
    n = np.array([-d[1], d[0]]) / ln * r
    return np.array([a + n, b + n, b - n, a - n])


def buffer_rings(rings: Sequence[np.ndarray], r: float,
                 quad_segs: int = QUAD_SEGS) -> List[np.ndarray]:
    """Offset an even-odd polygon region by ``r`` (±)."""
    rings = _normalize_rings(rings)
    if not rings:
        return []
    if r == 0:
        return list(rings)
    pieces = []
    rr = abs(r)
    for ring in rings:
        closed = np.vstack([ring, ring[:1]])
        for i in range(len(ring)):
            box = _edge_box(closed[i], closed[i + 1], rr)
            if box is not None:
                pieces.append([box])
            pieces.append([_disc(ring[i], rr, quad_segs)])
    band = unary_union_rings(pieces)
    if r > 0:
        return rings_boolean(list(rings), band, "union")
    return rings_boolean(list(rings), band, "difference")


def buffer_geometry(arr: GeometryArray, r, quad_segs: int = QUAD_SEGS,
                    cap_style: str = "round") -> GeometryArray:
    """Row-wise buffer (reference: ST_Buffer, +cap style for lines).

    Polygons/multipolygons: area offset (cap style n/a).  Lines: the
    stroked band around the path — cap_style in {round, square, flat}.
    Points: disc (round) or square."""
    out = GeometryBuilder(srid=arr.srid)
    rs = np.broadcast_to(np.asarray(r, np.float64), (len(arr),))
    for gi in range(len(arr)):
        t = arr.geom_type(gi)
        ri = float(rs[gi])
        if t in (GeometryType.POLYGON, GeometryType.MULTIPOLYGON):
            rings = buffer_rings(geometry_rings(arr, gi), ri)
            rings_to_array(rings, builder=out)
            continue
        # points / lines: union of discs/boxes along the parts
        _, parts = arr.geom_slices(gi)
        pieces = []
        for part in parts:
            for seq in part:
                pts = np.asarray(seq, np.float64)[:, :2]
                if len(pts) == 1 or t in (GeometryType.POINT,
                                          GeometryType.MULTIPOINT):
                    for p in pts:
                        if cap_style == "square":
                            pieces.append([np.array(
                                [p + [-ri, -ri], p + [ri, -ri],
                                 p + [ri, ri], p + [-ri, ri]])])
                        else:
                            pieces.append([_disc(p, ri, quad_segs)])
                    continue
                for i in range(len(pts) - 1):
                    box = _edge_box(pts[i], pts[i + 1], ri)
                    if box is not None:
                        pieces.append([box])
                # joints always round; caps per style
                inner = pts[1:-1]
                for p in inner:
                    pieces.append([_disc(p, ri, quad_segs)])
                for end, prev in ((pts[0], pts[1]), (pts[-1], pts[-2])):
                    if cap_style == "round":
                        pieces.append([_disc(end, ri, quad_segs)])
                    elif cap_style == "square":
                        d = end - prev
                        ln = float(np.hypot(*d))
                        if ln == 0:
                            continue
                        u = d / ln * ri
                        n = np.array([-u[1], u[0]])
                        pieces.append([np.array(
                            [end - n, end + u - n, end + u + n,
                             end + n])])
                    # flat: nothing beyond the edge boxes
        if ri <= 0 or not pieces:
            rings_to_array([], builder=out)
        else:
            rings_to_array(unary_union_rings(pieces), builder=out)
    return out.finish()


def simplify_ring(ring: np.ndarray, tol: float,
                  closed: bool = True) -> np.ndarray:
    """Douglas–Peucker with tolerance ``tol`` (reference: ST_Simplify →
    JTS DouglasPeuckerSimplifier)."""
    pts = np.asarray(ring, np.float64)[:, :2]
    if closed and len(pts) >= 2 and np.array_equal(pts[0], pts[-1]):
        pts = pts[:-1]
    if len(pts) <= (3 if closed else 2):
        return pts
    if closed:
        # anchor at the two extreme points to keep a stable split
        i0 = int(np.argmin(pts[:, 0] + pts[:, 1]))
        pts = np.roll(pts, -i0, axis=0)
        i1 = int(np.argmax(np.hypot(*(pts - pts[0]).T)))
        first = _dp(pts[:i1 + 1], tol)
        second = _dp(np.vstack([pts[i1:], pts[:1]]), tol)
        out = np.vstack([first[:-1], second[:-1]])
        return out if len(out) >= 3 else pts
    return _dp(pts, tol)


def _dp(pts: np.ndarray, tol: float) -> np.ndarray:
    if len(pts) <= 2:
        return pts
    a, b = pts[0], pts[-1]
    d = b - a
    ln = float(np.hypot(*d))
    if ln == 0:
        dist = np.hypot(*(pts[1:-1] - a).T)
    else:
        dist = np.abs(d[0] * (pts[1:-1, 1] - a[1]) -
                      d[1] * (pts[1:-1, 0] - a[0])) / ln
    i = int(np.argmax(dist))
    if dist[i] <= tol:
        return np.vstack([a, b])
    i += 1
    left = _dp(pts[:i + 1], tol)
    right = _dp(pts[i:], tol)
    return np.vstack([left[:-1], right])


def simplify_geometry(arr: GeometryArray, tol) -> GeometryArray:
    """Row-wise simplify, per ring / per linestring."""
    out = GeometryBuilder(ndim=2, srid=arr.srid)
    tols = np.broadcast_to(np.asarray(tol, np.float64), (len(arr),))
    for gi in range(len(arr)):
        t = arr.geom_type(gi)
        _, parts = arr.geom_slices(gi)
        new_parts = []
        for part in parts:
            rings = []
            for seq in part:
                pts = np.asarray(seq, np.float64)[:, :2]
                if t in (GeometryType.POLYGON, GeometryType.MULTIPOLYGON):
                    s = simplify_ring(pts, float(tols[gi]), closed=True)
                    if len(s) >= 3:
                        rings.append(np.vstack([s, s[:1]]))
                elif t in (GeometryType.LINESTRING,
                           GeometryType.MULTILINESTRING):
                    rings.append(simplify_ring(pts, float(tols[gi]),
                                               closed=False))
                else:
                    rings.append(pts)
            if rings:
                new_parts.append(rings)
        if new_parts:
            out.add(t, new_parts)
        else:
            out.add(t, [[np.zeros((0, 2))]])
    return out.finish()


def convex_hull_points(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; returns CCW hull ring (open)."""
    pts = np.unique(np.asarray(pts, np.float64)[:, :2], axis=0)
    if len(pts) <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(points):
        hull = []
        for p in points:
            while len(hull) >= 2:
                o = (hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1]) - \
                    (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])
                if o <= 0:
                    hull.pop()
                else:
                    break
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def is_valid_rings(rings: Sequence[np.ndarray]) -> bool:
    """OGC-style validity for the even-odd region: every ring simple
    (no self-crossing), no two rings properly crossing, every ring with
    nonzero area (reference: ST_IsValid → JTS IsValidOp)."""
    rs = []
    for r in rings:
        r = np.asarray(r, np.float64)[:, :2]
        if len(r) >= 2 and np.array_equal(r[0], r[-1]):
            r = r[:-1]
        if len(r) < 3 or ring_signed_area(r) == 0.0:
            return False
        rs.append(r)
    for i, r in enumerate(rs):
        e = np.stack([r, np.roll(r, -1, axis=0)], axis=1)
        if np.any(np.triu(proper_crossings(e, e), 2)):
            return False
        for q in rs[i + 1:]:
            eq = np.stack([q, np.roll(q, -1, axis=0)], axis=1)
            if np.any(proper_crossings(e, eq)):
                return False
    return True
