"""Delaunay triangulation, conforming constraints, interpolation,
concave hull.

Port copy of ``mosaic_tpu.core.geometry.triangulate`` (pure numpy).

Reference counterpart:
core/geometry/triangulation/JTSConformingDelaunayTriangulationBuilder.scala:12
(constraint lines + split-point insertion) powering ST_Triangulate,
ST_InterpolateElevation, RST_DTMFromGeoms; JTS ConcaveHull (edge-length
Delaunay erosion) powering ST_ConcaveHull.

Bowyer–Watson incremental insertion in float64 with a far-away super
triangle; conforming constraints by midpoint (Steiner) splitting until
every constraint segment is an edge of the triangulation — the same
strategy as the reference's MIDPOINT split-point finder
(TriangulationSplitPointTypeEnum.scala).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["delaunay", "conforming_delaunay", "interpolate_z",
           "concave_hull_points"]


def _circumcircle_contains(tri_pts: np.ndarray, p: np.ndarray) -> bool:
    a, b, c = tri_pts
    ax, ay = a - p
    bx, by = b - p
    cx, cy = c - p
    det = ((ax * ax + ay * ay) * (bx * cy - cx * by) -
           (bx * bx + by * by) * (ax * cy - cx * ay) +
           (cx * cx + cy * cy) * (ax * by - bx * ay))
    return det > 0


def delaunay(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """points [N, 2] -> (vertices [M, 2], triangles [T, 3] CCW indices).

    Duplicate points are dropped; M ≤ N and triangle indices refer to
    the returned vertex array."""
    pts = np.unique(np.asarray(points, np.float64)[:, :2], axis=0)
    n = len(pts)
    if n < 3:
        return pts, np.zeros((0, 3), np.int64)
    # Super triangle at ~1e8x the data extent.  A close-by super
    # triangle (20x, pre-round-4) EXCLUDES legitimate flat hull
    # triangles — any real triangle whose circumradius exceeds the
    # super distance keeps a super vertex inside its circumcircle and
    # is stripped with the super faces, leaving sliver holes along the
    # hull (~0.1% area deficit).  At 1e8x the in-circle determinant for
    # super-involving triangles is dominated by its R² term, which
    # makes the test the exact point-at-infinity half-plane limit, and
    # the residual exclusion band (circumradius > R/2) is ~1e-9 of the
    # extent — below f64 geometry noise.
    cmin = pts.min(axis=0)
    cmax = pts.max(axis=0)
    c = (cmin + cmax) / 2
    d = float(max(cmax[0] - cmin[0], cmax[1] - cmin[1], 1e-12))
    R = 1e8 * d
    sup = np.array([[c[0] - 2 * R, c[1] - R],
                    [c[0] + 2 * R, c[1] - R],
                    [c[0], c[1] + 2 * R]])
    verts = np.vstack([pts, sup])
    tris: List[Tuple[int, int, int]] = [(n, n + 1, n + 2)]
    order = np.argsort(pts[:, 0] + pts[:, 1] * 1e-9, kind="stable")

    def cross2(u, v):
        return u[0] * v[1] - u[1] * v[0]

    for pi in order:
        p = verts[pi]
        # Locate the triangle containing p, then flood-fill the cavity
        # across shared edges into circumcircle-violating neighbors.  A
        # global "every triangle whose circumcircle contains p" scan
        # (pre-round-4) can select a DISCONNECTED set under float64
        # noise; its boundary then isn't one closed loop and the re-fan
        # leaves holes (seen as an area deficit vs the convex hull).
        # Flood fill keeps the cavity connected and star-shaped, which
        # is what Bowyer–Watson requires.
        container = -1
        for ti, t in enumerate(tris):
            a, b, cc = (verts[t[0]], verts[t[1]], verts[t[2]])
            s1 = cross2(b - a, p - a)
            s2 = cross2(cc - b, p - b)
            s3 = cross2(a - cc, p - cc)
            if (s1 >= 0) and (s2 >= 0) and (s3 >= 0):
                container = ti
                break
        if container < 0:
            for ti, t in enumerate(tris):
                if _circumcircle_contains(verts[list(t)], p):
                    container = ti
                    break
        if container < 0:
            continue
        edge_map = {}
        for ti, t in enumerate(tris):
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                edge_map.setdefault((min(e), max(e)), []).append(ti)
        cavity = {container}
        stack = [container]
        while stack:
            ti = stack.pop()
            t = tris[ti]
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                for tj in edge_map[(min(e), max(e))]:
                    if tj not in cavity and _circumcircle_contains(
                            verts[list(tris[tj])], p):
                        cavity.add(tj)
                        stack.append(tj)
        # cavity boundary = edges belonging to exactly one cavity tri
        edge_count = {}
        for ti in cavity:
            t = tris[ti]
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                key = (min(e), max(e))
                edge_count[key] = edge_count.get(key, (0, e))[0] + 1, e
        tris = [t for ti, t in enumerate(tris) if ti not in cavity]
        for (cnt, e) in edge_count.values():
            if cnt == 1:
                tris.append((e[0], e[1], int(pi)))
    # strip super-triangle faces
    out = [t for t in tris if max(t) < n]
    tri = np.asarray(out, np.int64).reshape(-1, 3)
    # normalize CCW
    a = pts[tri[:, 0]]
    b = pts[tri[:, 1]]
    cc = pts[tri[:, 2]]
    cw = ((b[:, 0] - a[:, 0]) * (cc[:, 1] - a[:, 1]) -
          (b[:, 1] - a[:, 1]) * (cc[:, 0] - a[:, 0])) < 0
    tri[cw] = tri[cw][:, ::-1]
    return pts, tri


def _edges_of_tris(tri: np.ndarray) -> set:
    out = set()
    for t in tri:
        for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            out.add((min(e), max(e)))
    return out


def conforming_delaunay(points: np.ndarray,
                        constraints: Optional[np.ndarray] = None,
                        max_iter: int = 12
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Delaunay with every constraint segment present as an edge.

    constraints: [S, 2, 2] segments (endpoints are appended to the point
    set).  Midpoint Steiner insertion, like the reference's MIDPOINT
    split-point finder."""
    pts = np.asarray(points, np.float64)[:, :2]
    segs = [] if constraints is None else \
        [(np.asarray(s[0], np.float64), np.asarray(s[1], np.float64))
         for s in constraints]
    extra = [e for s in segs for e in s]
    allp = np.vstack([pts] + [np.asarray(extra).reshape(-1, 2)]) \
        if extra else pts
    work = [(a, b) for a, b in segs]
    for _ in range(max_iter):
        verts, tri = delaunay(allp)
        if not work:
            return verts, tri
        edges = _edges_of_tris(tri)

        def vid(p):
            d = np.sum((verts - p) ** 2, axis=1)
            return int(np.argmin(d))

        missing = []
        new_pts = []
        for a, b in work:
            ia, ib = vid(a), vid(b)
            if ia == ib or (min(ia, ib), max(ia, ib)) in edges:
                continue
            mid = (a + b) / 2
            new_pts.append(mid)
            missing.append((a, mid))
            missing.append((mid, b))
        if not new_pts:
            return verts, tri
        allp = np.vstack([allp, np.asarray(new_pts)])
        work = missing
    return delaunay(allp)


def interpolate_z(verts_xy: np.ndarray, verts_z: np.ndarray,
                  tri: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Barycentric z at query points; NaN outside the triangulation
    (reference: ST_InterpolateElevation over the conforming TIN)."""
    q = np.asarray(query, np.float64)[:, :2]
    out = np.full(len(q), np.nan)
    if len(tri) == 0:
        return out
    a = verts_xy[tri[:, 0]]
    b = verts_xy[tri[:, 1]]
    c = verts_xy[tri[:, 2]]
    det = ((b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) +
           (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1]))
    for i, p in enumerate(q):
        w1 = ((b[:, 1] - c[:, 1]) * (p[0] - c[:, 0]) +
              (c[:, 0] - b[:, 0]) * (p[1] - c[:, 1])) / det
        w2 = ((c[:, 1] - a[:, 1]) * (p[0] - c[:, 0]) +
              (a[:, 0] - c[:, 0]) * (p[1] - c[:, 1])) / det
        w3 = 1 - w1 - w2
        eps = 1e-12
        hit = np.nonzero((w1 >= -eps) & (w2 >= -eps) & (w3 >= -eps))[0]
        if len(hit):
            t = hit[0]
            out[i] = (w1[t] * verts_z[tri[t, 0]] +
                      w2[t] * verts_z[tri[t, 1]] +
                      w3[t] * verts_z[tri[t, 2]])
    return out


def concave_hull_points(points: np.ndarray, length_ratio: float = 0.3
                        ) -> np.ndarray:
    """Concave hull by Delaunay border erosion (JTS ConcaveHull's
    edge-length strategy): repeatedly remove the border triangle whose
    border edge is longest, while the edge exceeds
    ``length_ratio × max_edge`` and removal keeps the region simple.
    Returns the hull ring (open, CCW)."""
    verts, tri = delaunay(points)
    if len(tri) == 0:
        return convexish(verts)
    tris = [tuple(t) for t in tri]

    def edge_len(e):
        return float(np.hypot(*(verts[e[0]] - verts[e[1]])))

    def border_edges(ts):
        cnt = {}
        for t in ts:
            for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
                k = (min(e), max(e))
                cnt[k] = cnt.get(k, 0) + 1
        return {k for k, v in cnt.items() if v == 1}

    all_edges = _edges_of_tris(tri)
    max_len = max(edge_len(e) for e in all_edges)
    threshold = length_ratio * max_len
    changed = True
    while changed and len(tris) > 1:
        changed = False
        border = border_edges(tris)
        # vertex use count (removal must not pinch the region)
        vcnt = {}
        for t in tris:
            for v in t:
                vcnt[v] = vcnt.get(v, 0) + 1
        candidates = []
        for t in tris:
            es = [(min(a, b), max(a, b)) for a, b in
                  ((t[0], t[1]), (t[1], t[2]), (t[2], t[0]))]
            on_border = [e for e in es if e in border]
            if len(on_border) != 1:
                continue
            e = on_border[0]
            if edge_len(e) <= threshold:
                continue
            apex = [v for v in t if v not in e][0]
            if vcnt.get(apex, 0) == 1:
                continue      # removing would detach the apex
            candidates.append((edge_len(e), t))
        if candidates:
            candidates.sort(reverse=True)
            tris.remove(candidates[0][1])
            changed = True
    border = border_edges(tris)
    # walk the border into a ring
    nxt = {}
    for t in tris:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            if (min(a, b), max(a, b)) in border:
                nxt[a] = b
    if not nxt:
        return convexish(verts)
    start = next(iter(nxt))
    ring = [start]
    cur = nxt[start]
    guard = 0
    while cur != start and guard < len(nxt) + 1:
        ring.append(cur)
        cur = nxt.get(cur, start)
        guard += 1
    return verts[ring]


def convexish(verts: np.ndarray) -> np.ndarray:
    from .ops import convex_hull_points
    return convex_hull_points(verts)
