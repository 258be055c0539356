"""Exact f64 geometry distance (numpy).

The port's own copy of ``pairwise_geometry_distance`` from
``mosaic_tpu.core.geometry.measures`` (that module imports jax), and
nothing else of it: SpatialKNN's geometry rows rank candidates by it.
Planar (Cartesian) semantics in the geometry's own CRS, matching JTS.
"""

from __future__ import annotations

import numpy as np

from .array import GeometryType
from .padded import build_edges_np


def pairwise_geometry_distance(a, b) -> np.ndarray:
    """Row-wise exact f64 distance between two geometry batches
    (reference: ST_Distance via JTS Geometry.distance).

    For each row: 0 if the geometries intersect — any edge crossing, or
    any PART of one polygon containing a representative vertex of any
    part of the other (per-part reps, so nested multipolygon components
    count); otherwise the min vertex-to-segment (or vertex-to-vertex
    for edge-less POINT rows) distance in both directions, where the
    minimum between two segment sets is always attained.  Vectorized
    per row.
    """
    A1, A2, MA = build_edges_np(a)         # [G, Ea, 2] x2 + mask
    B1, B2, MB = build_edges_np(b)
    g = len(a)
    out = np.full(g, np.inf)

    def seg_point_d(p, s1, s2):
        # p [P, 2]; s1/s2 [E, 2] -> min distance point->segments
        if not len(p) or not len(s1):
            return np.inf
        d = s2 - s1                                  # [E, 2]
        ap = p[:, None, :] - s1[None]                # [P, E, 2]
        denom = np.maximum(np.sum(d * d, -1), 1e-300)
        t = np.clip(np.sum(ap * d[None], -1) / denom, 0.0, 1.0)
        proj = s1[None] + t[..., None] * d[None]
        dd = np.linalg.norm(p[:, None] - proj, axis=-1)
        return dd.min(initial=np.inf)

    def crossing_any(p1, p2, q1, q2):
        if not len(p1) or not len(q1):
            return False

        def orient(p, q, r):
            return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - \
                   (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])
        a1 = p1[:, None]
        b1 = p2[:, None]
        a2 = q1[None]
        b2 = q2[None]
        d1 = orient(a2, b2, a1)
        d2 = orient(a2, b2, b1)
        d3 = orient(a1, b1, a2)
        d4 = orient(a1, b1, b2)
        proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
        return bool(np.any(proper))

    def pip_any(pts, s1, s2):
        # any of pts inside the closed-ring edge set, crossing rule
        # (only valid over closed rings — open segments break parity)
        if not len(pts) or not len(s1):
            return False
        straddle = (s1[None, :, 1] <= pts[:, 1:2]) != \
            (s2[None, :, 1] <= pts[:, 1:2])
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (pts[:, 1:2] - s1[None, :, 1]) / np.where(
                s2[None, :, 1] == s1[None, :, 1], 1.0,
                s2[None, :, 1] - s1[None, :, 1])
        xi = s1[None, :, 0] + t * (s2[None, :, 0] - s1[None, :, 0])
        hits = straddle & (pts[:, 0:1] < xi)
        return bool(np.any(np.sum(hits, axis=1) & 1))

    def closed_ring_edges(arr, i):
        """Edges of rows' FILLED rings only, for crossing-parity PIP:
        rings whose member type is POLYGON/MULTIPOLYGON.  Linestring and
        point members never contribute (a closed LINESTRING is a curve
        with no interior — JTS distance semantics); unknown members
        (legacy arrays without part_types) count only when explicitly
        closed."""
        eff = arr.part_types_effective()
        p0 = int(arr.geom_offsets[i])
        _, parts = arr.geom_slices(i)
        s1s, s2s = [], []
        for k, part in enumerate(parts):
            mt = GeometryType(int(eff[p0 + k]))
            if mt in (GeometryType.POINT, GeometryType.MULTIPOINT,
                      GeometryType.LINESTRING,
                      GeometryType.MULTILINESTRING):
                continue
            unknown = mt == GeometryType.GEOMETRYCOLLECTION
            for ring in part:
                r = np.asarray(ring, np.float64)[:, :2]
                if len(r) < 3:
                    continue
                closed = np.array_equal(r[0], r[-1])
                if unknown and not closed:
                    continue
                body = r[:-1] if closed else r
                if len(body) < 3:
                    continue
                s1s.append(body)
                s2s.append(np.roll(body, -1, axis=0))
        if not s1s:
            z = np.zeros((0, 2))
            return z, z
        return np.vstack(s1s), np.vstack(s2s)

    def row_vertices(arr, i):
        _, parts = arr.geom_slices(i)
        vs = [np.asarray(r, np.float64)[:, :2]
              for part in parts for r in part if len(r)]
        verts = np.vstack(vs) if vs else np.zeros((0, 2))
        reps = np.array([np.asarray(part[0], np.float64)[0, :2]
                         for part in parts
                         if len(part) and len(part[0])])
        return verts, reps.reshape(-1, 2)

    poly_t = (GeometryType.POLYGON, GeometryType.MULTIPOLYGON,
              GeometryType.GEOMETRYCOLLECTION)
    for i in range(g):
        ea1, ea2 = A1[i][MA[i]], A2[i][MA[i]]     # valid edges only —
        eb1, eb2 = B1[i][MB[i]], B2[i][MB[i]]     # no capacity-wide math
        va, ra = row_vertices(a, i)
        vb, rb = row_vertices(b, i)
        if not len(va) or not len(vb):
            out[i] = np.nan                  # empty geometry
            continue
        if crossing_any(ea1, ea2, eb1, eb2):
            out[i] = 0.0
            continue
        # per-part representative containment (nested components),
        # tested against closed rings only
        if (b.geom_type(i) in poly_t and
                pip_any(ra, *closed_ring_edges(b, i))) or \
                (a.geom_type(i) in poly_t and
                 pip_any(rb, *closed_ring_edges(a, i))):
            out[i] = 0.0
            continue
        d1 = seg_point_d(va, eb1, eb2)
        d2 = seg_point_d(vb, ea1, ea2)
        best = min(d1, d2)
        if not np.isfinite(best):            # point vs point rows
            dd = np.linalg.norm(va[:, None] - vb[None], axis=-1)
            best = float(dd.min())
        out[i] = best
    return out
