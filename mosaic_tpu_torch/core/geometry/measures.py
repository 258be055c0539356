"""Vectorized geometry measures on padded edge blocks, and the exact f64
geometry distance.

Port of ``mosaic_tpu.core.geometry.measures``.  ``area``, ``length``,
``centroid`` and ``bounds`` are one launch each of the edge-measures
kernel (``ops/edge_measures.py``), ``distance_points_to_geoms`` one
launch of the point-query kernel (``ops/edge_point.py``), on the edge
blocks' device; ``point_segment_dist2``, ``pairwise_point_distance`` and
``haversine`` are torch ops, elementwise and broadcasting.  On CPU
tensors the kernels' plain versions run.  ``pairwise_geometry_distance``
is the numpy host path SpatialKNN's geometry rows rank candidates by.

Reference counterpart: the measure methods on
core/geometry/MosaicGeometry.scala (getArea, getLength, getCentroid,
minMaxCoord, distance) executed row-at-a-time through JTS.  Planar
(Cartesian) semantics in the geometry's own CRS, matching JTS.
Spherical helpers (haversine) live at the bottom.
"""

from __future__ import annotations

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ...ops.edge_measures import edge_measures, guards
from ...ops.edge_point import edge_point_query
from .array import GeometryType
from .padded import EdgeBlocks, build_edges_np

EARTH_RADIUS_M = 6_371_008.8  # mean Earth radius (IUGG)


def area(e: EdgeBlocks) -> torch.Tensor:
    """Signed shoelace area per geometry. [G].

    Winding was normalized on build (shells CCW, holes CW) so the signed sum
    equals shell area minus hole area; clamp at 0 for degenerate inputs.
    """
    return edge_measures(e.a, e.b, e.mask, "area")


def length(e: EdgeBlocks) -> torch.Tensor:
    """Sum of edge lengths per geometry (perimeter for polygons). [G]."""
    return edge_measures(e.a, e.b, e.mask, "length")


def centroid(e: EdgeBlocks) -> torch.Tensor:
    """Area-weighted centroid per geometry; falls back to the
    length-weighted edge midpoints (lines), then the vertex mean
    (degenerate). [G, 2]."""
    return edge_measures(e.a, e.b, e.mask, "centroid")


def bounds(e: EdgeBlocks) -> torch.Tensor:
    """[G, 4] (xmin, ymin, xmax, ymax) over valid edges."""
    return edge_measures(e.a, e.b, e.mask, "bounds")


def point_segment_dist2(p: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Squared distance from points to segments, broadcasting."""
    eps, _ = guards(a.dtype)
    ab = b - a
    ap = p - a
    denom = torch.sum(ab * ab, dim=-1)
    t = torch.clamp(torch.sum(ap * ab, dim=-1) / (denom + eps), 0.0, 1.0)
    proj = a + t[..., None] * ab
    d = p - proj
    return torch.sum(d * d, dim=-1)


def as_points(points, e: EdgeBlocks) -> torch.Tensor:
    """[N, 2] points on the blocks' device, in the blocks' type: a tensor
    as it is, anything else through ``torch.as_tensor``; ValueError when
    the types differ."""
    p = points if isinstance(points, torch.Tensor) else \
        torch.as_tensor(np.asarray(points), device=e.a.device)
    if p.dtype != e.a.dtype:
        raise ValueError(f"points are {p.dtype}, the edge blocks "
                         f"{e.a.dtype}: give both one type")
    return p


def distance_points_to_geoms(points, e: EdgeBlocks) -> torch.Tensor:
    """[N, G] planar distance from each point to each geometry's edges.

    Distance 0 is NOT shortcut for containment here; use
    predicates.contains for inside tests (JTS distance to a polygon
    interior is 0 — callers combine the two, see functions.st.st_distance).
    """
    return edge_point_query(as_points(points, e), e.a, e.b, e.mask,
                            count=False, dist=True)[1]


def pairwise_point_distance(a: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """[N, M] Euclidean distances between two point sets."""
    diff = a[:, None, :] - b[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def haversine(lat1, lng1, lat2, lng2,
              radius: float = EARTH_RADIUS_M / 1000.0,
              device: DeviceLike = None) -> torch.Tensor:
    """Great-circle distance (default km — matches reference ST_Haversine,
    expressions/geometry/ST_Haversine.scala which returns km).  Tensors
    stay where they are; anything else becomes float64 on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""
    args = [lat1, lng1, lat2, lng2]
    if not all(isinstance(v, torch.Tensor) for v in args):
        dev = resolve_device(device)
        args = [v if isinstance(v, torch.Tensor) else
                torch.as_tensor(v, dtype=torch.float64, device=dev)
                for v in args]
    lat1, lng1, lat2, lng2 = map(torch.deg2rad, args)
    dlat = lat2 - lat1
    dlng = lng2 - lng1
    h = torch.sin(dlat / 2) ** 2 + torch.cos(lat1) * torch.cos(lat2) * \
        torch.sin(dlng / 2) ** 2
    return 2 * radius * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


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
