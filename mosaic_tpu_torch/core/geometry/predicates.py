"""Vectorized spatial predicates on padded edge blocks.

Port of ``mosaic_tpu.core.geometry.predicates``.  ``crossing_number`` and
``points_in_polygons`` are one launch of the point-query kernel
(``ops/edge_point.py``; with the boundary distance, still one launch),
``edges_cross_matrix`` one launch of the edge-crossing kernel
(``ops/edges_cross.py``), on the edge blocks' device; ``_orient``,
``segments_intersect`` and ``first_vertex`` are torch ops.
``polygons_intersect`` and ``polygon_contains_polygon`` compose the
crossing kernel with point queries of each geometry's first vertex.  On
CPU tensors the kernels' plain versions run.

Reference counterpart: ST_Contains / ST_Intersects / ST_Within
(expressions/geometry/*, JTS relate ops, row-at-a-time).  Precision
policy: ``points_in_polygons`` can also return each point's distance to
the geometry boundary so callers flag points within an epsilon band for
an exact float64 host re-check.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops.edge_point import edge_point_query
from ...ops.edges_cross import edges_cross, orient, segments_intersect_xy
from .measures import as_points
from .padded import EdgeBlocks


def crossing_number(points, e: EdgeBlocks) -> torch.Tensor:
    """[N, G] int32 — number of boundary crossings of a +x ray from each
    point, using the half-open rule (ay <= py < by) so vertices are counted
    exactly once and results form a consistent planar partition."""
    return edge_point_query(as_points(points, e), e.a, e.b, e.mask,
                            count=True, dist=False)[0]


def points_in_polygons(
        points, e: EdgeBlocks, with_boundary_dist: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[N, G] bool containment (odd crossing number ⇒ inside; holes flip
    parity naturally).  Optionally also [N, G] boundary distance for the
    f32→f64 exact-fallback filter."""
    count, dist = edge_point_query(as_points(points, e), e.a, e.b, e.mask,
                                   count=True, dist=with_boundary_dist)
    return (count & 1).to(torch.bool), dist


def _orient(p, q, r):
    """Sign of the cross product (q-p) x (r-p)."""
    return orient(p[..., 0], p[..., 1], q[..., 0], q[..., 1], r[..., 0],
                  r[..., 1])


def segments_intersect(a1, b1, a2, b2) -> torch.Tensor:
    """Proper-or-touching segment intersection test, broadcasting."""
    return segments_intersect_xy(a1[..., 0], a1[..., 1], b1[..., 0],
                                 b1[..., 1], a2[..., 0], a2[..., 1],
                                 b2[..., 0], b2[..., 1])


def edges_cross_matrix(e1: EdgeBlocks, e2: EdgeBlocks) -> torch.Tensor:
    """[G1, G2] bool — any edge of geometry i crosses any edge of j.

    O(G1·G2·E1·E2) dense, a warp a pair that stops at the first hit;
    intended for post-grid-filter candidate pairs (the tessellation
    prefilter does the heavy pruning, mirroring the reference's
    core/border chip design)."""
    return edges_cross(e1.a, e1.b, e1.mask, e2.a, e2.b, e2.mask)


def first_vertex(e: EdgeBlocks) -> torch.Tensor:
    """[G, 2] a representative boundary vertex per geometry (first valid;
    slot 0 where none is)."""
    idx = torch.argmax(e.mask.to(torch.int32), dim=-1)
    return torch.gather(e.a, 1, idx[:, None, None].expand(-1, 1, 2))[:, 0]


def polygons_intersect(e1: EdgeBlocks, e2: EdgeBlocks) -> torch.Tensor:
    """[G1, G2] bool ST_Intersects for polygon batches: boundaries cross,
    or one contains a representative vertex of the other."""
    cross = edges_cross_matrix(e1, e2)
    v1_in_2, _ = points_in_polygons(first_vertex(e1), e2)     # [G1, G2]
    v2_in_1, _ = points_in_polygons(first_vertex(e2), e1)     # [G2, G1]
    return cross | v1_in_2 | v2_in_1.T


def polygon_contains_polygon(e1: EdgeBlocks,
                             e2: EdgeBlocks) -> torch.Tensor:
    """[G1, G2] bool — polygon i contains polygon j (no boundary cross and
    a vertex of j inside i).  Matches JTS contains up to boundary-touch
    cases, which the exact host fallback resolves."""
    cross = edges_cross_matrix(e1, e2)
    v2_in_1, _ = points_in_polygons(first_vertex(e2), e1)     # [G2, G1]
    return (~cross) & v2_in_1.T
