"""Segment and ring primitives of the geometry layer.

Port copy of the three numpy helpers of ``mosaic_tpu.core.geometry.clip``
that ``bench.workloads`` needs (partition validation and hole fitting).
The polygon boolean ops of that module come with a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["proper_crossings"]


def proper_crossings(e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """[N, M] bool: strict interior crossing of each segment pair.

    Endpoint touches and collinear overlaps do NOT count (all four
    orientations must be nonzero) — the primitive behind ring-simplicity
    and partition validation."""
    a1, b1 = e1[:, None, 0], e1[:, None, 1]
    a2, b2 = e2[None, :, 0], e2[None, :, 1]

    def orient(p, q, r):
        return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - \
               (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])

    d1 = orient(a2, b2, a1)
    d2 = orient(a2, b2, b1)
    d3 = orient(a1, b1, a2)
    d4 = orient(a1, b1, b2)
    return ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & \
        (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)


def _pip_rings(points: np.ndarray, rings: Sequence[np.ndarray]) -> np.ndarray:
    """Even-odd membership of points in the region bounded by ``rings``."""
    if len(points) == 0:
        return np.zeros(0, bool)
    inside = np.zeros(len(points), bool)
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    for r in rings:
        r = np.asarray(r, np.float64)[:, :2]
        if len(r) >= 2 and np.array_equal(r[0], r[-1]):
            r = r[:-1]
        if len(r) < 3:
            continue
        ax, ay = r[:, 0][None], r[:, 1][None]
        bx = np.concatenate([r[1:, 0], r[:1, 0]])[None]
        by = np.concatenate([r[1:, 1], r[:1, 1]])[None]
        straddle = (ay <= py) != (by <= py)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (py - ay) / np.where(by == ay, 1.0, by - ay)
        xi = ax + t * (bx - ax)
        inside ^= ((straddle & (px < xi)).sum(axis=1) & 1).astype(bool)
    return inside


def _seg_point_dist(points: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Min distance from each point to any edge ([N] float64)."""
    if len(edges) == 0 or len(points) == 0:
        return np.full(len(points), np.inf)
    a = edges[None, :, 0]
    b = edges[None, :, 1]
    ab = b - a
    ap = points[:, None, :] - a
    denom = np.sum(ab * ab, axis=-1)
    t = np.clip(np.sum(ap * ab, axis=-1) / np.where(denom == 0, 1.0, denom),
                0.0, 1.0)
    proj = a + t[..., None] * ab
    d = points[:, None, :] - proj
    return np.sqrt(np.min(np.sum(d * d, axis=-1), axis=1))
