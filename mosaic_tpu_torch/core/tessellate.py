"""Tessellation engine: geometry → (is_core, cell, chip) rows.

Reference counterpart: core/Mosaic.scala:20-240 (getChips / mosaicFill /
lineFill / pointChip / geometryKRing / geometryKLoop) — the PIP-join
accelerator.  The reference classifies cells with a negative-buffer carve +
polyfill + per-cell JTS intersection (core/Mosaic.scala:61-99).

TPU-first redesign (no buffering, no row loop):
  1. candidate cells from the grid for the geometry bbox
  2. one vectorized pass classifies every candidate:
       touching  = any polygon edge crosses the cell, or cell center /
                   vertex inside polygon, or polygon vertex inside cell
       core      = all cell vertices inside AND no edge crosses
  3. border chips = polygon rings clipped to the (convex) cell via a
     vectorized Sutherland–Hodgman over all border cells at once.
This is *exact* where the reference's buffer trick is approximate, and it
is dense masked arithmetic.

Port copy of ``mosaic_tpu.core.tessellate``: its float64 numpy branches
only (the JAX package's bit-exact parity path).  Tessellation is index
build, not the per-point hot path; the f64 device kernels of the JAX
package (pair check, parity block, clip buckets) come in a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..perf.bucketing import iter_size_buckets
from ..types import ChipSet
from .geometry.array import GeometryArray, GeometryBuilder, GeometryType
from .index.base import IndexSystem

__all__ = ["tessellate", "point_chips", "convex_clip_rings",
           "classify_cells"]


# --------------------------------------------------------------- primitives

def _poly_edges(arr: GeometryArray, gi: int) -> np.ndarray:
    """All directed edges of geometry gi as [E, 2, 2] float64 (rings closed)."""
    _, parts = arr.geom_slices(gi)
    segs = []
    for rings in parts:
        for ring in rings:
            if len(ring) < 2:
                continue
            r = ring[:, :2]
            if not np.array_equal(r[0], r[-1]):
                r = np.vstack([r, r[:1]])
            segs.append(np.stack([r[:-1], r[1:]], axis=1))
    if not segs:
        return np.zeros((0, 2, 2))
    return np.concatenate(segs)


def _pip(points: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Crossing-number PIP, half-open rule; points [N,2], edges [E,2,2]."""
    if len(edges) == 0 or len(points) == 0:
        return np.zeros(len(points), dtype=bool)
    px = points[:, None, 0]
    py = points[:, None, 1]
    ax, ay = edges[None, :, 0, 0], edges[None, :, 0, 1]
    bx, by = edges[None, :, 1, 0], edges[None, :, 1, 1]
    straddle = (ay <= py) != (by <= py)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (py - ay) / np.where(by == ay, 1.0, by - ay)
    xi = ax + t * (bx - ax)
    hits = straddle & (px < xi)
    return (hits.sum(axis=1) & 1).astype(bool)


def _seg_cross(a1, b1, a2, b2) -> np.ndarray:
    """Broadcast segment intersection (touching counts)."""
    def orient(p, q, r):
        return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - \
               (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])

    d1 = orient(a2, b2, a1)
    d2 = orient(a2, b2, b1)
    d3 = orient(a1, b1, a2)
    d4 = orient(a1, b1, b2)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & \
             (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)

    def on_seg(p, q, r, d):
        return (d == 0) & \
            (np.minimum(p[..., 0], q[..., 0]) <= r[..., 0]) & \
            (r[..., 0] <= np.maximum(p[..., 0], q[..., 0])) & \
            (np.minimum(p[..., 1], q[..., 1]) <= r[..., 1]) & \
            (r[..., 1] <= np.maximum(p[..., 1], q[..., 1]))

    touch = on_seg(a2, b2, a1, d1) | on_seg(a2, b2, b1, d2) | \
        on_seg(a1, b1, a2, d3) | on_seg(a1, b1, b2, d4)
    return proper | touch


def _pair_check(a1: np.ndarray, b1: np.ndarray, a2: np.ndarray,
                b2: np.ndarray, vmask: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact edge-cross + vertex-in-cell test for P (cell, edge) pairs.

    a1/b1 [P, K, 2] = each pair's cell vertex ring (vertex and its
    successor), a2/b2 [P, 2] = the pair's polygon edge, vmask [P, K].
    Returns (hit [P], inside [P]): hit = the edge crosses/touches any
    valid cell side; inside = the edge's START vertex sits inside the
    convex CCW cell (all cross products >= 0).

    This is the sparse-pair half of cell classification.  The JAX
    package runs it as a jitted f64 kernel when x64 is on; this is its
    numpy branch, the bit-exact parity reference."""
    P, K = a1.shape[:2]
    hit = np.zeros(P, dtype=bool)
    inside = np.zeros(P, dtype=bool)
    if P == 0:
        return hit, inside
    a2b = a2[:, None, :]
    b2b = b2[:, None, :]
    hit = (_seg_cross(a1, b1, a2b, b2b) & vmask).any(axis=1)
    ev = b1 - a1
    pvec = a2b - a1
    crossz = ev[..., 0] * pvec[..., 1] - ev[..., 1] * pvec[..., 0]
    inside = np.all((crossz >= 0) | ~vmask, axis=1)
    return hit, inside


def classify_cells(cell_verts: np.ndarray, cell_counts: np.ndarray,
                   centers: np.ndarray, edges: np.ndarray,
                   block: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Classify candidate cells against one polygon's edge soup.

    cell_verts [M, K, 2], cell_counts [M], centers [M, 2], edges [E, 2, 2].
    Returns (touching [M], core [M]).

    A cell is core only if all its vertices are inside the polygon, no
    polygon edge crosses it, AND no polygon vertex lies inside it — the
    last clause catches rings (holes, or whole multipolygon parts) that sit
    entirely inside one cell and therefore cross no cell boundary.

    The O(M*E) crossing and vertex-in-cell tests only matter for (cell,
    edge) pairs whose bboxes overlap — a sparse set (each edge overlaps a
    handful of cells), so both run on the nonzero pairs of a cheap bbox
    overlap matrix instead of the dense [M, K, E] broadcast (which was
    half of tessellation time on the 281-zone bench).  The crossing-number
    tests (center/vertex in polygon) need every edge's parity and stay
    dense.
    """
    m, kmax = cell_verts.shape[:2]
    touching = np.zeros(m, dtype=bool)
    core = np.zeros(m, dtype=bool)
    if m == 0:
        return touching, core
    center_in = _pip(centers, edges)
    # cell vertices inside polygon
    vmask = np.arange(kmax)[None, :] < cell_counts[:, None]
    flat = cell_verts.reshape(-1, 2)
    vin = _pip(flat, edges).reshape(m, kmax)
    all_in = np.all(vin | ~vmask, axis=1)
    any_in = np.any(vin & vmask, axis=1)

    inside_cell = np.zeros(m, dtype=bool)
    crossed = np.zeros(m, dtype=bool)
    if len(edges):
        vx = np.where(vmask, cell_verts[..., 0], np.inf)
        vy = np.where(vmask, cell_verts[..., 1], np.inf)
        cb = np.stack([vx.min(1), vy.min(1),
                       np.where(vmask, cell_verts[..., 0],
                                -np.inf).max(1),
                       np.where(vmask, cell_verts[..., 1],
                                -np.inf).max(1)], axis=-1)   # [M, 4]
        del vx, vy
        ex0 = np.minimum(edges[:, 0, 0], edges[:, 1, 0])
        ex1 = np.maximum(edges[:, 0, 0], edges[:, 1, 0])
        ey0 = np.minimum(edges[:, 0, 1], edges[:, 1, 1])
        ey1 = np.maximum(edges[:, 0, 1], edges[:, 1, 1])
        ci_l, ei_l = [], []
        for s in range(0, m, block):
            e0 = min(s + block, m)
            ov = (cb[s:e0, 0, None] <= ex1[None, :]) & \
                 (ex0[None, :] <= cb[s:e0, 2, None]) & \
                 (cb[s:e0, 1, None] <= ey1[None, :]) & \
                 (ey0[None, :] <= cb[s:e0, 3, None])
            a, b = np.nonzero(ov)
            ci_l.append(a + s)
            ei_l.append(b)
        ci = np.concatenate(ci_l)
        ei = np.concatenate(ei_l)
        if len(ci):
            k = np.arange(kmax)
            nxt_idx = np.where(k[None, :] + 1 >= cell_counts[:, None], 0,
                               k[None, :] + 1)
            cv_next = np.take_along_axis(cell_verts, nxt_idx[:, :, None],
                                         axis=1)
            # exact crossing + polygon-(start-)vertex-inside-cell, one
            # bucketed kernel over the sparse pairs
            hit, inside = _pair_check(cell_verts[ci], cv_next[ci],
                                      edges[ei, 0], edges[ei, 1],
                                      vmask[ci])
            np.logical_or.at(crossed, ci, hit)
            np.logical_or.at(inside_cell, ci, inside)

    core = all_in & ~crossed & ~inside_cell
    touching = crossed | center_in | any_in | inside_cell | core
    return touching, core


# -------------------------------------------------- convex clipping (chips)

def _sh_halfplane(subj, counts, p0, p1, active):
    """One Sutherland–Hodgman half-plane pass over a batch of subject
    polygons (the shared kernel behind convex_clip_rings and
    convex_clip_tasks — keeping two hand-synced copies of this math is
    how subtle divergences start).

    subj [M, V, 2], counts [M]; p0, p1 [M, 2] = the clip edge
    (interior left); active [M] = rows whose clip polygon still has
    edges (inactive rows pass through untouched).  Returns
    (subj', counts')."""
    m = len(subj)
    ev = p1 - p0
    vmax = subj.shape[1]
    vidx = np.arange(vmax)
    valid = vidx[None, :] < counts[:, None]
    cur = subj
    nxt_v = np.take_along_axis(
        subj, np.where(vidx[None, :] + 1 >= counts[:, None],
                       0, vidx[None, :] + 1)[:, :, None], axis=1)
    d_cur = ev[:, None, 0] * (cur[..., 1] - p0[:, None, 1]) - \
        ev[:, None, 1] * (cur[..., 0] - p0[:, None, 0])
    d_nxt = ev[:, None, 0] * (nxt_v[..., 1] - p0[:, None, 1]) - \
        ev[:, None, 1] * (nxt_v[..., 0] - p0[:, None, 0])
    in_cur = d_cur >= 0
    in_nxt = d_nxt >= 0
    denom = d_cur - d_nxt
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(denom != 0,
                     d_cur / np.where(denom == 0, 1.0, denom), 0.0)
    inter = cur + t[..., None] * (nxt_v - cur)
    emit_v = in_cur & valid
    emit_i = (in_cur != in_nxt) & valid
    n_emit = emit_v.astype(np.int64) + emit_i.astype(np.int64)
    pos = np.cumsum(n_emit, axis=1) - n_emit
    new_count = n_emit.sum(axis=1)
    new_vmax = max(int(new_count.max(initial=0)), 1)
    new_subj = np.zeros((m, new_vmax, 2))
    ci, vi = np.nonzero(emit_v)
    new_subj[ci, pos[ci, vi]] = cur[ci, vi]
    ci, vi = np.nonzero(emit_i)
    new_subj[ci, pos[ci, vi] + emit_v[ci, vi]] = inter[ci, vi]
    if not np.all(active):
        keep = ~active
        old_vmax = subj.shape[1]
        if new_vmax < old_vmax:
            new_subj = np.pad(
                new_subj, ((0, 0), (0, old_vmax - new_vmax), (0, 0)))
        new_subj[keep, :old_vmax] = subj[keep]
        new_count = np.where(active, new_count, counts)
    return new_subj, new_count


def _parity_block(eg: np.ndarray, px: np.ndarray, py: np.ndarray,
                  block: int) -> np.ndarray:
    """Crossing parity of Q query points per pair vs the pair's own
    padded edge set: eg [B, Epad, 2, 2], px/py [B, Q] -> [B, Q] bool.

    The numpy branch of the JAX package's jitted f64 kernel —
    classification is an exact-f64 contract."""
    ax, ay = eg[..., 0, 0], eg[..., 0, 1]
    bx, by = eg[..., 1, 0], eg[..., 1, 1]
    straddle = (ay[:, None, :] <= py[..., None]) != \
        (by[:, None, :] <= py[..., None])
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (py[..., None] - ay[:, None, :]) / \
            np.where(by == ay, 1.0, by - ay)[:, None, :]
        xi = ax[:, None, :] + t * (bx - ax)[:, None, :]
        hits = straddle & (px[..., None] < xi)
    return (hits.sum(axis=-1) & 1).astype(bool)


def classify_cells_multi(cell_verts: np.ndarray,
                         cell_counts: np.ndarray,
                         centers: np.ndarray, geo_of: np.ndarray,
                         edges_pad: np.ndarray, block: int = 4096
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """classify_cells for (cell, geometry) PAIRS across many geometries.

    cell_verts [N, K, 2], cell_counts [N], centers [N, 2];
    geo_of [N] indexes into edges_pad [G, Epad, 2, 2] (unused edge
    rows hold +inf sentinels, which fail every test naturally).  Same classification semantics as
    classify_cells — this is the round-4 batch form that removes the
    per-geometry Python pass (3k+ calls of ~25 numpy ops each were a
    quarter of county-scale tessellation, VERDICT round-3 weak #4)."""
    npair, kmax = cell_verts.shape[:2]
    touching = np.zeros(npair, dtype=bool)
    core = np.zeros(npair, dtype=bool)
    if npair == 0:
        return touching, core
    vmask = np.arange(kmax)[None, :] < cell_counts[:, None]
    # geometry-level edge bboxes (sentinels make empty rows non-matching)
    ex0 = np.minimum(edges_pad[..., 0, 0], edges_pad[..., 1, 0])
    ex1 = np.maximum(edges_pad[..., 0, 0], edges_pad[..., 1, 0])
    ey0 = np.minimum(edges_pad[..., 0, 1], edges_pad[..., 1, 1])
    ey1 = np.maximum(edges_pad[..., 0, 1], edges_pad[..., 1, 1])
    k = np.arange(kmax)
    nxt_idx = np.where(k[None, :] + 1 >= cell_counts[:, None], 0,
                       k[None, :] + 1)
    cv_next = np.take_along_axis(cell_verts, nxt_idx[:, :, None],
                                 axis=1)
    vx = np.where(vmask, cell_verts[..., 0], np.inf)
    vy = np.where(vmask, cell_verts[..., 1], np.inf)
    cb0 = vx.min(1)
    cb1 = vy.min(1)
    cb2 = np.where(vmask, cell_verts[..., 0], -np.inf).max(1)
    cb3 = np.where(vmask, cell_verts[..., 1], -np.inf).max(1)
    del vx, vy
    all_in = np.zeros(npair, bool)
    any_in = np.zeros(npair, bool)
    center_in = np.zeros(npair, bool)
    inside_cell = np.zeros(npair, bool)
    crossed = np.zeros(npair, bool)
    for s in range(0, npair, block):
        e0 = min(s + block, npair)
        g = geo_of[s:e0]
        eg = edges_pad[g]                         # [B, Epad, 2, 2]
        # one parity pass covers the center + all K cell vertices
        px = np.concatenate([centers[s:e0, 0:1],
                             cell_verts[s:e0, :, 0]], axis=1)
        py = np.concatenate([centers[s:e0, 1:2],
                             cell_verts[s:e0, :, 1]], axis=1)
        par = _parity_block(eg, px, py, block)
        center_in[s:e0] = par[:, 0]
        vin = par[:, 1:]
        all_in[s:e0] = np.all(vin | ~vmask[s:e0], axis=1)
        any_in[s:e0] = np.any(vin & vmask[s:e0], axis=1)

        # bbox-sparse exact crossing + vertex-in-cell
        ov = (cb0[s:e0, None] <= ex1[g]) & (ex0[g] <= cb2[s:e0, None]) \
            & (cb1[s:e0, None] <= ey1[g]) & (ey0[g] <= cb3[s:e0, None])
        ci, ei = np.nonzero(ov)
        if len(ci):
            hit, inside = _pair_check(cell_verts[s + ci],
                                      cv_next[s + ci],
                                      eg[ci, ei, 0], eg[ci, ei, 1],
                                      vmask[s + ci])
            np.logical_or.at(crossed, s + ci, hit)
            np.logical_or.at(inside_cell, s + ci, inside)
    core = all_in & ~crossed & ~inside_cell
    touching = crossed | center_in | any_in | inside_cell | core
    return touching, core


def _sh_all_planes(subj, counts, cv, cc):
    """Run every half-plane of each task's clip polygon through the
    interpreted _sh_halfplane kernel — the single host driver behind
    convex_clip_rings and convex_clip_tasks."""
    m = len(subj)
    kmax = cv.shape[1]
    for kk in range(kmax):
        active = kk < cc
        p0 = cv[:, kk]
        nxt = np.where(kk + 1 >= cc, 0, kk + 1)
        p1 = cv[np.arange(m), nxt]
        subj, counts = _sh_halfplane(subj, counts, p0, p1, active)
    return subj, counts


def convex_clip_tasks(ring_pool, task_ring: np.ndarray,
                      clip_verts: np.ndarray,
                      clip_counts: np.ndarray):
    """Sutherland–Hodgman over a flat (ring, cell) TASK stream.

    ring_pool: list of [V, 2] f64 open rings (pre-deduped, len >= 3).
    task_ring [T] indexes ring_pool; clip_verts [T, K, 2] CCW convex,
    clip_counts [T].  Returns a list of CLOSED [V'+1, 2] arrays (or
    None) per task.  This is convex_clip_rings with the per-geometry Python pass
    flattened away: tasks bucket by ring size and each bucket runs the
    half-plane loop ONCE over all its tasks (the per-geometry variant
    ran ~15 numpy ops per geometry per half-plane on ~12-cell
    batches — pure overhead at county scale)."""
    T = len(task_ring)
    out = [None] * T
    if T == 0:
        return out
    sizes = np.array([len(ring_pool[r]) for r in task_ring])
    kmax = clip_verts.shape[1]
    for vcur, sel in iter_size_buckets(sizes, floor=4):
        m = len(sel)
        # pad each DISTINCT ring once, then gather per task (a ring is
        # clipped against many cells; per-task filling dominated the
        # whole clip pass)
        uring, uinv = np.unique(task_ring[sel], return_inverse=True)
        upad = np.zeros((len(uring), vcur, 2))
        ulen = np.zeros(len(uring), np.int64)
        for j, rid in enumerate(uring):
            r = ring_pool[rid]
            upad[j, :len(r)] = r
            ulen[j] = len(r)
        subj = upad[uinv].copy()
        counts = ulen[uinv]
        cv = clip_verts[sel]
        cc = clip_counts[sel]
        subj, counts = _sh_all_planes(subj, counts, cv, cc)
        # close rings in one vectorized pass (callers previously
        # vstack'd a wrap vertex per chip — 68k calls at county scale)
        subj = np.concatenate(
            [subj, np.zeros((m, 1, 2))], axis=1)
        rows = np.arange(m)
        subj[rows, counts] = subj[rows, 0]
        for i, t in enumerate(sel):
            c = int(counts[i])
            if c >= 3:
                out[t] = subj[i, :c + 1]
    return out


def convex_clip_rings(rings, clip_verts: np.ndarray,
                      clip_counts: np.ndarray):
    """Clip polygon rings against many convex cells at once
    (Sutherland–Hodgman, vectorized over cells).

    rings: list of [V, 2] float64 (open or closed).  clip_verts [M, K, 2]
    CCW convex, clip_counts [M].  Returns ``out[cell][ring_index]`` =
    clipped ring ([V', 2]) or None, preserving ring identity so callers can
    reassemble shells/holes per part.  The hot math is the per-half-plane
    pass over all cells simultaneously; the ragged re-assembly is
    host-side.
    """
    m, kmax = clip_verts.shape[:2]
    out = [[None] * len(rings) for _ in range(m)]
    for ri, ring in enumerate(rings):
        r = np.asarray(ring, dtype=np.float64)[:, :2]
        if len(r) >= 2 and np.array_equal(r[0], r[-1]):
            r = r[:-1]
        if len(r) < 3:
            continue
        # current subject per cell: [M, Vcur, 2] + mask
        subj = np.broadcast_to(r[None], (m, len(r), 2)).copy()
        counts = np.full(m, len(r), dtype=np.int64)
        subj, counts = _sh_all_planes(subj, counts, clip_verts,
                                      clip_counts)
        for i in range(m):
            c = int(counts[i])
            if c >= 3:
                out[i][ri] = subj[i, :c]
    return out


# ----------------------------------------------------------------- engine

def point_chips(arr: GeometryArray, res: int, grid: IndexSystem,
                geom_ids: Optional[np.ndarray] = None) -> ChipSet:
    """Chips for POINT geometries: one non-core chip per point
    (reference: Mosaic.pointChip, core/Mosaic.scala:48-59)."""
    starts = arr.vertex_starts()[:-1]
    pts = arr.coords[starts, :2]
    cells = grid.point_to_cell(pts, res)
    builder = GeometryBuilder(srid=arr.srid)
    for p in pts:
        builder.add_point(p)
    gids = geom_ids if geom_ids is not None else np.arange(len(arr))
    return ChipSet(gids, cells, np.zeros(len(arr), bool), builder.finish())


def tessellate(arr: GeometryArray, res: int, grid: IndexSystem,
               keep_core_geom: bool = True) -> ChipSet:
    """grid_tessellate / mosaicfill for a geometry batch.

    Reference: core/Mosaic.scala:22-99 (getChips → mosaicFill).  Polygons
    and multipolygons get core + border chips; lines get border chips along
    the path (lineFill, :101-156); points one chip each.
    """
    parts_out = []
    bboxes = arr.bboxes()
    # one shared candidate pass for all area/line geometries (see
    # IndexSystem.candidate_cells_batch), plus per-unique-cell boundary/
    # center cache: neighboring geometries share most candidate cells,
    # so boundary development is hoisted out of the per-geometry loop
    is_areal = np.array([arr.geom_type(g) not in
                         (GeometryType.POINT, GeometryType.MULTIPOINT)
                         for g in range(len(arr))])
    cand = [np.empty(0, np.int64)] * len(arr)
    if is_areal.any():
        sel = np.nonzero(is_areal)[0]
        got = grid.candidate_cells_batch(bboxes[sel], res)
        for g, c in zip(sel, got):
            cand[g] = c
    ucells = np.unique(np.concatenate(cand)) if len(arr) else \
        np.empty(0, np.int64)
    if len(ucells):
        uverts, ucounts = grid.cell_boundary(ucells)
        ucenters = grid.cell_center(ucells)

    poly_types = (GeometryType.POLYGON, GeometryType.MULTIPOLYGON,
                  GeometryType.GEOMETRYCOLLECTION)

    # ---- batched polygon pre-pass (round-4): classify every
    # (geometry, candidate-cell) pair in edge-count buckets, then clip
    # every (border cell, ring) task in ring-size buckets — the
    # per-geometry loop below only assembles.  (The per-geometry
    # classify+clip calls were ~2/3 of county-scale tessellation.)
    poly_sel = [g for g in range(len(arr))
                if arr.geom_type(g) in poly_types and len(cand[g])]
    pair_touch = pair_core = None
    if poly_sel:
        pair_off = {}
        off = 0
        for g in poly_sel:
            pair_off[g] = off
            off += len(cand[g])
        pair_g = np.concatenate([np.full(len(cand[g]), g, np.int64)
                                 for g in poly_sel])
        pair_ci = np.concatenate([np.searchsorted(ucells, cand[g])
                                  for g in poly_sel])
        pverts = uverts[pair_ci]
        pcounts = ucounts[pair_ci]
        pcenters = ucenters[pair_ci]
        edges_by = {g: _poly_edges(arr, g) for g in poly_sel}
        nume = np.array([len(edges_by[g]) for g in poly_sel])
        pair_touch = np.zeros(len(pair_g), bool)
        pair_core = np.zeros(len(pair_g), bool)
        loc = np.full(len(arr), -1, np.int64)
        for epad, gsel in iter_size_buckets(nume, floor=4):
            bucket = [poly_sel[j] for j in gsel]
            loc[:] = -1
            loc[bucket] = np.arange(len(bucket))
            psel = np.nonzero(loc[pair_g] >= 0)[0]
            edges_pad = np.full((len(bucket), epad, 2, 2), np.inf)
            for j, g in enumerate(bucket):
                eg = edges_by[g]
                edges_pad[j, :len(eg)] = eg
            t_, c_ = classify_cells_multi(
                pverts[psel], pcounts[psel], pcenters[psel],
                loc[pair_g[psel]], edges_pad)
            pair_touch[psel] = t_
            pair_core[psel] = c_
        # ---- flat clip-task stream over border pairs
        ring_pool = []
        ring_ids = {}                # g -> ring indexes into pool
        ring_is_shell = {}
        for g in poly_sel:
            _, gparts = arr.geom_slices(g)
            ids, shells = [], []
            for rings in gparts:
                for k2, r in enumerate(rings):
                    r = np.asarray(r, np.float64)[:, :2]
                    if len(r) >= 2 and np.array_equal(r[0], r[-1]):
                        r = r[:-1]
                    if len(r) < 3:
                        ids.append(-1)
                    else:
                        ids.append(len(ring_pool))
                        ring_pool.append(r)
                    shells.append(k2 == 0)
            ring_ids[g] = ids
            ring_is_shell[g] = shells
        # tasks laid out CSR: for border pair bi, its geometry's valid
        # rings occupy clip_out[tstart[bi] : tstart[bi+1]] in ring order
        vpos = {g: [rp for rp, rid in enumerate(ring_ids[g])
                    if rid >= 0] for g in poly_sel}
        vrid = {g: [rid for rid in ring_ids[g] if rid >= 0]
                for g in poly_sel}
        border_pair = np.nonzero(pair_touch & ~pair_core)[0]
        nval = np.array([len(vrid[pair_g[p]]) for p in border_pair],
                        np.int64)
        tstart = np.concatenate([[0], np.cumsum(nval)])
        task_ring = np.concatenate(
            [vrid[pair_g[p]] for p in border_pair]) \
            if len(border_pair) else np.empty(0, np.int64)
        task_pair = np.repeat(border_pair, nval) \
            if len(border_pair) else np.empty(0, np.int64)
        clip_out = convex_clip_tasks(
            ring_pool, np.asarray(task_ring, np.int64),
            pverts[task_pair] if len(task_pair) else
            np.zeros((0, pverts.shape[1], 2)),
            pcounts[task_pair] if len(task_pair) else
            np.zeros(0, np.int64))

    for gi in range(len(arr)):
        t = arr.geom_type(gi)
        if t == GeometryType.POINT or t == GeometryType.MULTIPOINT:
            v0, v1 = arr.vertex_starts()[gi], arr.vertex_starts()[gi + 1]
            pts = arr.coords[v0:v1, :2]
            cell_of = grid.point_to_cell(pts, res)
            cells = np.unique(cell_of)
            b = GeometryBuilder(srid=arr.srid)
            for c in cells:
                in_c = pts[cell_of == c]
                if len(in_c) == 1:
                    b.add_point(in_c[0])
                else:
                    b.add(GeometryType.MULTIPOINT, [[p[None]] for p in in_c])
            parts_out.append(ChipSet(np.full(len(cells), gi), cells,
                                     np.zeros(len(cells), bool), b.finish()))
            continue

        cells = cand[gi]
        if len(cells) == 0:
            continue
        ci = np.searchsorted(ucells, cells)
        verts, counts = uverts[ci], ucounts[ci]
        centers = ucenters[ci]

        if t in poly_types:
            p0 = pair_off[gi]
            sl = slice(p0, p0 + len(cells))
            core = pair_core[sl]
            touching = pair_touch[sl]
            core_cells = cells[core]
            border_rows = np.nonzero(touching & ~core)[0]
            border_cells = cells[border_rows]
            # core chips
            b = GeometryBuilder(srid=arr.srid)
            if keep_core_geom:
                cverts, ccounts = verts[core], counts[core]
                # place the wrap vertex at each row's own count (the
                # boundary rows are padded by REPEATING the last valid
                # vertex, so slicing the concat'd column only works for
                # full-width hexagons — pentagons need the explicit
                # per-row wrap)
                wrapped = np.concatenate([cverts, cverts[:, :1]],
                                         axis=1)
                rws = np.arange(len(core_cells))
                wrapped[rws, ccounts] = cverts[rws, 0] \
                    if len(core_cells) else 0
                b.add_shell_polygons(
                    [wrapped[i, :ccounts[i] + 1]
                     for i in range(len(core_cells))])
            else:
                b.add_empty_polygons(len(core_cells))
            # border chips: gather the flat clip-task outputs, then
            # reassemble per part so shells/holes keep their roles even
            # when some part's shell clips away entirely
            shells = ring_is_shell[gi]
            gvpos = vpos[gi]
            keep_border = []
            run = []                 # pending single-shell chips (bulk)
            bis = np.searchsorted(border_pair, p0 + border_rows)

            def _flush():
                if run:
                    b.add_shell_polygons(run)
                    run.clear()

            for i, row in enumerate(border_rows):
                t0_ = tstart[bis[i]]
                polys = []           # (shell, [holes]) per surviving part
                cur = None
                jptr = 0
                for rpos, is_shell in enumerate(shells):
                    if jptr < len(gvpos) and gvpos[jptr] == rpos:
                        rr = clip_out[t0_ + jptr]
                        jptr += 1
                    else:
                        rr = None     # degenerate ring: no clip task
                    if is_shell:
                        cur = None    # resets even when the shell died
                        if rr is not None:
                            cur = (rr, [])
                            polys.append(cur)
                    elif rr is not None and cur is not None:
                        cur[1].append(rr)
                if not polys:
                    continue
                keep_border.append(i)
                if len(polys) == 1 and not polys[0][1]:
                    run.append(polys[0][0])
                    continue
                _flush()
                if len(polys) == 1:
                    b.add_polygon(polys[0][0], polys[0][1])
                else:
                    b.add(GeometryType.MULTIPOLYGON,
                          [[s2, *hs] for s2, hs in polys])
            _flush()
            border_cells = border_cells[keep_border]
            n_core, n_border = len(core_cells), len(border_cells)
            parts_out.append(ChipSet(
                np.full(n_core + n_border, gi),
                np.concatenate([core_cells, border_cells]),
                np.concatenate([np.ones(n_core, bool),
                                np.zeros(n_border, bool)]),
                b.finish()))
        elif t in (GeometryType.LINESTRING, GeometryType.MULTILINESTRING):
            # lineFill: cells the line passes through; chip = clipped line
            edges = _poly_edges(arr, gi)
            hit = _line_cells_mask(verts, counts, edges)
            line_cells = cells[hit]
            b = GeometryBuilder(srid=arr.srid)
            keep = []
            for i, ci in enumerate(np.nonzero(hit)[0]):
                segs = _clip_line_to_cell(edges, verts[ci], counts[ci])
                if not segs:
                    continue
                keep.append(i)
                if len(segs) == 1:
                    b.add_linestring(segs[0])
                else:
                    b.add(GeometryType.MULTILINESTRING,
                          [[s] for s in segs])
            line_cells = line_cells[keep]
            parts_out.append(ChipSet(
                np.full(len(line_cells), gi), line_cells,
                np.zeros(len(line_cells), bool), b.finish()))
        else:
            raise ValueError(f"unsupported geometry type {t}")
    return ChipSet.concat(parts_out)


def _line_cells_mask(verts, counts, edges) -> np.ndarray:
    """Cells any line segment touches (segment-cell edge cross or segment
    endpoint inside cell)."""
    m, kmax = verts.shape[:2]
    if len(edges) == 0:
        return np.zeros(m, dtype=bool)
    k = np.arange(kmax)
    nxt = np.where(k[None, :] + 1 >= counts[:, None], 0, k[None, :] + 1)
    vnext = np.take_along_axis(verts, nxt[:, :, None], axis=1)
    a1 = verts[:, :, None, :]
    b1 = vnext[:, :, None, :]
    a2 = edges[None, None, :, 0, :]
    b2 = edges[None, None, :, 1, :]
    hit = _seg_cross(a1, b1, a2, b2)
    hit &= (k[None, :] < counts[:, None])[:, :, None]
    crossed = np.any(hit, axis=(1, 2))
    # endpoint containment (half-plane, convex CCW cells)
    p = edges[:, 0, :]
    ev = vnext - verts
    pv = p[None, None, :, :] - verts[:, :, None, :]
    cz = ev[..., None, 0] * pv[..., 1] - ev[..., None, 1] * pv[..., 0]
    vmask = (k[None, :] < counts[:, None])[:, :, None]
    inside = np.any(np.all((cz >= 0) | ~vmask, axis=1), axis=-1)
    return crossed | inside


def _clip_line_to_cell(edges, cell_verts, cell_count):
    """Clip line segments to one convex cell (Liang–Barsky per segment),
    merging consecutive collinear-continuation pieces into polylines."""
    cv = cell_verts[:cell_count]
    nxt = np.roll(cv, -1, axis=0)
    ev = nxt - cv
    segs = []
    for a, b in edges:
        d = b - a
        t0, t1 = 0.0, 1.0
        ok = True
        for j in range(len(cv)):
            # inside = left of edge (CCW)
            nx, ny = -ev[j, 1], ev[j, 0]
            denom = nx * d[0] + ny * d[1]
            dist = nx * (a[0] - cv[j, 0]) + ny * (a[1] - cv[j, 1])
            if abs(denom) < 1e-300:
                if dist < 0:
                    ok = False
                    break
            else:
                t = -dist / denom
                if denom > 0:
                    t0 = max(t0, t)
                else:
                    t1 = min(t1, t)
                if t0 > t1:
                    ok = False
                    break
        if ok and t1 > t0:
            segs.append(np.stack([a + t0 * d, a + t1 * d]))
    # merge consecutive segments sharing endpoints
    merged = []
    for s in segs:
        if merged and np.allclose(merged[-1][-1], s[0]):
            merged[-1] = np.vstack([merged[-1], s[1:]])
        else:
            merged.append(s)
    return merged
