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

Port copy of ``mosaic_tpu.core.tessellate``.  The float64 classify and
clip passes run on the device as two hand-written kernels over flat CSR
inputs (``ops/tess_classify.py``, ``ops/tess_clip.py``), whose plain
PyTorch versions repeat the JAX package's numpy branches op for op, so a
ChipSet is bit-equal to that package's bit-exact parity path on either
device.  On H3, candidate cells come from the cell kernel over the
sampling lattice (``H3IndexSystem._point_to_cell_sample``).  The ChipSet
assembly stays on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..ops.tess_classify import classify_pairs_ref, tess_classify
from ..ops.tess_clip import closed_rings, tess_clip
from ..types import ChipSet
from .geometry.array import GeometryArray, GeometryBuilder, GeometryType
from .index.base import IndexSystem

__all__ = ["tessellate", "tessellate_subset", "polyfill", "point_chips",
           "convex_clip_rings", "classify_cells"]


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


def _edge_csr(edges_by) -> Tuple[np.ndarray, np.ndarray]:
    """Per-geometry [E_g, 2, 2] edge arrays -> (edges [E, 4], edge_off
    [G + 1]), the flat CSR the classify kernel reads."""
    ne = [len(e) for e in edges_by]
    edges = np.concatenate(edges_by).reshape(-1, 4) if sum(ne) else \
        np.zeros((0, 4))
    return edges, np.concatenate([[0], np.cumsum(ne)]).astype(np.int64)


def classify_cells(cell_verts: np.ndarray, cell_counts: np.ndarray,
                   centers: np.ndarray, edges: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Classify candidate cells against one polygon's edge soup.

    cell_verts [M, K, 2], cell_counts [M], centers [M, 2], edges [E, 2, 2].
    Returns (touching [M], core [M]).

    A cell is core only if all its vertices are inside the polygon, no
    polygon edge crosses it, AND no polygon vertex lies inside it — the
    last clause catches rings (holes, or whole multipolygon parts) that sit
    entirely inside one cell and therefore cross no cell boundary.  The
    crossing and vertex-in-cell tests run only on (cell, edge) pairs whose
    bboxes overlap.  Host numpy in, numpy out: the classify kernel's plain
    version with every cell paired with the one polygon."""
    m = len(cell_verts)
    edges_t, edge_off = _edge_csr([np.asarray(edges, np.float64)])
    touching, core = classify_pairs_ref(
        torch.from_numpy(edges_t), torch.from_numpy(edge_off),
        torch.zeros(m, dtype=torch.int64), torch.arange(m),
        torch.from_numpy(np.asarray(cell_verts, np.float64)),
        torch.from_numpy(np.asarray(cell_counts, np.int32)),
        torch.from_numpy(np.asarray(centers, np.float64)))
    return touching.numpy(), core.numpy()


# -------------------------------------------------- convex clipping (chips)

def convex_clip_rings(rings, clip_verts: np.ndarray,
                      clip_counts: np.ndarray, device: DeviceLike = None):
    """Clip polygon rings against many convex cells at once
    (Sutherland–Hodgman, every (ring, cell) pair a task of the clip
    kernel).

    rings: list of [V, 2] float64 (open or closed).  clip_verts [M, K, 2]
    CCW convex, clip_counts [M].  Returns ``out[cell][ring_index]`` =
    clipped ring ([V', 2], open) or None, preserving ring identity so
    callers can reassemble shells/holes per part.  Runs on the card
    unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    m = len(clip_verts)
    out = [[None] * len(rings) for _ in range(m)]
    pool, ids = [], []
    for ri, ring in enumerate(rings):
        r = np.asarray(ring, dtype=np.float64)[:, :2]
        if len(r) >= 2 and np.array_equal(r[0], r[-1]):
            r = r[:-1]
        if len(r) >= 3:
            pool.append(r)
            ids.append(ri)
    task_ring = np.repeat(np.arange(len(pool)), m)
    task_cell = np.tile(np.arange(m), len(pool))
    clipped = _clip_tasks(pool, task_ring, task_cell, clip_verts,
                          clip_counts, dev)
    for t, ring in enumerate(clipped):
        if ring is not None:
            out[task_cell[t]][ids[task_ring[t]]] = ring[:-1]
    return out


# ----------------------------------------------------------------- engine

def _on(dev: torch.device, *arrays):
    """The host arrays as contiguous tensors on ``dev``."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _classify_pairs(edges_by, pair_geo, pair_cell, uverts, ucounts,
                    ucenters, dev: torch.device
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(touching, core) of every (geometry, cell) pair by the classify
    kernel: ``edges_by`` one [E_g, 2, 2] array per geometry, ``pair_geo``
    its position there and ``pair_cell`` the row of the cell table
    (uverts [U, K, 2], ucounts [U], ucenters [U, 2])."""
    edges, edge_off = _edge_csr(edges_by)
    touching, core = tess_classify(*_on(
        dev, edges, edge_off, np.asarray(pair_geo, np.int64),
        np.asarray(pair_cell, np.int64), np.asarray(uverts, np.float64),
        np.asarray(ucounts, np.int32), np.asarray(ucenters, np.float64)))
    return touching.cpu().numpy(), core.cpu().numpy()


def _clip_tasks(ring_pool, task_ring, task_cell, uverts, ucounts,
                dev: torch.device) -> list:
    """The clip kernel over (ring, cell) tasks: ``ring_pool`` open [V, 2]
    rings (V >= 3), ``task_ring`` into it, ``task_cell`` rows of the cell
    table.  Returns a list of CLOSED [V' + 1, 2] arrays (or None where
    fewer than 3 vertices survive), one per task."""
    if not len(task_ring):
        return []
    ring_off = np.concatenate([[0], np.cumsum([len(r) for r in ring_pool])])
    xy, off, count = tess_clip(*_on(
        dev, np.concatenate(ring_pool), ring_off.astype(np.int64),
        np.asarray(task_ring, np.int64), np.asarray(task_cell, np.int64),
        np.asarray(uverts, np.float64), np.asarray(ucounts, np.int32)))
    return closed_rings(xy, off, count)


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
               keep_core_geom: bool = True,
               device: DeviceLike = None) -> ChipSet:
    """grid_tessellate / mosaicfill for a geometry batch.

    Reference: core/Mosaic.scala:22-99 (getChips → mosaicFill).  Polygons
    and multipolygons get core + border chips; lines get border chips along
    the path (lineFill, :101-156); points one chip each.

    The candidate sampling (H3), the classify pass and the clip pass run
    on ``device``: CUDA unless the caller passes ``"cpu"``, where the
    kernels' plain versions run.  The ChipSet is the same on both.
    """
    dev = resolve_device(device)
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
        got = grid.candidate_cells_batch(bboxes[sel], res, device=dev)
        for g, c in zip(sel, got):
            cand[g] = c
    ucells = np.unique(np.concatenate(cand)) if len(arr) else \
        np.empty(0, np.int64)
    if len(ucells):
        uverts, ucounts = grid.cell_boundary(ucells)
        ucenters = grid.cell_center(ucells)

    poly_types = (GeometryType.POLYGON, GeometryType.MULTIPOLYGON,
                  GeometryType.GEOMETRYCOLLECTION)

    # ---- batched polygon pre-pass: classify every (geometry, candidate
    # cell) pair in one kernel launch, then clip every (border cell, ring)
    # task in another — the per-geometry loop below only assembles
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
        pair_touch, pair_core = _classify_pairs(
            [_poly_edges(arr, g) for g in poly_sel],
            np.repeat(np.arange(len(poly_sel)),
                      [len(cand[g]) for g in poly_sel]),
            pair_ci, uverts, ucounts, ucenters, dev)
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
        clip_out = _clip_tasks(ring_pool, np.asarray(task_ring, np.int64),
                               pair_ci[task_pair], uverts, ucounts, dev)

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


def tessellate_subset(arr: GeometryArray, geom_ids: np.ndarray,
                      res: int, grid: IndexSystem,
                      keep_core_geom: bool = True,
                      device: DeviceLike = None
                      ) -> Tuple[GeometryArray, ChipSet]:
    """Tessellate only ``geom_ids`` of ``arr`` at ``res``, on ``device``
    as :func:`tessellate` (CUDA unless the caller passes ``"cpu"``).

    Returns ``(sub_arr, chips)`` where ``sub_arr = arr.take(geom_ids)``
    and ``chips.geom_id`` is **subset-local**: chip ``geom_id == j``
    refers to ``arr``'s geometry ``geom_ids[j]``; remap with
    ``np.asarray(geom_ids)[chips.geom_id]``.  ``geom_ids`` order is
    kept, so first-match over the subset agrees with first-match over
    ``arr`` restricted to it.  The refined PIP join deepens the dense
    cells' polygons with it."""
    dev = resolve_device(device)
    geom_ids = np.asarray(geom_ids, dtype=np.int64).reshape(-1)
    sub = arr.take(geom_ids)
    return sub, tessellate(sub, res, grid, keep_core_geom=keep_core_geom,
                           device=dev)


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


def polyfill(arr: GeometryArray, res: int, grid: IndexSystem,
             device: DeviceLike = None) -> list:
    """Cells whose center is inside each geometry (H3 polyfill semantics;
    reference: IndexSystem.polyfill:166).  Returns list of int64 arrays.
    The candidate cells are sampled on ``device`` (CUDA unless the caller
    passes ``"cpu"``; H3 only); the center test is host f64."""
    dev = resolve_device(device)
    out = []
    bboxes = arr.bboxes()
    for gi in range(len(arr)):
        bbox = bboxes[gi]
        if np.any(np.isnan(bbox)):
            out.append(np.empty(0, np.int64))
            continue
        cells = grid.candidate_cells_batch(bbox[None], res, device=dev)[0]
        if len(cells) == 0:
            out.append(np.empty(0, np.int64))
            continue
        centers = grid.cell_center(cells)
        edges = _poly_edges(arr, gi)
        inside = _pip(centers, edges)
        out.append(cells[inside])
    return out
