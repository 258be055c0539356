"""Polygon x polygon overlay on one device: ST_Intersects and the
intersection area.

Port of the single-device path of ``mosaic_tpu.parallel.overlay``
(``mesh=None``).  Reference mechanism: Spark equi-joins tessellated chips
on cell id (expressions/index/MosaicExplode.scala:70-79), so two polygons
are candidates only where they share a cell.

Pipeline:

  1. tessellate both sides with ``keep_core_geom=True`` (a core chip
     carries its whole cell) and pack the chips into rows: cell id,
     geometry id, f32 origin-local edges [N, E, 4], valid
     (:func:`pack_chip_rows`, on the host);
  2. on the device, sort the A rows by cell, find each B row's A rows of
     the same cell and run the f32 chip-pair test on every match, one
     launch of the chip-pair kernel (``ops/overlay_pairs.py``): edge
     crossings plus a representative-vertex containment test each way;
  3. the result is a dense [GA, GB] hits and hazards matrix
     (:func:`overlay_intersects`) or the ragged list of chip-row pairs
     that hit or are flagged (:func:`overlay_row_pairs`), whose exact
     areas the native kernel sums per geometry pair
     (:func:`overlay_intersection_area`).

Exactness contract (the JAX package's): an f32 hazard — edges within eps
of touching, or a representative vertex within eps of the other chip's
boundary, with eps = max(EPS_DEG, 64 ulp of the local frame's extent) —
flags the geometry pair, and every flagged pair is settled on the host in
f64 against the ORIGINAL geometries (:func:`overlay_host_pair`).  Two
polygons that share a cell but do not touch do not intersect: the cell is
only the candidate filter.

The sharded exchange of the JAX package (``mesh``/``axis``, the cell-hash
all-to-all) is not ported; each entry point runs on CUDA unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.geometry.array import GeometryArray
from ..core.geometry.padded import build_edges_np
from ..core.index.base import IndexSystem
from ..core.tessellate import _pip, _poly_edges, _seg_cross, tessellate
from ..ops.overlay_pairs import ChipRows, overlay_dense, overlay_pairs
from ..types import ChipSet

EPS_DEG = 1e-6


# ----------------------------------------------------------- host packing

def pack_chip_rows(polys: GeometryArray, res: int, grid: IndexSystem,
                   chips: Optional[ChipSet] = None,
                   origin: Optional[np.ndarray] = None,
                   device: DeviceLike = None):
    """ChipSet -> dense rows (cell i64, geom i32, edges [N, E, 4] f32
    origin-local with 1e9 padding, valid bool, origin, chips).

    Core chips are fully covered by their polygon, so for the overlay a
    core chip is the cell itself: ``tessellate(keep_core_geom=True)``
    emits the cell polygon for it; without ``chips`` it tessellates on
    ``device``."""
    if chips is None:
        chips = tessellate(polys, res, grid, keep_core_geom=True,
                           device=device)
    A, B, M = build_edges_np(chips.geoms)
    if origin is None:
        bb = polys.bboxes()
        origin = np.round(np.array(
            [np.nanmean(bb[:, [0, 2]]), np.nanmean(bb[:, [1, 3]])]), 1)
    edges = np.stack([A[..., 0] - origin[0], A[..., 1] - origin[1],
                      B[..., 0] - origin[0], B[..., 1] - origin[1]],
                     axis=-1).astype(np.float32)
    edges[~M] = 1e9
    valid = M.any(axis=1)
    return (chips.cell_id.astype(np.int64),
            chips.geom_id.astype(np.int32), edges, valid, origin, chips)


def overlay_rows_from_arrays(rows: Sequence[np.ndarray],
                             device: DeviceLike = None) -> ChipRows:
    """Packed chip rows (cell i64, geometry or row id, edges [N, E, 4] f32,
    valid; further entries of a :func:`pack_chip_rows` tuple ignored) as
    the device's :class:`ChipRows`, ids widened to int64.  It carries rows
    packed elsewhere — for instance by the JAX package — onto ``device``
    unchanged."""
    dev = resolve_device(device)
    cell, ids, edges, valid = rows[:4]

    def own(arr, dtype):
        return torch.from_numpy(np.array(arr, dtype)).to(dev)

    return ChipRows(cell=own(cell, np.int64), ids=own(ids, np.int64),
                    edges=own(edges, np.float32), valid=own(valid, bool))


def hazard_eps(edges_a: np.ndarray, edges_b: np.ndarray) -> float:
    """The hazard band scaled with the local frame's extent: f32
    quantization of a coordinate of magnitude m moves a vertex by about
    ulp(m), so a fixed 1e-6 band would under-flag continent-scale
    inputs."""
    ext = 1.0
    for arr in (edges_a, edges_b):
        fin = arr[np.abs(arr) < 1e8]
        if len(fin):
            ext = max(ext, float(np.abs(fin).max()))
    return max(EPS_DEG, 64.0 * float(np.spacing(np.float32(ext))))


# ----------------------------------------------------------- device logic

def overlay_row_pairs(chips_a: ChipSet, chips_b: ChipSet,
                      polys_a: GeometryArray, polys_b: GeometryArray,
                      res: int, grid: IndexSystem,
                      device: DeviceLike = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """All (row A, row B) chip pairs that share a cell and (possibly)
    touch, as (rows_a [K], rows_b [K]) global chip-row indices in
    ascending key order; the dense [GA, GB] matrix never
    materializes."""
    dev = resolve_device(device)
    ra = pack_chip_rows(polys_a, res, grid, chips=chips_a, device=dev)
    rb = pack_chip_rows(polys_b, res, grid, chips=chips_b, origin=ra[4],
                        device=dev)
    ca, _, ea, va = ra[:4]
    cb, _, eb, vb = rb[:4]
    row_mult = int(len(cb)) + 1
    keys = overlay_pairs(
        overlay_rows_from_arrays((ca, np.arange(len(ca)), ea, va), dev),
        overlay_rows_from_arrays((cb, np.arange(len(cb)), eb, vb), dev),
        row_mult, hazard_eps(ea, eb), pair_cap=max(1024, 4 * len(ca)))
    keys = np.unique(keys.cpu().numpy())
    return keys // row_mult, keys % row_mult


def overlay_intersection_area(polys_a: GeometryArray,
                              polys_b: GeometryArray, res: int,
                              grid: IndexSystem, device: DeviceLike = None,
                              chips_a: Optional[ChipSet] = None,
                              chips_b: Optional[ChipSet] = None):
    """Exact ST_IntersectionAgg AREA: for every intersecting polygon pair,
    the planar area of the intersection.

    Chips partition each polygon within each cell, so area(A∩B) = Σ over
    shared cells of area(chipA ∩ chipB) (reference: tessellate +
    equi-join feeding ST_IntersectionAgg, MosaicExplode.scala:70-79 +
    ST_IntersectionAgg.scala:41-58).  The device join emits the candidate
    chip-row pairs; their exact areas come from the native
    fragment-shoelace kernel (``clip.pairs_intersection_area``) and are
    summed per (geomA, geomB).  ``chips_a``/``chips_b`` are each side's
    ``tessellate(..., keep_core_geom=True)``, made here when not given.

    Returns (ga [K], gb [K], area [K]) for pairs with area > 0."""
    from ..core.geometry.clip import pairs_intersection_area
    if chips_a is None:
        chips_a = tessellate(polys_a, res, grid, keep_core_geom=True,
                             device=device)
    if chips_b is None:
        chips_b = tessellate(polys_b, res, grid, keep_core_geom=True,
                             device=device)
    rows_a, rows_b = overlay_row_pairs(chips_a, chips_b, polys_a, polys_b,
                                       res, grid, device=device)
    areas = pairs_intersection_area(chips_a.geoms, rows_a, chips_b.geoms,
                                    rows_b)
    ga = chips_a.geom_id[rows_a].astype(np.int64)
    gb = chips_b.geom_id[rows_b].astype(np.int64)
    mult = int(chips_b.geom_id.max(initial=0)) + 1
    key = ga * mult + gb
    uk, inv = np.unique(key, return_inverse=True)
    tot = np.zeros(len(uk))
    np.add.at(tot, inv, areas)
    keep = tot > 0
    return (uk[keep] // mult, uk[keep] % mult, tot[keep])


# ------------------------------------------------------------ host oracle

def overlay_host_pair(polys_a: GeometryArray, polys_b: GeometryArray,
                      ia: int, ib: int) -> bool:
    """Exact f64 ST_Intersects of one polygon pair (edge crossings +
    mutual containment via crossing number)."""
    ea = _poly_edges(polys_a, ia)
    eb = _poly_edges(polys_b, ib)
    if len(ea) == 0 or len(eb) == 0:
        return False
    if np.any(_seg_cross(ea[:, None, 0], ea[:, None, 1],
                         eb[None, :, 0], eb[None, :, 1])):
        return True
    return bool(_pip(ea[:1, 0], eb)[0] or _pip(eb[:1, 0], ea)[0])


def overlay_host_truth(polys_a: GeometryArray,
                       polys_b: GeometryArray) -> np.ndarray:
    """[GA, GB] exact boolean intersects matrix (bbox-pruned)."""
    ba = polys_a.bboxes()
    bb = polys_b.bboxes()
    out = np.zeros((len(polys_a), len(polys_b)), bool)
    for i in range(len(polys_a)):
        cand = np.nonzero((ba[i, 0] <= bb[:, 2]) & (bb[:, 0] <= ba[i, 2])
                          & (ba[i, 1] <= bb[:, 3]) &
                          (bb[:, 1] <= ba[i, 3]))[0]
        for j in cand:
            out[i, j] = overlay_host_pair(polys_a, polys_b, i, int(j))
    return out


def resolve_hazards(hits: np.ndarray, hazards: np.ndarray,
                    polys_a: GeometryArray,
                    polys_b: GeometryArray) -> np.ndarray:
    """The device's [GA, GB] hits with every flagged pair replaced by its
    exact f64 answer against the original geometries (in place)."""
    for i, j in zip(*np.nonzero(hazards)):
        hits[i, j] = overlay_host_pair(polys_a, polys_b, int(i), int(j))
    return hits


# -------------------------------------------------------------- end2end

def overlay_intersects(polys_a: GeometryArray, polys_b: GeometryArray,
                       res: int, grid: IndexSystem,
                       device: DeviceLike = None,
                       chips_a: Optional[ChipSet] = None,
                       chips_b: Optional[ChipSet] = None) -> np.ndarray:
    """Exact ST_Intersects overlay: [GA, GB] bool.

    Packs both sides' chips (tessellated here unless ``chips_a``/
    ``chips_b`` are given, with ``keep_core_geom=True``), runs the chip
    join on the device, then settles the f32-hazard pairs on the host in
    f64.  This is the BASELINE config 3 (building footprints x flood
    zones) engine."""
    dev = resolve_device(device)
    rows_a = pack_chip_rows(polys_a, res, grid, chips=chips_a, device=dev)
    rows_b = pack_chip_rows(polys_b, res, grid, chips=chips_b,
                            origin=rows_a[4], device=dev)
    h, z = overlay_dense(overlay_rows_from_arrays(rows_a, dev),
                         overlay_rows_from_arrays(rows_b, dev),
                         len(polys_a), len(polys_b),
                         hazard_eps(rows_a[2], rows_b[2]))
    return resolve_hazards(h.cpu().numpy() > 0, z.cpu().numpy() > 0,
                           polys_a, polys_b)
