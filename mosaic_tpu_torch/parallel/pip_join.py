"""The index-accelerated point-in-polygon join: dense H3 and sorted-table
indexes.

Port of ``mosaic_tpu.parallel.pip_join`` (the flagship join and the
grid-agnostic sorted path).  Reference counterpart: the Quickstart
workload — points get ``grid_pointascellid``, polygons get
``grid_tessellateexplode``, Spark equi-joins on cell id, then filters
``is_core OR st_contains(chip, point)``.

``build_pip_index`` returns one of two indexes.

* ``DensePIPIndex`` (city-scale H3 on one icosahedron face): per point,
  on the device,

      (face, a, b, margin, facegap) = H3 lattice projection
      entry  = dense window table[(a, b)]
      inside = per-zone crossing parity vs the cell's merged chip pool row
      zone   = core hit ? core zone : first zone the point is inside

  one thread per point in one CUDA kernel (``ops/dense_join.py``).
* ``PIPIndex``, the sorted-table index, for everything else: CUSTOM and
  BNG grids, H3 windows across faces or beyond the df Taylor bound,
  overlapping polygons, or ``dense="never"``.  Per point,

      cell   = grid.point_to_cell_torch_margin(points + origin)
      slot   = binary search of cell in the core / border tables
      inside = crossing parity vs the <= max_dup chips of the cell
      zone   = core hit ? core zone : first chip hit

  as torch ops; on an H3 grid the cell step is one launch of the cell
  kernel (``ops/cell.py``).

Points whose f32 result could differ from the exact f64 one are flagged
``uncertain`` and rechecked on the host in f64 — against the original
chip edges for a dense index, against the polygons for a sorted one — by
the native C++ kernels of ``native/``, so the final zones equal the
exact oracle ``pip_host_truth``.

Over these sit the join strategies, each the same zones by another
path: ``make_streamed_pip_join`` (chunks through ``perf/pipeline.py``),
``make_planned_pip_join`` (the cost planner of ``sql/planner.py`` picks
one monolithic call, a chunk class or the sharded join per batch) and
``make_refined_pip_join`` (the dense border cells' polygons tessellated
a level deeper, each point routed to its level by its cell).  Over a
``torch.distributed`` process group (``parallel/collectives.py``),
``make_sharded_pip_join`` and ``make_sharded_streamed_pip_join`` split
the points over the ranks, each running the same join on its own device
with the index replicated, and gather the zones; ``zone_histogram`` sums
its counts over the group.  ``make_store_sharded_pip_join`` feeds the
sharded streamed join from an out-of-core chip store (``store/``), one
chunk off disk at a time.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from .._device import DeviceLike, resolve_device
from ..config import default_config
from ..core.geometry.array import GeometryArray
from ..core.geometry.padded import build_edges_np
from ..core.index.h3 import hexmath as hm
from ..core.index.h3.constants import M_SQRT7, RES0_U_GNOMONIC
from ..core.index.h3.system import H3IndexSystem
from ..core.index.h3.torchkernel import (FACEGAP_EPS, MAX_LOCAL_DEG,
                                         err_lattice_bound)
from ..core.tessellate import (_pip, _poly_edges, tessellate,
                               tessellate_subset)
from ..obs import metrics
from ..obs.heat import heat
from ..ops.dense_join import CORE_FLAG as _CORE_FLAG
from ..ops.dense_join import JoinConsts, dense_join, join_tables, prepare
from ..ops.lookup import lookup
from ..perf.bucketing import pow2_bucket
from ..perf.pipeline import chunk_rows, stream
from ..sql.planner import FORCE_CHOICES, Decision, planner
from . import collectives as coll
from .placement import SkewRebalancer, placement_slots
from ..types import ChipSet

#: f32 hazard band (degrees) around chip edges for the crossing-parity
#: test: covers the f32 representation of points and chip vertices
#: (~1.5e-8 deg at city magnitudes) and the f32 edge-intersection
#: arithmetic (~1e-7 deg), with ~8x safety.
EPS_EDGE_DEG = 1e-6

CORE_FLAG = np.int32(_CORE_FLAG)


def _workload_origin(polys: GeometryArray) -> np.ndarray:
    """Shared local-frame origin of a polygon batch: round(mean bbox)."""
    bb = polys.bboxes()
    return np.round(np.array(
        [np.nanmean(bb[:, [0, 2]]), np.nanmean(bb[:, [1, 3]])]), 1)


def localize(idx, points64: np.ndarray) -> np.ndarray:
    """Absolute float64 points -> local-frame float32 device input.

    The origin shift happens in float64 BEFORE the float32 cast, so the
    device sees full point precision in the frame the chips live in."""
    return np.asarray(points64 - np.asarray(idx.origin)[None],
                      np.float32)


@dataclasses.dataclass
class DensePIPIndex:
    """Dense-window tessellation index (H3, one face), its tensors on
    one device.

    entry  [W*H] i32   per lattice cell: -1 empty; CORE_FLAG|zone core;
                       else group index into pool
    pool   [G, E, 5]   merged chip edges per border cell, local-frame
                       f32: ax, ay, bx, by, zslot (-1 pad; pad coords
                       at +1e9 so they never straddle/flag)
    gzones [G, Z] i32  distinct zone ids per group (-1 pad)
    gwide  [G] bool    group's edges exceed the pool width: every point
                       landing there is flagged for the host recheck
    origin [2] f64     local-frame origin (lon, lat), host numpy
    face0, a0, b0, W, H, res, err_lattice (margin threshold), n_zones,
    ext_deg (max |local degree| of the window, + slack)
    aux    host f64 recheck tables (see host_recheck_fn); an index
           that build_dense_pip_index made also holds its polygons'
           edges there (``oracle_edges``, ``oracle_start``), the
           recheck's fallback
    """

    entry: torch.Tensor
    pool: torch.Tensor
    gzones: torch.Tensor
    gwide: torch.Tensor
    origin: np.ndarray
    face0: int
    a0: int
    b0: int
    W: int
    H: int
    res: int
    err_lattice: float
    n_zones: int
    ext_deg: float = 2.0
    aux: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.entry.device

    @property
    def num_chips(self) -> int:
        return int(self.pool.shape[0])


def dense_index_from_arrays(tables: dict, device: DeviceLike = None
                            ) -> DensePIPIndex:
    """A DensePIPIndex from host arrays: ``entry``, ``pool``, ``gzones``,
    ``gwide``, ``origin`` (numpy), the statics ``face0 a0 b0 W H res
    err_lattice n_zones ext_deg``, and ``aux`` (the recheck tables
    ``flat_a flat_b edge_zslot gstart gzones64``, and the polygons' edges
    ``oracle_edges oracle_start`` of :func:`_oracle_edges` where the
    caller has them; other keys ignored).  It carries an index built
    elsewhere — for instance by the JAX package — onto ``device``
    unchanged."""
    dev = resolve_device(device)

    def own(key, dtype):
        # a private copy: the index must not alias the caller's arrays
        return torch.from_numpy(np.array(tables[key], dtype)).to(dev)

    aux = tables.get("aux")
    if aux is not None:
        aux = {k: np.array(aux[k]) for k in
               ("flat_a", "flat_b", "edge_zslot", "gstart", "gzones64",
                "oracle_edges", "oracle_start") if k in aux}
    return DensePIPIndex(
        entry=own("entry", np.int32), pool=own("pool", np.float32),
        gzones=own("gzones", np.int32), gwide=own("gwide", bool),
        origin=np.array(tables["origin"], np.float64),
        face0=int(tables["face0"]), a0=int(tables["a0"]),
        b0=int(tables["b0"]), W=int(tables["W"]), H=int(tables["H"]),
        res=int(tables["res"]), err_lattice=float(tables["err_lattice"]),
        n_zones=int(tables["n_zones"]), ext_deg=float(tables["ext_deg"]),
        aux=aux)


def _host_lattice(pts_deg: np.ndarray, res: int):
    """f64 (face, a, b) of absolute lon/lat degree points (host truth)."""
    latlng = np.radians(np.asarray(pts_deg, np.float64)[:, ::-1])
    face, hex2d = hm.project_lattice(latlng, res)
    ijk = hm.hex2d_to_ijk(hex2d)
    return face, ijk[:, 0] - ijk[:, 2], ijk[:, 1] - ijk[:, 2]


#: why the last build_dense_pip_index call fell back (None = it
#: didn't), so a workload losing the dense path is diagnosable
LAST_DENSE_REJECT: Optional[str] = None


def _dense_reject(reason: str) -> None:
    global LAST_DENSE_REJECT
    LAST_DENSE_REJECT = reason


def build_dense_pip_index(polys: GeometryArray, res: int, grid,
                          chips: Optional[ChipSet] = None,
                          device: DeviceLike = None
                          ) -> Optional[DensePIPIndex]:
    """Build the dense-window index on ``device`` (CUDA unless the
    caller passes ``"cpu"``), or None when the workload doesn't fit the
    dense path (non-H3 grid, cells spanning icosahedron faces, window
    larger than the df Taylor bound, or overlapping polygons putting one
    cell in both core and border sets).  The reject reason lands in
    ``LAST_DENSE_REJECT``."""
    global LAST_DENSE_REJECT
    LAST_DENSE_REJECT = None
    dev = resolve_device(device)

    if not isinstance(grid, H3IndexSystem):
        _dense_reject("non_h3_grid")
        return None
    if chips is None:
        chips = tessellate(polys, res, grid, keep_core_geom=False,
                           device=dev)
    if len(chips) == 0:
        _dense_reject("no_chips")
        return None

    cells = np.unique(chips.cell_id)
    centers = grid.cell_center(cells)                    # [C, 2] deg
    origin = _workload_origin(polys)
    _, circ = grid._cell_metrics_deg(res)                # max circumradius
    # 2x: circumradius is angular degrees; lon extent is circ/cos(lat)
    ext = float(max(np.max(np.abs(centers[:, 0] - origin[0])),
                    np.max(np.abs(centers[:, 1] - origin[1])))) + 2 * circ
    if ext > MAX_LOCAL_DEG - 0.1:
        _dense_reject("window_extent")
        return None
    face_c, a_c, b_c = _host_lattice(centers, res)
    if len(np.unique(face_c)) != 1:
        _dense_reject("multi_face")
        return None
    # face-edge safety: every window cell must be interior enough that
    # no point of it can argmax to another face (facegap ≈ angular
    # distance to the face boundary; 0.02 ≈ 1.1 degrees of arc)
    xyz = hm.geo_to_xyz(np.radians(centers[:, ::-1]))
    dots = xyz @ hm.face_center_xyz().T
    srt = np.sort(dots, axis=1)
    if np.min(srt[:, -1] - srt[:, -2]) < 0.02:
        _dense_reject("face_edge_band")
        return None

    core = chips.is_core
    core_cells = chips.cell_id[core]
    if len(np.intersect1d(core_cells, chips.cell_id[~core])):
        _dense_reject("overlap_regime")
        return None
    if len(np.unique(core_cells)) != len(core_cells):
        _dense_reject("duplicate_core")
        return None

    face0 = int(face_c[0])
    a0, b0 = int(a_c.min()) - 1, int(b_c.min()) - 1
    W = int(a_c.max()) - a0 + 2
    H = int(b_c.max()) - b0 + 2
    if W * H > 64_000_000:
        _dense_reject("window_too_large")
        return None

    lat_of = {int(c): (int(a), int(b))
              for c, a, b in zip(cells, a_c, b_c)}

    entry = np.full(W * H, -1, np.int32)

    def lin(cell):
        a, b = lat_of[int(cell)]
        return (a - a0) * H + (b - b0)

    for c, z in zip(core_cells, chips.geom_id[core]):
        entry[lin(c)] = np.int32(z) | CORE_FLAG

    # ---- border groups: all chips of a cell merged into one edge soup
    b_cells = chips.cell_id[~core]
    b_zone = chips.geom_id[~core].astype(np.int32)
    border_idx = np.nonzero(~core)[0]
    order = np.argsort(b_cells, kind="stable")
    b_cells, b_zone = b_cells[order], b_zone[order]
    chip_geoms = chips.geoms.take(border_idx[order])
    A, B, M = build_edges_np(chip_geoms)                 # [Bc, cap, 2] f64
    cnt = M.sum(axis=1)

    ucells, ustart = np.unique(b_cells, return_index=True)
    G = len(ucells)
    gidx = np.searchsorted(ucells, b_cells)              # chip -> group
    gedges = np.bincount(gidx, weights=cnt).astype(np.int64)
    # pool width covers the 98th-percentile group; wider groups are
    # truncated and their cells flagged always-uncertain (host f64
    # resolves them exactly) — one pathological cell must not pad the
    # kernel for every point
    emax = int(gedges.max()) if G else 0
    etarget = int(max(np.quantile(gedges, 0.98), 8)) if G else 8
    E = 8
    while E < min(emax, etarget):
        E *= 2
    E = min(E, 512)
    gwide_np = gedges > E
    if G and float(gwide_np.mean()) > 0.2:
        # most cells would bounce to host: dense is the wrong shape
        _dense_reject("pathological_cell")
        return None

    # distinct zones per group, first-appearance order; per-chip zslot
    gzone_lists: list = [[] for _ in range(G)]
    zslot_chip = np.zeros(len(b_cells), np.int32)
    for i in range(len(b_cells)):
        zl = gzone_lists[gidx[i]]
        z = int(b_zone[i])
        if z not in zl:
            zl.append(z)
        zslot_chip[i] = zl.index(z)
    Z = max(1, max(len(zl) for zl in gzone_lists))
    gzones = np.full((G, Z), -1, np.int32)
    for g, zl in enumerate(gzone_lists):
        gzones[g, :len(zl)] = zl

    for g, c in enumerate(ucells):
        entry[lin(c)] = np.int32(g)

    # flatten valid edges in (group, chip, edge) order — already sorted
    flat_a = A[M]                                        # [Etot, 2] f64
    flat_b = B[M]
    edge_chip = np.repeat(np.arange(len(b_cells)), cnt.astype(np.int64))
    edge_group = gidx[edge_chip]
    edge_zslot = zslot_chip[edge_chip]
    gstart = np.zeros(G + 1, np.int64)
    np.cumsum(gedges, out=gstart[1:])
    pos = np.arange(len(flat_a)) - gstart[edge_group]

    pool = np.full((max(G, 1), E, 5), 1e9, np.float32)
    pool[..., 4] = -1.0
    loc_a = flat_a - origin[None]
    loc_b = flat_b - origin[None]
    fits = pos < E                       # wide-group overflow truncated
    eg, ep = edge_group[fits], pos[fits]
    pool[eg, ep, 0] = loc_a[fits, 0].astype(np.float32)
    pool[eg, ep, 1] = loc_a[fits, 1].astype(np.float32)
    pool[eg, ep, 2] = loc_b[fits, 0].astype(np.float32)
    pool[eg, ep, 3] = loc_b[fits, 1].astype(np.float32)
    pool[eg, ep, 4] = edge_zslot[fits].astype(np.float32)

    ext_deg = float(ext) + 0.1
    # the margin threshold of the arithmetic the port runs: df
    err = err_lattice_bound(res, "df", ext_deg, localized=True)
    # widen by the cell-edge sagitta: points between the true (gnomonic)
    # cell boundary and the straight lon/lat chord the chips were
    # clipped against must re-rank on host (negligible at city
    # resolutions, dominant at coarse ones).  Exact over the window's
    # own cells; degrees -> lattice units via the gnomonic scale.
    sag_deg = grid.cells_edge_sagitta_deg(cells)
    err = max(err, 2.0 * np.radians(sag_deg) * M_SQRT7 ** res /
              RES0_U_GNOMONIC)
    return dense_index_from_arrays(dict(
        entry=entry, pool=pool, gzones=gzones,
        gwide=np.resize(gwide_np, max(G, 1)), origin=origin,
        face0=face0, a0=a0, b0=b0, W=W, H=H, res=res, err_lattice=err,
        n_zones=len(polys), ext_deg=ext_deg,
        aux={"flat_a": flat_a, "flat_b": flat_b,
             "edge_zslot": edge_zslot.astype(np.int64),
             "gstart": gstart, "gzones64": gzones.astype(np.int64),
             **dict(zip(("oracle_edges", "oracle_start"),
                        _oracle_edges(polys)))}),
        dev)


@dataclasses.dataclass
class PIPIndex:
    """Sorted-table tessellation index of a polygon batch, its tensors on
    one device.

    core_cells   [C] i64       sorted cell ids fully inside some polygon
    core_zone    [C] i32       polygon id per core cell
    border_cells [B] i64       sorted cell ids on some polygon's boundary
                               (duplicates allowed: one entry per chip)
    border_zone  [B] i32       polygon id per chip
    chip_a/b     [B, E, 2] f32 chip edges, local frame
    chip_mask    [B, E] bool
    origin       [2] f64       local-frame origin (lon, lat), host numpy:
                               chip coords are stored origin-shifted so f32
                               edge-crossing arithmetic runs on small
                               magnitudes
    max_dup      max chips sharing one cell id (probe width)
    res          grid resolution
    sagitta_deg  exact max chord-vs-gnomonic cell-edge deviation (planar
                 degrees) over this index's cells: the extra
                 cell-assignment uncertainty band the join must honor
    """

    core_cells: torch.Tensor
    core_zone: torch.Tensor
    border_cells: torch.Tensor
    border_zone: torch.Tensor
    chip_a: torch.Tensor
    chip_b: torch.Tensor
    chip_mask: torch.Tensor
    origin: np.ndarray
    max_dup: int
    res: int
    sagitta_deg: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.core_cells.device

    @property
    def num_chips(self) -> int:
        return int(self.border_cells.shape[0])


SORTED_TABLES = ("core_cells", "core_zone", "border_cells", "border_zone",
                 "chip_a", "chip_b", "chip_mask")


def sorted_index_from_arrays(tables: dict, device: DeviceLike = None
                             ) -> PIPIndex:
    """A PIPIndex from host arrays: ``core_cells``, ``core_zone``,
    ``border_cells``, ``border_zone``, ``chip_a``, ``chip_b``,
    ``chip_mask``, ``origin`` (numpy) and the statics ``max_dup res
    sagitta_deg``.  It carries an index built elsewhere — for instance by
    the JAX package — onto ``device`` unchanged, uploaded once."""
    dev = resolve_device(device)
    dtypes = (np.int64, np.int32, np.int64, np.int32, np.float32,
              np.float32, bool)
    own = {k: torch.from_numpy(np.array(tables[k], dt)).to(dev)
           for k, dt in zip(SORTED_TABLES, dtypes)}
    return PIPIndex(**own, origin=np.array(tables["origin"], np.float64),
                    max_dup=int(tables["max_dup"]), res=int(tables["res"]),
                    sagitta_deg=float(tables["sagitta_deg"]))


def _build_sorted_index(polys: GeometryArray, res: int, grid,
                        chips: ChipSet, device: torch.device) -> PIPIndex:
    """The grid-agnostic sorted-table index on ``device``: sorted core and
    border cell tables and the border chips' edges in the workload's
    local frame, f32."""
    origin = _workload_origin(polys)
    core = chips.is_core
    core_cells = chips.cell_id[core]
    core_zone = chips.geom_id[core]
    order = np.argsort(core_cells, kind="stable")
    core_cells, core_zone = core_cells[order], core_zone[order]

    b_cells = chips.cell_id[~core]
    b_zone = chips.geom_id[~core]
    border_idx = np.nonzero(~core)[0]
    order = np.argsort(b_cells, kind="stable")
    b_cells, b_zone = b_cells[order], b_zone[order]
    max_dup = int(np.unique(b_cells, return_counts=True)[1].max()) \
        if len(b_cells) else 1
    if len(b_cells):
        chip_geoms = chips.geoms.take(border_idx[order])
        chip_geoms.coords = chip_geoms.coords - origin[None, :2]
        A, B, M = build_edges_np(chip_geoms)
    else:
        A = B = np.zeros((0, 8, 2))
        M = np.zeros((0, 8), bool)
    sagitta = grid.cells_edge_sagitta_deg(np.unique(chips.cell_id)) \
        if hasattr(grid, "cells_edge_sagitta_deg") else 0.0
    return sorted_index_from_arrays(dict(
        core_cells=core_cells, core_zone=core_zone, border_cells=b_cells,
        border_zone=b_zone, chip_a=A, chip_b=B, chip_mask=M, origin=origin,
        max_dup=max_dup, res=res, sagitta_deg=sagitta), device)


def build_pip_index(polys: GeometryArray, res: int, grid,
                    chips: Optional[ChipSet] = None, dense: str = "auto",
                    device: DeviceLike = None):
    """Tessellate polygons and lay the chips out for the device join, on
    ``device`` (CUDA unless the caller passes ``"cpu"``).

    Returns a DensePIPIndex (one-gather lattice-window fast path) when
    the workload allows it, else the grid-agnostic sorted-table PIPIndex
    (why the dense path refused lands in ``LAST_DENSE_REJECT``).
    ``dense``: "auto" | "never" | "require" (ValueError when the dense
    path refuses)."""
    if dense not in ("auto", "never", "require"):
        raise ValueError(f"dense must be auto, never or require, not "
                         f"{dense!r}")
    dev = resolve_device(device)
    if chips is None:
        chips = tessellate(polys, res, grid, keep_core_geom=False,
                           device=dev)
    if dense != "never":
        d = build_dense_pip_index(polys, res, grid, chips=chips, device=dev)
        if d is not None:
            return d
        if dense == "require":
            raise ValueError("workload does not fit the dense fast path "
                             f"(LAST_DENSE_REJECT={LAST_DENSE_REJECT!r})")
    return _build_sorted_index(polys, res, grid, chips, dev)


# ------------------------------------------------------- sorted join body

def _chip_pip(points: torch.Tensor, idx: PIPIndex, slots: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crossing-parity containment of each point in the chip at its slot.

    points [N, 2], slots [N] -> (inside [N] bool, min boundary distance²
    [N]).  One gather of that chip's edges per point; the [N, E]
    broadcast is the hot inner loop of the sorted join.  Its products
    and sums are elementwise, never ``torch.matmul``, so TF32 cannot
    reach them."""
    a = idx.chip_a[slots]                          # [N, E, 2]
    b = idx.chip_b[slots]
    mask = idx.chip_mask[slots]
    px = points[:, None, 0]
    py = points[:, None, 1]
    ax, ay = a[..., 0], a[..., 1]
    bx, by = b[..., 0], b[..., 1]
    straddle = (ay <= py) != (by <= py)
    t = (py - ay) / torch.where(by == ay, 1.0, by - ay)
    xi = ax + t * (bx - ax)
    hits = straddle & (px < xi) & mask
    inside = (hits.sum(dim=-1) & 1).bool()
    # boundary distance² for the exact-fallback band
    ab = b - a
    ap = points[:, None, :] - a
    denom = (ab * ab).sum(dim=-1)
    tt = ((ap * ab).sum(dim=-1) / torch.where(denom == 0, 1.0, denom)
          ).clamp(0.0, 1.0)
    d = points[:, None, :] - (a + tt[..., None] * ab)
    d2 = torch.where(mask, (d * d).sum(dim=-1), float("inf"))
    return inside, d2.amin(dim=-1)


def pip_assign(points: torch.Tensor, cells: torch.Tensor, idx: PIPIndex,
               eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each point to a polygon id (or -1).

    points [N, 2] (local frame), cells [N] int64 (the cell of each
    point).  Returns (zone [N] int32, uncertain [N] bool); ``uncertain``
    marks points within eps of a chip boundary, the f64 host recheck
    set.  Zero-size core or border tables are legal (border-only or
    core-only tessellations) and skip their gathers."""
    n = points.shape[0]
    if idx.core_cells.shape[0]:
        slot, in_core = lookup(idx.core_cells, cells)
        zone = torch.where(in_core, idx.core_zone[slot], -1)
    else:
        zone = torch.full((n,), -1, dtype=torch.int32, device=points.device)
    b0, in_border = lookup(idx.border_cells, cells)
    uncertain = torch.zeros(n, dtype=torch.bool, device=points.device)
    nb = idx.num_chips
    eps2 = float(np.float32(eps * eps))
    for d in range(idx.max_dup if nb else 0):
        s = (b0 + d).clamp(0, nb - 1)
        valid = in_border & (idx.border_cells[s] == cells) & (b0 + d < nb)
        inside, d2 = _chip_pip(points, idx, s)
        zone = torch.where(valid & inside & (zone < 0), idx.border_zone[s],
                           zone)
        uncertain |= valid & (d2 < eps2)
    return zone, uncertain


def make_pip_join_fn(idx, grid=None, eps: Optional[float] = None,
                     margin_eps: Optional[float] = None):
    """``local_points -> (zone, uncertain)`` for an index; inputs come
    from ``localize`` (local-frame float32, on the index's device).
    Dense indexes dispatch to make_dense_pip_join_fn (which does not read
    ``grid``); a sorted index needs the grid it was built on.

    Exactness contract: every float32 hazard raises ``uncertain``, and
    the f64 host recheck resolves those — on the sorted path (a) points
    within ``eps`` of a chip boundary (crossing-parity rounding), (b)
    points whose cell-boundary margin is below ``margin_eps`` (cell
    assignment from f32 absolute coordinates could differ from f64),
    (c) points within ``eps`` of the grid's domain edge.  Out-of-domain
    points are forced to zone -1."""
    if isinstance(idx, DensePIPIndex):
        return make_dense_pip_join_fn(
            idx, eps=EPS_EDGE_DEG if eps is None else eps,
            margin_eps_deg=margin_eps)
    if not isinstance(idx, PIPIndex):
        raise TypeError(f"not a PIP index: {type(idx).__name__}")
    if grid is None:
        raise ValueError("the sorted join needs the index's grid")
    # sorted-path defaults, wider than the dense path's: its cell step
    # runs on f32 absolute coordinates.  The margin (planar degrees)
    # also covers the cell-edge sagitta over this index's cells, the gap
    # between the true gnomonic cell boundary and the straight lon/lat
    # chords the chips were clipped against
    eps = 1e-5 if eps is None else float(eps)
    if margin_eps is None:
        margin_eps = max(3e-5, 2.0 * idx.sagitta_deg)
    margin32 = float(np.float32(margin_eps))
    dev = idx.device
    origin32 = torch.from_numpy(np.asarray(idx.origin, np.float32)).to(dev)
    # 8-neighborhood offsets: diagonals matter for points just outside a
    # domain corner on both axes
    offsets = [torch.tensor([dx, dy], dtype=torch.float32, device=dev)
               for dx in (-eps, 0.0, eps) for dy in (-eps, 0.0, eps)
               if (dx, dy) != (0.0, 0.0)]
    grid.prepare_torch(dev, idx.res)    # build and upload before any loop

    def fn(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        absolute = points + origin32
        cells, margin = grid.point_to_cell_torch_margin(absolute, idx.res)
        zone, uncertain = pip_assign(points, cells, idx, eps)
        uncertain |= margin < margin32
        inb = grid.point_in_bounds_torch(absolute)
        near_edge = torch.zeros_like(inb)
        for off in offsets:
            near_edge |= grid.point_in_bounds_torch(absolute + off) != inb
        return torch.where(inb, zone, -1), uncertain | near_edge

    return fn


def make_dense_pip_join_fn(idx: DensePIPIndex, eps: float = EPS_EDGE_DEG,
                           margin_eps_deg: Optional[float] = None
                           ) -> Callable[[torch.Tensor],
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """``local_points [N, 2] f32 -> (zone [N] i32, uncertain [N] bool)``
    on the dense index, on the index's device.  On CUDA each call is one
    launch of the fused projection + join kernel (``ops/dense_join.py``);
    on the CPU it runs that kernel's plain version.  The kernel is built
    and its tables uploaded here, before any call.

    Exactness contract: every f32 hazard raises ``uncertain`` — (a)
    hex-boundary margin below the df projection's validated error bound
    (cell assignment could differ from f64), (b) nearest-face ambiguity,
    (c) edge-crossing tests within ``eps`` of flipping (horizontal
    crossing distance, distance to a straddling edge's line, or
    ray-through-vertex; the line distance is the port's, where the JAX
    body misses points beside nearly horizontal edges), (d) a point in
    a wide group.  Points beyond the window's local extent are out-of-domain by
    construction: zone -1, certain.  host_recheck_fn resolves flagged
    points in f64."""
    # the projection always runs df; the margin threshold must match it
    err_lat = max(idx.err_lattice, err_lattice_bound(
        idx.res, "df", idx.ext_deg, localized=True))
    if margin_eps_deg is not None:
        # honor a caller-requested degree band: degrees -> lattice units
        scale = M_SQRT7 ** idx.res / RES0_U_GNOMONIC
        err_lat = max(err_lat, margin_eps_deg * np.pi / 180.0 * scale)
    tables = join_tables(idx.entry, idx.pool, idx.gzones, idx.gwide)
    consts = JoinConsts(
        res=idx.res, origin=(float(idx.origin[0]), float(idx.origin[1])),
        face0=idx.face0, a0=idx.a0, b0=idx.b0, W=idx.W, H=idx.H,
        err32=float(np.float32(err_lat)),
        gap32=float(np.float32(FACEGAP_EPS)), eps32=float(np.float32(eps)),
        far_lim=float(np.float32(idx.ext_deg + 0.05)))
    # TF32 cannot reach the face selection: its dot runs inside the
    # kernel (built with -fmad=false), and the plain version's join body
    # is elementwise and gather ops, no matmul.  Reduced-precision dots
    # shifted face selection by 13 cells in the JAX package, so a
    # product moved to torch.matmul must turn TF32 off around its call.
    prepare(tables, consts)
    return functools.partial(dense_join, tables=tables, consts=consts)


def zone_histogram(zone: torch.Tensor, num_zones: int,
                   group=None) -> torch.Tensor:
    """Per-zone match counts — the canonical aggregation after the join
    (reference: groupBy(index_id).count()).  Unmatched (-1) rows, and
    any zone id outside [0, num_zones), are masked to one overflow bin
    before ``torch.bincount`` (which rejects negatives) and dropped.

    Over a process group (every rank holding the same ``zone``) each
    rank counts its block of rows and one ``all_reduce`` sums the counts:
    the JAX package's sharded segment sum and ``psum``."""
    zone = zone[coll.row_block(zone.shape[0], coll.group_size(group),
                               coll.group_rank(group))]
    valid = (zone >= 0) & (zone < num_zones)
    z = torch.where(valid, zone, num_zones).long()
    counts = torch.bincount(z, minlength=num_zones + 1)[:num_zones]
    return coll.all_reduce(counts, group).to(torch.int32)


def dense_recheck_np(pts: np.ndarray, g: np.ndarray, aux: dict, Z: int,
                     near_eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy version of the native ``recheck_zones``: the chip-parity
    zone of each point in its border group ``g`` (the JAX package's numpy
    branch), and whether the point lies closer than ``near_eps`` to an
    edge of its group.  ``host_recheck_fn`` runs it where the index has
    more than 16 zone slots per cell."""
    gstart = aux["gstart"]
    cnt = (gstart[g + 1] - gstart[g]).astype(np.int64)
    total = int(cnt.sum())
    pidx = np.repeat(np.arange(len(g)), cnt)
    estart = np.repeat(gstart[g], cnt)
    local = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    eidx = estart + local
    pa = aux["flat_a"][eidx]
    pb = aux["flat_b"][eidx]
    zsl = aux["edge_zslot"][eidx]
    P = pts[pidx]
    ay, by = pa[:, 1], pb[:, 1]
    straddle = (ay <= P[:, 1]) != (by <= P[:, 1])
    denom = np.where(by == ay, 1.0, by - ay)
    xi = pa[:, 0] + (P[:, 1] - ay) / denom * (pb[:, 0] - pa[:, 0])
    crossed = straddle & (P[:, 0] < xi)
    counts = np.bincount(pidx * Z + zsl, weights=crossed,
                         minlength=len(g) * Z)
    odd = (counts.reshape(len(g), Z).astype(np.int64) & 1).astype(bool)
    anyin = odd.any(axis=1)
    first = odd.argmax(axis=1)
    zone = np.where(anyin, aux["gzones64"][g, first], -1).astype(np.int32)
    e = pb - pa
    r = P - pa
    len2 = np.sum(e * e, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        u = np.where(len2 > 0, np.sum(r * e, axis=1) / len2, 0.0)
    d = r - np.clip(u, 0.0, 1.0)[:, None] * e
    close = np.sum(d * d, axis=1) < float(near_eps) ** 2
    return zone, np.bincount(pidx, weights=close, minlength=len(g)) > 0


def host_recheck_fn(idx, polys: Optional[GeometryArray] = None):
    """Vectorized f64 host recheck bound to an index (either kind).

    Returns ``recheck(points64_abs, zone, uncertain) -> zone`` (numpy),
    whose flagged rows equal :func:`pip_host_truth`.  For a dense index
    it reruns the flagged points through the SAME chip semantics in f64
    — exact cell assignment (host lattice), exact crossing parity against
    the original unquantized chip edges — through the native
    ``recheck_zones`` (``dense_recheck_np`` when the index has more than
    16 zone slots per cell, the reference's one dispatch).  The chips
    are clipped to the straight lon/lat hexagon while the cell comes from
    the true H3 lattice, so a point in the cell-edge sagitta, or on a
    chip edge under the half-open rule, can find no chip or the wrong
    one; every flagged point that ends -1, or lies within
    ``EPS_EDGE_DEG`` of an edge of its cell's chips, takes the full
    polygon test ``pip_first_match`` instead.  Those polygons are the
    index's own (``aux["oracle_edges"]``, which ``build_pip_index``
    keeps) or ``polys``; an index with neither raises ValueError.  For a
    sorted ``PIPIndex`` the recheck authority is the original polygons,
    which the caller must pass: it does what :func:`host_recheck` does.
    Tables are prepared, and the library built, here, once."""
    if isinstance(idx, PIPIndex):
        if polys is None:
            raise ValueError(
                "host_recheck_fn on a sorted PIPIndex needs the original "
                "polygons: host_recheck_fn(idx, polys)")
        flat, gs = _oracle_edges(polys)
        native.get_lib()

        def recheck_sorted(points64, zone, uncertain):
            return _recheck_flagged(
                points64, zone, uncertain,
                lambda pts: native.pip_first_match(pts, flat, gs))

        return recheck_sorted
    if not isinstance(idx, DensePIPIndex):
        raise TypeError(f"not a PIP index: {type(idx).__name__}")
    aux = idx.aux
    if aux is None:
        raise ValueError("recheck needs the build-time aux tables")
    if polys is not None:
        oracle = _oracle_edges(polys)
    elif "oracle_edges" in aux:
        oracle = (aux["oracle_edges"], aux["oracle_start"])
    else:
        raise ValueError(
            "host_recheck_fn on a dense index made from arrays needs the "
            "original polygons for its fallback: host_recheck_fn(idx, "
            "polys)")
    entry = idx.entry.cpu().numpy()
    Z = int(idx.gzones.shape[1])
    use_native = Z <= native.MAX_ZONE_SLOTS
    native.get_lib()
    if use_native:
        flat_native = np.ascontiguousarray(
            np.concatenate([aux["flat_a"], aux["flat_b"]], axis=1))
        ezslot_native = aux["edge_zslot"].astype(np.int32)
        gzones_native = np.ascontiguousarray(
            aux["gzones64"].astype(np.int32))

    def recheck(points64: np.ndarray, zone: np.ndarray,
                uncertain: np.ndarray) -> np.ndarray:
        sel = np.nonzero(uncertain)[0]
        if len(sel) == 0:
            return zone
        zone = np.asarray(zone).copy()
        pts = np.asarray(points64)[sel]
        face, a, b = _host_lattice(pts, idx.res)
        ia = a - idx.a0
        ib = b - idx.b0
        inw = ((face == idx.face0) & (ia >= 0) & (ia < idx.W) &
               (ib >= 0) & (ib < idx.H))
        e = np.where(inw, entry[np.where(inw, ia * idx.H + ib, 0)], -1)
        out = np.full(len(sel), -1, np.int32)
        near = np.zeros(len(sel), bool)
        is_core = (e >= 0) & ((e & int(CORE_FLAG)) != 0)
        out[is_core] = (e[is_core] & ~int(CORE_FLAG))

        bsel = np.nonzero((e >= 0) & ~is_core)[0]
        if len(bsel):
            g = e[bsel].astype(np.int64)
            if use_native:
                out[bsel], near[bsel] = native.recheck_zones(
                    pts[bsel], g, flat_native, ezslot_native,
                    aux["gstart"], gzones_native, EPS_EDGE_DEG)
            else:
                out[bsel], near[bsel] = dense_recheck_np(
                    pts[bsel], g, aux, Z, EPS_EDGE_DEG)
        fall = np.nonzero((out < 0) | near)[0]
        if len(fall):
            out[fall] = native.pip_first_match(pts[fall], *oracle)
            recheck.fallbacks += len(fall)
        zone[sel] = out
        return zone

    #: flagged points that took the full polygon test
    recheck.fallbacks = 0
    return recheck


def _oracle_edges(polys: GeometryArray) -> Tuple[np.ndarray, np.ndarray]:
    """Every polygon's edges as one [E, 4] f64 table (ax, ay, bx, by) and
    the [G + 1] CSR offsets of each polygon's edges."""
    edges = [_poly_edges(polys, gi) for gi in range(len(polys))]
    gs = np.zeros(len(polys) + 1, np.int64)
    np.cumsum([len(e) for e in edges], out=gs[1:])
    flat = np.concatenate(edges).reshape(-1, 4) if edges else \
        np.zeros((0, 4))
    return flat, gs


def pip_host_truth(points64: np.ndarray, polys: GeometryArray
                   ) -> np.ndarray:
    """The exact float64 host oracle: first polygon containing each point
    (crossing-number, first-match tie-break) — the single source of truth
    that the recheck, tests and chip_smoke.py compare against.  Runs the
    native ``pip_first_match``; ``pip_host_truth_np`` is its numpy
    version."""
    flat, gs = _oracle_edges(polys)
    return native.pip_first_match(np.asarray(points64)[:, :2], flat, gs)


def pip_host_truth_np(points64: np.ndarray, polys: GeometryArray
                      ) -> np.ndarray:
    """Numpy version of :func:`pip_host_truth`: the per-polygon
    crossing-number loop."""
    points64 = np.asarray(points64)[:, :2]
    flat, gs = _oracle_edges(polys)
    truth = np.full(len(points64), -1, np.int32)
    for gi in range(len(gs) - 1):
        inside = _pip(points64, flat[gs[gi]:gs[gi + 1]].reshape(-1, 2, 2))
        truth = np.where((truth < 0) & inside, gi, truth)
    return truth


def _recheck_flagged(points64, zone, uncertain, truth) -> np.ndarray:
    """``zone`` with its flagged rows replaced by ``truth`` of their
    points (numpy)."""
    sel = np.nonzero(uncertain)[0]
    if len(sel) == 0:
        return zone
    zone = np.asarray(zone).copy()
    zone[sel] = truth(np.asarray(points64)[sel, :2])
    return zone


def host_recheck(points64: np.ndarray, zone: np.ndarray,
                 uncertain: np.ndarray, polys: GeometryArray
                 ) -> np.ndarray:
    """Re-run the uncertain points in float64 against the original
    polygons (not the chips) on host — the exact tie-break authority."""
    return _recheck_flagged(points64, zone, uncertain,
                            lambda pts: pip_host_truth(pts, polys))


def _resolve_chunk(chunk: Optional[int]) -> int:
    """Caller-supplied chunk rows, else ``mosaic.stream.chunk.rows``."""
    if chunk is not None:
        return int(chunk)
    return int(default_config().stream_chunk_rows)


def _check_device(idx, device: DeviceLike) -> torch.device:
    """``device`` resolved, checked to be the index's."""
    dev = resolve_device(device)
    if idx.device != dev:
        raise ValueError(f"index lives on {idx.device}, join asked for "
                         f"{dev}")
    return dev


def make_streamed_pip_join(idx, grid=None,
                           polys: Optional[GeometryArray] = None,
                           chunk: Optional[int] = None,
                           eps: Optional[float] = None,
                           margin_eps: Optional[float] = None,
                           device: DeviceLike = None):
    """End-to-end chunked join with transfer/compute/recheck overlap, on
    either index type.

    Cuts a host batch into ``chunk``-row pieces (``chunk=None`` reads
    ``mosaic.stream.chunk.rows``) and runs them through
    :func:`mosaic_tpu_torch.perf.pipeline.stream` on ``device`` (CUDA
    unless the caller passes ``"cpu"``; the index must live there): the
    localize + upload of chunk k+1 rides along with device compute on
    chunk k, and the f64 host recheck of chunk k-1's flagged points runs
    while the device works.  Exactness is untouched — same join, same
    recheck authority (``grid`` and ``polys`` are required for a sorted
    :class:`PIPIndex`).

    Returns ``run(points64_abs) -> (zone [N] int32, rechecked count)``;
    ``run.recheck`` is its :func:`host_recheck_fn`."""
    dev = _check_device(idx, device)
    chunk = _resolve_chunk(chunk)
    fn = make_pip_join_fn(idx, grid, eps, margin_eps)
    recheck = host_recheck_fn(idx, polys)
    origin = np.asarray(idx.origin, np.float64)

    def run(points64: np.ndarray):
        points64 = np.asarray(points64, np.float64)[:, :2]
        n = len(points64)
        zone_out = np.empty(n, np.int32)
        state = {"rechecked": 0}

        def stage(sl, out):
            # f64 origin shift BEFORE the f32 cast (= localize())
            out[...] = points64[sl] - origin[None]

        def consume(i, sl, host):
            z, unc = host
            zone_out[sl] = recheck(points64[sl], z, unc)
            state["rechecked"] += int(unc.sum())

        stream(chunk_rows(n, chunk), stage, 2, lambda i, x: fn(x), consume,
               dev)
        return zone_out, state["rechecked"]

    #: the bound host recheck (a dense index's counts its fallbacks)
    run.recheck = recheck
    return run


# ------------------------------------------------------ the sharded joins

#: padding rows of the sharded streamed join get this local-frame
#: coordinate (degrees): far outside every workload extent, so every
#: index gives them zone -1, yet small enough that f32 trig in the
#: projections stays finite.  The dense join and the H3 sorted body leave
#: them unflagged, the CUSTOM sorted body flags them (as the JAX
#: package's does); only a rank's real rows reach the recheck
_PAD_SENTINEL_DEG = 4.0e3


def make_sharded_pip_join(idx, grid=None, group=None,
                          eps: Optional[float] = None,
                          margin_eps: Optional[float] = None,
                          device: DeviceLike = None):
    """The join over a process group: the points split over the ranks,
    the index replicated on every rank's device (the reference's
    broadcast-join regime).

    Returns ``fn(points [N, 2] local f32) -> (zone [N] int32, uncertain
    [N] bool)`` on ``device`` (the index's; CUDA unless the caller passes
    ``"cpu"``), N divisible by the group's size.  Every rank calls it with
    the same points, runs :func:`make_pip_join_fn` on its block of N / D
    rows (on a dense index one K2 launch; on a sorted H3 index K3 under the
    sorted body) and gets every rank's rows back by one ``all_gather``
    each of ``zone`` and ``uncertain``.  ``group=None`` is the
    single-device call."""
    dev = _check_device(idx, device)
    fn = make_pip_join_fn(idx, grid, eps, margin_eps)
    D, r = coll.group_size(group), coll.group_rank(group)

    def run(points) -> Tuple[torch.Tensor, torch.Tensor]:
        points = torch.as_tensor(points)
        n = int(points.shape[0])
        if n % D:
            raise ValueError(f"{n} points do not split evenly over {D} "
                             "ranks")
        zone, unc = fn(points[coll.row_block(n, D, r)].to(dev))
        return coll.all_gather(zone, group), coll.all_gather(unc, group)

    return run


def _shard_skew_readback(zones_padded: np.ndarray, D: int) -> np.ndarray:
    """Per-shard matched-candidate counts from a [D * rows] zone vector
    (padding rows read zone -1 and drop out)."""
    return (np.asarray(zones_padded).reshape(D, -1) >= 0).sum(axis=1)


def make_sharded_streamed_pip_join(idx, grid=None, group=None,
                                   polys: Optional[GeometryArray] = None,
                                   chunk: Optional[int] = None,
                                   eps: Optional[float] = None,
                                   margin_eps: Optional[float] = None,
                                   refresh: Optional[int] = None,
                                   nbins: int = 16,
                                   device: DeviceLike = None):
    """:func:`make_streamed_pip_join` over a process group, with
    skew-aware placement.

    Each chunk of ``chunk`` rows pads with ``_PAD_SENTINEL_DEG`` rows to
    ``pow2_bucket(ceil(rows / D), floor=64) * D`` slots; the rows take
    their slots from :func:`.placement.placement_slots` (arrival order
    until the :class:`.placement.SkewRebalancer` arms), and rank ``r``
    runs slot block ``r`` through ``perf.pipeline.stream`` on its device.
    Each rank rechecks its own flagged rows on the host, then one
    ``all_gather`` per chunk brings every rank's (device zone, final
    zone) block back.  Every rank feeds the same gathered chunk to its
    rebalancer (which bins the rows with a matched device zone, as the
    JAX package's does), so all ranks place the next chunks alike; every
    ``refresh`` chunks (``mosaic.shard.skew.refresh``) the bins are
    re-packed.  Placement moves only where a row is computed: the zones
    are those of the single-device streamed join.

    ``polys`` is required for a sorted :class:`PIPIndex`.  Returns
    ``run(points64_abs) -> (zone [N] int32, rechecked)``, ``rechecked``
    summed over the ranks; ``run.rebalancer`` is the placement pass and
    ``run.shard_counts`` the last chunk's matched rows per shard."""
    dev = _check_device(idx, device)
    chunk = _resolve_chunk(chunk)
    fn = make_pip_join_fn(idx, grid, eps, margin_eps)
    recheck = host_recheck_fn(idx, polys)
    origin = np.asarray(idx.origin, np.float64)
    D, r = coll.group_size(group), coll.group_rank(group)
    if refresh is None:
        refresh = default_config().shard_skew_refresh
    rebalancer = SkewRebalancer(D, refresh=refresh, nbins=nbins)

    def run(points64: np.ndarray):
        points64 = np.asarray(points64, np.float64)[:, :2]
        n = len(points64)
        zone_out = np.empty(n, np.int32)
        state = {"rechecked": 0, "slots": {}}
        # stream() sees rank r's slot block of each chunk: a slice as long
        # as the block, starting where the chunk does
        real = {}
        blocks = []
        for sl in chunk_rows(n, chunk):
            per = pow2_bucket(-(-(sl.stop - sl.start) // D), floor=64)
            real[sl.start] = sl
            blocks.append(slice(sl.start, sl.start + per))

        def stage(blk, out):
            sl = real[blk.start]
            per = blk.stop - blk.start
            pts = points64[sl]
            slots = placement_slots(rebalancer.preferred(pts), len(pts),
                                    D, per)
            # this rank's rows of the chunk and their places in its block
            mine = np.nonzero(slots // per == r)[0]
            at = slots[mine] - r * per
            state["slots"][sl.start] = slots, mine, at
            out[...] = _PAD_SENTINEL_DEG
            # f64 origin shift BEFORE the f32 cast (= localize())
            out[at] = pts[mine] - origin[None]

        def consume(i, blk, host):
            z, unc = host
            sl = real[blk.start]
            per = blk.stop - blk.start
            slots, mine, at = state["slots"].pop(sl.start)
            both = np.full((per, 2), -1, np.int32)
            both[:, 0] = z
            both[at, 1] = recheck(points64[sl][mine], z[at], unc[at])
            state["rechecked"] += int(unc[at].sum())
            full = coll.all_gather(torch.from_numpy(both).to(dev),
                                   group).cpu().numpy()
            zone_out[sl] = full[slots, 1]
            run.shard_counts = _shard_skew_readback(full[:, 0], D)
            rebalancer.observe(points64[sl], full[slots, 0] >= 0)

        stream(blocks, stage, 2, lambda i, x: fn(x), consume, dev)
        total = torch.tensor(state["rechecked"], dtype=torch.int64,
                             device=dev)
        return zone_out, int(coll.all_reduce(total, group))

    run.rebalancer = rebalancer
    run.shard_counts = None
    return run


def _own_block(pref: Optional[np.ndarray], n: int, D: int, r: int,
               per: int):
    """(slots, mine, at) of one chunk of ``n`` rows padded to ``D`` blocks
    of ``per`` slots: each row's slot (:func:`.placement.placement_slots`
    on the preferred shards ``pref``), this rank's rows and their places
    in its block.  Identity placement (no preference, or one rank) gives
    each as a slice, so the rows move without fancy indexing."""
    if pref is None or D == 1:
        lo, hi = min(r * per, n), min((r + 1) * per, n)
        return slice(0, n), slice(lo, hi), slice(0, hi - lo)
    slots = placement_slots(pref, n, D, per)
    mine = np.nonzero(slots // per == r)[0]
    return slots, mine, slots[mine] - r * per


def make_store_sharded_pip_join(store, idx, grid=None, group=None,
                                polys: Optional[GeometryArray] = None,
                                chunk: Optional[int] = None,
                                eps: Optional[float] = None,
                                margin_eps: Optional[float] = None,
                                refresh: Optional[int] = None,
                                nbins: int = 16,
                                device: DeviceLike = None):
    """:func:`make_sharded_streamed_pip_join` fed from an out-of-core chip
    store (``store.ChipStore``).

    The chunk source is :meth:`~..store.reader.ChipStore.iter_chunks`, a
    generator that prunes partitions against the query bbox from the
    manifest alone and then reads one shard at a time off disk;
    ``perf.pipeline.stream`` pulls it one chunk ahead of the compute, so
    the host holds at most the double buffer's chunks, and the store may
    be larger than RAM.  Every rank reads the same chunks, stages only
    its own block of each (``pow2_bucket(ceil(rows / D), floor=64)``
    slots, padded with ``_PAD_SENTINEL_DEG`` rows), rechecks its own
    flagged rows and gets every rank's (device zone, final zone) block
    back by one ``all_gather`` a chunk; every rank feeds the same
    gathered chunk to its rebalancer.

    Placement is by partition: once the :class:`.placement.SkewRebalancer`
    is armed, every row of a chunk's span takes the shard it prefers for
    that partition's bbox centroid.  Under ``mosaic.heat.prior`` the
    partition heat (``obs.heat``) primes the rebalancer when the join is
    made (``heat/prior_primes``).  Placement moves only where a row is
    computed: the zones are those of the single-device streamed join over
    the same rows in store order.

    Returns ``run(bbox=None) -> (zone [rows] int32, rechecked)`` over the
    scanned rows in store order (manifest partition order, ingest order
    within a partition), ``rechecked`` summed over the ranks.
    ``run.rebalancer`` is the placement pass; after each call
    ``run.staged_bytes_by_partition`` maps cell -> the bytes its rows
    staged: each chunk's whole padded buffer, ``per * D * 2 * 4`` bytes,
    split over its spans by cumulative row share (the JAX package's
    ledger, whose buffer holds every rank's block; so its sum is ``D``
    times this rank's ``pipeline/h2d_bytes``).  A pruned partition never
    appears in it, and each staged partition's bytes are charged to its
    heat.  ``group=None`` is one device; ``polys`` is required for a
    sorted :class:`PIPIndex`.  Beside the stream's labels (the shard
    reads and chunk assembly run under ``stream/pull``), the host pass
    carries ``torch.profiler`` labels ``store_join/recheck``,
    ``store_join/gather`` and ``store_join/observe``."""
    dev = _check_device(idx, device)
    chunk = _resolve_chunk(chunk)
    fn = make_pip_join_fn(idx, grid, eps, margin_eps)
    recheck = host_recheck_fn(idx, polys)
    origin = np.asarray(idx.origin, np.float64)
    D, r = coll.group_size(group), coll.group_rank(group)
    if refresh is None:
        refresh = default_config().shard_skew_refresh
    rebalancer = SkewRebalancer(D, refresh=refresh, nbins=nbins)
    # partition bbox centroids: the placement key, one query per span
    cent = {p.cell: ((p.bbox[0] + p.bbox[2]) / 2.0,
                     (p.bbox[1] + p.bbox[3]) / 2.0)
            for p in store.partitions}
    if default_config().heat_prior:
        # a pure hint: placement moves rows between ranks, never zones
        hp = heat.prior(nbins, store.bbox, cent)
        if hp is not None:
            rebalancer.prime(np.asarray(store.bbox, np.float64), hp)
            if metrics.enabled:
                metrics.count("heat/prior_primes")
    # the stream's row bound: the block of a full (pow2-bucketed) chunk
    bound = pow2_bucket(-(-pow2_bucket(chunk, floor=64) // D), floor=64)

    def run(bbox=None):
        state = {"rechecked": 0}
        chunks, zones = {}, []
        staged_by_part: dict = {}

        def blocks():
            # rank r's block of each chunk, keyed by the chunk's offset
            for ck in store.iter_chunks(bbox=bbox, chunk_rows=chunk):
                per = pow2_bucket(-(-ck.rows // D), floor=64)
                chunks[ck.offset] = ck
                yield slice(ck.offset, ck.offset + per)

        def stage(blk, out):
            ck = chunks[blk.start]
            per = blk.stop - blk.start
            pref = None
            if rebalancer.armed:
                cpts = np.asarray([cent[c] for c, _ in ck.parts],
                                  np.float64)
                pref = np.repeat(rebalancer.preferred(cpts),
                                 [n for _, n in ck.parts])
            slots, mine, at = _own_block(pref, ck.rows, D, r, per)
            chunks[blk.start] = ck, slots, mine, at
            # f64 origin shift BEFORE the f32 cast (= localize())
            if isinstance(at, slice):
                out[at] = ck.points[mine] - origin[None]
                out[at.stop:] = _PAD_SENTINEL_DEG
            else:
                out[...] = _PAD_SENTINEL_DEG
                out[at] = ck.points[mine] - origin[None]
            # the ledger: the whole padded buffer split over the spans by
            # cumulative row share, so the shares sum to it exactly
            nbytes = per * D * 2 * 4
            seen = acc = 0
            for c, n in ck.parts:
                seen += n
                share = nbytes * seen // ck.rows - acc
                acc += share
                staged_by_part[c] = staged_by_part.get(c, 0) + share

        def consume(i, blk, host):
            z, unc = host
            ck, slots, mine, at = chunks.pop(blk.start)
            per = blk.stop - blk.start
            both = np.full((per, 2), -1, np.int32)
            both[:, 0] = z
            with record_function("store_join/recheck"):
                both[at, 1] = recheck(ck.points[mine], z[at], unc[at])
            state["rechecked"] += int(unc[at].sum())
            with record_function("store_join/gather"):
                full = both if group is None else coll.all_gather(
                    torch.from_numpy(both).to(dev), group).cpu().numpy()
                zones.append(full[slots, 1])
            with record_function("store_join/observe"):
                # density feedback stays row-level, on the gathered chunk
                rebalancer.observe(ck.points, full[slots, 0] >= 0)

        stream(blocks(), stage, 2, lambda i, x: fn(x), consume, dev,
               rows=bound)
        zone_out = np.concatenate(zones) if zones \
            else np.empty(0, np.int32)
        run.staged_bytes_by_partition = staged_by_part
        for c, b in staged_by_part.items():
            heat.touch(c, nbytes=b, scans=0)
        if metrics.enabled:
            metrics.count("pip_join/store_points", float(len(zone_out)))
            metrics.count("pip_join/store_chunks", float(len(zones)))
        total = torch.tensor(state["rechecked"], dtype=torch.int64,
                             device=dev)
        return zone_out, int(coll.all_reduce(total, group))

    run.rebalancer = rebalancer
    run.staged_bytes_by_partition = {}
    return run


# ------------------------------------------------------ the planned join

def _join_once(fn, idx, recheck, points64: np.ndarray, dev):
    """One join call over f64 points in ``idx``'s frame (:func:`localize`:
    the f64 origin shift, then the f32 cast) on ``dev``, then the f64
    ``recheck`` of its flagged points: ``(zone [N] int32, rechecked)``."""
    z, unc = fn(torch.from_numpy(localize(idx, points64)).to(dev))
    z = z.cpu().numpy()
    unc = unc.cpu().numpy()
    return recheck(points64, z, unc), int(unc.sum())


def _overlap_frac(points64: np.ndarray, poly_ext) -> Optional[float]:
    """What fraction of the batch's bbox intersects the polygons' extent
    ``poly_ext`` (x0, y0, x1, y1): an upper bound on the match rate.  The
    bbox is one pass of torch's threaded ``aminmax`` over the host array:
    numpy reduces an axis of width 2 a row at a time, and a reduction per
    column reads the whole array each time."""
    if poly_ext is None or not len(points64):
        return None
    lo, hi = torch.aminmax(torch.from_numpy(points64), dim=0)
    (x0, y0), (x1, y1) = lo.tolist(), hi.tolist()
    w = max(x1 - x0, 1e-12) * max(y1 - y0, 1e-12)
    iw = max(0.0, min(x1, poly_ext[2]) - max(x0, poly_ext[0]))
    ih = max(0.0, min(y1, poly_ext[3]) - max(y0, poly_ext[1]))
    return min(1.0, (iw * ih) / w)


def make_planned_pip_join(idx, grid=None,
                          polys: Optional[GeometryArray] = None,
                          eps: Optional[float] = None,
                          margin_eps: Optional[float] = None,
                          group=None):
    """Cost-based entry point over the PIP join family, on the index's
    device.

    Per call the planner (``sql/planner.py``) picks one monolithic call
    of :func:`make_pip_join_fn` on the whole batch (on a dense index one
    K2 launch), :func:`make_streamed_pip_join` in one of two chunk
    classes, or, over a ``group`` of more than one rank,
    :func:`make_sharded_streamed_pip_join`, from its learned
    per-(strategy, size-class) cost coefficients; cold it falls back to
    the batch-vs-chunk threshold.  A ``sharded`` pin with no group, or a
    group of one rank, runs the streamed join.  Over a group rank 0's
    decision is broadcast and every time fed to the planners is the
    slowest rank's (``all_reduce`` MAX, the wall time of the JAX
    package's mesh call), so all ranks run the same variant and learn
    the same coefficients.
    Every candidate localizes the same way (f64 origin shift before the
    f32 cast), runs the same join body and the same f64 recheck, so the
    zones are the same whichever path runs.  A bbox-overlap sketch of the
    batch against the polygons' extent feeds the estimate.

    After each call the wall time and matched rows flow back into the
    planner.  ``run.calibrate(points64)`` runs every candidate warm,
    feeds its time to the planner and raises AssertionError on any zone
    difference; over more than one rank, under ``mosaic.heat.prior``,
    when the partition heat (``obs.heat``) is skewed (rank 0's report:
    ``skew >= 2``) it runs the ``sharded`` candidate first
    (``heat/calibrate_hints``), an ordering hint that changes no zone.
    ``run.calibrate_order`` is the last calibration's candidates in the
    order they ran.

    Returns ``run(points64_abs) -> (zone [N] int32, rechecked count)``;
    ``run.last_decision`` is the most recent pick and ``run.last_times``
    its host seconds in the sketch, the decision, the chosen variant's
    call and the planner's feedback."""
    dev = idx.device
    D = coll.group_size(group)
    variants: dict = {}
    poly_ext = None
    if polys is not None and len(polys):
        bb = polys.bboxes()
        poly_ext = (float(np.nanmin(bb[:, 0])), float(np.nanmin(bb[:, 1])),
                    float(np.nanmax(bb[:, 2])), float(np.nanmax(bb[:, 3])))

    def _variant(strategy: str, chunk: int):
        key = (strategy, chunk if strategy == "streamed" else 0)
        if key in variants:
            return variants[key]
        if strategy == "monolithic":
            fn = make_pip_join_fn(idx, grid, eps, margin_eps)
            recheck = host_recheck_fn(idx, polys)

            def mono(points64):
                points64 = np.asarray(points64, np.float64)[:, :2]
                if not len(points64):
                    return np.empty(0, np.int32), 0
                return _join_once(fn, idx, recheck, points64, dev)

            variants[key] = mono
        elif strategy == "sharded":
            variants[key] = make_sharded_streamed_pip_join(
                idx, grid, group, polys=polys, chunk=chunk, eps=eps,
                margin_eps=margin_eps, device=dev)
        else:
            variants[key] = make_streamed_pip_join(
                idx, grid, polys=polys, chunk=chunk, eps=eps,
                margin_eps=margin_eps, device=dev)
        return variants[key]

    def slowest(seconds: float) -> float:
        """The group's largest ``seconds`` (this rank's alone without a
        group)."""
        t = torch.tensor([seconds], dtype=torch.float64, device=dev)
        return float(coll.all_reduce(t, group, "max"))

    def agreed(d: Decision) -> Decision:
        """``d`` carrying rank 0's strategy and chunk."""
        if group is None:
            return d
        names = FORCE_CHOICES["pip_join"]
        mine = (d.strategy, getattr(d, "chunk", planner.chunk_rows()))
        pick = torch.tensor([names.index(mine[0]), mine[1]],
                            dtype=torch.int64, device=dev)
        s, chunk = coll.broadcast(pick, group).tolist()
        if (names[s], chunk) != mine:
            d.reason = f"rank 0's decision ({d.reason} here)"
            d.strategy, d.chunk = names[s], chunk
            d.cost_key = planner.pip_cost_key(d.strategy, chunk)
        return d

    def run(points64: np.ndarray):
        t = [time.perf_counter()]
        points64 = np.asarray(points64, np.float64)[:, :2]
        frac = _overlap_frac(points64, poly_ext)
        t.append(time.perf_counter())
        d = agreed(planner.decide_pip_join(len(points64), D,
                                           in_extent_frac=frac))
        chunk = getattr(d, "chunk", planner.chunk_rows())
        strategy = d.strategy
        if strategy == "sharded" and D == 1:
            strategy = "streamed"   # a sharded pin without a group
        t.append(time.perf_counter())
        zone, rechecked = _variant(strategy, chunk)(points64)
        t.append(time.perf_counter())
        planner.observe_decision(d, slowest(t[3] - t[2]),
                                 rows_out=int(np.count_nonzero(zone >= 0)))
        t.append(time.perf_counter())
        run.last_decision = d
        run.last_times = dict(zip(("sketch", "decide", "call", "observe"),
                                  np.diff(t).tolist()))
        return zone, rechecked

    def calibrate(points64: np.ndarray):
        """Run every candidate warm on this batch: seeds the planner's
        coefficients and asserts the candidates' zones are equal."""
        points64 = np.asarray(points64, np.float64)[:, :2]
        n = len(points64)
        ref = None
        cands = planner.pip_join_candidates(n, D)
        if D > 1 and default_config().heat_prior:
            # a hot, skewed workload warms the skew-aware sharded path
            # first; rank 0's heat decides, so every rank runs one order
            rep = heat.report(top=1)
            hint = torch.tensor([int(bool(rep["tracked"]) and
                                     rep["skew"] >= 2.0)],
                                dtype=torch.int64, device=dev)
            if int(coll.broadcast(hint, group)):
                cands = sorted(cands, key=lambda sc:
                               0 if sc[0] == "sharded" else 1)
                if metrics.enabled:
                    metrics.count("heat/calibrate_hints")
        run.calibrate_order = list(cands)
        for strategy, chunk in cands:
            fn = _variant(strategy, chunk)
            fn(points64)                # warm: builds stay out of the
            t0 = time.perf_counter()    # learned coefficients
            zone, _ = fn(points64)
            wall = slowest(time.perf_counter() - t0)
            planner.observe_op(planner.pip_cost_key(strategy, chunk), n,
                               wall, rows_out=int(np.count_nonzero(zone >= 0)))
            if ref is None:
                ref = zone
            elif not np.array_equal(ref, zone):
                raise AssertionError(
                    f"pip_join strategy {strategy!r} (chunk {chunk}) "
                    "diverged from the reference path")
        return ref

    run.calibrate = calibrate
    run.calibrate_order = None
    run.last_decision = None
    run.last_times = None
    return run


# ------------------------------------------------------ the refined join

def _chips_clean(chips: ChipSet) -> bool:
    """True when a chipset's index is *clean*: no cell id is both core
    and border, and no cell is core for two polygons — the two
    conditions whose violation rejects the dense path (overlap_regime,
    duplicate_core).

    In a clean index a core hit means no other polygon meets that cell
    (it would have a chip there), so the core zone is the only
    container; border-only hits take the first border slot, and the
    stable sort of ``_build_sorted_index`` keeps slots in geom-id order,
    so they resolve to the lowest containing id — the first-match rule
    of :func:`pip_host_truth`.  So every point's final zone equals the
    oracle at any resolution, and routing points between two clean
    levels cannot change a zone.  An unclean chipset (overlapping
    polygons sharing a core cell) voids the argument: the refined join
    then runs flat."""
    core = chips.is_core
    core_cells = chips.cell_id[core]
    if len(np.intersect1d(core_cells, chips.cell_id[~core])):
        return False
    return len(np.unique(core_cells)) == len(core_cells)


def make_refined_pip_join(polys: GeometryArray, grid, res: int,
                          chunk: Optional[int] = None,
                          eps: Optional[float] = None,
                          margin_eps: Optional[float] = None,
                          device: DeviceLike = None):
    """Adaptive per-cell refinement of the sorted join, on ``device``
    (CUDA unless the caller passes ``"cpu"``).

    The flat join pays ``max_dup`` chip probes per point, set by the
    worst cell.  This join starts at ``res`` like the flat path, measures
    per-cell candidate pairs on the first batch's leading
    ``mosaic.join.refine.sample.rows`` points, and tessellates only the
    dense border cells' polygons ``mosaic.join.refine.depth`` levels
    deeper.  Each chunk's points are routed by their base-level cell
    (``grid.point_to_cell_device``: on H3 one launch of the cell kernel,
    low-margin points on the host, so the ids are the host's): a point
    in a dense cell runs against the refined index, every other one
    against the base index the flat path uses.  Both levels are sorted
    indexes (``dense="never"``), so on H3 each part's join body is one
    cell-kernel launch.

    Both levels are gated on :func:`_chips_clean`, so the zones equal
    :func:`pip_host_truth` and the flat path's.  The refined part's
    recheck authority is the polygon subset whose bboxes touch a dense
    cell (inflated by twice the base index's sagitta, order kept, ids
    mapped back), which holds every polygon that can contain a
    dense-routed point.  The planner's ``refine`` decision picks the
    path (``mosaic.planner.force.refine`` pins it,
    ``mosaic.join.refine.enabled`` off beats any pin).  A failure in the
    refined path raises; nothing re-runs the batch flat.

    Returns ``run(points64_abs) -> (zone [N] int32, rechecked count)``
    with ``run.last_decision``, ``run.stats`` (levels, cells_refined,
    cells_flat, refined_points, flat_points, strategy: what ran) and
    ``run.counts`` (the last call's route, base-part and refined-part
    join calls, routed points and those the host assigned)."""
    dev = resolve_device(device)
    chunk = _resolve_chunk(chunk)
    chips = tessellate(polys, res, grid, keep_core_geom=False, device=dev)
    idx_base = build_pip_index(polys, res, grid, chips=chips,
                               dense="never", device=dev)
    clean_base = _chips_clean(chips)
    fn_base = make_pip_join_fn(idx_base, grid, eps, margin_eps)
    recheck_base = host_recheck_fn(idx_base, polys)
    b_cells = chips.cell_id[~chips.is_core]
    u_cells, u_dup = (np.unique(b_cells, return_counts=True)
                      if len(b_cells) else
                      (np.empty(0, np.int64), np.empty(0, np.int64)))
    state = {"probed": False, "dense": np.empty(0, np.int64),
             "frac": 0.0, "depth": 0, "ref": None, "ref_unclean": False,
             "flat": None}
    counts = {}

    def _route_cells(pts64: np.ndarray) -> np.ndarray:
        """Base-level cell ids for the hot/cold split, equal to the
        host's ``point_to_cell``.  Routing is never the answer's
        authority: a cold-routed point runs the full base index, and the
        subset holds every polygon that can contain a hot-routed one."""
        if not len(pts64):
            return np.empty(0, np.int64)
        cells, host = grid.point_to_cell_device(pts64, res, dev)
        counts["route"] += 1
        counts["route_points"] += len(pts64)
        counts["route_host_points"] += host
        return cells

    def _probe(points64: np.ndarray) -> None:
        """Sticky selectivity probe: per border cell, the estimated
        candidate pairs = (sample points in cell) x (chips in cell)."""
        cfg = default_config()
        sample = points64[:max(1, int(cfg.join_refine_sample_rows))]
        if not len(u_cells) or not len(sample):
            return
        cells = _route_cells(sample)
        pos = np.searchsorted(u_cells, cells)
        posc = np.clip(pos, 0, len(u_cells) - 1)
        valid = (pos < len(u_cells)) & (u_cells[posc] == cells)
        hits = np.bincount(posc[valid], minlength=len(u_cells))
        pairs = hits.astype(np.float64) * u_dup
        total = float(pairs.sum())
        floor = int(cfg.join_refine_dup_threshold)
        sel = np.nonzero((u_dup >= floor) & (hits > 0))[0]
        cap = max(1, int(cfg.join_refine_max_cells))
        if len(sel) > cap:
            sel = sel[np.argsort(-pairs[sel], kind="stable")[:cap]]
        state["dense"] = np.sort(u_cells[sel])
        state["frac"] = float(pairs[sel].sum()) / total if total else 0.0

    def _ensure_refined(depth: int) -> bool:
        """Build the deeper index over the dense cells' polygons once
        (sticky at the first requested depth); False when the parity
        gate fails at the refined level, and the caller runs flat."""
        if state["ref"] is not None:
            return True
        if state["ref_unclean"]:
            return False
        dense = state["dense"]
        if not len(dense):
            state["ref"] = {"empty": True}
            state["depth"] = max(1, int(depth))
            return True
        verts, vcount = grid.cell_boundary(dense)
        m = np.arange(verts.shape[1])[None, :] < vcount[:, None]
        vx, vy = verts[..., 0], verts[..., 1]
        cb = np.stack([np.where(m, vx, np.inf).min(1),
                       np.where(m, vy, np.inf).min(1),
                       np.where(m, vx, -np.inf).max(1),
                       np.where(m, vy, -np.inf).max(1)], axis=1)
        # the true cell edge can bow past the vertex-chord bbox by the
        # sagitta: the subset must hold every polygon that can contain a
        # dense-routed point
        pad = max(1e-9, 2.0 * float(idx_base.sagitta_deg))
        cb += np.array([-pad, -pad, pad, pad])
        pb = polys.bboxes()
        inter = ~((pb[:, None, 0] > cb[None, :, 2]) |
                  (pb[:, None, 2] < cb[None, :, 0]) |
                  (pb[:, None, 1] > cb[None, :, 3]) |
                  (pb[:, None, 3] < cb[None, :, 1]))
        sub_ids = np.nonzero(inter.any(axis=1))[0]
        depth = max(1, int(depth))
        sub, sub_chips = tessellate_subset(polys, sub_ids, res + depth,
                                           grid, keep_core_geom=False,
                                           device=dev)
        if not _chips_clean(sub_chips):
            state["ref_unclean"] = True
            return False
        idx_ref = build_pip_index(sub, res + depth, grid, chips=sub_chips,
                                  dense="never", device=dev)
        state["ref"] = {"idx": idx_ref, "orig": sub_ids.astype(np.int32),
                        "fn": make_pip_join_fn(idx_ref, grid, eps,
                                               margin_eps),
                        "recheck": host_recheck_fn(idx_ref, sub)}
        state["depth"] = depth
        return True

    def _run_part(part: str, fn, idx_level, recheck, pts64: np.ndarray):
        """One join call over a part's points in their level's own frame
        (f64 shift by the level's origin, then the f32 cast), then that
        level's f64 recheck."""
        if not len(pts64):
            return np.empty(0, np.int32), 0
        out = _join_once(fn, idx_level, recheck, pts64, dev)
        counts[part] += 1
        return out

    def _flat():
        if state["flat"] is None:
            state["flat"] = make_streamed_pip_join(
                idx_base, grid, polys=polys, chunk=chunk, eps=eps,
                margin_eps=margin_eps, device=dev)
        return state["flat"]

    def _refined(points64: np.ndarray):
        ref = state["ref"]
        dense = state["dense"]
        n = len(points64)
        zone = np.empty(n, np.int32)
        rechecked = refined_pts = 0
        for sl in chunk_rows(n, chunk):
            pts = points64[sl]
            if len(dense) and "idx" in ref:
                cells = _route_cells(pts)
                pos = np.searchsorted(dense, cells)
                posc = np.clip(pos, 0, len(dense) - 1)
                hot = (pos < len(dense)) & (dense[posc] == cells)
            else:
                hot = np.zeros(len(pts), bool)
            out = np.empty(len(pts), np.int32)
            za, ra = _run_part("base", fn_base, idx_base, recheck_base,
                               pts[~hot])
            out[~hot] = za
            if hot.any():
                zb, rb = _run_part("refined", ref["fn"], ref["idx"],
                                   ref["recheck"], pts[hot])
                orig = ref["orig"]
                out[hot] = np.where(zb >= 0,
                                    orig[np.clip(zb, 0, len(orig) - 1)],
                                    np.int32(-1))
                rechecked += rb
                refined_pts += int(hot.sum())
            rechecked += ra
            zone[sl] = out
        return zone, rechecked, refined_pts

    def run(points64: np.ndarray):
        points64 = np.asarray(points64, np.float64)[:, :2]
        n = len(points64)
        counts.update(route=0, base=0, refined=0, route_points=0,
                      route_host_points=0)
        if not state["probed"]:
            _probe(points64)
            state["probed"] = True
        if not clean_base:
            # a parity gate, not a cost call: the clean-index argument
            # does not hold, so no pin can choose refinement
            d = Decision("refine", "flat",
                         "overlap regime at base level (parity gate)",
                         n, cost_key="refine/flat", key_n=n, forced=True)
            d.depth = 0
            planner.record_decision(d)
        else:
            d = planner.decide_refine(n, state["frac"], idx_base.max_dup)
            if d.strategy == "refined" and \
                    not _ensure_refined(getattr(d, "depth", 1)):
                d.strategy = "flat"
                d.reason = ("overlap regime at refined level "
                            "(parity gate)")
                d.cost_key = "refine/flat"
                d.forced = True
                planner.record_decision(d)
        t0 = time.perf_counter()
        refined_pts = 0
        if d.strategy == "refined":
            zone, rechecked, refined_pts = _refined(points64)
        else:
            zone, rechecked = _flat()(points64)
        planner.observe_decision(d, time.perf_counter() - t0,
                                 rows_out=int(np.count_nonzero(zone >= 0)))
        depth = state["depth"] or int(getattr(d, "depth", 1) or 1)
        refined_run = (d.strategy == "refined" and state["ref"] is not None
                       and refined_pts > 0)
        cells_refined = len(state["dense"]) if refined_run else 0
        run.stats = {
            "levels": [res, res + depth] if refined_run else [res],
            "cells_refined": cells_refined,
            "cells_flat": len(u_cells) - cells_refined,
            "refined_points": int(refined_pts),
            "flat_points": int(n - refined_pts),
            "strategy": "refined" if refined_run else "flat",
        }
        run.last_decision = d
        return zone, rechecked

    run.stats = None
    run.last_decision = None
    run.counts = counts
    return run
