"""Tessellation's cell classification: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

Counterpart of the JAX package's classify pass,
``mosaic_tpu.core.tessellate.classify_cells_multi`` with its two device
bodies ``_parity_block`` (``tess/parity``) and ``_pair_check``
(``tess/pair_check``): for every (cell, geometry) pair, in exact
float64, whether the geometry touches the cell and whether the cell is
core.  A cell is core when all its vertices lie inside the geometry
(crossing parity), no edge crosses or touches a cell side, and no edge's
start vertex lies inside the cell; it is touched when any of those
tests, or the centre's parity, says so.

The inputs are flat CSR, nothing padded: a geometry's edges are rows
``edge_off[g]:edge_off[g + 1]`` of ``edges`` [E, 4] (ax, ay, bx, by); a
pair names its geometry (``pair_geo``) and its cell (``pair_cell``) in a
table of cell vertices [U, K, 2] (CCW, rows past the count unread),
counts [U] and centres [U, 2].

:func:`tess_classify` is the entry point.  On CUDA tensors it launches
``csrc/tess_classify.cu`` (built at first use) or raises; on CPU tensors
it runs :func:`classify_pairs_ref`, which repeats numpy's operations one
for one (the padded edges of a block of pairs, the bbox-sparse pair
check), so both give the numpy branches' booleans bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _kernels
from .projection import check_rc

#: the most vertices a cell may have (the kernel's widest template)
MAX_K = 10
#: lanes a pair the kernel takes, 32 / lanes pairs a warp
LANES = (1, 2, 4, 8, 16, 32)
#: the wrapper's pick of lanes a pair: at least this many edges a lane,
#: and groups widened until a launch has WARPS_PER_SM warps an SM
EDGES_PER_LANE = 8
WARPS_PER_SM = 16
#: the kernel's queue of items for phase B: drained by a warp when it
#: holds 32, at most 63 between drains
QUEUE = 64
#: the plain version's block: at most this many pairs, and pairs x padded
#: edges x queries at most PLAIN_BUDGET elements a block
PLAIN_BLOCK = 4096
PLAIN_BUDGET = 1 << 23


def _seg_cross_ref(a1, b1, a2, b2) -> torch.Tensor:
    """Broadcast segment intersection, touching counts (numpy's
    ``_seg_cross``)."""
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
            (torch.minimum(p[..., 0], q[..., 0]) <= r[..., 0]) & \
            (r[..., 0] <= torch.maximum(p[..., 0], q[..., 0])) & \
            (torch.minimum(p[..., 1], q[..., 1]) <= r[..., 1]) & \
            (r[..., 1] <= torch.maximum(p[..., 1], q[..., 1]))

    touch = on_seg(a2, b2, a1, d1) | on_seg(a2, b2, b1, d2) | \
        on_seg(a1, b1, a2, d3) | on_seg(a1, b1, b2, d4)
    return proper | touch


def pair_check_ref(a1, b1, a2, b2, vmask) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(hit [P], inside [P]) of P (cell, edge) pairs: a1/b1 [P, K, 2] each
    cell side's start and end, a2/b2 [P, 2] the edge, vmask [P, K] the
    real sides.  hit: the edge crosses or touches a real side; inside:
    its start vertex is on the left of (or on) every real side."""
    a2b = a2[:, None, :]
    b2b = b2[:, None, :]
    hit = (_seg_cross_ref(a1, b1, a2b, b2b) & vmask).any(dim=1)
    ev = b1 - a1
    pvec = a2b - a1
    crossz = ev[..., 0] * pvec[..., 1] - ev[..., 1] * pvec[..., 0]
    inside = ((crossz >= 0) | ~vmask).all(dim=1)
    return hit, inside


def classify_pairs_ref(edges, edge_off, pair_geo, pair_cell, cell_verts,
                       cell_counts, centers) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Plain version: (touching [P] bool, core [P] bool) on the inputs'
    device.  Blocks of pairs, each against its pairs' edges padded with
    +inf edges to the block's widest geometry: the crossing parity of the
    centre and every cell vertex, then the exact pair check over the
    (cell, edge) pairs whose bboxes overlap."""
    dev = edges.device
    P = int(pair_geo.shape[0])
    K = int(cell_verts.shape[1])
    touching = torch.zeros(P, dtype=torch.bool, device=dev)
    core = torch.zeros(P, dtype=torch.bool, device=dev)
    if P == 0:
        return touching, core
    inf = float("inf")
    # row E is the +inf sentinel edge every padded slot reads
    sentinel = torch.full((1, 4), inf, dtype=edges.dtype, device=dev)
    edges_p = torch.cat([edges, sentinel])
    n_edges = int(edges.shape[0])
    per_pair = (edge_off[1:] - edge_off[:-1])[pair_geo]
    kk = torch.arange(K, device=dev)
    s = 0
    while s < P:
        e = min(s + PLAIN_BLOCK, P)
        emax = max(int(per_pair[s:e].max()), 1)
        e = min(e, s + max(1, PLAIN_BUDGET // (emax * (K + 1))))
        emax = max(int(per_pair[s:e].max()), 1)
        ne = per_pair[s:e]
        ar = torch.arange(emax, device=dev)
        real = ar[None, :] < ne[:, None]
        eidx = torch.where(real, edge_off[pair_geo[s:e]][:, None] + ar,
                           n_edges)
        eg = edges_p[eidx]                                    # [B, Emax, 4]
        c = pair_cell[s:e]
        cv = cell_verts[c]                                    # [B, K, 2]
        cnt = cell_counts[c].to(torch.int64)
        vmask = kk[None, :] < cnt[:, None]
        ax, ay, bx, by = eg[..., 0], eg[..., 1], eg[..., 2], eg[..., 3]
        # one parity pass covers the centre + all K cell vertices
        px = torch.cat([centers[c, 0:1], cv[..., 0]], dim=1)  # [B, Q]
        py = torch.cat([centers[c, 1:2], cv[..., 1]], dim=1)
        straddle = (ay[:, None, :] <= py[..., None]) != \
            (by[:, None, :] <= py[..., None])
        t = (py[..., None] - ay[:, None, :]) / \
            torch.where(by == ay, 1.0, by - ay)[:, None, :]
        xi = ax[:, None, :] + t * (bx - ax)[:, None, :]
        hits = straddle & (px[..., None] < xi)
        par = (hits.sum(dim=-1) & 1).bool()
        center_in = par[:, 0]
        vin = par[:, 1:]
        all_in = (vin | ~vmask).all(dim=1)
        any_in = (vin & vmask).any(dim=1)
        # bbox-sparse exact crossing + vertex-in-cell
        cb0 = torch.where(vmask, cv[..., 0], inf).amin(dim=1)
        cb1 = torch.where(vmask, cv[..., 1], inf).amin(dim=1)
        cb2 = torch.where(vmask, cv[..., 0], -inf).amax(dim=1)
        cb3 = torch.where(vmask, cv[..., 1], -inf).amax(dim=1)
        ex0, ex1 = torch.minimum(ax, bx), torch.maximum(ax, bx)
        ey0, ey1 = torch.minimum(ay, by), torch.maximum(ay, by)
        ov = (cb0[:, None] <= ex1) & (ex0 <= cb2[:, None]) & \
            (cb1[:, None] <= ey1) & (ey0 <= cb3[:, None])
        ci, ei = torch.nonzero(ov, as_tuple=True)
        crossed = torch.zeros(e - s, dtype=torch.int64, device=dev)
        inside_cell = torch.zeros(e - s, dtype=torch.int64, device=dev)
        if len(ci):
            nxt = torch.where(kk[None, :] + 1 >= cnt[:, None], 0,
                              kk[None, :] + 1)
            cv_next = torch.gather(cv, 1, nxt[..., None].expand(-1, -1, 2))
            hit, inside = pair_check_ref(cv[ci], cv_next[ci],
                                         eg[ci, ei, 0:2], eg[ci, ei, 2:4],
                                         vmask[ci])
            crossed.index_add_(0, ci, hit.to(torch.int64))
            inside_cell.index_add_(0, ci, inside.to(torch.int64))
        crossed = crossed > 0
        inside_cell = inside_cell > 0
        blk_core = all_in & ~crossed & ~inside_cell
        core[s:e] = blk_core
        touching[s:e] = crossed | center_in | any_in | inside_cell | blk_core
        s = e
    return touching, core


def lanes_for(items: int, pairs: int, sms: int) -> int:
    """The lanes a pair of a launch of ``pairs`` pairs and ``items``
    (pair, edge) items on ``sms`` SMs: the largest power of two that
    leaves a lane EDGES_PER_LANE edges of the mean pair, widened while
    the launch has fewer than WARPS_PER_SM warps an SM; at most 32."""
    w = 1
    while w < 32 and 2 * w * EDGES_PER_LANE * pairs <= items:
        w *= 2
    while w < 32 and pairs * w < 32 * WARPS_PER_SM * sms:
        w *= 2
    return w


@functools.cache
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = _kernels.load("tess_classify")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tess_classify_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i64,
                                         i, vp, vp, vp]
    lib.tess_classify_launch.restype = i
    lib.tess_classify_error_string.argtypes = [i]
    lib.tess_classify_error_string.restype = ctypes.c_char_p
    return lib


def _check(edges, edge_off, pair_geo, pair_cell, cell_verts, cell_counts,
           centers) -> None:
    """Raise unless the inputs are what both versions take."""
    named = (("edges", edges, torch.float64, 2),
             ("edge_off", edge_off, torch.int64, 1),
             ("pair_geo", pair_geo, torch.int64, 1),
             ("pair_cell", pair_cell, torch.int64, 1),
             ("cell_verts", cell_verts, torch.float64, 3),
             ("cell_counts", cell_counts, torch.int32, 1),
             ("centers", centers, torch.float64, 2))
    for name, t, dtype, dim in named:
        if t.dtype != dtype or t.dim() != dim:
            raise ValueError(f"tess_classify: {name} must be {dim}-d "
                             f"{dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device != edges.device:
            raise ValueError(f"tess_classify: {name} on {t.device}, edges "
                             f"on {edges.device}")
    if edges.shape[1] != 4 or cell_verts.shape[2] != 2 or \
            centers.shape[1] != 2:
        raise ValueError("tess_classify: edges [E, 4], cell_verts [U, K, 2] "
                         "and centers [U, 2]")
    if pair_geo.shape != pair_cell.shape:
        raise ValueError("tess_classify: pair_geo and pair_cell differ in "
                         "length")
    K = int(cell_verts.shape[1])
    if K > MAX_K:
        raise ValueError(f"tess_classify: cells of {K} vertex slots, at "
                         f"most {MAX_K}")
    if cell_counts.shape[0] != cell_verts.shape[0] or \
            centers.shape[0] != cell_verts.shape[0]:
        raise ValueError("tess_classify: cell_counts, centers and "
                         "cell_verts differ in length")
    if cell_counts.numel():
        cmin, cmax = torch.aminmax(cell_counts)
        cmin, cmax = int(cmin), int(cmax)
        if cmin < 0 or cmax > K:
            raise ValueError(f"tess_classify: cell_counts {cmin}..{cmax} "
                             f"outside 0..{K}, the cell table's width")


def tess_classify(edges: torch.Tensor, edge_off: torch.Tensor,
                  pair_geo: torch.Tensor, pair_cell: torch.Tensor,
                  cell_verts: torch.Tensor, cell_counts: torch.Tensor,
                  centers: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(touching [P] bool, core [P] bool) of every (cell, geometry) pair.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream, once, :func:`lanes_for`'s lanes a pair, and raise
    on anything it does not take or on a CUDA error; there is no
    fallback.  ``tess_classify.launches`` counts kernel launches."""
    _check(edges, edge_off, pair_geo, pair_cell, cell_verts, cell_counts,
           centers)
    dev = edges.device
    if dev.type == "cpu":
        return classify_pairs_ref(edges, edge_off, pair_geo, pair_cell,
                                  cell_verts, cell_counts, centers)
    if dev.type != "cuda":
        raise ValueError(f"tess_classify: unsupported device {dev}")
    edges, edge_off, pair_geo, pair_cell, cell_verts, cell_counts, \
        centers = (t.contiguous() for t in (
            edges, edge_off, pair_geo, pair_cell, cell_verts, cell_counts,
            centers))
    if edges.data_ptr() % 32 or cell_verts.data_ptr() % 16 or \
            centers.data_ptr() % 16:
        raise ValueError("tess_classify: edges must be 32-byte and "
                         "cell_verts and centers 16-byte aligned (read as "
                         "double4 and double2)")
    P = int(pair_geo.shape[0])
    if P == 0:
        return (torch.empty(0, dtype=torch.bool, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev))
    G = int(edge_off.shape[0]) - 1
    # a pair's edge count, read at a clamped geometry until the range
    # check below has passed
    ne = (edge_off[1:] - edge_off[:-1])[pair_geo.clamp(0, max(G - 1, 0))] \
        if G > 0 else torch.zeros_like(pair_geo)
    pcmin, pcmax, pgmin, pgmax, items, ne_min, ne_max = torch.stack([
        pair_cell.min(), pair_cell.max(), pair_geo.min(), pair_geo.max(),
        ne.sum(), ne.min(), ne.max()]).tolist()
    if pcmin < 0 or pcmax >= cell_verts.shape[0] or pgmin < 0 or \
            pgmax >= G:
        raise ValueError("tess_classify: a pair's cell or geometry is out "
                         "of range")
    if ne_min < 0 or ne_max >= 1 << 30:
        raise ValueError("tess_classify: a geometry's edge count is "
                         f"outside 0..2^30 - 1 ({ne_min}..{ne_max})")
    lanes = lanes_for(items, P, _sms(dev))
    touching = torch.empty(P, dtype=torch.bool, device=dev)
    core = torch.empty(P, dtype=torch.bool, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.tess_classify_launch(
            edges.data_ptr(), edge_off.data_ptr(), pair_geo.data_ptr(),
            pair_cell.data_ptr(), cell_verts.data_ptr(),
            cell_counts.data_ptr(), centers.data_ptr(),
            int(cell_verts.shape[1]), P, lanes, touching.data_ptr(),
            core.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "tess_classify", rc, "launch")
    tess_classify.launches += 1
    return touching, core


tess_classify.launches = 0
