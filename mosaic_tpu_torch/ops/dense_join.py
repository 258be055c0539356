"""The dense H3 point-in-polygon join body: a hand-written CUDA kernel
for Hopper that fuses the lattice projection with the join, and its plain
PyTorch version.

For each origin-local f32 point the join projects it to the H3 lattice,
looks its cell up in the dense window table, and, in a border cell,
counts crossing parity per zone slot against the cell's merged chip-edge
pool row.  Outputs: ``zone`` i32 [N] (-1 for none) and ``uncertain``
bool [N], the points whose f32 answer the f64 host recheck must settle.

:func:`dense_join` is the entry point.  On CUDA tensors it launches
``csrc/h3_dense_join.cu`` (built at first use) or raises; on CPU tensors
it runs :func:`dense_join_ref`, the plain version, which the kernel
matches bit for bit.  It replaces the Pallas projection kernel plus the
XLA join body of ``mosaic_tpu.parallel.pip_join.make_dense_pip_join_fn``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import _kernels
from .projection import (Projection, check_points, check_rc, device_table,
                         host_constants, project_lattice_ref, set_faces)

#: entry-table bit marking a core cell; the low bits hold its zone
CORE_FLAG = 1 << 30


class JoinTables(NamedTuple):
    """The dense index's device tables (see ``DensePIPIndex``), and the
    kernel's private copy of the pool in a layout that loads well
    (:func:`join_tables` makes it; the plain version does not read it)."""

    entry: torch.Tensor     # [W*H] i32: -1 empty, CORE_FLAG|zone, or group
    pool: torch.Tensor      # [G, E, 5] f32: ax, ay, bx, by, zslot
    gzones: torch.Tensor    # [G, Z] i32 zone per slot, -1 pad
    gwide: torch.Tensor     # [G] bool: group truncated to E edges
    edges: torch.Tensor     # [G, E, 4] f32: pool's ax, ay, bx, by
    eslot: torch.Tensor     # [G, E] i32: pool's zslot
    ecount: torch.Tensor    # [G] i32: edges to walk, trailing pads cut


#: a pool edge with ay == by and |ay| at least this is a pad: it never
#: straddles a point's latitude nor lies within eps of it, for any point
#: the join does not call far (|local degree| <= MAX_LOCAL_DEG + slack)
PAD_MIN_DEG = 1e6


def join_tables(entry: torch.Tensor, pool: torch.Tensor,
                gzones: torch.Tensor, gwide: torch.Tensor) -> JoinTables:
    """JoinTables of a dense index, with the kernel's layout of ``pool``:
    each edge's coordinates as one 16-byte load, its zone slot apart (read
    only for a crossing), and per group the count of edges before its
    trailing pads, so the walk skips them.  Same f32 values as ``pool``."""
    ay, by = pool[..., 1], pool[..., 3]
    real = ~((ay == by) & (ay.abs() >= PAD_MIN_DEG))
    E = pool.shape[1]
    pos = torch.arange(1, E + 1, dtype=torch.int32, device=pool.device)
    ecount = torch.where(real, pos, 0).amax(dim=1) if E else \
        torch.zeros(pool.shape[0], dtype=torch.int32, device=pool.device)
    return JoinTables(entry, pool, gzones, gwide,
                      pool[..., :4].contiguous(),
                      pool[..., 4].to(torch.int32).contiguous(),
                      ecount.to(torch.int32).contiguous())


class JoinConsts(NamedTuple):
    """The join's statics: the lattice window and the f32 thresholds."""

    res: int
    origin: Tuple[float, float]
    face0: int
    a0: int
    b0: int
    W: int
    H: int
    err32: float            # hex-margin threshold, lattice units
    gap32: float            # face-gap threshold
    eps32: float            # edge hazard band, degrees
    far_lim: float          # |local degree| beyond which a point is far


def join_body(points: torch.Tensor, projection: Projection,
              tables: JoinTables, consts: JoinConsts
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The join after the projection, as torch ops: ``projection`` is
    (face, a, b, margin, facegap) of ``points``."""
    face, ai, bi, margin, facegap = projection
    Z = int(tables.gzones.shape[1])
    far = (points[:, 0].abs() > consts.far_lim) | \
        (points[:, 1].abs() > consts.far_lim)
    ia = ai - consts.a0
    ib = bi - consts.b0
    inw = ((face == consts.face0) & (ia >= 0) & (ia < consts.W) &
           (ib >= 0) & (ib < consts.H))
    lidx = torch.where(inw, ia * consts.H + ib, 0).long()
    e = torch.where(inw, tables.entry[lidx], -1)
    is_core = (e >= 0) & ((e & CORE_FLAG) != 0)
    zone_core = torch.where(is_core, e & ~CORE_FLAG, -1)
    is_border = (e >= 0) & ~is_core

    g = torch.where(is_border, e, 0).long()
    rec = tables.pool[g]                            # [N, E, 5]
    ax, ay = rec[..., 0], rec[..., 1]
    bx, by = rec[..., 2], rec[..., 3]
    zs = rec[..., 4].to(torch.int32)
    px = points[:, None, 0]
    py = points[:, None, 1]
    straddle = (ay <= py) != (by <= py)
    dx, dy = bx - ax, by - ay
    t = (py - ay) / torch.where(by == ay, torch.ones_like(by), dy)
    xi = ax + t * dx
    crossed = straddle & (px < xi)
    # within eps of the crossing along x (the JAX body's band), or within
    # eps of the edge's line: the first alone misses points beside a
    # nearly horizontal edge, whose xi moves |dx / dy| times the f32
    # rounding of py and ay
    eps = torch.tensor(consts.eps32, dtype=torch.float32,
                       device=points.device)
    cr = dx * (py - ay) - dy * (px - ax)
    near_cross = straddle & (((px - xi).abs() < consts.eps32) |
                             (cr * cr < (eps * eps) * (dx * dx + dy * dy)))
    near_vertex = ((py - ay).abs() < consts.eps32) & \
        (px < torch.maximum(ax, bx) + consts.eps32)
    edge_flag = (near_cross | near_vertex).any(dim=-1) & is_border

    inside = torch.stack(
        [((crossed & (zs == z)).sum(dim=-1) & 1).bool()
         for z in range(Z)], dim=-1)                # [N, Z]
    first = torch.argmax(inside.to(torch.uint8), dim=-1)
    any_in = inside.any(dim=-1)
    gz = tables.gzones[g]                           # [N, Z]
    zone_border = torch.where(any_in & is_border,
                              gz.gather(1, first[:, None])[:, 0], -1)

    zone = torch.where(is_core, zone_core, zone_border)
    wide = tables.gwide[g] & is_border
    uncertain = (margin < consts.err32) | (facegap < consts.gap32) | \
        edge_flag | wide
    zone = torch.where(far, -1, zone).to(torch.int32)
    uncertain = uncertain & ~far
    return zone, uncertain


def dense_join_ref(points: torch.Tensor, tables: JoinTables,
                   consts: JoinConsts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the plain projection
    (:func:`project_lattice_ref`) and :func:`join_body`, on the inputs'
    device."""
    return join_body(points, project_lattice_ref(points, consts.res,
                                                 consts.origin),
                     tables, consts)


# ------------------------------------------------------------- kernel

class _Params(ctypes.Structure):
    """``JoinParams`` of csrc/h3_dense_join.cu, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("face0", "a0", "b0", "W", "H", "E", "Z")] + \
               [(name, ctypes.c_float) for name in
                ("err32", "gap32", "eps32", "far_lim")]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("h3_dense_join")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.h3_dense_join_set_faces.argtypes = [vp]
    lib.h3_dense_join_set_faces.restype = i
    lib.h3_dense_join.argtypes = [vp, i] + [vp] * 12
    lib.h3_dense_join.restype = i
    lib.h3_dense_join_error_string.argtypes = [i]
    lib.h3_dense_join_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _params(consts: JoinConsts, E: int, Z: int) -> _Params:
    return _Params(consts.face0, consts.a0, consts.b0, consts.W, consts.H,
                   E, Z, consts.err32, consts.gap32, consts.eps32,
                   consts.far_lim)


def _check_tables(tables: JoinTables, dev: torch.device) -> None:
    want = (("entry", torch.int32, 1), ("pool", torch.float32, 3),
            ("gzones", torch.int32, 2), ("gwide", torch.bool, 1),
            ("edges", torch.float32, 3), ("eslot", torch.int32, 2),
            ("ecount", torch.int32, 1))
    for (name, dtype, dim), t in zip(want, tables):
        if t.device != dev or t.dtype != dtype or t.dim() != dim or \
                not t.is_contiguous():
            raise ValueError(f"dense_join: table {name} must be a "
                             f"contiguous {dim}-d {dtype} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    G, E = tables.pool.shape[:2]
    if tables.pool.shape[2] != 5 or tables.gzones.shape[0] != G or \
            tables.gwide.shape[0] != G or \
            tables.edges.shape != (G, E, 4) or \
            tables.eslot.shape != (G, E) or tables.ecount.shape != (G,):
        raise ValueError("dense_join: pool [G, E, 5], gzones [G, Z], gwide "
                         "[G], edges [G, E, 4], eslot [G, E] and ecount [G] "
                         "must agree")
    if tables.edges.data_ptr() % 16:
        raise ValueError("dense_join: edges must be 16-byte aligned (read "
                         "as float4)")


def prepare(tables: JoinTables, consts: JoinConsts) -> None:
    """Build the kernel and put its constant tables on the tables'
    device, so that no launch copies to the device or synchronizes.  A
    no-op on the CPU."""
    dev = tables.entry.device
    if dev.type == "cuda":
        _check_tables(tables, dev)
        set_faces(_lib(), "h3_dense_join", dev)
        device_table(consts.res, dev)
        host_constants(consts.origin)


def dense_join(points: torch.Tensor, tables: JoinTables, consts: JoinConsts
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 2] f32 origin-local degrees -> (zone [N] i32, uncertain [N]
    bool) against a dense index's tables.

    Points and tables must share a device.  CPU tensors run the plain
    version.  CUDA tensors launch the kernel on the current stream and
    raise on anything it does not take (dtype, shape, contiguity,
    alignment) or on a CUDA error; there is no fallback.
    ``dense_join.launches`` counts kernel launches."""
    dev = points.device
    if tables.entry.device != dev:
        raise ValueError(f"dense_join: points on {dev}, tables on "
                         f"{tables.entry.device}")
    check_points(points, "dense_join")
    if dev.type == "cpu":
        return dense_join_ref(points, tables, consts)
    if dev.type != "cuda":
        raise ValueError(f"dense_join: unsupported device {dev}")
    _check_tables(tables, dev)
    n = int(points.shape[0])
    zone = torch.empty(n, dtype=torch.int32, device=dev)
    uncertain = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return zone, uncertain
    lib = _lib()
    set_faces(lib, "h3_dense_join", dev)
    table = device_table(consts.res, dev)
    k = host_constants(consts.origin)
    params = _params(consts, int(tables.pool.shape[1]),
                     int(tables.gzones.shape[1]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h3_dense_join(
            points.data_ptr(), n, table.data_ptr(), k.ctypes.data,
            ctypes.addressof(params), tables.entry.data_ptr(),
            tables.edges.data_ptr(), tables.eslot.data_ptr(),
            tables.ecount.data_ptr(), tables.gzones.data_ptr(),
            tables.gwide.data_ptr(), zone.data_ptr(), uncertain.data_ptr(),
            stream)
    check_rc(lib, "h3_dense_join", rc, "launch")
    dense_join.launches += 1
    return zone, uncertain


dense_join.launches = 0
