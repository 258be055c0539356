"""Point queries against padded edge blocks: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

Counterpart of the XLA bodies of ``mosaic_tpu.core.geometry.predicates``
``crossing_number`` and ``points_in_polygons`` and of
``mosaic_tpu.core.geometry.measures.distance_points_to_geoms``: for every
(point, geometry) pair of points [N, 2] and edge blocks a, b [G, E, 2]
with mask [G, E], the half-open +x ray crossing count ([N, G] int32)
and/or the distance to the nearest valid edge ([N, G], +inf where none is
valid), in float32 or float64.  The formulas, the 1e-300 guard (0 in
float32) and the NaN rules are in ``csrc/edge_point_query.cu``.

:func:`edge_point_query` is the entry point.  On CUDA tensors it launches
``csrc/edge_point_query.cu`` (built at first use), once for both outputs,
or raises; on CPU tensors it runs :func:`edge_point_query_ref`.  Both take
the edges in slot order and round every step once, so they agree bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _kernels
from .edge_measures import check_blocks, guards, keep_min
from .projection import check_rc

#: the output tile a block of ``csrc/edge_point_query.cu`` owns: points
#: and geometries (its kTilePts and kTileGeoms)
TILE_POINTS = 64
TILE_GEOMS = 32


def edge_point_query_ref(points: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, mask: torch.Tensor,
                         count: bool = True, dist: bool = False
                         ) -> Tuple[Optional[torch.Tensor],
                                    Optional[torch.Tensor]]:
    """Plain version: a loop over the edge slots in order, [N, G] a
    step."""
    N, G, E = points.shape[0], mask.shape[0], mask.shape[1]
    dt = a.dtype
    px, py = points[:, 0:1], points[:, 1:2]
    eps, _ = guards(dt)
    cnt = torch.zeros((N, G), dtype=torch.int32, device=a.device) \
        if count else None
    dmin = torch.full((N, G), float("inf"), dtype=dt, device=a.device) \
        if dist else None
    for e in range(E):
        ax, ay = a[:, e, 0], a[:, e, 1]
        bx, by = b[:, e, 0], b[:, e, 1]
        m = mask[:, e]
        if count:
            straddles = (ay <= py) != (by <= py)
            t = (py - ay) / torch.where(by == ay, 1.0, by - ay)
            xi = ax + t * (bx - ax)
            cnt += (straddles & (px < xi) & m).to(torch.int32)
        if dist:
            abx, aby = bx - ax, by - ay
            apx, apy = px - ax, py - ay
            denom = abx * abx + aby * aby
            t = torch.clamp((apx * abx + apy * aby) / (denom + eps), 0.0,
                            1.0)
            dx = px - (ax + t * abx)
            dy = py - (ay + t * aby)
            d2 = torch.where(m, dx * dx + dy * dy, float("inf"))
            dmin = keep_min(dmin, d2)
    return cnt, (torch.sqrt(dmin) if dist else None)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("edge_point_query")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn in (lib.edge_point_query_f32_launch,
               lib.edge_point_query_f64_launch):
        fn.argtypes = [vp, vp, vp, vp, i64, i64, i, vp, vp, vp]
        fn.restype = i
    lib.edge_point_query_error_string.argtypes = [i]
    lib.edge_point_query_error_string.restype = ctypes.c_char_p
    return lib


def edge_point_query(points: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, mask: torch.Tensor,
                     count: bool = True, dist: bool = False
                     ) -> Tuple[Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """(crossing counts [N, G] int32 or None, distances [N, G] or None)
    of points [N, 2] against the edge blocks a, b [G, E, 2] and mask
    [G, E], points and blocks of one type; ``count`` and ``dist`` say
    which to compute.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    on the current stream, once for both outputs, and raise on anything
    it does not take or on a CUDA error; there is no fallback.
    ``edge_point_query.launches`` counts kernel launches."""
    if not (count or dist):
        raise ValueError("edge_point_query: ask for count, dist or both")
    check_blocks("edge_point_query", a, b, mask)
    if points.dim() != 2 or points.shape[1] != 2 or \
            points.dtype != a.dtype or points.device != a.device:
        raise ValueError(f"edge_point_query: points must be [N, 2] "
                         f"{a.dtype} on {a.device}, got "
                         f"{tuple(points.shape)} {points.dtype} on "
                         f"{points.device}")
    dev = a.device
    if dev.type == "cpu":
        return edge_point_query_ref(points, a, b, mask, count, dist)
    if dev.type != "cuda":
        raise ValueError(f"edge_point_query: unsupported device {dev}")
    N, G, E = points.shape[0], mask.shape[0], mask.shape[1]
    if -(-N // TILE_POINTS) * -(-G // TILE_GEOMS) >= 1 << 31 or \
            E >= 1 << 31:
        raise ValueError(f"edge_point_query: {N} points x {G} geometries "
                         "is past the kernel's grid")
    points, a, b, mask = (t.contiguous() for t in (points, a, b, mask))
    cnt = torch.empty((N, G), dtype=torch.int32, device=dev) \
        if count else None
    dst = torch.empty((N, G), dtype=a.dtype, device=dev) if dist else None
    lib = _lib()
    fn = lib.edge_point_query_f64_launch if a.dtype == torch.float64 else \
        lib.edge_point_query_f32_launch
    with torch.cuda.device(dev):
        rc = fn(points.data_ptr(), a.data_ptr(), b.data_ptr(),
                mask.data_ptr(), N, G, E,
                cnt.data_ptr() if count else None,
                dst.data_ptr() if dist else None,
                torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "edge_point_query", rc, "launch")
    edge_point_query.launches += 1
    return cnt, dst


edge_point_query.launches = 0
