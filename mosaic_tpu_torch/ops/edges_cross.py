"""The edge-crossing matrix of two padded edge blocks: a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

Counterpart of the XLA body of
``mosaic_tpu.core.geometry.predicates.edges_cross_matrix`` (over
``segments_intersect``): [G1, G2] bool, whether any valid edge of g1
crosses or touches any valid edge of g2, for edge blocks a1, b1
[G1, E1, 2] with mask [G1, E1] and a2, b2 [G2, E2, 2] with mask
[G2, E2], in float32 or float64.  The test is in
``csrc/edges_cross.cu``.

:func:`edges_cross` is the entry point.  On CUDA tensors it launches
``csrc/edges_cross.cu`` (built at first use) or raises; on CPU tensors it
runs :func:`edges_cross_ref`.  Both round every step of an orientation
once, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from .edge_measures import check_blocks
from .projection import check_rc

#: the slots a block of ``csrc/edges_cross.cu`` stages in one pass, for
#: the g1 side and the g2 side, and the most geometries of a side's tile
#: (its kSlots1, kSlots2 and kMaxTile; the kernel refuses tiles past them)
SLOTS = (512, 512)
MAX_TILE = 64


def cross_tile(E: int, slots: int) -> int:
    """Geometries of capacity E a tile holds, so that one pass of
    ``slots`` slots stages them all: the largest power of two with
    tile * E <= slots, at least 1 (a geometry past the slots takes
    several passes) and at most MAX_TILE."""
    tile = 1
    while tile * 2 <= MAX_TILE and tile * 2 * E <= slots:
        tile *= 2
    return tile


def orient(px, py, qx, qy, rx, ry):
    """(q - p) x (r - p), each step rounded once."""
    return (qx - px) * (ry - py) - (qy - py) * (rx - px)


def segments_intersect_xy(a1x, a1y, b1x, b1y, a2x, a2y, b2x, b2y):
    """Proper-or-touching segment intersection on coordinate tensors,
    broadcasting (the JAX body's ``segments_intersect``)."""
    d1 = orient(a2x, a2y, b2x, b2y, a1x, a1y)
    d2 = orient(a2x, a2y, b2x, b2y, b1x, b1y)
    d3 = orient(a1x, a1y, b1x, b1y, a2x, a2y)
    d4 = orient(a1x, a1y, b1x, b1y, b2x, b2y)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & \
        (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)

    def on_seg(px, py, qx, qy, rx, ry, d):
        return (d == 0) & (torch.minimum(px, qx) <= rx) & \
            (rx <= torch.maximum(px, qx)) & \
            (torch.minimum(py, qy) <= ry) & (ry <= torch.maximum(py, qy))

    touch = on_seg(a2x, a2y, b2x, b2y, a1x, a1y, d1) | \
        on_seg(a2x, a2y, b2x, b2y, b1x, b1y, d2) | \
        on_seg(a1x, a1y, b1x, b1y, a2x, a2y, d3) | \
        on_seg(a1x, a1y, b1x, b1y, b2x, b2y, d4)
    return proper | touch


def edges_cross_ref(a1: torch.Tensor, b1: torch.Tensor, m1: torch.Tensor,
                    a2: torch.Tensor, b2: torch.Tensor, m2: torch.Tensor
                    ) -> torch.Tensor:
    """Plain version: a loop over g1's edge slots, [G1, G2, E2] a step."""
    G1, E1 = m1.shape
    out = torch.zeros((G1, m2.shape[0]), dtype=torch.bool, device=a1.device)
    q = [t[None] for t in (a2[..., 0], a2[..., 1], b2[..., 0], b2[..., 1])]
    for i in range(E1):
        p = [t[:, i, None, None] for t in (a1[..., 0], a1[..., 1],
                                           b1[..., 0], b1[..., 1])]
        hit = segments_intersect_xy(*p, *q) & m2[None] & \
            m1[:, i, None, None]
        out |= hit.any(-1)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("edges_cross")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn in (lib.edges_cross_f32_launch, lib.edges_cross_f64_launch):
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i, i, i, i, vp,
                       vp]
        fn.restype = i
    lib.edges_cross_error_string.argtypes = [i]
    lib.edges_cross_error_string.restype = ctypes.c_char_p
    return lib


def edges_cross(a1: torch.Tensor, b1: torch.Tensor, m1: torch.Tensor,
                a2: torch.Tensor, b2: torch.Tensor, m2: torch.Tensor
                ) -> torch.Tensor:
    """[G1, G2] bool: any valid edge of g1 crosses or touches any valid
    edge of g2; both blocks of one type and device.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    on the current stream and raise on anything it does not take or on
    a CUDA error; there is no fallback.  ``edges_cross.launches`` counts
    kernel launches."""
    check_blocks("edges_cross", a1, b1, m1)
    check_blocks("edges_cross", a2, b2, m2)
    if a2.dtype != a1.dtype or a2.device != a1.device:
        raise ValueError(f"edges_cross: the blocks differ in type or "
                         f"device ({a1.dtype} on {a1.device}, {a2.dtype} "
                         f"on {a2.device})")
    dev = a1.device
    if dev.type == "cpu":
        return edges_cross_ref(a1, b1, m1, a2, b2, m2)
    if dev.type != "cuda":
        raise ValueError(f"edges_cross: unsupported device {dev}")
    (G1, E1), (G2, E2) = m1.shape, m2.shape
    T1, T2 = cross_tile(E1, SLOTS[0]), cross_tile(E2, SLOTS[1])
    if -(-G1 // T1) * -(-G2 // T2) >= 1 << 31 or \
            max(E1 * T1, E2 * T2) >= 1 << 31:
        raise ValueError(f"edges_cross: {G1} x {G2} geometries is past the "
                         "kernel's grid")
    a1, b1, m1, a2, b2, m2 = (t.contiguous()
                              for t in (a1, b1, m1, a2, b2, m2))
    out = torch.empty((G1, G2), dtype=torch.bool, device=dev)
    lib = _lib()
    fn = lib.edges_cross_f64_launch if a1.dtype == torch.float64 else \
        lib.edges_cross_f32_launch
    with torch.cuda.device(dev):
        rc = fn(a1.data_ptr(), b1.data_ptr(), m1.data_ptr(), a2.data_ptr(),
                b2.data_ptr(), m2.data_ptr(), G1, G2, E1, E2, T1, T2,
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "edges_cross", rc, "launch")
    edges_cross.launches += 1
    return out


edges_cross.launches = 0
