"""SpatialKNN's ring step: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of the XLA body of ``mosaic_tpu.models.knn``'s ring march
(``SpatialKNN._make_step``'s ``step``): for every left row, the offsets of
one hex ring in its face's lattice window, each offset's window entry
and pool row, folded into the row's running top-(k+1) of (f32 squared
distance, code ``slot * cap + j``).  A candidate outside the window, in
an empty cell or past ``thr2`` is (inf, -1).

:func:`ring_step` is the entry point.  On CUDA tensors it launches
``csrc/knn_ring_step.cu`` (built at first use) or raises; on CPU tensors
it runs :func:`ring_step_ref`, the reference's scan with a stable sort in
place of ``lax.top_k`` (the k+1 smallest, ties to the lower position).
The two agree bit for bit at every list length k+1: the kernel keeps a
list in registers up to 64 entries, past that in shared memory, and past
what shared memory holds in global memory.  Its threads take the rows in
the order given; :func:`lattice_order` is the order it wants them in.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _kernels
from .projection import check_rc

#: candidates per row-group step of the plain version (its [N, G, cap]
#: temporaries)
REF_CANDIDATES = 1 << 24


def ring_step_ref(entry, pool_xy, pts, al, bl, a0r, b0r, wr, hr, eoffr,
                  top_d2, top_code, offs, omask, cap: int, thr2: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one ring: the running lists (top_d2 [N, k+1] f32,
    top_code [N, k+1] i32) after every offset of ``offs`` [P, 2] i32
    whose ``omask`` [P] bool is set, in order.

    Folding the offsets one at a time into the k+1 smallest, ties to the
    earlier entry, leaves the k+1 smallest of the running list followed
    by all the offsets' candidates in order, ties again to the earlier;
    so the offsets are taken in groups of up to REF_CANDIDATES candidates
    a group, each group by one stable sort."""
    n, k1 = int(pts.shape[0]), int(top_d2.shape[1])
    j = torch.arange(cap, dtype=torch.int32, device=pts.device)
    group = max(1, REF_CANDIDATES // max(n * cap, 1))
    for g in range(0, int(offs.shape[0]), group):
        og, mg = offs[g:g + group], omask[g:g + group]
        ia = al[:, None] + og[None, :, 0] - a0r[:, None]       # [N, G]
        ib = bl[:, None] + og[None, :, 1] - b0r[:, None]
        inw = mg[None, :] & (ia >= 0) & (ia < wr[:, None]) & (ib >= 0) & \
            (ib < hr[:, None])
        lidx = torch.where(inw, eoffr[:, None] + ia * hr[:, None] + ib, 0)
        slot = torch.where(inw, entry[lidx.long()], -1)
        rec = pool_xy[slot.clamp_min(0).long()]            # [N, G, cap, 2]
        dx = rec[..., 0] - pts[:, None, None, 0]
        dy = rec[..., 1] - pts[:, None, None, 1]
        d2 = dx * dx + dy * dy
        bad = (slot[..., None] < 0) | (d2 > thr2)
        d2 = torch.where(bad, torch.inf, d2)
        code = torch.where(bad, -1, slot[..., None] * cap + j)
        alld2 = torch.cat([top_d2, d2.reshape(n, -1)], dim=1)
        allcode = torch.cat([top_code, code.reshape(n, -1).to(torch.int32)],
                            dim=1)
        srt, sel = torch.sort(alld2, dim=1, stable=True)
        top_d2 = srt[:, :k1].contiguous()
        top_code = torch.gather(allcode, 1, sel[:, :k1]).contiguous()
    return top_d2, top_code


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = _kernels.load("knn_ring_step")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.knn_ring_step_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64, vp, vp, vp, vp, vp, vp,
        i, i, i, ctypes.c_float, vp]
    lib.knn_ring_step_launch.restype = i
    lib.knn_ring_step_error_string.argtypes = [i]
    lib.knn_ring_step_error_string.restype = ctypes.c_char_p
    return lib


def _check(entry, pool_xy, pts, rows, top_d2, top_code, offs, omask, cap):
    """Raise on anything the kernel does not take; the common device."""
    n = int(pts.shape[0])
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 2:
        raise ValueError(f"ring_step: pts must be [N, 2] float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    if pool_xy.dtype != torch.float32 or pool_xy.dim() != 3 or \
            pool_xy.shape[1:] != (cap, 2):
        raise ValueError(f"ring_step: pool_xy must be [C, {cap}, 2] "
                         f"float32, got {tuple(pool_xy.shape)}")
    if entry.dtype != torch.int32 or entry.dim() != 1:
        raise ValueError("ring_step: entry must be [E] int32")
    for t in rows:
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"ring_step: window scalars must be [{n}] "
                             "int32")
    k1 = int(top_d2.shape[1]) if top_d2.dim() == 2 else 0
    if k1 < 1:
        raise ValueError(f"ring_step: k + 1 = {k1} < 1")
    if top_d2.dtype != torch.float32 or top_code.dtype != torch.int32 or \
            top_d2.shape != (n, k1) or top_code.shape != (n, k1):
        raise ValueError("ring_step: top_d2/top_code must be [N, k+1] "
                         "float32/int32")
    if offs.dtype != torch.int32 or offs.dim() != 2 or offs.shape[1] != 2 \
            or omask.dtype != torch.bool or \
            omask.shape != (offs.shape[0],):
        raise ValueError("ring_step: offs [P, 2] int32 and omask [P] bool")
    dev = pts.device
    for t in (entry, pool_xy, *rows, top_d2, top_code, offs, omask):
        if t.device != dev:
            raise ValueError(f"ring_step: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ring_step: unsupported device {dev}")
    return dev


def lattice_order(al, bl, a0r, b0r, eoffr) -> torch.Tensor:
    """[N] i64: the rows sorted by face window, then by the Morton code
    of their window coordinates (clamped to 0..65535).  Rows handed to
    :func:`ring_step` in this order put neighbouring kernel threads on
    neighbouring cells, where they share most of their ring's entries
    and pool rows."""
    def spread(v):                 # 16 bits to the even bits of 32
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555
    ia = (al - a0r).long().clamp(0, 0xFFFF)
    ib = (bl - b0r).long().clamp(0, 0xFFFF)
    key = (eoffr.long() << 32) | spread(ia) | (spread(ib) << 1)
    return torch.argsort(key, stable=True)


def ring_step(entry, pool_xy, pts, al, bl, a0r, b0r, wr, hr, eoffr, top_d2,
              top_code, offs, omask, cap: int, thr2: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring of the march: the new (top_d2, top_code).

    ``entry`` [E] i32 (global pool slot or -1), ``pool_xy`` [C, cap, 2]
    f32 (face-local, 1e9 padding), ``pts`` [N, 2] f32 face-local left
    points, ``al bl a0r b0r wr hr eoffr`` [N] i32 (each row's lattice
    coordinates and its face window), the running lists, the ring's
    ``offs`` [P, 2] i32 and ``omask`` [P] bool, and ``thr2`` (the f32
    squared threshold, inf for none).  CPU tensors run the plain version;
    CUDA tensors launch the kernel on the current stream and raise on
    anything it does not take or on a CUDA error; there is no fallback.
    ``ring_step.launches`` counts kernel launches."""
    rows = (al, bl, a0r, b0r, wr, hr, eoffr)
    dev = _check(entry, pool_xy, pts, rows, top_d2, top_code, offs, omask,
                 cap)
    if dev.type == "cpu":
        return ring_step_ref(entry, pool_xy, pts, *rows, top_d2, top_code,
                             offs, omask, cap, thr2)
    n, k1 = int(pts.shape[0]), int(top_d2.shape[1])
    args = [t.contiguous() for t in (entry, pool_xy, pts, *rows, top_d2,
                                     top_code, offs, omask)]
    if args[1].data_ptr() % 8 or args[2].data_ptr() % 8 or \
            args[12].data_ptr() % 16 or args[13].data_ptr() % 4:
        raise ValueError("ring_step: pool_xy and pts must be 8-byte, offs "
                         "16-byte and omask 4-byte aligned (read as float2, "
                         "int4 and uchar4)")
    out_d2 = torch.empty_like(top_d2)
    out_code = torch.empty_like(top_code)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in args]
        rc = lib.knn_ring_step_launch(
            *ptrs[:10], n, ptrs[10], ptrs[11], out_d2.data_ptr(),
            out_code.data_ptr(), ptrs[12], ptrs[13], int(offs.shape[0]),
            int(cap), k1, float(thr2), stream)
    check_rc(lib, "knn_ring_step", rc, "launch")
    ring_step.launches += 1
    return out_d2, out_code


ring_step.launches = 0
