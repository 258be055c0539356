"""Tessellation's border-chip clip: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

Counterpart of the JAX package's clip pass,
``mosaic_tpu.core.tessellate.convex_clip_tasks`` with its device body
``_clip_bucket_jitted`` (``tess/clip``): Sutherland-Hodgman of each
(ring, cell) task's ring against every half-plane of its convex CCW
cell, in exact float64, the vertices in the order and rounding of the
JAX package's numpy ``_sh_halfplane``.

Input and output are flat CSR.  Ring r is rows ``ring_off[r]:ring_off[r
+ 1]`` of ``ring_xy`` [V, 2], open (no repeated closing vertex); a task
names its ring (``task_ring``) and its cell (``task_cell``) in a table
of cell vertices [U, K, 2] and counts [U].  The output is ``(xy, off,
count)``: task t's clipped ring has ``count[t]`` vertices, stored closed
(its first vertex again) at ``xy[off[t]:off[t] + count[t] + 1]`` when
``count[t] >= 1``.  The kernel's ``off`` leaves each task room for its
capacity; :func:`compact` packs either version's output tightly.

:func:`tess_clip` is the entry point.  On CUDA tensors it launches
``csrc/tess_clip.cu`` (built at first use), and relaunches the same
kernel at twice the capacity on the tasks whose concave ring outgrew
it, or raises; on CPU tensors it runs :func:`clip_tasks_ref`.  The two
agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from .projection import check_rc

#: the plain version's chunk: tasks x padded ring width at most this
PLAIN_BUDGET = 1 << 20
#: lanes a job the kernel takes: a thread a job (1), or a group of lanes
#: over the subject's vertices
LANES = (1, 4, 32)
#: the kernel's shared memory a block: two buffers of Cs vertices a job
SMEM_BUDGET = 100 * 1024
#: the largest capacity (ring length + K + 1) a launch may have for a
#: thread a job: the footprints' 4-vertex boxes (capacity 11) clip
#: faster so, the counties' and zones' rings (capacity 24-25) faster on
#: 4 lanes (PERF.md's K8 width table)
THREAD_CAP = 16



def _halfplane_ref(subj, counts, p0, p1, active):
    """One Sutherland-Hodgman half-plane over a batch: subj [M, W, 2],
    counts [M], clip edge p0 -> p1 [M, 2] (inside on its left), active [M]
    (rows whose cell has this plane; the others pass through).  Returns
    (subj', counts'); the JAX package's numpy ``_sh_halfplane`` op for
    op."""
    m, vmax = subj.shape[:2]
    dev = subj.device
    ev = p1 - p0
    vidx = torch.arange(vmax, device=dev)
    valid = vidx[None, :] < counts[:, None]
    nxt_i = torch.where(vidx[None, :] + 1 >= counts[:, None], 0,
                        vidx[None, :] + 1)
    nxt_v = torch.gather(subj, 1, nxt_i[..., None].expand(-1, -1, 2))
    d_cur = ev[:, None, 0] * (subj[..., 1] - p0[:, None, 1]) - \
        ev[:, None, 1] * (subj[..., 0] - p0[:, None, 0])
    d_nxt = ev[:, None, 0] * (nxt_v[..., 1] - p0[:, None, 1]) - \
        ev[:, None, 1] * (nxt_v[..., 0] - p0[:, None, 0])
    in_cur = d_cur >= 0
    in_nxt = d_nxt >= 0
    denom = d_cur - d_nxt
    t = torch.where(denom != 0,
                    d_cur / torch.where(denom == 0, 1.0, denom), 0.0)
    inter = subj + t[..., None] * (nxt_v - subj)
    emit_v = in_cur & valid
    emit_i = (in_cur != in_nxt) & valid
    n_emit = emit_v.to(torch.int64) + emit_i.to(torch.int64)
    pos = torch.cumsum(n_emit, dim=1) - n_emit
    new_count = n_emit.sum(dim=1)
    width = max(int(new_count.max()), vmax, 1)
    new_subj = torch.zeros((m, width, 2), dtype=subj.dtype, device=dev)
    ci, vi = torch.nonzero(emit_v, as_tuple=True)
    new_subj[ci, pos[ci, vi]] = subj[ci, vi]
    ci, vi = torch.nonzero(emit_i, as_tuple=True)
    new_subj[ci, pos[ci, vi] + emit_v[ci, vi]] = inter[ci, vi]
    keep = ~active
    new_subj[keep, :vmax] = subj[keep]
    return new_subj, torch.where(active, new_count, counts)


def clip_tasks_ref(ring_xy, ring_off, task_ring, task_cell, cell_verts,
                   cell_counts) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version: (xy, off, count) packed tightly, on the inputs'
    device.  Tasks in chunks of similar ring length (each chunk padded to
    its longest ring), every half-plane of each task's cell in turn."""
    dev = ring_xy.device
    T = int(task_ring.shape[0])
    K = int(cell_verts.shape[1])
    count = torch.zeros(T, dtype=torch.int32, device=dev)
    lens = (ring_off[1:] - ring_off[:-1])[task_ring]
    order = torch.argsort(lens, stable=True)
    sorted_lens = lens[order].tolist()
    chunks = []                          # (task ids, subj, counts)
    s = 0
    while s < T:
        e = min(T, s + max(1, PLAIN_BUDGET // max(sorted_lens[s], 1)))
        while e - s > 1 and (e - s) * sorted_lens[e - 1] > PLAIN_BUDGET:
            e = s + (e - s) // 2
        width = max(sorted_lens[e - 1], 1)
        sel = order[s:e]
        ar = torch.arange(width, device=dev)
        start = ring_off[task_ring[sel]]
        n = lens[sel]
        subj = ring_xy[torch.where(ar[None, :] < n[:, None],
                                   start[:, None] + ar, start[:, None])]
        c = task_cell[sel]
        cv = cell_verts[c]
        cc = cell_counts[c].to(torch.int64)
        rows = torch.arange(len(sel), device=dev)
        for kk in range(K):
            nxt = torch.where(kk + 1 >= cc, 0, kk + 1)
            subj, n = _halfplane_ref(subj, n, cv[:, kk], cv[rows, nxt],
                                     kk < cc)
        count[sel] = n.to(torch.int32)
        chunks.append((sel, subj, n))
        s = e
    sizes = torch.where(count >= 1, count.to(torch.int64) + 1, 0)
    off = torch.cumsum(sizes, 0) - sizes
    xy = torch.empty((int(sizes.sum()), 2), dtype=ring_xy.dtype, device=dev)
    for sel, subj, n in chunks:
        jj = torch.arange(subj.shape[1] + 1, device=dev)
        take = (jj[None, :] <= n[:, None]) & (n[:, None] >= 1)
        src = torch.where(jj[None, :] < n[:, None], jj[None, :], 0)
        r, j = torch.nonzero(take, as_tuple=True)
        xy[off[sel][r] + j] = subj[r, src[r, j]]
    return xy, off, count


def compact(xy, off, count) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xy', off') holding only each task's closed ring (``count + 1``
    vertices where ``count >= 1``), tightly packed in task order; the
    counts are unchanged."""
    sizes = torch.where(count >= 1, count.to(torch.int64) + 1, 0)
    new_off = torch.cumsum(sizes, 0) - sizes
    total = int(sizes.sum())
    pos = torch.arange(total, device=xy.device)
    src = torch.repeat_interleave(off - new_off, sizes, output_size=total)
    return xy[src + pos], new_off


def closed_rings(xy, off, count, min_count: int = 3
                 ) -> List[Optional[np.ndarray]]:
    """Host list, one per task: its closed clipped ring ([count + 1, 2]
    f64) where ``count >= min_count``, else None."""
    flat, offs = compact(xy, off, count)
    flat = flat.cpu().numpy()
    offs = offs.cpu().numpy().tolist()
    counts = count.cpu().numpy().tolist()
    return [flat[o:o + c + 1] if c >= min_count else None
            for o, c in zip(offs, counts)]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("tess_clip")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.tess_clip_launch.argtypes = [vp, vp, vp, i64, vp, vp, vp, vp, i, vp,
                                     vp, vp, vp, vp, vp, i, i, vp]
    lib.tess_clip_launch.restype = i
    lib.tess_clip_error_string.argtypes = [i]
    lib.tess_clip_error_string.restype = ctypes.c_char_p
    return lib


def _check(ring_xy, ring_off, task_ring, task_cell, cell_verts,
           cell_counts) -> None:
    """Raise unless the inputs are what both versions take."""
    named = (("ring_xy", ring_xy, torch.float64, 2),
             ("ring_off", ring_off, torch.int64, 1),
             ("task_ring", task_ring, torch.int64, 1),
             ("task_cell", task_cell, torch.int64, 1),
             ("cell_verts", cell_verts, torch.float64, 3),
             ("cell_counts", cell_counts, torch.int32, 1))
    for name, t, dtype, dim in named:
        if t.dtype != dtype or t.dim() != dim:
            raise ValueError(f"tess_clip: {name} must be {dim}-d {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != ring_xy.device:
            raise ValueError(f"tess_clip: {name} on {t.device}, ring_xy on "
                             f"{ring_xy.device}")
    if ring_xy.shape[1] != 2 or cell_verts.shape[2] != 2:
        raise ValueError("tess_clip: ring_xy [V, 2] and cell_verts [U, K, 2]")
    if task_ring.shape != task_cell.shape:
        raise ValueError("tess_clip: task_ring and task_cell differ in "
                         "length")
    if cell_counts.shape[0] != cell_verts.shape[0]:
        raise ValueError("tess_clip: cell_counts and cell_verts differ in "
                         "length")
    if cell_counts.numel():
        K = int(cell_verts.shape[1])
        cmin, cmax = torch.aminmax(cell_counts)
        cmin, cmax = int(cmin), int(cmax)
        if cmin < 0 or cmax > K:
            raise ValueError(f"tess_clip: cell_counts {cmin}..{cmax} "
                             f"outside 0..{K}, the cell table's width")


def lanes_for(cap_max: int, K: int) -> int:
    """The lanes a job of a launch whose largest capacity is ``cap_max``
    (cells of ``K`` vertex slots): a thread where no capacity passes
    THREAD_CAP, else 4 where every job's buffers fit in shared memory,
    else a warp."""
    if cap_max <= THREAD_CAP:
        return 1
    return 4 if cap_max <= shared_verts(4, K) else 32


def slots(lanes: int) -> int:
    """Jobs a block of the kernel takes at ``lanes`` a job: 64 threads a
    block at one lane a job, else 256 (csrc/tess_clip.cu ``Shape``)."""
    return 64 if lanes == 1 else 256 // lanes


def shared_verts(lanes: int, K: int) -> int:
    """The vertices of each of a job's two buffers that SMEM_BUDGET holds
    at ``lanes`` a job, beside the block's cells."""
    return max(0, (SMEM_BUDGET // (slots(lanes) * 16) - K) // 2)


def smem_verts(lanes: int, cap_max: int, K: int) -> int:
    """Cs, the vertices of each of a job's two buffers in shared memory:
    the launch's largest capacity, or what SMEM_BUDGET holds (jobs of
    larger capacity use global scratch)."""
    return min(cap_max, shared_verts(lanes, K))


def classes(cap: torch.Tensor, K: int) -> List[torch.Tensor]:
    """The positions in ``cap`` of a call's jobs, one launch each: those
    whose buffers fit in shared memory at 4 lanes a job, then the longer
    rings, which take a warp a job (on 4 lanes a long ring is a long
    chain of rounds); an empty class is left out."""
    long = cap > shared_verts(4, K)
    if not bool(long.any()):
        return [torch.arange(len(cap), device=cap.device)]
    return [p for p in (torch.nonzero(~long).flatten(),
                        torch.nonzero(long).flatten()) if len(p)]


def _launch(lib, args, jobs, cap, again: bool):
    """One launch over ``jobs`` (task ids) at capacities ``cap``, at
    :func:`lanes_for`'s lanes a job: (xy, off [J], count [J]), count -1
    where a job overflowed.  ``again``: a relaunch on overflowed
    tasks."""
    ring_xy, ring_off, task_ring, task_cell, cell_verts, cell_counts = args
    dev = ring_xy.device
    J = int(jobs.shape[0])
    cap64 = cap.to(torch.int64)
    size = cap64 + 1
    out_off = torch.cumsum(size, 0) - size
    n_out, cap_max = torch.stack([size.sum(), cap64.max()]).tolist()
    K = int(cell_verts.shape[1])
    lanes = lanes_for(cap_max, K)
    cs = smem_verts(lanes, cap_max, K)
    big = torch.where(cap64 > cs, 2 * cap64, 0)
    scratch_off = torch.cumsum(big, 0) - big
    n_scratch = int(big.sum()) if cap_max > cs else 0
    xy = torch.empty((n_out, 2), dtype=torch.float64, device=dev)
    scratch = torch.empty((max(n_scratch, 1), 2), dtype=torch.float64,
                          device=dev)
    count = torch.empty(J, dtype=torch.int32, device=dev)
    cap = cap.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        rc = lib.tess_clip_launch(
            ring_xy.data_ptr(), ring_off.data_ptr(), jobs.data_ptr(), J,
            task_ring.data_ptr(), task_cell.data_ptr(), cell_verts.data_ptr(),
            cell_counts.data_ptr(), K, cap.data_ptr(),
            out_off.data_ptr(), scratch_off.data_ptr(), scratch.data_ptr(),
            xy.data_ptr(), count.data_ptr(), lanes, cs,
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "tess_clip", rc, "launch")
    tess_clip.launches += 1
    tess_clip.relaunches += again
    return xy, out_off, count


def _launches(lib, args, jobs, cap, again: bool):
    """:func:`_launch` over each of the jobs' :func:`classes`: (xy, off,
    count) in the order of ``jobs``."""
    parts = classes(cap, int(args[4].shape[1]))
    if len(parts) == 1:
        return _launch(lib, args, jobs, cap, again)
    outs = [_launch(lib, args, jobs[p], cap[p], again) for p in parts]
    off = torch.empty(len(jobs), dtype=torch.int64, device=cap.device)
    count = torch.empty(len(jobs), dtype=torch.int32, device=cap.device)
    base = 0
    for p, (xy_p, off_p, count_p) in zip(parts, outs):
        off[p] = off_p + base
        count[p] = count_p
        base += xy_p.shape[0]
    return torch.cat([o[0] for o in outs]), off, count


def tess_clip(ring_xy: torch.Tensor, ring_off: torch.Tensor,
              task_ring: torch.Tensor, task_cell: torch.Tensor,
              cell_verts: torch.Tensor, cell_counts: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xy, off, count) of every task's clipped ring (the module's CSR).

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream at the convex capacity (ring length + K + 1), then
    again, at twice their capacity, on the tasks that overflowed it,
    until none does; they raise on anything the kernel does not take or
    on a CUDA error, and there is no fallback.  Each round launches once
    for the rings whose buffers fit in shared memory and once for the
    longer ones (:func:`classes`), and each launch picks its lanes a
    task (:func:`lanes_for`).  ``tess_clip.launches`` counts kernel
    launches, ``tess_clip.relaunches`` those on overflowed tasks."""
    _check(ring_xy, ring_off, task_ring, task_cell, cell_verts, cell_counts)
    dev = ring_xy.device
    if dev.type == "cpu":
        return clip_tasks_ref(ring_xy, ring_off, task_ring, task_cell,
                              cell_verts, cell_counts)
    if dev.type != "cuda":
        raise ValueError(f"tess_clip: unsupported device {dev}")
    args = tuple(t.contiguous() for t in (ring_xy, ring_off, task_ring,
                                          task_cell, cell_verts,
                                          cell_counts))
    if args[0].data_ptr() % 16 or args[4].data_ptr() % 16:
        raise ValueError("tess_clip: ring_xy and cell_verts must be 16-byte "
                         "aligned (read as double2)")
    T = int(task_ring.shape[0])
    if T == 0:
        return (torch.empty((0, 2), dtype=torch.float64, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    rmin, rmax, cmin, cmax = torch.stack([
        task_ring.min(), task_ring.max(), task_cell.min(),
        task_cell.max()]).tolist()
    if rmin < 0 or rmax >= ring_off.shape[0] - 1 or cmin < 0 or \
            cmax >= cell_verts.shape[0]:
        raise ValueError("tess_clip: a task's ring or cell is out of range")
    lib = _lib()
    lens = (args[1][1:] - args[1][:-1])[args[2]]
    cap = lens + int(cell_verts.shape[1]) + 1
    jobs = torch.arange(T, dtype=torch.int64, device=dev)
    xy, off, count = _launches(lib, args, jobs, cap, False)
    while True:
        bad = torch.nonzero(count < 0).flatten()
        if not len(bad):
            return xy, off, count
        cap[bad] *= 2
        xy2, off2, count2 = _launches(lib, args, bad, cap[bad], True)
        off[bad] = off2 + xy.shape[0]
        count[bad] = count2
        xy = torch.cat([xy, xy2])


tess_clip.launches = 0
tess_clip.relaunches = 0
