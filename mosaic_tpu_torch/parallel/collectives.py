"""The process group under the sharded paths: the port's stand-in for the
JAX package's device mesh.

Each sharded entry point takes ``group``, a ``torch.distributed`` process
group, where the JAX package takes ``mesh`` and ``axis``.  ``None`` means
one device and runs the single-device code path unchanged.  The contract
is SPMD: every rank of the group calls the entry point with the same host
inputs and arguments, works on its own device (the current CUDA device
unless the caller passes ``device="cpu"``) and returns the whole output,
the JAX package's global-array view.

This module holds the collectives those paths use, written once for any
backend (NCCL on the card, gloo on the CPU in the tests): the JAX
package's ``psum``/``pmax`` become :func:`all_reduce`, gathering a
sharded output becomes :func:`all_gather`, the overlay's cell-hash
``all_to_all`` :func:`all_to_all`, the raster halo's two ``ppermute``
shifts :func:`exchange_halo`, and a decision made on rank 0
:func:`broadcast`.  Booleans travel as ``uint8``; every buffer is made
contiguous and every split is equal.  A group that is given while no
process group is initialised raises; nothing falls back to one device.

``COUNTS`` holds each collective's calls and the bytes this rank sent
through it since :func:`reset_counts`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["group_size", "group_rank", "row_block", "all_gather",
           "all_gather_varlen", "all_reduce", "all_to_all", "broadcast",
           "exchange_halo", "COUNTS", "reset_counts"]

#: collective -> [calls, bytes this rank sent]
COUNTS = {name: [0, 0] for name in ("all_gather", "all_reduce",
                                    "all_to_all", "broadcast", "p2p")}


def reset_counts() -> None:
    for v in COUNTS.values():
        v[0] = v[1] = 0


def _count(name: str, nbytes: int) -> None:
    COUNTS[name][0] += 1
    COUNTS[name][1] += int(nbytes)


def group_size(group) -> int:
    """Ranks in ``group``; 1 for ``None`` (one device)."""
    if group is None:
        return 1
    if not dist.is_initialized():
        raise RuntimeError("a process group was given but "
                           "torch.distributed is not initialised: call "
                           "init_process_group first, or pass group=None")
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in ``group``; 0 for ``None``."""
    if group is None:
        return 0
    group_size(group)
    r = dist.get_rank(group)
    if r < 0:
        raise ValueError("this process is not a member of the group")
    return r


def row_block(n: int, size: int, rank: int) -> slice:
    """The rows of ``n`` that ``rank`` of ``size`` holds: contiguous
    blocks of ceil(n / size) rows, the last ones short or empty."""
    per = -(-n // size) if n else 0
    return slice(min(rank * per, n), min((rank + 1) * per, n))


def _wire(t: torch.Tensor) -> torch.Tensor:
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (same shape on all ranks) stacked along dim 0 in
    rank order."""
    D = group_size(group)
    if group is None:
        return t
    w = _wire(t)
    out = torch.empty((D,) + tuple(w.shape), dtype=w.dtype, device=w.device)
    dist.all_gather(list(out.unbind(0)), w, group=group)
    _count("all_gather", w.numel() * w.element_size())
    out = out.reshape((D * w.shape[0],) + tuple(w.shape[1:])) if w.dim() \
        else out
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_gather_varlen(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (lengths may differ along dim 0) concatenated in
    rank order: one gather of the lengths, one of the blocks padded to the
    longest."""
    if group is None:
        return t
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    lens = all_gather(n, group).tolist()
    pad = torch.zeros((max(lens) - t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    blocks = all_gather(torch.cat([t, pad]), group).split(max(lens))
    return torch.cat([b[:m] for b, m in zip(blocks, lens)])


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the group (``op`` "sum" or "max"), in place;
    the JAX package's ``psum`` / ``pmax``."""
    if group is None:
        return t
    group_size(group)
    w = _wire(t)
    dist.all_reduce(w, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    _count("all_reduce", w.numel() * w.element_size())
    if w is not t:
        t.copy_(w)
    return t


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """Block d of ``send`` (dim 0 split into group-size equal blocks) goes
    to rank d; returns the blocks received, in rank order."""
    if group is None:
        return send
    group_size(group)
    w = _wire(send)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    _count("all_to_all", w.numel() * w.element_size())
    return out.to(torch.bool) if send.dtype == torch.bool else out


def broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, in place."""
    if group is None:
        return t
    group_size(group)
    dist.broadcast(t, group=group, group_src=0)
    _count("broadcast", t.numel() * t.element_size()
           if group_rank(group) == 0 else 0)
    return t


def exchange_halo(slab: torch.Tensor, halo: int, group
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows above, rows below) a row slab [bands, rows, W]: the previous
    rank's last ``halo`` rows and the next rank's first ``halo`` rows, in
    one ``batch_isend_irecv``; zero rows past the first and last rank, as
    the JAX package's ``ppermute`` without wraparound gives."""
    bands, _, W = slab.shape
    above = torch.zeros((bands, halo, W), dtype=slab.dtype,
                        device=slab.device)
    below = torch.zeros_like(above)
    D, r = group_size(group), group_rank(group)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, slab[:, :halo].contiguous(),
                           group=group, group_peer=r - 1),
                dist.P2POp(dist.irecv, above, group=group,
                           group_peer=r - 1)]
    if r < D - 1:
        ops += [dist.P2POp(dist.isend, slab[:, -halo:].contiguous(),
                           group=group, group_peer=r + 1),
                dist.P2POp(dist.irecv, below, group=group,
                           group_peer=r + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        _count("p2p", (len(ops) // 2) * above.numel() * above.element_size())
    return above, below
