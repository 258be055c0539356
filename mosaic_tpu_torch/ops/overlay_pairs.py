"""The overlay's chip-pair probe: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Counterpart of the XLA body of ``mosaic_tpu.parallel.overlay``'s
single-device join: ``_chip_pair_test`` under ``_local_sorted_join`` (the
dense [GA, GB] hits and hazards) and ``_local_pair_join`` (the ragged
row-pair keys).  Both sides are chip rows (:class:`ChipRows`): cell id,
geometry or row id, f32 origin-local edges [N, E, 4] (ax, ay, bx, by;
1e9 padding) and a valid flag.  The A rows are sorted by cell on the
device, each B row finds its range of A rows of the same cell
(``torch.sort`` and ``torch.searchsorted``, the glue around the body),
and every (B row, A row) match runs the f32 chip-pair test: hit = a
proper edge crossing or either chip's first vertex inside the other;
hazard = an endpoint within ``eps`` of the other edge's line, or a
vertex within ``eps`` of the other chip's boundary.  The kernel walks a
flat list of the matches (:func:`match_list`: the prefix sum of the B
rows' range lengths), split evenly over the warps, a lane a match, after
a pre-pass (:func:`prep_b`) that compacts the B rows and computes their
edge lengths once.

:func:`overlay_dense` and :func:`overlay_pairs` are the entry points.  On
CUDA tensors they launch ``csrc/overlay_pairs.cu`` (built at first use)
or raise; on CPU tensors they run :func:`local_sorted_join_ref` and
:func:`local_pair_join_ref` over :func:`chip_pair_test_ref`, which keep
the kernel's order of operations, so the two agree bit for bit.  The
kernel walks each B row's whole range, so neither needs the JAX
package's duplicate cap or its retry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch

from .. import _kernels
from .projection import check_rc

#: an edge whose |ax| exceeds this is padding (the 1e9 sentinel)
PAD_ABOVE = 1e8
#: matches per step of the plain version ([M, E_a, E_b] temporaries)
REF_CHUNK = 1 << 14

_INT64_MAX = 0x7FFFFFFFFFFFFFFF


class ChipRows(NamedTuple):
    """One side's packed chip rows on a device."""

    cell: torch.Tensor      # [N] i64 cell id
    ids: torch.Tensor       # [N] i64 geometry id or global row id
    edges: torch.Tensor     # [N, E, 4] f32 origin-local, 1e9 padding
    valid: torch.Tensor     # [N] bool


def probe(a: ChipRows, b: ChipRows
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, start, upper): the A rows sorted by cell (invalid rows keyed
    INT64_MAX, last), and per B row the range [start, upper) of sorted
    positions with its cell; empty for an invalid B row."""
    key_a, order = torch.sort(torch.where(a.valid, a.cell, _INT64_MAX),
                              stable=True)
    q = torch.where(b.valid, b.cell, -_INT64_MAX)
    start = torch.searchsorted(key_a, q)
    upper = torch.searchsorted(key_a, q, right=True)
    return order, start, torch.where(b.valid, upper, start)


class MatchList(NamedTuple):
    """The kernel's flat list of matches: match m belongs to the B row j
    with offs[j] <= m < offs[j + 1] and tests A row ``order[start[j] + m -
    offs[j]]``."""

    order: torch.Tensor     # [NA] A rows sorted by cell (probe's)
    start: torch.Tensor     # [NB] range start of each B row
    offs: torch.Tensor      # [NB + 1] exclusive prefix sum of range lengths


def match_list(a: ChipRows, b: ChipRows) -> MatchList:
    """The flat list of every (B row, A row of the same cell) match, built
    from :func:`probe`'s ranges: the B rows in their own order, each row's
    matches together, and the prefix sum of their range lengths."""
    order, start, upper = probe(a, b)
    offs = torch.nn.functional.pad(torch.cumsum(upper - start, 0), (1, 0))
    return MatchList(order, start, offs)


# ------------------------------------------------------- plain version

def _orient(px, py, qx, qy, rx, ry):
    return (qx - px) * (ry - py) - (qy - py) * (rx - px)


def _lengths(e: torch.Tensor) -> torch.Tensor:
    """[..., E] f32 edge lengths, floored at 1e-30."""
    dx = e[..., 2] - e[..., 0]
    dy = e[..., 3] - e[..., 1]
    return torch.sqrt(dx * dx + dy * dy).clamp_min(1e-30)


def staged_rows_ref(edges: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of the kernel's B-row pre-pass (:func:`prep_b`):
    (count [N] of real edges, the real edges moved to the front in order
    [N, E, 4], their lengths [N, E] as :func:`_lengths` computes them and
    the f32 reciprocals of those), zero past the count."""
    real = ~(edges[..., 0].abs() > PAD_ABOVE)
    count = real.sum(dim=1)
    # a stable sort of the pad flags moves the real edges to the front
    pos = torch.sort((~real).to(torch.uint8), dim=1, stable=True)[1]
    moved = edges.gather(1, pos[..., None].expand(-1, -1, 4))
    keep = torch.arange(edges.shape[1], device=edges.device)[None, :] < \
        count[:, None]
    moved = torch.where(keep[..., None], moved, 0.0)
    lengths = torch.where(keep, _lengths(moved), 0.0)
    return count, moved, lengths, torch.where(keep, 1.0 / lengths, 0.0)


def _contains_ref(px: torch.Tensor, py: torch.Tensor, e: torch.Tensor,
                  eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inside [M], near [M]) of points (px, py) [M] against the edges
    [M, E, 4]: crossing parity with the half-open straddle rule, and
    whether the point lies within eps of the boundary."""
    px, py = px[:, None], py[:, None]
    ax, ay, bx, by = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
    epad = ax.abs() > PAD_ABOVE
    straddle = ((ay <= py) != (by <= py)) & ~epad
    t = (py - ay) / torch.where(by == ay, torch.ones_like(by), by - ay)
    xi = ax + t * (bx - ax)
    inside = ((straddle & (px < xi)).sum(dim=1) & 1).bool()
    near = (straddle & ((px - xi).abs() < eps)).any(dim=1) | \
        (((py - ay).abs() < eps) & ~epad &
         (px < torch.maximum(ax, bx) + eps)).any(dim=1)
    return inside, near


def chip_pair_test_ref(ea: torch.Tensor, eb: torch.Tensor, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hit [M], hazard [M]) of M chip pairs, ea [M, E_a, 4] and eb [M,
    E_b, 4] f32: the f32 intersects test and its hazard band, every
    operation in the kernel's order."""
    eps_t = torch.tensor(eps, dtype=torch.float32, device=ea.device)
    a1x, a1y, b1x, b1y = (ea[:, :, None, c] for c in range(4))
    a2x, a2y, b2x, b2y = (eb[:, None, :, c] for c in range(4))
    d1 = _orient(a2x, a2y, b2x, b2y, a1x, a1y)
    d2 = _orient(a2x, a2y, b2x, b2y, b1x, b1y)
    d3 = _orient(a1x, a1y, b1x, b1y, a2x, a2y)
    d4 = _orient(a1x, a1y, b1x, b1y, b2x, b2y)
    pad = (a1x.abs() > PAD_ABOVE) | (a2x.abs() > PAD_ABOVE)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & ~pad
    l1 = _lengths(ea)[:, :, None]
    l2 = _lengths(eb)[:, None, :]
    tiny = ((torch.minimum(d1.abs(), d2.abs()) / l2 < eps_t) |
            (torch.minimum(d3.abs(), d4.abs()) / l1 < eps_t)) & ~pad
    ina, na = _contains_ref(ea[:, 0, 0], ea[:, 0, 1], eb, eps_t)
    inb, nb = _contains_ref(eb[:, 0, 0], eb[:, 0, 1], ea, eps_t)
    hit = proper.flatten(1).any(dim=1) | ina | inb
    hazard = tiny.flatten(1).any(dim=1) | na | nb
    return hit, hazard


def _match_tests_ref(a: ChipRows, b: ChipRows, eps: float
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]]:
    """(A rows, B rows, hit, hazard) of every match, REF_CHUNK at a time:
    the j-th A row of each B row's range, for j up to the longest
    range."""
    order, start, upper = probe(a, b)
    n = upper - start
    for j in range(int(n.max()) if n.numel() else 0):
        rows = torch.nonzero(n > j).squeeze(1)
        for c in range(0, rows.numel(), REF_CHUNK):
            rb = rows[c:c + REF_CHUNK]
            ra = order[start[rb] + j]
            hit, hazard = chip_pair_test_ref(a.edges[ra], b.edges[rb], eps)
            yield ra, rb, hit, hazard


def local_sorted_join_ref(a: ChipRows, b: ChipRows, ga: int, gb: int,
                          eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dense mode: (hits [ga, gb] i32, hazards [ga,
    gb] i32), 1 where some chip pair of the geometry pair hits (is
    flagged); ids outside the matrix are dropped."""
    dev = a.edges.device
    hits = torch.zeros(ga * gb, dtype=torch.int32, device=dev)
    hazards = torch.zeros(ga * gb, dtype=torch.int32, device=dev)
    for ra, rb, hit, hazard in _match_tests_ref(a, b, eps):
        ia, ib = a.ids[ra], b.ids[rb]
        ok = (ia >= 0) & (ia < ga) & (ib >= 0) & (ib < gb)
        at = ia * gb + ib
        hits[at[hit & ok]] = 1
        hazards[at[hazard & ok]] = 1
    return hits.view(ga, gb), hazards.view(ga, gb)


def local_pair_join_ref(a: ChipRows, b: ChipRows, row_mult: int,
                        eps: float) -> torch.Tensor:
    """Plain version of the pairs mode: the keys ``id_a * row_mult +
    id_b`` [K] i64 of every match that hits or is flagged, in match
    order."""
    keys = []
    for ra, rb, hit, hazard in _match_tests_ref(a, b, eps):
        emit = hit | hazard
        keys.append(a.ids[ra][emit] * row_mult + b.ids[rb][emit])
    if not keys:
        return torch.zeros(0, dtype=torch.int64, device=a.edges.device)
    return torch.cat(keys)


# ------------------------------------------------------------- kernel

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("overlay_pairs")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.overlay_prep_b.argtypes = [vp, i, i64, vp, vp, vp]
    lib.overlay_prep_b.restype = i
    lib.overlay_pairs_launch.argtypes = [
        vp, vp, vp, i, vp, vp, i64, vp, vp, vp, vp, i, ctypes.c_float, i, vp,
        vp, i64, i64, vp, i64, vp, i64, vp]
    lib.overlay_pairs_launch.restype = i
    lib.overlay_pairs_error_string.argtypes = [i]
    lib.overlay_pairs_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(a: ChipRows, b: ChipRows, what: str) -> torch.device:
    """The rows' common device, after checking what the kernel reads."""
    dev = a.edges.device
    for side, r in (("a", a), ("b", b)):
        n = int(r.cell.shape[0])
        if r.edges.dtype != torch.float32 or r.edges.dim() != 3 or \
                r.edges.shape[2] != 4 or r.edges.shape[1] < 1:
            raise ValueError(f"{what}: edges_{side} must be [N, E, 4] "
                             f"float32, got {tuple(r.edges.shape)} "
                             f"{r.edges.dtype}")
        if r.cell.dtype != torch.int64 or r.ids.dtype != torch.int64 or \
                r.valid.dtype != torch.bool:
            raise ValueError(f"{what}: side {side} needs int64 cells and "
                             "ids and a bool valid flag")
        if not (r.ids.shape == r.valid.shape == (n,) and
                r.edges.shape[0] == n and r.cell.dim() == 1):
            raise ValueError(f"{what}: side {side} columns differ in "
                             "length")
        for t in r:
            if t.device != dev:
                raise ValueError(f"{what}: rows on {t.device} and {dev}")
        if dev.type == "cuda" and (not r.edges.is_contiguous() or
                                   r.edges.data_ptr() % 16):
            raise ValueError(f"{what}: edges_{side} must be contiguous and "
                             "16-byte aligned (read as float4)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


class Prepped(NamedTuple):
    """The kernel's pre-pass over the B rows: each row's real edges first,
    each (ax, ay, bx, by) then (bx - ax, by - ay, length, 1/length), and
    the count of real edges."""

    ew: torch.Tensor        # [NB, E_b, 2, 4] f32
    count: torch.Tensor     # [NB] i32


def prep_b(b: ChipRows) -> Prepped:
    """The pre-pass kernel over the CUDA rows ``b``, on the current
    stream.  Entries past a row's count are left unwritten;
    :func:`staged_rows_ref` is the plain version.  ``prep_b.launches``
    counts its launches."""
    dev = b.edges.device
    nb, eb = int(b.edges.shape[0]), int(b.edges.shape[1])
    out = Prepped(torch.empty((nb, eb, 2, 4), dtype=torch.float32,
                               device=dev),
                  torch.empty(nb, dtype=torch.int32, device=dev))
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.overlay_prep_b(
            b.edges.data_ptr(), eb, nb, *(t.data_ptr() for t in out),
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "overlay_pairs", rc, "pre-pass launch")
    prep_b.launches += 1
    return out


prep_b.launches = 0


def _launch(a: ChipRows, b: ChipRows, eps: float, mode: int, *,
            hits=None, hazards=None, ga: int = 0, gb: int = 0, keys=None,
            cap: int = 0, count=None, row_mult: int = 0) -> None:
    """One launch of the pre-pass and one of the kernel on the current
    stream."""
    ml = match_list(a, b)
    pb = prep_b(b)
    dev = a.edges.device
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.overlay_pairs_launch(
            a.edges.data_ptr(), ml.order.data_ptr(),
            a.ids.contiguous().data_ptr(), int(a.edges.shape[1]),
            ml.start.data_ptr(), ml.offs.data_ptr(), int(b.cell.shape[0]),
            b.edges.data_ptr(), b.ids.contiguous().data_ptr(),
            *(t.data_ptr() for t in pb), int(b.edges.shape[1]), float(eps),
            mode, ptr(hits), ptr(hazards), ga, gb, ptr(keys), cap,
            ptr(count), row_mult, stream)
    check_rc(lib, "overlay_pairs", rc, "launch")


def _nonempty(a: ChipRows, b: ChipRows) -> bool:
    return a.cell.shape[0] > 0 and b.cell.shape[0] > 0


def overlay_dense(a: ChipRows, b: ChipRows, ga: int, gb: int, eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hits [ga, gb] i32, hazards [ga, gb] i32) of the chip rows of both
    sides, whose ids are geometry ids.

    CPU rows run the plain version.  CUDA rows launch the kernel on the
    current stream and raise on anything it does not take or on a CUDA
    error; there is no fallback.  ``overlay_dense.launches`` counts
    kernel launches."""
    dev = _check_rows(a, b, "overlay_dense")
    if dev.type == "cpu":
        return local_sorted_join_ref(a, b, ga, gb, eps)
    hits = torch.zeros((ga, gb), dtype=torch.int32, device=dev)
    hazards = torch.zeros((ga, gb), dtype=torch.int32, device=dev)
    if _nonempty(a, b) and ga and gb:
        _launch(a, b, eps, 0, hits=hits, hazards=hazards, ga=ga, gb=gb)
        overlay_dense.launches += 1
    return hits, hazards


overlay_dense.launches = 0


def _pairs_once(a: ChipRows, b: ChipRows, row_mult: int, eps: float,
                cap: int) -> Tuple[torch.Tensor, int]:
    """(the first min(total, cap) keys, the exact total)."""
    dev = a.edges.device
    if dev.type == "cpu":
        keys = local_pair_join_ref(a, b, row_mult, eps)
        return keys[:cap], int(keys.numel())
    keys = torch.empty(max(cap, 1), dtype=torch.int64, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if not _nonempty(a, b):
        return keys[:0], 0
    _launch(a, b, eps, 1, keys=keys, cap=cap, count=count,
            row_mult=row_mult)
    overlay_pairs.launches += 1
    total = int(count.item())
    return keys[:min(total, cap)], total


def overlay_pairs(a: ChipRows, b: ChipRows, row_mult: int, eps: float,
                  pair_cap: int) -> torch.Tensor:
    """Keys ``id_a * row_mult + id_b`` [K] i64 of every chip-row pair that
    shares a cell and hits or is flagged, in no particular order (the
    caller takes ``np.unique``).

    The keys go into a buffer of ``pair_cap``; when the total is larger,
    the probe runs once more with a buffer of exactly the total, so
    nothing is dropped.  CPU rows run the plain version, CUDA rows the
    kernel (one launch, or two after a short buffer) or raise.
    ``overlay_pairs.launches`` counts kernel launches."""
    _check_rows(a, b, "overlay_pairs")
    if pair_cap < 1:
        raise ValueError(f"overlay_pairs: pair_cap {pair_cap} < 1")
    keys, total = _pairs_once(a, b, row_mult, eps, pair_cap)
    if total > pair_cap:
        keys, total = _pairs_once(a, b, row_mult, eps, total)
    return keys


overlay_pairs.launches = 0
