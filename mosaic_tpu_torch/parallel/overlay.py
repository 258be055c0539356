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

Over a ``torch.distributed`` process group (``group=``, the JAX
package's ``mesh``/``axis``) both sides' rows split into row blocks over
the ranks and route to rank hash(cell) % D by one ``all_to_all`` of each
column (:func:`_exchange_rows`, into buckets sized exactly from the host
hash, :func:`_exact_bucket_cap`; an overflowing bucket is counted and the
exchange runs again at twice the capacity).  Each rank then runs the same
chip-pair kernel on the rows it received: the dense form sums the [GA, GB]
hits and hazards over the ranks (the JAX package's ``psum``), the pairs
form gathers each rank's keys.  Every rank returns the whole answer.
Each entry point runs on CUDA unless the caller passes ``device="cpu"``.
The JAX package's probe-width cap (``_exact_dup_cap``) has no counterpart:
the kernel walks each B row's whole range.

Host planes, as the JAX package's: the three entry points run under
``root_trace("overlay")`` and the ``overlay/row_pairs``,
``overlay/intersection_area`` and ``overlay/intersects`` spans; the
sharded exchange's starting capacity is the ``overlay.bucket_cap``
degrade site, whose doubling loop restores the exact answer (each
exchange run counts one ``overlay/exchange_rounds`` in ``obs.metrics``).  The JAX
package's ``overlay.dup_cap`` site has no place here, since there is no
probe-width cap: a plan that names it injects nothing.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.geometry.array import GeometryArray
from ..core.geometry.padded import build_edges_np
from ..core.index.base import IndexSystem
from ..core.tessellate import _pip, _poly_edges, _seg_cross, tessellate
from ..obs import metrics
from ..obs.context import traced
from ..obs.devicemon import devicemon, mesh_device_keys
from ..ops.overlay_pairs import ChipRows, overlay_dense, overlay_pairs
from ..resilience import faults
from ..types import ChipSet
from . import collectives as coll

EPS_DEG = 1e-6
#: the hash's multiplier: 0x9E3779B97F4A7C15 as a wrapped int64
_HASH_MIX = int(np.uint64(0x9E3779B97F4A7C15).astype(np.int64))


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


def _pad_rows(cell, ids, edges, valid, rows_per_dev: int, n_dev: int):
    """Row-block placement padded to [n_dev * rows_per_dev] rows: -1 cells
    and ids, 1e9 edges, invalid.  ``ids`` keeps its dtype."""
    n = len(cell)
    total = rows_per_dev * n_dev
    if n > total:
        raise ValueError(f"{n} rows exceed {n_dev}x{rows_per_dev}")
    pad = total - n
    cell = np.concatenate([cell, np.full(pad, -1, np.int64)])
    ids = np.concatenate([ids, np.full(pad, -1, ids.dtype)])
    edges = np.concatenate(
        [edges, np.full((pad, *edges.shape[1:]), 1e9, np.float32)])
    valid = np.concatenate([valid, np.zeros(pad, bool)])
    return cell, ids, edges, valid


def _hash_dest(cell: torch.Tensor, n_dev: int) -> torch.Tensor:
    """Destination rank of each cell: an int64 mix (the product wraps),
    an arithmetic shift, and a floor modulus, as the JAX package's."""
    h = cell * _HASH_MIX
    h = h ^ (h >> 29)
    return ((h % n_dev + n_dev) % n_dev).to(torch.int32)


def _hash_dest_np(cell: np.ndarray, n_dev: int) -> np.ndarray:
    """Host mirror of :func:`_hash_dest`, which sizes the exchange's
    buckets before it runs."""
    with np.errstate(over="ignore"):
        h = np.asarray(cell, np.int64) * np.int64(_HASH_MIX)
    h = h ^ (h >> 29)
    return ((h % n_dev + n_dev) % n_dev).astype(np.int32)


def _exact_bucket_cap(cells: np.ndarray, valid: np.ndarray,
                      n_dev: int) -> int:
    """The most valid rows any rank receives (at least 64): computed from
    the whole input, so every rank sizes its buckets alike."""
    if not valid.any():
        return 64
    d = _hash_dest_np(cells[valid], n_dev)
    return max(64, int(np.bincount(d, minlength=n_dev).max()))


def _exchange_rows(rows: ChipRows, bucket_cap: int, group
                   ) -> Tuple[ChipRows, int]:
    """Route this rank's rows to rank hash(cell) % D: a stable sort by
    destination, each row's position in its bucket, a scatter into [D *
    bucket_cap] send buffers and one ``all_to_all`` per column.  Returns
    the rows received ([D * bucket_cap], padding invalid) and how many
    valid rows of this rank found their bucket full (dropped, so the
    caller must retry)."""
    D = coll.group_size(group)
    cell, ids, edges, valid = rows
    dev = cell.device
    dest = torch.where(valid, _hash_dest(cell, D).long(), D)
    dest_s, order = torch.sort(dest, stable=True)
    pos = torch.arange(dest.shape[0], device=dev) - \
        torch.searchsorted(dest_s, dest_s)
    real = dest_s < D
    ok = real & (pos < bucket_cap)
    overflow = int((real & ~ok).sum())
    at = (dest_s * bucket_cap + pos)[ok]
    src = order[ok]
    n = D * bucket_cap
    sc = torch.full((n,), -1, dtype=torch.int64, device=dev)
    si = torch.full((n,), -1, dtype=torch.int64, device=dev)
    se = torch.full((n,) + tuple(edges.shape[1:]), 1e9,
                    dtype=torch.float32, device=dev)
    sv = torch.zeros(n, dtype=torch.bool, device=dev)
    sc[at], si[at], se[at], sv[at] = cell[src], ids[src], edges[src], \
        valid[src]
    got = ChipRows(*(coll.all_to_all(t, group) for t in (sc, si, se, sv)))
    return got, overflow


def _sharded_rows(rows: tuple, group, dev: torch.device) -> ChipRows:
    """This rank's row block of packed host rows (cell, ids, edges, valid),
    padded to equal blocks, on ``dev``."""
    D, r = coll.group_size(group), coll.group_rank(group)
    per = -(-len(rows[0]) // D)
    padded = _pad_rows(*rows[:4], per, D)
    return overlay_rows_from_arrays(
        [a[r * per:(r + 1) * per] for a in padded], dev)


def _account_exchange(site: str, D: int, cells: np.ndarray,
                      valid: np.ndarray, sent: Tuple[int, int],
                      keys, keep) -> None:
    """Collective accounting for one side's run of :func:`_exchange_rows`
    (the JAX package's ``_account_exchange``): the bytes and calls this
    rank sent through ``all_to_all`` (``sent``, read off
    ``collectives.COUNTS``) in ``collective/all_to_all_bytes``, its
    ``/<site>`` counter and ``collective/all_to_all_calls``; the shard
    skew of the exact host-side hash destination counts (the whole
    input's, so equal on every rank) in ``shard/skew/<site>``, its
    series and ``shard/rows_max/<site>``; and this rank's routed rows in
    the device monitor.  Summed over the ranks, the bytes are the JAX
    package's static send-buffer bytes with 8-byte ids where it counts
    4 (the port's ids travel as int64); the calls are the JAX
    package's on every rank.  One attribute check when metrics are
    disabled."""
    if not metrics.enabled:
        return
    nbytes, calls = sent
    metrics.count("collective/all_to_all_bytes", float(nbytes))
    metrics.count(f"collective/all_to_all_bytes/{site}", float(nbytes))
    metrics.count("collective/all_to_all_calls", float(calls))
    v = np.asarray(valid, bool)
    if v.any():
        counts = np.bincount(_hash_dest_np(np.asarray(cells)[v], D),
                             minlength=D)
        mean = float(counts.mean())
        skew = float(counts.max()) / mean if mean else 1.0
        metrics.gauge(f"shard/skew/{site}", skew)
        metrics.observe(f"shard/skew_series/{site}", skew)
        metrics.gauge(f"shard/rows_max/{site}", float(counts.max()))
        devicemon.observe_rows(site, counts, keys, keep=keep)


def _sent(name: str) -> Tuple[int, int]:
    calls, nbytes = coll.COUNTS[name]
    return nbytes, calls


def _exchanged(a: tuple, b: tuple, group, dev: torch.device,
               join: Callable[[ChipRows, ChipRows], object]):
    """``join`` on the rows this rank receives from both sides' exchange,
    with the buckets sized exactly; a bucket overflow on any rank (only
    a wrong size could cause one) doubles the capacity and runs the
    exchange again on every rank.  The starting capacity is the
    ``overlay.bucket_cap`` degrade site (a chaos plan shrinks it on
    purpose to drive the doubling loop); each exchange run counts one
    ``overlay/exchange_rounds``.  With the registry on, each side's
    exchange is accounted (:func:`_account_exchange`) and the call's
    wall time is charged to the devices by both sides' routed-row
    counts, this rank its own share (``obs.devicemon``)."""
    t0 = time.perf_counter()
    D, r = coll.group_size(group), coll.group_rank(group)
    keys = mesh_device_keys(group, dev)
    keep = keys[r] if group is not None else None
    cap = faults.degrade("overlay.bucket_cap",
                         max(_exact_bucket_cap(a[0], a[3], D),
                             _exact_bucket_cap(b[0], b[3], D)))
    ra, rb = _sharded_rows(a, group, dev), _sharded_rows(b, group, dev)
    while True:
        if metrics.enabled:
            metrics.count("overlay/exchange_rounds")
        s0 = _sent("all_to_all")
        xa, ofa = _exchange_rows(ra, cap, group)
        s1 = _sent("all_to_all")
        xb, ofb = _exchange_rows(rb, cap, group)
        s2 = _sent("all_to_all")
        _account_exchange("overlay", D, a[0], a[3],
                          (s1[0] - s0[0], s1[1] - s0[1]), keys, keep)
        _account_exchange("overlay", D, b[0], b[3],
                          (s2[0] - s1[0], s2[1] - s1[1]), keys, keep)
        over = torch.tensor([ofa + ofb], dtype=torch.int64, device=dev)
        if int(coll.all_reduce(over, group, "max")) == 0:
            out = join(xa, xb)
            break
        cap *= 2
    if metrics.enabled:
        w = np.zeros(D, np.int64)
        for cc, vv in ((a[0], a[3]), (b[0], b[3])):
            vv = np.asarray(vv, bool)
            if vv.any():
                w += np.bincount(_hash_dest_np(np.asarray(cc)[vv], D),
                                 minlength=D)
        devicemon.attribute("overlay", time.perf_counter() - t0, w, keys,
                            keep=keep)
    return out


# ----------------------------------------------------------- device logic

@traced("overlay", "overlay/row_pairs")
def overlay_row_pairs(chips_a: ChipSet, chips_b: ChipSet,
                      polys_a: GeometryArray, polys_b: GeometryArray,
                      res: int, grid: IndexSystem,
                      device: DeviceLike = None, group=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """All (row A, row B) chip pairs that share a cell and (possibly)
    touch, as (rows_a [K], rows_b [K]) global chip-row indices in
    ascending key order; the dense [GA, GB] matrix never materializes.
    Over a ``group`` each rank probes the rows the cell-hash exchange
    gives it, and every rank's keys are gathered."""
    dev = resolve_device(device)
    ra = pack_chip_rows(polys_a, res, grid, chips=chips_a, device=dev)
    rb = pack_chip_rows(polys_b, res, grid, chips=chips_b, origin=ra[4],
                        device=dev)
    ca, _, ea, va = ra[:4]
    cb, _, eb, vb = rb[:4]
    row_mult = int(len(cb)) + 1
    eps = hazard_eps(ea, eb)
    a = (ca, np.arange(len(ca), dtype=np.int64), ea, va)
    b = (cb, np.arange(len(cb), dtype=np.int64), eb, vb)
    if group is None:
        keys = overlay_pairs(overlay_rows_from_arrays(a, dev),
                             overlay_rows_from_arrays(b, dev), row_mult,
                             eps, pair_cap=max(1024, 4 * len(ca)))
    else:
        D = coll.group_size(group)
        cap = max(1024, 4 * -(-max(len(ca), len(cb)) // D))
        keys = coll.all_gather_varlen(_exchanged(
            a, b, group, dev,
            lambda xa, xb: overlay_pairs(xa, xb, row_mult, eps, cap)),
            group)
    keys = np.unique(keys.cpu().numpy())
    return keys // row_mult, keys % row_mult


@traced("overlay", "overlay/intersection_area")
def overlay_intersection_area(polys_a: GeometryArray,
                              polys_b: GeometryArray, res: int,
                              grid: IndexSystem, device: DeviceLike = None,
                              chips_a: Optional[ChipSet] = None,
                              chips_b: Optional[ChipSet] = None,
                              group=None):
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
    Over a ``group`` the row pairs come from the sharded exchange
    (:func:`overlay_row_pairs`) and every rank sums every pair's area.

    Returns (ga [K], gb [K], area [K]) for pairs with area > 0."""
    from ..core.geometry.clip import pairs_intersection_area
    if chips_a is None:
        chips_a = tessellate(polys_a, res, grid, keep_core_geom=True,
                             device=device)
    if chips_b is None:
        chips_b = tessellate(polys_b, res, grid, keep_core_geom=True,
                             device=device)
    rows_a, rows_b = overlay_row_pairs(chips_a, chips_b, polys_a, polys_b,
                                       res, grid, device=device,
                                       group=group)
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

@traced("overlay", "overlay/intersects")
def overlay_intersects(polys_a: GeometryArray, polys_b: GeometryArray,
                       res: int, grid: IndexSystem,
                       device: DeviceLike = None,
                       chips_a: Optional[ChipSet] = None,
                       chips_b: Optional[ChipSet] = None,
                       group=None) -> np.ndarray:
    """Exact ST_Intersects overlay: [GA, GB] bool.

    Packs both sides' chips (tessellated here unless ``chips_a``/
    ``chips_b`` are given, with ``keep_core_geom=True``), runs the chip
    join on the device, then settles the f32-hazard pairs on the host in
    f64.  Over a ``group`` each rank joins the rows the cell-hash
    exchange gives it and one ``all_reduce`` each sums the hits and
    hazards.  This is the BASELINE config 3 (building footprints x flood
    zones) engine."""
    dev = resolve_device(device)
    rows_a = pack_chip_rows(polys_a, res, grid, chips=chips_a, device=dev)
    rows_b = pack_chip_rows(polys_b, res, grid, chips=chips_b,
                            origin=rows_a[4], device=dev)
    ga, gb = len(polys_a), len(polys_b)
    eps = hazard_eps(rows_a[2], rows_b[2])
    if group is None:
        h, z = overlay_dense(overlay_rows_from_arrays(rows_a, dev),
                             overlay_rows_from_arrays(rows_b, dev), ga, gb,
                             eps)
    else:
        h, z = (coll.all_reduce(t, group) for t in _exchanged(
            rows_a, rows_b, group, dev,
            lambda xa, xb: overlay_dense(xa, xb, ga, gb, eps)))
    return resolve_hazards(h.cpu().numpy() > 0, z.cpu().numpy() > 0,
                           polys_a, polys_b)
