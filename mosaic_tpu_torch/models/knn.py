"""SpatialKNN: grid-ring nearest-neighbour transformer.

Port of ``mosaic_tpu.models.knn``.  Reference counterparts:
models/knn/SpatialKNN.scala:28 (Spark-ML Transformer; params
kNeighbours/maxIterations/distanceThreshold/indexResolution;
early stop :108-121; transform :202) and
models/knn/GridRingNeighbours.scala:76-99 (iteration 1 = k-ring explode,
iteration i = hollow k-loop, join on cell id, distance + row_number
window for the k best).

Points x points (the AIS-pings x world-ports shape of BASELINE config 4)
take one of two exact engines, both on the device:

* **brute** (right side of at most ``brute_right_max`` rows): left rows
  in spatially coherent blocks of 8,192, one all-pairs f32 top-(k+8)
  launch per block on block-centered coordinates (``ops/knn_brute.py``,
  kernel K5), an f64 re-rank on the host overlapping the next block, and
  an exact host pass for the rows the f32 horizon cannot prove complete;
* **ring**: the right side becomes fused per-face lattice windows with a
  padded pool of point coordinates per cell (:class:`FusedKNNIndex`); ring
  d of a row is the 6d axial offsets of its face's window, scanned by one
  launch per ring (``ops/knn_ring.py``, kernel K6) that folds candidates
  into a running top-(k+1), the march's rows in lattice order.
  Iteration control stays on the host
  (:class:`IterativeTransformer`), one scalar per ring.  Right points
  near a face corner go to a host residual set; after convergence a row
  whose kth distance reaches another face merges that face's exact top-k
  on the host, and f32 ties at the rank boundary re-rank in f64.

Non-H3 grids take the exact blocked host path; geometry rows run the
reference's ring join on the host with exact ``pairwise_geometry_distance``
(or a bounded all-pairs pass for small right sides).

The engine of a point workload: the ``mosaic.knn.strategy`` pin, else the
cost planner's ``decide_knn`` (``sql/planner.py``: learned brute and ring
costs within its memory guard, else brute for ``0 < m <=
brute_right_max``), else, with the planner off, that rule alone;
``brute_right_max=0`` forces the ring.  Both engines give the same answer.

Over a ``torch.distributed`` process group (``group=``, the JAX
package's ``mesh``/``axis``) a point workload always takes the ring: the
left rows and their running top-k split into row blocks over the ranks,
the right side's windows replicate on every rank's device, each rank's
ring step is K6 on its own rows, and one ``all_reduce`` of the rows not
yet done per ring keeps every rank marching the same rings.  The exact
host passes then run on each rank's own rows, and the ids and distances
are gathered.  A checkpoint with a group of more than one rank is left
out: each rank's state is its own block.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..config import default_config
from ..core.geometry.array import GeometryArray, GeometryType
from ..core.geometry.measures import pairwise_geometry_distance
from ..core.geometry.padded import points_block_np
from ..core.index.base import IndexSystem
from ..core.index.h3.constants import face_center_xyz
from ..core.index.h3.hexmath import geo_to_xyz
from ..core.index.h3.system import H3IndexSystem
from ..core.tessellate import tessellate
from ..ops.knn_brute import brute_topk
from ..ops.knn_ring import lattice_order, ring_step
from ..parallel import collectives as coll
from ..parallel.pip_join import _host_lattice
from ..perf.pipeline import chunk_rows, stream
from ..sql.planner import Decision, planner
from .core import IterationState, IterativeTransformer

#: f32 tie band (degrees) at the k-th rank boundary
EPS_RANK_DEG = 1e-5
#: left rows per brute block (one K5 launch each)
BRUTE_BLOCK = 8192


def _face_and_corner(xy: np.ndarray, corner_gap: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(nearest face, near-corner flag) per (lon, lat) degree row.

    ``corner_gap`` is the face-dot gap marking the corner band where
    lattice ring adjacency is unreliable (pentagon wedge distortion);
    the caller scales it with the cell size so the residual set stays
    ~3 cells wide at any resolution."""
    xyz = geo_to_xyz(np.radians(np.asarray(xy, np.float64)[:, ::-1]))
    dots = xyz @ face_center_xyz().T
    face = np.argmax(dots, axis=1)
    srt = np.sort(dots, axis=1)
    corner = (srt[:, -1] - srt[:, -2]) < corner_gap
    return face, corner


@dataclasses.dataclass
class FusedKNNIndex:
    """All-face dense lattice windows fused into ONE device index.

    Per-face windows concatenate: ``entry`` holds every face's W*H
    window back to back (values are global pool slots or -1), and each
    left row carries its own (a0, b0, W, H, entry offset, origin) so one
    kernel serves every face.  Pool coordinates are face-origin-local
    f32 (global-extent coords in raw f32 would cost ~1e-5 deg of
    quantization at lon 180)."""

    entry: torch.Tensor              # [sum W*H] i32 global slot or -1
    pool_xy: torch.Tensor            # [Ctot, cap, 2] f32 face-local
    pool_rowid: np.ndarray           # [Ctot, cap] i32 global right row
    face_params: Dict[int, tuple]    # face -> (a0, b0, W, H, eoff,
                                     #          origin [2] f64)
    res: int
    cap: int
    inr_deg: float
    circ_deg: float
    n_right: int


def build_knn_indexes(right_xy: np.ndarray, res: int, grid,
                      device: DeviceLike = None):
    """Fused per-face windows on ``device`` (CUDA unless the caller passes
    ``"cpu"``) + host residual (near-corner) rows.

    Returns (FusedKNNIndex or None, rowmap {face: global right rows},
    residual global right-row ids)."""
    if not isinstance(grid, H3IndexSystem):
        raise ValueError("build_knn_indexes: the lattice windows are H3's")
    dev = resolve_device(device)
    right_xy = np.asarray(right_xy, np.float64)
    face, a, b = _host_lattice(right_xy, res)
    # corner band ~3 cells at this res: dot-gap changes at ~0.71/rad
    # near a face boundary, so gap = 3 * circ(rad) * 0.71
    _, circ0 = grid._cell_metrics_deg(res)
    corner_gap = max(2.2 * np.radians(circ0), 1e-5)
    nface, corner = _face_and_corner(right_xy, corner_gap)
    # a point whose quantized lattice face differs from its nearest
    # face sits in the projection overlap band: treat as residual
    corner |= face != nface
    rowmap: Dict[int, np.ndarray] = {}
    entries, pools, rowids, params = [], [], [], {}
    eoff = 0
    cap = 1
    # first pass: per-face bucketing (host)
    per_face = []
    for f in np.unique(face[~corner]):
        rows = np.nonzero((face == f) & ~corner)[0]
        rowmap[int(f)] = rows
        af, bf = a[rows], b[rows]
        a0, b0 = int(af.min()) - 1, int(bf.min()) - 1
        W = int(af.max()) - a0 + 2
        H = int(bf.max()) - b0 + 2
        if W * H > 64_000_000:
            raise ValueError(f"right-side window too large: {W}x{H}")
        lin = (af - a0) * H + (bf - b0)
        order = np.argsort(lin, kind="stable")
        lin_s = lin[order]
        ucells, start, count = np.unique(lin_s, return_index=True,
                                         return_counts=True)
        cap = max(cap, int(count.max()))
        per_face.append((int(f), rows, a0, b0, W, H, order, lin_s,
                         ucells, start, count))
    if not per_face:
        return None, rowmap, np.nonzero(corner)[0]
    slot_base = 0
    for (f, rows, a0, b0, W, H, order, lin_s, ucells, start,
         count) in per_face:
        C = len(ucells)
        origin = np.round(np.array([right_xy[rows, 0].mean(),
                                    right_xy[rows, 1].mean()]), 1)
        rid = np.full((C, cap), -1, np.int32)
        pxy = np.full((C, cap, 2), 1e9, np.float32)
        slot_of = np.repeat(np.arange(C), count)
        pos = np.arange(len(lin_s)) - np.repeat(start, count)
        rid[slot_of, pos] = rows[order].astype(np.int32)
        pxy[slot_of, pos] = (right_xy[rows[order]] -
                             origin[None]).astype(np.float32)
        ent = np.full(W * H, -1, np.int32)
        ent[ucells] = slot_base + np.arange(C, dtype=np.int32)
        entries.append(ent)
        pools.append(pxy)
        rowids.append(rid)
        params[f] = (a0, b0, W, H, eoff, origin)
        eoff += W * H
        slot_base += C
    inr, circ = grid._cell_metrics_deg(res)
    idx = FusedKNNIndex(
        entry=torch.from_numpy(np.concatenate(entries)).to(dev),
        pool_xy=torch.from_numpy(np.concatenate(pools)).to(dev),
        pool_rowid=np.concatenate(rowids),
        face_params=params, res=res, cap=cap, inr_deg=float(inr),
        circ_deg=float(circ), n_right=len(right_xy))
    return idx, rowmap, np.nonzero(corner)[0]


def knn_index_from_arrays(tables: dict, device: DeviceLike = None
                          ) -> FusedKNNIndex:
    """A FusedKNNIndex from host arrays: ``entry``, ``pool_xy``,
    ``pool_rowid`` (numpy), ``face_params`` {face: (a0, b0, W, H, eoff,
    origin)} and the statics ``res cap inr_deg circ_deg n_right``.  It
    carries an index built elsewhere — for instance by the JAX package —
    onto ``device`` unchanged."""
    dev = resolve_device(device)
    return FusedKNNIndex(
        entry=torch.from_numpy(np.array(tables["entry"], np.int32)).to(dev),
        pool_xy=torch.from_numpy(np.array(tables["pool_xy"],
                                          np.float32)).to(dev),
        pool_rowid=np.array(tables["pool_rowid"], np.int32),
        face_params={int(f): (int(a0), int(b0), int(W), int(H), int(eoff),
                              np.array(origin, np.float64))
                     for f, (a0, b0, W, H, eoff, origin)
                     in tables["face_params"].items()},
        res=int(tables["res"]), cap=int(tables["cap"]),
        inr_deg=float(tables["inr_deg"]), circ_deg=float(tables["circ_deg"]),
        n_right=int(tables["n_right"]))


def ring_rows(idx: FusedKNNIndex, left_xy: np.ndarray, device: DeviceLike
              ) -> Tuple[tuple, torch.Tensor, np.ndarray, np.ndarray]:
    """The ring step's per-row inputs for the left points: (rows, order,
    face, no_window).

    ``rows`` are ``(pts, al, bl, a0r, b0r, wr, hr, eoffr)`` on ``device``
    (face-origin-local f32 points, lattice coordinates and face window)
    in lattice order (:func:`lattice_order`): row i of them is left row
    ``order[i]``.  The march holds its rows, and so its lists and
    checkpoints, in that order, where the ring kernel's neighbouring
    threads share their ring cells and read and write their rows
    coalesced.  ``face`` [N] is each left row's face and ``no_window`` [N]
    marks rows whose face has no window: they scan a degenerate empty
    window, and the host pass takes them."""
    dev = resolve_device(device)
    n = len(left_xy)
    face, al, bl = _host_lattice(left_xy, idx.res)
    cols = np.zeros((5, n), np.int32)            # a0, b0, W, H, eoff
    pts_local = np.zeros((n, 2), np.float32)
    no_window = np.ones(n, bool)
    for f, (a0, b0, W, H, eoff, origin) in idx.face_params.items():
        sel = face == f
        no_window[sel] = False
        cols[:, sel] = np.array([a0, b0, W, H, eoff], np.int32)[:, None]
        pts_local[sel] = (left_xy[sel] - origin[None]).astype(np.float32)
    rows = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (pts_local, al.astype(np.int32), bl.astype(np.int32), *cols)]
    order = lattice_order(rows[1], rows[2], rows[3], rows[4], rows[7])
    return tuple(r[order] for r in rows), order, face, no_window


def _ring_offsets(d: int) -> np.ndarray:
    """Axial (da, db) offsets of the hex ring at grid distance d
    (6d cells; d=0 -> the center)."""
    if d == 0:
        return np.zeros((1, 2), np.int32)
    dirs = np.array([(1, 0), (1, 1), (0, 1), (-1, 0), (-1, -1), (0, -1)],
                    np.int32)
    out = []
    pos = np.array([d, 0], np.int32)      # start at direction 0 * d
    for side in range(6):
        step = dirs[(side + 2) % 6]
        for _ in range(d):
            out.append(pos.copy())
            pos = pos + step
    return np.stack(out)


def _brute_topk_blocked(left_xy: np.ndarray, right_xy: np.ndarray,
                        k: int, threshold: Optional[float],
                        block: int = 20_000):
    """Exact f64 top-k in row blocks (memory-bounded host oracle).
    Returns (ids [N, k] (-1 pad), d2 [N, k] (inf pad))."""
    left_xy = np.asarray(left_xy, np.float64)
    right_xy = np.asarray(right_xy, np.float64)
    n = len(left_xy)
    kk = min(k, len(right_xy))
    ids = np.full((n, k), -1, np.int64)
    d2o = np.full((n, k), np.inf)
    if kk == 0:
        return ids, d2o
    for s in range(0, n, block):
        e = min(s + block, n)
        diff = left_xy[s:e, None, :] - right_xy[None]
        d2 = np.sum(diff * diff, axis=-1)
        if threshold is not None:
            d2 = np.where(d2 > threshold ** 2, np.inf, d2)
        # stable: equal distances order by right id — the tie contract
        # every engine (ring, brute-device, this oracle) shares
        order = np.argsort(d2, axis=1, kind="stable")[:, :kk]
        dd = np.take_along_axis(d2, order, axis=1)
        ids[s:e, :kk] = np.where(np.isfinite(dd), order, -1)
        d2o[s:e, :kk] = dd
    return ids, d2o


def _merge_topk(top_d2, rid, d2_more, ids_more, k1: int):
    """The k1 smallest of two (d2, id) lists per row, stable: the first
    list's entries ahead of the second's on equal f32 distances."""
    all_d2 = np.concatenate([top_d2, d2_more.astype(np.float32)], axis=1)
    all_id = np.concatenate([rid, ids_more], axis=1)
    order = np.argsort(all_d2, axis=1, kind="stable")
    return (np.take_along_axis(all_d2, order, axis=1)[:, :k1],
            np.take_along_axis(all_id, order, axis=1)[:, :k1])


class SpatialKNN(IterativeTransformer):
    """k-nearest-neighbour transformer over grid rings.

    Parameters mirror the reference (SpatialKNNParams.scala): k
    neighbours, index resolution, max iterations (ring radius cap),
    optional distance threshold (planar CRS-unit cap).  The reference's
    ``approximate`` switch is not ported: adjacent f32 ties are always
    re-ranked in f64.  ``transform(left, right)`` accepts
    point coordinate arrays or GeometryArrays (geometry rows use exact
    st_distance semantics) and returns a dict of columnar matches.
    Device state lives on ``device``: CUDA unless the caller passes
    ``"cpu"``, where the kernels' plain versions run.  ``group`` is an
    optional ``torch.distributed`` process group over which every rank
    calls ``transform`` with the same inputs and gets the whole result.
    """

    def __init__(self, grid: IndexSystem, k: int = 5,
                 index_resolution: int = 7, max_iterations: int = 16,
                 distance_threshold: Optional[float] = None,
                 checkpoint=None,
                 brute_right_max: int = 32768, device: DeviceLike = None,
                 group=None):
        super().__init__(max_iterations=max_iterations,
                         checkpoint=checkpoint)
        #: right-side size up to which the device brute-force path is
        #: used instead of ring marching.  0 disables.
        self.brute_right_max = int(brute_right_max)
        self.grid = grid
        self.k = int(k)
        self.res = int(index_resolution)
        self.distance_threshold = distance_threshold
        self.device = resolve_device(device)
        #: optional ``torch.distributed`` process group: the left rows
        #: (and the running top-k) split over its ranks, the right-side
        #: windows replicate (broadcast regime, as the PIP join's)
        self.group = group
        if checkpoint is not None and coll.group_size(group) > 1:
            raise NotImplementedError(
                "a checkpoint of the ring march over more than one rank "
                "is not ported; pass checkpoint=None or group=None")
        self._idx: Optional[FusedKNNIndex] = None
        self._rowmap: Dict[int, np.ndarray] = {}
        #: the planner's engine decision of the last point transform
        self._last_decision: Optional[Decision] = None

    # ------------------------------------- IterativeTransformer protocol
    def initial_state(self, left_xy, right_xy) -> IterationState:
        n = len(left_xy)
        return IterationState(iteration=0, payload={
            "top_d2": torch.full((n, self.k + 1), torch.inf,
                                 dtype=torch.float32, device=self.device),
            "top_code": torch.full((n, self.k + 1), -1, dtype=torch.int32,
                                   device=self.device),
        })

    def _sep_floor(self, d: int) -> float:
        """Lower bound (planar degrees) on the distance from a left
        point to any point in a cell at grid distance >= d+1, after
        rings 0..d have been scanned.

        Hex centers at grid distance g are >= g*sqrt(3)*inr apart (the
        lattice's worst 'staircase' direction — NOT g*2*inr, which only
        holds along the axes); subtract both cells' circumradii for
        point-to-point."""
        idx = self._idx
        g = d + 1
        return max(0.0, np.sqrt(3.0) * g * idx.inr_deg
                   - 2.0 * idx.circ_deg)

    def _thr2(self) -> float:
        """The ring step's f32 squared threshold (inf for none)."""
        if self.distance_threshold is None:
            return float(np.float32(np.inf))
        return float(np.float32(self.distance_threshold) ** 2)

    def step(self, state: IterationState) -> IterationState:
        idx = self._idx
        d = state.iteration                    # ring at grid distance d
        offs = _ring_offsets(d)
        pad = 1
        while pad < len(offs):
            pad *= 2
        omask = np.zeros(pad, bool)
        omask[:len(offs)] = True
        offs_p = np.zeros((pad, 2), np.int32)
        offs_p[:len(offs)] = offs
        # a resumed checkpoint hands back host arrays
        top_d2, top_code = (torch.as_tensor(state.payload[key],
                                            device=self.device)
                            for key in ("top_d2", "top_code"))
        if len(self._pts):
            top_d2, top_code = ring_step(
                idx.entry, idx.pool_xy, self._pts, self._al, self._bl,
                self._a0r, self._b0r, self._wr, self._hr, self._eoffr,
                top_d2, top_code, torch.from_numpy(offs_p).to(self.device),
                torch.from_numpy(omask).to(self.device), idx.cap,
                self._thr2())
        # convergence: every kth distance within the separation floor
        # (no unvisited cell can hold a closer point).  Only the scalar
        # decision crosses to host — the top-k state stays device-side
        # between rings; over a group the count is summed, so every rank
        # stops at the same ring.
        sep = self._sep_floor(d)
        if self.distance_threshold is not None and \
                sep >= self.distance_threshold:
            not_done = 0
        else:
            kth = top_d2[:, self.k - 1]
            not_done = int(coll.all_reduce(
                (~(kth <= float(np.float32(sep) ** 2))).sum(), self.group))
        return IterationState(
            iteration=d, converged=not_done == 0,
            payload={"top_d2": top_d2, "top_code": top_code},
            metrics={"ring": d, "not_done": not_done})

    # --------------------------------------------------------- transform
    def transform(self, left, right):
        def as_points(x):
            if isinstance(x, GeometryArray):
                if len(x) and np.all(x.types == GeometryType.POINT):
                    return points_block_np(x, dtype=np.float64)
                return None
            return np.asarray(x, np.float64)

        lp = as_points(left)
        rp = as_points(right)
        if lp is None or rp is None:
            return self._transform_geoms(left, right)
        if not isinstance(self.grid, H3IndexSystem):
            # non-H3 grids: the dense lattice window is H3-frame math;
            # exact blocked host path
            ids, d2 = _brute_topk_blocked(lp, rp, self.k,
                                          self.distance_threshold)
            return self._result(lp, rp, ids, d2, iterations=0,
                                rechecked=len(lp))
        # timed so the planner's knn/brute and knn/ring coefficients
        # learn from every run
        t0 = time.perf_counter()
        out = self._transform_points(lp, rp)
        d = self._last_decision
        if d is not None:
            planner.observe_decision(d, time.perf_counter() - t0)
        return out

    def _points_strategy(self, n: int, m: int
                         ) -> Tuple[str, Optional[Decision]]:
        """(engine, the planner's decision or None) for an n-left x
        m-right point workload.  Both engines are exact (same f64
        re-rank, ties by right id), so this is purely a speed choice:
        the ``mosaic.knn.strategy`` pin wins (a positive integer there
        replaces ``brute_right_max``), then the planner's ``decide_knn``,
        then the built-in right-side threshold.  ``brute_right_max=0``
        forces the ring over the planner's pick, and so does a group:
        its rows and lists shard, the brute pass is one device's."""
        if self.group is not None or m == 0:
            return "ring", None
        threshold = self.brute_right_max
        conf = default_config().knn_strategy
        if conf not in ("auto", "brute", "ring"):
            threshold = int(conf)       # numeric conf: new threshold
            conf = "auto"
        if conf != "auto":
            d = None
            if planner.enabled:
                d = planner.record_decision(Decision(
                    "knn", conf, "forced by mosaic.knn.strategy", n,
                    cost_key=f"knn/{conf}", key_n=n, forced=True))
            return conf, d
        if planner.enabled:
            d = planner.decide_knn(n, m, threshold)
            if threshold <= 0 and d.strategy == "brute":
                d.strategy = "ring"
                d.reason = "brute_right_max=0 forces the ring"
                d.cost_key = "knn/ring"
                d.forced = True
            return d.strategy, d
        return ("brute" if 0 < m <= threshold else "ring"), None

    def _brute_device_topk(self, left_xy: np.ndarray,
                           right_xy: np.ndarray):
        """Exact top-k by an all-pairs device pass (right side small).

        f32 distances on block-centered coordinates pick k+8 candidates
        per row (one K5 launch per block); the candidates re-rank in f64
        on the host (ties broken by right id, matching the host oracle)
        while the next block runs.  Rows where the f64 kth distance
        cannot be PROVEN inside the f32 candidate horizon (f32 error
        bound on centered coords) fall back to the exact host path."""
        k = self.k
        n = len(left_xy)
        m = len(right_xy)
        kk = min(k, m)
        kc = min(k + 8, m)
        # spatially coherent blocks keep the per-block centering tight
        order = np.lexsort((left_xy[:, 0],
                            np.round(left_xy[:, 1] / 4.0)))
        lx = left_xy[order]
        chunks = chunk_rows(n, BRUTE_BLOCK)
        centers = [lx[sl].mean(axis=0) for sl in chunks]
        right_dev = torch.from_numpy(right_xy).to(self.device)
        ids = np.empty((n, kc), np.int64)
        d2s = np.empty((n, kc), np.float64)
        flagged = np.zeros(n, bool)

        def stage(sl, out):
            out[...] = lx[sl] - centers[sl.start // BRUTE_BLOCK][None]

        def consume(i, sl, host):
            # the f64 re-rank of block i overlaps the device pass on
            # block i+1
            d2b, idxb = host
            lb = lx[sl]
            rows = order[sl]
            lc = (lb - centers[i]).astype(np.float32)
            rc = (right_xy - centers[i]).astype(np.float32)
            cand = idxb.astype(np.int64)
            c32 = d2b[:, -1].astype(np.float64)
            # worst-case f32 d2 error on centered coords: per axis
            # |2*dx*ddx| with |dx| <= 2S, ddx <= eps*S, plus squaring
            # and the add — ~24 eps S^2 total; 32 keeps margin
            S2 = max(float(np.max(np.abs(lc))),
                     float(np.max(np.abs(rc)))) ** 2
            err = 32.0 * np.finfo(np.float32).eps * max(S2, 1e-30)
            # f64 re-rank of this block's candidates, ties by right id
            diff = lb[:, None, :] - right_xy[cand]
            d2c = np.sum(diff * diff, axis=-1)
            rorder = np.lexsort((cand, d2c), axis=1)
            d2s[rows] = np.take_along_axis(d2c, rorder, axis=1)
            ids[rows] = np.take_along_axis(cand, rorder, axis=1)
            # provable completeness: the true kth must sit strictly
            # inside the f32 candidate horizon
            if kc < m:
                flagged[rows] = d2s[rows, kk - 1] >= c32 - err

        stream(chunks, stage, 2,
               lambda i, x: brute_topk(x, right_dev, centers[i], kc),
               consume, self.device)
        sel = np.nonzero(flagged)[0]
        if len(sel):
            ids_h, d2_h = _brute_topk_blocked(
                left_xy[sel], right_xy, k, self.distance_threshold)
            ids[sel, :kk] = ids_h[:, :kk]
            d2s[sel, :kk] = d2_h[:, :kk]
        if kc < k:                    # fewer right rows than k
            ids = np.pad(ids, ((0, 0), (0, k - kc)),
                         constant_values=-1)
            d2s = np.pad(d2s, ((0, 0), (0, k - kc)),
                         constant_values=np.inf)
        ids = ids[:, :k].copy()
        d2 = d2s[:, :k].copy()
        if self.distance_threshold is not None:
            over = d2 > self.distance_threshold ** 2
            ids[over] = -1
            d2[over] = np.inf
        if kk < k:
            ids[:, kk:] = -1
            d2[:, kk:] = np.inf
        return self._result(left_xy, right_xy, ids, d2, iterations=0,
                            rechecked=int(flagged.sum()))

    def _transform_points(self, left_xy: np.ndarray,
                          right_xy: np.ndarray):
        left_xy = np.asarray(left_xy, np.float64)
        right_xy = np.asarray(right_xy, np.float64)
        k = self.k
        n = len(left_xy)
        strategy, self._last_decision = self._points_strategy(
            n, len(right_xy))
        if strategy == "brute":
            return self._brute_device_topk(left_xy, right_xy)
        self._idx, self._rowmap, residual = build_knn_indexes(
            right_xy, self.res, self.grid, device=self.device)
        if self._idx is None:
            # every right point is residual (tiny/corner set)
            ids, d2 = _brute_topk_blocked(left_xy, right_xy, k,
                                          self.distance_threshold)
            return self._result(left_xy, right_xy, ids, d2,
                                iterations=0, rechecked=n)
        D, r = coll.group_size(self.group), coll.group_rank(self.group)
        if D == 1:
            rid, d2, d, rechecked = self._ring_march(left_xy, right_xy,
                                                     residual)
            return self._result(left_xy, right_xy, rid, d2, iterations=d,
                                rechecked=rechecked)
        # each rank marches and rechecks its own block of rows; the
        # blocks, padded to one length, are gathered in rank order
        blk = coll.row_block(n, D, r)
        per = -(-n // D)
        rid, d2, d, rechecked = self._ring_march(left_xy[blk], right_xy,
                                                 residual)
        pad = ((0, per - len(rid)), (0, 0))
        rid = coll.all_gather(torch.from_numpy(np.pad(
            rid, pad, constant_values=-1)).to(self.device), self.group)
        d2 = coll.all_gather(torch.from_numpy(np.pad(
            d2, pad, constant_values=np.inf)).to(self.device), self.group)
        rechecked = coll.all_reduce(torch.tensor(
            rechecked, dtype=torch.int64, device=self.device), self.group)
        return self._result(left_xy, right_xy, rid[:n].cpu().numpy(),
                            d2[:n].cpu().numpy(), iterations=d,
                            rechecked=int(rechecked))

    def _ring_march(self, left_xy: np.ndarray, right_xy: np.ndarray,
                    residual: np.ndarray):
        """The ring march over ``left_xy`` and the exact host passes on
        its rows: (ids [n, k], d2 [n, k] f64, iterations, rechecked)."""
        k = self.k
        n = len(left_xy)
        idx = self._idx
        rows, order, face, no_window = ring_rows(idx, left_xy, self.device)
        (self._pts, self._al, self._bl, self._a0r, self._b0r, self._wr,
         self._hr, self._eoffr) = rows

        state = self.iterative_transform(left_xy, right_xy)
        back = order.cpu().numpy()
        top_d2 = np.empty((n, k + 1), np.float32)
        top_code = np.empty((n, k + 1), np.int32)
        for out, v in ((top_d2, state.payload["top_d2"]),
                       (top_code, state.payload["top_code"])):
            out[back] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        d = state.iteration
        rid = np.where(top_code >= 0,
                       idx.pool_rowid.reshape(-1)[
                           np.maximum(top_code, 0)],
                       -1).astype(np.int64)
        if len(residual):
            # near-corner right rows live outside every window: fold
            # their exact top-k into the device result (they are never
            # in a pool, so no duplicate ids can appear)
            ids_r, d2_r = _brute_topk_blocked(
                left_xy, right_xy[residual], k,
                self.distance_threshold)
            ids_r = np.where(ids_r >= 0, residual[np.maximum(ids_r, 0)],
                             -1)
            top_d2, rid = _merge_topk(top_d2, rid, d2_r, ids_r, k + 1)
        # the iteration loop bumps iteration after the last step, so rings
        # 0..d-1 were scanned; the floor must use the LAST ring
        sep_f = self._sep_floor(d - 1)
        unconverged = ~(top_d2[:, k - 1] <= np.float32(sep_f) ** 2)
        if self.distance_threshold is not None:
            unconverged &= ~(sep_f >= self.distance_threshold)

        # ---- cross-face / residual exposure (global-extent
        # exactness): the planar metric is global but each window only
        # covers its face, so a row whose kth distance reaches into
        # another face's region must merge that face's points on the
        # host.  Rows with no same-face window are always flagged.
        with np.errstate(invalid="ignore"):
            kth = np.sqrt(np.maximum(top_d2[:, k - 1], 0))
        kth = np.where(np.isfinite(kth), kth.astype(np.float64),
                       np.inf)
        flagged = no_window | unconverged

        # a row is safe from face f2's points when its kth planar
        # distance cannot reach f2's Voronoi region.  Angular distance
        # (degrees) lower-bounds planar lon/lat distance (the angular
        # metric dθ² = dlat² + cos²lat dlon² is pointwise ≤ the planar
        # dlat² + dlon²), and the angular distance from x to f2's region
        # is ≥ asin(-x·n̂) for the boundary plane normal n = f2_center -
        # own_center.  Exposed rows merge an exact top-k against ONLY the
        # exposed face's points (disjoint from the own-face pool).
        fc = face_center_xyz()
        xv = geo_to_xyz(np.radians(left_xy[:, ::-1]))
        dots = xv @ fc.T                              # [n, 20]
        own_dot = dots[np.arange(n), face]
        pair_len = np.linalg.norm(fc[:, None] - fc[None], axis=-1)
        kth_buf = kth * (1 + 1e-6) + EPS_RANK_DEG
        n_merged = 0
        for f2, rows2 in self._rowmap.items():
            num = own_dot - dots[:, f2]
            denom = pair_len[face, f2]
            bound = np.degrees(np.arcsin(
                np.clip(num / np.maximum(denom, 1e-12), 0.0, 1.0)))
            exp_rows = np.nonzero((bound < kth_buf) & (face != f2) &
                                  ~flagged)[0]
            if not len(exp_rows):
                continue
            n_merged += len(exp_rows)
            ids_f, d2_f = _brute_topk_blocked(
                left_xy[exp_rows], right_xy[rows2], k,
                self.distance_threshold)
            ids_f = np.where(ids_f >= 0, rows2[np.maximum(ids_f, 0)],
                             -1)
            top_d2[exp_rows], rid[exp_rows] = _merge_topk(
                top_d2[exp_rows], rid[exp_rows], d2_f, ids_f, k + 1)

        # adjacent f32 ties anywhere in the top k+1 (compared in sqrt
        # scale — the d2 gap of a distance gap eps is ~2*d*eps, so an
        # absolute d2 tolerance has no fixed meaning)
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(top_d2, 0))
            tie = (sq[:, 1:] - sq[:, :-1]) < EPS_RANK_DEG
            flagged = flagged | (np.isfinite(sq[:, :-1]) & tie).any(axis=1)
        sel = np.nonzero(flagged)[0]
        if len(sel):
            ids_h, d2_h = _brute_topk_blocked(
                left_xy[sel], right_xy, k, self.distance_threshold)
            rid[sel, :k] = ids_h
            top_d2[sel, :k] = d2_h.astype(np.float32)
            rid[sel, k:] = -1
            top_d2[sel, k:] = np.inf
        return (rid[:, :k], top_d2[:, :k].astype(np.float64), d,
                int(flagged.sum()) + n_merged)

    def _result(self, left_xy, right_xy, rid, d2, iterations: int,
                rechecked: int):
        n, k = rid.shape
        # exact f64 distances for the selected pairs
        safe = np.maximum(rid, 0)
        diff = np.asarray(left_xy)[:, None, :] - \
            np.asarray(right_xy)[safe]
        dist = np.sqrt(np.sum(diff * diff, axis=-1))
        dist = np.where(rid >= 0, dist, np.nan)
        return {
            "left_id": np.repeat(np.arange(n), k).reshape(n, k),
            "right_id": rid,
            "distance": dist,
            "rank": np.broadcast_to(np.arange(k), (n, k)).copy(),
            "iterations": iterations,
            "rechecked": rechecked,
        }

    # -------------------------------------------------- geometry rows
    def _geoms_pruned_topk(self, left, right):
        """Batched geometry KNN for small right sides: three vectorized
        passes.

        Bounds sandwich st_distance: bbox separation is a LOWER bound,
        the distance between one representative vertex of each
        geometry (vertices lie ON the geometry) an UPPER bound.  A row
        keeps exactly the candidates whose lower bound does not exceed
        its kth-smallest upper bound — any geometry pruned by that
        test provably cannot enter the top k — and ONE batched exact
        st_distance call over the surviving ragged pairs settles
        ranks, ties by right id."""
        k = self.k
        n, m = len(left), len(right)
        if n == 0:
            z = np.zeros((0, k))
            return {"left_id": z.astype(np.int64),
                    "right_id": z.astype(np.int64) - 1,
                    "distance": np.full((0, k), np.nan),
                    "rank": z.astype(np.int64),
                    "iterations": 0, "rechecked": 0}
        kk = min(k, m)
        lb_box = np.asarray(left.bboxes(), np.float64)
        rb_box = np.asarray(right.bboxes(), np.float64)

        def rep_vertex(arr):
            """One on-geometry vertex per row; empty rows -> +inf (an
            empty geometry can neither anchor an upper bound nor be a
            neighbour)."""
            starts = np.asarray(arr.vertex_starts())
            empty = starts[:-1] >= starts[1:]
            if len(arr.coords) == 0:
                # every row empty: no vertex to anchor on; all-inf reps
                # keep the all -1 / NaN output contract
                return np.full((len(starts) - 1, 2), np.inf)
            safe = np.minimum(starts[:-1],
                              max(len(arr.coords) - 1, 0))
            v = np.asarray(arr.coords, np.float64)[safe, :2].copy()
            v[empty] = np.inf
            return v
        lv = rep_vertex(left)
        rv = rep_vertex(right)
        pair_l: list = []
        pair_r: list = []
        B = max(1, (1 << 22) // max(m, 1))
        with np.errstate(invalid="ignore"):
            for s in range(0, n, B):
                e = min(s + B, n)
                gap = _bbox_gap(lb_box[s:e], rb_box)       # [b, m] LB
                dv = np.hypot(lv[s:e, None, 0] - rv[None, :, 0],
                              lv[s:e, None, 1] - rv[None, :, 1])
                tau = np.partition(dv, kk - 1, axis=1)[:, kk - 1]
                if self.distance_threshold is not None:
                    tau = np.minimum(tau, self.distance_threshold)
                # empty rows on either side: NaN bbox gaps compare
                # False and inf rep-vertices push dv to inf, so empty
                # candidates never survive; empty LEFT rows keep no
                # candidates at all and come out as -1 rows
                keep = gap <= tau[:, None] * (1 + 1e-12)
                li, rj = np.nonzero(keep)
                pair_l.append(li + s)
                pair_r.append(rj)
        pl = np.concatenate(pair_l) if pair_l else \
            np.zeros(0, np.int64)
        pr = np.concatenate(pair_r) if pair_r else \
            np.zeros(0, np.int64)
        dist = np.asarray(pairwise_geometry_distance(
            left.take(pl), right.take(pr)), np.float64)
        if self.distance_threshold is not None:
            ok = dist <= self.distance_threshold
            pl, pr, dist = pl[ok], pr[ok], dist[ok]
        # per-row top-k on the ragged pair list: sort by (row, d, rid)
        order = np.lexsort((pr, dist, pl))
        pl, pr, dist = pl[order], pr[order], dist[order]
        starts = np.searchsorted(pl, np.arange(n + 1))
        rid = np.full((n, k), -1, np.int64)
        dout = np.full((n, k), np.nan)
        rank_in_row = np.arange(len(pl)) - starts[pl]
        sel = rank_in_row < k
        rid[pl[sel], rank_in_row[sel]] = pr[sel]
        dout[pl[sel], rank_in_row[sel]] = dist[sel]
        return {
            "left_id": np.repeat(np.arange(n), k).reshape(n, k),
            "right_id": rid,
            "distance": dout,
            "rank": np.broadcast_to(np.arange(k), (n, k)).copy(),
            "iterations": 0,
            "rechecked": 0,
        }

    def _transform_geoms(self, left, right):
        """Geometry-capable KNN: the reference's ring-join algorithm
        (GridRingNeighbours.scala:76-99) with exact st_distance.

        Left/right tessellation cells anchor the rings; candidates are
        right geometries sharing a ring cell; exact distances via
        measures.pairwise_geometry_distance; a left row stops when its
        kth exact distance is inside the ring separation floor."""
        if not (isinstance(left, GeometryArray) and
                isinstance(right, GeometryArray)):
            raise TypeError("SpatialKNN: geometry rows need GeometryArrays "
                            "on both sides")
        k = self.k
        n = len(left)
        if 0 < len(right) <= self.brute_right_max:
            return self._geoms_pruned_topk(left, right)
        grid = self.grid
        chips_l = tessellate(left, self.res, grid,
                             keep_core_geom=False, device=self.device)
        chips_r = tessellate(right, self.res, grid,
                             keep_core_geom=False, device=self.device)
        # sorted cell -> right geom table
        rc = chips_r.cell_id.astype(np.int64)
        rg = chips_r.geom_id.astype(np.int64)
        order = np.argsort(rc, kind="stable")
        rc, rg = rc[order], rg[order]
        inr, circ = grid._cell_metrics_deg(self.res) \
            if hasattr(grid, "_cell_metrics_deg") else (None, None)

        frontier = [np.unique(chips_l.cell_id[chips_l.geom_id == i])
                    for i in range(n)]
        visited = [set(fr.tolist()) for fr in frontier]
        cand: list = [set() for _ in range(n)]
        top: list = [[] for _ in range(n)]      # (dist, rid) sorted
        active = np.ones(n, bool)
        d = 0
        while active.any() and d < self.max_iterations:
            # candidates on this ring's cells
            pair_l, pair_r = [], []
            for i in np.nonzero(active)[0]:
                cells = frontier[i]
                if len(cells) == 0:
                    continue
                lo = np.searchsorted(rc, cells)
                hi = np.searchsorted(rc, cells, side="right")
                new = set()
                for s, e in zip(lo, hi):
                    new.update(rg[s:e].tolist())
                new -= cand[i]
                cand[i].update(new)
                for j in new:
                    pair_l.append(i)
                    pair_r.append(j)
            if pair_l:
                dl = pairwise_geometry_distance(
                    left.take(np.asarray(pair_l)),
                    right.take(np.asarray(pair_r)))
                for p in range(len(pair_l)):
                    dd = float(dl[p])
                    if self.distance_threshold is not None and \
                            dd > self.distance_threshold:
                        continue
                    top[pair_l[p]].append((dd, pair_r[p]))
            # convergence per row: kth distance within separation floor
            if inr is not None:
                sep = max(0.0, np.sqrt(3.0) * (d + 1) * inr - 2 * circ)
            else:
                sep = 0.0
            for i in np.nonzero(active)[0]:
                top[i].sort()
                del top[i][k:]
                full = len(top[i]) >= min(k, len(right))
                if full and (len(top[i]) == 0 or
                             top[i][-1][0] <= sep):
                    active[i] = False
                elif self.distance_threshold is not None and \
                        sep >= self.distance_threshold and full:
                    active[i] = False
            # expand frontier one ring
            d += 1
            for i in np.nonzero(active)[0]:
                if len(frontier[i]) == 0:
                    continue
                ring = grid.k_ring(frontier[i], 1)
                nxt = np.unique(ring[ring >= 0])
                nxt = np.array([c for c in nxt.tolist()
                                if c not in visited[i]], np.int64)
                visited[i].update(nxt.tolist())
                frontier[i] = nxt
        rid = np.full((n, k), -1, np.int64)
        dist = np.full((n, k), np.nan)
        for i in range(n):
            for r, (dd, j) in enumerate(top[i][:k]):
                rid[i, r] = j
                dist[i, r] = dd
        return {
            "left_id": np.repeat(np.arange(n), k).reshape(n, k),
            "right_id": rid,
            "distance": dist,
            "rank": np.broadcast_to(np.arange(k), (n, k)).copy(),
            "iterations": d,
            "rechecked": 0,
        }


def _bbox_gap(lb: np.ndarray, rb: np.ndarray) -> np.ndarray:
    """[N, M] bbox-to-bbox separation — a LOWER bound on st_distance.
    lb/rb are [*, 4] (xmin, ymin, xmax, ymax)."""
    dx = np.maximum(0.0, np.maximum(rb[None, :, 0] - lb[:, None, 2],
                                    lb[:, None, 0] - rb[None, :, 2]))
    dy = np.maximum(0.0, np.maximum(rb[None, :, 1] - lb[:, None, 3],
                                    lb[:, None, 1] - rb[None, :, 3]))
    return np.hypot(dx, dy)


def knn_host_truth(left_xy: np.ndarray, right_xy: np.ndarray, k: int,
                   distance_threshold: Optional[float] = None):
    """Brute-force f64 oracle: (right ids [N, k], distances [N, k])."""
    ids, d2 = _brute_topk_blocked(np.asarray(left_xy, np.float64),
                                  np.asarray(right_xy, np.float64),
                                  k, distance_threshold)
    return ids, np.where(ids >= 0, np.sqrt(d2), np.nan)
