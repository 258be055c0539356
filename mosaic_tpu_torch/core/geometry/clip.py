"""Polygon rings, the boolean engine and the dissolve of the geometry
layer.

Port copy of ``mosaic_tpu.core.geometry.clip``:

* segment and ring primitives (``proper_crossings``, ``ring_signed_area``,
  ``_pip_rings``, ``geometry_rings``, ``_normalize_rings``, ``_edges_of``);
* the edge-fragment boolean engine ``rings_boolean`` for intersection,
  union, difference and symmetric difference (split every edge at its
  intersections with the other side, classify each fragment by its
  midpoint, stitch the selected fragments into rings by leftmost turns),
  ``rings_intersection`` (its intersection at ``SPLIT_EPS``),
  ``rings_to_array`` and the row-wise ``boolean_op``;
* the dissolve of interior-disjoint regions by boundary-parity
  cancellation (``dissolve_disjoint_rings``, with the reason of its last
  rejection in ``LAST_DISSOLVE_REJECT``, counted in the metrics registry
  as ``dissolve_reject/<reason>``) and ``unary_union_rings``;
* ``pairs_intersection_area``, the batched exact area of chip pairs behind
  the overlay's ST_IntersectionAgg area, through the native
  ``intersect_area_pairs`` kernel.

Everything is float64 host math.  Unlike the JAX package there is no
Python-engine fallback when the native library cannot be built: the
library raises.  A pair the native kernel cannot settle (NaN, or an area
outside [0, min(area A, area B)]) still goes through
``rings_intersection``, because that is how the area stays exact.
Three departures from the JAX package's areas, each a repair (see
``pairs_intersection_area``): chips whose rings touch give the kernel
their region's boundary (``_region_edges``), the range check above, and
a local frame for the areas.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .array import GeometryArray, GeometryBuilder, GeometryType

#: rings_intersection's parameter-space splitting tolerance: how close to
#: an edge endpoint an intersection may land and still count as interior
SPLIT_EPS = 1e-12
#: the area kernel's distance tolerance (degrees) for a point on the
#: other side's boundary, and for rings that touch
AREA_EPS = 1e-9

__all__ = ["boolean_op", "rings_boolean", "geometry_rings",
           "rings_to_array", "ring_signed_area", "unary_union_rings",
           "dissolve_disjoint_rings", "proper_crossings",
           "rings_intersection", "pairs_intersection_area"]


def proper_crossings(e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """[N, M] bool: strict interior crossing of each segment pair.

    Endpoint touches and collinear overlaps do NOT count (all four
    orientations must be nonzero) — the primitive behind ring-simplicity
    and partition validation."""
    a1, b1 = e1[:, None, 0], e1[:, None, 1]
    a2, b2 = e2[None, :, 0], e2[None, :, 1]

    def orient(p, q, r):
        return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - \
               (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])

    d1 = orient(a2, b2, a1)
    d2 = orient(a2, b2, b1)
    d3 = orient(a1, b1, a2)
    d4 = orient(a1, b1, b2)
    return ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & \
        (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)


def ring_signed_area(r: np.ndarray) -> float:
    """Shoelace signed area of a (closed or open) ring."""
    r = np.asarray(r, np.float64)[:, :2]
    if len(r) >= 2 and np.array_equal(r[0], r[-1]):
        r = r[:-1]
    if len(r) < 3:
        return 0.0
    x, y = r[:, 0], r[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _pip_rings(points: np.ndarray, rings: Sequence[np.ndarray]) -> np.ndarray:
    """Even-odd membership of points in the region bounded by ``rings``."""
    if len(points) == 0:
        return np.zeros(0, bool)
    inside = np.zeros(len(points), bool)
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    for r in rings:
        r = np.asarray(r, np.float64)[:, :2]
        if len(r) >= 2 and np.array_equal(r[0], r[-1]):
            r = r[:-1]
        if len(r) < 3:
            continue
        ax, ay = r[:, 0][None], r[:, 1][None]
        bx = np.concatenate([r[1:, 0], r[:1, 0]])[None]
        by = np.concatenate([r[1:, 1], r[:1, 1]])[None]
        straddle = (ay <= py) != (by <= py)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (py - ay) / np.where(by == ay, 1.0, by - ay)
        xi = ax + t * (bx - ax)
        inside ^= ((straddle & (px < xi)).sum(axis=1) & 1).astype(bool)
    return inside


def geometry_rings(arr: GeometryArray, gi: int) -> List[np.ndarray]:
    """All rings of geometry ``gi`` as open [V, 2] float64 arrays."""
    _, parts = arr.geom_slices(gi)
    out = []
    for rings in parts:
        for ring in rings:
            r = np.asarray(ring, np.float64)[:, :2]
            if len(r) >= 2 and np.array_equal(r[0], r[-1]):
                r = r[:-1]
            if len(r) >= 3:
                out.append(r)
    return out


def _normalize_rings(rings: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Orient rings so the even-odd region is left of every edge.

    Nesting depth d of a ring = how many *other* rings contain a point of
    it; depth-even rings are shells (CCW), depth-odd are holes (CW)."""
    rings = [np.asarray(r, np.float64)[:, :2] for r in rings]
    rings = [r[:-1] if len(r) >= 2 and np.array_equal(r[0], r[-1]) else r
             for r in rings]
    rings = [r for r in rings if len(r) >= 3 and
             abs(ring_signed_area(r)) > 0.0]
    out = []
    for i, r in enumerate(rings):
        others = [q for j, q in enumerate(rings) if j != i]
        # use the ring's lowest-then-leftmost vertex, nudged inward? No:
        # even-odd membership of a boundary vertex of r w.r.t. OTHER
        # rings is well-defined unless rings share boundary; sample a few
        # vertices and take the majority to be safe.
        k = min(len(r), 5)
        depth_votes = _pip_rings(r[:k], others) if others else \
            np.zeros(k, bool)
        depth_odd = bool(np.median(depth_votes.astype(int)) > 0.5)
        ccw = ring_signed_area(r) > 0
        want_ccw = not depth_odd
        out.append(r if ccw == want_ccw else r[::-1])
    return out


# ------------------------------------------------------------ splitting

def _edges_of(rings: Sequence[np.ndarray]) -> np.ndarray:
    """[E, 2, 2] directed closed edges of all rings."""
    segs = []
    for r in rings:
        if len(r) < 2:
            continue
        segs.append(np.stack([r, np.roll(r, -1, axis=0)], axis=1))
    if not segs:
        return np.zeros((0, 2, 2))
    return np.concatenate(segs)


def _split_points(ea: np.ndarray, eb: np.ndarray, eps: float
                  ) -> Tuple[List[List[np.ndarray]], List[List[np.ndarray]]]:
    """For every edge of A (and of B) collect interior split points coming
    from intersections with the other side's edges.

    Proper crossings contribute the same float64 point to both edges;
    endpoint-on-edge and collinear overlaps contribute the projected
    endpoint.  Returns (splits_a, splits_b): per-edge lists of points."""
    na, nb = len(ea), len(eb)
    splits_a: List[List[np.ndarray]] = [[] for _ in range(na)]
    splits_b: List[List[np.ndarray]] = [[] for _ in range(nb)]
    if na == 0 or nb == 0:
        return splits_a, splits_b
    a0 = ea[:, None, 0]
    a1 = ea[:, None, 1]
    b0 = eb[None, :, 0]
    b1 = eb[None, :, 1]
    da = a1 - a0
    db = b1 - b0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    diff = b0 - a0
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(denom != 0,
                     (diff[..., 0] * db[..., 1] -
                      diff[..., 1] * db[..., 0]) / np.where(denom == 0, 1.0,
                                                            denom), np.nan)
        u = np.where(denom != 0,
                     (diff[..., 0] * da[..., 1] -
                      diff[..., 1] * da[..., 0]) / np.where(denom == 0, 1.0,
                                                            denom), np.nan)
    cross_ij = np.argwhere((denom != 0) & (t > -eps) & (t < 1 + eps) &
                           (u > -eps) & (u < 1 + eps))
    for i, j in cross_ij:
        p = ea[i, 0] + t[i, j] * (ea[i, 1] - ea[i, 0])
        if eps < t[i, j] < 1 - eps:
            splits_a[i].append(p)
        if eps < u[i, j] < 1 - eps:
            splits_b[j].append(p)
    # collinear overlaps: project the other edge's endpoints
    la = np.maximum(np.linalg.norm(da, axis=-1), 1e-300)
    para = np.abs(denom) <= eps * la * np.maximum(
        np.linalg.norm(db, axis=-1), 1e-300)
    # distance of b0 from line(a): zero ⇒ same line
    off = np.abs(diff[..., 0] * da[..., 1] - diff[..., 1] * da[..., 0]) / la
    col_ij = np.argwhere(para & (off <= eps))
    for i, j in col_ij:
        dai = ea[i, 1] - ea[i, 0]
        l2 = float(dai @ dai)
        if l2 <= 0:
            continue
        for p in (eb[j, 0], eb[j, 1]):
            tt = float((p - ea[i, 0]) @ dai) / l2
            if eps < tt < 1 - eps:
                splits_a[i].append(ea[i, 0] + tt * dai)
        dbj = eb[j, 1] - eb[j, 0]
        l2b = float(dbj @ dbj)
        if l2b <= 0:
            continue
        for p in (ea[i, 0], ea[i, 1]):
            uu = float((p - eb[j, 0]) @ dbj) / l2b
            if eps < uu < 1 - eps:
                splits_b[j].append(eb[j, 0] + uu * dbj)
    return splits_a, splits_b


def _fragment(edges: np.ndarray, splits: List[List[np.ndarray]]
              ) -> np.ndarray:
    """Split edges at their interior split points -> [F, 2, 2] fragments."""
    out = []
    for i in range(len(edges)):
        a, b = edges[i, 0], edges[i, 1]
        if not splits[i]:
            out.append((a, b))
            continue
        d = b - a
        l2 = float(d @ d)
        ts = sorted({min(max(float((p - a) @ d) / l2, 0.0), 1.0)
                     for p in splits[i]})
        prev = a
        for t in ts:
            p = a + t * d
            out.append((prev, p))
            prev = p
        out.append((prev, b))
    if not out:
        return np.zeros((0, 2, 2))
    frags = np.array([[p, q] for p, q in out])
    keep = np.linalg.norm(frags[:, 1] - frags[:, 0], axis=-1) > 0
    return frags[keep]


# -------------------------------------------------------- classification

def _seg_point_dist(points: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Min distance from each point to any edge ([N] float64)."""
    if len(edges) == 0 or len(points) == 0:
        return np.full(len(points), np.inf)
    a = edges[None, :, 0]
    b = edges[None, :, 1]
    ab = b - a
    ap = points[:, None, :] - a
    denom = np.sum(ab * ab, axis=-1)
    t = np.clip(np.sum(ap * ab, axis=-1) / np.where(denom == 0, 1.0, denom),
                0.0, 1.0)
    proj = a + t[..., None] * ab
    d = points[:, None, :] - proj
    return np.sqrt(np.min(np.sum(d * d, axis=-1), axis=1))


def _classify(frags: np.ndarray, other_rings: Sequence[np.ndarray],
              other_frags: np.ndarray, eps: float
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(inside, outside, shared_dir) per fragment.

    shared_dir: 0 = not on other's boundary, +1 = collinear same
    direction, -1 = collinear opposite direction."""
    n = len(frags)
    if n == 0:
        z = np.zeros(0, bool)
        return z, z, np.zeros(0, np.int8)
    mid = (frags[:, 0] + frags[:, 1]) / 2
    dist = _seg_point_dist(mid, _edges_of(other_rings))
    on = dist <= eps
    inside = np.zeros(n, bool)
    if np.any(~on):
        inside[~on] = _pip_rings(mid[~on], other_rings)
    outside = ~on & ~inside
    shared = np.zeros(n, np.int8)
    if np.any(on) and len(other_frags):
        om = (other_frags[:, 0] + other_frags[:, 1]) / 2
        od = other_frags[:, 1] - other_frags[:, 0]
        for i in np.nonzero(on)[0]:
            d2 = np.sum((om - mid[i]) ** 2, axis=-1)
            j = int(np.argmin(d2))
            if d2[j] <= (eps * 4) ** 2:
                mydir = frags[i, 1] - frags[i, 0]
                shared[i] = 1 if float(mydir @ od[j]) > 0 else -1
            else:
                # on other's boundary but no matching fragment midpoint —
                # vertex touch; classify by nudging off the boundary
                inside[i] = bool(_pip_rings(mid[i][None],
                                            other_rings)[0])
                outside[i] = not inside[i]
    elif np.any(on):
        inside[on] = _pip_rings(mid[on], other_rings)
        outside[on] = ~inside[on]
    return inside, outside, shared


# -------------------------------------------------------------- stitching

def _stitch(frags: List[np.ndarray], eps: float) -> List[np.ndarray]:
    """Assemble directed fragments into closed rings (leftmost-turn walk)."""
    if not frags:
        return []
    F = np.array(frags)                      # [F, 2, 2]
    q = eps * 8

    def key(p):
        return (round(float(p[0]) / q), round(float(p[1]) / q))

    from collections import defaultdict
    outgoing = defaultdict(list)
    for i in range(len(F)):
        outgoing[key(F[i, 0])].append(i)
    used = np.zeros(len(F), bool)
    rings = []
    for start in range(len(F)):
        if used[start]:
            continue
        path = [start]
        used[start] = True
        cur = start
        ring_pts = [F[start, 0]]
        guard = 0
        while guard < len(F) + 1:
            guard += 1
            endk = key(F[cur, 1])
            ring_pts.append(F[cur, 1])
            if endk == key(F[path[0], 0]):
                break
            cands = [j for j in outgoing[endk] if not used[j]]
            if not cands:
                break               # open chain — dropped
            if len(cands) == 1:
                nxt = cands[0]
            else:
                din = F[cur, 1] - F[cur, 0]
                ain = np.arctan2(din[1], din[0])

                def turn(j):
                    d = F[j, 1] - F[j, 0]
                    a = np.arctan2(d[1], d[0])
                    # leftmost turn = largest CCW deviation from reverse
                    return (a - ain + np.pi) % (2 * np.pi)
                nxt = max(cands, key=turn)
            used[nxt] = True
            path.append(nxt)
            cur = nxt
        else:
            continue
        if key(F[cur, 1]) == key(F[path[0], 0]) and len(path) >= 3:
            ring = np.array(ring_pts[:-1])
            # sliver filter: a stitching-noise ring has area ~ width q
            # along its own perimeter.  Scale by the RING's perimeter —
            # scaling by the global coordinate magnitude (pre-round-4)
            # silently dropped any real ring smaller than ~q*|coord|,
            # e.g. building footprints at lon ~74
            perim = float(np.sum(np.linalg.norm(
                np.diff(np.vstack([ring, ring[:1]]), axis=0), axis=1)))
            if abs(ring_signed_area(ring)) > q * max(perim, q):
                rings.append(ring)
    return rings


def _dedupe_ring(r: np.ndarray, eps: float) -> Optional[np.ndarray]:
    keep = [0]
    for i in range(1, len(r)):
        if np.linalg.norm(r[i] - r[keep[-1]]) > eps:
            keep.append(i)
    if len(keep) > 1 and np.linalg.norm(r[keep[-1]] - r[keep[0]]) <= eps:
        keep.pop()
    if len(keep) < 3:
        return None
    return r[keep]


# ----------------------------------------------------------------- api

def rings_boolean(rings_a: Sequence[np.ndarray],
                  rings_b: Sequence[np.ndarray], op: str,
                  eps: float = 1e-12) -> List[np.ndarray]:
    """Boolean op on two even-odd regions given as ring lists.

    op in {"intersection", "union", "difference", "symdifference"}.
    ``eps`` is the parameter-space splitting tolerance (how close to an
    edge endpoint an intersection may land and still count as interior);
    the coordinate-space classification tolerance is derived from it and
    the data's magnitude.  Returns result rings, region-left-of-edge
    oriented (shells CCW, holes CW)."""
    A = _normalize_rings(rings_a)
    B = _normalize_rings(rings_b)
    if not A and not B:
        return []
    scale = max([float(np.abs(np.concatenate(A + B)).max()), 1.0]) \
        if (A or B) else 1.0
    # Coordinate-space tolerance, scaled by the coordinate magnitude.
    # Accuracy envelope (measured by tests/test_fuzz_boolean.py): for
    # geometries of extent L at coordinate magnitude M, boolean areas
    # are exact to ~1e-9 relative when L ~ M, degrading to ~1e-6
    # relative for footprint-sized L ≈ 1e-5*M (snap-rounding at
    # junctions, the same class of floor JTS's snapping tolerance
    # sets).  Tightening the quantum does NOT improve the envelope:
    # fewer bridged junctions start dropping open chains at the same
    # rate as fewer spurious merges stop occurring.
    e = eps * scale * 1e3            # splitting/classify tolerance
    if not A:
        return [] if op in ("intersection", "difference") else B
    if not B:
        return [] if op == "intersection" else A

    ea, eb = _edges_of(A), _edges_of(B)
    sa, sb = _split_points(ea, eb, eps)
    fa, fb = _fragment(ea, sa), _fragment(eb, sb)
    a_in, a_out, a_sh = _classify(fa, B, fb, e)
    b_in, b_out, b_sh = _classify(fb, A, fa, e)
    # B's shared fragments are fully represented by A's (avoid doubles)
    pick: List[np.ndarray] = []
    if op == "intersection":
        pick += [fa[a_in], fb[b_in & (b_sh == 0)], fa[a_sh == 1]]
    elif op == "union":
        pick += [fa[a_out], fb[b_out & (b_sh == 0)], fa[a_sh == 1]]
    elif op == "difference":
        pick += [fa[a_out], fb[b_in & (b_sh == 0)][:, ::-1],
                 fa[a_sh == -1]]
    elif op == "symdifference":
        pick += [fa[a_out], fb[b_in & (b_sh == 0)][:, ::-1],
                 fa[a_sh == -1]]
        pick += [fb[b_out & (b_sh == 0)], fa[a_in][:, ::-1]]
    else:
        raise ValueError(f"unknown boolean op {op!r}")
    frags = [f for f in np.concatenate(pick) if True] if pick else []
    rings = _stitch(list(frags), e)
    out = []
    for r in rings:
        d = _dedupe_ring(r, e)
        if d is not None:
            out.append(d)
    return out



def _sample_parity(rings, los, his, K: int = 5):
    """Per-ring nesting parity by K strided sample vertices, plus the
    containers of each ring's first sample.

    Container-major: each ring is iterated ONCE as a container and all
    other rings' samples inside its bbox are batched through one
    crossing-parity pass — O(sum V_i * P_i) where the ring-major
    version is O(R^2 * V) (measured 29 s on a 2k-ring county union).
    Returns (parity [R, K] bool, n_samples [R], first_in dict
    ring -> list of containers of its first sample vertex)."""
    nr = len(rings)
    samp = np.zeros((nr, K, 2))
    skn = np.zeros(nr, np.int64)
    for j, r in enumerate(rings):
        k = min(len(r), K)
        idx = (np.arange(k) * max(1, len(r) // k))[:k] % len(r)
        samp[j, :k] = r[idx]
        skn[j] = k
    flat = samp.reshape(-1, 2)
    ok_pt = (np.arange(K)[None, :] < skn[:, None]).reshape(-1)
    owner = np.repeat(np.arange(nr), K)
    parity = np.zeros(len(flat), bool)
    first_in: dict = {j: [] for j in range(nr)}
    for i, r in enumerate(rings):
        inb = (ok_pt & (owner != i) &
               (flat[:, 0] >= los[i, 0]) & (flat[:, 0] <= his[i, 0]) &
               (flat[:, 1] >= los[i, 1]) & (flat[:, 1] <= his[i, 1]))
        sel = np.nonzero(inb)[0]
        if not len(sel):
            continue
        hit = _pip_rings(flat[sel], [r])
        parity[sel] ^= hit
        for p in sel[hit]:
            if p % K == 0:
                first_in[p // K].append(i)
    return parity.reshape(nr, K), skn, first_in


def rings_to_array(rings: Sequence[np.ndarray], srid: int = 4326,
                   builder: Optional[GeometryBuilder] = None,
                   empty_ok: bool = True) -> Optional[GeometryArray]:
    """Group result rings into POLYGON/MULTIPOLYGON by even-odd nesting.

    If ``builder`` is given, append and return None; else return a
    1-geometry (or empty) GeometryArray."""
    own = builder is None
    b = builder or GeometryBuilder(srid=srid)
    rings = [r for r in rings if len(r) >= 3]
    if not rings:
        if empty_ok:
            b.add(GeometryType.POLYGON, [[np.zeros((0, 2))]])
        return b.finish() if own else None
    nr = len(rings)
    los = np.array([r.min(axis=0) for r in rings])
    his = np.array([r.max(axis=0) for r in rings])
    parity, skn, first_in = _sample_parity(rings, los, his)
    depth = [int(np.median(parity[j, :skn[j]].astype(int)) > 0.5)
             for j in range(nr)]
    shells = [i for i, d in enumerate(depth) if d == 0]
    shell_set = set(shells)
    holes_of = {i: [] for i in shells}
    for i, d in enumerate(depth):
        if d == 0:
            continue
        # assign hole to the smallest-area shell containing it
        cands = [s for s in first_in[i] if s in shell_set]
        if cands:
            s = min(cands, key=lambda j: abs(ring_signed_area(rings[j])))
            holes_of[s].append(i)
    def closed(r):
        return np.vstack([r, r[:1]])
    if len(shells) == 1:
        s = shells[0]
        b.add_polygon(closed(rings[s]),
                      [closed(rings[h]) for h in holes_of[s]])
    else:
        b.add_multipolygon([[closed(rings[s]),
                             *[closed(rings[h]) for h in holes_of[s]]]
                            for s in shells])
    return b.finish() if own else None


def boolean_op(a: GeometryArray, b: GeometryArray, op: str
               ) -> GeometryArray:
    """Row-wise polygon boolean op over two equal-length batches."""
    if len(a) != len(b):
        raise ValueError(f"batch lengths differ: {len(a)} vs {len(b)}")
    out = GeometryBuilder(srid=a.srid)
    for gi in range(len(a)):
        rings = rings_boolean(geometry_rings(a, gi),
                              geometry_rings(b, gi), op)
        rings_to_array(rings, builder=out)
    return out.finish()


def rings_intersection(rings_a: Sequence[np.ndarray],
                       rings_b: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Intersection of two even-odd regions given as ring lists:
    :func:`rings_boolean` with op "intersection" at ``SPLIT_EPS``."""
    return rings_boolean(rings_a, rings_b, "intersection", SPLIT_EPS)


def _rings_touch(rings: Sequence[np.ndarray], eps: float) -> bool:
    """Whether a vertex of one ring lies within ``eps`` of another ring's
    edges."""
    for i, r in enumerate(rings):
        others = _edges_of([q for j, q in enumerate(rings) if j != i])
        if len(others) and np.any(_seg_point_dist(r, others) <= eps):
            return True
    return False


def _region_edges(rings: Sequence[np.ndarray], eps: float) -> np.ndarray:
    """[E, 2, 2] boundary of the even-odd region of rings that touch, each
    piece directed with the region on its left.

    A chip whose hole runs along its cell's boundary has a hole edge lying
    on part of a shell edge: the two cancel over their common stretch,
    which bounds no region, and a fragment area sum that keeps one stretch
    but not the other does not close.  So every edge is split at the
    vertices of all rings that lie on it (within ``eps``), and each piece
    is oriented by the region's membership just left and right of its
    midpoint; a piece with the region on both sides or neither (a
    cancelled stretch) is dropped."""
    verts = np.concatenate(rings)
    delta = max(eps * 1e-2, 1e3 * float(np.spacing(
        max(float(np.abs(verts).max()), 1.0))))
    pieces = []
    for a, b in _edges_of(rings):
        d = b - a
        l2 = float(d @ d)
        if l2 == 0.0:
            continue
        t = ((verts - a) @ d) / l2
        off = np.abs((verts[:, 0] - a[0]) * d[1] - (verts[:, 1] - a[1]) *
                     d[0])
        on = (off <= eps * np.sqrt(l2)) & (t > 0) & (t < 1)
        chain = [a, *verts[on][np.argsort(t[on], kind="stable")], b]
        pieces += [(p, q) for p, q in zip(chain[:-1], chain[1:])
                   if not np.array_equal(p, q)]
    if not pieces:
        return np.zeros((0, 2, 2))
    F = np.array(pieces)
    d = F[:, 1] - F[:, 0]
    normal = np.stack([-d[:, 1], d[:, 0]], -1) / \
        np.linalg.norm(d, axis=-1)[:, None]
    mid = (F[:, 0] + F[:, 1]) / 2
    left = _pip_rings(mid + delta * normal, rings)
    right = _pip_rings(mid - delta * normal, rings)
    F = F[left != right]
    flip = right[left != right]
    F[flip] = F[flip][:, ::-1]
    return F


def _area_edges(rings: Sequence[np.ndarray], eps: float) -> np.ndarray:
    """Region-left directed edges [E, 2, 2] of one geometry for the area
    kernel: the normalized rings' edges, or, where rings touch, the
    split and re-oriented boundary of ``_region_edges``."""
    if len(rings) > 1 and _rings_touch(rings, eps):
        return _region_edges(rings, eps)
    return _edges_of(rings)


def _edges_area(edge_sets: Sequence[np.ndarray]) -> np.ndarray:
    """[G] shoelace area of each region-left edge set [E, 2, 2]."""
    return np.array([0.5 * float(np.sum(e[:, 0, 0] * e[:, 1, 1] -
                                        e[:, 1, 0] * e[:, 0, 1]))
                     for e in edge_sets])


def pairs_intersection_area(a: GeometryArray, ia: np.ndarray,
                            b: GeometryArray, ib: np.ndarray) -> np.ndarray:
    """Exact planar area(A[ia[p]] ∩ B[ib[p]]) per pair, batched.

    The scalable sibling of rings_intersection for the overlay's
    ST_IntersectionAgg area (reference:
    expressions/geometry/ST_IntersectionAgg.scala:41-58): area needs no
    ring stitching — it is a shoelace sum over selected boundary
    fragments, which the native kernel (native/geokernels.cpp
    intersect_area_pairs) walks in O(Ea*Eb) per pair.  A pair the kernel
    returns as NaN goes through the boolean engine + shoelace; a library
    that cannot be built raises RuntimeError.

    Three differences from the JAX package, where its answer is wrong:

    * a geometry whose rings touch (a chip whose hole runs along its
      cell's boundary) gives the kernel its region's boundary
      (``_region_edges``), not its raw ring edges, whose overlapping
      stretches the fragment sum cannot cancel;
    * a pair whose kernel area lies outside [0, min(area A, area B)] by
      more than rounding (a sliver chip lying along the other chip's
      boundary) goes through the boolean engine, as a NaN pair does;
      the check is one-sided: a wrong area inside that range stands;
    * every area is computed in a local frame (:func:`_frame_origin`):
      a shoelace at |lon| ~74 rounds each coordinate product at ~3e3
      and loses about 1e-12 deg^2, more than the 1e-12 + 1e-9 area
      contract allows; translated near 0 it loses ~1e-17."""
    from ... import native
    ia = np.asarray(ia, np.int64)
    ib = np.asarray(ib, np.int64)
    if len(ia) != len(ib):
        raise ValueError(f"pair lists differ in length: {len(ia)} vs "
                         f"{len(ib)}")
    # normalize/edge-build once per DISTINCT geometry (pair lists
    # repeat geometries heavily in the overlay join)
    ua, inva = np.unique(ia, return_inverse=True)
    ub, invb = np.unique(ib, return_inverse=True)
    ra_u = [_normalize_rings(geometry_rings(a, int(g))) for g in ua]
    rb_u = [_normalize_rings(geometry_rings(b, int(g))) for g in ub]
    origin = _frame_origin(ra_u + rb_u)
    ea_u = [_area_edges(r, AREA_EPS) - origin for r in ra_u]
    eb_u = [_area_edges(r, AREA_EPS) - origin for r in rb_u]
    offa = np.cumsum([0] + [len(e) for e in ea_u])
    offb = np.cumsum([0] + [len(e) for e in eb_u])
    flat_a = (np.concatenate(ea_u) if ea_u else
              np.zeros((0, 2, 2))).reshape(-1, 4)
    flat_b = (np.concatenate(eb_u) if eb_u else
              np.zeros((0, 2, 2))).reshape(-1, 4)
    out = native.intersect_area_pairs(flat_a, offa, inva, flat_b, offb,
                                      invb, AREA_EPS)
    # NaN = kernel split-buffer overflow on that pair (edge vs >500
    # splits); an area outside [0, min(area A, area B)] beyond rounding =
    # a sliver chip along the other's boundary, whose fragments the sum
    # cannot close: resolve both exactly via the boolean engine
    cap = np.minimum(_edges_area(ea_u)[inva], _edges_area(eb_u)[invb])
    tol = 1e-12 + 1e-9 * np.abs(cap)
    redo = np.isnan(out) | (out < -tol) | (out > cap + tol)
    for p in np.nonzero(redo)[0]:
        rings = rings_intersection(ra_u[inva[p]], rb_u[invb[p]])
        out[p] = sum(ring_signed_area(r - origin)
                     for r in _normalize_rings(rings))
    return out


def _frame_origin(ring_lists: Sequence[Sequence[np.ndarray]]
                  ) -> np.ndarray:
    """[2] origin of the area frame: per axis, the centre of the rings'
    bbox rounded to 0.1, where that centre lies farther from 0 than the
    bbox is wide (footprints at lon -74, extent 0.5), else 0 (data around
    0 keeps its coordinates, and its areas their bits)."""
    pts = [r for rings in ring_lists for r in rings]
    if not pts:
        return np.zeros(2)
    pts = np.concatenate(pts)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    centre = (lo + hi) / 2
    return np.where(np.abs(centre) > hi - lo, np.round(centre, 1), 0.0)


def _shoelace(r: np.ndarray) -> float:
    """Signed area of an OPEN ring without np.roll round-trips."""
    x, y = r[:, 0], r[:, 1]
    s = x[:-1] @ y[1:] - x[1:] @ y[:-1]
    return 0.5 * float(s + x[-1] * y[0] - x[0] * y[-1])


#: why the last dissolve_disjoint_rings call fell back (None = it
#: accepted) -- mirrors pip_join.LAST_DENSE_REJECT so a workload
#: quietly losing the fast union path is diagnosable
LAST_DISSOLVE_REJECT: Optional[str] = None


def _dissolve_reject(reason: str) -> None:
    global LAST_DISSOLVE_REJECT
    LAST_DISSOLVE_REJECT = reason
    from ...obs import metrics
    metrics.count(f"dissolve_reject/{reason}")


def dissolve_disjoint_rings(parts: Sequence[Sequence[np.ndarray]],
                            ) -> Optional[List[np.ndarray]]:
    """Union of N even-odd regions with pairwise-disjoint INTERIORS by
    boundary-parity cancellation — O(E log E) where the pairwise-union
    fold is O(N · E_pair²).

    The union boundary of interior-disjoint regions is exactly the
    multiset of their directed boundary edges with opposite-direction
    duplicates cancelled (shared cell walls between adjacent chips
    vanish; everything else survives).  Surviving edges are stitched
    into closed rings by leftmost-turn face walking.  Correctness is
    VERIFIED, not assumed: area(result) must equal Σ area(parts) —
    that identity holds iff the inputs really were interior-disjoint
    and every shared wall cancelled bit-for-bit after snapping.  On any
    violation (overlapping inputs, mismatched edge splits, open walk)
    the function returns None and the caller falls back to the exact
    pairwise fold.

    This is the scalable path behind ST_UnionAgg / ST_IntersectionAgg
    (reference: ST_UnionAgg.scala, ST_IntersectionAgg.scala:41-58):
    their inputs are per-cell chips of one tessellation, disjoint by
    construction.

    CONTRACT: pairwise-disjoint interiors is the CALLER's guarantee.
    The self-checks catch the *accidental* violations that move the
    area identity (duplicated parts, unpartitioned overlap, open
    walks), but the identity is a necessary condition, not a
    sufficient one.  Known gap: when two parts share a border but
    SPLIT it differently (vertices on one side that the other lacks),
    the opposite-direction wall edges are not bit-identical after
    snapping, so they fail to cancel — yet the leftover edge pairs
    stitch into degenerate interior rings whose net signed area is ~0,
    which passes the area check within tolerance.  The result then
    carries spurious zero-area interior rings along the shared border
    WITHOUT triggering the fallback (see PARITY.md "Boolean-engine
    snap floor").  Tessellation chips of one grid split shared walls
    identically, so the flagship paths never hit this; callers feeding
    independently-generated borders must tolerate (or post-filter)
    such rings.  Adversarial overlapping inputs with collinear shared
    boundaries can likewise slip the identity — which is why the
    general ``unary_union_rings`` only takes this path when its caller
    passes ``assume_disjoint=True``.
    """
    global LAST_DISSOLVE_REJECT
    LAST_DISSOLVE_REJECT = None
    # orient every part region-left (shells CCW, holes CW): then each
    # surviving directed edge keeps the union on its LEFT, stitched
    # rings come out correctly oriented AND nested, and no O(R²)
    # output normalization pass is needed.  Single-ring parts (the
    # overwhelming majority of tessellation chips) are processed as
    # ONE flat array — per-ring shoelace via reduceat, orientation as
    # an edge-level src/dst swap — so cost scales with vertices, not
    # Python calls per chip.
    singles: List[np.ndarray] = []
    multi_rings: List[np.ndarray] = []
    target = 0.0
    for p in parts:
        if not p:
            continue
        rr = []
        for r in p:
            r = np.asarray(r, np.float64)
            if r.shape[1] > 2:
                r = r[:, :2]
            if len(r) >= 2 and r[0, 0] == r[-1, 0] and \
                    r[0, 1] == r[-1, 1]:
                r = r[:-1]
            if len(r) >= 3:
                rr.append(r)
        if not rr:
            continue
        if len(rr) == 1:
            singles.append(rr[0])
        else:
            rr = _normalize_rings(rr)
            target += sum(_shoelace(r) for r in rr)
            multi_rings.extend(rr)
    if not singles and not multi_rings:
        return []
    seg_blocks = []
    pts_max = 1.0
    if singles:
        lens = np.array([len(r) for r in singles], np.int64)
        ptr = np.concatenate([[0], np.cumsum(lens)])
        V = np.concatenate(singles)
        pts_max = max(pts_max, float(np.max(np.abs(V))))
    if multi_rings:
        pts_max = max(pts_max, max(float(np.max(np.abs(r)))
                                   for r in multi_rings))
    snap = pts_max * 2.0 ** -36
    if singles:
        nxt = np.arange(len(V)) + 1
        nxt[ptr[1:] - 1] = ptr[:-1]
        x, y = V[:, 0], V[:, 1]
        cross = x * y[nxt] - x[nxt] * y
        areas = 0.5 * np.add.reduceat(cross, ptr[:-1])
        target += float(np.abs(areas).sum())
        rev = np.repeat(areas < 0, lens)          # CW ring -> swap
        Q = np.rint(V / snap).astype(np.int64)
        src = np.where(rev[:, None], Q[nxt], Q)
        dst = np.where(rev[:, None], Q, Q[nxt])
        seg_blocks.append(np.stack([src, dst], axis=1))
    for r in multi_rings:
        q = np.rint(r / snap).astype(np.int64)
        qn = np.concatenate([q[1:], q[:1]])
        seg_blocks.append(np.stack([q, qn], axis=1))
    e = np.concatenate(seg_blocks)                # [E, 2, 2] int64
    # Cancel + balance-check, with a bounded REPAIR loop: real datasets
    # hand adjacent chips whose shared-wall vertices agree only to
    # ~1e-6 deg (independent boundary computations, shallow-angle
    # crossing amplification), which is beyond the snap quantum; those
    # walls fail to cancel and show up as in/out-degree imbalance at
    # two near-coincident vertices.  Merging imbalanced vertices within
    # a small radius and re-cancelling heals them; the area identity
    # at the end remains the arbiter of correctness.
    dirs = None
    for _repair in range(3):
        e = e[np.any(e[:, 0] != e[:, 1], axis=1)]  # drop degenerate
        if len(e) == 0:
            if target <= snap * snap:
                return []
            _dissolve_reject("all_edges_degenerate")
            return None
        # canonical undirected key + direction sign
        flip = (e[:, 0, 0] > e[:, 1, 0]) | (
            (e[:, 0, 0] == e[:, 1, 0]) & (e[:, 0, 1] > e[:, 1, 1]))
        canon = np.where(flip[:, None, None], e[:, ::-1],
                         e).reshape(-1, 4)
        sign = np.where(flip, -1, 1).astype(np.int64)
        uniq, inv = np.unique(canon, axis=0, return_inverse=True)
        net = np.zeros(len(uniq), np.int64)
        np.add.at(net, inv, sign)
        live = net % 2 != 0
        if not np.any(live):
            # everything cancelled: union of nonempty regions can't
            # be empty unless the inputs weren't disjoint
            if target > snap * snap:
                _dissolve_reject("fully_cancelled")
                return None
            return []
        # rebuild directed survivors (net parity ±1 → one copy)
        lu = uniq[live]
        ln = net[live]
        fwd = lu.reshape(-1, 2, 2)
        cand = np.where((ln > 0)[:, None, None], fwd, fwd[:, ::-1])
        nv_pts = np.concatenate([cand[:, 0], cand[:, 1]])
        verts, vid = np.unique(nv_pts, axis=0, return_inverse=True)
        n_c = len(cand)
        outd = np.bincount(vid[:n_c], minlength=len(verts))
        ind = np.bincount(vid[n_c:], minlength=len(verts))
        bad = np.nonzero(outd != ind)[0]
        if len(bad) == 0:
            dirs = cand
            break
        if len(bad) > max(64, len(verts) // 64):
            _dissolve_reject("imbalance_too_wide")
            return None                           # not a precision tail
        # cluster imbalanced vertices within the heal radius and snap
        # each cluster to its first member, then re-cancel
        bv = verts[bad].astype(np.float64)
        radius = 2.0 ** 13                        # in snap quanta
        remap = {}
        for i in range(len(bad)):
            if int(bad[i]) in remap:
                continue
            d = np.max(np.abs(bv - bv[i]), axis=1)
            members = np.nonzero(d <= radius)[0]
            if len(members) < 2:
                _dissolve_reject("unpaired_imbalance")
                return None
            for j in members:
                remap[int(bad[j])] = verts[bad[i]]
        flat = e.reshape(-1, 2)
        new_flat = flat.copy()
        for old_vid, new_pt in remap.items():
            hit = np.all(flat == verts[old_vid], axis=1)
            new_flat[hit] = new_pt
        e = new_flat.reshape(-1, 2, 2)
    if dirs is None:
        _dissolve_reject("repair_exhausted")
        return None

    # stitch into closed rings.  Vertices get integer ids; each edge
    # chases successor edges at its head vertex.  Degree-1 vertices
    # (the overwhelming majority) resolve by direct lookup; junction
    # vertices (>= 2 outgoing) resolve by sharpest-left-turn so faces
    # stay simple.
    nv_pts = np.concatenate([dirs[:, 0], dirs[:, 1]])
    verts, vid = np.unique(nv_pts, axis=0, return_inverse=True)
    n_e = len(dirs)
    src_id, dst_id = vid[:n_e], vid[n_e:]
    order = np.argsort(src_id, kind="stable")
    bounds = np.searchsorted(src_id[order], np.arange(len(verts) + 1))
    multi = {}
    successor = np.full(len(verts), -1, np.int64)
    for v in np.nonzero(np.diff(bounds) > 1)[0]:
        multi[int(v)] = [int(j) for j in order[bounds[v]:bounds[v + 1]]]
    single = np.diff(bounds) == 1
    successor[single] = order[bounds[:-1][single]]
    vecs = (dirs[:, 1] - dirs[:, 0]).astype(np.float64)
    # edge -> next edge for edges whose head is a degree-1 vertex
    # (-1 marks a junction head).  Python lists make the chase a pure
    # int-op loop (~100 ns/step): a county-scale dissolve walks ~1M
    # steps, which np scalar indexing made a 30+ s stage (BENCH r5
    # first cut measured union_agg at 38 s on 93k chips).
    # successor is -1 at every vertex whose out-degree != 1, so the
    # chase array is already -1 exactly at junction/dead-end heads
    chase_l = successor[dst_id].tolist()
    src_l = src_id.tolist()
    dst_l = dst_id.tolist()
    used = [False] * n_e
    rings_out: List[np.ndarray] = []
    for start in range(n_e):
        if used[start]:
            continue
        walk = [start]
        used[start] = True
        home = src_l[start]
        prev = start
        cur = dst_l[start]
        guard = n_e + 1
        while cur != home and guard:
            guard -= 1
            nxt = chase_l[prev]
            if nxt < 0:                  # junction (or dead-end) vertex
                cands = [j for j in multi.get(cur, ())
                         if not used[j]]
                if not cands:
                    _dissolve_reject("open_walk")
                    return None
                if len(cands) == 1:
                    nxt = cands[0]
                else:
                    pv = vecs[prev]

                    def turn(j):
                        v = vecs[j]
                        return np.arctan2(pv[0] * v[1] - pv[1] * v[0],
                                          pv[0] * v[0] + pv[1] * v[1])
                    nxt = max(cands, key=turn)
            elif used[nxt]:
                _dissolve_reject("open_walk")
                return None
            walk.append(nxt)
            used[nxt] = True
            prev = nxt
            cur = dst_l[nxt]
        if not guard:
            _dissolve_reject("walk_guard")
            return None
        rings_out.append(dirs[walk, 0].astype(np.float64) * snap)
    got = float(sum(_shoelace(r) for r in rings_out))
    tol = max(abs(target), snap) * 1e-6 + pts_max * snap * 64.0
    if abs(got - target) > tol:
        _dissolve_reject(f"area_identity:{got:.3e}vs{target:.3e}")
        return None
    # orientation/depth consistency: a CCW ring must sit at even
    # nesting depth, CW at odd.  Catches interior-disjointness
    # violations the area identity alone cannot see (e.g. one input
    # nested inside another: its boundary survives CCW at depth 1,
    # where a true hole would be CW).  Only rings bbox-contained in
    # another ring need a vote, so the usual output (one shell, few
    # holes) costs almost nothing.
    if len(rings_out) > 1:
        nr = len(rings_out)
        los = np.array([r.min(axis=0) for r in rings_out])
        his = np.array([r.max(axis=0) for r in rings_out])
        sa = np.array([_shoelace(r) for r in rings_out])
        area_floor = pts_max * snap * 16.0
        parity, skn, _ = _sample_parity(rings_out, los, his)
        for j in range(nr):
            if abs(sa[j]) <= area_floor:
                continue                          # healed sliver ring
            depth_odd = bool(np.median(
                parity[j, :skn[j]].astype(int)) > 0.5)
            if depth_odd == (sa[j] > 0):
                _dissolve_reject("orientation_depth_mismatch")
                return None
    return rings_out


def unary_union_rings(parts: Sequence[Sequence[np.ndarray]],
                      assume_disjoint: bool = False
                      ) -> List[np.ndarray]:
    """Union of N even-odd regions.  Fast path (only when the caller
    asserts interior-disjoint inputs — tessellation chips keyed by
    distinct cells): boundary-parity dissolve, O(E log E).  General
    path: balanced fold of pairwise unions, which resolves arbitrary
    overlaps exactly.  Reference: ST_UnionAgg / ST_UnaryUnion."""
    regs = [list(p) for p in parts if p]
    if not regs:
        return []
    if assume_disjoint and len(regs) > 4:
        fast = dissolve_disjoint_rings(regs)
        if fast is not None:
            return fast
    while len(regs) > 1:
        nxt = []
        for i in range(0, len(regs) - 1, 2):
            nxt.append(rings_boolean(regs[i], regs[i + 1], "union"))
        if len(regs) % 2:
            nxt.append(regs[-1])
        regs = nxt
    return _normalize_rings(regs[0])
