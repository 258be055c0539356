"""The port's edge-block measures and predicates against the JAX package.

Every function of ``mosaic_tpu.core.geometry.measures`` and
``predicates`` that runs on a device (ROADMAP §B7) goes through both
packages on the CPU, in float64 and float32, on the same edge blocks:
``build_edges`` of each package over one WKT list (holes, multipolygons,
open lines, a point, an empty polygon, a zero-length edge, adjacent
squares that share edges, a nested square), and seeded random blocks
with zero-length edges, fully masked rows and NaN endpoints.  Points are
seeded, with vertices, edge midpoints and NaN rows among them.  The
port's wrappers run their kernels' plain versions here (``device="cpu"``).

Tolerances:

* bit-equal: ``bounds``, crossing counts, containment, the edge-crossing
  matrix, ``polygons_intersect``, ``polygon_contains_polygon``,
  ``first_vertex`` and ``segments_intersect`` (NaN in the same places);
* ``area``, ``length`` and ``centroid``: within 1e-12 x the row's sum of
  |terms| in float64 and 1e-5 x that sum in float32 (XLA sums in its own
  order and contracts multiplies into adds; the shoelace's terms are its
  products |ax by| + |ay bx|);
* distances (``distance_points_to_geoms``, the boundary distance,
  ``point_segment_dist2``, ``pairwise_point_distance``, ``haversine``):
  within 1e-12 relative in float64 and 1e-5 relative in float32, +inf and
  NaN in the same places: a NaN point, and in float32 a zero-length
  valid edge, whose 1e-300 guard rounds to 0 (0/0, as XLA gives).

The plain versions sum over the edge slots left to right, as the kernels
do: ``area``, ``length``, ``centroid`` and ``bounds`` are held bit for
bit to a numpy loop in slot order (its lengths through torch's sqrt: on
this host torch's CPU sqrt is not always correctly rounded, while on the
card both the kernel and the plain version take CUDA's IEEE sqrt).  The
edge-measures adversarial set (``bench.workloads.measures_adversarial``,
which ``chip_smoke.py`` holds the kernel to on the card) goes through
both packages too, and the wrapper's launch plan is checked for every
class of slot count against the kernel source's constants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mosaic_tpu as J
import mosaic_tpu_torch as T
from mosaic_tpu.core.geometry import measures as jm
from mosaic_tpu.core.geometry import predicates as jp
from mosaic_tpu.core.geometry.padded import EdgeBlocks as JBlocks
from mosaic_tpu.core.geometry.padded import build_edges as jbuild
from mosaic_tpu.core.geometry.padded import points_block as jpoints
from mosaic_tpu_torch.core.geometry import measures as tm
from mosaic_tpu_torch.core.geometry import predicates as tp
from mosaic_tpu_torch.core.geometry.padded import EdgeBlocks as TBlocks
from mosaic_tpu_torch.core.geometry.padded import build_edges as tbuild
from mosaic_tpu_torch.core.geometry.padded import points_block as tpoints
from mosaic_tpu_torch.bench.workloads import (MEASURES_ADV_SHAPES,
                                              MEASURES_ADV_VIEWS,
                                              measures_adversarial,
                                              measures_view)
from mosaic_tpu_torch.ops import edge_measures as em
from mosaic_tpu_torch.ops.edge_measures import (edge_measures,
                                                edge_measures_ref, guards,
                                                launch_plan)
from mosaic_tpu_torch.ops.edge_point import edge_point_query
from mosaic_tpu_torch.ops.edges_cross import edges_cross

WKTS = [
    "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
    "POLYGON ((4 0, 8 0, 8 4, 4 4, 4 0))",              # shares x = 4
    "POLYGON ((0 4, 4 4, 4 8, 0 8, 0 4))",              # shares y = 4
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (2 2, 4 2, 4 4, 2 4, 2 2))",
    "POLYGON ((1 1, 2 1, 2 2, 1 2, 1 1))",              # inside the first
    "POLYGON ((0 0, 0 4, 4 4, 4 0, 0 0))",              # CW input
    "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)), ((5 5, 6 5, 6 6, 5 6, "
    "5 5)))",
    "LINESTRING (1 2, 5 -3, 2 7)",
    "LINESTRING (2 2, 2 2, 3 2)",                       # zero-length edge
    "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3))",
    "POINT (3 3)",
    "POLYGON EMPTY",
    "POLYGON ((-74.02 40.70, -73.95 40.70, -73.95 40.76, -74.02 40.76, "
    "-74.02 40.70), (-74.00 40.72, -73.98 40.72, -73.98 40.74, -74.00 "
    "40.74, -74.00 40.72))",
]

DTYPES = [(jnp.float64, torch.float64, np.float64),
          (jnp.float32, torch.float32, np.float32)]


def _blocks_random(seed: int = 5, G: int = 24, E: int = 16):
    """Seeded random blocks: integer and real coordinates, random masks,
    zero-length valid edges, two fully masked rows, NaN endpoints in one
    valid slot and one masked slot."""
    r = np.random.default_rng(seed)
    A = r.uniform(-5, 5, (G, E, 2))
    B = r.uniform(-5, 5, (G, E, 2))
    A[:G // 2] = np.round(A[:G // 2])
    B[:G // 2] = np.round(B[:G // 2])
    M = r.random((G, E)) < 0.7
    B[:, ::5] = A[:, ::5]                        # zero-length edges
    M[3] = False
    M[7] = False
    A[9, 2] = np.nan
    M[9, 2] = True
    A[10, 4] = np.nan
    M[10, 4] = False
    return A, B, M


def _pair(A, B, M, jdt, tdt):
    return (JBlocks(jnp.asarray(A, jdt), jnp.asarray(B, jdt),
                    jnp.asarray(M)),
            TBlocks(torch.from_numpy(A).to(tdt), torch.from_numpy(B).to(tdt),
                    torch.from_numpy(M)))


def _wkt_blocks(jdt, tdt):
    return (jbuild(J.read_wkt(WKTS), dtype=jdt),
            tbuild(T.read_wkt(WKTS), dtype=tdt, device="cpu"))


def _points(npdt, seed: int = 9):
    r = np.random.default_rng(seed)
    pts = np.concatenate([
        r.uniform(-2, 11, (300, 2)),
        [[4, 2], [4, 4], [0, 0], [2, 2], [3, 2], [2, 3], [4, 0], [8, 4],
         [np.nan, np.nan], [5, 5.5], [-74.0, 40.73], [-73.99, 40.73]]])
    return pts.astype(npdt)


def _np(x):
    return np.asarray(x)


def _same(j, t):
    j, t = _np(j), t.numpy()
    assert j.shape == t.shape and np.array_equal(j, t, equal_nan=True), \
        np.argwhere(~((j == t) | (np.isnan(j) & np.isnan(t))))[:10]


def _close(j, t, tol):
    """Within ``tol`` (an array or a number), NaN and inf placed alike."""
    j, t = _np(j).astype(np.float64), t.numpy().astype(np.float64)
    assert j.shape == t.shape
    assert np.array_equal(np.isnan(j), np.isnan(t))
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t))
    assert np.array_equal(j[~fin & ~np.isnan(j)], t[~fin & ~np.isnan(t)])
    tol = np.broadcast_to(tol, j.shape)
    bad = np.abs(j[fin] - t[fin]) > tol[fin]
    assert not bad.any(), (j[fin][bad][:5], t[fin][bad][:5])


def _term_scales(A, B, M):
    """Per row, the sums of |terms| of area, length and the centroid's
    branch (numpy f64)."""
    m = M.astype(np.float64)
    cross = (A[..., 0] * B[..., 1] - A[..., 1] * B[..., 0]) * m
    # the shoelace's terms are its products: |ax by| + |ay bx| an edge
    prod = (np.abs(A[..., 0] * B[..., 1]) + np.abs(A[..., 1] * B[..., 0])) * m
    d = B - A
    ln = np.sqrt(np.sum(d * d, -1)) * m
    with np.errstate(invalid="ignore", divide="ignore"):
        S = prod.sum(-1)
        L = ln.sum(-1)
        Aa = np.abs(cross.sum(-1))
        cen_poly = (np.abs((A + B) * prod[..., None]).sum(1) +
                    np.abs(A + B).max(1) * S[:, None]) / (3 * Aa[:, None])
        cen_line = (np.abs(0.5 * (A + B) * ln[..., None]).sum(1) +
                    np.abs(A + B).max(1) * L[:, None]) / L[:, None]
        cen_vert = np.abs(A * m[..., None]).sum(1) / \
            np.maximum(M.sum(-1), 1)[:, None]
    cen = np.where(Aa[:, None] > 1e-30, cen_poly,
                   np.where(L[:, None] > 1e-30, cen_line, cen_vert))
    return 0.5 * S, L, np.nan_to_num(cen, nan=np.inf)


def _tol(scale, npdt):
    return (1e-12 if npdt == np.float64 else 1e-5) * scale + 1e-300


def _block_sets(jdt, tdt):
    """(label, JAX blocks, port blocks, numpy A, B, M)."""
    out = []
    je, te = _wkt_blocks(jdt, tdt)
    out.append(("wkt", je, te, te.a.double().numpy(), te.b.double().numpy(),
                te.mask.numpy()))
    A, B, M = _blocks_random()
    je, te = _pair(A, B, M, jdt, tdt)
    out.append(("random", je, te, te.a.double().numpy(),
                te.b.double().numpy(), M))
    return out


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_area_length_centroid(jdt, tdt, npdt):
    for label, je, te, A, B, M in _block_sets(jdt, tdt):
        s_area, s_len, s_cen = _term_scales(A, B, M)
        for f, scale in (("area", s_area), ("length", s_len),
                         ("centroid", s_cen)):
            j = getattr(jm, f)(je)
            t = getattr(tm, f)(te)
            assert t.dtype == tdt, (label, f)
            _close(j, t, _tol(scale, npdt))


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_bounds_bit_equal(jdt, tdt, npdt):
    for label, je, te, *_ in _block_sets(jdt, tdt):
        _same(jm.bounds(je), tm.bounds(te))


def test_known_values():
    """tests/test_geometry_core.py's measure values, in both types."""
    polys = T.read_wkt(WKTS[:1] + WKTS[3:4] +
                       ["POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), "
                        "(6 6, 9 6, 9 9, 6 9, 6 6))", WKTS[5],
                        "LINESTRING (1 2, 5 -3, 2 7)"])
    for dt in (torch.float64, torch.float32):
        e = tbuild(polys, dtype=dt, device="cpu")
        assert np.allclose(tm.area(e).numpy()[:2], [16.0, 96.0])
        assert np.allclose(tm.length(e).numpy()[:2], [16.0, 48.0])
        c = tm.centroid(e).numpy()
        assert np.allclose(c[0], [2.0, 2.0])
        assert c[2, 0] < 5.0 and c[2, 1] < 5.0
        assert tm.area(e).numpy()[3] == 16.0
        assert np.allclose(tm.bounds(e).numpy()[4], [1, -3, 5, 7])
        d = tm.distance_points_to_geoms(
            torch.tensor([[5.0, 3.0], [-3.0, 4.0]], dtype=dt),
            tbuild(T.read_wkt(["LINESTRING (0 0, 10 0)"]), dtype=dt,
                   device="cpu")).numpy()
        assert np.allclose(d[:, 0], [3.0, 5.0])


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_point_queries(jdt, tdt, npdt):
    pts = _points(npdt)
    jpts, tpts = jnp.asarray(pts), torch.from_numpy(pts)
    for label, je, te, *_ in _block_sets(jdt, tdt):
        _same(jp.crossing_number(jpts, je), tp.crossing_number(tpts, te))
        ji, jd = jp.points_in_polygons(jpts, je, with_boundary_dist=True)
        ti, td = tp.points_in_polygons(tpts, te, with_boundary_dist=True)
        _same(ji, ti)
        assert ti.dtype == torch.bool and td.dtype == tdt
        rel = 1e-12 if npdt == np.float64 else 1e-5
        _close(jd, td, rel * np.abs(_np(jd).astype(np.float64)) + 1e-300)
        ji2, none = tp.points_in_polygons(tpts, te)
        assert none is None
        _same(ji, ji2)
        dj = jm.distance_points_to_geoms(jpts, je)
        dt_ = tm.distance_points_to_geoms(tpts, te)
        _close(dj, dt_, rel * np.abs(_np(dj).astype(np.float64)) + 1e-300)


def test_f32_zero_length_edge_gives_nan_as_xla():
    """The 1e-300 guard rounds to 0 in float32: a point against a block
    whose only valid edge has zero length gets NaN in both packages, and
    the distance to the point a in float64."""
    A = np.array([[[2.0, 2.0], [0, 0]]])
    B = np.array([[[2.0, 2.0], [0, 0]]])
    M = np.array([[True, False]])
    p = np.array([[2.0, 3.0]])
    for jdt, tdt, npdt in DTYPES:
        je, te = _pair(A, B, M, jdt, tdt)
        dj = jm.distance_points_to_geoms(jnp.asarray(p.astype(npdt)), je)
        dt_ = tm.distance_points_to_geoms(torch.from_numpy(p.astype(npdt)),
                                          te)
        _same(dj, dt_)
        assert np.isnan(dt_.item()) == (npdt == np.float32)
        if npdt == np.float64:
            assert dt_.item() == 1.0
    # and a row with no valid slot has a NaN centroid in float32 only
    for jdt, tdt, npdt in DTYPES:
        je, te = _pair(A, B, np.zeros_like(M), jdt, tdt)
        _same(jm.centroid(je), tm.centroid(te))
        assert np.isnan(tm.centroid(te).numpy()).all() == \
            (npdt == np.float32)


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_polygon_predicates_bit_equal(jdt, tdt, npdt):
    for label, je, te, *_ in _block_sets(jdt, tdt):
        _same(jp.edges_cross_matrix(je, je), tp.edges_cross_matrix(te, te))
        _same(jp.polygons_intersect(je, je), tp.polygons_intersect(te, te))
        _same(jp.polygon_contains_polygon(je, je),
              tp.polygon_contains_polygon(te, te))
        _same(jp.first_vertex(je), tp.first_vertex(te))
    je, te = _wkt_blocks(jdt, tdt)
    m = tp.polygons_intersect(te, te).numpy()
    c = tp.polygon_contains_polygon(te, te).numpy()
    assert m[0, 1] and m[0, 2] and m[1, 2]        # shared edges, corner
    assert m[0, 4] and c[0, 4] and not c[4, 0]    # nested square


def test_adjacent_partition_bit_equal():
    """A 6 x 6 partition of unit squares with jittered shared vertices:
    every neighbour pair shares whole edges."""
    n = 6
    r = np.random.default_rng(17)
    xs = np.arange(n + 1) + r.uniform(-0.3, 0.3, (n + 1, n + 1))
    ys = np.arange(n + 1)[:, None] + r.uniform(-0.3, 0.3, (n + 1, n + 1))
    wkts = []
    for i in range(n):
        for j in range(n):
            ring = [(xs[i, j], ys[i, j]), (xs[i, j + 1], ys[i, j + 1]),
                    (xs[i + 1, j + 1], ys[i + 1, j + 1]),
                    (xs[i + 1, j], ys[i + 1, j])]
            ring.append(ring[0])
            wkts.append("POLYGON ((" + ", ".join(
                f"{float(x)!r} {float(y)!r}" for x, y in ring) + "))")
    for jdt, tdt, npdt in DTYPES:
        je = jbuild(J.read_wkt(wkts), dtype=jdt)
        te = tbuild(T.read_wkt(wkts), dtype=tdt, device="cpu")
        _same(jp.edges_cross_matrix(je, je), tp.edges_cross_matrix(te, te))
        _same(jp.polygons_intersect(je, je), tp.polygons_intersect(te, te))
        _same(jp.polygon_contains_polygon(je, je),
              tp.polygon_contains_polygon(te, te))
        m = tp.polygons_intersect(te, te).numpy()
        assert m[0, 1] and m[0, n] and m[0, n + 1] and not m[0, 2]


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_broadcast_helpers(jdt, tdt, npdt):
    r = np.random.default_rng(23)
    p = r.uniform(-3, 3, (40, 1, 2)).astype(npdt)
    a = r.uniform(-3, 3, (1, 30, 2)).astype(npdt)
    b = r.uniform(-3, 3, (1, 30, 2)).astype(npdt)
    b[0, ::7] = a[0, ::7]
    rel = 1e-12 if npdt == np.float64 else 1e-5
    j = jm.point_segment_dist2(jnp.asarray(p), jnp.asarray(a),
                               jnp.asarray(b))
    t = tm.point_segment_dist2(*(torch.from_numpy(x) for x in (p, a, b)))
    _close(j, t, rel * np.abs(_np(j).astype(np.float64)) + 1e-300)
    q = r.uniform(-3, 3, (25, 2)).astype(npdt)
    j = jm.pairwise_point_distance(jnp.asarray(p[:, 0]), jnp.asarray(q))
    t = tm.pairwise_point_distance(torch.from_numpy(p[:, 0]),
                                   torch.from_numpy(q))
    _close(j, t, rel * np.abs(_np(j).astype(np.float64)) + 1e-300)
    # integer segments: touching, collinear overlaps, shared endpoints
    s = np.round(r.uniform(-3, 3, (4, 200, 2))).astype(npdt)
    j = jp.segments_intersect(*(jnp.asarray(x) for x in s))
    t = tp.segments_intersect(*(torch.from_numpy(x) for x in s))
    _same(j, t)
    _same(jp._orient(*(jnp.asarray(x) for x in s[:3])),
          tp._orient(*(torch.from_numpy(x) for x in s[:3])))


def test_haversine():
    r = np.random.default_rng(29)
    lat1, lat2 = r.uniform(-89, 89, (2, 500))
    lng1, lng2 = r.uniform(-180, 180, (2, 500))
    j = jm.haversine(*(jnp.asarray(x) for x in (lat1, lng1, lat2, lng2)))
    t = tm.haversine(*(torch.from_numpy(x) for x in (lat1, lng1, lat2,
                                                      lng2)))
    _close(j, t, 1e-12 * np.abs(_np(j)))
    d = float(tm.haversine(51.5074, -0.1278, 48.8566, 2.3522,
                           device="cpu"))
    assert d == pytest.approx(float(jm.haversine(51.5074, -0.1278, 48.8566,
                                                 2.3522)), rel=1e-12)
    assert 330 < d < 360
    assert tm.EARTH_RADIUS_M == jm.EARTH_RADIUS_M


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_points_block_and_edges_equal(jdt, tdt, npdt):
    arrs = (J.read_wkt(WKTS), T.read_wkt(WKTS))
    _same(jpoints(arrs[0], dtype=jdt), tpoints(arrs[1], dtype=tdt,
                                               device="cpu"))
    je = jbuild(arrs[0], dtype=jdt)
    te = tbuild(arrs[1], dtype=tdt, device="cpu")
    for f in ("a", "b", "mask"):
        _same(getattr(je, f), getattr(te, f))
    assert te.num_geoms == len(WKTS) and te.capacity == je.capacity
    # f64 coordinates round to nearest into float32, as jnp.asarray does
    x = np.array([[[0.1, 1 / 3], [2.0 ** -30 + 1, -74.123456789]]])
    y = torch.from_numpy(x).to(torch.float32).numpy()
    assert np.array_equal(y, x.astype(np.float32))


def _left_to_right(A, B, M, what, npdt):
    A, B = A.astype(npdt), B.astype(npdt)
    G, E = M.shape
    s = np.zeros(G, npdt)
    for e in range(E):
        if what == "area":
            s = s + np.where(M[:, e], A[:, e, 0] * B[:, e, 1] -
                             A[:, e, 1] * B[:, e, 0], npdt(0))
        else:
            # torch's CPU sqrt (MKL here) is not always correctly rounded;
            # the model takes the same sqrt, and sums in its own order
            d = B[:, e] - A[:, e]
            ln = torch.sqrt(torch.from_numpy(d[:, 0] * d[:, 0] +
                                             d[:, 1] * d[:, 1])).numpy()
            s = s + np.where(M[:, e], ln, npdt(0))
    if what == "area":
        v = npdt(0.5) * s
        return np.where((v > 0) | np.isnan(v), v, npdt(0))
    return s


@pytest.mark.parametrize("npdt,tdt", [(np.float64, torch.float64),
                                      (np.float32, torch.float32)])
def test_plain_sums_run_left_to_right(npdt, tdt):
    """The plain version's sums equal a numpy loop over the slots in
    order, bit for bit (the kernel's order), where a pairwise sum would
    round otherwise."""
    r = np.random.default_rng(31)
    G, E = 64, 64
    A = r.uniform(-1e3, 1e3, (G, E, 2)) * r.uniform(0, 1, (G, E, 1)) ** 8
    B = r.uniform(-1e3, 1e3, (G, E, 2))
    M = r.random((G, E)) < 0.9
    At, Bt = torch.from_numpy(A.astype(npdt)), torch.from_numpy(
        B.astype(npdt))
    for what in ("area", "length"):
        got = edge_measures(At, Bt, torch.from_numpy(M), what).numpy()
        assert np.array_equal(got, _left_to_right(A, B, M, what, npdt))
    eps, tiny = guards(tdt)
    assert eps == (1e-300 if npdt == np.float64 else 0.0)
    assert np.float32(tiny) == np.float32(1e-30)


def _centroid_bounds_model(A, B, M, what, npdt):
    """The centroid or the bounds by a numpy loop over the slots in order,
    every step rounded once in ``npdt`` (lengths through torch's sqrt)."""
    A, B = A.astype(npdt), B.astype(npdt)
    G, E = M.shape
    z = np.zeros(G, npdt)
    if what == "bounds":
        lo = [np.full(G, np.inf, npdt), np.full(G, np.inf, npdt)]
        hi = [np.full(G, -np.inf, npdt), np.full(G, -np.inf, npdt)]
        for e in range(E):
            for k in range(2):
                for v in (A[:, e, k], B[:, e, k]):
                    take = M[:, e] & ((v < lo[k]) | np.isnan(v))
                    lo[k] = np.where(take, v, lo[k])
                    take = M[:, e] & ((v > hi[k]) | np.isnan(v))
                    hi[k] = np.where(take, v, hi[k])
        return np.stack([lo[0], lo[1], hi[0], hi[1]], -1)
    S = {k: z for k in ("A", "L", "sx", "sy", "lx", "ly", "vx", "vy")}
    half = npdt(0.5)
    for e in range(E):
        m = M[:, e]
        ax, ay, bx, by = A[:, e, 0], A[:, e, 1], B[:, e, 0], B[:, e, 1]
        w = np.where(m, ax * by - ay * bx, z)
        dx, dy = bx - ax, by - ay
        ln = np.where(m, torch.sqrt(torch.from_numpy(dx * dx + dy * dy))
                      .numpy(), z)
        S["A"] = S["A"] + w
        S["L"] = S["L"] + ln
        S["sx"] = S["sx"] + (ax + bx) * w
        S["sy"] = S["sy"] + (ay + by) * w
        S["lx"] = S["lx"] + half * (ax + bx) * ln
        S["ly"] = S["ly"] + half * (ay + by) * ln
        S["vx"] = S["vx"] + np.where(m, ax, z)
        S["vy"] = S["vy"] + np.where(m, ay, z)
    eps = npdt(1e-300) if npdt == np.float64 else npdt(0)
    tiny = npdt(1e-30)
    n = M.sum(-1).astype(npdt)
    poly = np.stack([S["sx"], S["sy"]], -1) / (npdt(3) * S["A"] + eps)[:, None]
    line = np.stack([S["lx"], S["ly"]], -1) / (S["L"] + eps)[:, None]
    vert = np.stack([S["vx"], S["vy"]], -1) / (n + eps)[:, None]
    return np.where((np.abs(S["A"]) > tiny)[:, None], poly,
                    np.where((S["L"] > tiny)[:, None], line, vert))


@pytest.mark.parametrize("what", ["centroid", "bounds"])
@pytest.mark.parametrize("npdt,tdt", [(np.float64, torch.float64),
                                      (np.float32, torch.float32)])
def test_plain_centroid_bounds_run_left_to_right(what, npdt, tdt):
    """The plain version's centroid and bounds equal a numpy loop over the
    slots in order, bit for bit, on the random blocks of the sums' test
    and on the adversarial set's blocks of up to 33 slots (NaN, infinity,
    overflow, underflow, -0.0, every slot masked)."""
    r = np.random.default_rng(31)
    G, E = 64, 64
    A = r.uniform(-1e3, 1e3, (G, E, 2)) * r.uniform(0, 1, (G, E, 1)) ** 8
    B = r.uniform(-1e3, 1e3, (G, E, 2))
    M = r.random((G, E)) < 0.9
    sets = [(A.astype(npdt), B.astype(npdt), M)] + [
        (a, b, m) for _, a, b, m in
        measures_adversarial(np.dtype(npdt).name) if m.shape[1] <= 33]
    for a, b, m in sets:
        got = edge_measures(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(m), what).numpy()
        with np.errstate(all="ignore"):
            want = _centroid_bounds_model(a, b, m, what, npdt)
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)) or (
            np.array_equal(np.isnan(got), np.isnan(want)) and
            np.array_equal(got[~np.isnan(got)].view(np.uint8),
                           want[~np.isnan(want)].view(np.uint8)))


def _flush_subnormals(x):
    """x with its subnormal values replaced by zeros of their sign, as
    XLA's CPU backend reads them."""
    small = np.abs(x) < np.finfo(x.dtype).tiny
    return np.where(small, np.copysign(np.zeros_like(x), x), x)


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_adversarial_plain_against_jax(jdt, tdt, npdt):
    """The edge-measures adversarial set through both packages: bounds bit
    equal; area, length and centroid within the file's tolerances (their
    scales from the valid slots: a masked slot adds +0 to every sum), NaN
    and infinity placed alike; a NaN in a masked slot gives a NaN
    centroid in both.  XLA's CPU backend flushes float32 subnormals to
    zero, the port keeps them (test_f32_subnormals_kept_where_xla_flushes):
    here both packages take the set with its subnormals flushed, and in
    float32 the rows of coordinates near 1e-38 (kinds 9 and 10, whose sums
    and quotients pass through the subnormal range) are held to JAX by
    their bounds alone; the plain version is held bit for bit to the
    numpy loop on them (test_plain_centroid_bounds_run_left_to_right)."""
    kinds = 0
    for label, A, B, M in measures_adversarial(np.dtype(npdt).name):
        A, B = _flush_subnormals(A), _flush_subnormals(B)
        je, te = _pair(A, B, M, jdt, tdt)
        _same(jm.bounds(je), tm.bounds(te))
        keep = np.ones(len(M), bool) if npdt == np.float64 else \
            ~np.isin(np.arange(len(M)) % 12, (9, 10))
        valid = M[..., None]
        with np.errstate(all="ignore"):
            s_area, s_len, s_cen = _term_scales(
                np.where(valid, A, 0).astype(np.float64),
                np.where(valid, B, 0).astype(np.float64), M)
        for f, scale in (("area", s_area), ("length", s_len),
                         ("centroid", s_cen)):
            _close(_np(getattr(jm, f)(je))[keep],
                   getattr(tm, f)(te)[torch.from_numpy(keep)],
                   _tol(np.nan_to_num(scale, nan=np.inf)[keep], npdt))
        # a NaN end in a masked slot, in a row whose length picks the
        # area's or the length's branch, both of which multiply it by +0
        nan_masked = ((np.isnan(A) | np.isnan(B)).any(-1) & ~M).any(1)
        L = tm.length(te).numpy()
        rows = np.flatnonzero(nan_masked & np.isfinite(L) & (L > 1e-30))
        if rows.size:
            kinds += 1
            assert np.isnan(_np(jm.centroid(je))[rows]).any(1).all()
            assert np.isnan(tm.centroid(te).numpy()[rows]).any(1).all()
    # every shape but the one-slot rows, whose NaN slot is their only one
    assert kinds == len(MEASURES_ADV_SHAPES) - 1


def test_f32_subnormals_kept_where_xla_flushes():
    """A float32 subnormal coordinate: the port's bounds keep it, as IEEE
    arithmetic and the card do; XLA's CPU backend reads it as 0."""
    sub = np.float32(-3e-39)
    A = np.array([[[1.0, sub]]], np.float32)
    B = np.array([[[2.0, 1.0]]], np.float32)
    M = np.array([[True]])
    je, te = _pair(A, B, M, jnp.float32, torch.float32)
    assert tm.bounds(te).numpy()[0, 1] == sub
    assert _np(jm.bounds(je))[0, 1] == 0.0


def test_launch_plan_by_slot_class():
    """Staged tiles for the slot counts up to 32 at 32,768 rows and more,
    a warp a geometry for every other class; the constants are the
    kernel source's."""
    src = (em._kernels.CSRC / "edge_measures.cu").read_text()
    assert f"kStagedSlots = {em.STAGED_SLOTS};" in src
    assert f"kStagedRows = {em.STAGED_ROWS};" in src
    for E in (0, 1, 3, 8, 16, 32, 33, 64, 1024, 4096):
        for G in (1, 3136, 16384, em.STAGED_ROWS - 1, em.STAGED_ROWS,
                  1 << 20):
            want = "staged" if E <= 32 and G >= 32768 else "warp"
            assert launch_plan(G, E) == want, (G, E)
    assert launch_plan(1 << 20, 8) == "staged"       # the footprints
    assert launch_plan(3136, 32) == "warp"           # the counties


def test_wrappers_launch_nothing_on_cpu_and_check_inputs():
    A, B, M = _blocks_random()
    a, b, m = (torch.from_numpy(x) for x in (A, B, M))
    before = (edge_measures.launches, edge_point_query.launches,
              edges_cross.launches)
    edge_measures(a, b, m, "centroid")
    edge_point_query(a[:, 0], a, b, m, count=True, dist=True)
    edges_cross(a, b, m, a, b, m)
    # any contiguous view, an unaligned one too, any slot count and either
    # mapping: the plain version, with no launch and no error
    for _, A3, B3, M3 in measures_adversarial()[:2]:      # E = 1 and 3
        for view in MEASURES_ADV_VIEWS:
            a3, b3 = (measures_view(x, view, torch.float64, "cpu")
                      for x in (A3, B3))
            m3 = measures_view(M3, view, None, "cpu")
            want = edge_measures_ref(*(torch.from_numpy(x)
                                       for x in (A3, B3, M3)), "centroid")
            for path in (None, "staged", "warp"):
                got = edge_measures(a3, b3, m3, "centroid", path=path)
                assert torch.equal(got.isnan(), want.isnan())
                assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert (edge_measures.launches, edge_point_query.launches,
            edges_cross.launches) == before
    with pytest.raises(ValueError):
        edge_measures(a, b, m, "area", path="tiles")
    with pytest.raises(ValueError):
        edge_measures(a, b, m, "volume")
    with pytest.raises(ValueError):
        edge_measures(a, b.float(), m, "area")
    with pytest.raises(ValueError):
        edge_measures(a, b, m[:, :3], "area")
    with pytest.raises(ValueError):
        edge_point_query(a[:, 0].float(), a, b, m)
    with pytest.raises(ValueError):
        edge_point_query(a[:, 0], a, b, m, count=False, dist=False)
    with pytest.raises(ValueError):
        edges_cross(a, b, m, a.float(), b.float(), m)
    with pytest.raises(ValueError, match="one type"):
        tp.crossing_number(np.zeros((2, 2), np.float32),
                           TBlocks(a, b, m))
