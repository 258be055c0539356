"""The point-query (K12) and edge-crossing (K13) plain versions against the
JAX package on the cases their redesigned kernels must keep, and the
wrappers' host-side pieces.

The JAX ``EdgeBlocks`` are built directly from the same seeded numpy
arrays as the port's, so nothing of ``build_edges`` lies between them.
The cases: non-prefix masks of three densities with all-masked rows,
small integer coordinates (shared, reversed, collinear and touching
edges, horizontal and zero-length ones) with NaN ends, points on vertices
and on edges; capacity 512; and nearly collinear disjoint segments whose
orientations are rounding noise, so that the plain version, like the JAX
body, calls some of them crossing (no bbox filter may skip them).
``tests/test_torch_measures.py`` covers ``build_edges``' blocks.  The
port's wrappers run their plain versions here (CPU tensors).

Tolerances: crossing counts, containment and the edge-crossing matrix
bit-equal in float64 and float32; distances within 1e-12 relative in
float64 and 1e-5 in float32, +inf and NaN in the same places, as in
``tests/test_torch_measures.py`` (XLA orders and fuses the distance's
arithmetic its own way).  The tile choice is held to a plain walk over
the candidate tiles, and the wrappers' tile constants to the kernels'
sources.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.geometry import measures as jm
from mosaic_tpu.core.geometry import predicates as jp
from mosaic_tpu.core.geometry.padded import EdgeBlocks as JBlocks
from mosaic_tpu_torch.core.geometry import measures as tm
from mosaic_tpu_torch.core.geometry import predicates as tp
from mosaic_tpu_torch.core.geometry.padded import EdgeBlocks as TBlocks
from mosaic_tpu_torch.ops import edge_point, edges_cross as ec
from mosaic_tpu_torch.ops.edge_point import (edge_point_query,
                                             edge_point_query_ref)
from mosaic_tpu_torch.ops.edges_cross import (cross_tile, edges_cross,
                                              edges_cross_ref)

CSRC = Path(edge_point.__file__).resolve().parent.parent / "csrc"

DTYPES = [(jnp.float64, torch.float64, np.float64),
          (jnp.float32, torch.float32, np.float32)]


def _blocks(seed: int, G: int, E: int):
    """Seeded A, B [G, E, 2] and M [G, E]: integer coordinates, horizontal,
    zero-length, copied and reversed edges, a third of the rows jittered,
    non-prefix masks with all-masked rows, NaN ends."""
    r = np.random.default_rng(seed)
    A = r.integers(-6, 7, (G, E, 2)).astype(np.float64)
    B = A + r.integers(-3, 4, (G, E, 2))
    kind = r.random((G, E))
    B[..., 1] = np.where(kind < 0.2, A[..., 1], B[..., 1])
    B = np.where((kind > 0.92)[..., None], A, B)
    dst = r.integers(0, G * E, G * E // 4)
    src = r.integers(0, G * E, dst.size)
    flip = r.random(dst.size) < 0.5
    fa, fb = A.reshape(-1, 2), B.reshape(-1, 2)
    sa, sb = fa[src].copy(), fb[src].copy()
    fa[dst] = np.where(flip[:, None], sb, sa)
    fb[dst] = np.where(flip[:, None], sa, sb)
    jit = r.random(G) < 0.3
    A[jit] += r.uniform(-0.5, 0.5, A[jit].shape)
    B[jit] += r.uniform(-0.5, 0.5, B[jit].shape)
    M = r.random((G, E)) < r.choice([0.05, 0.4, 0.9], G)[:, None]
    M[::5] = False
    rows, slot = np.arange(G), r.integers(0, E, G)
    A[rows[1::4], slot[1::4], 0] = np.nan
    B[rows[3::4], slot[3::4], 1] = np.nan
    return A, B, M


def _points(seed: int, N: int, A, B):
    """Vertices, the integer grid, half-integers, reals and NaN."""
    r = np.random.default_rng(seed)
    ends = np.concatenate([A.reshape(-1, 2), B.reshape(-1, 2)])
    ends = ends[~np.isnan(ends).any(1)]
    P = np.where((r.random(N) < 0.3)[:, None],
                 ends[r.integers(0, len(ends), N)],
                 r.integers(-7, 8, (N, 2)).astype(np.float64))
    P[r.random(N) < 0.2] += 0.5
    real = r.random(N) < 0.2
    P[real] = r.uniform(-7, 7, (int(real.sum()), 2))
    P[:3] = np.nan
    return P


def _collinear(seed: int, n: int):
    """n disjoint segment pairs on lines through the origin, one segment
    on each side, the inner ends within 1e-9 to 1e-3 of it: (a1, b1, a2,
    b2) as [n, 1, 2] blocks."""
    r = np.random.default_rng(seed)
    v = r.normal(0.0, 1.0, (n, 2))
    s = np.stack([-r.uniform(1, 10, n), -10 ** r.uniform(-9, -3, n),
                  10 ** r.uniform(-9, -3, n), r.uniform(1, 10, n)], 1)
    p = s[..., None] * v[:, None, :]
    return tuple(p[:, k, None, :] for k in range(4))


def _pair(A, B, M, jdt, tdt, npdt):
    A, B = A.astype(npdt), B.astype(npdt)
    return (JBlocks(jnp.asarray(A, jdt), jnp.asarray(B, jdt), jnp.asarray(M)),
            TBlocks(torch.from_numpy(A).to(tdt), torch.from_numpy(B).to(tdt),
                    torch.from_numpy(M)))


def _same(j, t):
    j, t = np.asarray(j), t.numpy()
    assert j.shape == t.shape and np.array_equal(j, t, equal_nan=True), \
        np.argwhere(~((j == t) | (np.isnan(j) & np.isnan(t))))[:10]


def _close(j, t, npdt):
    """Within 1e-12 (f64) or 1e-5 (f32) relative, NaN and inf alike."""
    j, t = np.asarray(j).astype(np.float64), t.numpy().astype(np.float64)
    assert j.shape == t.shape
    assert np.array_equal(np.isnan(j), np.isnan(t))
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t))
    assert np.array_equal(j[~fin & ~np.isnan(j)], t[~fin & ~np.isnan(t)])
    rel = 1e-12 if npdt == np.float64 else 1e-5
    bad = np.abs(j[fin] - t[fin]) > rel * np.abs(j[fin]) + 1e-300
    assert not bad.any(), (j[fin][bad][:5], t[fin][bad][:5])


#: (label, seed, N points, G geometries, E slots)
QUERY_CASES = [("non-prefix masks", 11, 97, 33, 8),
               ("capacity 512", 12, 65, 3, 512)]


@pytest.mark.parametrize("label,seed,N,G,E", QUERY_CASES)
@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_point_queries_match_jax(label, seed, N, G, E, jdt, tdt, npdt):
    A, B, M = _blocks(seed, G, E)
    je, te = _pair(A, B, M, jdt, tdt, npdt)
    P = _points(seed + 100, N, A, B).astype(npdt)
    jpts, tpts = jnp.asarray(P), torch.from_numpy(P)
    _same(jp.crossing_number(jpts, je), tp.crossing_number(tpts, te))
    ji, jd = jp.points_in_polygons(jpts, je, with_boundary_dist=True)
    ti, td = tp.points_in_polygons(tpts, te, with_boundary_dist=True)
    _same(ji, ti)
    _close(jd, td, npdt)
    _close(jm.distance_points_to_geoms(jpts, je),
           tm.distance_points_to_geoms(tpts, te), npdt)
    # the case has what it is meant to have: a masked slot before a valid
    # one, empty rows, NaN distances, points on an edge (distance 0)
    assert (np.diff(M.astype(int), axis=1) > 0).any() and not M[0].any()
    d = td.numpy()
    assert np.isnan(d).any() and (d == 0).any() and np.isinf(d).any()


#: (label, seed, G1, E1, G2, E2)
CROSS_CASES = [("non-prefix masks", 21, 33, 8, 17, 32),
               ("capacity 512", 22, 3, 512, 2, 512)]


@pytest.mark.parametrize("label,seed,G1,E1,G2,E2", CROSS_CASES)
@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_edges_cross_matches_jax(label, seed, G1, E1, G2, E2, jdt, tdt,
                                 npdt):
    j1, t1 = _pair(*_blocks(seed, G1, E1), jdt, tdt, npdt)
    j2, t2 = _pair(*_blocks(seed + 1, G2, E2), jdt, tdt, npdt)
    m = tp.edges_cross_matrix(t1, t2)
    _same(jp.edges_cross_matrix(j1, j2), m)
    _same(jp.polygons_intersect(j1, j2), tp.polygons_intersect(t1, t2))
    assert m.any() and not m.all()


@pytest.mark.parametrize("jdt,tdt,npdt", DTYPES)
def test_collinear_disjoint_segments_cross_as_in_jax(jdt, tdt, npdt):
    """The segments of pair i never meet, yet their rounded orientations
    pass the proper test for some i: both packages answer true there."""
    a1, b1, a2, b2 = _collinear(31, 1024)
    one = np.ones((1024, 1), bool)
    j1, t1 = _pair(a1, b1, one, jdt, tdt, npdt)
    j2, t2 = _pair(a2, b2, one, jdt, tdt, npdt)
    m = tp.edges_cross_matrix(t1, t2)
    _same(jp.edges_cross_matrix(j1, j2), m)
    assert int(m.diagonal().sum()) >= 1
    assert torch.equal(m, edges_cross(t1.a, t1.b, t1.mask, t2.a, t2.b,
                                      t2.mask))


def _tile_walk(E: int, slots: int) -> int:
    """The largest of 1, 2, 4, ..., MAX_TILE geometries whose slots fit
    ``slots``, by trying each; 1 when none does."""
    best = 1
    for t in (1, 2, 4, 8, 16, 32, 64):
        if t <= ec.MAX_TILE and t * E <= slots:
            best = t
    return best


@pytest.mark.parametrize("slots", ec.SLOTS)
def test_cross_tile_is_the_largest_fitting_tile(slots):
    for E in range(0, 1600):
        t = cross_tile(E, slots)
        assert t == _tile_walk(E, slots), E
        assert t * E <= slots or t == 1


def test_tile_constants_match_the_kernels():
    src13 = (CSRC / "edges_cross.cu").read_text()
    got = {k: int(re.search(rf"constexpr int {k} = (\d+);", src13).group(1))
           for k in ("kSlots1", "kSlots2", "kMaxTile")}
    assert (got["kSlots1"], got["kSlots2"]) == ec.SLOTS
    assert got["kMaxTile"] == ec.MAX_TILE
    src12 = (CSRC / "edge_point_query.cu").read_text()
    pts = int(re.search(r"constexpr int kPts = (\d+);", src12).group(1))
    geoms = int(re.search(r"constexpr int kTileGeoms = (\d+);",
                          src12).group(1))
    assert (32 * pts, geoms) == (edge_point.TILE_POINTS,
                                 edge_point.TILE_GEOMS)


def test_wrappers_run_the_plain_versions_on_cpu_and_check_inputs():
    A, B, M = _blocks(41, 9, 16)
    a, b, m = (torch.from_numpy(x) for x in (A, B, M))
    p = torch.from_numpy(_points(42, 20, A, B))
    before = (edge_point_query.launches, edges_cross.launches)
    for cnt, dst in ((True, True), (True, False), (False, True)):
        got = edge_point_query(p, a, b, m, cnt, dst)
        ref = edge_point_query_ref(p, a, b, m, cnt, dst)
        for g, r in zip(got, ref):
            assert (g is None and r is None) or \
                np.array_equal(g.numpy(), r.numpy(), equal_nan=True)
    assert torch.equal(edges_cross(a, b, m, a[:4], b[:4], m[:4]),
                       edges_cross_ref(a, b, m, a[:4], b[:4], m[:4]))
    assert (edge_point_query.launches, edges_cross.launches) == before
    with pytest.raises(ValueError):
        edge_point_query(p[:, :1], a, b, m)
    with pytest.raises(ValueError):
        edge_point_query(p, a, b, m.to(torch.uint8))
    with pytest.raises(ValueError):
        edge_point_query(p.to("meta"), a.to("meta"), b.to("meta"),
                         m.to("meta"))
    with pytest.raises(ValueError):
        edges_cross(a, b, m[:, :3], a, b, m)
    with pytest.raises(ValueError):
        edges_cross(a, b, m, a.float(), b.float(), m)
    with pytest.raises(ValueError):
        edges_cross(a.to("meta"), b.to("meta"), m.to("meta"),
                    a.to("meta"), b.to("meta"), m.to("meta"))
