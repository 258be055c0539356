"""Native C++ kernels of the PyTorch port (mosaic_tpu_torch.native).

The port compiles its own copy of geokernels.cpp with g++ at first use.
On the same inputs its ``pip_first_match`` and ``recheck_zones`` equal
their numpy versions in ``parallel/pip_join.py`` and the JAX package's
native library exactly (integer zone ids: no tolerance).  The dense host
recheck through the native kernel equals its numpy version and the
polygon oracle on every point (the analogue of
tests/test_dense_pip.py::test_vectorized_recheck_equals_polygon_loop),
and falls back to numpy only where the reference does: more than 16 zone
slots per cell.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu import native as jnative
from mosaic_tpu.bench.workloads import build_workload as jbuild
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu_torch import native
from mosaic_tpu_torch.bench.workloads import build_workload, nyc_points
from mosaic_tpu_torch.parallel import pip_join as tpj


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def taxi():
    polys, grid, res = build_workload(n_side=4, grid_name="H3",
                                      zones="taxi")
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    assert isinstance(idx, tpj.DensePIPIndex)
    return polys, grid, res, idx


def test_library_builds_from_the_port_copy():
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.read_bytes() != b""
    native.build()
    assert native.lib_path().exists()
    assert native.lib_path().parent == native.BUILD_DIR
    assert native.get_lib() is native.get_lib()


def test_pip_first_match_three_ways(taxi):
    polys = taxi[0]
    jpolys = jbuild(n_side=4, grid_name="H3", zones="taxi")[0]
    pts = nyc_points(20_000, seed=21)
    # points on polygon vertices exercise the half-open rule
    flat, gs = tpj._oracle_edges(polys)
    pts = np.concatenate([pts, flat[::7, :2], flat[::11, 2:]])
    calls = native.pip_first_match.calls
    ours = native.pip_first_match(pts, flat, gs)
    assert native.pip_first_match.calls == calls + 1
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, tpj.pip_host_truth_np(pts, polys))
    np.testing.assert_array_equal(ours, jnative.pip_first_match(pts, flat,
                                                                gs))
    np.testing.assert_array_equal(ours, tpj.pip_host_truth(pts, polys))
    np.testing.assert_array_equal(ours, jpj.pip_host_truth(pts, jpolys))
    assert np.mean(ours >= 0) > 0.9


def test_pip_first_match_rejects_bad_offsets():
    flat = np.zeros((3, 4))
    with pytest.raises(ValueError, match="CSR"):
        native.pip_first_match(np.zeros((2, 2)), flat, np.array([0, 2]))
    empty = native.pip_first_match(np.zeros((2, 2)), np.zeros((0, 4)),
                                   np.array([0]))
    np.testing.assert_array_equal(empty, [-1, -1])


def test_recheck_zones_three_ways(taxi):
    idx = taxi[3]
    aux = idx.aux
    Z = int(idx.gzones.shape[1])
    G = len(aux["gstart"]) - 1
    rng = np.random.default_rng(5)
    # each point tested against a random group near its own chips: half
    # the points at group edges' midpoints, half uniform over the groups
    g = rng.integers(0, G, 4000)
    mid = 0.5 * (aux["flat_a"][aux["gstart"][g]] +
                 aux["flat_b"][aux["gstart"][g]])
    pts = mid + rng.normal(0, 2e-4, mid.shape)
    flat = np.concatenate([aux["flat_a"], aux["flat_b"]], axis=1)
    ez = aux["edge_zslot"].astype(np.int32)
    gz = aux["gzones64"].astype(np.int32)
    grp = np.where(rng.random(len(g)) < 0.1, -1, g)
    ours = native.recheck_zones(pts, grp, flat, ez, aux["gstart"], gz,
                                tpj.EPS_EDGE_DEG)[0]
    theirs = jnative.recheck_zones(pts, grp, flat, ez, aux["gstart"], gz)
    np.testing.assert_array_equal(ours, theirs)
    keep = grp >= 0
    assert np.all(ours[~keep] == -1)
    np.testing.assert_array_equal(
        ours[keep], tpj.dense_recheck_np(pts[keep], grp[keep], aux, Z,
                                         tpj.EPS_EDGE_DEG)[0])
    assert np.mean(ours[keep] >= 0) > 0.3
    with pytest.raises(ValueError, match="16 zone slots"):
        native.recheck_zones(pts, grp, flat, ez, aux["gstart"],
                             np.zeros((G, 17), np.int32), tpj.EPS_EDGE_DEG)


def test_recheck_zones_near_flag_equals_numpy(taxi):
    """The near-edge flag the dense recheck's fallback reads: points on
    and a hair beside their group's edges, against the numpy version's
    point-to-segment distance; the zones equal the JAX package's native
    recheck's."""
    idx = taxi[3]
    aux = idx.aux
    Z = int(idx.gzones.shape[1])
    G = len(aux["gstart"]) - 1
    rng = np.random.default_rng(6)
    g = rng.integers(0, G, 3000)
    e = aux["gstart"][g] + rng.integers(0, 2, len(g))
    t = rng.random(len(g))[:, None]
    on = aux["flat_a"][e] + t * (aux["flat_b"][e] - aux["flat_a"][e])
    step = rng.choice([0.0, 3e-7, 9e-7, 1.1e-6, 5e-6], len(g))
    pts = on + step[:, None] * rng.choice([-1.0, 1.0], (len(g), 2))
    flat = np.concatenate([aux["flat_a"], aux["flat_b"]], axis=1)
    ez = aux["edge_zslot"].astype(np.int32)
    gz = aux["gzones64"].astype(np.int32)
    zone, near = native.recheck_zones(pts, g, flat, ez, aux["gstart"], gz,
                                      tpj.EPS_EDGE_DEG)
    assert near.dtype == bool
    np.testing.assert_array_equal(
        zone, jnative.recheck_zones(pts, g, flat, ez, aux["gstart"], gz))
    np_zone, np_near = tpj.dense_recheck_np(pts, g, aux, Z,
                                            tpj.EPS_EDGE_DEG)
    np.testing.assert_array_equal(zone, np_zone)
    np.testing.assert_array_equal(near, np_near)
    assert near[step == 0].all() and near.mean() < 0.95
    assert not near[step == 5e-6].all()


def test_native_dense_recheck_equals_numpy_and_polygons(taxi):
    polys, grid, _, idx = taxi
    pts = nyc_points(30_000, seed=5)
    fn = tpj.make_pip_join_fn(idx, grid)
    zone, _ = fn(torch.from_numpy(tpj.localize(idx, pts)))
    zone = zone.numpy()
    all_on = np.ones(len(pts), bool)
    calls = native.recheck_zones.calls
    via_native = tpj.host_recheck_fn(idx)(pts, zone.copy(), all_on)
    assert native.recheck_zones.calls == calls + 1
    via_numpy = tpj.host_recheck_fn(_widened(idx, 17))(
        pts, zone.copy(), all_on)
    assert native.recheck_zones.calls == calls + 1
    via_polys = tpj.host_recheck(pts, zone.copy(), all_on, polys)
    np.testing.assert_array_equal(via_native, via_numpy)
    np.testing.assert_array_equal(via_native, via_polys)


def _widened(idx, Z: int):
    """The same dense index with its zone slots padded to ``Z`` (same
    zones): past 16 slots its recheck takes ``dense_recheck_np``."""
    pad = Z - int(idx.gzones.shape[1])
    tables = {k: getattr(idx, k).numpy() for k in
              ("entry", "pool", "gzones", "gwide")}
    tables.update({k: getattr(idx, k) for k in
                   ("origin", "face0", "a0", "b0", "W", "H", "res",
                    "err_lattice", "n_zones", "ext_deg")})
    tables["gzones"] = np.pad(tables["gzones"], ((0, 0), (0, pad)),
                              constant_values=-1)
    aux = dict(idx.aux)
    aux["gzones64"] = np.pad(aux["gzones64"], ((0, 0), (0, pad)),
                             constant_values=-1)
    tables["aux"] = aux
    return tpj.dense_index_from_arrays(tables, device="cpu")


def test_wide_zone_slots_take_the_numpy_recheck(taxi):
    """More than 16 zone slots per cell: the reference's one dispatch to
    numpy; same zones as the 4-slot index."""
    polys, grid, _, idx = taxi
    wide = _widened(idx, 17)
    assert int(wide.gzones.shape[1]) == 17
    pts = nyc_points(5_000, seed=8)
    zone = np.full(len(pts), -1, np.int32)
    flags = np.ones(len(pts), bool)
    calls = native.recheck_zones.calls
    got = tpj.host_recheck_fn(wide)(pts, zone, flags)
    assert native.recheck_zones.calls == calls
    np.testing.assert_array_equal(got, tpj.host_recheck_fn(idx)(pts, zone,
                                                                flags))


def _area_pools(pairs):
    """Region-left edge pools (port's clip helpers) of each pair's two
    polygons, one pool slot per pair and side."""
    from mosaic_tpu_torch.core.geometry.clip import (_edges_of,
                                                     _normalize_rings)
    pools = ([_edges_of(_normalize_rings(a)) for a, _ in pairs],
             [_edges_of(_normalize_rings(b)) for _, b in pairs])
    out = []
    for pool in pools:
        off = np.cumsum([0] + [len(e) for e in pool])
        out += [np.concatenate(pool).reshape(-1, 4), off,
                np.arange(len(pairs))]
    return out


def _square(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float)


def test_intersect_area_pairs_against_jax_native():
    """The new binding equals the JAX package's native library on the same
    flat edge pools, NaN included: the sawtooth's 600 edges split one
    strip edge past the kernel's buffer."""
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(40):
        c = rng.uniform(-1, 1, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        star = c + rng.uniform(0.3, 0.6, (7, 1)) * np.stack(
            [np.cos(ang), np.sin(ang)], -1)
        pairs.append(([star], [_square(*(c - 0.2), *(c + 0.3))]))
    pairs.append(([_square(0, 0, 4, 4), _square(1, 1, 3, 3)[::-1]],
                  [_square(1.5, 1.5, 2.5, 2.5)]))
    k = np.arange(601)
    saw = np.stack([k / 6.0, np.where(k % 2, 0.5, -0.5)], -1)
    pairs.append(([_square(0, 0, 100, 1)],
                  [np.vstack([saw, [[100, -2], [0, -2]]])]))
    args = _area_pools(pairs)
    calls = native.intersect_area_pairs.calls
    ours = native.intersect_area_pairs(*args, 1e-9)
    assert native.intersect_area_pairs.calls == calls + 1
    theirs = jnative.intersect_area_pairs(*args, 1e-9)
    np.testing.assert_array_equal(ours, theirs)
    assert np.isnan(ours[-1]) and not np.isnan(ours[:-1]).any()
    assert ours[-2] == 0.0 and np.sum(ours[:-2] > 0) > 20


def test_intersect_area_pairs_rejects_bad_pools():
    ea, oa, ia, eb, ob, ib = _area_pools([([_square(0, 0, 1, 1)],
                                           [_square(0, 0, 2, 2)])])
    with pytest.raises(ValueError, match="CSR"):
        native.intersect_area_pairs(ea, oa[:-1], ia, eb, ob, ib)
    with pytest.raises(ValueError, match="outside the pool"):
        native.intersect_area_pairs(ea, oa, ia + 1, eb, ob, ib)
    with pytest.raises(ValueError, match="length"):
        native.intersect_area_pairs(ea, oa, ia, eb, ob, ib[:0])
    np.testing.assert_allclose(
        native.intersect_area_pairs(ea, oa, ia, eb, ob, ib), [1.0])
