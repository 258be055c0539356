"""BNG and CUSTOM grids of the PyTorch port against the JAX package's.

* ``mosaic_tpu_torch.core.index.bng`` equals ``mosaic_tpu.core.index.bng``
  on ids at every resolution, string format and parse, k-ring and
  k-loop, centers, boundaries, validity and candidate cells (integer ids
  and exact f64 geometry: no tolerance).
* The device hooks ``point_to_cell_torch(_margin)`` and
  ``point_in_bounds_torch`` equal the JAX package's ``*_jax`` hooks bit
  for bit, on f64 and on f32 inputs, for BNG and for CUSTOM grids with
  negative coordinates and points out of bounds; the BNG hook equals the
  host ids (tests/test_bng.py::test_jax_kernel_matches_host).
* ``get_index_system("BNG")`` works, and the sorted PIP join on each row
  of tests/test_bng.py's GRIDS equals the exact oracle and the JAX
  package's final zones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.geometry.wkt import read_wkt as jread_wkt
from mosaic_tpu.core.index.bng import BNGIndexSystem as JBNG
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu_torch.core.geometry.wkt import read_wkt
from mosaic_tpu_torch.core.index.bng import BNGIndexSystem
from mosaic_tpu_torch.core.index.factory import get_index_system
from mosaic_tpu_torch.parallel import pip_join as tpj

RESOLUTIONS = [1, 2, 3, 4, 5, 6, -1, -2, -3, -4, -5, -6]

GRIDS = [
    ("BNG", 3, (100_000, 100_000, 200_000, 200_000)),
    ("CUSTOM(0,16,0,16,2,1,1)", 2, (0, 0, 16, 16)),
    ("H3", 7, (-74.1, 40.6, -73.9, 40.8)),
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bngs():
    return BNGIndexSystem(), JBNG()


def bng_points(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, 700_000, n),
                    rng.uniform(0, 1_300_000, n)], -1)
    # whole metres and cell corners, where floor and mod flip
    pts[: n // 4] = np.round(pts[: n // 4], -3)
    return pts


def test_factory_gives_bng():
    assert isinstance(get_index_system("BNG"), BNGIndexSystem)
    assert get_index_system("bng").name == "BNG"


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_host_side_equals_jax(bngs, res):
    ours, theirs = bngs
    pts = bng_points(2000, seed=abs(res) + (res < 0) * 10)
    ids = ours.point_to_cell(pts, res)
    np.testing.assert_array_equal(ids, theirs.point_to_cell(pts, res))
    names = ours.format_cell_id(ids)
    assert names == theirs.format_cell_id(ids)
    np.testing.assert_array_equal(ours.parse_cell_id(names),
                                  theirs.parse_cell_id(names))
    np.testing.assert_array_equal(ours.parse_cell_id(names), ids)
    np.testing.assert_array_equal(ours.resolution_of(ids),
                                  theirs.resolution_of(ids))
    np.testing.assert_array_equal(ours.cell_center(ids),
                                  theirs.cell_center(ids))
    for a, b in zip(ours.cell_boundary(ids), theirs.cell_boundary(ids)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.is_valid_cell(ids),
                                  theirs.is_valid_cell(ids))
    np.testing.assert_array_equal(ours.cell_area(ids),
                                  theirs.cell_area(ids))
    few = ids[:40]
    np.testing.assert_array_equal(ours.k_ring(few, 2), theirs.k_ring(few, 2))
    np.testing.assert_array_equal(ours.k_loop(few, 1), theirs.k_loop(few, 1))
    np.testing.assert_array_equal(ours.grid_distance(few, few[::-1]),
                                  theirs.grid_distance(few, few[::-1]))
    if abs(res) <= 3:
        bbox = np.array([120_000.0, 130_000.0, 480_000.0, 510_000.0])
        np.testing.assert_array_equal(ours.candidate_cells(bbox, res),
                                      theirs.candidate_cells(bbox, res))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("res", RESOLUTIONS)
def test_device_hooks_equal_jax(bngs, res, dtype):
    ours, theirs = bngs
    pts = np.concatenate([bng_points(3000, seed=7),
                          [[-5.0, 10.0], [700_000.0, 1_300_000.0],
                           [350_000.5, -0.25], [700_001.0, 5.0]]]).astype(
        dtype)
    c, m = ours.point_to_cell_torch_margin(torch.from_numpy(pts), res)
    jc, jm = theirs.point_to_cell_jax_margin(jnp.asarray(pts), res)
    assert c.dtype == torch.int64 and m.dtype == torch.from_numpy(pts).dtype
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        ours.point_in_bounds_torch(torch.from_numpy(pts)).numpy(),
        np.asarray(theirs.point_in_bounds_jax(jnp.asarray(pts))))
    np.testing.assert_array_equal(
        ours.point_to_cell_torch(torch.from_numpy(pts), res).numpy(),
        c.numpy())


def test_device_hook_matches_host(bngs):
    """tests/test_bng.py::test_jax_kernel_matches_host and the res -1
    blocks of test_res_minus_one_blocks, on the port's hook."""
    ours, _ = bngs
    rng = np.random.default_rng(42)
    pts = np.stack([rng.uniform(0, 700_000, 500),
                    rng.uniform(0, 1_300_000, 500)], -1)
    for res in (2, 4, -3, -5):
        np.testing.assert_array_equal(
            ours.point_to_cell(pts, res),
            ours.point_to_cell_torch(torch.from_numpy(pts), res).numpy())
    blocks = np.array([[100.0, 100.0], [600_000.0, 100.0],
                       [100.0, 600_000.0], [600_000.0, 600_000.0],
                       [100.0, 1_100_000.0], [600_000.0, 1_100_000.0]])
    ids = ours.point_to_cell(blocks, -1)
    assert ours.format_cell_id(ids) == ["S", "T", "N", "O", "H", "J"]
    np.testing.assert_array_equal(
        ours.point_to_cell_torch(torch.from_numpy(blocks), -1).numpy(), ids)
    with pytest.raises(ValueError, match="resolution"):
        ours.point_to_cell_torch(torch.from_numpy(blocks), 0)


CUSTOMS = ["CUSTOM(-180,180,-90,90,2,360,180)",
           "CUSTOM(-75,-73,40,42,2,2,2)",
           "CUSTOM(-1000.5,250,-30,-10,3,50,10)"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", CUSTOMS)
def test_custom_hooks_equal_jax(name, dtype):
    ours, theirs = get_index_system(name), jget(name)
    c = ours.conf
    rng = np.random.default_rng(11)
    w, h = c.bound_x_max - c.bound_x_min, c.bound_y_max - c.bound_y_min
    pts = np.stack([rng.uniform(c.bound_x_min - 0.1 * w,
                                c.bound_x_max + 0.1 * w, 4000),
                    rng.uniform(c.bound_y_min - 0.1 * h,
                                c.bound_y_max + 0.1 * h, 4000)], -1)
    corners = np.array([[c.bound_x_min, c.bound_y_min],
                        [c.bound_x_max, c.bound_y_max],
                        [c.bound_x_min, c.bound_y_max]])
    pts = np.concatenate([pts, corners]).astype(dtype)
    for res in (0, 1, 3, 6):
        cells, m = ours.point_to_cell_torch_margin(torch.from_numpy(pts),
                                                   res)
        jc, jm = theirs.point_to_cell_jax_margin(jnp.asarray(pts), res)
        np.testing.assert_array_equal(cells.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        if dtype == np.float64:
            np.testing.assert_array_equal(cells.numpy(),
                                          ours.point_to_cell(pts, res))
    inb = ours.point_in_bounds_torch(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(
        inb, np.asarray(theirs.point_in_bounds_jax(jnp.asarray(pts))))
    assert 0.5 < inb.mean() < 1.0


def _poly(domain, reader):
    """tests/test_bng.py TestBackendMatrix._poly."""
    x0, y0, x1, y1 = domain
    w, h = x1 - x0, y1 - y0
    ring = [(x0 + 0.2 * w, y0 + 0.2 * h), (x0 + 0.8 * w, y0 + 0.25 * h),
            (x0 + 0.7 * w, y0 + 0.8 * h), (x0 + 0.4 * w, y0 + 0.6 * h),
            (x0 + 0.2 * w, y0 + 0.75 * h), (x0 + 0.2 * w, y0 + 0.2 * h)]
    return reader(["POLYGON((" + ", ".join(f"{x} {y}" for x, y in ring)
                   + "))"])


@pytest.mark.parametrize("name,res,domain", GRIDS,
                         ids=[g[0].split("(")[0] for g in GRIDS])
def test_pip_join_parity(name, res, domain):
    """tests/test_bng.py::TestBackendMatrix::test_pip_join_parity through
    both packages: final zones equal the oracle and each other."""
    grid, polys = get_index_system(name), _poly(domain, read_wkt)
    jgrid, jpolys = jget(name), _poly(domain, jread_wkt)
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    if name != "H3":
        assert isinstance(idx, tpj.PIPIndex)
        assert tpj.LAST_DENSE_REJECT == "non_h3_grid"
    x0, y0, x1, y1 = domain
    rng = np.random.default_rng(42)
    pts = np.stack([rng.uniform(x0, x1, 3000),
                    rng.uniform(y0, y1, 3000)], -1)
    z, u = tpj.make_pip_join_fn(idx, grid)(
        torch.from_numpy(tpj.localize(idx, pts)))
    final = tpj.host_recheck_fn(idx, polys)(pts, z.numpy(), u.numpy())
    truth = tpj.pip_host_truth(pts, polys)
    np.testing.assert_array_equal(final, truth)
    assert 0.2 < np.mean(truth >= 0) < 0.8

    jidx = jpj.build_pip_index(jpolys, res, jgrid)
    jz, ju = jpj.make_pip_join_fn(jidx, jgrid)(
        jnp.asarray(jpj.localize(jidx, pts)))
    jfinal = jpj.host_recheck_fn(jidx, jpolys)(pts, np.asarray(jz),
                                               np.asarray(ju))
    np.testing.assert_array_equal(final, jfinal)
