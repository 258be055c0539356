"""H3 cell assignment of the PyTorch port (ops/cell.py, torchkernel.py).

On the CPU the wrapper runs the plain version of the CUDA cell kernel
(``latlng_to_cell_margin_ref``).  It is held against

* the JAX package's ``cell_from_lattice_jax`` on the same (face, a, b):
  int64 ids bit-equal at every resolution 0..15, pentagon base cells
  included (integer arithmetic: no tolerance);
* the JAX package's H3 device hook ``point_to_cell_jax_margin`` (which
  calls ``latlng_to_cell_jax_margin``; on the CPU under x64 the JAX
  package projects in native f64, the port in df from f32 sin/cos): ids
  equal wherever the port's margin is at least 3e-5 degrees, the sorted
  join's band, and margins within 3e-5 degrees where the ids agree
  (f32 inputs carry up to ~1.5e-5 degrees of rounding at |lon| ~180);
* the f64 host ``point_to_cell`` on the fixture of
  tests/test_h3.py::test_jax_kernel_matches_host: ids equal wherever the
  margin clears the band, and on more than 98% of all points (the JAX
  test's bound).

The kernel itself runs only on the card; chip_smoke.py holds it against
the plain version there, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.core.index.h3.jaxkernel import (cell_from_lattice_jax,
                                                latlng_to_cell_jax_margin)
from mosaic_tpu_torch.core.index.factory import get_index_system
from mosaic_tpu_torch.core.index.h3 import hexmath as hm
from mosaic_tpu_torch.core.index.h3 import index as ix
from mosaic_tpu_torch.core.index.h3.tables import tables
from mosaic_tpu_torch.core.index.h3.torchkernel import (cell_from_lattice_ref,
                                                        round_div7)
from mosaic_tpu_torch.ops.cell import (latlng_to_cell_margin,
                                       latlng_to_cell_margin_ref)

BAND_DEG = 3e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def global_points(n: int, seed: int) -> np.ndarray:
    """[n, 2] f64 (lon, lat) degrees: uniform on the sphere, plus points
    within a few hundred km of each of the 12 pentagon centers."""
    rng = np.random.default_rng(seed)
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    lon = rng.uniform(-180, 180, n)
    t = tables()
    pent = np.nonzero(t.is_pentagon)[0]
    centers = ix.cell_to_latlng(ix.pack(pent, np.zeros((len(pent), 0),
                                                       np.int64), 0))
    near = np.degrees(centers)[:, ::-1][rng.integers(0, 12, n // 4)]
    near = near + rng.normal(0, 2.0, near.shape)
    near[:, 1] = np.clip(near[:, 1], -89.9, 89.9)
    near[:, 0] = (near[:, 0] + 180.0) % 360.0 - 180.0
    return np.concatenate([np.stack([lon, lat], -1), near])


def test_round_div7_is_floor():
    p = torch.arange(-200, 201, dtype=torch.int32)
    want = np.floor((2 * p.numpy() + 7) / 14).astype(np.int32)
    np.testing.assert_array_equal(round_div7(p).numpy(), want)
    # floor(-19/14) = -2 where truncation gives -1 (p = -13)
    assert int(round_div7(torch.tensor([-13]))[0]) == -2


@pytest.mark.parametrize("res", range(16))
def test_cell_from_lattice_bit_equal(res):
    pts = global_points(4000, seed=res)
    face, hex2d = hm.project_lattice(np.radians(pts[:, ::-1]), res)
    ijk = hm.hex2d_to_ijk(hex2d)
    a, b = ijk[:, 0] - ijk[:, 2], ijk[:, 1] - ijk[:, 2]
    ours = cell_from_lattice_ref(torch.from_numpy(face.astype(np.int32)),
                                 torch.from_numpy(a.astype(np.int32)),
                                 torch.from_numpy(b.astype(np.int32)), res)
    theirs = np.asarray(cell_from_lattice_jax(
        jnp.asarray(face, jnp.int32), jnp.asarray(a, jnp.int32),
        jnp.asarray(b, jnp.int32), res))
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # and they are the host's ids for the f64 points
    np.testing.assert_array_equal(
        ours.numpy(), ix.latlng_to_cell(np.radians(pts[:, ::-1]), res))
    base = (ours.numpy() >> 45) & 0x7F
    assert np.any(tables().is_pentagon[base])


@pytest.mark.parametrize("res", [0, 1, 2, 5, 9, 12, 15])
def test_latlng_to_cell_matches_jax_hook(res):
    pts = global_points(20_000, seed=100 + res).astype(np.float32)
    cells, margin = get_index_system("H3").point_to_cell_torch_margin(
        torch.from_numpy(pts), res)
    jc, jm = [np.asarray(v) for v in jget("H3").point_to_cell_jax_margin(
        jnp.asarray(pts), res)]
    cells, margin = cells.numpy(), margin.numpy()
    assert margin.dtype == np.float32
    sure = margin >= BAND_DEG
    differ = cells != jc
    print(f"res {res}: {int(differ.sum())} ids differ from the JAX hook, "
          f"{int((differ & sure).sum())} with margin >= {BAND_DEG}; "
          f"{int((~sure).sum())} below the band")
    assert not np.any(differ & sure)
    assert np.max(np.abs(margin - jm)[~differ]) <= BAND_DEG
    assert np.all(ix.is_valid_cell(cells))
    # the composed plain version is what the hook runs on the CPU
    c2, m2 = latlng_to_cell_margin_ref(torch.from_numpy(pts), res)
    np.testing.assert_array_equal(c2.numpy(), cells)
    np.testing.assert_array_equal(m2.numpy(), margin)


def test_latlng_to_cell_jax_entry_point_same_answer():
    """The JAX package's ``latlng_to_cell_jax_margin`` called with the
    hook's f32 radians is the hook: the comparison above is with it."""
    pts = global_points(5_000, seed=3).astype(np.float32)
    lat = jnp.radians(jnp.asarray(pts[:, 1]))
    lng = jnp.radians(jnp.asarray(pts[:, 0]))
    jc, _ = latlng_to_cell_jax_margin(lat, lng, 9)
    cells, margin = latlng_to_cell_margin_ref(torch.from_numpy(pts), 9)
    sure = margin.numpy() >= BAND_DEG
    assert not np.any((cells.numpy() != np.asarray(jc)) & sure)


def test_matches_host_on_h3_fixture():
    """tests/test_h3.py's fixture: 5000 uniform points on the sphere."""
    rng = np.random.default_rng(7)
    lat = np.arcsin(rng.uniform(-1, 1, 5000))
    lng = rng.uniform(-np.pi, np.pi, 5000)
    host = ix.latlng_to_cell(np.stack([lat, lng], -1), 9)
    pts = np.stack([np.degrees(lng), np.degrees(lat)], -1).astype(
        np.float32)
    cells, margin = latlng_to_cell_margin_ref(torch.from_numpy(pts), 9)
    cells, margin = cells.numpy(), margin.numpy()
    agree = np.mean(cells == host)
    print(f"agreement with the f64 host: {agree}")
    assert agree > 0.98
    assert np.array_equal(cells[margin >= BAND_DEG],
                          host[margin >= BAND_DEG])


def test_wrapper_runs_plain_on_cpu_and_rejects():
    pts = torch.from_numpy(global_points(1000, seed=9).astype(np.float32))
    before = latlng_to_cell_margin.launches
    c, m = latlng_to_cell_margin(pts, 7)
    assert latlng_to_cell_margin.launches == before
    c2, m2 = latlng_to_cell_margin_ref(pts, 7)
    assert torch.equal(c, c2) and torch.equal(m, m2)
    with pytest.raises(ValueError, match="resolution"):
        latlng_to_cell_margin(pts, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        latlng_to_cell_margin(pts.to("meta"), 7)
    with pytest.raises(ValueError, match="resolution"):
        get_index_system("H3").point_to_cell_torch(pts, -1)
    empty = latlng_to_cell_margin(torch.zeros((0, 2)), 3)
    assert empty[0].shape == (0,) and empty[0].dtype == torch.int64
