"""Sorted-table PIP join of the PyTorch port against the JAX package's.

* ``ops/lookup.py`` equals ``mosaic_tpu.ops.lookup`` on empty, size-1
  and duplicate-laden tables, keys beyond both ends and real H3 ids
  (integer indices: exact).
* The port's ``PIPIndex`` tables are bit-equal to the JAX one's, built
  from the same workload (the JAX side on its numpy tessellation
  branches): the CUSTOM workload of tests/test_pip_join.py (n_side=6,
  64 cells a side) and the H3 taxi workload (n_side=4, res 9) with
  ``dense="never"``.
* The very index the JAX package built, carried across with
  ``sorted_index_from_arrays``, joins 20,000 NYC points: after the f64
  recheck the final zones equal the JAX package's and ``pip_host_truth``
  bit for bit; before it, the device zones agree on every point neither
  package flags; the two uncertain shares lie within 1e-3 of each other
  (the H3 cell step differs: native f64 in the JAX package on the CPU,
  df from f32 sin/cos in the port).
* Analogues of tests/test_pip_join.py:39-65 and :224 (continental, both
  boxes), tests/test_dense_pip.py:61 (dense equals sorted) and :102
  (a multi-face polygon gives a PIPIndex); the streamed sorted join
  equals the one-shot join; ``dense="require"`` raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu.bench.workloads import build_workload as jbuild
from mosaic_tpu.ops import lookup as jlookup
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu_torch.bench.workloads import build_workload, nyc_points
from mosaic_tpu_torch.core.geometry.wkt import read_wkt
from mosaic_tpu_torch.core.index.factory import get_index_system
from mosaic_tpu_torch.ops.lookup import lookup, searchsorted
from mosaic_tpu_torch.parallel import pip_join as tpj

WORKLOADS = {
    "custom": dict(n_side=6, res_cells=64),
    "h3": dict(n_side=4, grid_name="H3", zones="taxi"),
}

STATICS = ("max_dup", "res", "sagitta_deg")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- lookup

def _tables():
    rng = np.random.default_rng(0)
    h3 = np.sort(get_index_system("H3").point_to_cell(
        nyc_points(500, seed=1), 9))
    return {
        "empty": np.zeros(0, np.int64),
        "one": np.array([42], np.int64),
        "dups": np.sort(rng.integers(-50, 50, 300)).astype(np.int64),
        "h3": h3,
    }


@pytest.mark.parametrize("name", ["empty", "one", "dups", "h3"])
def test_lookup_equals_jax(name):
    table = _tables()[name]
    rng = np.random.default_rng(3)
    if len(table):
        lo, hi = int(table.min()), int(table.max())
        keys = np.concatenate([
            table, table + 1, table - 1,
            [lo - 10**6, hi + 10**6, np.iinfo(np.int64).min,
             np.iinfo(np.int64).max],
            rng.integers(lo - 100, hi + 100, 200)])
    else:
        keys = np.array([-5, 0, 7], np.int64)
    keys = keys.astype(np.int64)
    t, k = torch.from_numpy(table), torch.from_numpy(keys)
    jt, jk = jnp.asarray(table), jnp.asarray(keys)
    ours = searchsorted(t, k)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jlookup.searchsorted(jt, jk)))
    idx, found = lookup(t, k)
    jidx, jfound = jlookup.lookup(jt, jk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert found.dtype == torch.bool
    if len(table):
        assert found[:len(table)].all()
        if name == "h3":
            # exact in the high bits: a neighbouring id is never found
            assert not found[len(table):3 * len(table)].any()


# ------------------------------------------------------------ indexes

def tables_of(idx) -> dict:
    out = {k: np.asarray(getattr(idx, k)) for k in tpj.SORTED_TABLES}
    out["origin"] = np.asarray(idx.origin)
    out.update({k: getattr(idx, k) for k in STATICS})
    return out


@pytest.fixture(scope="module", params=sorted(WORKLOADS))
def built(request):
    kw = WORKLOADS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtess_module, "_f64_jit_enabled",
                   lambda disable_env=None: False)
        jp, jg, res = jbuild(**kw)
        jidx = jpj.build_pip_index(jp, res, jg, dense="never")
    tp, tg, _ = build_workload(**kw)
    tidx = tpj.build_pip_index(tp, res, tg, dense="never", device="cpu")
    return {"name": request.param, "jp": jp, "jg": jg, "jidx": jidx,
            "tp": tp, "tg": tg, "tidx": tidx, "res": res}


def test_index_tables_bit_equal(built):
    jidx, tidx = built["jidx"], built["tidx"]
    assert isinstance(jidx, jpj.PIPIndex)
    assert isinstance(tidx, tpj.PIPIndex)
    assert tidx.device == torch.device("cpu")
    for k in tpj.SORTED_TABLES:
        a, b = np.asarray(getattr(jidx, k)), getattr(tidx, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    np.testing.assert_array_equal(np.asarray(jidx.origin), tidx.origin)
    for k in STATICS:
        assert getattr(jidx, k) == getattr(tidx, k), k
    pts = nyc_points(1000, seed=3)
    np.testing.assert_array_equal(jpj.localize(jidx, pts),
                                  tpj.localize(tidx, pts))
    # partition covers (tests/test_pip_join.py:51)
    assert len(tidx.core_cells) > 0 and tidx.num_chips > 0
    assert tidx.max_dup >= 2


def test_join_parity_on_carried_index(built):
    jidx, jp, jg = built["jidx"], built["jp"], built["jg"]
    pidx = tpj.sorted_index_from_arrays(tables_of(jidx), device="cpu")
    pts64 = nyc_points(20_000, seed=3)

    jz, ju = [np.asarray(v) for v in jax.jit(jpj.make_pip_join_fn(
        jidx, jg))(jnp.asarray(jpj.localize(jidx, pts64)))]
    j_final = jpj.host_recheck_fn(jidx, jp)(pts64, jz, ju)

    tz, tu = tpj.make_pip_join_fn(pidx, built["tg"])(
        torch.from_numpy(tpj.localize(pidx, pts64)))
    assert tz.dtype == torch.int32 and tu.dtype == torch.bool
    tz, tu = tz.numpy(), tu.numpy()
    t_final = tpj.host_recheck_fn(pidx, built["tp"])(pts64, tz, tu)

    truth = tpj.pip_host_truth(pts64, built["tp"])
    np.testing.assert_array_equal(truth, jpj.pip_host_truth(pts64, jp))
    np.testing.assert_array_equal(t_final, j_final)
    np.testing.assert_array_equal(t_final, truth)
    sure = ~tu & ~ju
    np.testing.assert_array_equal(tz[sure], jz[sure])
    print(f"{built['name']}: uncertain {tu.mean():.5f} (port) vs "
          f"{ju.mean():.5f} (JAX); flags differ at {int((tu != ju).sum())} "
          f"of {len(tu)} points")
    assert abs(tu.mean() - ju.mean()) <= 1e-3
    # a partition: everything except boundary-degenerate points matches
    assert np.mean(truth >= 0) > 0.999


def test_streamed_equals_one_shot(built):
    tidx, tp, tg = built["tidx"], built["tp"], built["tg"]
    pts64 = nyc_points(12_000, seed=11)
    z, u = tpj.make_pip_join_fn(tidx, tg)(
        torch.from_numpy(tpj.localize(tidx, pts64)))
    one_shot = tpj.host_recheck(pts64, z.numpy(), u.numpy(), tp)
    run = tpj.make_streamed_pip_join(tidx, tg, tp, chunk=4096,
                                     device="cpu")
    streamed, rechecked = run(pts64)
    np.testing.assert_array_equal(streamed, one_shot)
    assert rechecked == int(u.sum())
    np.testing.assert_array_equal(streamed, tpj.pip_host_truth(pts64, tp))
    with pytest.raises(ValueError, match="polygons"):
        tpj.make_streamed_pip_join(tidx, tg, None, device="cpu")


def test_out_of_domain_points(built):
    tidx, tg = built["tidx"], built["tg"]
    pts = np.array([[-80.0, 40.7], [-74.0, 50.0], [0.0, 0.0]])
    z, _ = tpj.make_pip_join_fn(tidx, tg)(
        torch.from_numpy(tpj.localize(tidx, pts)))
    assert np.all(z.numpy() == -1)


# ------------------------------------------------ dispatch and analogues

@pytest.fixture(scope="module")
def taxi5():
    return build_workload(n_side=5, grid_name="H3", zones="taxi")


def test_dense_equals_sorted_path(taxi5):
    polys, grid, res = taxi5
    dense = tpj.build_pip_index(polys, res, grid, device="cpu")
    sorted_idx = tpj.build_pip_index(polys, res, grid, dense="never",
                                     device="cpu")
    assert isinstance(dense, tpj.DensePIPIndex)
    assert isinstance(sorted_idx, tpj.PIPIndex)
    pts64 = nyc_points(10_000, seed=4)
    zd, ud = tpj.make_pip_join_fn(dense, grid)(
        torch.from_numpy(tpj.localize(dense, pts64)))
    zs, us = tpj.make_pip_join_fn(sorted_idx, grid)(
        torch.from_numpy(tpj.localize(sorted_idx, pts64)))
    zd = tpj.host_recheck_fn(dense)(pts64, zd.numpy(), ud.numpy())
    zs = tpj.host_recheck(pts64, zs.numpy(), us.numpy(), polys)
    np.testing.assert_array_equal(zd, zs)


def test_dense_require_raises_and_custom_falls_back():
    polys, grid, res = build_workload(n_side=3, res_cells=32)
    with pytest.raises(ValueError, match="non_h3_grid"):
        tpj.build_pip_index(polys, res, grid, dense="require", device="cpu")
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    assert isinstance(idx, tpj.PIPIndex)
    with pytest.raises(ValueError, match="dense must be"):
        tpj.build_pip_index(polys, res, grid, dense="sometimes",
                            device="cpu")


def test_multiface_falls_back_to_sorted():
    """tests/test_dense_pip.py:102: a polygon spanning icosahedron faces
    cannot use the dense window; its sorted join equals the oracle."""
    polys = read_wkt(["POLYGON((-30 20, 20 20, 20 60, -30 60, -30 20))"])
    grid = get_index_system("H3")
    idx = tpj.build_pip_index(polys, 2, grid, device="cpu")
    assert isinstance(idx, tpj.PIPIndex)
    # the extent test refuses it first; its cells do span faces
    assert tpj.LAST_DENSE_REJECT == "window_extent"
    cells = np.concatenate([idx.core_cells.numpy(),
                            idx.border_cells.numpy()])
    faces = tpj._host_lattice(grid.cell_center(cells), 2)[0]
    assert len(np.unique(faces)) > 1
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-35, 25, 5000), rng.uniform(15, 65, 5000)],
                   -1)
    z, u = tpj.make_pip_join_fn(idx, grid)(
        torch.from_numpy(tpj.localize(idx, pts)))
    final = tpj.host_recheck_fn(idx, polys)(pts, z.numpy(), u.numpy())
    np.testing.assert_array_equal(final, tpj.pip_host_truth(pts, polys))


@pytest.mark.parametrize("box", ["mid", "polar"])
def test_coarse_res_continental_join_exact(box):
    """tests/test_pip_join.py:224: continent-extent boxes at res 2, where
    the chord-vs-gnomonic cell-edge band is ~0.3 degrees."""
    grid = get_index_system("H3")
    wkt, lon, lat = {
        "mid": ("POLYGON ((-120 30, -70 30, -70 50, -120 50, -120 30))",
                (-121, -69), (29, 51)),
        "polar": ("POLYGON ((-30 55, 30 55, 30 75, -30 75, -30 55))",
                  (-31, 31), (54, 76)),
    }[box]
    polys = read_wkt([wkt])
    idx = tpj.build_pip_index(polys, 2, grid, device="cpu")
    assert isinstance(idx, tpj.PIPIndex)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(*lon, 20000), rng.uniform(*lat, 20000)], -1)
    z, u = tpj.make_pip_join_fn(idx, grid)(
        torch.from_numpy(tpj.localize(idx, pts)))
    final = tpj.host_recheck_fn(idx, polys)(pts, z.numpy(), u.numpy())
    np.testing.assert_array_equal(final, tpj.pip_host_truth(pts, polys))
    if box == "mid":
        assert u.numpy().mean() < 0.10


def test_zero_size_tables():
    """Border-only and core-only indexes: pip_assign skips the empty
    table's gathers (tests/test_pip_join.py's zero-size guards)."""
    polys, grid, res = build_workload(n_side=2, res_cells=16)
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    pts64 = nyc_points(3000, seed=6)
    x = torch.from_numpy(tpj.localize(idx, pts64))
    fn_full = tpj.make_pip_join_fn(idx, grid)
    z_full, _ = fn_full(x)
    tables = tables_of(idx)
    no_core = dict(tables, core_cells=np.zeros(0, np.int64),
                   core_zone=np.zeros(0, np.int32))
    z, u = tpj.make_pip_join_fn(tpj.sorted_index_from_arrays(
        no_core, "cpu"), grid)(x)
    assert not np.any((z.numpy() >= 0) & (z_full.numpy() != z.numpy()))
    no_border = dict(tables, border_cells=np.zeros(0, np.int64),
                     border_zone=np.zeros(0, np.int32),
                     chip_a=np.zeros((0, 8, 2), np.float32),
                     chip_b=np.zeros((0, 8, 2), np.float32),
                     chip_mask=np.zeros((0, 8), bool))
    z, u = tpj.make_pip_join_fn(tpj.sorted_index_from_arrays(
        no_border, "cpu"), grid)(x)
    core_hit = z.numpy() >= 0
    assert core_hit.any()
    np.testing.assert_array_equal(z.numpy()[core_hit],
                                  z_full.numpy()[core_hit])
    assert not u.numpy()[~core_hit].all()


def test_sorted_join_needs_grid_and_index():
    polys, grid, res = build_workload(n_side=2, res_cells=16)
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    with pytest.raises(ValueError, match="grid"):
        tpj.make_pip_join_fn(idx)
    with pytest.raises(TypeError, match="PIP index"):
        tpj.make_pip_join_fn(object(), grid)
    with pytest.raises(ValueError, match="polygons"):
        tpj.host_recheck_fn(idx)
