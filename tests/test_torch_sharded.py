"""The port's sharded paths over a torch.distributed group, against the JAX
package on a 4-device mesh.

One gloo world of four spawned CPU ranks (``tests/torch_sharded_worker.py``,
which imports torch, numpy and the port only) runs every sharded entry
point once for the whole module; the parent computes the JAX package's
answers on ``jax.devices()[:4]`` (tests/test_pip_join.py's ``_mesh4``)
while the ranks work, then reads each rank's outputs.  The cases mirror
the JAX package's sharded tests at their own sizes:

* every rank returns the same output, and no rank loaded ``jax`` or
  ``mosaic_tpu``;
* ``make_sharded_pip_join`` (4,096 points) and ``zone_histogram``: zones,
  flags and counts bit-equal to JAX's (exact);
* ``make_sharded_streamed_pip_join`` (10,037 points, chunk 4096, a ragged
  tail): zones bit-equal to JAX's sharded and single-device streamed
  joins and to ``pip_host_truth``, ``rechecked`` equal (exact);
* the skewed cloud (refresh 2): arrival-order skew 1/0.9 within 2%, the
  rebalancer arms on the second run, the placed run's per-shard skew at
  most 1.5 and below the first, planned skew at most 1.5 and equal to
  JAX's, zones unchanged (exact);
* the planned join pinned to ``sharded``, and unpinned after
  ``calibrate``: zones equal to the streamed join's (exact);
* a small H3 workload, dense (K2's plain version) and sorted (K3's):
  zones and flags bit-equal to the port's single-device join, final
  zones equal to ``pip_host_truth`` (exact);
* the overlay (150 footprints x 9 zones, H3 res 9): hits equal to JAX's
  sharded call and to ``overlay_host_truth``; pair areas within
  1e-12 + 1e-9 area of JAX's and bit-equal to the port's single device;
  the exchange routes each valid row to hash(cell) % 4, drops none at
  the exact bucket capacity and counts what a one-row bucket drops;
* SpatialKNN (2,048 x 256, k = 5, res 7): ids equal to JAX's on the mesh
  and to ``knn_host_truth``, distances within 1e-12 of the oracle,
  iterations equal; three left rows over four ranks equal to one device;
* the raster halo (ksize 3 and 5, nodata): within JAX's rtol=2e-6,
  atol=1e-4 of its sharded form and ``rops.convolve``, and bit-equal to
  the port's ``group=None``; its guards;
* each entry over a one-rank gloo group equals ``group=None`` (exact).

Limits: each collective times out after 60 s, the world is killed and
the module fails after ``WORLD_TIMEOUT_S``, the store is a ``FileStore``
in a temporary directory, each rank runs one torch thread, and every CPU
call stays below torch's 32,768-element grain (ROADMAP C10).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mosaic_tpu.bench.workloads import build_workload as jbuild_workload
from mosaic_tpu.bench.workloads import nyc_points as jnyc_points
from mosaic_tpu.bench.workloads import nyc_zones as jnyc_zones
from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.core.raster.rops import convolve as jconvolve
from mosaic_tpu.core.raster.tile import GeoTransform as JGT
from mosaic_tpu.core.raster.tile import RasterTile as JTile
from mosaic_tpu.models import SpatialKNN as JKNN
from mosaic_tpu.models import knn_host_truth as jknn_truth
from mosaic_tpu.parallel import overlay as jov
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.parallel.raster_halo import sharded_convolve as jhalo
from mosaic_tpu_torch.bench.workloads import build_workload
from mosaic_tpu_torch.parallel import collectives as coll
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.parallel.overlay import _hash_dest_np

from torch_sharded_worker import (KNN_BBOX, OVERLAY_BBOX, join_world,
                                  start_world)

WORLD = 4
#: seconds the spawned world may take before it is killed
WORLD_TIMEOUT_S = 150


def _mesh4():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _skewed_cloud(polys, n=4096, frac=0.9, seed=21):
    """tests/test_pip_join.py's skewed cloud: 90% inside zone 0's box,
    10% west of the workload, cluster first."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = polys.bboxes()[0]
    n_hot = int(n * frac)
    hot = np.stack([rng.uniform(x0, x1, n_hot),
                    rng.uniform(y0, y1, n_hot)], -1)
    wx0 = float(polys.bboxes()[:, 0].min())
    cold = np.stack([rng.uniform(wx0 - 0.2, wx0 - 0.05, n - n_hot),
                     rng.uniform(y0, y1, n - n_hot)], -1)
    return np.concatenate([hot, cold])


def _jax_footprints(n, seed):
    rng = np.random.default_rng(seed)
    b = JBuilder()
    x0, y0, x1, y1 = OVERLAY_BBOX
    for _ in range(n):
        cx, cy = rng.uniform(x0, x1), rng.uniform(y0, y1)
        w, h = rng.uniform(2e-4, 2e-3), rng.uniform(2e-4, 2e-3)
        b.add_polygon(np.array([[cx - w, cy - h], [cx + w, cy - h],
                                [cx + w, cy + h], [cx - w, cy + h],
                                [cx - w, cy - h]]))
    return b.finish()


def _knn_points(n, seed):
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = KNN_BBOX
    return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], -1)


def _jax_tile(h=64, w=40, bands=2, seed=0, nodata_block=False):
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 10, (bands, h, w))
    nodata = None
    if nodata_block:
        data[0, 10:20, 5:15] = -9999.0
        nodata = -9999.0
    return JTile(data, JGT(-74.0, 0.001, 0.0, 40.9, 0.0, -0.001),
                 nodata=nodata, srid=4326)


def _jax_refs(inp) -> dict:
    """The JAX package's answers on the 4-device mesh (and one device
    where the case compares with it)."""
    mesh = _mesh4()
    ref = {}
    polys, grid, res = jbuild_workload(n_side=6, res_cells=64)
    idx = jpj.build_pip_index(polys, res, grid)
    z, u = jpj.make_sharded_pip_join(idx, grid, mesh)(
        jnp.asarray(jpj.localize(idx, inp["pip_pts"])))
    ref["pip_zone"], ref["pip_unc"] = np.asarray(z), np.asarray(u)
    ref["pip_hist"] = np.asarray(jpj.zone_histogram(z, len(polys)))
    pts = inp["stream_pts"]
    ref["stream"] = jpj.make_sharded_streamed_pip_join(
        idx, grid, mesh, polys=polys, chunk=4096)(pts)
    ref["streamed"] = jpj.make_streamed_pip_join(
        idx, grid, polys=polys, chunk=4096)(pts)
    ref["truth"] = jpj.pip_host_truth(pts, polys)
    cloud = inp["skew_pts"]
    shj = jpj.make_sharded_streamed_pip_join(
        idx, grid, mesh, polys=polys, chunk=len(cloud), refresh=2)
    for _ in range(3):
        shj(cloud)
    ref["skew_planned"] = shj.rebalancer.planned_skew()
    ref["skew_zone"], _ = jpj.make_streamed_pip_join(
        idx, grid, polys=polys, chunk=len(cloud))(cloud)

    h3 = jget("H3")
    a = _jax_footprints(150, 1)
    b = jnyc_zones(n_side=3, seed=2, bbox=OVERLAY_BBOX)
    ref["ov_hits"] = jov.overlay_intersects(a, b, 9, h3, mesh=mesh)
    ref["ov_truth"] = jov.overlay_host_truth(a, b)
    ref["ov_area"] = jov.overlay_intersection_area(a, b, 9, h3, mesh=mesh)

    left, right = _knn_points(2048, 9), _knn_points(256, 10)
    ref["knn"] = JKNN(h3, k=5, index_resolution=7, max_iterations=32,
                      mesh=mesh).transform(left, right)
    ref["knn_truth"] = jknn_truth(left, right, 5)

    t = _jax_tile()
    for ksize in (3, 5):
        k = np.random.default_rng(ksize).normal(0, 1, (ksize, ksize))
        ref[f"halo_k{ksize}"] = jhalo(t, k, mesh).data
        ref[f"conv_k{ksize}"] = jconvolve(t, k).data
    t2 = _jax_tile(seed=3, nodata_block=True)
    ref["halo_nodata"] = jhalo(t2, np.ones((3, 3)) / 9.0, mesh).data
    ref["conv_nodata"] = jconvolve(t2, np.ones((3, 3)) / 9.0).data
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(every rank's outputs, the solo_/none_ keys of all ranks, the JAX
    references, the inputs)."""
    path = tmp_path_factory.mktemp("world")
    jpolys, _, _ = jbuild_workload(n_side=6, res_cells=64)
    inp = {"pip_pts": jnyc_points(8 * 512, seed=5),
           "stream_pts": jnyc_points(10_037, seed=9),
           "skew_pts": _skewed_cloud(jpolys),
           "h3_pts": jnyc_points(4096, seed=17)}
    np.savez(path / "inputs.npz", **inp)
    procs = start_world(path, WORLD)
    try:
        ref = _jax_refs(inp)        # while the ranks work
    finally:
        codes = join_world(procs, WORLD_TIMEOUT_S)
    if codes != [0] * WORLD:
        errors = "\n".join(f.read_text()
                           for f in sorted(path.glob("error*.txt")))
        pytest.fail(f"rank exit codes {codes} (None: killed after "
                    f"{WORLD_TIMEOUT_S} s)\n{errors}")
    outs = [dict(np.load(path / f"out{r}.npz")) for r in range(WORLD)]
    single = {}
    for o in outs:
        single.update({k: v for k, v in o.items()
                       if k.startswith(("solo_", "none_"))})
    return outs, single, ref, inp


def test_every_rank_returns_the_same_output(world):
    outs = world[0]
    keys = [k for k in outs[0] if not k.startswith(("solo_", "none_",
                                                    "xchg_"))]
    assert len(keys) > 40
    for o in outs[1:]:
        for k in keys:
            assert np.array_equal(o[k], outs[0][k]), k


def test_ranks_load_no_jax(world):
    for o in world[0]:
        assert o["foreign_modules"].size == 0, o["foreign_modules"]


# ------------------------------------------------------------- the joins

def test_sharded_pip_join(world):
    out, single, ref, _ = world[0][0], world[1], world[2], world[3]
    assert np.array_equal(out["pip_zone"], ref["pip_zone"])
    assert np.array_equal(out["pip_unc"], ref["pip_unc"])
    assert np.array_equal(out["pip_zone"], single["none_pip_zone"])
    assert "do not split evenly over 4 ranks" in str(out["pip_odd_rows"])


def test_zone_histogram_sums_over_the_group(world):
    out, ref = world[0][0], world[2]
    assert np.array_equal(out["pip_hist"], ref["pip_hist"])
    assert int(out["pip_hist"].sum()) == int((out["pip_zone"] >= 0).sum())


def test_sharded_streamed_parity(world):
    """10,037 points in chunks of 4096: the ragged tail pads to a
    power-of-two block per rank."""
    out, ref = world[0][0], world[2]
    assert np.array_equal(out["stream_zone"], ref["stream"][0])
    assert np.array_equal(out["stream_zone"], ref["streamed"][0])
    assert np.array_equal(out["stream_zone"], ref["truth"])
    assert int(out["stream_rechecked"]) == ref["stream"][1] == \
        ref["streamed"][1]


def test_skew_rebalance_cuts_shard_load(world):
    out, ref = world[0][0], world[2]
    skew = [c.max() / c.mean() for c in
            (out[f"skew_counts{i}"] for i in range(3))]
    assert skew[0] == pytest.approx(1.0 / 0.9, rel=0.02)
    assert not out["skew_armed0"] and out["skew_armed1"]
    assert skew[2] <= 1.5 and skew[2] < skew[0]
    assert float(out["skew_planned"]) <= 1.5
    assert float(out["skew_planned"]) == ref["skew_planned"]
    for i in range(3):
        assert np.array_equal(out[f"skew_zone{i}"], ref["skew_zone"])


def test_planned_join_sharded(world):
    out, single, ref = world[0][0], world[1], world[2]
    assert str(out["planned_strategy"]) == "sharded"
    assert np.array_equal(out["planned_zone"], ref["streamed"][0])
    assert int(out["planned_rechecked"]) == ref["streamed"][1]
    # unpinned after calibrate: zones equal whichever rank 0 picked (the
    # agreement across ranks is in test_every_rank_returns_the_same_output)
    assert str(out["auto_strategy"]) in ("streamed", "sharded")
    assert np.array_equal(out["calibrate_zone"], ref["streamed"][0])
    assert np.array_equal(out["auto_zone"], ref["streamed"][0])
    # a sharded pin with no group runs the streamed join
    assert np.array_equal(single["none_planned_zone"], ref["streamed"][0])


@pytest.mark.parametrize("tag,kind", [("h3d", "DensePIPIndex"),
                                      ("h3s", "PIPIndex")])
def test_sharded_joins_on_h3(world, tag, kind):
    out, single, inp = world[0][0], world[1], world[3]
    assert str(out[f"{tag}_kind"]) == kind
    for key in (f"{tag}_zone", f"{tag}_unc", f"{tag}_stream_zone",
                f"{tag}_stream_rechecked"):
        assert np.array_equal(out[key], single[f"none_{key}"]), key
    assert np.array_equal(out[f"{tag}_stream_zone"],
                          single[f"none_{tag}_streamed_zone"])
    assert int(out[f"{tag}_stream_rechecked"]) == \
        int(single[f"none_{tag}_streamed_rechecked"])
    polys, _, _ = build_workload(n_side=4, grid_name="H3")
    assert np.array_equal(out[f"{tag}_stream_zone"],
                          tpj.pip_host_truth(inp["h3_pts"], polys))


def test_padding_rows_come_out_unmatched():
    """The sentinel rows padding a rank's block end zone -1 on every index
    kind; the dense join and the H3 sorted body leave them unflagged, and
    the CUSTOM sorted body flags them as the JAX package's does (they
    never reach the recheck: only a rank's real rows do)."""
    pad = np.full((64, 2), tpj._PAD_SENTINEL_DEG, np.float32)
    for kw, kind, flagged in (
            (dict(n_side=4, grid_name="H3"), "DensePIPIndex", 0),
            (dict(n_side=4, grid_name="H3", dense="never"), "PIPIndex", 0),
            (dict(n_side=6, res_cells=64), "PIPIndex", 64)):
        dense = kw.pop("dense", "auto")
        polys, grid, res = build_workload(**kw)
        idx = tpj.build_pip_index(polys, res, grid, device="cpu",
                                  dense=dense)
        assert type(idx).__name__ == kind
        z, u = tpj.make_pip_join_fn(idx, grid)(torch.from_numpy(pad))
        assert np.all(z.numpy() == -1) and int(u.sum()) == flagged
    jpolys, jgrid, jres = jbuild_workload(n_side=6, res_cells=64)
    jidx = jpj.build_pip_index(jpolys, jres, jgrid)
    _, ju = jax.jit(jpj.make_pip_join_fn(jidx, jgrid))(jnp.asarray(pad))
    assert int(np.asarray(ju).sum()) == 64


def test_group_not_initialised_raises():
    polys, grid, res = build_workload(n_side=6, res_cells=64)
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    for call in (lambda: coll.group_size(object()),
                 lambda: tpj.make_sharded_pip_join(idx, grid, object(),
                                                   device="cpu"),
                 lambda: tpj.zone_histogram(torch.zeros(4, dtype=torch.int32),
                                            3, object())):
        with pytest.raises(RuntimeError, match="not initialised"):
            call()


# ------------------------------------------------------------ the overlay

def test_overlay_sharded_equals_single(world):
    out, single, ref = world[0][0], world[1], world[2]
    assert np.array_equal(out["ov_hits"], ref["ov_hits"])
    assert np.array_equal(out["ov_hits"], ref["ov_truth"])
    assert np.array_equal(out["ov_hits"], single["none_ov_hits"])


def test_intersection_area_sharded_equals_single(world):
    """Pairs equal; areas within 1e-12 + 1e-9 area of JAX's (the native
    fragment-shoelace kernel of each package) and bit-equal to the port's
    single-device call."""
    out, single, ref = world[0][0], world[1], world[2]
    ga, gb, area = ref["ov_area"]
    assert np.array_equal(out["ov_area_ga"], ga)
    assert np.array_equal(out["ov_area_gb"], gb)
    assert np.all(np.abs(out["ov_area_area"] - area) <=
                  1e-12 + 1e-9 * np.abs(area))
    for k in ("ov_area_ga", "ov_area_gb", "ov_area_area", "ov_rows_a",
              "ov_rows_b"):
        assert np.array_equal(out[k], single[f"none_{k}"]), k


def test_exchange_routes_rows_by_cell_hash(world):
    outs = world[0]
    cells = []
    for r, o in enumerate(outs):
        assert np.all(_hash_dest_np(o["xchg_cells"], WORLD) == r)
        assert int(o["xchg_overflow"]) == 0
        cells.append(o["xchg_cells"])
    # every valid row arrives once: the ranks' blocks were disjoint
    assert sum(len(c) for c in cells) == \
        sum(int(o["xchg_mine_valid"]) for o in outs)
    # a one-row bucket keeps one row per destination and counts the rest
    for o in outs:
        assert 0 < int(o["xchg_overflow_cap1"]) < int(o["xchg_mine_valid"])


# ------------------------------------------------------------ SpatialKNN

def test_knn_sharded(world):
    """JAX's test_knn_sharded_8dev at four ranks: ids equal to JAX's on
    the mesh and to the oracle, distances within 1e-12 of the oracle."""
    out, single, ref = world[0][0], world[1], world[2]
    ids, dist = ref["knn_truth"]
    assert np.array_equal(out["knn_right_id"], ref["knn"]["right_id"])
    assert np.array_equal(out["knn_right_id"], ids)
    both = np.isfinite(dist)
    assert np.allclose(out["knn_distance"][both], dist[both], rtol=0,
                       atol=1e-12)
    assert not np.any(np.isfinite(out["knn_distance"]) ^ both)
    assert int(out["knn_iterations"]) == int(ref["knn"]["iterations"])
    for k in ("knn_right_id", "knn_distance", "knn_iterations",
              "knn_rechecked"):
        assert np.array_equal(out[k], single[f"none_{k}"]), k
    assert "NotImplementedError" in str(out["knn_checkpoint"])
    # three left rows over four ranks: the last rank has none
    assert np.array_equal(out["knn_tiny_ids"], out["one_knn_tiny_ids"])
    assert np.array_equal(out["knn_tiny_distance"],
                          out["one_knn_tiny_distance"], equal_nan=True)


# ---------------------------------------------------------- the raster halo

@pytest.mark.parametrize("ksize", [3, 5])
def test_halo_matches_single_device(world, ksize):
    """Within JAX's own rtol=2e-6, atol=1e-4 of its sharded form and of
    ``rops.convolve``; bit-equal to the port's one device."""
    out, single, ref = world[0][0], world[1], world[2]
    got = out[f"halo_k{ksize}"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref[f"halo_k{ksize}"], rtol=2e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got, ref[f"conv_k{ksize}"], rtol=2e-6,
                               atol=1e-4)
    assert np.array_equal(got, single[f"none_halo_k{ksize}"])


def test_halo_nodata_respected(world):
    out, single, ref = world[0][0], world[1], world[2]
    for key in ("halo_nodata", "conv_nodata"):
        np.testing.assert_allclose(out["halo_nodata"], ref[key], rtol=2e-6,
                                   atol=1e-4)
    assert np.array_equal(out["halo_nodata"], single["none_halo_nodata"])


def test_halo_stream_equals_one_device(world):
    out, single = world[0][0], world[1]
    assert np.array_equal(out["halo_stream"], single["none_halo_stream"])


def test_halo_guards(world):
    out = world[0][0]
    assert "must divide the tile height 63" in str(out["halo_guard_divide"])
    assert "odd kernel" in str(out["halo_guard_odd"])
    assert "smaller than the kernel halo" in str(out["halo_guard_slab"])


# ------------------------------------------------------- one-rank groups

ONE_RANK_KEYS = {
    "pip_join": ("pip_zone", "pip_unc"),
    "zone_histogram": ("pip_hist",),
    "sharded_streamed": ("stream_zone", "stream_rechecked"),
    "planned": ("planned_zone", "planned_strategy"),
    "h3_dense": ("h3d_zone", "h3d_unc", "h3d_stream_zone"),
    "h3_sorted": ("h3s_zone", "h3s_unc", "h3s_stream_zone"),
    "overlay_intersects": ("ov_hits",),
    "overlay_area": ("ov_area_ga", "ov_area_gb", "ov_area_area"),
    "overlay_row_pairs": ("ov_rows_a", "ov_rows_b"),
    "knn": ("knn_right_id", "knn_distance", "knn_iterations"),
    "halo": ("halo_k3", "halo_k5", "halo_nodata"),
    "halo_stream": ("halo_stream",),
}


@pytest.mark.parametrize("entry", list(ONE_RANK_KEYS))
def test_one_rank_group_is_one_device(world, entry):
    """Each entry over a gloo group of one rank gives what ``group=None``
    gives (and what the four ranks give)."""
    out, single = world[0][0], world[1]
    for key in ONE_RANK_KEYS[entry]:
        assert np.array_equal(single[f"solo_{key}"], single[f"none_{key}"]), \
            key
        assert np.array_equal(single[f"solo_{key}"], out[key]), key
