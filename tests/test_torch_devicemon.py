"""The device monitor and the ``collective/*`` counters over a gloo world
of 4 CPU ranks, against the JAX package's on a 4-device mesh.

The counterpart of ``tests/test_trace.py::test_collective_accounting_exchange``
and ``::test_ppermute_bytes_sharded_convolve`` and of the devicemon sites
of the JAX package's sharded paths.  The ranks run
``tests/torch_sharded_worker.py``'s ``planes_cases`` (the sharded join,
the sharded streamed join, the overlay exchange, the raster halo) with
every ``devicemon.attribute`` call recorded; the parent runs the same
calls through the JAX package with its ``devicemon.attribute`` recorded
the same way.

The stated divergence (ROADMAP C11): each rank is its own process and
holds only its own device's share, where the JAX package, in one
process, holds all D.  So:

* every ``attribute`` call carries the JAX call's weights (exact) and
  device keys (``cpu:0``..``cpu:3``), and each rank keeps only its own
  key; a rank's share of the sharded join's seconds is its weight's
  fraction of the call's wall time (within 1e-12), as the JAX package's
  device's share is of its own;
* the modelled movements are summed over the ranks: the replicated
  index bytes, the scattered points and the index broadcast equal the
  JAX package's formulas over the port's index tables;
* the overlay exchange's bytes are what each rank sent through
  ``all_to_all`` (``collectives.COUNTS``); summed over the ranks they are
  the JAX package's static send-buffer bytes with 8-byte ids where it
  counts 4; the calls, the skew gauge and the routed rows per device
  equal the JAX package's (the union of the ranks' rows);
* the halo's bytes are what each rank sent (``COUNTS["p2p"]``): summed,
  ``2 (D - 1) bands halo W 4`` where the JAX package's ``ppermute``
  counts ``2 D bands halo W 4``; its calls equal the JAX package's on
  every rank.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mosaic_tpu.bench.workloads import build_workload as jbuild_workload
from mosaic_tpu.bench.workloads import nyc_points as jnyc_points
from mosaic_tpu.bench.workloads import nyc_zones as jnyc_zones
from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.core.raster.tile import GeoTransform as JGT
from mosaic_tpu.core.raster.tile import RasterTile as JTile
from mosaic_tpu.obs import ledger as jledger
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.parallel import overlay as jov
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.parallel.raster_halo import sharded_convolve as jhalo

from torch_sharded_worker import OVERLAY_BBOX, join_world, start_world

# the package re-exports the singleton under the module's name
jdevmon_mod = importlib.import_module("mosaic_tpu.obs.devicemon")

WORLD = 4
#: seconds the spawned world may take before it is killed
WORLD_TIMEOUT_S = 150


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


def _jax_refs(inp) -> dict:
    """The JAX package's attribute calls and counters on the mesh."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    dm = jdevmon_mod.devicemon
    calls = []
    real = dm.attribute

    def spy(op, seconds, weights=None, devices=None):
        keys = list(devices) if devices is not None else \
            jdevmon_mod._default_keys(len(weights))
        calls.append((op, np.asarray(weights, np.float64), keys,
                      float(seconds)))
        real(op, seconds, weights, devices)

    ref = {}
    was = jmetrics.enabled

    def fresh():
        jmetrics.reset()
        jmetrics.enable()
        dm.reset()
        jledger.reset()
        calls.clear()

    def snap(tag):
        rep = jmetrics.report()
        ref[tag] = {"calls": list(calls),
                    "vals": {**rep["counters"], **rep["gauges"]},
                    "busy": dm.busy_by_device(),
                    "ledger": jledger.report()}

    dm.attribute = spy
    try:
        polys, grid, res = jbuild_workload(n_side=6, res_cells=64)
        idx = jpj.build_pip_index(polys, res, grid)
        loc = jnp.asarray(jpj.localize(idx, inp["pip_pts"]))
        fresh()
        jpj.make_sharded_pip_join(idx, grid, mesh)(loc)
        snap("join")
        fresh()
        jpj.make_sharded_streamed_pip_join(idx, grid, mesh, polys=polys,
                                           chunk=4096)(inp["stream_pts"])
        snap("stream")
        h3 = jget("H3")
        a = _jax_footprints(150, 1)
        b = jnyc_zones(n_side=3, seed=2, bbox=OVERLAY_BBOX)
        fresh()
        jov.overlay_intersects(a, b, 9, h3, mesh=mesh)
        snap("overlay")
        rng = np.random.default_rng(0)
        tile = JTile(rng.normal(0, 10, (2, 64, 40)),
                     JGT(-74.0, 0.001, 0.0, 40.9, 0.0, -0.001),
                     nodata=None, srid=4326)
        fresh()
        jhalo(tile, np.ones((3, 3)) / 9.0, mesh)
        snap("halo")
    finally:
        dm.attribute = real
        jmetrics.reset()
        if not was:
            jmetrics.disable()
        dm.reset()
        jledger.reset()
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(every rank's outputs, the JAX references)."""
    path = tmp_path_factory.mktemp("planes_world")
    inp = {"pip_pts": jnyc_points(8 * 512, seed=5),
           "stream_pts": jnyc_points(10_037, seed=9),
           "cases": np.array(["planes_cases"])}
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
    return outs, ref


KEYS = [f"cpu:{r}" for r in range(WORLD)]


@pytest.mark.parametrize("tag", ["join", "stream", "overlay"])
def test_attribute_calls_carry_the_jax_weights_and_keep_one_device(
        world, tag):
    outs, ref = world
    jcalls = ref[tag]["calls"]
    assert len(jcalls) >= 1
    for r, o in enumerate(outs):
        assert list(o[f"{tag}_ops"]) == [c[0] for c in jcalls]
        for w, devs, keep, jc in zip(o[f"{tag}_weights"],
                                     o[f"{tag}_devices"],
                                     o[f"{tag}_keep"], jcalls):
            assert np.array_equal(w, jc[1])
            assert list(devs) == jc[2] == KEYS
            assert keep == f"cpu:{r}"
        # the rank holds its own device's seconds and no other's
        assert list(o[f"{tag}_busy_keys"]) == [f"cpu:{r}"]
    assert sorted(ref[tag]["busy"]) == KEYS


def test_join_seconds_split_as_the_jax_shares(world):
    outs, ref = world
    (jc,) = ref["join"]["calls"]
    jbusy = ref["join"]["busy"]
    for r, o in enumerate(outs):
        w = o["join_weights"][0]
        share = float(o["join_busy"][0]) / float(o["join_ledger_s"])
        assert share == pytest.approx(w[r] / w.sum(), rel=1e-12)
        assert share == pytest.approx(jbusy[f"cpu:{r}"] / jc[3], rel=1e-12)


@pytest.mark.parametrize("tag", ["join", "stream"])
def test_modelled_movements_sum_to_the_jax_formulas(world, tag):
    outs, ref = world
    jv = ref[tag]["vals"]
    idx_bytes = int(outs[0]["index_bytes"])
    rep = [float(o[f"{tag}|collective/replicated_index_bytes"])
           for o in outs]
    assert rep == [idx_bytes] * WORLD
    assert sum(rep) == idx_bytes * WORLD
    assert "collective/replicated_index_bytes" in jv
    scatter = sum(float(o[f"{tag}|collective/points_scatter_bytes"])
                  for o in outs)
    assert scatter == jv["collective/points_scatter_bytes"]
    for o in outs:
        assert float(o[f"{tag}|shard/points_per_shard/pip_join"]) == \
            jv["shard/points_per_shard/pip_join"]
    if tag == "join":
        bc = [float(o["join|collective/broadcast_bytes"]) for o in outs]
        assert np.isnan(bc[0]) and bc[1:] == [idx_bytes] * (WORLD - 1)
        assert outs[0]["join|shard/skew/pip_join"] == \
            jv["shard/skew/pip_join"]
    else:
        for o in outs:
            assert float(o["stream|pip_join/sharded_points"]) == \
                jv["pip_join/sharded_points"]
            assert int(o["stream_launches"]) == sum(
                e["launches"] for e in ref["stream"]["ledger"]["kernels"]
                if e["name"] == "pip/sharded_stream")


def test_overlay_exchange_bytes_calls_skew_and_rows(world):
    outs, ref = world
    jv = ref["overlay"]["vals"]
    D = WORLD
    cap = int(outs[0]["overlay_cap"])
    cap_e = [int(c) for c in outs[0]["overlay_cap_e"]]
    rounds = float(outs[0]["overlay|overlay/exchange_rounds"])
    assert rounds == 1.0
    # the JAX package's static send buffers: cell i64, id i32, edges,
    # valid — one formula a side
    jbytes = sum(D * D * cap * (8 + 4 + ce * 16 + 1) for ce in cap_e)
    assert jv["collective/all_to_all_bytes"] == jbytes
    sent = [float(o["overlay|collective/all_to_all_bytes"]) for o in outs]
    # what each rank sent, read off collectives.COUNTS: ids go as int64
    assert sent == [float(o["overlay_a2a"][1]) for o in outs]
    assert sent == [float(o["overlay|collective/all_to_all_bytes/overlay"])
                    for o in outs]
    assert sum(sent) == jbytes + 2 * D * D * cap * 4
    for o in outs:
        assert float(o["overlay|collective/all_to_all_calls"]) == \
            jv["collective/all_to_all_calls"] == float(o["overlay_a2a"][0])
        assert float(o["overlay|shard/skew/overlay"]) == \
            jv["shard/skew/overlay"]
        assert float(o["overlay|shard/rows_max/overlay"]) == \
            jv["shard/rows_max/overlay"]
    # the routed rows: each rank holds its own device's count
    for r, o in enumerate(outs):
        for q in range(D):
            v = float(o[f"overlay|device/rows/cpu:{q}"])
            if q == r:
                assert v == jv[f"device/rows/cpu:{q}"]
            else:
                assert np.isnan(v)


def test_halo_ppermute_bytes_and_calls(world):
    outs, ref = world
    jv = ref["halo"]["vals"]
    bands, halo, W = 2, 1, 40
    assert jv["collective/ppermute_bytes"] == 2.0 * WORLD * bands * halo * W * 4
    sent = [float(o["halo|collective/ppermute_bytes"]) for o in outs]
    assert sent == [float(o["halo_p2p"][1]) for o in outs]
    assert sent == [float(o["halo|collective/ppermute_bytes/raster_halo"])
                    for o in outs]
    assert sum(sent) == 2.0 * (WORLD - 1) * bands * halo * W * 4
    for o in outs:
        assert float(o["halo|collective/ppermute_calls"]) == \
            jv["collective/ppermute_calls"] == 2.0 * float(o["halo_p2p"][0])
