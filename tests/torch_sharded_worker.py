"""The ranks of the sharded-path tests: a gloo world of CPU processes that
runs every sharded entry point of the port.

This module imports torch, numpy and the port only, never ``jax`` or
``mosaic_tpu``: ``multiprocessing``'s spawn imports it in every rank, so a
rank loads nothing else.  The parent test writes the inputs that come
from the JAX package's generators to ``inputs.npz`` in a directory (and
a chip store under ``chipstore``, written by the JAX package's writer),
starts the world with :func:`start_world`, computes its JAX references
while the ranks work, and reads each rank's ``out<rank>.npz`` after
:func:`join_world`.

Every rank runs every entry point over the whole world (``G``), so the
test can hold the four ranks' outputs equal.  An ``inputs.npz`` with a
``cases`` entry runs only the case functions it names
(``tests/test_torch_devicemon.py`` runs :func:`planes_cases` alone).  Each rank also runs a
share of the entry points over a one-rank subgroup of its own and with
``group=None``, the single-device path; those keys start with ``solo_``
and ``none_``.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

#: seconds a collective may wait before the rank gives up
COLLECTIVE_TIMEOUT_S = 60
#: the overlay fixture's bbox (tests/test_overlay.py)
OVERLAY_BBOX = (-74.05, 40.65, -73.90, 40.80)
#: the KNN fixture's bbox (tests/test_knn.py)
KNN_BBOX = (-74.25, 40.5, -73.7, 40.9)


def start_world(path: Path, world: int) -> list:
    """Start ``world`` spawned ranks over ``path`` (a fresh directory
    holding ``inputs.npz``); returns the processes."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, str(path)),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs: list, timeout: float) -> list:
    """Wait for every rank until ``timeout`` seconds have passed or a rank
    has failed; kill what is left.  Returns the exit codes (None for a
    rank that had to be killed)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    return codes


def rank_main(rank: int, world: int, path: str) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(path, "store"), world),
            rank=rank, world_size=world,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        G = dist.group.WORLD
        solo = [dist.new_group([i]) for i in range(world)][rank]
        inp = dict(np.load(os.path.join(path, "inputs.npz")))
        out = {}
        cases = [globals()[str(c)] for c in inp["cases"]] \
            if "cases" in inp else (pip_cases, h3_cases, overlay_cases,
                                    knn_cases, raster_cases, store_cases)
        for case in cases:
            out.update(case(G, solo, rank, inp))
        out["foreign_modules"] = np.array(sorted(
            m for m in ("jax", "mosaic_tpu") if m in sys.modules))
        np.savez(os.path.join(path, f"out{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(path, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _set_conf(key: str, value) -> None:
    from mosaic_tpu_torch import config
    config.set_default_config(config.apply_conf(config.default_config(),
                                                key, value))


def _raises(fn) -> str:
    """``"Type: message"`` of what ``fn()`` raises ("" when it returns)."""
    try:
        fn()
    except Exception as e:          # the case records what it raised
        return f"{type(e).__name__}: {e}"
    return ""


# ------------------------------------------------------------- the joins

def pip_cases(G, solo, rank, inp) -> dict:
    """tests/test_pip_join.py's sharded workload (sorted index, CUSTOM)."""
    from mosaic_tpu_torch import config
    from mosaic_tpu_torch.bench.workloads import build_workload
    from mosaic_tpu_torch.parallel import pip_join as pj
    from mosaic_tpu_torch.sql.planner import planner
    polys, grid, res = build_workload(n_side=6, res_cells=64)
    idx = pj.build_pip_index(polys, res, grid, device="cpu")
    out = {}
    loc = pj.localize(idx, inp["pip_pts"])
    z, u = pj.make_sharded_pip_join(idx, grid, G, device="cpu")(loc)
    out["pip_zone"], out["pip_unc"] = z.numpy(), u.numpy()
    out["pip_hist"] = pj.zone_histogram(z, len(polys), G).numpy()
    out["pip_odd_rows"] = np.array(_raises(
        lambda: pj.make_sharded_pip_join(idx, grid, G, device="cpu")(
            loc[:-1])))

    pts = inp["stream_pts"]
    run = pj.make_sharded_streamed_pip_join(idx, grid, G, polys=polys,
                                            chunk=4096, device="cpu")
    out["stream_zone"], out["stream_rechecked"] = run(pts)

    cloud = inp["skew_pts"]
    shj = pj.make_sharded_streamed_pip_join(
        idx, grid, G, polys=polys, chunk=len(cloud), refresh=2,
        device="cpu")
    for i in range(3):
        out[f"skew_zone{i}"], _ = shj(cloud)
        out[f"skew_counts{i}"] = shj.shard_counts
        out[f"skew_armed{i}"] = np.array(shj.rebalancer.armed)
    out["skew_planned"] = np.array(shj.rebalancer.planned_skew())

    prev = config.default_config()
    _set_conf("mosaic.planner.force.pip_join", "sharded")
    planned = pj.make_planned_pip_join(idx, grid, polys, group=G)
    out["planned_zone"], out["planned_rechecked"] = planned(pts)
    out["planned_strategy"] = np.array(planned.last_decision.strategy)
    # unpinned, after calibrate: every rank learns the slowest rank's
    # times, and rank 0's decision runs
    config.set_default_config(prev)
    _set_conf("mosaic.stream.chunk.rows", "4096")
    planner.reset()
    auto = pj.make_planned_pip_join(idx, grid, polys, group=G)
    out["calibrate_zone"] = auto.calibrate(pts)
    out["auto_zone"], _ = auto(pts)
    out["auto_strategy"] = np.array(auto.last_decision.strategy)
    config.set_default_config(prev)
    planner.reset()

    if rank == 0:
        for tag, g in (("solo", solo), ("none", None)):
            z, u = pj.make_sharded_pip_join(idx, grid, g, device="cpu")(loc)
            out[f"{tag}_pip_zone"], out[f"{tag}_pip_unc"] = z.numpy(), \
                u.numpy()
            out[f"{tag}_pip_hist"] = pj.zone_histogram(z, len(polys),
                                                       g).numpy()
            out[f"{tag}_stream_zone"], out[f"{tag}_stream_rechecked"] = \
                pj.make_sharded_streamed_pip_join(
                    idx, grid, g, polys=polys, chunk=4096, device="cpu")(pts)
            _set_conf("mosaic.planner.force.pip_join", "sharded")
            one = pj.make_planned_pip_join(idx, grid, polys, group=g)
            out[f"{tag}_planned_zone"], _ = one(pts)
            out[f"{tag}_planned_strategy"] = np.array(
                one.last_decision.strategy)
            config.set_default_config(prev)
        out["none_streamed_zone"], out["none_streamed_rechecked"] = \
            pj.make_streamed_pip_join(idx, grid, polys, chunk=4096,
                                      device="cpu")(pts)
        planner.reset()
    return out


def h3_cases(G, solo, rank, inp) -> dict:
    """A small H3 workload: the dense index (K2's plain version) and the
    sorted one (K3's under the sorted body)."""
    from mosaic_tpu_torch.bench.workloads import build_workload
    from mosaic_tpu_torch.parallel import pip_join as pj
    polys, grid, res = build_workload(n_side=4, grid_name="H3")
    pts = inp["h3_pts"]
    out = {}
    for tag, kw in (("h3d", {}), ("h3s", {"dense": "never"})):
        idx = pj.build_pip_index(polys, res, grid, device="cpu", **kw)
        out[f"{tag}_kind"] = np.array(type(idx).__name__)
        groups = [("", G)] + ([("solo_", solo), ("none_", None)]
                              if rank == 2 else [])
        for pre, g in groups:
            z, u = pj.make_sharded_pip_join(idx, grid, g, device="cpu")(
                pj.localize(idx, pts))
            out[f"{pre}{tag}_zone"], out[f"{pre}{tag}_unc"] = z.numpy(), \
                u.numpy()
            out[f"{pre}{tag}_stream_zone"], \
                out[f"{pre}{tag}_stream_rechecked"] = \
                pj.make_sharded_streamed_pip_join(
                    idx, grid, g, polys=polys, chunk=1024,
                    device="cpu")(pts)
        if rank == 2:
            out[f"none_{tag}_streamed_zone"], \
                out[f"none_{tag}_streamed_rechecked"] = \
                pj.make_streamed_pip_join(idx, grid, polys, chunk=1024,
                                          device="cpu")(pts)
    return out


# ------------------------------------------------------------ the overlay

def overlay_footprints(n: int, seed: int):
    """tests/test_overlay.py's footprint boxes, built by the port."""
    from mosaic_tpu_torch.core.geometry.array import GeometryBuilder
    rng = np.random.default_rng(seed)
    b = GeometryBuilder()
    x0, y0, x1, y1 = OVERLAY_BBOX
    for _ in range(n):
        cx, cy = rng.uniform(x0, x1), rng.uniform(y0, y1)
        w, h = rng.uniform(2e-4, 2e-3), rng.uniform(2e-4, 2e-3)
        b.add_polygon(np.array([[cx - w, cy - h], [cx + w, cy - h],
                                [cx + w, cy + h], [cx - w, cy + h],
                                [cx - w, cy - h]]))
    return b.finish()


def overlay_cases(G, solo, rank, inp) -> dict:
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import nyc_zones
    from mosaic_tpu_torch.parallel import overlay as ov
    a = overlay_footprints(150, 1)
    b = nyc_zones(n_side=3, seed=2, bbox=OVERLAY_BBOX)
    grid = mt.get_index_system("H3")
    ca = mt.tessellate(a, 9, grid, keep_core_geom=True, device="cpu")
    cb = mt.tessellate(b, 9, grid, keep_core_geom=True, device="cpu")
    out = {}
    groups = [("", G)] + ([("solo_", solo), ("none_", None)]
                          if rank == 1 else [])
    for pre, g in groups:
        kw = dict(device="cpu", chips_a=ca, chips_b=cb, group=g)
        out[f"{pre}ov_hits"] = ov.overlay_intersects(a, b, 9, grid, **kw)
        for k, v in zip(("ga", "gb", "area"), ov.overlay_intersection_area(
                a, b, 9, grid, **kw)):
            out[f"{pre}ov_area_{k}"] = v
        for k, v in zip(("a", "b"), ov.overlay_row_pairs(
                ca, cb, a, b, 9, grid, device="cpu", group=g)):
            out[f"{pre}ov_rows_{k}"] = v
    # the exchange itself: the rows each rank receives, and an overflow
    # counted (never silently dropped) when the buckets are too small
    rows = ov.pack_chip_rows(a, 9, grid, chips=ca, device="cpu")
    mine = ov._sharded_rows(rows, G, torch.device("cpu"))
    got, overflow = ov._exchange_rows(mine, ov._exact_bucket_cap(
        rows[0], rows[3], G.size()), G)
    keep = got.valid.numpy()
    out["xchg_cells"] = got.cell.numpy()[keep]
    out["xchg_ids"] = got.ids.numpy()[keep]
    out["xchg_edges"] = got.edges.numpy()[keep]
    out["xchg_overflow"] = np.array(overflow)
    _, out["xchg_overflow_cap1"] = ov._exchange_rows(mine, 1, G)
    out["xchg_mine_valid"] = np.array(int(mine.valid.sum()))
    return out


# ------------------------------------------------------------ SpatialKNN

def knn_points(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = KNN_BBOX
    return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], -1)


def knn_cases(G, solo, rank, inp) -> dict:
    import mosaic_tpu_torch as mt
    grid = mt.get_index_system("H3")
    left, right = knn_points(2048, 9), knn_points(256, 10)
    out = {}
    groups = [("", G, {})] + (
        [("solo_", solo, {}), ("none_", None, {"brute_right_max": 0})]
        if rank == 3 else [])
    for pre, g, kw in groups:
        res = mt.SpatialKNN(grid, k=5, index_resolution=7,
                            max_iterations=32, device="cpu", group=g,
                            **kw).transform(left, right)
        for key in ("right_id", "distance", "iterations", "rechecked"):
            out[f"{pre}knn_{key}"] = np.asarray(res[key])
    out["knn_checkpoint"] = np.array(_raises(lambda: mt.SpatialKNN(
        grid, device="cpu", group=G, checkpoint=object())))
    # fewer left rows than ranks: the last rank marches none
    tiny = knn_points(3, 11)
    for pre, g, kw in (("", G, {}), ("one_", None, {"brute_right_max": 0})):
        res = mt.SpatialKNN(grid, k=5, index_resolution=7,
                            max_iterations=32, device="cpu", group=g,
                            **kw).transform(tiny, right)
        out[f"{pre}knn_tiny_ids"] = res["right_id"]
        out[f"{pre}knn_tiny_distance"] = res["distance"]
    return out


# ---------------------------------------------------------- the raster halo

def halo_tile(h=64, w=40, bands=2, seed=0, nodata_block=False):
    """tests/test_raster_halo.py's tile, built by the port."""
    from mosaic_tpu_torch.core.raster.tile import GeoTransform, RasterTile
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 10, (bands, h, w))
    nodata = None
    if nodata_block:
        data[0, 10:20, 5:15] = -9999.0
        nodata = -9999.0
    return RasterTile(data, GeoTransform(-74.0, 0.001, 0.0, 40.9, 0.0,
                                         -0.001), nodata=nodata, srid=4326)


def raster_cases(G, solo, rank, inp) -> dict:
    from mosaic_tpu_torch.parallel.raster_halo import (
        sharded_convolve, sharded_convolve_stream)
    out = {}
    t = halo_tile()
    groups = [("", G)] + ([("solo_", solo), ("none_", None)]
                          if rank == 3 else [])
    tiles = [halo_tile(seed=s) for s in range(3)]
    k3 = np.random.default_rng(9).normal(0, 1, (3, 3))
    for pre, g in groups:
        for ksize in (3, 5):
            k = np.random.default_rng(ksize).normal(0, 1, (ksize, ksize))
            out[f"{pre}halo_k{ksize}"] = sharded_convolve(
                t, k, g, device="cpu").data
        out[f"{pre}halo_nodata"] = sharded_convolve(
            halo_tile(seed=3, nodata_block=True), np.ones((3, 3)) / 9.0, g,
            device="cpu").data
        out[f"{pre}halo_stream"] = np.stack([
            r.data for r in sharded_convolve_stream(tiles, k3, g,
                                                    device="cpu")])
    out["halo_guard_divide"] = np.array(_raises(lambda: sharded_convolve(
        halo_tile(h=63), np.ones((3, 3)), G, device="cpu")))
    out["halo_guard_odd"] = np.array(_raises(lambda: sharded_convolve(
        t, np.ones((2, 2)), G, device="cpu")))
    out["halo_guard_slab"] = np.array(_raises(lambda: sharded_convolve(
        halo_tile(h=4), np.ones((5, 5)), G, device="cpu")))
    return out


# ------------------------------------------------------ the store-fed join

#: tests/test_store.py's pruning query box
STORE_BBOX = (-74.05, 40.6, -73.9, 40.75)


def _ledger(out: dict, key: str, ledger: dict) -> None:
    cells = sorted(ledger)
    out[f"{key}_cells"] = np.array(cells, np.int64)
    out[f"{key}_bytes"] = np.array([ledger[c] for c in cells], np.int64)


def store_cases(G, solo, rank, inp) -> dict:
    """tests/test_store.py's store-fed join over the chip store the parent
    wrote: a cold run with and without a bbox, a heat-primed run, and the
    planned join's calibration under a skewed heat prior."""
    from mosaic_tpu_torch import config
    from mosaic_tpu_torch.bench.workloads import build_workload
    from mosaic_tpu_torch.obs import metrics
    from mosaic_tpu_torch.obs.heat import heat
    from mosaic_tpu_torch.parallel import pip_join as pj
    from mosaic_tpu_torch.sql.planner import planner
    from mosaic_tpu_torch.store import ChipStore
    polys, grid, res = build_workload(n_side=6, res_cells=64)
    idx = pj.build_pip_index(polys, res, grid, device="cpu")
    st = ChipStore(str(inp["store_root"]))
    prev = config.default_config()
    _set_conf("mosaic.heat.halflife.ms", "0")
    metrics.enable()
    heat.reset()
    out = {}
    for tag, bbox in (("store", None), ("store_bbox", STORE_BBOX)):
        run = pj.make_store_sharded_pip_join(st, idx, grid, G, polys=polys,
                                             chunk=4096, refresh=2,
                                             device="cpu")
        h0 = metrics.counter_value("pipeline/h2d_bytes")
        out[f"{tag}_zone"], out[f"{tag}_rechecked"] = run(bbox=bbox)
        out[f"{tag}_h2d"] = np.array(
            metrics.counter_value("pipeline/h2d_bytes") - h0)
        out[f"{tag}_observations"] = np.array(run.rebalancer.observations)
        _ledger(out, f"{tag}_ledger", run.staged_bytes_by_partition)
    # the cold runs fed heat alike on every rank: prime from it
    _set_conf("mosaic.heat.prior", "true")
    p0 = metrics.counter_value("heat/prior_primes")
    hot = pj.make_store_sharded_pip_join(st, idx, grid, G, polys=polys,
                                         chunk=4096, refresh=2,
                                         device="cpu")
    out["store_hot_armed"] = np.array(hot.rebalancer.armed)
    out["store_hot_zone"], out["store_hot_rechecked"] = hot()
    out["store_hot_primes"] = np.array(
        metrics.counter_value("heat/prior_primes") - p0)
    # a skewed heat plane puts the sharded candidate first in calibrate
    heat.touch(1, rows=1_000_000)
    _set_conf("mosaic.stream.chunk.rows", "4096")
    planner.reset()
    h0 = metrics.counter_value("heat/calibrate_hints")
    planned = pj.make_planned_pip_join(idx, grid, polys, group=G)
    out["hint_zone"] = planned.calibrate(inp["stream_pts"])
    out["hint_order"] = np.array([s for s, _ in planned.calibrate_order])
    out["hint_count"] = np.array(
        metrics.counter_value("heat/calibrate_hints") - h0)
    heat.reset()
    planned.calibrate(inp["stream_pts"])
    out["cold_order"] = np.array([s for s, _ in planned.calibrate_order])
    planner.reset()
    config.set_default_config(prev)
    if rank == 1:
        for pre, g in (("solo_", solo), ("none_", None)):
            z, rc = pj.make_store_sharded_pip_join(
                st, idx, grid, g, polys=polys, chunk=4096, refresh=2,
                device="cpu")()
            out[f"{pre}store_zone"], out[f"{pre}store_rechecked"] = z, rc
    metrics.disable()
    return out


# ------------------------------------------- the memory and device planes

def planes_cases(G, solo, rank, inp) -> dict:
    """Each rank's share of the device monitor and the ``collective/*``
    counters on the sharded join, the sharded streamed join, the overlay
    exchange and the raster halo; every ``devicemon.attribute`` call is
    recorded with its arguments."""
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import build_workload, nyc_zones
    from mosaic_tpu_torch.obs import devicemon, ledger, metrics
    from mosaic_tpu_torch.parallel import collectives as coll
    from mosaic_tpu_torch.parallel import overlay as ov
    from mosaic_tpu_torch.parallel import pip_join as pj
    from mosaic_tpu_torch.parallel.raster_halo import sharded_convolve
    calls = []
    real = devicemon.attribute

    def spy(op, seconds, weights=None, devices=None, keep=None):
        calls.append((op, np.asarray(weights, np.float64),
                      list(devices), keep))
        real(op, seconds, weights, devices, keep=keep)

    devicemon.attribute = spy
    out = {}

    def fresh():
        metrics.reset()
        metrics.enable()
        devicemon.reset()
        ledger.reset()
        coll.reset_counts()
        calls.clear()

    def keep_calls(tag):
        out[f"{tag}_ops"] = np.array([c[0] for c in calls])
        out[f"{tag}_weights"] = np.stack([c[1] for c in calls])
        out[f"{tag}_devices"] = np.array([c[2] for c in calls])
        out[f"{tag}_keep"] = np.array([c[3] for c in calls])
        busy = devicemon.busy_by_device()
        out[f"{tag}_busy_keys"] = np.array(sorted(busy))
        out[f"{tag}_busy"] = np.array([busy[k] for k in sorted(busy)])

    def counters(tag, names):
        rep = metrics.report()
        vals = {**rep["counters"], **rep["gauges"]}
        for n in names:
            out[f"{tag}|{n}"] = np.array(vals.get(n, np.nan))

    polys, grid, res = build_workload(n_side=6, res_cells=64)
    idx = pj.build_pip_index(polys, res, grid, device="cpu")
    out["index_bytes"] = np.array(pj._index_bytes(idx))
    loc = pj.localize(idx, inp["pip_pts"])
    fresh()
    pj.make_sharded_pip_join(idx, grid, G, device="cpu")(loc)
    keep_calls("join")
    out["join_ledger_s"] = np.array(ledger.seconds("pip/sharded_wrap"))
    counters("join", ("collective/replicated_index_bytes",
                      "collective/points_scatter_bytes",
                      "collective/broadcast_bytes",
                      "shard/points_per_shard/pip_join",
                      "shard/skew/pip_join"))

    fresh()
    pj.make_sharded_streamed_pip_join(idx, grid, G, polys=polys,
                                      chunk=4096, device="cpu")(
        inp["stream_pts"])
    keep_calls("stream")
    out["stream_launches"] = np.array(sum(
        e["launches"] for e in ledger.report()["kernels"]
        if e["name"] == "pip/sharded_stream"))
    counters("stream", ("collective/replicated_index_bytes",
                        "collective/points_scatter_bytes",
                        "shard/points_per_shard/pip_join",
                        "pip_join/sharded_points"))

    a = overlay_footprints(150, 1)
    b = nyc_zones(n_side=3, seed=2, bbox=OVERLAY_BBOX)
    h3 = mt.get_index_system("H3")
    ca = mt.tessellate(a, 9, h3, keep_core_geom=True, device="cpu")
    cb = mt.tessellate(b, 9, h3, keep_core_geom=True, device="cpu")
    fresh()
    ov.overlay_intersects(a, b, 9, h3, device="cpu", chips_a=ca,
                          chips_b=cb, group=G)
    keep_calls("overlay")
    ra = ov.pack_chip_rows(a, 9, h3, chips=ca, device="cpu")
    rb = ov.pack_chip_rows(b, 9, h3, chips=cb, origin=ra[4], device="cpu")
    out["overlay_cap"] = np.array(max(
        ov._exact_bucket_cap(ra[0], ra[3], G.size()),
        ov._exact_bucket_cap(rb[0], rb[3], G.size())))
    out["overlay_cap_e"] = np.array([ra[2].shape[1], rb[2].shape[1]])
    out["overlay_a2a"] = np.array(coll.COUNTS["all_to_all"])
    counters("overlay", ["collective/all_to_all_bytes",
                         "collective/all_to_all_bytes/overlay",
                         "collective/all_to_all_calls",
                         "overlay/exchange_rounds", "shard/skew/overlay",
                         "shard/rows_max/overlay"]
             + [f"device/rows/cpu:{r}" for r in range(G.size())])

    fresh()
    sharded_convolve(halo_tile(), np.ones((3, 3)) / 9.0, G, device="cpu")
    out["halo_p2p"] = np.array(coll.COUNTS["p2p"])
    counters("halo", ("collective/ppermute_bytes",
                      "collective/ppermute_bytes/raster_halo",
                      "collective/ppermute_calls"))
    devicemon.attribute = real
    metrics.disable()
    metrics.reset()
    return out
