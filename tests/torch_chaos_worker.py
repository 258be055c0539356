"""One rank of the gloo world that tests/test_torch_chaos.py starts: the
port's sharded overlay under a degraded bucket capacity.

Each rank builds tests/test_chaos.py's overlay workload (40 footprint
boxes from seed 7 against ``nyc_zones(n_side=3, seed=2)``), runs
``overlay_intersects`` over the world under
``seed=35;site=overlay.*,mode=degrade,rate=1.0,factor=4``, again under a
plan naming ``overlay.dup_cap`` alone, and once clean, and writes the
answers, the exchange rounds and the injected faults to
``out<rank>.npz``.  It imports torch, numpy and the port only.
"""

from __future__ import annotations

import os
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BBOX = (-74.05, 40.65, -73.90, 40.80)
DEGRADE = "seed=35;site=overlay.*,mode=degrade,rate=1.0,factor=4"
DUP_ONLY = "seed=35;site=overlay.dup_cap,mode=degrade,rate=1.0,factor=4"


def footprint_rings(n: int = 40, seed: int = 7) -> list:
    """tests/test_chaos.py's overlay footprints as closed rings."""
    rng = np.random.default_rng(seed)
    rings = []
    for _ in range(n):
        cx = rng.uniform(-74.05, -73.90)
        cy = rng.uniform(40.65, 40.80)
        w = rng.uniform(2e-4, 2e-3)
        h = rng.uniform(2e-4, 2e-3)
        rings.append(np.array([[cx - w, cy - h], [cx + w, cy - h],
                               [cx + w, cy + h], [cx - w, cy + h],
                               [cx - w, cy - h]]))
    return rings


def rank_main(rank: int, world: int, path: str) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(path, "store"), world),
            rank=rank, world_size=world, timeout=timedelta(seconds=60))
        from mosaic_tpu_torch.bench.workloads import nyc_zones
        from mosaic_tpu_torch.core.geometry.array import GeometryBuilder
        from mosaic_tpu_torch.core.index.factory import get_index_system
        from mosaic_tpu_torch.obs import metrics
        from mosaic_tpu_torch.parallel import overlay as tov
        from mosaic_tpu_torch.resilience import faults
        b = GeometryBuilder()
        for r in footprint_rings():
            b.add_polygon(r)
        a = b.finish()
        zones = nyc_zones(n_side=3, seed=2, bbox=BBOX)
        grid = get_index_system("H3")
        out = {}
        metrics.enable()

        def run(tag, spec):
            plan = faults.arm(spec) if spec else None
            r0 = metrics.counter_value("overlay/exchange_rounds")
            try:
                out[tag] = tov.overlay_intersects(
                    a, zones, 9, grid, device="cpu", group=dist.group.WORLD)
            finally:
                faults.disarm()
            out[f"{tag}_rounds"] = np.int64(
                metrics.counter_value("overlay/exchange_rounds") - r0)
            out[f"{tag}_injected"] = np.array(
                [f"{s}:{n}:{k}" for s, n, k in plan.injected]
                if plan else [], dtype=str)

        run("degraded", DEGRADE)
        run("dup_only", DUP_ONLY)
        run("clean", None)
        np.savez(os.path.join(path, f"out{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(path, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def start_world(path: Path, world: int) -> list:
    """Start ``world`` spawned ranks over ``path``; returns the
    processes (join them with ``torch_sharded_worker.join_world``)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, str(path)),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs
