#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device — name and power limit (nvidia-smi); exits if CUDA is absent;
2. build — compiles both kernels from ``csrc/`` with ``nvcc``, one
   process per source, started together: ``h3_projection`` (K1, the
   projection alone) and ``h3_dense_join`` (K2, the projection fused
   with the dense join body);
3. K1 vs plain — the projection kernel against its plain PyTorch
   version on the card, 2^22 localized NYC points (seed 100) at res 9
   around the flagship index's origin: all five outputs bit-equal; timed
   in turns (plain, kernel, kernel, plain) at the main path's chunk
   shape and at 2^22 rows, with the host's time per launch;
4. df contract — K1 against the f64 host lattice (hexmath) on 500,000
   points in ±0.4° × ±0.3° around (-74.0, 40.7): no disagreement with
   margin >= err_lattice_bound(9, "df", 0.4);
5. flagship join — 281 taxi zones at H3 res 9, the streamed join over 4
   batches of 2^22 points (seeds 100-103) in 2^18-row chunks, through
   the public entry points; final zones equal ``pip_host_truth`` on a
   seeded 65,536-point sample, uncertain share below 5e-3, one K2
   launch per chunk and no K1 launch, and the zone histogram sums to
   the matched rows; then a profiled batch;
6. K2 vs plain — the fused join kernel against ``dense_join_ref`` on the
   card, zone and uncertain bit-equal, on a flagship batch of 2^22
   points, on points placed on chip and hex edges and a hair beside
   them, and on the flagship index with its zone slots spread past 32
   (``widen_zone_slots``); timed in turns against the plain version and
   against the torch-ops join it replaced (K1 then torch ops), with its
   bound from this run's data;
7. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of ``mosaic_tpu``.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

# the port must never reach JAX or the JAX package
sys.modules["jax"] = None
sys.modules["mosaic_tpu"] = None

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
RES = 9
BATCH = 1 << 22
CHUNK = 1 << 18
SEEDS = (100, 101, 102, 103)
ORACLE_SAMPLE = 65_536
#: chip edges the adversarial set is placed on (1e6 points or so)
ADV_EDGES = 1 << 15
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, an FMA
# counted as two flops, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: f32 arithmetic the count sees (compares, selects, casts and the
#: integer work come on top and are not counted)
F32_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "round",
             "maximum", "clamp_min"}
#: f32 operations of one exact product: in the plain version's Dekker
#: split (the product, two 4-op Veltkamp splits, an 8-op error term), as
#: the kernels issue it (the product and one FMA), and in flops (the FMA
#: counted as two)
DEKKER_OPS = 17
KERNEL_PRODUCT_OPS = 2
EXACT_PRODUCT_FLOPS = 3
#: K2's flops per edge of a border point's group (|py - ay|, max(ax, bx)
#: + eps: sub, abs, max, add) and per straddling edge on top (by - ay,
#: the divide, bx - ax, the mul, the add, |px - xi|: 7 with the abs)
EDGE_FLOPS = 4
STRADDLE_FLOPS = 7
KERNELS = ("h3_projection", "h3_dense_join")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, reps: int, kernel_name: str):
    """Mean device time (ms) of the CUDA kernel named ``kernel_name``
    per call of ``fn``, from torch.profiler — the kernel alone, without
    the host's launch gaps.  None when the profiler records no device
    time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:         # no CUPTI tracing available
        log(f"[kernel] torch.profiler unavailable: {e}")
        return None
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    if count == 0 or total <= 0:
        return None
    return total / 1e3 / reps


def in_turns(plain, kernel, reps_plain: int, reps_kernel: int):
    """(plain ms, kernel ms): plain, kernel, kernel, plain; each the
    mean of its two turns."""
    p1 = time_ms(plain, reps_plain)
    k1 = time_ms(kernel, reps_kernel)
    k2 = time_ms(kernel, reps_kernel)
    p2 = time_ms(plain, reps_plain)
    return (p1 + p2) / 2, (k1 + k2) / 2


def flops_per_point(res: int, origin):
    """(flops the function needs, f32 instructions the kernels issue) per
    point, counted on a small CPU input from the plain version, which
    keeps the kernels' operations one for one.

    The needed flops are in the unit of PEAK_F32_FLOPS: each exact
    product counts EXACT_PRODUCT_FLOPS instead of its DEKKER_OPS, and a
    negation is not counted, since it folds into the add or subtract
    that reads it.  The kernels issue KERNEL_PRODUCT_OPS instructions
    per exact product, and fold negations the same way."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from mosaic_tpu_torch.ops import twofloat
    from mosaic_tpu_torch.ops.projection import project_lattice_ref

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in F32_ARITH and isinstance(out, torch.Tensor):
                self.ops[name] += out.numel()
            return out

    two_prod = twofloat.two_prod
    products = collections.Counter()

    def counted_two_prod(a, b):
        p, err = two_prod(a, b)
        products["n"] += p.numel()
        return p, err

    n = 1024
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.3, 0.3, (n, 2)).astype(np.float32))
    twofloat.two_prod = counted_two_prod
    try:
        with Count() as c:
            project_lattice_ref(x, res, origin)
    finally:
        twofloat.two_prod = two_prod
    plain = sum(c.ops.values()) - c.ops["neg"]
    needed = plain - products["n"] * (DEKKER_OPS - EXACT_PRODUCT_FLOPS)
    issued = plain - products["n"] * (DEKKER_OPS - KERNEL_PRODUCT_OPS)
    check(plain % n == 0 and products["n"] % n == 0,
          f"op counts {plain}, {products['n']} not multiples of {n}")
    log(f"[kernel] per point: {needed // n} flops needed, {issued // n} f32 "
        f"instructions issued by the kernels ({products['n'] // n} exact "
        f"products at {KERNEL_PRODUCT_OPS} each, where the plain version's "
        f"Dekker split takes {DEKKER_OPS}; {c.ops['neg'] // n} negations "
        f"folded)")
    return needed // n, issued // n


def phase_device():
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {card}")
    return name, card


def phase_build():
    from mosaic_tpu_torch import _kernels
    t0 = time.perf_counter()
    seconds = _kernels.build_all(KERNELS)
    log(f"[build] nvcc {seconds} s, in parallel (phase "
        f"{time.perf_counter() - t0:.1f} s)")
    for name in KERNELS:
        report = _kernels.lib_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text(errors="replace").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name} ptxas: {line.strip()}")


def host_ms_per_launch(fn, reps: int) -> float:
    """Host time (ms) to enqueue one call of ``fn``: a host clock around
    ``reps`` calls with no synchronize inside the loop."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def timed_kernel(label: str, kernel, plain, kernel_name: str,
                 reps_plain: int):
    """(device ms, its source, events ms per launch in a loop, host ms
    per launch, plain ms) of a kernel call against its plain version,
    timed in turns.  The device time is the profiler's when it records
    the kernel, else the event time of a launch loop (which includes
    the host's launch gaps)."""
    plain_ms, events_ms = in_turns(plain, kernel, reps_plain, 50)
    prof_ms = kernel_device_ms(kernel, 50, kernel_name)
    host_ms = host_ms_per_launch(kernel, 200)
    source = "profiler" if prof_ms is not None else "events"
    ms = prof_ms if prof_ms is not None else events_ms
    log(f"[{label}] kernel {ms:.4f} ms ({source}; profiler {prof_ms}, "
        f"events over a launch loop {events_ms:.4f} ms), host enqueue "
        f"{host_ms:.4f} ms per launch, plain {plain_ms:.4f} ms")
    return ms, source, events_ms, host_ms, plain_ms


def phase_kernel(origin, flops_per_pt: int, issued_per_pt: int):
    import numpy as np
    import torch
    from mosaic_tpu_torch import nyc_points
    from mosaic_tpu_torch.ops.projection import (project_lattice,
                                                 project_lattice_ref)
    pts = nyc_points(BATCH, seed=SEEDS[0])
    loc = np.asarray(pts - np.asarray(origin)[None], np.float32)
    x = torch.from_numpy(loc).to(DEV)
    ker = [t.cpu().numpy() for t in project_lattice(x, RES, origin)]
    ref = [t.cpu().numpy() for t in project_lattice_ref(x, RES, origin)]
    for name, k, r in zip(("face", "a", "b", "margin", "facegap"), ker,
                          ref):
        nbits = int(np.sum(k.view(np.int32) != r.view(np.int32)))
        log(f"[kernel] {name}: {nbits} of {BATCH} differ bitwise from the "
            "plain version")
        check(nbits == 0, f"K1 {name} differs from plain at {nbits} points")

    def timed(rows: int):
        xs = x[:rows]
        ms, source, events_ms, host_ms, plain_ms = timed_kernel(
            f"kernel {rows} rows", lambda: project_lattice(xs, RES, origin),
            lambda: project_lattice_ref(xs, RES, origin), "project_kernel",
            3)
        ops_ms = flops_per_pt * rows / PEAK_F32_FLOPS * 1e3
        # an FMA is one instruction and two flops: issue at half the peak
        issue_ms = issued_per_pt * rows / (PEAK_F32_FLOPS / 2) * 1e3
        bytes_ms = 28 * rows / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        log(f"[kernel] {rows} rows: bound {bound:.4f} ms (flops "
            f"{ops_ms:.4f}, bytes {bytes_ms:.4f}; {flops_per_pt} flops and "
            f"28 bytes per point), roofline share {bound / ms:.4f}; the "
            f"{issued_per_pt} f32 instructions issued per point take "
            f"{issue_ms:.4f} ms at one per lane per clock")
        return {"plain_ms": plain_ms, "ms": ms, "ms_source": source,
                "events_ms": events_ms, "host_ms": host_ms, "bound_ms": bound,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "max_abs_err": 0.0}

    timed(BATCH)
    return timed(CHUNK)         # the shape the main path gives the kernel


def phase_df_contract():
    import numpy as np
    import torch
    from mosaic_tpu_torch.core.index.h3 import hexmath as hm
    from mosaic_tpu_torch.core.index.h3.torchkernel import err_lattice_bound
    from mosaic_tpu_torch.ops.projection import project_lattice
    r = np.random.default_rng(3)
    origin = np.array([-74.0, 40.7])
    n = 500_000
    loc = np.stack([r.uniform(-0.4, 0.4, n), r.uniform(-0.3, 0.3, n)], -1)
    loc32 = loc.astype(np.float32)
    fd, ad, bd, margin, _ = [t.cpu().numpy() for t in project_lattice(
        torch.from_numpy(loc32).to(DEV), RES, tuple(origin))]
    bound = err_lattice_bound(RES, "df", 0.4)
    # host truth from the f64 points, then from their f32 cast
    for label, pts in (("f64 input", loc), ("f32 input",
                                            loc32.astype(np.float64))):
        latlng = np.radians((pts + origin[None])[:, ::-1])
        fh, hex2d = hm.project_lattice(latlng, RES)
        ijk = hm.hex2d_to_ijk(hex2d)
        ah, bh = ijk[:, 0] - ijk[:, 2], ijk[:, 1] - ijk[:, 2]
        dis = ~((fd == fh) & (ad == ah) & (bd == bh))
        unflagged = int(np.sum(dis & (margin >= bound)))
        worst = float(margin[dis].max()) if dis.any() else 0.0
        log(f"[df] {label}: {int(dis.sum())} of {n} disagree with the f64 "
            f"host lattice, {unflagged} with margin >= {bound:.3e} "
            f"(worst disagreeing margin {worst:.3e})")
        check(unflagged == 0, f"{unflagged} unflagged disagreements "
              f"({label})")


def phase_flagship():
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.ops.dense_join import dense_join
    from mosaic_tpu_torch.ops.projection import project_lattice

    t0 = time.perf_counter()
    polys, grid, res = mt.build_workload(n_side=16, grid_name="H3",
                                         zones="taxi")
    t_work = time.perf_counter() - t0
    t0 = time.perf_counter()
    chips = mt.tessellate(polys, res, grid, keep_core_geom=False)
    t_tess = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = mt.build_pip_index(polys, res, grid, chips=chips, device=DEV)
    t_idx = time.perf_counter() - t0
    log(f"[flagship] {len(polys)} zones (built in {t_work:.2f} s) -> "
        f"{len(chips)} chips ({int(chips.is_core.sum())} core), host "
        f"tessellation {t_tess:.2f} s; index build {t_idx:.2f} s: window "
        f"{idx.W}x{idx.H}, pool {tuple(idx.pool.shape)}, gzones "
        f"{tuple(idx.gzones.shape)}, err_lattice {idx.err_lattice:.3e}, "
        f"on {idx.device}")
    check(idx.device.type == DEV, "index is not on the card")
    run = mt.make_streamed_pip_join(idx, grid, polys, chunk=CHUNK,
                                    device=DEV)
    batches = [mt.nyc_points(BATCH, seed=s) for s in SEEDS]

    # ---- the main path, counted: counts to 0, drive, read
    project_lattice.launches = 0
    dense_join.launches = 0
    zones, hists, rechecked, t_batch = [], [], 0, []
    t0 = time.perf_counter()
    for pts in batches:
        tb = time.perf_counter()
        zone, nre = run(pts)
        t_batch.append(time.perf_counter() - tb)
        hists.append(mt.zone_histogram(
            torch.from_numpy(zone).to(DEV), len(polys)))
        zones.append(zone)
        rechecked += nre
    hists = [h.cpu().numpy() for h in hists]
    t_e2e = time.perf_counter() - t0
    launches = {"h3_project_lattice": project_lattice.launches,
                "h3_dense_join": dense_join.launches}
    n_chunks = len(SEEDS) * -(-BATCH // CHUNK)
    total = len(SEEDS) * BATCH
    pps = total / t_e2e
    unc = rechecked / total
    log(f"[flagship] streamed join: {total} points in {t_e2e:.3f} s = "
        f"{pps:.4e} points/s end to end (host clock, first batch "
        f"included); {rechecked} rechecked on host (uncertain_frac "
        f"{unc:.3e}); launches {launches} for {n_chunks} chunks; "
        f"streamed join per batch {[round(t, 4) for t in t_batch]} s")
    check(launches["h3_dense_join"] == n_chunks, f"K2 launched "
          f"{launches['h3_dense_join']} times for {n_chunks} chunks")
    check(launches["h3_project_lattice"] == 0, "K1 launched "
          f"{launches['h3_project_lattice']} times on the main path")
    check(unc < 5e-3, f"uncertain_frac {unc} >= 5e-3")
    for zone, h in zip(zones, hists):
        matched = int(np.sum(zone >= 0))
        check(int(h.sum()) == matched, f"zone_histogram sums to "
              f"{int(h.sum())}, {matched} rows matched")
        check(np.array_equal(h, np.bincount(zone[zone >= 0],
                                            minlength=len(polys))),
              "zone_histogram differs from np.bincount")
    check(all(np.all((z >= -1) & (z < len(polys))) for z in zones),
          "zone ids out of range")

    # ---- exact oracle on a seeded sample across the batches
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(total, ORACLE_SAMPLE, replace=False))
    all_pts = np.concatenate(batches)
    all_zone = np.concatenate(zones)
    t0 = time.perf_counter()
    truth = mt.pip_host_truth(all_pts[pick], polys)
    bad = int(np.sum(truth != all_zone[pick]))
    log(f"[flagship] oracle: {bad} mismatches of {ORACLE_SAMPLE} sampled "
        f"points ({time.perf_counter() - t0:.1f} s, "
        f"{int(np.sum(truth >= 0))} matched)")
    check(bad == 0, f"{bad} zones differ from pip_host_truth")

    profile_batch(run, batches[0], min(t_batch[1:]) * 1e3)
    return launches, idx, grid, batches, rechecked


def index_tables(idx) -> dict:
    """A dense index as the dict ``dense_index_from_arrays`` takes (no
    recheck tables)."""
    out = {k: getattr(idx, k).cpu().numpy()
           for k in ("entry", "pool", "gzones", "gwide")}
    out.update({k: getattr(idx, k) for k in
                ("origin", "face0", "a0", "b0", "W", "H", "res",
                 "err_lattice", "n_zones", "ext_deg")})
    return out


def join_work(x, tables, consts, flops_pt: int):
    """(flops, bytes, border points) the join needs on the points ``x``,
    from this data: the projection of every point within the window's
    extent, EDGE_FLOPS per edge of a border point's group (pads excluded)
    and STRADDLE_FLOPS more per edge that straddles its latitude; 8 bytes
    in and 5 out per point, and each entry cell and group (its edges, zone
    slots, edge count, gzones row and gwide flag) that the points reach,
    read once."""
    import torch
    from mosaic_tpu_torch.ops.dense_join import CORE_FLAG
    from mosaic_tpu_torch.ops.projection import project_lattice
    c = consts
    face, a, b, _, _ = project_lattice(x, c.res, c.origin)
    near = (x.abs() <= c.far_lim).all(dim=1)
    ia, ib = a - c.a0, b - c.b0
    inw = near & (face == c.face0) & (ia >= 0) & (ia < c.W) & (ib >= 0) & \
        (ib < c.H)
    cell = (ia * c.H + ib)[inw].long()
    e = tables.entry[cell]
    border = (e >= 0) & ((e & CORE_FLAG) == 0)
    g = e[border].long()
    py = x[inw][border, 1][:, None]
    rec = tables.pool[g]
    straddles = int(((rec[..., 1] <= py) != (rec[..., 3] <= py)).sum())
    Z = int(tables.gzones.shape[1])
    rows = torch.unique(g)
    flops = (flops_pt * int(near.sum())
             + EDGE_FLOPS * int(tables.ecount[g].sum())
             + STRADDLE_FLOPS * straddles)
    nbytes = (13 * int(x.shape[0]) + 4 * int(torch.unique(cell).numel())
              + 20 * int(tables.ecount[rows].sum())
              + int(rows.numel()) * (Z * 4 + 1 + 4))
    return flops, nbytes, int(g.numel())


def phase_join_kernel(idx, grid, batches, rechecked: int, flops_pt: int):
    """K2 against dense_join_ref on the card, bit for bit, and its times
    against the plain version and the torch-ops join it replaced."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import (adversarial_points,
                                                  widen_zone_slots)
    from mosaic_tpu_torch.ops.dense_join import (dense_join, dense_join_ref,
                                                 join_body)
    from mosaic_tpu_torch.ops.projection import project_lattice

    def compare(label, x, fn):
        tables, consts = fn.keywords["tables"], fn.keywords["consts"]
        zk, uk = dense_join(x, tables, consts)
        zr, ur = dense_join_ref(x, tables, consts)
        dz, du = int((zk != zr).sum()), int((uk != ur).sum())
        log(f"[join] {label}: {x.shape[0]} points, Z={tables.gzones.shape[1]}"
            f"; zone differs from plain at {dz}, uncertain at {du}; "
            f"{int((zk >= 0).sum())} matched, {int(uk.sum())} uncertain")
        check(dz == 0 and du == 0, f"K2 differs from dense_join_ref on "
              f"{label}: zone at {dz}, uncertain at {du} points")
        return zk, uk

    fn = mt.make_pip_join_fn(idx, grid)
    tables, consts = fn.keywords["tables"], fn.keywords["consts"]
    # every flagship point, in 2^21-row pieces: K2 equals the plain
    # version, and so does the main path's uncertain count
    uncertain = 0
    for i, pts in enumerate(batches):
        x = torch.from_numpy(mt.localize(idx, pts)).to(DEV)
        for k, xs in enumerate(torch.split(x, 1 << 21)):
            uncertain += int(compare(f"flagship batch {i} part {k}", xs,
                                     fn)[1].sum())
    log(f"[join] plain version: {uncertain} uncertain of "
        f"{len(batches) * BATCH}; the main path rechecked {rechecked}")
    check(uncertain == rechecked, "the main path's uncertain count differs "
          "from the plain version's")
    adv, off = adversarial_points(idx.aux["flat_a"], idx.aux["flat_b"], grid,
                                  idx.res, ADV_EDGES, seed=0)
    xa = torch.from_numpy(mt.localize(idx, adv)).to(DEV)
    compare(f"adversarial set ({int((off == 0).sum())} on edges, the rest "
            f"{sorted(set(off[off > 0].tolist()))} deg beside them)", xa, fn)
    wide = mt.dense_index_from_arrays(widen_zone_slots(index_tables(idx)),
                                      device=DEV)
    wfn = mt.make_pip_join_fn(wide, grid)
    x = torch.from_numpy(mt.localize(idx, batches[0])).to(DEV)
    xw = torch.cat([x[:CHUNK * 4], xa])
    zw, uw = compare("index with zone slots widened past 32", xw, wfn)
    z0, u0 = fn(xw)
    check(torch.equal(zw, z0) and torch.equal(uw, u0),
          "widening the zone slots changed the join's answer")

    def timed(rows: int):
        xs = x[:rows]
        kernel = lambda: dense_join(xs, tables, consts)  # noqa: E731
        ms, source, events_ms, host_ms, plain_ms = timed_kernel(
            f"join {rows} rows", kernel,
            lambda: dense_join_ref(xs, tables, consts), "dense_join_kernel",
            3)
        ops_ms, k_ms = in_turns(
            lambda: join_body(xs, project_lattice(xs, consts.res,
                                                  consts.origin),
                              tables, consts), kernel, 10, 50)
        flops, nbytes, n_border = join_work(xs, tables, consts, flops_pt)
        ops_bound = flops / PEAK_F32_FLOPS * 1e3
        bytes_bound = nbytes / PEAK_BYTES * 1e3
        bound = max(ops_bound, bytes_bound)
        log(f"[join] {rows} rows: {n_border} border points; bound "
            f"{bound:.4f} ms (flops {ops_bound:.4f}: {flops}; bytes "
            f"{bytes_bound:.4f}: {nbytes}), roofline share "
            f"{bound / ms:.4f}; the torch-ops join it replaced (K1, then "
            f"torch ops) {ops_ms:.4f} ms against K2 {k_ms:.4f} ms, in turns "
            "(CUDA events)")
        return {"plain_ms": plain_ms, "ms": ms, "ms_source": source,
                "events_ms": events_ms, "host_ms": host_ms,
                "torch_ops_join_ms": ops_ms, "bound_ms": bound,
                "bound_by": "operations" if ops_bound >= bytes_bound
                else "bytes", "max_abs_err": 0.0}

    timed(BATCH)
    return timed(CHUNK)


def profile_batch(run, pts, plain_wall_ms: float) -> None:
    """Where one batch's time goes: torch.profiler over a streamed run
    (not counted): host time per ``stream/*`` phase, device time by op,
    and the device's idle share.  Busy time is the union of the device
    intervals over both streams, so a copy that overlaps a kernel counts
    once.  The idle share is given against the profiled wall time and
    against ``plain_wall_ms``, the fastest unprofiled warm batch: the
    profiler slows the host, not the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(pts)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:         # no CUPTI tracing available
        log(f"[profile] torch.profiler unavailable: {e}")
        return
    events = prof.key_averages()
    chunks = -(-len(pts) // CHUNK)
    for e in events:
        # the stream/* labels appear twice: as host ranges and as device
        # ranges mirroring the kernels they enclose; only the host side
        # is a phase time.  Device busy counts device-side events only
        # (kernels, copies): a host op's device time repeats its kernels
        if e.key.startswith("stream/") and e.cpu_time_total > 0:
            log(f"[profile] host {e.key}: {e.cpu_time_total / 1e3:.3f} ms "
                f"total, {e.cpu_time_total / 1e3 / chunks:.4f} ms per chunk "
                f"({e.count} calls)")
    dev = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                  for e in events if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("stream/")), reverse=True)
    if not dev:
        log("[profile] no device-side events recorded")
        return
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("stream/")
                   and e.time_range.end > e.time_range.start)
    busy_us, lo, hi = 0.0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            busy_us += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy_ms = (busy_us + (0.0 if hi is None else hi - lo)) / 1e3
    log(f"[profile] one batch of {len(pts)} points: wall {wall_ms:.3f} ms "
        f"under the profiler, {plain_wall_ms:.3f} ms unprofiled; device "
        f"busy {busy_ms:.3f} ms (union over both streams; the op times "
        f"sum to {sum(d[0] for d in dev):.3f} ms); idle share "
        f"{1 - busy_ms / wall_ms:.4f} of the profiled wall, "
        f"{1 - busy_ms / plain_wall_ms:.4f} of the unprofiled one")
    for ms, key, count in dev[:8]:
        log(f"[profile] device {ms:.3f} ms ({count}x): {key[:90]}")


def kernel_line(name, source, replaces, launches, k) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "ms_source": k["ms_source"], "host_ms": k["host_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            **({"torch_ops_join_ms": k["torch_ops_join_ms"]}
               if "torch_ops_join_ms" in k else {})}


def main() -> int:
    if not (ROOT / "mosaic_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the mosaic_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import torch
        name, card = phase_device()
        phase_build()
        import mosaic_tpu_torch as mt
        from mosaic_tpu_torch.parallel.pip_join import _workload_origin
        origin = tuple(float(v) for v in _workload_origin(mt.taxi_zones(16)))
        flops_pt, issued_pt = flops_per_point(RES, origin)
        kern = phase_kernel(origin, flops_pt, issued_pt)
        phase_df_contract()
        launches, idx, grid, batches, rechecked = phase_flagship()
        join = phase_join_kernel(idx, grid, batches, rechecked, flops_pt)
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"kernels": [
        kernel_line("h3_project_lattice",
                    "mosaic_tpu_torch/csrc/h3_projection.cu",
                    "mosaic_tpu/ops/pallas_projection.py:228",
                    launches["h3_project_lattice"], kern),
        kernel_line("h3_dense_join",
                    "mosaic_tpu_torch/csrc/h3_dense_join.cu",
                    "mosaic_tpu/ops/pallas_projection.py:228 + "
                    "mosaic_tpu/parallel/pip_join.py:1689",
                    launches["h3_dense_join"], join)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
