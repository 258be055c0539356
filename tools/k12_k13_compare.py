#!/usr/bin/env python3
"""K12 (point queries) and K13 (edge crossings) against other versions of
their sources on one card, at ``chip_smoke.py`` phase 18's shapes: this
checkout's kernels on the adversarial set of ``chip_smoke.py``, then on
each case every other version's answer bit-equal to this one's and each
timed against this one in turns (other, this, this, other), each turn
the profiler's device time of ``--reps`` launches; beside them the bound
of ``chip_smoke.py`` and, for K12, ``zero_`` of its outputs (CUDA events),
which writes the outputs' bytes and nothing else.

    git show REV:mosaic_tpu_torch/csrc/edge_point_query.cu > OLD12.cu
    git show REV:mosaic_tpu_torch/csrc/edges_cross.cu > OLD13.cu
    python3 tools/k12_k13_compare.py --k12 OLD12.cu [MORE.cu[:gmajor] ...]
        --k13 OLD13.cu [--probe CUT.cu ...] [--json OUT] [--sass DIR]

The other sources are built with this checkout's ``nvcc`` flags.  A K12
source has the C interface of both versions; a K13 source has this
checkout's (the tiles from its ``kSlots1`` and ``kSlots2``) when its
kernel is ``cross_tile_kernel``, else the first version's (a warp per
geometry pair).  A K12 source marked
``:gmajor`` writes its outputs [G, N] (a probe of the first version's
writes); its answers are compared transposed.  A ``--probe`` source is a
K13 with work cut out, timed but not held to this kernel's answers.
Prints the card, the ptxas report of this checkout's kernels, a line a
case and, last, one JSON object of the times (also written to
``--json``); ``--sass DIR`` keeps the kernels' machine code
(``cuobjdump -sass``).  ``--census ROWS`` runs on the host alone and
counts the counties' zero-length edges and exact zero orientations.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (after the path)


def build_other(src: Path, kernel: str) -> ctypes.CDLL:
    from mosaic_tpu_torch import _kernels
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _kernels.BUILD_DIR / f"libother_{kernel}-{digest}.so"
    if not out.exists():
        _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
                        str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    # the profiler's name of its kernel: this checkout's or the first's
    text = src.read_text()
    lib.kernel_name = next(n for n in ("query_tile_kernel", "query_kernel",
                                       "cross_tile_kernel", "cross_kernel")
                           if n + "(" in text or n + "<" in text)
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # a cross_tile_kernel takes the tiles its slots give (this checkout's
    # interface); the first version's kernel does not
    lib.slots = tuple(
        int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
        for k in ("kSlots1", "kSlots2")) \
        if lib.kernel_name == "cross_tile_kernel" else None
    for t in ("f32", "f64"):
        fn = getattr(lib, f"{kernel}_{t}_launch")
        fn.argtypes = ([vp, vp, vp, vp, i64, i64, i, vp, vp, vp]
                       if kernel == "edge_point_query" else
                       [vp, vp, vp, vp, vp, vp, i64, i64, i, i] +
                       ([i, i] if lib.slots else []) + [vp, vp])
        fn.restype = i
    return lib


def other_query(lib, gmajor: bool, p, a, b, m):
    """The other K12 on one case, count and distance: one launch."""
    import torch
    N, (G, E) = p.shape[0], m.shape
    shape = (G, N) if gmajor else (N, G)
    cnt = torch.empty(shape, dtype=torch.int32, device=p.device)
    dst = torch.empty(shape, dtype=p.dtype, device=p.device)
    fn = lib.edge_point_query_f64_launch if p.dtype == torch.float64 else \
        lib.edge_point_query_f32_launch
    rc = fn(p.data_ptr(), a.data_ptr(), b.data_ptr(), m.data_ptr(), N, G, E,
            cnt.data_ptr(), dst.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"the other K12's launch failed: CUDA error {rc}")
    return (cnt.T, dst.T) if gmajor else (cnt, dst)


def other_cross(lib, a1, b1, m1, a2, b2, m2):
    """The other K13 on one case: one launch."""
    import torch
    from mosaic_tpu_torch.ops.edges_cross import cross_tile
    (G1, E1), (G2, E2) = m1.shape, m2.shape
    tiles = [cross_tile(E1, lib.slots[0]), cross_tile(E2, lib.slots[1])] \
        if lib.slots else []
    out = torch.empty((G1, G2), dtype=torch.bool, device=a1.device)
    fn = lib.edges_cross_f64_launch if a1.dtype == torch.float64 else \
        lib.edges_cross_f32_launch
    rc = fn(a1.data_ptr(), b1.data_ptr(), m1.data_ptr(), a2.data_ptr(),
            b2.data_ptr(), m2.data_ptr(), G1, G2, E1, E2, *tiles,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"the other K13's launch failed: CUDA error {rc}")
    return out


def turns(this, other, reps: int, this_name: str, other_name: str):
    """(this ms [2], other ms [2], sources) in turns other, this, this,
    other, each the profiler's device time a launch."""
    got = {"this": [], "other": []}
    sources = set()
    for which in ("other", "this", "this", "other"):
        fn, name = (this, this_name) if which == "this" else \
            (other, other_name)
        ms, source = cs.kernel_device_ms(fn, reps, name)
        got[which].append(ms)
        sources.add(source)
    return got["this"], got["other"], sorted(sources)


def census(rows: int) -> dict:
    """What K13's walk meets on the counties, counted on the host (no
    card): their zero-length valid edges, and the share of the edge-pair
    tests of ``rows`` seeded rows x all counties with an exact zero
    orientation, with and without the zero-length edges."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.bench.workloads import conus_counties
    from mosaic_tpu_torch.core.geometry.padded import build_edges
    from mosaic_tpu_torch.ops.edges_cross import orient
    e = build_edges(conus_counties(n_side=cs.GEOM_COUNTY_SIDE),
                    dtype=torch.float64, device="cpu")
    v = e.b - e.a
    point = (v[..., 0] == 0) & (v[..., 1] == 0) & e.mask
    pick = np.sort(np.random.default_rng(cs.GEOM_SEED).choice(
        e.mask.shape[0], rows, replace=False))
    q = [t[None, :, None, :] for t in (e.a[..., 0], e.a[..., 1],
                                      e.b[..., 0], e.b[..., 1])]
    tests = {"all": [0, 0], "no zero-length": [0, 0]}
    for i in pick:
        p = [t[i, None, :, None] for t in (e.a[..., 0], e.a[..., 1],
                                           e.b[..., 0], e.b[..., 1])]
        d = (orient(*q[0:2], *q[2:4], *p[0:2]),
             orient(*q[0:2], *q[2:4], *p[2:4]),
             orient(*p[0:2], *p[2:4], *q[0:2]),
             orient(*p[0:2], *p[2:4], *q[2:4]))
        zero = (d[0] == 0) | (d[1] == 0) | (d[2] == 0) | (d[3] == 0)
        valid = e.mask[i, None, :, None] & e.mask[None, :, None, :]
        line = valid & ~point[i, None, :, None] & ~point[None, :, None, :]
        for key, m in (("all", valid), ("no zero-length", line)):
            tests[key][0] += int(m.sum())
            tests[key][1] += int((zero & m).sum())
    return {"valid_edges": int(e.mask.sum()),
            "zero_length_edges": int(point.sum()),
            "counties_with_one": int(point.any(1).sum()), "rows": rows,
            "zero_share": {k: z / n for k, (n, z) in tests.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k12", nargs="+", default=[],
                    help="other versions of csrc/edge_point_query.cu, "
                         "each optionally with :gmajor")
    ap.add_argument("--k13", nargs="+", default=[],
                    help="other versions of csrc/edges_cross.cu")
    ap.add_argument("--probe", nargs="+", default=[],
                    help="K13 sources timed against this one but not held "
                         "to its answers (probes that cut work out)")
    ap.add_argument("--reps", type=int, default=5,
                    help="launches a timed turn")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the result here")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write cuobjdump -sass of this checkout's two "
                         "libraries into this directory")
    ap.add_argument("--census", type=int, default=0, metavar="ROWS",
                    help="only count, on the host, what K13's walk meets "
                         "on the counties over ROWS seeded rows")
    args = ap.parse_args()
    if args.census:
        print(json.dumps(census(args.census)))
        return 0
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch import _kernels
    from mosaic_tpu_torch.bench.workloads import conus_counties
    from mosaic_tpu_torch.core.geometry.padded import build_edges
    from mosaic_tpu_torch.ops.edge_point import edge_point_query
    from mosaic_tpu_torch.ops.edges_cross import edges_cross
    f64, f32 = torch.float64, torch.float32
    try:
        name, card = cs.phase_device()
        _kernels.build_all(["edge_point_query", "edges_cross"])
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            tool = Path(_kernels._nvcc()).with_name("cuobjdump")
            for kernel in ("edge_point_query", "edges_cross"):
                lib = _kernels.lib_path(kernel)
                (args.sass / f"{kernel}.sass").write_bytes(subprocess.run(
                    [str(tool), "-sass", str(lib)], check=True,
                    capture_output=True).stdout)
        for kernel in ("edge_point_query", "edges_cross"):
            report = _kernels.lib_path(kernel).with_suffix(".log")
            for line in report.read_text(errors="replace").splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling" in line or "smem" in line:
                    cs.log(f"[ptxas] {kernel}: {line.strip()}")
        jobs = [(Path(spec.partition(":")[0]), "edge_point_query")
                for spec in args.k12] + \
            [(Path(spec), "edges_cross") for spec in args.k13 + args.probe]
        with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
            libs = list(pool.map(lambda job: build_other(*job), jobs))
        k12 = {spec: (lib, spec.partition(":")[2] == "gmajor")
               for spec, lib in zip(args.k12, libs)}
        k13 = dict(zip(args.k13 + args.probe, libs[len(args.k12):]))
        adversarial = cs.geom_adversarial()
        zones, _, _ = mt.build_workload(n_side=16, grid_name="H3",
                                        zones="taxi")
        pts64 = torch.from_numpy(mt.nyc_points(
            cs.GEOM_POINTS, seed=cs.GEOM_POINT_SEED)).to(cs.DEV)
        rng = np.random.default_rng(cs.GEOM_SEED)
        sample = torch.from_numpy(np.sort(rng.choice(
            cs.GEOM_POINTS, cs.GEOM_SAMPLE, replace=False))).to(cs.DEV)
        rows = {}
        for dt, p, label in ((f64, pts64, "f64 all points"),
                             (f32, pts64.to(f32), "f32 all points"),
                             (f64, pts64[sample], "f64 sample")):
            e = build_edges(zones, dtype=dt, device=cs.DEV)
            this = lambda: edge_point_query(p, e.a, e.b, e.mask, True, True)
            cnt, dst = this()
            bound = cs.k12_bound(p, e)
            zero_ms = cs.time_ms(lambda: (cnt.zero_(), dst.zero_()), 3)
            cnt, dst = this()
            row = {"bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"], "zero_ms": zero_ms}
            for spec, (lib, gmajor) in k12.items():
                oc, od = other_query(lib, gmajor, p, e.a, e.b, e.mask)
                cs.check(torch.equal(oc, cnt) and cs.same_bits(od, dst),
                         f"K12 {label}: {spec} differs from this kernel")
                del oc, od
                mine, theirs, sources = turns(
                    this, lambda: other_query(lib, gmajor, p, e.a, e.b,
                                              e.mask),
                    args.reps, "query_tile_kernel", lib.kernel_name)
                row[spec] = {"this_ms": mine, "other_ms": theirs,
                             "sources": sources}
                cs.log(f"[k12] {label} against {spec}: this {mine} ms, "
                       f"other {theirs} ms; bound {bound['bound_ms']:.4f} "
                       f"ms ({bound['bound_by']}); zero_ of the outputs "
                       f"{zero_ms:.4f} ms")
            if not k12:
                row["this_ms"], row["source"] = cs.kernel_device_ms(
                    this, args.reps, "query_tile_kernel")
                cs.log(f"[k12] {label}: {row['this_ms']:.4f} ms; bound "
                       f"{bound['bound_ms']:.4f} ms; zero_ of the outputs "
                       f"{zero_ms:.4f} ms")
            rows[f"K12 {label}"] = row
            del cnt, dst
        counties = conus_counties(n_side=cs.GEOM_COUNTY_SIDE)
        pick = torch.from_numpy(np.sort(rng.choice(
            len(counties), cs.GEOM_PLAIN_ROWS, replace=False))).to(cs.DEV)
        for dt, label, sub in ((f64, "f64 all county pairs", None),
                               (f32, "f32 all county pairs", None),
                               (f64, "f64 512 sampled counties", pick)):
            e = build_edges(counties, dtype=dt, device=cs.DEV)
            x = [e.a, e.b, e.mask] if sub is None else \
                [e.a[sub], e.b[sub], e.mask[sub]]
            args13 = (*x, e.a, e.b, e.mask)
            this = lambda: edges_cross(*args13)
            mine_out = this()
            bound = cs.k13_bound(type(e)(*x), e, mine_out)
            row = {"bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"],
                   "edge_pair_tests": bound["edge_pair_tests"]}
            for spec, lib in k13.items():
                cs.check(spec in args.probe or torch.equal(
                    other_cross(lib, *args13), mine_out),
                         f"K13 {label}: {spec} differs from this kernel")
                mine, theirs, sources = turns(
                    this, lambda: other_cross(lib, *args13), args.reps,
                    "cross_tile_kernel", lib.kernel_name)
                row[spec] = {"this_ms": mine, "other_ms": theirs,
                             "sources": sources}
                cs.log(f"[k13] {label} against {spec}: this {mine} ms, "
                       f"other {theirs} ms; bound {bound['bound_ms']:.4f} "
                       f"ms ({bound['bound_by']})")
            if not k13:
                row["this_ms"], row["source"] = cs.kernel_device_ms(
                    this, args.reps, "cross_tile_kernel")
                cs.log(f"[k13] {label}: {row['this_ms']:.4f} ms; bound "
                       f"{bound['bound_ms']:.4f} ms")
            rows[f"K13 {label}"] = row
    except cs.PhaseError as e:
        print(f"k12_k13_compare: FAIL: {e}", file=sys.stderr)
        return 1
    result = {"device": name, "card": card, "adversarial": adversarial,
              "cases": rows, "torch": torch.__version__}
    text = json.dumps(result)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
