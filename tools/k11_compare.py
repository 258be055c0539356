#!/usr/bin/env python3
"""K11 (edge-block measures) against other versions of its source on one
card, at ``chip_smoke.py`` phase 18's shapes: this checkout's kernel on
the adversarial set of ``chip_smoke.py`` (``k11_adversarial``), then for
each (measure, type) on the 2^20 footprints (8 slots) and the 3,136
counties (32 slots) every other version's answer bit-equal to this one's
and each timed against this one in turns (other, this, this, other),
each turn the profiler's device time of ``--reps`` launches, beside the
byte bound of ``chip_smoke.py`` ``k11_bound``.

    git show REV:mosaic_tpu_torch/csrc/edge_measures.cu > OLD.cu
    python3 tools/k11_compare.py --other OLD.cu [MORE.cu ...]
        [--probe CUT.cu ...] [--variant NAME ...] [--sweep] [--reps N]
        [--old-wrapper OLD.py] [--host-steps] [--json OUT] [--sass DIR]

The other sources are built with this checkout's ``nvcc`` flags and
called through the C launch both versions have
(``edge_measures_<type>_launch``).  A ``--probe`` source is a copy with
work cut out, timed but not held to this kernel's answers.  A
``--variant`` is one of :data:`VARIANTS`, a copy of this checkout's
source with one edit, built beside it: held to the answers where the
edit keeps them, else timed as a probe.  ``--sweep``
times this kernel's two mappings, forced, against each other on seeded
blocks of G rows x E slots (prefix masks, E/2 to E valid), the
measurement behind ``launch_plan``'s thresholds.  ``--old-wrapper``
takes another version of ``ops/edge_measures.py`` (e.g. ``git show
REV:mosaic_tpu_torch/ops/edge_measures.py``), loads it beside this one
(both launch this checkout's kernel) and times the host enqueue of a
call of each in turns, ``chip_smoke.py`` ``host_ms_per_launch``;
``--host-steps`` times each step of this wrapper's host path alone on
the counties' float32 blocks (its checks, the three ``contiguous``, the
output's ``torch.empty``, entering the device's context, the current
stream, the C launch with its arguments made, the whole wrapper and
``measures.area``).
Prints the card, the
ptxas report of this checkout's kernels, a line a case and, last, one
JSON object of the times (also written to ``--json``); ``--sass DIR``
keeps this checkout's machine code (``cuobjdump -sass``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (after the path)

#: (G, E) of --sweep: 2^23 slots at 8 to 128 slots a row, then the
#: counties' shape and fewer rows of 32, and few rows of many slots
SWEEP = ((1 << 20, 8), (1 << 19, 16), (1 << 18, 32), (1 << 17, 64),
         (1 << 16, 128), (3136, 8), (3136, 32), (8192, 32), (16384, 32),
         (32768, 32), (65536, 32), (64, 4096), (1024, 1024))


#: name -> (what the edit does, [(text, replacement)] on this checkout's
#: csrc/edge_measures.cu, whether the answers stay this kernel's)
VARIANTS = {
    "copy_all": ("area, length and bounds copy every slot beside the mask "
                 "word, as the centroid does (no mask first)",
                 [("    if (M == kCentroid) {\n      // every slot",
                   "    if (true) {\n      // every slot")], True),
    "first4": ("every measure copies slots 0-3 of its rows and no other, "
               "beside the mask word (work cut: the footprints' valid "
               "slots, bytes without the mask's wait)",
               [("    if (M == kCentroid) {\n      // every slot",
                 "    if (true) {\n      // every slot"),
                ("  if (c >= w) return;", "  if (c >= w || c >= 4) return;")],
               False),
}


def variant_source(name: str) -> Path:
    """This checkout's source with the edits of VARIANTS[name], written
    under the build directory."""
    from mosaic_tpu_torch import _kernels
    text = (_kernels.CSRC / "edge_measures.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source once")
        text = text.replace(old, new)
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _kernels.BUILD_DIR / f"variant_{name}.cu"
    out.write_text(text)
    return out


def load_wrapper(path: Path):
    """Another version of ops/edge_measures.py as a module of the ops
    package, so that its relative imports resolve to this checkout's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "mosaic_tpu_torch.ops._other_edge_measures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_other(src: Path) -> ctypes.CDLL:
    from mosaic_tpu_torch import _kernels
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _kernels.BUILD_DIR / f"libother_edge_measures-{digest}.so"
    if not out.exists():
        _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
                        str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for t in ("f32", "f64"):
        fn = getattr(lib, f"edge_measures_{t}_launch")
        fn.argtypes = [vp, vp, vp, ctypes.c_int64, i, i, vp, vp]
        fn.restype = i
    return lib


def other_measure(lib, a, b, m, what: str):
    """The other K11 on one case: one launch."""
    import torch
    from mosaic_tpu_torch.ops.edge_measures import MEASURES, WIDTH
    G, E = m.shape
    out = torch.empty((G, WIDTH[what]) if WIDTH[what] else (G,),
                      dtype=a.dtype, device=a.device)
    fn = lib.edge_measures_f64_launch if a.dtype == torch.float64 else \
        lib.edge_measures_f32_launch
    rc = fn(a.data_ptr(), b.data_ptr(), m.data_ptr(), G, E, MEASURES[what],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"the other K11's launch failed: CUDA error {rc}")
    return out


def turns(this, other, reps: int):
    """(this ms [2], other ms [2], sources) in turns other, this, this,
    other, each the profiler's device time a launch."""
    got = {"this": [], "other": []}
    sources = set()
    for which in ("other", "this", "this", "other"):
        ms, source = cs.kernel_device_ms(this if which == "this" else other,
                                         reps, "measures_")
        got[which].append(ms)
        sources.add(source)
    return got["this"], got["other"], sorted(sources)


def sweep_blocks(G: int, E: int, dtype, seed: int = 5):
    """Seeded blocks of G rows x E slots on the card: footprint-like
    coordinates, a prefix of E/2 to E valid slots a row."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.core.geometry.padded import EdgeBlocks
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(-74.2, -73.7, (G, E, 2))).to(dtype)
    b = torch.roll(a, -1, 1)
    n = rng.integers(max(1, E // 2), E + 1, G)
    m = torch.from_numpy(np.arange(E)[None, :] < n[:, None])
    return EdgeBlocks(a.to(cs.DEV), b.to(cs.DEV), m.to(cs.DEV))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", nargs="+", default=[],
                    help="other versions of csrc/edge_measures.cu")
    ap.add_argument("--probe", nargs="+", default=[],
                    help="K11 sources timed against this one but not held "
                         "to its answers (probes that cut work out)")
    ap.add_argument("--variant", nargs="+", default=[],
                    choices=sorted(VARIANTS),
                    help="copies of this checkout's source with one edit")
    ap.add_argument("--sweep", action="store_true",
                    help="time this kernel's two mappings on the SWEEP "
                         "shapes")
    ap.add_argument("--old-wrapper", type=Path, default=None,
                    help="another ops/edge_measures.py whose host enqueue "
                         "is timed beside this one's")
    ap.add_argument("--host-steps", action="store_true",
                    help="time each step of this wrapper's host path")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches a timed turn")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the result here")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write cuobjdump -sass of this checkout's library "
                         "into this directory")
    args = ap.parse_args()
    import torch
    from mosaic_tpu_torch import _kernels
    from mosaic_tpu_torch.bench.workloads import conus_counties, footprints
    from mosaic_tpu_torch.core.geometry.padded import build_edges
    from mosaic_tpu_torch.ops.edge_measures import edge_measures, launch_plan
    f64, f32 = torch.float64, torch.float32
    try:
        name, card = cs.phase_device()
        _kernels.build_all(["edge_measures"])
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            tool = Path(_kernels._nvcc()).with_name("cuobjdump")
            (args.sass / "edge_measures.sass").write_bytes(subprocess.run(
                [str(tool), "-sass", str(_kernels.lib_path("edge_measures"))],
                check=True, capture_output=True).stdout)
        report = _kernels.lib_path("edge_measures").with_suffix(".log")
        for line in report.read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling" in line or "smem" in line:
                cs.log(f"[ptxas] edge_measures: {line.strip()}")
        sources = {s: Path(s) for s in args.other + args.probe}
        sources.update({v: variant_source(v) for v in args.variant})
        probes = set(args.probe) | {v for v in args.variant
                                    if not VARIANTS[v][2]}
        with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
            libs = dict(zip(sources, pool.map(build_other,
                                              sources.values())))
        adversarial = cs.k11_adversarial()
        rows = {}
        sets = (("footprints", footprints(cs.GEOM_FOOTPRINTS, seed=41)),
                ("counties", conus_counties(n_side=cs.GEOM_COUNTY_SIDE)))
        for set_label, arr in sets:
            for dt in (f64, f32):
                e = build_edges(arr, dtype=dt, device=cs.DEV)
                for w in cs.GEOM_MEASURES:
                    label = f"{w} {str(dt).split('.')[-1]} {set_label}"
                    this = lambda e=e, w=w: edge_measures(  # noqa: E731
                        e.a, e.b, e.mask, w)
                    mine = this()
                    bound = cs.k11_bound(e, w)
                    row = {"bound_ms": bound["bound_ms"],
                           "bound_by": bound["bound_by"],
                           "bytes": bound["bytes"],
                           "path": launch_plan(*e.mask.shape)}
                    for spec, lib in libs.items():
                        def other(lib=lib, e=e, w=w):
                            return other_measure(lib, e.a, e.b, e.mask, w)
                        cs.check(spec in probes or
                                 cs.same_bits(other(), mine),
                                 f"K11 {label}: {spec} differs from this "
                                 "kernel")
                        t_ms, o_ms, sources = turns(this, other, args.reps)
                        row[spec] = {"this_ms": t_ms, "other_ms": o_ms,
                                     "sources": sources}
                        cs.log(f"[k11] {label} against {spec}: this {t_ms} "
                               f"ms, other {o_ms} ms; bound "
                               f"{bound['bound_ms']:.4f} ms")
                    if not libs:
                        row["this_ms"], row["source"] = cs.kernel_device_ms(
                            this, args.reps, "measures_")
                        cs.log(f"[k11] {label}: {row['this_ms']:.4f} ms; "
                               f"bound {bound['bound_ms']:.4f} ms")
                    rows[label] = row
                del e
        host = {}
        if args.old_wrapper is not None:
            old = load_wrapper(args.old_wrapper)
            for set_label, arr in sets:
                for dt in (f64, f32):
                    e = build_edges(arr, dtype=dt, device=cs.DEV)
                    for w in ("area", "centroid"):
                        key = f"{w} {str(dt).split('.')[-1]} {set_label}"
                        got = {"this": [], "old": []}
                        for which in ("old", "this", "this", "old"):
                            fn = old.edge_measures if which == "old" else \
                                edge_measures
                            got[which].append(cs.host_ms_per_launch(
                                lambda fn=fn, e=e, w=w: fn(e.a, e.b, e.mask,
                                                           w), 500))
                        host[key] = got
                        cs.log(f"[host] {key}: host enqueue a call, this "
                               f"wrapper {got['this']} ms, the other "
                               f"{got['old']} ms")
                    del e
        if args.host_steps:
            from mosaic_tpu_torch.core.geometry import measures
            from mosaic_tpu_torch.ops import edge_measures as em
            e = build_edges(sets[1][1], dtype=f32, device=cs.DEV)
            G, E = e.mask.shape
            out = torch.empty((G,), dtype=f32, device=cs.DEV)
            lib = em._lib()
            fn = lib.edge_measures_f32_launch_path
            made = (e.a.data_ptr(), e.b.data_ptr(), e.mask.data_ptr(), G, E,
                    em.MEASURES["area"], em.PATHS[launch_plan(G, E)],
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            def device_context():
                with torch.cuda.device(e.a.device):
                    pass

            steps = {
                "checks": lambda: em.check_blocks("edge_measures", e.a, e.b,
                                                  e.mask),
                "contiguous x3": lambda: (e.a.contiguous(), e.b.contiguous(),
                                          e.mask.contiguous()),
                "torch.empty": lambda: torch.empty((G,), dtype=f32,
                                                   device=e.a.device),
                "device context": device_context,
                "current_stream": lambda: torch.cuda.current_stream(
                    e.a.device).cuda_stream,
                "C launch": lambda: fn(*made),
                "wrapper": lambda: edge_measures(e.a, e.b, e.mask, "area"),
                "measures.area": lambda: measures.area(e)}
            host["steps"] = {k: cs.host_ms_per_launch(f, 2000)
                             for k, f in steps.items()}
            cs.log(f"[host] steps of the wrapper, ms a call: "
                   f"{host['steps']}")
            del e
        sweep = {}
        if args.sweep:
            for G, E in SWEEP:
                for dt in (f64, f32):
                    e = sweep_blocks(G, E, dt)
                    for w in ("centroid", "area"):
                        def by(path, e=e, w=w):
                            return edge_measures(e.a, e.b, e.mask, w,
                                                 path=path)
                        cs.check(cs.same_bits(by("staged"), by("warp")),
                                 f"K11 sweep {G} x {E}: the mappings differ")
                        staged, warp, sources = turns(
                            lambda: by("staged"), lambda: by("warp"),
                            args.reps)
                        key = f"{w} {str(dt).split('.')[-1]} {G}x{E}"
                        sweep[key] = {"staged_ms": staged, "warp_ms": warp,
                                      "planned": launch_plan(G, E),
                                      "bound_ms": cs.k11_bound(
                                          e, w)["bound_ms"],
                                      "sources": sources}
                        cs.log(f"[sweep] {key}: staged {staged} ms, warp "
                               f"{warp} ms (planned {launch_plan(G, E)})")
                    del e
    except cs.PhaseError as e:
        print(f"k11_compare: FAIL: {e}", file=sys.stderr)
        return 1
    result = {"device": name, "card": card, "adversarial": adversarial,
              "cases": rows, "host": host, "sweep": sweep,
              "torch": torch.__version__}
    text = json.dumps(result)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
