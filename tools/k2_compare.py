#!/usr/bin/env python3
"""K2 (the dense join) against another version of its source on one card,
at ``chip_smoke.py`` phase 6's shapes: the flagship index (281 taxi-zone
stand-ins, H3 res 9) and the first 2^22 flagship points (seed 100).  This
checkout's kernel is held bit-equal to ``dense_join_ref`` on the card on
that batch, on phase 6's adversarial set and on the index widened past 32
zone slots (``widen_zone_slots``) and past 32 pool edges
(``widen_pool_edges``); the other version's outputs are held equal to
this one's.  Then on
the main path's 2^18-row chunk, and on the same chunk against the index
widened past 32 pool edges, the other version and each probe are timed
against this one in turns (other, this, this, other), each turn the profiler's device time
of ``--reps`` launches, beside the bound and the issue floor of
``chip_smoke.py`` ``k2_bound``.

    git show REV:mosaic_tpu_torch/csrc/h3_dense_join.cu > OLD.cu
    python3 tools/k2_compare.py [--other OLD.cu] [--probe CUT ...]
        [--reps N] [--json OUT]

The other source is built with this checkout's ``nvcc`` flags and
launched through the C interface ``ops/dense_join.py`` calls, which every
version shares.  A ``--probe`` is this
checkout's source with one edit (``PROBES``), timed only: ``phase_a``
walks no queued point (phase A alone: the projection, the entry read and
the queue, its border points left unwritten) and ``no_walk`` reads no
edge (phase A, the owners' search, the passes' barriers and the
writes).  Prints the card, the ptxas report and SASS count of each
version, a line a case and, last, one JSON object of the times (also
written to ``--json``).
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

SOURCE = "h3_dense_join"

#: name -> (what the edit does, [(text, replacement)] on this checkout's
#: csrc/h3_dense_join.cu)
PROBES = {
    "phase_a": ("phase A alone: the projection, entry read and queue; no "
                "queued point walked or written",
                [("  for (int w = 0;; ++w) {              // passes of 32 "
                  "zone slots", "  for (int w = 0; w < 0; ++w) {")]),
    "no_walk": ("the queue resolved and written, but no edge read: phase A, "
                "the queue, the owners' search and the writes",
                [("act[u] = fu + lane < f_end && !(qu.unc[s] & 4);",
                  "act[u] = false;")]),
}


def probe_source(name: str) -> Path:
    """This checkout's source with the edit of PROBES[name], written
    under the build directory."""
    from mosaic_tpu_torch import _kernels
    text = (_kernels.CSRC / f"{SOURCE}.cu").read_text()
    for old, new in PROBES[name][1]:
        cs.check(text.count(old) == 1,
                 f"probe {name}: {old!r} is not in the source once")
        text = text.replace(old, new)
    _kernels.build_dir().mkdir(parents=True, exist_ok=True)
    out = _kernels.build_dir() / f"probe_{name}.cu"
    out.write_text(text)
    return out


def ptxas_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "stack" in ln]


def sass_count(lib: Path) -> int:
    """Machine instructions in a library (cuobjdump -sass), or -1."""
    from mosaic_tpu_torch import _kernels
    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return -1
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    return sum(1 for ln in text.splitlines() if ln.strip().startswith("/*")
               and "*/" in ln and ";" in ln)


def build(src: Path, tag: str):
    """(library path, ptxas lines) of ``src`` built with this checkout's
    flags (the csrc headers on the include path) under the build
    directory."""
    from mosaic_tpu_torch import _kernels
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _kernels.build_dir() / f"lib{tag}_{SOURCE}-{digest}.so"
    _kernels.build_dir().mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                           "-I", str(_kernels.CSRC), "-o", str(out),
                           str(src)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    text = proc.stdout.decode(errors="replace")
    cs.check(proc.returncode == 0, f"nvcc failed on {src}:\n{text}")
    return out, ptxas_lines(text) + [f"{sass_count(out)} SASS instructions"]


class Version:
    """One K2 library launched as ``ops/dense_join.py`` launches it."""

    def __init__(self, path: Path):
        import torch
        from mosaic_tpu_torch.ops.projection import face_centers_f32
        self.lib = lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.h3_dense_join_set_faces.argtypes = [vp]
        lib.h3_dense_join_set_faces.restype = i
        lib.h3_dense_join.argtypes = [vp, i] + [vp] * 12
        lib.h3_dense_join.restype = i
        fc = face_centers_f32()
        with torch.cuda.device(0):
            rc = lib.h3_dense_join_set_faces(fc.ctypes.data)
        cs.check(rc == 0, f"set_faces of {path.name}: CUDA error {rc}")

    def __call__(self, x, tables, consts):
        import torch
        from mosaic_tpu_torch.ops import dense_join as dj
        from mosaic_tpu_torch.ops.projection import (device_table,
                                                     host_constants)
        n = int(x.shape[0])
        zone = torch.empty(n, dtype=torch.int32, device=x.device)
        unc = torch.empty(n, dtype=torch.bool, device=x.device)
        table = device_table(consts.res, x.device)
        k = host_constants(consts.origin)
        params = dj._params(consts, int(tables.pool.shape[1]),
                            int(tables.gzones.shape[1]))
        rc = self.lib.h3_dense_join(
            x.data_ptr(), n, table.data_ptr(), k.ctypes.data,
            ctypes.addressof(params), tables.entry.data_ptr(),
            tables.edges.data_ptr(), tables.eslot.data_ptr(),
            tables.ecount.data_ptr(), tables.gzones.data_ptr(),
            tables.gwide.data_ptr(), zone.data_ptr(), unc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"K2 launch failed: CUDA error {rc}")
        return zone, unc


def cases():
    """(label, points on the card, tables, consts) of the held cases, the
    two timed ones first."""
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import (adversarial_points,
                                                  widen_pool_edges,
                                                  widen_zone_slots)
    polys, grid, res = mt.build_workload(n_side=16, grid_name="H3",
                                         zones="taxi")
    idx = mt.build_pip_index(polys, res, grid, device=cs.DEV)
    x = torch.from_numpy(mt.localize(idx, mt.nyc_points(
        cs.BATCH, seed=cs.SEEDS[0]))).to(cs.DEV)
    adv, _ = adversarial_points(idx.aux["flat_a"], idx.aux["flat_b"], grid,
                                idx.res, cs.ADV_EDGES, seed=0)
    xa = torch.from_numpy(mt.localize(idx, adv)).to(cs.DEV)
    xw = torch.cat([x[:cs.CHUNK * 4], xa])

    def tables_of(index):
        fn = mt.make_pip_join_fn(index, grid)
        return fn.keywords["tables"], fn.keywords["consts"]

    flag = tables_of(idx)
    edges = tables_of(mt.dense_index_from_arrays(
        widen_pool_edges(cs.index_tables(idx)), device=cs.DEV))
    slots = tables_of(mt.dense_index_from_arrays(
        widen_zone_slots(cs.index_tables(idx)), device=cs.DEV))
    return [("chunk", x[:cs.CHUNK], *flag),
            ("chunk, pool edges widened past 32", x[:cs.CHUNK], *edges),
            ("flagship batch", x, *flag),
            ("adversarial set", xa, *flag),
            ("pool edges widened past 32", xw, *edges),
            ("zone slots widened past 32", xw, *slots)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another version of csrc/h3_dense_join.cu")
    ap.add_argument("--probe", nargs="+", default=[], choices=sorted(PROBES),
                    help="this checkout's source with one edit")
    ap.add_argument("--reps", type=int, default=50,
                    help="launches a timed turn")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the result here")
    args = ap.parse_args()
    import numpy as np
    import torch
    from mosaic_tpu_torch import _kernels
    from mosaic_tpu_torch.ops.dense_join import dense_join, dense_join_ref
    try:
        name, card = cs.phase_device()
        with ThreadPoolExecutor(max_workers=2 + len(args.probe)) as pool:
            mine = pool.submit(_kernels.build, SOURCE)
            builds = {p: pool.submit(build, probe_source(p), p)
                      for p in args.probe}
            if args.other is not None:
                builds["other"] = pool.submit(build, args.other, "other")
            mine.result()
            builds = {k: f.result() for k, f in builds.items()}
        lib = _kernels.lib_path(SOURCE)
        report = {"this": ptxas_lines(lib.with_suffix(".log").read_text(
            errors="replace")) + [f"{sass_count(lib)} SASS instructions"]}
        report.update({k: lines for k, (_, lines) in builds.items()})
        for who, lines in report.items():
            for line in lines:
                cs.log(f"[ptxas] {who}: {line}")
        versions = {k: Version(path) for k, (path, _) in builds.items()}
        all_cases = cases()
        origin = all_cases[0][3].origin
        flops_pt, issued_pt = cs.flops_per_point(cs.RES, origin)
        for label, x, tables, consts in all_cases:
            zk, uk = dense_join(x, tables, consts)
            zr, ur = dense_join_ref(x, tables, consts)
            dz, du = int((zk != zr).sum()), int((uk != ur).sum())
            cs.log(f"[k2] {label}: {x.shape[0]} points, E="
                   f"{tables.pool.shape[1]}, Z={tables.gzones.shape[1]}; "
                   f"this kernel differs from dense_join_ref at {dz} zones, "
                   f"{du} flags; {int((zk >= 0).sum())} matched, "
                   f"{int(uk.sum())} uncertain")
            cs.check(dz == 0 and du == 0, f"{label}: this kernel differs "
                     "from dense_join_ref")
            if "other" in versions:
                zo, uo = versions["other"](x, tables, consts)
                cs.check(torch.equal(zo, zk) and torch.equal(uo, uk),
                         f"{label}: the other version's outputs differ "
                         "from this kernel's")
            del zr, ur
        rows = {}
        for label, x, tables, consts in all_cases[:2]:
            b = cs.k2_bound(x, tables, consts, flops_pt, issued_pt)
            row = {"rows": int(x.shape[0]), "E": int(tables.pool.shape[1]),
                   **b}

            def this():
                return dense_join(x, tables, consts)
            if not versions:
                row["this_ms"], row["source"] = cs.kernel_device_ms(
                    this, args.reps, "dense_join_kernel")
            for who, v in versions.items():
                got = {"this": [], who: []}
                sources = set()
                for which in (who, "this", "this", who):
                    fn = this if which == "this" else \
                        (lambda v=v: v(x, tables, consts))
                    ms, source = cs.kernel_device_ms(fn, args.reps,
                                                     "dense_join_kernel")
                    got[which].append(ms)
                    sources.add(source)
                row[who] = {**got, "sources": sorted(sources)}
                mine_ms = sum(got["this"]) / 2
                theirs = sum(got[who]) / 2
                cs.log(f"[k2] {label}: this {got['this']} ms, {who} "
                       f"{got[who]} ms ({theirs / mine_ms:.3f}x); bound "
                       f"{b['bound_ms']:.4f} ms ({b['bound_by']}), shares "
                       f"{b['bound_ms'] / mine_ms:.3f} and "
                       f"{b['bound_ms'] / theirs:.3f}; issue floor "
                       f"{b['issue_ms']:.4f} ms")
            rows[label] = row
    except cs.PhaseError as e:
        print(f"k2_compare: FAIL: {e}", file=sys.stderr)
        return 1
    result = {"device": name, "card": card, "ptxas": report,
              "probes": {k: PROBES[k][0] for k in args.probe},
              "issued_per_point": issued_pt, "flops_per_point": flops_pt,
              "cases": rows, "torch": torch.__version__,
              "numpy": np.__version__}
    text = json.dumps(result)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
