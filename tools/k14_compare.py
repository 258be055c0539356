#!/usr/bin/env python3
"""K14 (the fused SQL group) against another version of its source on one
card, at ``chip_smoke.py`` phase 22b's shapes: the flagship's aggregate
and project groups over its first 2^22-point batch (seed 100, the dense
join's zones) and the two groups over phase 20's 1,048,635 points in a
2^21 bucket.  For each group this checkout's kernel is held byte-equal to
``fused_group_ref`` on the card, the other version's outputs to this
one's, and the two are timed in turns (other, this, this, other), each
turn the profiler's device time of ``--reps`` launches, beside the byte
bound of ``chip_smoke.py`` ``k14_bound``.

    git show REV:mosaic_tpu_torch/csrc/fused_group.cu > OLD.cu
    git show REV:mosaic_tpu_torch/ops/fused_group.py > OLD.py
    python3 tools/k14_compare.py [--other OLD.cu --old-wrapper OLD.py]
        [--probe CUT.cu ...] [--cases] [--reps N] [--json OUT]

The other source is built with this checkout's ``nvcc`` flags and run on
the buffers its own wrapper packs (``--old-wrapper``: the input and
output layouts may differ between versions, so the outputs are compared
as the arrays each wrapper's ``unpack_outputs`` reads).  A ``--probe`` is
a copy of this checkout's source with work cut out, launched as this
kernel is, timed but not held to its answers.  ``--cases`` also runs the
CPU tests' groups (``tests/torch_fusion_cases.py``, the tile edges
included) through this kernel, each byte-equal to ``fused_group_ref``
(and the other version's arrays equal to this one's).  Prints the card,
the ptxas report of each version, a line a group and, last, one JSON
object of the times (also written to ``--json``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (after the path)

#: phase 20's Quickstart points: the zones' bbox at this seed, plus the
#: trips of the sample CSV (chip_smoke.py phase_functions)
FN_DATA = ROOT / cs.FN_DATA


#: name -> (what the edit does, [(text, replacement)] on this checkout's
#: csrc/fused_group.cu, whether the answers stay this kernel's)
VARIANTS = {
    "no_specs": ("the aggregate's specs skipped (the mask bits kept)",
                 [("        if (sp.kind == kCountStar || sp.same != s) "
                   "continue;",
                   "        if (sp.kind != -7) continue;")], False),
    "no_program": ("the program skipped (copies, waits and terminal kept)",
                   [("        execute(c, W, smem, stage_off, live);",
                     "        if (c.op == -7) execute(c, W, smem, stage_off,"
                     " live);")], False),
}
#: variants built for more blocks an SM, and the plans they run under
BLOCKS_VARIANTS = {
    f"blocks{b}": (f"{b} blocks an SM: registers held to 65,536 / "
                   f"(256 * {b})",
                   [("__launch_bounds__(kThreads, 2)",
                     f"__launch_bounds__(kThreads, {b})")], True)
    for b in (3, 4)}
BLOCKS_PLANS = {f"blocks{b}": {"PLAN_CHOICES": ((b, 2, 512), (2, 2, 1024),
                                               (1, 2, 128), (1, 1, 128))}
                for b in (3, 4)}
VARIANTS.update(BLOCKS_VARIANTS)
VARIANTS["no_copies"] = (
    "no column copied and no wait: the program and terminal over whatever "
    "the stages hold",
    [("  if (live == 0) return;\n  const int lane",
      "  if (live >= 0) return;\n  const int lane"),
     ("      bar_wait(bar + st, (phase >> st) & 1u);", "")], False)
VARIANTS["copies_only"] = (
    "the program and the specs skipped: the staged copies, the waits, "
    "the mask bits and the barriers",
    VARIANTS["no_specs"][1] + VARIANTS["no_program"][1], False)


def variant_source(name: str) -> Path:
    """This checkout's source with the edits of VARIANTS[name], written
    under the build directory."""
    from mosaic_tpu_torch import _kernels
    text = (_kernels.CSRC / "fused_group.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source once")
        text = text.replace(old, new)
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _kernels.BUILD_DIR / f"variant_{name}.cu"
    out.write_text(text)
    return out


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
    """(library, ptxas lines) of ``src`` built with this checkout's flags
    under the build directory."""
    from mosaic_tpu_torch import _kernels
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _kernels.BUILD_DIR / f"lib{tag}_fused_group-{digest}.so"
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
                           str(out), str(src)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    text = proc.stdout.decode(errors="replace")
    cs.check(proc.returncode == 0, f"nvcc failed on {src}:\n{text}")
    return ctypes.CDLL(str(out)), ptxas_lines(text) + [
        f"{sass_count(out)} SASS instructions"]


def ptxas_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "stack" in ln]


def load_wrapper(path: Path):
    """Another version of ops/fused_group.py as a module of the ops
    package, so that its relative imports resolve to this checkout's."""
    spec = importlib.util.spec_from_file_location(
        "mosaic_tpu_torch.ops._other_fused_group", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


#: name -> (what it changes, the wrapper's plan constants it sets): this
#: kernel under another tile plan, its answers kept
PLANS = {
    "one_block": ("one block an SM at the largest tile that fits 227 KB",
                  {"PLAN_CHOICES": ((1, 2, 128), (1, 1, 128))}),
    "one_block_3": ("one block an SM, three stages",
                    {"PLAN_CHOICES": ((1, 3, 1024), (1, 2, 128),
                                      (1, 1, 128))}),
    "two_blocks_3": ("two blocks an SM, three stages, down to 512 rows",
                     {"PLAN_CHOICES": ((2, 3, 512), (2, 2, 1024),
                                       (1, 2, 128), (1, 1, 128))}),
}


class Version:
    """One K14 build and the wrapper whose layouts it reads (with
    ``patch``, the wrapper's constants set so while it packs):
    ``prepare`` packs a group's columns and returns its buffer, a launch
    (the state words reset first) and the arrays of the output."""

    def __init__(self, lib, wrapper, new_launch: bool, patch=None):
        import torch
        self.lib, self.fg, self.new = lib, wrapper, new_launch
        self.patch = patch or {}
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.fused_group_launch
        fn.argtypes = [vp, ll, ll, vp, vp, i, i, vp] if new_launch else \
            [vp, ll, ll, vp, i, i, vp]
        fn.restype = i
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def prepare(self, prog, cols, n: int, bucket: int):
        fg = self.fg
        saved = {k: getattr(fg, k) for k in self.patch}
        for k, v in self.patch.items():
            setattr(fg, k, v)
        plans = fg.__dict__.get("_PLANS")
        try:
            if plans is not None:
                fg._PLANS = {}
            return self._prepare(prog, cols, n, bucket)
        finally:
            for k, v in saved.items():
                setattr(fg, k, v)
            if plans is not None:
                fg._PLANS = plans

    def _prepare(self, prog, cols, n: int, bucket: int):
        import torch
        fg = self.fg
        buf = torch.from_numpy(fg.pack_inputs(prog, cols, n, bucket)).to(
            cs.DEV)
        sb = 8 * (fg.header_words(prog) + 2 + 3 * len(prog.specs))
        state0 = buf[:sb].clone()
        nbytes = fg.out_layout(prog, bucket)[0]
        stream = torch.cuda.current_stream().cuda_stream
        if self.new:
            plan = fg.plan_program(prog)
            blocks = fg.launch_blocks(prog, n, bucket, self.sms)
            scratch = 8 * blocks * len(prog.specs)
            out = torch.empty(nbytes + scratch, dtype=torch.uint8,
                              device=cs.DEV)
            args = (buf.data_ptr(), n, bucket, out.data_ptr(),
                    out.data_ptr() + nbytes, blocks, plan.smem, stream)
        else:
            blocks = max(1, min(-(-bucket // fg.THREADS),
                                self.sms * fg.BLOCKS_PER_SM))
            out = torch.empty(nbytes, dtype=torch.uint8, device=cs.DEV)
            args = (buf.data_ptr(), n, bucket, out.data_ptr(), blocks,
                    8 * fg.header_words(prog), stream)

        def call():
            buf[:sb].copy_(state0)
            rc = self.lib.fused_group_launch(*args)
            cs.check(rc == 0, f"K14 launch failed: CUDA error {rc}")
            return out[:nbytes]

        def arrays():
            call()
            return fg.unpack_outputs(prog, out[:nbytes].cpu().numpy(),
                                     bucket)

        return buf, call, arrays


def where_differ(prog, bucket: int, got, ref) -> str:
    """Where two output buffers of this wrapper's layout differ: each
    part's count of differing elements, first row and values."""
    import numpy as np
    from mosaic_tpu_torch.ops import fused_group as fg
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    nbytes, item_offs, spec_words = fg.out_layout(prog, bucket)
    parts = [("count", 0, 8, np.int64)]
    if prog.terminal == "project":
        parts.append(("mask", 8, bucket, np.uint8))
        parts += [(f"item {i}", o, bucket * fg.DTYPES[dt].itemsize,
                   fg.DTYPES[dt]) for i, ((_, dt), o) in
                  enumerate(zip(prog.items, item_offs))]
    else:
        parts += [(f"spec {i}", 8 * w, 16, np.int64)
                  for i, w in enumerate(spec_words)]
    out = []
    for label, off, size, dt in parts:
        a = g[off:off + size].view(dt)
        b = r[off:off + size].view(dt)
        bad = np.flatnonzero((a.view(np.uint8).reshape(len(a), -1) !=
                              b.view(np.uint8).reshape(len(b), -1)).any(1))
        if len(bad):
            i = int(bad[0])
            out.append(f"{label}: {len(bad)} differ, first at {i} "
                       f"({a[i]!r} against {b[i]!r}), last at "
                       f"{int(bad[-1])}")
    return "; ".join(out)


def same_arrays(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype and
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(a, b))


def programs(tables: dict, queries: dict) -> dict:
    """{label: (program, columns, n, bucket)} of each query's fused group,
    planned in a CPU session (the program does not depend on the
    device)."""
    from mosaic_tpu_torch import config
    from mosaic_tpu_torch.functions.context import MosaicContext
    from mosaic_tpu_torch.perf import fusion
    from mosaic_tpu_torch.perf.bucketing import pow2_bucket
    from mosaic_tpu_torch.sql import SQLSession, parse
    from mosaic_tpu_torch.sql.planner import planner
    prev = config.default_config()
    config.set_default_config(config.apply_conf(
        prev, "mosaic.planner.force.fusion", "on"))
    try:
        s = SQLSession(MosaicContext("H3", device="cpu"))
        for name, cols in tables.items():
            s.create_table(name, cols)
        got = {}
        for label, (table, q) in queries.items():
            plan = planner.plan_query(parse(q), s)
            cs.check(plan.fusion is not None, f"{label}: no fused group")
            (group,) = plan.fusion.groups
            prog = fusion.encode_group(group)
            cols = [tables[table][name] for _, name, _ in group.cols]
            n = len(cols[0])
            got[label] = (prog, cols, n, pow2_bucket(n))
        return got
    finally:
        config.set_default_config(prev)


def phase22b_groups() -> dict:
    """Phase 22b's four timed groups, their data made as the phase makes
    it: the flagship's first batch through the dense streamed join, and
    phase 20's points with their H3 cells."""
    import csv
    import numpy as np
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.functions.context import MosaicContext
    polys, grid, res = mt.build_workload(n_side=16, grid_name="H3",
                                         zones="taxi")
    idx = mt.build_pip_index(polys, res, grid, device=cs.DEV)
    run = mt.make_streamed_pip_join(idx, grid, polys, chunk=cs.CHUNK,
                                    device=cs.DEV)
    batch = mt.nyc_points(cs.BATCH, seed=cs.SEEDS[0])
    zone, _ = run(batch)
    flag, groups = cs.fusion_flagship_groups(batch, zone)
    ctx = MosaicContext("H3", device=cs.DEV)
    zones_2263, _ = mt.io.read_vector(str(FN_DATA /
                                          "nyc_taxi_zones_2263.shp"))
    zones = ctx.st_transform(zones_2263, 4326)
    with open(FN_DATA / "nyc_taxi_trips_sample.csv") as f:
        trips = np.array([[float(r["pickup_longitude"]),
                           float(r["pickup_latitude"])]
                          for r in csv.DictReader(f)])
    bb = zones.bboxes()
    rng = np.random.default_rng(cs.FN_SEED)
    pts = np.concatenate([np.stack([
        rng.uniform(bb[:, 0].min(), bb[:, 2].max(), cs.FN_POINTS),
        rng.uniform(bb[:, 1].min(), bb[:, 3].max(), cs.FN_POINTS)], -1),
        trips])
    cell = grid.point_to_cell(pts, cs.FN_RES)
    qs, padded = cs.fusion_padded_groups(pts, cell)
    queries = {f"flagship {k}": ("flag", q) for k, q in groups.items()}
    queries.update({f"padded {k}": ("qs", q) for k, q in padded.items()})
    return programs({"flag": flag, "qs": qs}, queries)


def case_groups() -> dict:
    got = {}
    for table, cols, q, label in cs.fusion_case_suite():
        got.update(programs({table: cols}, {label: (table, q)}))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another version of csrc/fused_group.cu")
    ap.add_argument("--old-wrapper", type=Path, default=None,
                    help="the ops/fused_group.py of --other's version")
    ap.add_argument("--probe", nargs="+", type=Path, default=[],
                    help="cut-down copies of this source, timed only")
    ap.add_argument("--variant", nargs="+", default=[],
                    choices=sorted(VARIANTS),
                    help="copies of this checkout's source with one edit")
    ap.add_argument("--plan", nargs="+", default=[], choices=sorted(PLANS),
                    help="this kernel under another tile plan")
    ap.add_argument("--cases", action="store_true",
                    help="also hold the CPU tests' groups")
    ap.add_argument("--reps", type=int, default=50,
                    help="launches a timed turn")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the result here")
    args = ap.parse_args()
    if (args.other is None) != (args.old_wrapper is None):
        ap.error("--other and --old-wrapper go together")
    import numpy as np
    import torch
    from mosaic_tpu_torch import _kernels
    from mosaic_tpu_torch.ops import fused_group as fg
    try:
        name, card = cs.phase_device()
        with ThreadPoolExecutor(
                max_workers=2 + len(args.probe) + len(args.variant)) as pool:
            mine = pool.submit(_kernels.build, "fused_group")
            other = pool.submit(build, args.other, "other") \
                if args.other else None
            probes = {p.name: pool.submit(build, p, "probe")
                      for p in args.probe}
            probes.update({v: pool.submit(build, variant_source(v), v)
                           for v in args.variant})
            mine.result()
            other = other.result() if other else None
            probes = {k: f.result() for k, f in probes.items()}
        lib = _kernels.lib_path("fused_group")
        report = {"this": ptxas_lines(lib.with_suffix(".log").read_text(
            errors="replace")) + [f"{sass_count(lib)} SASS instructions"]}
        this = Version(fg.load_kernel(), fg, True)
        versions = {}
        if other is not None:
            report["other"] = other[1]
            old = load_wrapper(args.old_wrapper)
            versions["other"] = Version(other[0], old,
                                        hasattr(old, "plan_program"))
        for k, (lib, lines) in probes.items():
            report[k] = lines
            versions[k] = Version(lib, fg, True, BLOCKS_PLANS.get(k))
        for k in args.plan:
            versions[k] = Version(this.lib, fg, True, PLANS[k][1])
        for who, lines in report.items():
            for line in lines:
                cs.log(f"[ptxas] {who}: {line}")
        groups = phase22b_groups()
        cases = case_groups() if args.cases else {}
        rows, failed = {}, []
        for label, (prog, cols, n, bucket) in {**groups, **cases}.items():
            buf, call, arrays = this.prepare(prog, cols, n, bucket)
            kept = buf.clone()
            got = call()
            ref = fg.fused_group_ref(prog, kept, n, bucket)
            plan = fg.plan_program(prog)
            if not torch.equal(got, ref):
                failed.append(label)
                cs.log(f"[k14] FAIL {label}: {n} rows, bucket {bucket}, T "
                       f"{plan.tile}, S {plan.stages}, P {plan.slots}: "
                       f"{where_differ(prog, bucket, got, ref)}")
                continue
            mine_arrays = arrays()
            row = {"rows": n, "bucket": bucket, "tile": plan.tile,
                   "stages": plan.stages, "slots": plan.slots,
                   "blocks_per_sm": plan.blocks_per_sm, "smem": plan.smem,
                   "instructions": len(prog.instrs)}
            for who, v in versions.items():
                _, ocall, oarrays = v.prepare(prog, cols, n, bucket)
                kept_answers = who == "other" or who in PLANS or (
                    who in VARIANTS and VARIANTS[who][2])
                if kept_answers and not same_arrays(oarrays(), mine_arrays):
                    if who == "other":
                        # this kernel equals fused_group_ref here
                        row["other_differs_from_ref"] = True
                        cs.log(f"[k14] {label}: the other version's outputs "
                               "differ from fused_group_ref's, which this "
                               "kernel's equal")
                    else:
                        failed.append(label)
                        cs.log(f"[k14] FAIL {label}: {who}'s outputs "
                               "differ from this one's")
                if label in groups:
                    got_t = {"this": [], who: []}
                    for which in (who, "this", "this", who):
                        ms, _ = cs.kernel_device_ms(
                            call if which == "this" else ocall, args.reps,
                            "fused_group_kernel")
                        got_t[which].append(ms)
                    row[who] = got_t
            if label in groups:
                bound = cs.k14_bound(prog, bucket, n)
                row.update(bound_ms=bound["bound_ms"],
                           bound_by=bound["bound_by"], bytes=bound["bytes"])
                if not versions:
                    row["this_ms"], row["source"] = cs.kernel_device_ms(
                        call, args.reps, "fused_group_kernel")
                times = {who: row[who] for who in versions}
                cs.log(f"[k14] {label}: {n} rows, plan T {plan.tile} S "
                       f"{plan.stages} P {plan.slots} x"
                       f"{plan.blocks_per_sm} blocks/SM {plan.smem} B; "
                       f"times {json.dumps(times)} "
                       f"{row.get('this_ms', '')} ms; bound "
                       f"{bound['bound_ms']:.4f} ms ({bound['bytes']} B)")
            else:
                cs.log(f"[k14] {label}: {n} rows, T {plan.tile}, byte-equal"
                       " to fused_group_ref" +
                       (" and to the other version" if other else ""))
            rows[label] = row
            del buf, kept
        cs.check(not failed, f"{len(failed)} groups failed: {failed}")
    except cs.PhaseError as e:
        print(f"k14_compare: FAIL: {e}", file=sys.stderr)
        return 1
    result = {"device": name, "card": card, "ptxas": report, "groups": rows,
              "torch": torch.__version__, "numpy": np.__version__}
    text = json.dumps(result)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
