#!/usr/bin/env python3
"""Time the streamed dense flagship join with and without the host
planes' disarmed probes on one card: what they cost on the main path.

    python3 tools/host_planes_ab.py --other OTHER_ROOT [--reps 5] [--rounds 2]
    python3 tools/host_planes_ab.py --stub [--reps 10] [--rounds 3]

OTHER_ROOT is another checkout of the repository (for example the parent
commit, unpacked with ``git archive REV | tar -x -C DIR``).  Each turn is
a fresh process on one tree: it builds the flagship workload (281 taxi
zones, H3 res 9), its dense index on the card and the streamed join in
2^18-row chunks, warms it on the four 2^22-point batches of
``chip_smoke.py`` phase 5 (seeds 100-103), then times ``--reps`` passes
over them, each ended at a ``torch.cuda.synchronize()`` (host clock).
The turns go other, this, this, other, ``--rounds`` times.  Every turn
prints one JSON line (tree, pass seconds, points/s, a digest of the
zones), and the last line holds both trees' medians and whether every
turn's zones were equal.  No fault plan is armed and no tracer is on:
the probes run disarmed, as on every path of a user's call.

With ``--stub`` every turn is one process on this tree that alternates
passes with the probes live and with them replaced by no-ops (the
executor's chunk-boundary ``checkpoint``, ``pipeline.chunk`` stall and
``pipeline.fetch`` fault site; the join's entry ``checkpoint``,
``root_trace`` and span), ``--reps`` of each, live first in odd turns
and stubbed first in even ones.  The process's placement, pinned buffers
and warm caches are then shared by both arms.  Each turn also times the
live per-chunk probe sequence alone, 200,000 times (host clock).  The
last line holds both arms' medians, the median of the paired
differences (live minus stubbed, pass by pass) with its interquartile
range, the probes' microseconds a chunk, and whether every pass's zones
were equal.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]

TURN = r"""
import hashlib, json, sys, time
root, reps = sys.argv[1], int(sys.argv[2])
sys.modules["jax"] = None
sys.modules["mosaic_tpu"] = None
sys.path.insert(0, root)
import torch
import mosaic_tpu_torch as mt
polys, grid, res = mt.build_workload(n_side=16, grid_name="H3",
                                     zones="taxi")
idx = mt.build_pip_index(polys, res, grid)
run = mt.make_streamed_pip_join(idx, grid, polys, chunk=1 << 18)
batches = [mt.nyc_points(1 << 22, seed=s) for s in (100, 101, 102, 103)]
for b in batches:
    run(b)
walls = []
for _ in range(reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zones = [run(b)[0] for b in batches]
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
digest = hashlib.sha256(b"".join(z.tobytes() for z in zones)).hexdigest()
n = sum(len(b) for b in batches)
print(json.dumps({"root": root, "pass_s": walls,
                  "points_per_s": [n / w for w in walls],
                  "zones_sha256": digest}))
"""


STUB_TURN = r"""
import contextlib, hashlib, json, sys, time, types
root, reps, live_first = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
sys.modules["jax"] = None
sys.modules["mosaic_tpu"] = None
sys.path.insert(0, root)
import torch
import mosaic_tpu_torch as mt
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.perf import pipeline
from mosaic_tpu_torch.obs.inflight import checkpoint
from mosaic_tpu_torch.resilience import faults
polys, grid, res = mt.build_workload(n_side=16, grid_name="H3",
                                     zones="taxi")
idx = mt.build_pip_index(polys, res, grid)
run = mt.make_streamed_pip_join(idx, grid, polys, chunk=1 << 18)
batches = [mt.nyc_points(1 << 22, seed=s) for s in (100, 101, 102, 103)]
none = lambda *a, **k: None
null = lambda *a, **k: contextlib.nullcontext()
stubs = [(pipeline, "checkpoint", none),
         (pipeline, "faults", types.SimpleNamespace(stall=none,
                                                    maybe_fail=none)),
         (tpj, "checkpoint", none), (tpj, "root_trace", null),
         (tpj, "tracer", types.SimpleNamespace(span=null, count=none))]
live = [(m, k, getattr(m, k)) for m, k, _ in stubs]

def arm(which):
    for m, k, v in which:
        setattr(m, k, v)

def one_pass():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zones = [run(b)[0] for b in batches]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, hashlib.sha256(
        b"".join(z.tobytes() for z in zones)).hexdigest()

for which in (stubs, live):
    arm(which)
    for b in batches:
        run(b)
walls = {"live": [], "stubbed": []}
digests = set()
order = ("live", "stubbed") if live_first else ("stubbed", "live")
for _ in range(reps):
    for name in order:
        arm(live if name == "live" else stubs)
        w, d = one_pass()
        walls[name].append(w)
        digests.add(d)
arm(live)
n = 200_000
t0 = time.perf_counter()
for _ in range(n):
    checkpoint("pipeline.stream")
    faults.stall("pipeline.chunk")
    faults.maybe_fail("pipeline.fetch")
probe_us = (time.perf_counter() - t0) / n * 1e6
print(json.dumps({"root": root, "live_first": live_first,
                  "live_s": walls["live"], "stubbed_s": walls["stubbed"],
                  "probe_us_per_chunk": probe_us,
                  "chunks_per_pass": sum(-(-len(b) // (1 << 18))
                                         for b in batches),
                  "zones_sha256": sorted(digests)}))
"""


def turn(root: Path, reps: int, script: str = TURN, *extra: str) -> dict:
    out = subprocess.run([sys.executable, "-c", script, str(root),
                          str(reps), *extra],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"turn on {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--stub", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if args.stub:
        return stubbed(args.reps, args.rounds)
    if args.other is None:
        ap.error("give --other OTHER_ROOT or --stub")
    other = args.other.resolve()
    sides = {"this": [], "other": []}
    digests = set()
    for _ in range(args.rounds):
        for name, root in (("other", other), ("this", THIS),
                           ("this", THIS), ("other", other)):
            r = turn(root, args.reps)
            r["tree"] = name
            print(json.dumps(r), flush=True)
            sides[name].extend(r["pass_s"])
            digests.add(r["zones_sha256"])
    med = {k: statistics.median(v) for k, v in sides.items()}
    print(json.dumps({"median_pass_s": med,
                      "this_over_other": med["this"] / med["other"],
                      "passes": {k: len(v) for k, v in sides.items()},
                      "zones_equal": len(digests) == 1}))
    return 0


def stubbed(reps: int, rounds: int) -> int:
    live, stub, diffs, probe_us, digests = [], [], [], [], set()
    for k in range(rounds):
        r = turn(THIS, reps, STUB_TURN, "1" if k % 2 == 0 else "0")
        print(json.dumps(r), flush=True)
        live.extend(r["live_s"])
        stub.extend(r["stubbed_s"])
        diffs.extend(a - b for a, b in zip(r["live_s"], r["stubbed_s"]))
        probe_us.append(r["probe_us_per_chunk"])
        digests.update(r["zones_sha256"])
    q = statistics.quantiles(diffs, n=4)
    print(json.dumps({
        "median_pass_s": {"live": statistics.median(live),
                          "stubbed": statistics.median(stub)},
        "median_live_minus_stubbed_s": statistics.median(diffs),
        "iqr_live_minus_stubbed_s": [q[0], q[2]],
        "passes": len(diffs),
        "probe_us_per_chunk": statistics.median(probe_us),
        "chunks_per_pass": r["chunks_per_pass"],
        "zones_equal": len(digests) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
