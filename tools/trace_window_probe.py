"""Which device records a ``torch.profiler`` trace keeps as a process ages.

Runs ``chip_smoke.py``'s phases as ``python3 chip_smoke.py`` does, with a
probe after each phase.  A probe traces four small elementwise kernels
(four others queued just before the window) under three windows: unpadded,
and opened and closed 0.05 s and 1 s away from the device work.  For each
it prints how many kernel records the Chrome trace kept, how many of them
link by correlation id to a launch inside the window, and each linked
record's start less its launch's (ms).  It prints the drift of
CLOCK_REALTIME against CLOCK_MONOTONIC_RAW and CLOCK_MONOTONIC since the
first probe.  After the overlay phase and every other phase past it, the
same probe also runs in a fresh child process (windows unpadded, 0.05 s,
0.5 s and 1 s), so a loss that follows the process and one that follows
the card tell apart.

Run it from the repository's root on a machine with a CUDA card, with
kineto's record counts (its out-of-window count among them) on stderr:

    KINETO_LOG_LEVEL=1 python3 tools/trace_window_probe.py > probe.log 2> kineto.log
    grep -E 'trace probe|host planes\\] traced' probe.log

Its exit code is ``chip_smoke.py``'s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("phase_build", "phase_kernel", "phase_flagship",
          "phase_join_kernel", "phase_cell_kernel", "phase_sorted_custom",
          "phase_sorted_h3", "phase_sorted_bng", "phase_overlay",
          "phase_knn", "phase_chips", "phase_strategies", "phase_raster",
          "phase_sharded", "phase_store", "phase_geometry",
          "phase_host_planes")
#: phases after which the probe also runs in a child process
CHILD_AFTER = ("phase_overlay", "phase_knn", "phase_strategies",
               "phase_sharded", "phase_geometry", "phase_host_planes")


def window(pad: float, x) -> dict:
    """One trace of four ``add_`` kernels, four ``mul_`` queued before
    the window, the window opened ``pad`` s after the device went idle
    and closed ``pad`` s after the body's work finished."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            for _ in range(4):
                x.mul_(1.0001)
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
            time.sleep(pad)
            for _ in range(4):
                x.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    launched = {e["args"]["correlation"]: e["ts"] for e in evs
                if e.get("cat") == "cuda_runtime" and
                "correlation" in e.get("args", {})}
    kern = [e for e in evs if e.get("cat") == "kernel"]
    linked = [round((e["ts"] - launched[e["args"]["correlation"]]) / 1e3, 3)
              for e in kern
              if e.get("args", {}).get("correlation") in launched]
    return {"kernels": len(kern), "linked": len(linked),
            "start_less_launch_ms": linked}


def child() -> int:
    """``--child``: the probe in this fresh process; JSON on stdout."""
    import torch
    x = torch.ones(1 << 24, device="cuda")
    print(json.dumps({f"pad{p}": window(p, x)
                      for p in (0.0, 0.05, 0.5, 1.0)}))
    return 0


def clocks():
    rt = time.clock_gettime(time.CLOCK_REALTIME)
    return (rt - time.clock_gettime(time.CLOCK_MONOTONIC_RAW),
            rt - time.clock_gettime(time.CLOCK_MONOTONIC))


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    first = {}

    def probe(phase: str) -> None:
        import torch
        x = torch.ones(1 << 24, device="cuda")
        c = clocks()
        first.setdefault("clocks", c)
        first.setdefault("t", time.perf_counter())
        out = {"after": phase,
               "t_s": round(time.perf_counter() - first["t"], 1),
               "rt_minus_raw_ms": round(
                   (c[0] - first["clocks"][0]) * 1e3, 3),
               "rt_minus_mono_ms": round(
                   (c[1] - first["clocks"][1]) * 1e3, 3),
               **{f"pad{p}": window(p, x) for p in (0.0, 0.05, 1.0)}}
        if phase in CHILD_AFTER:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, __file__, "--child"],
                               capture_output=True, text=True)
            out["child"] = (json.loads(r.stdout.strip().splitlines()[-1])
                            if r.returncode == 0 else r.stderr[-500:])
            out["child_s"] = round(time.perf_counter() - t0, 1)
        cs.log("[trace probe] " + json.dumps(out))

    def after(name: str):
        fn = getattr(cs, name)

        def wrapped(*args, **kwargs):
            res = fn(*args, **kwargs)
            probe(name)
            return res
        return wrapped

    for name in PHASES:
        setattr(cs, name, after(name))
    return cs.main()


if __name__ == "__main__":
    sys.exit(child() if sys.argv[1:2] == ["--child"] else main())
