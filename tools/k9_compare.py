#!/usr/bin/env python3
"""K9, the raster stencil, against another version of its source on one
card: the edge set of ``chip_smoke.py`` on this checkout's kernel, then on
each of ``chip_smoke.py``'s timed K9 cases every kernel bit-equal to
``convolve_ref`` and each other version timed against this one in turns
(other, this, this, other), each turn the profiler's device time of 50
launches; beside them ``Tensor.copy_`` of the raster (CUDA events), which
moves the bytes of the bound and nothing else.

    git show REV:mosaic_tpu_torch/csrc/raster_convolve.cu > OLD.cu
    python3 tools/k9_compare.py --other OLD.cu [MORE.cu ...] [--json OUT]

The other source is built with this checkout's ``nvcc`` flags.  A library
without ``raster_convolve_instances`` has the thread-a-pixel interface of
the first version (no instance argument).  Prints the card, the ptxas
report of this checkout's kernel, a line a case and, last, one JSON
object of the times (also written to ``--json``).
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


def build_other(src: Path) -> ctypes.CDLL:
    from mosaic_tpu_torch import _kernels
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _kernels.BUILD_DIR / f"libother_raster_convolve-{digest}.so"
    if not out.exists():
        _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
                        str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    instanced = hasattr(lib, "raster_convolve_instances")
    for name in ("raster_convolve_f64_launch", "raster_convolve_f32_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i, i, i, vp, i, i] + ([i] if instanced else []) \
            + [vp, vp]
        fn.restype = i
    lib.instanced = instanced
    return lib


def other_call(lib, x, w):
    """The other kernel on x [B, H, W] and w [kh, kw]: one launch."""
    import torch
    from mosaic_tpu_torch.ops.raster_convolve import launch_plan
    out = torch.empty_like(x)
    fn = (lib.raster_convolve_f64_launch if x.dtype == torch.float64
          else lib.raster_convolve_f32_launch)
    B, H, W = x.shape
    kh, kw = w.shape
    extra = [launch_plan(x.shape, w.shape, x.element_size())] \
        if lib.instanced else []
    rc = fn(x.data_ptr(), B, H, W, w.data_ptr(), kh, kw, *extra,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"the other kernel's launch failed: CUDA error {rc}")
    return out


def cases():
    """chip_smoke.py's timed K9 cases: (label, x [B, H, W], w)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(cs.K9_SEED)
    tile = cs.srtm_tile()
    data = np.where(tile.valid_mask(), tile.data, 0.0)
    x64 = torch.from_numpy(data).to(cs.DEV)
    x32 = torch.from_numpy(data.astype(np.float32)).to(cs.DEV)
    out = [(f"f64 {s[0]}x{s[1]} srtm", x64,
            torch.from_numpy(rng.normal(0, 1, s)).to(cs.DEV))
           for s in cs.K9_SHAPES]
    w32 = torch.from_numpy(rng.normal(0, 1, cs.K9_HALO_SHAPE).astype(
        np.float32)).to(cs.DEV)
    yy, xx = np.mgrid[0:cs.DEM_SHAPE[0], 0:cs.DEM_SHAPE[1]]
    dem = np.asarray((np.sin(xx / 60.0) * 50 + yy * 0.1)[None], np.float32)
    halo = f"f32 {cs.K9_HALO_SHAPE[0]}x{cs.K9_HALO_SHAPE[1]} halo"
    out += [(f"{halo} dem", torch.from_numpy(dem).to(cs.DEV), w32),
            (f"{halo} srtm", x32, w32)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, nargs="+",
                    help="other versions of csrc/raster_convolve.cu")
    ap.add_argument("--json", type=Path, default=None,
                    help="also write the result here")
    args = ap.parse_args()
    import torch
    from mosaic_tpu_torch import _kernels
    from mosaic_tpu_torch.ops.raster_convolve import (convolve_ref,
                                                      raster_convolve)
    try:
        name, card = cs.phase_device()
        _kernels.build("raster_convolve")
        report = _kernels.lib_path("raster_convolve").with_suffix(".log")
        for line in report.read_text(errors="replace").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                cs.log(f"[ptxas] {line.strip()}")
        with ThreadPoolExecutor(max_workers=len(args.other)) as pool:
            others = dict(zip(map(str, args.other),
                              pool.map(build_other, args.other)))
        edges = cs.k9_edge_set()
        rows = {}
        for label, x, w in cases():
            ref = convolve_ref(x, w)
            cs.check(cs.same_bits(raster_convolve(x, w), ref),
                     f"{label}: this kernel differs from convolve_ref")
            for other in others.values():
                cs.check(cs.same_bits(other_call(other, x, w), ref),
                         f"{label}: another kernel differs from "
                         "convolve_ref")
            bound, by = cs.conv_bound(x, w)
            y = torch.empty_like(x)
            copy_ms = cs.time_ms(lambda: y.copy_(x), 50)
            del y
            rows[label] = {"bound_ms": bound, "bound_by": by,
                           "copy_ms": copy_ms}
            cs.log(f"[k9] {label}: copy_ of the raster (its bytes read "
                   f"and written once) {copy_ms:.4f} ms")
            for path, other in others.items():
                turns = []
                for which in ("other", "this", "this", "other"):
                    fn = (lambda: raster_convolve(x, w)) if which == "this" \
                        else (lambda: other_call(other, x, w))
                    ms, source = cs.kernel_device_ms(fn, 50,
                                                     "convolve_kernel")
                    turns.append((which, ms, source))
                mine = [t[1] for t in turns if t[0] == "this"]
                theirs = [t[1] for t in turns if t[0] == "other"]
                rows[label][path] = {
                    "this_ms": mine, "other_ms": theirs,
                    "sources": sorted({t[2] for t in turns})}
                cs.log(f"[k9] {label} against {path}: this {mine} ms, "
                       f"other {theirs} ms; bound {bound:.4f} ms ({by}), "
                       f"shares {bound / (sum(mine) / 2):.3f} and "
                       f"{bound / (sum(theirs) / 2):.3f}")
    except cs.PhaseError as e:
        print(f"k9_compare: FAIL: {e}", file=sys.stderr)
        return 1
    result = {"device": name, "card": card, "edge_cases": edges,
              "cases": rows, "torch": torch.__version__}
    text = json.dumps(result)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
