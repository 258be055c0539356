"""Native (C++) exact-geometry kernels of the port's host side.

Port of ``mosaic_tpu.native``.  ``geokernels.cpp`` (the port's own copy)
is compiled with ``g++`` at first use into
``mosaic_tpu_torch/_build/geokernels-<hash>.so``, keyed by a hash of the
source, and loaded with ``ctypes``.  Three entry points are bound: the
whole-polygon PIP oracle :func:`pip_first_match`, the chip-parity
recheck :func:`recheck_zones` and the overlay's exact pair areas
:func:`intersect_area_pairs`.

Unlike the JAX package's loader there is no silent fallback: a failed
build raises RuntimeError.  The numpy versions of the first two stay in
``parallel/pip_join.py`` as the plain versions the tests compare
against, and run only when a caller asks for them; the pair areas'
exact host engine is ``core.geometry.clip.rings_intersection``.  Each wrapper
counts its calls in ``<function>.calls``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "geokernels.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

#: zone slots per cell the native recheck handles (its counts array)
MAX_ZONE_SLOTS = 16


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"geokernels-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library unless it is built already; the seconds ``g++``
    took (0.0 when built).  Raises RuntimeError with the compiler's
    output when the compile fails."""
    import time
    out = lib_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, then an atomic rename: concurrent
    # processes never load a half-written library
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                           f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use, with its C signatures."""
    build()
    lib = ctypes.CDLL(str(lib_path()))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pip_first_match.argtypes = [vp, i64, vp, vp, i64, vp]
    lib.pip_first_match.restype = None
    lib.recheck_zones.argtypes = [vp, vp, i64, vp, vp, vp, vp, i64,
                                  ctypes.c_double, vp, vp]
    lib.recheck_zones.restype = None
    lib.intersect_area_pairs.argtypes = [vp, vp, vp, vp, vp, vp, i64,
                                         ctypes.c_double, vp]
    lib.intersect_area_pairs.restype = None
    return lib


def pip_first_match(points: np.ndarray, edges: np.ndarray,
                    geom_start: np.ndarray) -> np.ndarray:
    """First geometry containing each point (crossing number, the
    half-open rule of ``tessellate._pip``), or -1.

    points [N, 2] f64; edges [E, 4] f64 (ax, ay, bx, by); geom_start
    [G + 1] CSR offsets of each geometry's edges."""
    pts = np.ascontiguousarray(np.asarray(points)[:, :2], np.float64)
    ed = np.ascontiguousarray(edges, np.float64).reshape(-1, 4)
    gs = np.ascontiguousarray(geom_start, np.int64)
    if gs.ndim != 1 or len(gs) < 1 or gs[0] != 0 or gs[-1] != len(ed) or \
            np.any(np.diff(gs) < 0):
        raise ValueError("geom_start must be CSR offsets over the edges")
    out = np.empty(len(pts), np.int32)
    get_lib().pip_first_match(pts.ctypes.data, len(pts), ed.ctypes.data,
                              gs.ctypes.data, len(gs) - 1, out.ctypes.data)
    pip_first_match.calls += 1
    return out


pip_first_match.calls = 0


def recheck_zones(points: np.ndarray, group: np.ndarray, edges: np.ndarray,
                  ezslot: np.ndarray, gstart: np.ndarray,
                  gzones: np.ndarray, near_eps: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(zone, near) per (point, group): the first zone slot of the
    point's group whose edges it crosses an odd number of times, or -1;
    and whether the point lies closer than ``near_eps`` to an edge of its
    group.

    points [N, 2] f64; group [N] (row of gstart, -1 skips the point);
    edges [E, 4] f64; ezslot [E] zone slot per edge; gstart [G + 1];
    gzones [G, Z] zone per slot, Z <= MAX_ZONE_SLOTS.  Returns [N] int32
    and [N] bool."""
    pts = np.ascontiguousarray(points, np.float64)
    grp = np.ascontiguousarray(group, np.int64)
    ed = np.ascontiguousarray(edges, np.float64)
    ez = np.ascontiguousarray(ezslot, np.int32)
    gs = np.ascontiguousarray(gstart, np.int64)
    gz = np.ascontiguousarray(gzones, np.int32)
    if gz.ndim != 2 or gz.shape[1] > MAX_ZONE_SLOTS:
        raise ValueError(f"recheck_zones takes at most {MAX_ZONE_SLOTS} "
                         f"zone slots, got gzones {gz.shape}")
    if len(grp) != len(pts) or len(ez) != len(ed) or \
            len(gs) != gz.shape[0] + 1 or (len(grp) and grp.max() >= len(gz)):
        raise ValueError("recheck_zones: inconsistent table sizes")
    out = np.empty(len(pts), np.int32)
    near = np.empty(len(pts), np.uint8)
    get_lib().recheck_zones(pts.ctypes.data, grp.ctypes.data, len(pts),
                            ed.ctypes.data, ez.ctypes.data, gs.ctypes.data,
                            gz.ctypes.data, gz.shape[1],
                            float(near_eps) ** 2, near.ctypes.data,
                            out.ctypes.data)
    recheck_zones.calls += 1
    return out, near.astype(bool)


recheck_zones.calls = 0


def _check_pool(off: np.ndarray, idx: np.ndarray, n_edges: int,
                side: str) -> None:
    if off.ndim != 1 or len(off) < 1 or off[0] != 0 or \
            off[-1] != n_edges or np.any(np.diff(off) < 0):
        raise ValueError(f"off_{side} must be CSR offsets over edges_{side}")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(off) - 1):
        raise ValueError(f"idx_{side} names a slot outside the pool")


def intersect_area_pairs(edges_a: np.ndarray, off_a: np.ndarray,
                         idx_a: np.ndarray, edges_b: np.ndarray,
                         off_b: np.ndarray, idx_b: np.ndarray,
                         eps: float = 1e-9) -> np.ndarray:
    """Exact f64 area(A∩B) per pair via boundary-fragment shoelace sums
    (no ring stitching — see geokernels.cpp).

    edges_* [E, 4] f64 are region-left directed edge POOLS over distinct
    geometries (shells CCW, holes CW), off_* their CSR offsets, idx_* [P]
    the pool slot of each pair's side.  Returns [P] f64 areas; a pair
    where one edge collects more split points than the kernel's buffer
    holds comes back NaN, and the caller must resolve it exactly
    (``clip.pairs_intersection_area`` runs ``rings_intersection``)."""
    ea = np.ascontiguousarray(edges_a, np.float64).reshape(-1, 4)
    eb = np.ascontiguousarray(edges_b, np.float64).reshape(-1, 4)
    oa = np.ascontiguousarray(off_a, np.int64)
    ob = np.ascontiguousarray(off_b, np.int64)
    xa = np.ascontiguousarray(idx_a, np.int64)
    xb = np.ascontiguousarray(idx_b, np.int64)
    if len(xa) != len(xb):
        raise ValueError(f"pair lists differ in length: {len(xa)} vs "
                         f"{len(xb)}")
    _check_pool(oa, xa, len(ea), "a")
    _check_pool(ob, xb, len(eb), "b")
    out = np.empty(len(xa), np.float64)
    get_lib().intersect_area_pairs(ea.ctypes.data, oa.ctypes.data,
                                   xa.ctypes.data, eb.ctypes.data,
                                   ob.ctypes.data, xb.ctypes.data, len(xa),
                                   float(eps), out.ctypes.data)
    intersect_area_pairs.calls += 1
    return out


intersect_area_pairs.calls = 0
