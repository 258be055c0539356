"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so``,
keyed by a hash of the source, the ``csrc/*.cuh`` headers it may include
and the flags, and loaded with ``ctypes``.  Nothing is built at import: a
kernel is built at its first CUDA use, or ahead of time by :func:`build`
(several at once: :func:`build_all`).  ``-fmad=false`` keeps every multiply
and add separately rounded, which the double-single arithmetic of the
kernels needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "--ptxas-options=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "mosaic_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # an edited header must not reuse a library built from the old one
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    seconds ``nvcc`` took (0.0 when already built); the ptxas report
    lands in ``<lib>.log``.  Raises RuntimeError naming the source when
    the compile fails."""
    out = lib_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                           f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, out)
    return seconds


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """:func:`build` for each name, all ``nvcc`` runs started together;
    ``{name: seconds}``.  Raises the first failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib
