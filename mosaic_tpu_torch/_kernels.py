"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``<cache dir>/lib<name>-<hash>.so``,
keyed by a hash of the source, the ``csrc/*.cuh`` headers it may include
and the flags, and loaded with ``ctypes``.  Nothing is built at import: a
kernel is built at its first CUDA use, or ahead of time by :func:`build`
(several at once: :func:`build_all`).  ``-fmad=false`` keeps every multiply
and add separately rounded, which the double-single arithmetic of the
kernels needs.

The directory is the port's persistent kernel cache, the counterpart of
the JAX package's on-disk XLA cache: ``_build/`` beside this file unless
``mosaic.jit.cache.dir`` (``perf.jit_cache.configure_persistent_cache``)
points it elsewhere, where processes sharing it load what one of them
built.  :func:`load` counts a library it finds there as a persistent hit
and one it has to build as a miss (:func:`cache_stats`; with the metrics
registry on also ``kernels/persistent_hits`` and
``kernels/persistent_misses``).

A kernel that does not build, load or launch raises :class:`KernelError`,
a ``RuntimeError``: no fallback path catches it (the refined join's flat
bailout lets it through), so a broken kernel never hides behind a plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
#: the kernel cache directory when ``mosaic.jit.cache.dir`` is not set
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "--ptxas-options=-v")

_loaded: Dict[str, ctypes.CDLL] = {}

_lock = threading.Lock()
_build_dir: Path = BUILD_DIR
#: libraries :func:`load` found built in the cache directory, and built
_hits = 0
_misses = 0
#: seconds each ``nvcc`` run of this process took, by kernel name
build_seconds: Dict[str, float] = {}


class KernelError(RuntimeError):
    """A hand kernel failed to build, load, match its wrapper or launch."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels of "
                          "mosaic_tpu_torch build on a machine with the "
                          "CUDA toolkit")
    return found


def build_dir() -> Path:
    """The kernel cache directory libraries are built into and loaded
    from."""
    return _build_dir


def set_build_dir(path) -> Path:
    """Point the kernel cache at ``path`` (None: back to ``_build/``); a
    library already loaded in this process stays loaded."""
    global _build_dir
    with _lock:
        _build_dir = BUILD_DIR if path is None else Path(path)
        return _build_dir


def cache_stats() -> Dict[str, int]:
    """``{"persistent_hits", "persistent_misses"}`` of this process's
    loads."""
    with _lock:
        return {"persistent_hits": _hits, "persistent_misses": _misses}


def reset_cache_stats() -> None:
    global _hits, _misses
    with _lock:
        _hits = _misses = 0


def _count_load(hit: bool) -> None:
    global _hits, _misses
    with _lock:
        if hit:
            _hits += 1
        else:
            _misses += 1
    from .obs.metrics import metrics
    if metrics.enabled:
        metrics.count("kernels/persistent_hits" if hit
                      else "kernels/persistent_misses")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # an edited header must not reuse a library built from the old one
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    seconds ``nvcc`` took (0.0 when already built); the ptxas report
    lands in ``<lib>.log``.  Raises :class:`KernelError` naming the source
    when the compile fails."""
    out = lib_path(name)
    if out.exists():
        return 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_bytes(proc.stdout)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed on csrc/{name}.cu:\n"
                          f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, out)
    build_seconds[name] = seconds
    return seconds


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """:func:`build` for each name, all ``nvcc`` runs started together;
    ``{name: seconds}``.  Raises the first failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.  Its
    first load in a process counts a persistent hit when the cache
    directory holds the library already, else a miss, before ``nvcc`` runs
    (a build or load that fails raises :class:`KernelError` all the
    same)."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        hit = path.exists()
        _count_load(hit)
        if not hit:
            build(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"csrc/{name}.cu's library does not load: "
                              f"{e}") from e
        _loaded[name] = lib
    return lib
