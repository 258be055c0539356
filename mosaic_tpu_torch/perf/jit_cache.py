"""Process-level cache of built kernels, keyed by name and shape.

Port of ``mosaic_tpu.perf.jit_cache.JitCache`` and ``kernel_cache``.  A
:class:`JitCache` is a bounded, thread-safe LRU keyed on ``(kernel name,
shape/dtype/static-arg key)`` with hit, miss and eviction counters (kept
locally and, with the registry on, in ``obs.metrics`` under
``perf/jit_cache/hit|miss|evict`` and ``.../miss/<name>``); every new
entry seeds a kernel-ledger row (``obs.profiler``).

What an entry holds differs from the JAX package's, where it is a
``jax.jit`` wrapper that compiles at its first call.  The port compiles
nothing at run time: its kernels are built from ``csrc/`` once, keyed by
their sources' hash (``_kernels.py``).  The SQL fusion pass caches the
encoded K14 program of a fusion group here (``perf/fusion.py``), one
entry per group signature (the program does not depend on the row
bucket), so the cache's ``misses`` count the programs encoded and no
entry ever compiles.  The JAX
package's wrapper that notes a jitted entry's output bytes with the
memory ledger has no counterpart: the fusion pass registers its group's
output itself (``fusion/<name>``).

:func:`configure_persistent_cache` is the port of the JAX package's,
which wires XLA's on-disk compilation cache to ``mosaic.jit.cache.dir``.
What the port caches on disk is its hand kernels' libraries, so the
directory it wires is the kernel build directory (``_kernels``): a
process pointed at a directory another one built into loads the
libraries without running ``nvcc``, and ``_kernels.cache_stats()`` counts
the persistent hits and misses (the server's ``stats()["jit"]``).  The
JAX package's compile-threshold settings have no counterpart.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

from ..obs.metrics import metrics

__all__ = ["JitCache", "kernel_cache", "configure_persistent_cache",
           "persistent_cache_dir"]

#: env var mirroring the ``mosaic.jit.cache.dir`` conf key
JIT_CACHE_DIR_ENV = "MOSAIC_TPU_JIT_CACHE_DIR"


class JitCache:
    """Bounded LRU of encoded programs (the fusion groups'), thread-safe.

    Keys are ``(name, key)`` where ``name`` identifies the entry's kind (a
    stable string, NOT a function id — ids recycle) and ``key`` captures
    everything the entry depends on: padded shapes, dtypes, static
    arguments."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, name: str, key, build: Callable[[], object]):
        """Return the cached entry for ``(name, key)``, building (and
        caching) it on first use; ``build`` runs inside the miss path's
        lock."""
        full = (name, key)
        with self._lock:
            fn = self._entries.get(full)
            if fn is not None:
                self._entries.move_to_end(full)
                self.hits += 1
                if metrics.enabled:
                    metrics.count("perf/jit_cache/hit")
                return fn
            fn = build()
            self._entries[full] = fn
            self.misses += 1
            if metrics.enabled:
                metrics.count("perf/jit_cache/miss")
                metrics.count(f"perf/jit_cache/miss/{name}")
            try:
                # seed a kernel-ledger row so every named cache entry
                # shows up in profiler reports before its first launch
                from ..obs.profiler import ledger
                ledger.register(name, key)
            except Exception:
                pass
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
                if metrics.enabled:
                    metrics.count("perf/jit_cache/evict")
        return fn

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries)}


#: the process-global cache the fusion pass's programs go through
kernel_cache = JitCache()


_persist_lock = threading.Lock()
_persist_dir: Optional[str] = None


def persistent_cache_dir() -> Optional[str]:
    """The directory the persistent kernel cache was wired to in this
    process (None = not configured: ``_build/``)."""
    return _persist_dir


def configure_persistent_cache(path: Optional[str] = None
                               ) -> Optional[str]:
    """Point the persistent kernel cache at ``path``.

    Resolution order: explicit argument > ``MOSAIC_TPU_JIT_CACHE_DIR``
    env > the active config's ``mosaic.jit.cache.dir``.  Returns the
    resolved directory, or None when nothing is configured (a no-op: the
    kernels stay in ``_build/``).  Idempotent; re-pointing at a different
    directory is honored (last call wins) and recorded as a ``config``
    flight-recorder event.  Libraries already loaded in this process stay
    loaded; the next kernel's first load looks in the new directory."""
    global _persist_dir
    if path is None:
        path = os.environ.get(JIT_CACHE_DIR_ENV)
    if path is None:
        from ..config import default_config
        path = getattr(default_config(), "jit_cache_dir", "") or None
    if not path:
        return _persist_dir
    path = str(path)
    with _persist_lock:
        if _persist_dir == path:
            return _persist_dir
        os.makedirs(path, exist_ok=True)
        from .. import _kernels
        _kernels.set_build_dir(path)
        _persist_dir = path
    from ..obs.recorder import recorder
    recorder.record("config", key="mosaic.jit.cache.dir", value=path)
    return _persist_dir
