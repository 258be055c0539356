"""Device memory watermarks from ``torch.cuda``.

Port of the device-memory half of ``mosaic_tpu.obs.jaxmon`` (the file
keeps its name so that a reader finds the counterpart).  The JAX
package reads ``Device.memory_stats()``; the port reads the CUDA caching
allocator's ``torch.cuda.memory_stats(i)``: ``allocated_bytes.all.peak``
and ``.current``, with source ``allocator``.  A CPU device has no
allocator statistics, so the host's peak RSS stands in, as the JAX
package's CPU backend does (source ``host_rss``).

Device keys are ``f"{device.type}:{index or 0}"``: ``cuda:0`` on the
card, ``cpu:0`` on a CPU host — the spelling ``memwatch`` and
``devicemon`` use too.

Nothing here initializes CUDA: with no device given, the CUDA devices
are read only once CUDA has been initialized by something else, so a
sampler tick or a crash bundle on a fresh process reads ``cpu:0`` alone.

The JAX half of the module — ``install_jax_listeners`` (compile events
from ``jax.monitoring``, the recompile-storm warning) and
``record_cost_analysis`` (XLA cost-model figures) — has no counterpart:
the port has no jit, so nothing compiles at run time and the cost
vector's ``compiles`` stays 0 (ROADMAP C14).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

from .metrics import metrics

__all__ = ["sample_memory", "last_watermarks", "device_capacity",
           "device_key"]


def device_key(device) -> str:
    """``<type>:<index>`` of a ``torch.device`` (index 0 when unset)."""
    return f"{device.type}:{device.index or 0}"


def _cuda_ready():
    """The torch module when CUDA is initialized in this process, else
    None (reading it then would initialize it)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch


def _devices(devices) -> List:
    """``devices`` as ``torch.device``s; by default every CUDA device
    when CUDA is initialized, else the CPU."""
    import torch
    if devices is not None:
        return [torch.device(d) for d in devices]
    t = _cuda_ready()
    if t is None:
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(t.cuda.device_count())]


#: most recent sample_memory() result — the flight recorder embeds it
#: in dump bundles so a post-mortem shows the last known watermarks
#: even when the registry was disabled
_last_watermarks: Dict[str, Dict[str, Optional[float]]] = {}


def last_watermarks() -> Dict[str, Dict[str, Optional[float]]]:
    """The most recent :func:`sample_memory` result (``{}`` before the
    first sample)."""
    return dict(_last_watermarks)


def sample_memory(devices=None) -> Dict[str, Dict[str, Optional[float]]]:
    """Sample per-device memory watermarks into gauges.

    For each device, records ``mem/peak_bytes/<type>:<index>`` (max-
    tracked, so repeated samples keep the high-water mark) and
    ``mem/source/<type>:<index>`` (1 = allocator stats, 0 = host-RSS
    fallback), and returns the raw stats.  CUDA devices report the
    caching allocator's ``allocated_bytes.all.peak`` / ``.current``; a
    CPU device falls back to the process peak RSS.  The
    ``obs.timeseries`` sampler calls this (through ``obs.devicemon``) on
    its cadence."""
    out: Dict[str, Dict[str, Optional[float]]] = {}
    host_peak = _host_peak_rss_bytes()
    for d in _devices(devices):
        key = device_key(d)
        st = None
        if d.type == "cuda":
            t = _cuda_ready()
            if t is not None:
                try:
                    st = t.cuda.memory_stats(d)
                except Exception:
                    st = None
        if st:
            cur = float(st.get("allocated_bytes.all.current", 0.0))
            peak = float(st.get("allocated_bytes.all.peak", cur))
            out[key] = {"peak_bytes": peak, "bytes_in_use": cur,
                        "source": "allocator"}
        else:
            peak = float(host_peak)
            out[key] = {"peak_bytes": peak, "bytes_in_use": None,
                        "source": "host_rss"}
        metrics.gauge_max(f"mem/peak_bytes/{key}", peak)
        metrics.gauge(f"mem/source/{key}",
                      1.0 if out[key]["source"] == "allocator" else 0.0)
    if host_peak:
        metrics.gauge_max("mem/host_peak_rss_bytes", float(host_peak))
    _last_watermarks.clear()
    _last_watermarks.update(out)
    return out


def _host_peak_rss_bytes() -> int:
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def _host_total_bytes() -> int:
    """Total physical host memory (the CPU device's capacity stand-in);
    0 when the platform can't say."""
    try:
        return int(os.sysconf("SC_PHYS_PAGES")) * \
            int(os.sysconf("SC_PAGE_SIZE"))
    except (AttributeError, OSError, ValueError):
        return 0


_capacity_cache: Dict[str, float] = {}


def device_capacity(devices=None) -> Dict[str, float]:
    """Per-device memory capacity in bytes — the memwatch pressure
    denominator: ``torch.cuda.get_device_properties(i).total_memory``
    for a CUDA device (read only when CUDA is initialized), total host
    RAM for the CPU.  Cached per device (capacities are static)."""
    host = float(_host_total_bytes())
    out: Dict[str, float] = {}
    for d in _devices(devices):
        key = device_key(d)
        cap = _capacity_cache.get(key, 0.0)
        if cap <= 0 and d.type == "cuda":
            t = _cuda_ready()
            if t is not None:
                try:
                    cap = float(t.cuda.get_device_properties(
                        d.index or 0).total_memory)
                except Exception:
                    cap = 0.0
        if cap <= 0:
            cap = host
        if cap > 0 and (d.type != "cuda" or _cuda_ready() is not None):
            _capacity_cache[key] = cap
        out[key] = cap
    return out
