"""Device-memory plane: live-buffer ledger, budget, leak sentinel.

Port of ``mosaic_tpu.obs.memwatch``: the same ledger, budget, sentinel,
gauges, events and conf keys.  The ledger tracks live device buffers at
the choke points the port owns:

* ``perf.pipeline.stream`` — each chunk's staged input and its kernel
  outputs, registered at dispatch and released when the host fetch
  completes (``<site>/staged``, ``<site>/out``);
* the store-fed join's staging (``pip_join/store/staged``).

Bytes are **logical**: ``numel * element_size`` of each tensor, as the
JAX package's ``_tree_bytes`` counts ``nbytes`` — not the CUDA caching
allocator's rounded blocks (``obs.jaxmon`` reads those).  Pinned host
buffers are not device memory and are never registered.

Everything is keyed ``(site, trace id, device)``; device keys are
``<type>:<index>`` (``cuda:0``, ``cpu:0``).  Threads that inherit the
query's trace (``obs.context``) charge its in-flight ticket
(``mem_live_bytes`` / ``mem_peak_bytes``).  Gauges:
``mem/live_bytes/<dev>``, ``mem/pressure/<dev>`` (live vs. the device
capacity from ``jaxmon.device_capacity``, or the budget when smaller),
and the ``mem/pressure_max`` aggregate the ``device_mem_pressure`` SLO
watches.

**Leak sentinel**: at query completion (``obs.accounting.complete``),
buffers still registered to that trace fire exactly one ``mem_leak``
flight-recorder event + one ``mem/leaks`` count — naming the worst
offending site — and are then force-released so the live gauges return
to zero.  The ``memwatch.release`` fault site models a lost release for
drills.

**MemoryBudget**: ``admit(estimated_bytes)`` gates work against
``mosaic.mem.budget.bytes`` (0 = unlimited), and ``shrink_needed()``
tells ``pipeline.stream`` to halve chunk rows when any device's pressure
crosses ``mosaic.mem.pressure.high`` — the stream degrades instead of
dying, with the same zones (chunk boundaries are invisible in results).

Kill switches: ``mosaic.obs.mem.enabled`` conf (default on) or env
``MOSAIC_TPU_MEMWATCH=0``.  Quiescent cost per probe: one env-pinned
bool plus one config read.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .context import current_trace_id
from .inflight import inflight
from .jaxmon import device_key
from .metrics import metrics

__all__ = ["DeviceMemoryLedger", "MemoryBudget", "memwatch",
           "mem_budget", "device_keys_of", "tensor_bytes"]


def _default_device() -> str:
    """The key buffers land on when the caller knows no better: the
    current CUDA device once CUDA is initialized (this never
    *initializes* it), else the CPU."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        try:
            return f"cuda:{torch.cuda.current_device()}"
        except Exception:
            pass
    return "cpu:0"


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def device_keys_of(tree) -> List[str]:
    """``<type>:<index>`` keys of the devices holding the tensors of a
    tensor or a (nested) tuple, list or dict of them.  Empty list when
    nothing is a tensor (host numpy trees)."""
    return sorted({device_key(leaf.device) for leaf in _leaves(tree)
                   if hasattr(leaf, "element_size")})


def tensor_bytes(tree) -> int:
    """Logical bytes (``numel * element_size``) over the tensors of a
    tensor or a (nested) tuple, list or dict of them; numpy arrays count
    their ``nbytes``, anything else 0."""
    n = 0
    for leaf in _leaves(tree):
        if hasattr(leaf, "element_size"):
            n += int(leaf.numel()) * int(leaf.element_size())
        else:
            n += int(getattr(leaf, "nbytes", 0))
    return n


class DeviceMemoryLedger:
    """Process-global live-buffer ledger keyed (site, trace, device).

    ``register`` returns an opaque token; ``release(token)`` balances
    it.  Mutations happen from query threads and the stream's fetch
    worker concurrently — every update runs under one lock, and the
    per-register work is a handful of dict ops (chunk-granular call
    sites, never per-row)."""

    def __init__(self):
        env = os.environ.get("MOSAIC_TPU_MEMWATCH", "").strip().lower()
        self._env_off = env in ("0", "off", "false", "no")
        self._lock = threading.Lock()
        self._tokens = itertools.count(1)
        # token -> (site, trace, devices tuple, per-device byte shares)
        self._handles: Dict[int, Tuple[str, Optional[str],
                                       Tuple[str, ...],
                                       Tuple[int, ...]]] = {}
        self._dev_live: Dict[str, int] = {}
        self._dev_peak: Dict[str, int] = {}
        self._by_key: Dict[Tuple[str, Optional[str], str], int] = {}
        self._key_peak: Dict[Tuple[str, Optional[str], str], int] = {}
        self._trace_live: Dict[str, int] = {}
        self._trace_peak: Dict[str, int] = {}
        self._trace_alloc: Dict[str, int] = {}
        self._capacity: Dict[str, float] = {}
        self._registered = 0
        self._released = 0
        self._release_skipped = 0
        self._leak_count = 0
        self._leaks: "collections.deque" = collections.deque(maxlen=64)

    @property
    def enabled(self) -> bool:
        """``mosaic.obs.mem.enabled`` (default on); env
        ``MOSAIC_TPU_MEMWATCH=0`` pins it off (the A/B off arm)."""
        if self._env_off:
            return False
        try:
            from .. import config as _config
            return bool(_config.default_config().obs_mem_enabled)
        except Exception:
            return True

    def reset(self) -> None:
        """Forget everything (tests); the env pin is kept."""
        with self._lock:
            self._handles.clear()
            self._dev_live.clear()
            self._dev_peak.clear()
            self._by_key.clear()
            self._key_peak.clear()
            self._trace_live.clear()
            self._trace_peak.clear()
            self._trace_alloc.clear()
            self._registered = 0
            self._released = 0
            self._release_skipped = 0
            self._leak_count = 0
            self._leaks.clear()

    # -- the write path ----------------------------------------------
    def register(self, site: str, nbytes: int,
                 devices: Optional[Iterable[str]] = None,
                 trace: Optional[str] = None) -> Optional[int]:
        """Track a live device buffer of ``nbytes`` at ``site``;
        returns the release token (None when disabled / empty, which
        :meth:`release` passes through).  ``devices`` splits the bytes
        evenly across a sharded buffer's devices; ``trace`` defaults to
        the calling thread's active trace."""
        nbytes = int(nbytes)
        if nbytes <= 0 or not self.enabled:
            return None
        if trace is None:
            trace = current_trace_id()
        devs = tuple(d for d in (devices or ()) if d) or \
            (_default_device(),)
        share = nbytes // len(devs)
        shares = [share] * len(devs)
        shares[0] += nbytes - share * len(devs)
        with self._lock:
            token = next(self._tokens)
            self._handles[token] = (site, trace, devs, tuple(shares))
            self._registered += 1
            for d, s in zip(devs, shares):
                live = self._dev_live.get(d, 0) + s
                self._dev_live[d] = live
                if live > self._dev_peak.get(d, 0):
                    self._dev_peak[d] = live
                k = (site, trace, d)
                kl = self._by_key.get(k, 0) + s
                self._by_key[k] = kl
                if kl > self._key_peak.get(k, 0):
                    self._key_peak[k] = kl
            if trace is not None:
                tl = self._trace_live.get(trace, 0) + nbytes
                self._trace_live[trace] = tl
                if tl > self._trace_peak.get(trace, 0):
                    self._trace_peak[trace] = tl
                self._trace_alloc[trace] = \
                    self._trace_alloc.get(trace, 0) + nbytes
                self._prune_traces_locked()
        self._after_change(trace)
        return token

    def release(self, token: Optional[int]) -> None:
        """Balance one :meth:`register`; None passes through.  The
        ``memwatch.release`` fault site models a *lost* release (the
        leak drill): an injected fault here keeps the buffer
        registered — the sentinel names it at query completion — and
        never propagates to the data path."""
        if token is None:
            return
        try:
            from ..resilience import faults
            faults.maybe_fail("memwatch.release")
        except ImportError:
            pass
        except Exception:
            with self._lock:
                self._release_skipped += 1
            if metrics.enabled:
                metrics.count("mem/release_skipped")
            return
        self._release_token(token)

    def _release_token(self, token: int):
        with self._lock:
            h = self._handles.pop(token, None)
            if h is None:
                return None
            site, trace, devs, shares = h
            self._released += 1
            for d, s in zip(devs, shares):
                self._dev_live[d] = max(0, self._dev_live.get(d, 0) - s)
                k = (site, trace, d)
                left = self._by_key.get(k, 0) - s
                if left <= 0:
                    self._by_key.pop(k, None)
                else:
                    self._by_key[k] = left
            if trace is not None and trace in self._trace_live:
                self._trace_live[trace] = \
                    max(0, self._trace_live[trace] - sum(shares))
        self._after_change(trace)
        return h

    def note_transient(self, site: str, nbytes: int,
                       trace: Optional[str] = None) -> None:
        """Account a fetched-immediately device buffer: peaks and the
        per-trace allocation total move, live bytes do not — no token,
        nothing to leak."""
        nbytes = int(nbytes)
        if nbytes <= 0 or not self.enabled:
            return
        if trace is None:
            trace = current_trace_id()
        dev = _default_device()
        with self._lock:
            cand = self._dev_live.get(dev, 0) + nbytes
            if cand > self._dev_peak.get(dev, 0):
                self._dev_peak[dev] = cand
            k = (site, trace, dev)
            kc = self._by_key.get(k, 0) + nbytes
            if kc > self._key_peak.get(k, 0):
                self._key_peak[k] = kc
            tpeak = 0
            if trace is not None:
                tl = self._trace_live.get(trace, 0) + nbytes
                if tl > self._trace_peak.get(trace, 0):
                    self._trace_peak[trace] = tl
                tpeak = self._trace_peak[trace]
                self._trace_alloc[trace] = \
                    self._trace_alloc.get(trace, 0) + nbytes
                self._prune_traces_locked()
        if trace is not None and inflight._by_trace:
            t = inflight._by_trace.get(trace)
            if t is not None and tpeak > t.mem_peak_bytes:
                t.mem_peak_bytes = int(tpeak)

    # -- the leak sentinel -------------------------------------------
    def on_query_complete(self, ticket) -> int:
        """Close a query's memory books (called once per completion by
        ``obs.accounting.complete``): finalize the ticket's peak/live
        bytes, and if any buffer is still registered to the query's
        trace, fire exactly one ``mem_leak`` event + ``mem/leaks``
        count naming the worst site, then force-release the stragglers
        so live gauges return to zero.  Returns the leaked-buffer
        count."""
        if ticket is None or not self.enabled:
            return 0
        trace = getattr(ticket, "trace_id", None)
        if trace is None:
            return 0
        with self._lock:
            leaked = [(tok, h) for tok, h in self._handles.items()
                      if h[1] == trace]
        sites: Dict[str, int] = {}
        total = 0
        for tok, h in leaked:
            site, _, _, shares = h
            nb = int(sum(shares))
            total += nb
            sites[site] = sites.get(site, 0) + nb
            self._release_token(tok)
        with self._lock:
            peak = self._trace_peak.pop(trace, 0)
            self._trace_live.pop(trace, None)
            self._trace_alloc.pop(trace, None)
        if peak > getattr(ticket, "mem_peak_bytes", 0):
            ticket.mem_peak_bytes = int(peak)
        ticket.mem_live_bytes = 0
        if leaked:
            worst = max(sites, key=lambda s: sites[s])
            rec = {"ts": round(time.time(), 3), "trace": trace,
                   "query_id": ticket.query_id, "site": worst,
                   "sites": dict(sites), "bytes": total,
                   "buffers": len(leaked)}
            with self._lock:
                self._leak_count += 1
                self._leaks.append(rec)
            if metrics.enabled:
                metrics.count("mem/leaks")
            from .recorder import recorder
            recorder.record("mem_leak", trace=trace,
                            query_id=ticket.query_id, site=worst,
                            sites=dict(sites), bytes=total,
                            buffers=len(leaked))
        return len(leaked)

    # -- capacity / pressure -----------------------------------------
    def capacity(self, dev: str) -> float:
        """Best-known capacity of ``dev`` in bytes (the CUDA device's
        ``total_memory`` once CUDA is initialized, host RAM otherwise;
        0.0 = unknown).  Cached — capacities are static."""
        cap = self._capacity.get(dev)
        if cap:
            return cap
        from .jaxmon import _host_total_bytes, device_capacity
        try:
            cap = float(device_capacity([dev]).get(dev, 0.0))
        except Exception:
            cap = 0.0
        if cap <= 0:
            cap = float(_host_total_bytes())
        if cap > 0 and (not dev.startswith("cuda") or self._cuda_ready()):
            with self._lock:
                self._capacity[dev] = cap
        return cap

    @staticmethod
    def _cuda_ready() -> bool:
        torch = sys.modules.get("torch")
        return torch is not None and torch.cuda.is_initialized()

    def effective_capacity(self, dev: str) -> float:
        """The pressure denominator: the configured budget when one is
        set (and smaller), else the device capacity."""
        try:
            from .. import config as _config
            b = float(_config.default_config().mem_budget_bytes)
        except Exception:
            b = 0.0
        cap = self.capacity(dev)
        if b > 0:
            return b if cap <= 0 else min(b, cap)
        return cap

    def pressure(self, dev: str,
                 live: Optional[int] = None) -> float:
        cap = self.effective_capacity(dev)
        if cap <= 0:
            return 0.0
        if live is None:
            with self._lock:
                live = self._dev_live.get(dev, 0)
        return float(live) / cap

    def max_pressure(self) -> float:
        with self._lock:
            devl = dict(self._dev_live)
        p = 0.0
        for d, v in devl.items():
            p = max(p, self.pressure(d, live=v))
        return p

    # -- reads --------------------------------------------------------
    def total_live(self) -> int:
        with self._lock:
            return int(sum(self._dev_live.values()))

    def live_bytes(self, dev: Optional[str] = None) -> int:
        with self._lock:
            if dev is not None:
                return int(self._dev_live.get(dev, 0))
            return int(sum(self._dev_live.values()))

    def live_by_device(self) -> Dict[str, int]:
        with self._lock:
            return {d: int(v) for d, v in self._dev_live.items()}

    def live_buffers(self) -> int:
        with self._lock:
            return len(self._handles)

    def trace_live_bytes(self, trace: Optional[str]) -> int:
        if trace is None:
            return 0
        with self._lock:
            return int(self._trace_live.get(trace, 0))

    def trace_peak_bytes(self, trace: Optional[str]) -> int:
        if trace is None:
            return 0
        with self._lock:
            return int(self._trace_peak.get(trace, 0))

    def current_trace_alloc_bytes(self) -> int:
        """Cumulative bytes registered/noted under the calling
        thread's trace."""
        tid = current_trace_id()
        if tid is None:
            return 0
        with self._lock:
            return int(self._trace_alloc.get(tid, 0))

    def leaks(self) -> List[Dict[str, object]]:
        with self._lock:
            return [dict(r) for r in self._leaks]

    def leak_count(self) -> int:
        with self._lock:
            return self._leak_count

    def snapshot(self, top: int = 20) -> Dict[str, object]:
        """JSON-ready ledger state: per-device live/peak/capacity/
        pressure, top live holders by (site, trace, device), site peak
        attribution, and the recent leak list — embedded in flight
        bundles."""
        with self._lock:
            dev_live = dict(self._dev_live)
            dev_peak = dict(self._dev_peak)
            holders = sorted(self._by_key.items(),
                             key=lambda kv: -kv[1])[:top]
            site_peaks: Dict[str, int] = {}
            for (site, _, _), b in self._key_peak.items():
                site_peaks[site] = site_peaks.get(site, 0) + b
            leaks = [dict(r) for r in self._leaks]
            totals = {"live_bytes": int(sum(dev_live.values())),
                      "live_buffers": len(self._handles),
                      "registered": self._registered,
                      "released": self._released,
                      "release_skipped": self._release_skipped,
                      "leaks": self._leak_count}
        devices: Dict[str, Dict[str, object]] = {}
        for d in sorted(set(dev_live) | set(dev_peak)):
            cap = self.effective_capacity(d)
            live = int(dev_live.get(d, 0))
            devices[d] = {
                "live_bytes": live,
                "peak_bytes": int(dev_peak.get(d, 0)),
                "capacity_bytes": int(cap),
                "pressure": round(live / cap, 6) if cap > 0 else 0.0,
            }
        return {
            "enabled": self.enabled,
            "devices": devices,
            "holders": [{"site": s, "trace": t, "device": d,
                         "bytes": int(b)}
                        for (s, t, d), b in holders],
            "site_peak_bytes": {s: int(b)
                                for s, b in sorted(site_peaks.items())},
            "leaks": leaks,
            "totals": totals,
        }

    # -- internals ----------------------------------------------------
    def _after_change(self, trace: Optional[str]) -> None:
        """Refresh gauges + the owning ticket after any live-bytes
        move (outside the ledger lock)."""
        if metrics.enabled:
            with self._lock:
                devl = dict(self._dev_live)
            pmax = 0.0
            for d, v in devl.items():
                metrics.gauge(f"mem/live_bytes/{d}", float(v))
                p = self.pressure(d, live=v)
                metrics.gauge(f"mem/pressure/{d}", p)
                pmax = max(pmax, p)
            metrics.gauge("mem/pressure_max", pmax)
        if trace is not None and inflight._by_trace:
            t = inflight._by_trace.get(trace)
            if t is not None:
                with self._lock:
                    live = self._trace_live.get(trace, 0)
                    peak = self._trace_peak.get(trace, 0)
                t.mem_live_bytes = int(live)
                if peak > t.mem_peak_bytes:
                    t.mem_peak_bytes = int(peak)

    def _prune_traces_locked(self) -> None:
        # traces that never complete (non-query work) would grow the
        # side tables forever; drop the oldest quarter past 1024
        if len(self._trace_alloc) > 1024:
            for k in list(itertools.islice(iter(self._trace_alloc),
                                           256)):
                self._trace_alloc.pop(k, None)
                self._trace_live.pop(k, None)
                self._trace_peak.pop(k, None)


class MemoryBudget:
    """Admission + degrade decisions over the ledger.

    ``mosaic.mem.budget.bytes`` (0 = unlimited) caps what the process
    should hold live on device; ``mosaic.mem.pressure.high`` (default
    0.85) is the fraction of the effective capacity past which the
    streaming executor halves chunk rows (``mem/chunk_shrink``)."""

    def __init__(self, ledger: DeviceMemoryLedger):
        self._ledger = ledger

    @staticmethod
    def budget_bytes() -> int:
        try:
            from .. import config as _config
            return int(_config.default_config().mem_budget_bytes)
        except Exception:
            return 0

    @staticmethod
    def pressure_high() -> float:
        try:
            from .. import config as _config
            return float(_config.default_config().mem_pressure_high)
        except Exception:
            return 0.85

    def admit(self, estimated_bytes: int) -> bool:
        """True when ``estimated_bytes`` more device bytes fit under
        the budget (always, when no budget is set).  A denial is
        advisory — callers degrade (shrink chunks, queue) rather than
        fail; it is counted (``mem/admit_denied``) and flight-recorded
        so the admission-control arc has ground truth."""
        b = self.budget_bytes()
        if b <= 0 or not self._ledger.enabled:
            return True
        est = max(0, int(estimated_bytes))
        live = self._ledger.total_live()
        if live + est <= b:
            return True
        if metrics.enabled:
            metrics.count("mem/admit_denied")
        from .recorder import recorder
        recorder.record("mem_admit_denied", estimated_bytes=est,
                        live_bytes=live, budget_bytes=b)
        return False

    def shrink_needed(self) -> bool:
        """True when any device's pressure is at/over the high-water
        fraction — the stream's cue to halve its next chunk."""
        if not self._ledger.enabled:
            return False
        hi = self.pressure_high()
        return hi > 0 and self._ledger.max_pressure() >= hi


#: the process-global ledger every choke point feeds
memwatch = DeviceMemoryLedger()
#: the budget pipeline.stream consults
mem_budget = MemoryBudget(memwatch)
