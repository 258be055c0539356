"""Flight recorder: always-on bounded ring of structured events.

Port copy of ``mosaic_tpu.obs.recorder``: a process-global
:class:`FlightRecorder` — a bounded, lock-cheap ring of small dict
events that is **on by default** (even with the tracer off) and costs
one attribute check per probe when disabled.

What lands in the ring: span completions (when the tracer is on),
retry attempts/recoveries/giveups, armed fault-plan firings, codec
``ErrorRecord``s from degrade-not-die ingestion, config mutations,
planner decisions, the refined join's bailouts, torn store shards,
layout advice, query cancels and dump marks themselves.  Every event
carries the active trace id (``obs.context``), so a dump reconstructs
the failing span chain of the call that died.

``dump()`` writes a self-contained JSON bundle — events + metrics
snapshot + resolved config + the CUDA device — to
``MOSAIC_TPU_DUMP_DIR`` (default: a ``mosaic_tpu_flight`` dir under
the system tempdir).  Unhandled exceptions dump automatically (a
chained ``sys.excepthook``, installed at ``mosaic_tpu_torch.obs``
import).

The bundle also carries the metric time series (``timeseries``), the
last memory watermarks (``memory``), the device-memory ledger
(``device_memory``), the profiler snapshot (``profile``) and the query
console (``queries``: in-flight tickets, recent audit records, the
per-principal meters), as the JAX package's does.  One stated
divergence (ROADMAP C13): the bundle's ``"jax"`` entry is a
``"device"`` entry read from ``torch.cuda``, and only when CUDA is
already initialized (a crash dump must never initialize a backend).

Env knobs: ``MOSAIC_TPU_RECORDER=0`` disables, ``MOSAIC_TPU_RECORDER_EVENTS``
sizes the ring (default 4096), ``MOSAIC_TPU_DUMP_DIR`` redirects dumps.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from .context import current_trace

__all__ = ["FlightRecorder", "EVENTS", "recorder",
           "install_excepthook"]

_DEF_CAPACITY = 4096

#: The event catalogue: every ``kind`` string a ``record()`` call of the
#: port may emit (``tests/test_torch_recorder.py`` holds the port's
#: ``record`` calls to it).  Kinds of modules the port has not got yet
#: (serve, the history plane, the fleet) join it with them.
EVENTS = frozenset({
    # lifecycle / tracing; the SQL engine's query and slow-query marks
    "span", "sql", "slow_query", "config", "trace_link", "device_trace",
    "audit",
    # cancellation
    "query_cancel_requested",
    # resilience: retries, faults, degrade-not-die ingestion
    "retry", "retry_recovered", "retry_giveup", "fault_injected",
    "codec_error", "codec_record_dropped",
    # planner + fusion
    "planner_decision", "planner_mispredict", "planner_stats_loaded",
    "planner_stats_corrupt", "planner_stats_save_failed",
    "fusion_group", "fusion_bailout", "fusion_plan_error",
    # the refined PIP join re-ran a failed batch on the flat path
    "refine_bailout",
    # the layout advisor's recommendation, with its evidence
    "layout_advice",
    # a store shard held fewer bytes than its manifest promised
    "store_shard_torn",
    # memory plane
    "mem_admit_denied", "mem_chunk_shrink", "mem_leak",
    # SLO + profiler
    "slo_breach", "slo_recovered", "profiler",
    # pipeline observer hook failures
    "pipeline_observe_error",
    # recorder-internal marks
    "dump", "dump_suppressed", "dump_suppressed_flush", "error",
    "unhandled_error",
})


def _device_info() -> Dict[str, Any]:
    """CUDA device snapshot for bundles — only if torch is imported and
    CUDA is already initialized (a crash dump must never *initialize* a
    backend)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {"initialized": False}
    try:
        n = torch.cuda.device_count()
        return {
            "initialized": True,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device_count": n,
            "devices": [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                        for i in range(n)],
            "current": torch.cuda.current_device(),
        }
    except Exception as e:  # a device fault must not mask the dump
        return {"initialized": True, "error": f"{type(e).__name__}: {e}"}


class FlightRecorder:
    """Bounded structured event ring; one attribute check per
    ``record()`` when disabled."""

    def __init__(self):
        env = os.environ.get("MOSAIC_TPU_RECORDER", "").strip().lower()
        self._enabled = env not in ("0", "off", "false", "no")
        try:
            cap = int(os.environ.get("MOSAIC_TPU_RECORDER_EVENTS",
                                     _DEF_CAPACITY))
        except ValueError:
            cap = _DEF_CAPACITY
        self._lock = threading.Lock()
        self._events: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=max(16, cap))
        self._seq = 0
        self._dumps = 0
        self._dropped = 0            # events evicted off the ring
        self._last_auto_dump: Optional[float] = None
        self._suppressed = 0         # auto-dumps held by the cooldown

    # -- switches
    def enable(self) -> None:
        # a GIL-atomic bool store; record() reads it unlocked by design
        self._enabled = True

    def disable(self) -> None:
        # a GIL-atomic bool store; record() reads it unlocked by design
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    def reset(self, capacity: Optional[int] = None) -> None:
        """Clear the ring; optionally resize it (tests exercise bounds
        with a small ring)."""
        with self._lock:
            if capacity is not None:
                self._events = collections.deque(
                    maxlen=max(16, int(capacity)))
            else:
                self._events.clear()
            self._seq = 0
            self._dropped = 0
            self._last_auto_dump = None
            self._suppressed = 0

    # -- the probe
    def record(self, kind: str, **fields) -> None:
        """Append one structured event.  The active trace id (if any)
        is attached automatically."""
        if not self._enabled:
            return
        ev: Dict[str, Any] = {"seq": 0, "ts": time.time(), "kind": kind}
        ctx = current_trace()
        if ctx is not None:
            ev["trace"] = ctx.trace_id
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            # a full ring wraps silently at append — count the
            # eviction so truncated flight recordings are detectable
            dropping = len(self._events) == self._events.maxlen
            if dropping:
                self._dropped += 1
            self._events.append(ev)
        if dropping:
            from .metrics import metrics
            if metrics.enabled:
                metrics.count("obs/recorder_dropped")

    @property
    def dropped(self) -> int:
        """Events evicted off the ring since the last reset."""
        with self._lock:
            return self._dropped

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot of retained events, oldest first (optionally
        filtered by kind)."""
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.get("kind") == kind]

    # -- bundles
    def bundle(self, reason: str = "manual",
               error: Optional[str] = None) -> Dict[str, Any]:
        """Self-contained post-mortem: events + metrics snapshot +
        metric time-series history + last memory watermarks + the
        device-memory ledger + the profiler snapshot + the query
        console + resolved config + the CUDA device."""
        import dataclasses

        from .. import config as _config
        from .metrics import metrics
        try:                    # history survives into the bundle: the
            from .timeseries import timeseries   # post-mortem shows the
            ts_snap = timeseries.snapshot()      # minutes before, not
        except Exception:                        # just the final values
            ts_snap = {}
        try:
            from .jaxmon import last_watermarks
            mem = last_watermarks()
        except Exception:
            mem = {}
        try:                    # triggered capture: host stacks + the
            from .profiler import capture_snapshot   # kernel ledger
            prof = capture_snapshot()                # ride along in
        except Exception:                            # every bundle
            prof = {}
        try:                    # query console state: what was running
            from .accounting import audit, meter     # at dump time +
            from .inflight import inflight           # who spent what
            queries = {"inflight": inflight.list_active(),
                       "recent": audit.records(limit=50),
                       "principals": meter.report()}
        except Exception:
            queries = {}
        try:                    # device-memory ledger: who HOLDS live
            from .memwatch import memwatch           # bytes right now —
            device_memory = memwatch.snapshot()      # the mem-pressure
        except Exception:                            # breach post-mortem
            device_memory = {}
        b: Dict[str, Any] = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "events": self.events(),
            "dropped": self.dropped,
            "metrics": metrics.report(),
            "timeseries": ts_snap,
            "memory": mem,
            "device_memory": device_memory,
            "profile": prof,
            "queries": queries,
            "config": dataclasses.asdict(_config.default_config()),
            "device": _device_info(),
        }
        if error is not None:
            b["error"] = error
        return b

    def dump(self, path: Optional[str] = None, reason: str = "manual",
             error: Optional[str] = None) -> str:
        """Write a bundle as JSON (atomic rename); returns the path."""
        b = self.bundle(reason=reason, error=error)
        if path is None:
            d = os.environ.get("MOSAIC_TPU_DUMP_DIR") or os.path.join(
                tempfile.gettempdir(), "mosaic_tpu_flight")
            os.makedirs(d, exist_ok=True)
            with self._lock:
                self._dumps += 1
                n = self._dumps
            path = os.path.join(
                d, f"flight_{os.getpid()}_{n:03d}_{reason}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(b, f, default=str)
        os.replace(tmp, path)
        self.record("dump", path=path, reason=reason)
        return path

    def dump_throttled(self, reason: str = "auto",
                       error: Optional[str] = None) -> Optional[str]:
        """Cooldown-gated :meth:`dump` for automatic triggers (a
        sustained trigger must not become a dump storm).

        At most one dump per ``mosaic.obs.dump.cooldown.ms`` (default
        30 s; 0 disables the gate).  A held dump returns None and
        records a ``dump_suppressed`` event carrying how many dumps
        the cooldown has swallowed since the last one that went
        through; an allowed dump's bundle likewise carries the count.
        Also fires the optional bounded device-profiler capture
        (``obs.profiler.maybe_device_capture``) on allowed dumps."""
        from .. import config as _config
        cd_ms = float(_config.default_config().obs_dump_cooldown_ms)
        now = time.time()
        with self._lock:
            held = (cd_ms > 0 and self._last_auto_dump is not None
                    and (now - self._last_auto_dump) * 1e3 < cd_ms)
            if held:
                self._suppressed += 1
                suppressed = self._suppressed
            else:
                self._last_auto_dump = now
                suppressed = self._suppressed
                self._suppressed = 0
        if held:
            self.record("dump_suppressed", reason=reason,
                        suppressed=suppressed, cooldown_ms=cd_ms)
            return None
        if suppressed:
            self.record("dump_suppressed_flush", reason=reason,
                        suppressed=suppressed)
        from .profiler import maybe_device_capture
        maybe_device_capture(reason)
        return self.dump(reason=reason, error=error)

    @contextlib.contextmanager
    def dump_on_error(self, reason: str = "unhandled_error"):
        """Dump a bundle when the body raises, then re-raise."""
        try:
            yield
        except BaseException as e:
            msg = f"{type(e).__name__}: {e}"[:300]
            self.record("error", error=msg)
            try:
                self.dump(reason=reason, error=msg)
            except OSError:
                pass
            raise


recorder = FlightRecorder()


# ------------------------------------------------ crash auto-dump

_hook_lock = threading.Lock()
_hook_installed = False


def install_excepthook() -> bool:
    """Chain a ``sys.excepthook`` that dumps a flight bundle on any
    unhandled exception (once per process).  The previous hook always
    runs afterwards."""
    global _hook_installed
    with _hook_lock:
        if _hook_installed:
            return False
        prev = sys.excepthook

        def hook(tp, val, tb):
            try:
                if recorder.enabled:
                    msg = f"{tp.__name__}: {val}"[:300]
                    recorder.record("unhandled_error", error=msg)
                    recorder.dump(reason="unhandled_error", error=msg)
            except Exception:
                pass
            prev(tp, val, tb)

        sys.excepthook = hook
        _hook_installed = True
        return True
