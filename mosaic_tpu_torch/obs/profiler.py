"""Continuous profiling plane: host sampler, kernel ledger, capture.

Port copy of ``mosaic_tpu.obs.profiler``.  The telemetry plane (metrics
/ time series / SLO burn rates) answers *that* a query is slow; this
module answers *where the time went*.  Three capture modes share one
report format:

* **Sampling host profiler** — :class:`HostProfiler`, a daemon thread
  walking ``sys._current_frames()`` at ``mosaic.obs.profile.hz`` (env
  ``MOSAIC_TPU_PROFILE_HZ`` pins it; 0 = off, the default).  Samples
  fold into collapsed-stack counts keyed by the active trace context of
  the sampled thread (``obs.context`` keeps a thread-ident → trace side
  table, because a ``ContextVar`` is not readable from another thread),
  so two interleaved queries get disjoint profiles.
* **Per-kernel device-cost ledger** — :class:`KernelLedger`, keyed by
  ``(name, key)`` pairs as the JAX package's call sites key it (the
  streamed join's ``pip/streamed`` by ``(id(idx), id(grid), eps,
  margin_eps, precision)``, the sharded wrap's ``pip/sharded_wrap``).
  The streaming executor feeds observed per-chunk launch wall times
  (dispatch → host fetch complete, clamped to the previous chunk's
  completion so spans never overlap); each launch's seconds also charge
  the in-flight ticket (``device_s``).  The port has no XLA cost model,
  so nothing calls :meth:`KernelLedger.record_cost` in it.
* **Triggered capture** — flight-recorder bundles embed
  :func:`capture_snapshot` (host stacks + ledger); when
  ``mosaic.obs.profile.trace.ms`` > 0, :func:`maybe_device_capture`
  additionally records a bounded ``torch.profiler`` timeline through
  ``tracer.device_trace``.

Exports: :meth:`HostProfiler.collapsed` (collapsed-stack text,
``flamegraph.pl``-ready) and :meth:`HostProfiler.speedscope`
(https://www.speedscope.app JSON).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["HostProfiler", "KernelLedger", "ledger", "profiler",
           "start_profiler", "stop_profiler", "configure_profiler",
           "capture_snapshot", "maybe_device_capture",
           "DEFAULT_PROFILE_HZ"]

#: cadence used when the profiler is enabled without an explicit rate.
#: 97 Hz (prime) avoids phase-locking with the 500 ms telemetry
#: sampler and with millisecond-periodic workloads.
DEFAULT_PROFILE_HZ = 97.0

_MAX_STACKS = 10_000       # distinct (trace, stack) keys before drops
_MAX_DEPTH = 64            # frames kept per sample (deepest dropped)
_SNAPSHOT_STACKS = 200     # stacks embedded per flight bundle


def _frame_label(code) -> str:
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class HostProfiler:
    """Sampling profiler over ``sys._current_frames()``.

    ``sample()`` is one pass (callable directly from tests);
    ``start()`` runs it on a daemon thread at ``hz``.  Aggregation is
    bounded: at most ``max_stacks`` distinct (trace, stack) keys are
    retained — overflow lands in ``truncated`` instead of growing
    memory.  The sampling thread itself (and, on inline calls, the
    calling thread) is excluded from its own samples.
    """

    def __init__(self, hz: float = DEFAULT_PROFILE_HZ,
                 max_stacks: int = _MAX_STACKS,
                 max_depth: int = _MAX_DEPTH):
        self.hz = min(1000.0, max(0.5, float(hz)))
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self.samples = 0
        self.truncated = 0
        self._lock = threading.Lock()
        # (trace_id | None, root-first frame tuple) -> sample count
        self._stacks: Dict[Tuple[Optional[str], Tuple[str, ...]], int] = {}
        self._trace_names: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mosaic-obs-profiler", daemon=True)

    # -- lifecycle (mirrors timeseries.Sampler)
    def start(self) -> "HostProfiler":
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(1.0 / self.hz):
            try:
                self.sample()
            except Exception:
                pass          # a sampling hiccup must never kill the
                              # thread (next tick retries)

    # -- the probe
    def sample(self) -> None:
        """One sampling pass over every live thread's current stack."""
        from .context import thread_trace_map
        me = threading.get_ident()
        own = self._thread.ident
        traces = thread_trace_map()
        for ident, frame in sys._current_frames().items():
            if ident == me or ident == own:
                continue
            stack: List[str] = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                stack.append(_frame_label(f.f_code))
                f = f.f_back
            if not stack:
                continue
            stack.reverse()               # root first (collapsed order)
            ctx = traces.get(ident)
            key = (ctx.trace_id if ctx is not None else None,
                   tuple(stack))
            with self._lock:
                if key in self._stacks:
                    self._stacks[key] += 1
                elif len(self._stacks) < self.max_stacks:
                    self._stacks[key] = 1
                    if ctx is not None:
                        self._trace_names[ctx.trace_id] = ctx.name
                else:
                    self.truncated += 1
        with self._lock:
            self.samples += 1

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._trace_names.clear()
            self.samples = 0
            self.truncated = 0

    # -- reads / exports
    def report(self, max_stacks: Optional[int] = None) -> Dict[str, Any]:
        """Aggregated profile: stacks sorted by weight, plus a
        per-trace sample rollup (disjoint per query — the attribution
        contract)."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            names = dict(self._trace_names)
        if max_stacks is not None:
            items = items[:max_stacks]
        traces: Dict[str, Dict[str, Any]] = {}
        for (tid, _), c in items:
            if tid is None:
                continue
            t = traces.setdefault(
                tid, {"name": names.get(tid, ""), "samples": 0})
            t["samples"] += c
        return {
            "hz": self.hz,
            "samples": self.samples,
            "distinct_stacks": len(items),
            "truncated": self.truncated,
            "stacks": [{"trace": tid, "trace_name": names.get(tid, ""),
                        "frames": list(frames), "count": c}
                       for (tid, frames), c in items],
            "traces": traces,
        }

    def collapsed(self, trace: Optional[str] = None) -> str:
        """Collapsed-stack text (``frame;frame;frame count`` per line,
        root first) — pipe into ``flamegraph.pl`` or paste into
        speedscope.  ``trace`` filters to one trace context."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        lines = [f"{';'.join(frames)} {c}"
                 for (tid, frames), c in items
                 if trace is None or tid == trace]
        return "\n".join(lines)

    def speedscope(self, trace: Optional[str] = None,
                   name: str = "mosaic_tpu_torch host profile") -> Dict[str, Any]:
        """The profile in speedscope's sampled-profile JSON schema."""
        with self._lock:
            items = [((tid, frames), c)
                     for (tid, frames), c in self._stacks.items()
                     if trace is None or tid == trace]
        frame_ix: Dict[str, int] = {}
        frames_out: List[Dict[str, str]] = []
        samples: List[List[int]] = []
        weights: List[int] = []
        for (_, frames), c in items:
            row = []
            for fr in frames:
                if fr not in frame_ix:
                    frame_ix[fr] = len(frames_out)
                    frames_out.append({"name": fr})
                row.append(frame_ix[fr])
            samples.append(row)
            weights.append(c)
        total = sum(weights)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "exporter": "mosaic_tpu_torch.obs.profiler",
            "name": name,
            "shared": {"frames": frames_out},
            "profiles": [{
                "type": "sampled",
                "name": name,
                "unit": "none",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }],
        }


# ------------------------------------------------------ kernel ledger

class KernelLedger:
    """Per-kernel device-cost accounting, keyed as the JAX package's
    call sites key it.

    ``observe(name, key, seconds, rows)`` accumulates launch wall
    time per ``(name, key)``; ``record_cost(name, figures)`` attaches
    cost figures (flops / bytes_accessed); ``register(name, key)``
    marks a kernel known so the report lists unobserved kernels too.
    Always on (one dict update per chunk launch — noise next to a
    device dispatch); bounded at ``max_entries`` distinct keys.
    """

    def __init__(self, max_entries: int = 512):
        self.max_entries = int(max_entries)
        self.enabled = True
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._costs: Dict[str, Dict[str, float]] = {}
        self.dropped = 0

    def _entry_locked(self, name: str, key
                      ) -> Optional[Dict[str, Any]]:
        k = (name, repr(key))
        e = self._entries.get(k)
        if e is None:
            if len(self._entries) >= self.max_entries:
                self.dropped += 1
                return None
            e = self._entries[k] = {
                "name": name, "key": k[1], "launches": 0,
                "seconds": 0.0, "rows": 0}
        return e

    def register(self, name: str, key) -> None:
        """Mark a kernel known (zero launches until observed)."""
        if not self.enabled:
            return
        with self._lock:
            self._entry_locked(name, key)

    def observe(self, name: str, key, seconds: float,
                rows: int = 0) -> None:
        """Charge one launch's wall time to ``(name, key)``."""
        if not self.enabled:
            return
        with self._lock:
            e = self._entry_locked(name, key)
            if e is None:
                return
            e["launches"] += 1
            e["seconds"] += float(seconds)
            e["rows"] += int(rows)
        # query accounting join: observe() runs on the thread that
        # launched the kernel, which carries the owning query's trace,
        # so the same seconds charge the in-flight ticket — the
        # per-principal device_s column (one empty-dict check when no
        # query is registered)
        from .inflight import charge_device_seconds
        charge_device_seconds(float(seconds))

    def record_cost(self, name: str, figures: Dict[str, float]) -> None:
        """Attach cost figures to every ``name`` entry."""
        if not self.enabled or not figures:
            return
        with self._lock:
            self._costs[name] = {k: float(v) for k, v in figures.items()
                                 if isinstance(v, (int, float))}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._costs.clear()
            self.dropped = 0

    def seconds(self, *names: str) -> float:
        """Total observed wall seconds over kernels named ``names``
        (all kernels when empty)."""
        with self._lock:
            return sum(e["seconds"] for e in self._entries.values()
                       if not names or e["name"] in names)

    def report(self) -> Dict[str, Any]:
        """``{"kernels": [...], "total_s": float, "dropped": int}`` —
        kernels sorted by wall time, each joined with its cost figures
        and derived rates (gflops_s / rows_per_s) where available."""
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
            costs = {n: dict(f) for n, f in self._costs.items()}
        out = []
        for e in sorted(entries, key=lambda e: -e["seconds"]):
            cost = costs.get(e["name"])
            if cost:
                e["cost"] = cost
                if e["seconds"] > 0 and cost.get("flops"):
                    e["gflops_s"] = round(
                        cost["flops"] * e["launches"]
                        / e["seconds"] / 1e9, 3)
            if e["seconds"] > 0 and e["rows"]:
                e["rows_per_s"] = round(e["rows"] / e["seconds"])
            e["seconds"] = round(e["seconds"], 6)
            out.append(e)
        return {"kernels": out,
                "total_s": round(sum(e["seconds"] for e in out), 6),
                "dropped": self.dropped}


#: the process-global ledger every instrumented launch feeds
ledger = KernelLedger()


# --------------------------------------------------- global lifecycle

_prof_lock = threading.Lock()
_active_profiler: Optional[HostProfiler] = None
_conf_hz: Optional[float] = None     # last rate applied via conf

#: env var pinning the sampling rate over the conf key
PROFILE_HZ_ENV = "MOSAIC_TPU_PROFILE_HZ"


def profiler() -> Optional[HostProfiler]:
    """The running host profiler, or None."""
    return _active_profiler


def start_profiler(hz: Optional[float] = None) -> HostProfiler:
    """(Re)start the process host profiler; stops a previous one
    first.  The flight recorder notes the transition."""
    global _active_profiler
    with _prof_lock:
        if _active_profiler is not None:
            _active_profiler.close()
        _active_profiler = HostProfiler(
            hz if hz is not None else DEFAULT_PROFILE_HZ).start()
        p = _active_profiler
    from .recorder import recorder
    recorder.record("profiler", action="start", hz=p.hz)
    return p


def stop_profiler() -> None:
    global _active_profiler
    with _prof_lock:
        if _active_profiler is not None:
            _active_profiler.close()
            _active_profiler = None


def configure_profiler(conf_hz: float) -> None:
    """Conf-driven lifecycle (``mosaic.obs.profile.hz`` via
    ``set_default_config``): > 0 starts/retunes, 0 stops.  Change-
    detecting, and only ever stops what a conf started — a
    programmatic ``start_profiler()`` survives unrelated ``SET``
    statements.  ``MOSAIC_TPU_PROFILE_HZ`` pins the rate: conf values
    are ignored while it is set."""
    global _conf_hz
    if os.environ.get(PROFILE_HZ_ENV):
        return
    hz = float(conf_hz)
    with _prof_lock:
        # check-and-set under the lock: two concurrent SETs reading
        # the same prev would both decide to start/stop
        prev = _conf_hz
        if prev is not None and hz == prev:
            return
        _conf_hz = hz
    if hz > 0:
        start_profiler(hz)
    elif prev:
        stop_profiler()


# ----------------------------------------------------- capture modes

def capture_snapshot() -> Dict[str, Any]:
    """One profiler snapshot for flight-recorder bundles: bounded host
    stacks + collapsed text + the kernel ledger.  Empty-but-shaped
    when no profiler runs (the ledger is always on)."""
    p = profiler()
    out: Dict[str, Any] = {"ledger": ledger.report()}
    if p is not None:
        out["host"] = p.report(max_stacks=_SNAPSHOT_STACKS)
        out["collapsed"] = p.collapsed()
    else:
        out["host"] = {}
        out["collapsed"] = ""
    return out


_capture_lock = threading.Lock()
_capture_busy = False


def maybe_device_capture(reason: str) -> Optional[str]:
    """Bounded ``torch.profiler`` capture on a trigger (SLO breach /
    slow query), gated on ``mosaic.obs.profile.trace.ms`` > 0.

    Runs ``tracer.device_trace`` for the configured duration on a
    daemon thread and returns the log directory immediately (None
    when disabled, when CUDA is available but not initialized — a
    trigger must not *initialize* a backend — or when a capture is
    already running: ``torch.profiler`` supports one trace at a
    time).  A device trace taken late in a long process can lose its
    device records (``tracer.device_trace``); take one that must hold
    them in a fresh process."""
    from .. import config as _config
    ms = float(getattr(_config.default_config(),
                       "obs_profile_trace_ms", 0.0))
    if ms <= 0:
        return None
    torch = sys.modules.get("torch")
    if torch is None or (torch.cuda.is_available()
                         and not torch.cuda.is_initialized()):
        return None
    global _capture_busy
    with _capture_lock:
        if _capture_busy:
            return None
        _capture_busy = True
    import tempfile
    logdir = os.path.join(
        os.environ.get("MOSAIC_TPU_DUMP_DIR") or os.path.join(
            tempfile.gettempdir(), "mosaic_tpu_flight"),
        f"device_trace_{os.getpid()}_{reason}")

    def _run():
        global _capture_busy
        try:
            from .tracer import device_trace
            with device_trace(logdir):
                time.sleep(ms / 1e3)
            from .recorder import recorder
            recorder.record("device_trace", logdir=logdir,
                            ms=ms, reason=reason)
        except Exception:
            pass              # a failed capture must never take down
                              # the trigger path
        finally:
            with _capture_lock:
                _capture_busy = False

    threading.Thread(target=_run, name="mosaic-device-capture",
                     daemon=True).start()
    return logdir
