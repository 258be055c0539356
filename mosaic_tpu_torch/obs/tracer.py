"""Span tracer: per-stage histograms, counters, span events.

Port copy of ``mosaic_tpu.obs.tracer``:

* ``tracer`` — process-global span timer.  Each span aggregates
  total/calls/max and an exponential-bucket histogram, so ``report()``
  carries p50/p95/p99 per stage; spans also append to a bounded event
  ring.  Disabled by default; enable with ``tracer.enable()``,
  ``MOSAIC_TPU_TRACE=1`` or the ``mosaic.trace.enabled`` conf key.
* **Trace-scoped span trees** — the span stack lives in a
  ``contextvars.ContextVar``, so it follows the active
  :class:`~mosaic_tpu_torch.obs.context.TraceContext`: every completed
  span carries its trace id, a process-unique span id, and its parent's
  span id; ``report()["traces"]`` groups spans per trace.
* ``record_command`` / ``record_error`` — raster operators stamp what ran
  (and what failed) into ``tile.meta`` and bump registry counters.
* ``device_trace`` — a ``torch.profiler`` capture (CPU and, where CUDA
  is available, CUDA activities) written as a Chrome trace into a
  directory; it stands where the JAX package's ``jax.profiler`` trace
  does, and shows the port's kernel launches beside the host's ops.

A span measures host time, as the JAX package's does: it adds no device
synchronisation, which would serialise the streamed executor's overlap
and change the path it measures.  ``tracer.enable()`` also enables the
metrics registry; ``disable()`` turns the registry back off unless
``MOSAIC_TPU_METRICS`` asked for it.  Completed spans also land in the
flight recorder (``obs.recorder``), so a crash dump holds the failing
span chain.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from .context import current_trace, next_span_id
from .metrics import Histogram, metrics
from .recorder import recorder

__all__ = ["Tracer", "tracer", "SpanEvent", "record_command",
           "record_error", "device_trace"]

_MAX_EVENTS = 100_000   # bounded span-event ring

#: active span stack: tuple of (name, span_id) pairs.  A ContextVar
#: (copy-on-write tuples) instead of a thread-local list so the stack
#: follows the trace context across threads and executors.
_SPAN_STACK: "contextvars.ContextVar[Tuple[Tuple[str, int], ...]]" = \
    contextvars.ContextVar("mosaic_span_stack", default=())


class SpanEvent(NamedTuple):
    """One completed span in the event ring."""

    qual: str                  # qualified name ("outer/inner")
    start_s: float             # offset from the tracer epoch
    dur_s: float
    tid: int                   # python thread ident
    native_tid: int            # OS thread id (Perfetto lanes)
    trace_id: Optional[str]    # active TraceContext (None outside)
    trace_name: Optional[str]
    span_id: int
    parent_id: Optional[int]
    error: Optional[str]       # "ExcType: msg" when the body raised


class _Span:
    __slots__ = ("name", "total_s", "calls", "max_s", "hist")

    def __init__(self, name: str):
        self.name = name
        self.total_s = 0.0
        self.calls = 0
        self.max_s = 0.0
        self.hist = Histogram(name)


class Tracer:
    """Span wall-times + named counters, thread-safe, ~zero cost when
    disabled (one attribute check per span)."""

    def __init__(self):
        self._enabled = bool(os.environ.get("MOSAIC_TPU_TRACE"))
        self._lock = threading.Lock()
        self._spans: Dict[str, _Span] = {}
        self._counters: Dict[str, float] = {}
        self._events: "collections.deque[SpanEvent]" \
            = collections.deque(maxlen=_MAX_EVENTS)
        self._epoch = time.perf_counter()

    # -- switches
    def enable(self) -> None:
        # graftlint: ignore[lock-unguarded-attr] — GIL-atomic bool store; probes read it unlocked by design
        self._enabled = True
        metrics.enable()

    def disable(self) -> None:
        # graftlint: ignore[lock-unguarded-attr] — GIL-atomic bool store; probes read it unlocked by design
        self._enabled = False
        if not os.environ.get("MOSAIC_TPU_METRICS"):
            metrics.disable()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._events.clear()
            self._epoch = time.perf_counter()
        metrics.reset()

    # -- spans
    @contextlib.contextmanager
    def span(self, name: str):
        if not self._enabled:
            yield
            return
        stack = _SPAN_STACK.get()
        sid = next_span_id()
        parent = stack[-1][1] if stack else None
        qual = "/".join([n for n, _ in stack] + [name])
        token = _SPAN_STACK.set(stack + ((name, sid),))
        t0 = time.perf_counter()
        err: Optional[str] = None
        try:
            yield
        except BaseException as e:
            err = f"{type(e).__name__}: {e}"[:200]
            raise
        finally:
            dt = time.perf_counter() - t0
            _SPAN_STACK.reset(token)
            ctx = current_trace()
            try:
                ntid = threading.get_native_id()
            except Exception:
                ntid = threading.get_ident()
            ev = SpanEvent(
                qual, t0 - self._epoch, dt, threading.get_ident(),
                ntid, ctx.trace_id if ctx else None,
                ctx.name if ctx else None, sid, parent, err)
            with self._lock:
                s = self._spans.setdefault(qual, _Span(qual))
                s.total_s += dt
                s.calls += 1
                s.max_s = max(s.max_s, dt)
                s.hist.observe(dt)
                self._events.append(ev)
            extra = {"error": err} if err else {}
            recorder.record("span", name=qual, span=sid,
                            parent=parent, dur_s=round(dt, 6), **extra)

    # -- counters
    def count(self, name: str, value: float = 1.0) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    # -- span events
    def events(self) -> List[SpanEvent]:
        """Snapshot of completed :class:`SpanEvent` records, oldest
        first."""
        with self._lock:
            return list(self._events)

    # -- reporting
    def report(self) -> Dict[str, object]:
        """One-stop snapshot: per-stage span histograms plus everything
        the metrics registry holds (counters merged; tracer-local names
        win on collision), plus per-trace span trees under
        ``"traces"``: ``{trace_id: {"name": ..., "spans": [...]}}``
        with each span carrying ``span_id``/``parent_id`` links."""
        reg = metrics.report()
        with self._lock:
            spans = {}
            for n, s in self._spans.items():
                h = s.hist.snapshot()
                spans[n] = {"total_s": s.total_s, "calls": s.calls,
                            "max_s": s.max_s, "p50_s": h["p50"],
                            "p95_s": h["p95"], "p99_s": h["p99"]}
            counters = dict(reg["counters"])
            counters.update(self._counters)
            traces: Dict[str, dict] = {}
            for ev in self._events:
                if ev.trace_id is None:
                    continue
                t = traces.setdefault(
                    ev.trace_id, {"name": ev.trace_name, "spans": []})
                rec = {"name": ev.qual, "span_id": ev.span_id,
                       "parent_id": ev.parent_id, "start_s": ev.start_s,
                       "dur_s": ev.dur_s, "thread": ev.native_tid}
                if ev.error:
                    rec["error"] = ev.error
                t["spans"].append(rec)
            return {
                "spans": spans,
                "counters": counters,
                "gauges": reg["gauges"],
                "histograms": reg["histograms"],
                "traces": traces,
            }

    def format_report(self) -> str:
        rep = self.report()
        lines = [f"{'span':<44} {'calls':>6} {'total_s':>9} "
                 f"{'p50_s':>8} {'p95_s':>8} {'max_s':>8}"]
        for n, s in sorted(rep["spans"].items(),
                           key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{n:<44} {s['calls']:>6} "
                         f"{s['total_s']:>9.4f} {s['p50_s']:>8.4f} "
                         f"{s['p95_s']:>8.4f} {s['max_s']:>8.4f}")
        for tid, t in sorted(rep["traces"].items()):
            errs = sum(1 for s in t["spans"] if s.get("error"))
            lines.append(f"trace {tid} ({t['name']}): "
                         f"{len(t['spans'])} spans"
                         + (f", {errs} errored" if errs else ""))
        for n, v in sorted(rep["counters"].items()):
            lines.append(f"counter {n} = {v:g}")
        for n, v in sorted(rep["gauges"].items()):
            lines.append(f"gauge {n} = {v:g}")
        for n, h in sorted(rep["histograms"].items()):
            lines.append(f"hist {n}: count={h['count']} "
                         f"p50={h['p50']:g} p95={h['p95']:g} "
                         f"p99={h['p99']:g}")
        return "\n".join(lines)


tracer = Tracer()


# -- raster-op provenance: last_command / last_error / full_error in
#    tile metadata

def record_command(tile, command: str) -> None:
    tile.meta["last_command"] = command
    metrics.count("raster/commands")


def record_error(tile, err: BaseException) -> None:
    tile.meta["last_error"] = f"{type(err).__name__}: {err}"[:200]
    tile.meta["full_error"] = repr(err)
    metrics.count(f"raster/errors/{type(err).__name__}")


_trace_seq = itertools.count(1)


@contextlib.contextmanager
def device_trace(logdir: str, pad_s: float = 0.5):
    """Capture a ``torch.profiler`` timeline of the body into ``logdir``
    as a Chrome trace (``device_trace_<pid>_<n>.json``; open it in
    Perfetto or ``chrome://tracing``).  CUDA activity is captured where
    CUDA is available, so the port's kernel launches show beside the
    host ops.  Yields ``logdir``; the written path lands in the flight
    recorder as a ``device_trace`` event.

    The profiler runs an empty warm-up cycle, whose records are
    discarded, then keeps the body's cycle.  It keeps a device record
    only if the record's timestamp falls inside the cycle's window, and
    on the H100 the device records' clock can drift from the window's
    host clock by tens of milliseconds over a long process: a short
    body's kernels then land past the window's end and are dropped, and
    work queued just before the window lands inside it.  So where CUDA
    is captured the window opens ``pad_s`` seconds after the device went
    idle, the body starts ``pad_s`` after that, and the window closes
    ``pad_s`` after the body's device work has finished: an offset under
    ``pad_s`` moves no record across an edge (``chip_smoke.py`` phase 19
    prints the offsets it measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pad = pad_s if cuda else 0.0

    def settle():
        sync()
        time.sleep(pad)

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"device_trace_{os.getpid()}_{next(_trace_seq):03d}.json")
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        settle()
        prof.step()                  # the warm-up cycle ends here
        settle()
        try:
            yield logdir
        finally:
            settle()
            prof.step()              # the body's cycle: export it
    recorder.record("device_trace", path=path)
