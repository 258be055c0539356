"""Query-scoped trace contexts: trace ids, span parentage, propagation.

Port copy of ``mosaic_tpu.obs.context``: the same ids, decorator and
W3C ``traceparent`` helpers.  A :class:`TraceContext` is a small
immutable (trace id, name) pair carried in a ``contextvars.ContextVar``
so everything that runs under it — joins, overlays, codec ingest, the
raster halo — records spans and flight-recorder events keyed by the
same trace id, and an in-flight ticket (``obs.inflight``) finds its
query by it.

* :func:`new_trace` — always opens a *fresh* trace.
* :func:`root_trace` — joins the active trace when one exists, else
  opens a fresh one (standalone calls get their own trace, calls inside
  a query inherit the query's).
* :func:`traced` — decorator form of ``root_trace`` + a tracer span,
  used to instrument entry points without touching their bodies.

``contextvars`` do **not** flow into new ``threading.Thread``s by
default; :func:`install_thread_propagation` wraps ``Thread.start`` so a
thread spawned *while a trace is active* inherits the spawner's context
snapshot.  Importing the port does not install it (the JAX package's
import does): the port's executor fetches on the calling thread, so a
caller that spawns workers under a trace installs it once itself.  Threads spawned with no active trace start untouched.  The
wrapper marks the threads it wraps with an attribute of its own, so it
composes with the JAX package's wrapper when a process (a parity test)
imports both packages.

Cross-process propagation speaks W3C ``traceparent``
(``00-<32 hex trace>-<16 hex parent span>-<2 hex flags>``).  Local
trace ids keep their ``t<pid>-<seq>`` shape, so linking is by
annotation: :func:`link_traceparent` parks a validated incoming header,
the next :func:`new_trace` consumes it onto the context's
``w3c_trace``/``w3c_parent`` fields and records a ``trace_link``
flight-recorder event; :func:`make_traceparent` renders the outgoing
header for the active trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import hashlib
import itertools
import os
import re
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["TraceContext", "new_trace", "root_trace", "current_trace",
           "current_trace_id", "next_span_id", "traced",
           "install_thread_propagation", "thread_trace_map",
           "parse_traceparent", "make_traceparent", "link_traceparent"]

_trace_ids = itertools.count(1)
_span_ids = itertools.count(1)


def next_span_id() -> int:
    """Process-unique span id (parent/child links in trace trees)."""
    return next(_span_ids)


@dataclass(frozen=True)
class TraceContext:
    """One trace: a process-unique id plus a human-readable name
    (``pip_join``, ``ingest:gtiff``, ``overlay``).  When the
    trace was opened under :func:`link_traceparent`, ``w3c_trace`` /
    ``w3c_parent`` carry the caller's W3C ids — the cross-process
    stitching key; both stay None for purely local traces."""

    trace_id: str
    name: str
    w3c_trace: Optional[str] = None
    w3c_parent: Optional[str] = None


_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("mosaic_torch_trace_ctx", default=None)

# Thread-ident -> active trace side table.  A ContextVar is only
# readable from its own thread; the sampling host profiler
# (obs.profiler) walks ``sys._current_frames()`` from outside the
# sampled threads, so its trace attribution needs this cross-thread
# view.  Kept by ``new_trace`` (enter/exit) and by the thread-
# propagation wrapper below; plain dict ops are GIL-atomic.
_THREAD_TRACES: dict = {}


def thread_trace_map() -> dict:
    """Snapshot of thread ident -> :class:`TraceContext` for every
    thread currently inside a trace (the profiler's attribution key)."""
    return dict(_THREAD_TRACES)


def current_trace() -> Optional[TraceContext]:
    """The active trace context, or None outside any trace."""
    return _CTX.get()


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


# ------------------------------------- W3C traceparent (cross-process)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

#: Incoming link parked by :func:`link_traceparent`, consumed by the
#: next :func:`new_trace` in the same context.
_PENDING_LINK: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("mosaic_torch_pending_trace_link",
                           default=None)


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """Validate a W3C ``traceparent`` header -> ``(trace_id,
    parent_span_id)`` hex pair, or None when absent/malformed (the
    spec says ignore, never error: a bad header from a client must not
    fail the request).  All-zero ids and the reserved version ``ff``
    are invalid per spec."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff" or set(trace_id) == {"0"} or \
            set(span_id) == {"0"}:
        return None
    return trace_id, span_id


def _derived_w3c_ids(local_trace_id: str) -> Tuple[str, str]:
    """Deterministic (trace, span) hex ids for a local trace that has
    no incoming W3C link — same local id always maps to the same W3C
    ids, so retries of the same derivation agree across call sites."""
    digest = hashlib.sha256(local_trace_id.encode()).hexdigest()
    return digest[:32], digest[32:48]


def make_traceparent(ctx: Optional[TraceContext] = None
                     ) -> Optional[str]:
    """Render the outgoing ``traceparent`` for ``ctx`` (default: the
    active trace; None when no trace is active).  A linked trace keeps
    the caller's W3C trace id so the whole cross-process tree shares
    one id; an unlinked trace derives a stable one from the local id.
    The span id is this process's own — it becomes the downstream
    side's ``w3c_parent``."""
    ctx = ctx if ctx is not None else _CTX.get()
    if ctx is None:
        return None
    trace_hex, span_hex = _derived_w3c_ids(ctx.trace_id)
    if ctx.w3c_trace:
        trace_hex = ctx.w3c_trace
    return f"00-{trace_hex}-{span_hex}-01"


@contextlib.contextmanager
def link_traceparent(header: Optional[str]):
    """Park an incoming ``traceparent`` so the next :func:`new_trace`
    under this context links to it.  Invalid/absent headers are a
    no-op (the trace opens unlinked).  Yields the parsed ``(trace,
    parent span)`` pair or None."""
    link = parse_traceparent(header)
    token = _PENDING_LINK.set(link) if link else None
    try:
        yield link
    finally:
        if token is not None:
            _PENDING_LINK.reset(token)


@contextlib.contextmanager
def new_trace(name: str):
    """Open a fresh trace context (always a new trace id).  If an
    incoming ``traceparent`` was parked by :func:`link_traceparent`,
    this trace consumes it (one link -> one trace): the W3C ids land
    on the context and a ``trace_link`` event lands in the flight
    recorder so the pieces can be reunited."""
    link = _PENDING_LINK.get()
    ctx = TraceContext(
        trace_id=f"t{os.getpid()}-{next(_trace_ids):05d}", name=name,
        w3c_trace=link[0] if link else None,
        w3c_parent=link[1] if link else None)
    token = _CTX.set(ctx)
    ident = threading.get_ident()
    prev = _THREAD_TRACES.get(ident)
    _THREAD_TRACES[ident] = ctx
    if link:
        _PENDING_LINK.set(None)   # consumed: one link, one trace
        # lazy import: recorder imports this module at top level
        from .recorder import recorder
        recorder.record("trace_link", w3c_trace=link[0],
                        w3c_parent=link[1], name=name)
    try:
        yield ctx
    finally:
        _CTX.reset(token)
        if prev is not None:
            _THREAD_TRACES[ident] = prev
        else:
            _THREAD_TRACES.pop(ident, None)


@contextlib.contextmanager
def root_trace(name: str):
    """Join the active trace, or open a fresh one when none is active."""
    ctx = _CTX.get()
    if ctx is not None:
        yield ctx
        return
    with new_trace(name) as ctx:
        yield ctx


def traced(trace_name: str, span_name: Optional[str] = None):
    """Decorator: run ``fn`` under ``root_trace(trace_name)`` and a
    tracer span (one-line instrumentation for codec entry points and
    the overlay's drivers).  The span only exists when the tracer is on;
    the trace context is always established so recorder events from the
    body carry a trace id."""
    span = span_name or trace_name.replace(":", "/")

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from .tracer import tracer
            with root_trace(trace_name):
                with tracer.span(span):
                    return fn(*args, **kwargs)
        return wrapper
    return deco


# ------------------------------------------- thread context inheritance

_patch_lock = threading.Lock()
_patched = False


def install_thread_propagation() -> bool:
    """Make new threads inherit the spawner's trace context (once per
    process).  Returns True if this call performed the installation.

    Only threads started while a trace context is active are affected:
    their ``run`` executes inside a ``contextvars`` snapshot taken at
    ``start()`` time, so ``current_trace()`` (and the tracer's span
    stack) carry over.  All other threads start exactly as before.
    """
    global _patched
    with _patch_lock:
        if _patched:
            return False
        orig_start = threading.Thread.start

        @functools.wraps(orig_start)
        def start(self):
            ctx = _CTX.get()
            if ctx is not None and \
                    getattr(self, "_mosaic_torch_trace_ctx", None) is None:
                snap = contextvars.copy_context()
                self._mosaic_torch_trace_ctx = snap
                orig_run = self.run

                def run():
                    # the child joins the cross-thread trace table for
                    # the sampling profiler (the ContextVar itself flows
                    # in through the snapshot)
                    ident = threading.get_ident()
                    _THREAD_TRACES[ident] = ctx
                    try:
                        snap.run(orig_run)
                    finally:
                        _THREAD_TRACES.pop(ident, None)

                self.run = run
            orig_start(self)

        threading.Thread.start = start
        _patched = True
        return True
