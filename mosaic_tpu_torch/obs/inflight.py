"""In-flight query registry: tickets, cooperative cancellation, deadlines.

Port copy of ``mosaic_tpu.obs.inflight``.  A caller registers a
:class:`QueryTicket` (query id, principal, text, start time, current
operator, live row/byte counters) in the process-global
:class:`InflightRegistry` for its query's lifetime, keyed by the
query's trace id (``obs.context``).

Cancellation is **cooperative**: :meth:`InflightRegistry.cancel` (or an
expired deadline) only flags the ticket; the running query observes the
flag at its next :func:`checkpoint` — one at every join's entry and
between ``perf.pipeline.stream`` chunks — and raises
:class:`QueryCancelled` there.  Device work is never abandoned
mid-launch: the streamed executor drains its CUDA streams before the
error propagates, so a cancelled stream stops within one chunk boundary
and leaves nothing queued on the device.

Attribution rides the trace context: pipeline bytes, the store's
partition reads, the kernel ledger's launch seconds (``device_s``,
``obs.profiler.KernelLedger.observe``) and the memory ledger's live and
peak bytes (``mem_live_bytes``, ``mem_peak_bytes``, ``obs.memwatch``)
observed anywhere under the query charge its ticket; the per-principal
meter and audit log (``obs.accounting``) fold finished tickets.
Quiescent cost: one empty-dict check per probe when no query is
registered; env ``MOSAIC_TPU_ACCOUNTING=0`` disables registration.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

from .context import current_trace_id

__all__ = ["QueryCancelled", "QueryTicket", "InflightRegistry",
           "inflight", "checkpoint", "charge_device_seconds",
           "charge_h2d_bytes", "charge_d2h_bytes", "note_rows",
           "note_rows_in", "note_strategies", "note_mispredict",
           "note_fusion_group", "note_partitions",
           "note_partition_bytes", "note_refine", "ticket_observer"]

_qids = itertools.count(1)


class QueryCancelled(RuntimeError):
    """Raised inside a query at the first checkpoint after a cancel
    or deadline expiry: an operator/deadline action, not a client
    mistake, with its own outcome (``cancelled`` / ``deadline``)."""

    def __init__(self, query_id: str, reason: str = "cancel"):
        self.query_id = query_id
        #: ``"cancel"`` (explicit cancel()) or ``"deadline"``
        self.reason = reason
        outcome = "deadline" if reason == "deadline" else "cancelled"
        super().__init__(f"query {query_id} {outcome} "
                         f"({'deadline exceeded' if reason == 'deadline' else 'cancel requested'})")

    @property
    def outcome(self) -> str:
        return "deadline" if self.reason == "deadline" else "cancelled"


class QueryTicket:
    """One registered query: identity + live progress counters.

    Mutated from multiple threads (the query's own and a cancelling
    one); every mutation is a single
    GIL-atomic attribute write or an int/float augmented assignment
    under the registry's read patterns — small races only smear live
    counters, never correctness."""

    def __init__(self, query_id: str, principal: str, sql: str,
                 trace_id: Optional[str], deadline_ms: float = 0.0):
        self.query_id = query_id
        self.principal = principal
        self.sql = sql
        self.trace_id = trace_id
        self.start_ts = time.time()
        self._t0 = time.perf_counter()
        #: absolute perf_counter deadline, or None
        self.deadline = (self._t0 + deadline_ms / 1e3
                         if deadline_ms and deadline_ms > 0 else None)
        self.operator = "-"          # current operator
        self.rows = 0                # rows out of the last stage
        self.rows_in = 0             # rows out of the scan/join stage
        self.compiles0 = 0.0         # jax/recompiles at registration
        self.h2d_bytes = 0           # pipeline staging charged here
        self.d2h_bytes = 0           # pipeline/fusion fetches charged
        self.device_s = 0.0          # kernel launch seconds charged
        self.mem_live_bytes = 0      # device bytes live right now
        self.mem_peak_bytes = 0      # device bytes high-water mark
        self.strategies: Dict[str, str] = {}   # planner picks per op
        self.mispredicts = 0         # planner estimates past the factor
        self.fusion_groups: List[str] = []     # fused groups executed
        #: store cells touched: cell -> [rows read, bytes staged]
        self.partitions: Dict[int, List[int]] = {}
        #: adaptive-refinement counters (cells_refined / cells_flat /
        #: refined_points / flat_points), accumulated over every
        #: refined join the query ran
        self.refine: Dict[str, int] = {}
        #: per-call refinement summaries: (operator at call time,
        #: summary string)
        self.refine_ops: List[tuple] = []
        self.status = "running"
        self._cancel_reason: Optional[str] = None

    # -- cooperative cancellation
    def request_cancel(self, reason: str = "cancel") -> None:
        if self._cancel_reason is None:
            self._cancel_reason = reason

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_reason is not None

    def check(self) -> None:
        """Raise :class:`QueryCancelled` if flagged or past deadline."""
        if self._cancel_reason is not None:
            raise QueryCancelled(self.query_id, self._cancel_reason)
        if self.deadline is not None and \
                time.perf_counter() > self.deadline:
            self._cancel_reason = "deadline"
            raise QueryCancelled(self.query_id, "deadline")

    # -- reads
    @property
    def wall_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def cost(self) -> Dict[str, object]:
        """The live cost vector (partial until the query completes)."""
        return {
            "wall_ms": round(self.wall_ms, 3),
            "device_s": round(self.device_s, 6),
            "rows": int(self.rows),
            "h2d_bytes": int(self.h2d_bytes),
            "d2h_bytes": int(self.d2h_bytes),
            "mem_live_bytes": int(self.mem_live_bytes),
            "mem_peak_bytes": int(self.mem_peak_bytes),
            "cells_refined": int(self.refine.get("cells_refined", 0)),
            "cells_flat": int(self.refine.get("cells_flat", 0)),
        }

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready state of the ticket."""
        return {
            "query_id": self.query_id,
            "principal": self.principal,
            "sql": self.sql,
            "trace": self.trace_id,
            "start_ts": round(self.start_ts, 3),
            "status": self.status,
            "operator": self.operator,
            "cancel_requested": self.cancel_requested,
            "deadline_ms": round((self.deadline - self._t0) * 1e3, 1)
            if self.deadline is not None else 0.0,
            "cost": self.cost(),
        }


class InflightRegistry:
    """Process-global map of running queries, keyed by query id AND by
    trace id (the checkpoint/attribution lookup key)."""

    def __init__(self):
        env = os.environ.get("MOSAIC_TPU_ACCOUNTING", "").strip().lower()
        #: registration switch (``MOSAIC_TPU_ACCOUNTING=0`` = off);
        #: checks stay one empty-dict probe either way
        self.enabled = env not in ("0", "off", "false", "no")
        self._lock = threading.Lock()
        self._active: Dict[str, QueryTicket] = {}       # qid -> ticket
        self._by_trace: Dict[str, QueryTicket] = {}     # trace -> ticket

    # -- lifecycle
    def register(self, sql: str, principal: str = "anonymous",
                 deadline_ms: float = 0.0,
                 trace_id: Optional[str] = None) -> Optional[QueryTicket]:
        """Open a ticket (None when accounting is disabled).
        ``trace_id`` defaults to the active trace context's id."""
        if not self.enabled:
            return None
        if trace_id is None:
            trace_id = current_trace_id()
        t = QueryTicket(f"q{os.getpid()}-{next(_qids)}", principal,
                        sql, trace_id, deadline_ms)
        from .metrics import metrics
        # the port has no jit, so this stays 0 (ROADMAP C14)
        t.compiles0 = metrics.counter_value("jax/recompiles")
        with self._lock:
            self._active[t.query_id] = t
            if trace_id is not None:
                self._by_trace[trace_id] = t
        if metrics.enabled:
            metrics.count("inflight/registered")
            metrics.gauge("inflight/active", float(len(self._active)))
        cb = getattr(_registration_observer, "cb", None)
        if cb is not None:
            # observer trouble must never fail the query it watches
            try:
                cb(t)
            except Exception:
                pass
        return t

    def finish(self, ticket: Optional[QueryTicket],
               status: str = "ok") -> None:
        """Close a ticket (idempotent; None passes through)."""
        if ticket is None:
            return
        ticket.status = status
        with self._lock:
            self._active.pop(ticket.query_id, None)
            if ticket.trace_id is not None and \
                    self._by_trace.get(ticket.trace_id) is ticket:
                self._by_trace.pop(ticket.trace_id, None)
        from .metrics import metrics
        if metrics.enabled:
            metrics.gauge("inflight/active", float(len(self._active)))

    # -- control
    def cancel(self, query_id: str, reason: str = "cancel") -> bool:
        """Flag a running query for cancellation; True if it was
        found in flight.  The query raises at its next checkpoint."""
        with self._lock:
            t = self._active.get(query_id)
        if t is None:
            return False
        t.request_cancel(reason)
        from .metrics import metrics
        if metrics.enabled:
            metrics.count("inflight/cancel_requests")
        from .recorder import recorder
        recorder.record("query_cancel_requested", query_id=query_id,
                        principal=t.principal, reason=reason)
        return True

    # -- reads
    def get(self, query_id: str) -> Optional[QueryTicket]:
        with self._lock:
            return self._active.get(query_id)

    def ticket_for_trace(self, trace_id: Optional[str]
                         ) -> Optional[QueryTicket]:
        if trace_id is None:
            return None
        return self._by_trace.get(trace_id)

    def list_active(self) -> List[Dict[str, object]]:
        with self._lock:
            tickets = list(self._active.values())
        return [t.snapshot() for t in
                sorted(tickets, key=lambda t: t.start_ts)]

    def __len__(self) -> int:
        return len(self._active)


#: the process-global registry
inflight = InflightRegistry()

#: thread-local ticket-registration observer (see ticket_observer)
_registration_observer = threading.local()


@contextlib.contextmanager
def ticket_observer(cb: Callable[[QueryTicket], None]) -> Iterator[None]:
    """Watch ticket registrations made on THIS thread.

    A caller whose query registers its own ticket has no handle on
    the query id it would need for :meth:`InflightRegistry.cancel`.
    Inside this context every :meth:`~InflightRegistry.register` call
    on the current thread passes the fresh ticket to ``cb`` before any
    query work runs.  Thread-local by design: threads spawned by the
    query inherit its *trace*, not this hook.  Observer exceptions are
    swallowed (watching a query must not fail it)."""
    prev = getattr(_registration_observer, "cb", None)
    _registration_observer.cb = cb
    try:
        yield
    finally:
        _registration_observer.cb = prev


# ------------------------------------------------------------- probes
#
# Module-level helpers with the one-empty-dict-check quiescent cost.
# They key off the ACTIVE TRACE: once a caller installs
# obs.context.install_thread_propagation, threads inherit the spawning
# query's trace, so charges from threads a query starts land on its
# ticket.

def _active_ticket() -> Optional[QueryTicket]:
    if not inflight._by_trace:          # quiescent fast path
        return None
    return inflight._by_trace.get(current_trace_id())


def checkpoint(operator: Optional[str] = None) -> None:
    """Cooperative cancellation probe: update the active ticket's
    current operator and raise :class:`QueryCancelled` if it was
    cancelled or blew its deadline.  No-op (one dict check) outside
    any registered query."""
    t = _active_ticket()
    if t is None:
        return
    if operator is not None:
        t.operator = operator
    t.check()


def charge_device_seconds(seconds: float) -> None:
    """Charge kernel-launch wall time to the active ticket (called from
    :meth:`~.profiler.KernelLedger.observe`)."""
    t = _active_ticket()
    if t is not None:
        t.device_s += float(seconds)


def charge_h2d_bytes(n: int) -> None:
    """Charge host->device staging bytes to the active ticket."""
    t = _active_ticket()
    if t is not None:
        t.h2d_bytes += int(n)


def charge_d2h_bytes(n: int) -> None:
    """Charge device->host fetch bytes to the active ticket (the
    pipeline's chunk drains)."""
    t = _active_ticket()
    if t is not None:
        t.d2h_bytes += int(n)


def note_rows(rows: int) -> None:
    """Record the latest stage's output rows on the active ticket."""
    t = _active_ticket()
    if t is not None:
        t.rows = int(rows)


def note_rows_in(rows: int) -> None:
    """Record the source stage's (scan/join) output rows."""
    t = _active_ticket()
    if t is not None:
        t.rows_in = int(rows)


def note_strategies(strategies: Dict[str, str]) -> None:
    """Attach the planner's per-operator strategy picks to the active
    ticket."""
    t = _active_ticket()
    if t is not None:
        t.strategies.update(strategies)


def note_refine(stats: Dict[str, int],
                summary: Optional[str] = None) -> None:
    """Accumulate one refined-join run's counters (``cells_refined``,
    ``cells_flat``, ``refined_points``, ``flat_points``) on the active
    ticket and, when ``summary`` is given, append it to the per-call
    refinement log under the operator the query is currently in."""
    t = _active_ticket()
    if t is None:
        return
    for k, v in dict(stats).items():
        try:
            t.refine[k] = t.refine.get(k, 0) + int(v)
        except (TypeError, ValueError):
            pass                      # non-scalar stats stay off the sum
    if summary:
        t.refine_ops.append((t.operator, str(summary)))


def note_mispredict() -> None:
    """Count one planner cardinality mispredict against the active
    ticket."""
    t = _active_ticket()
    if t is not None:
        t.mispredicts += 1


def note_fusion_group(name: str) -> None:
    """Record one fused-group execution on the active ticket."""
    t = _active_ticket()
    if t is not None:
        t.fusion_groups.append(str(name))


def note_partitions(spans) -> None:
    """Charge ``(cell, rows)`` store-read spans to the active ticket's
    partition ledger (the chip-store chunk/partition read paths)."""
    t = _active_ticket()
    if t is None:
        return
    for cell, rows in spans:
        e = t.partitions.get(cell)
        if e is None:
            t.partitions[cell] = [int(rows), 0]
        else:
            e[0] += int(rows)


def note_partition_bytes(by_cell) -> None:
    """Charge per-partition staged bytes (the store-fed join's
    ``staged_bytes_by_partition`` ledger) to the active ticket."""
    t = _active_ticket()
    if t is None:
        return
    for cell, nbytes in dict(by_cell).items():
        e = t.partitions.get(cell)
        if e is None:
            t.partitions[cell] = [0, int(nbytes)]
        else:
            e[1] += int(nbytes)
