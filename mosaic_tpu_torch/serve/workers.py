"""Worker pool: admitted queries onto the shared warm engine.

Port copy of ``mosaic_tpu.serve.workers``.  Each worker is one daemon
thread looping take → :meth:`dispatch`.  ``dispatch`` is the server's
operator boundary (the JAX package's graftlint ``cancel-checkpoint``
rule holds it to the same contract as the engine's ``stage()``): it
probes the inflight checkpoint, honors the
``serve.dispatch`` fault site, routes micro-batchable point lookups
through :func:`~.batching.execute_batch`, and runs everything else
through ``SQLSession.sql`` with the request's cancellation plumbing
attached (``obs.inflight.ticket_observer``), so a client disconnect
or deadline observed on the asyncio side lands in the running query
within one pipeline chunk.  All workers share ONE session — and
therefore one set of built kernels, one planner coefficient store, one
catalog — which is the entire point of a long-lived server process.
"""

from __future__ import annotations

import threading
import time
from typing import List

from ..obs import metrics
from ..obs.context import link_traceparent
from ..obs.inflight import QueryCancelled, checkpoint, ticket_observer
from ..resilience import faults
from ..resilience.faults import InjectedFault
from ..sql.engine import SQLError
from ..sql.parser import SQLParseError
from .admission import AdmissionQueue, ServeRequest

__all__ = ["WorkerPool"]


class WorkerPool:
    def __init__(self, session, queue: AdmissionQueue,
                 workers: int, batch_max: int,
                 batch_window_ms: float):
        self.session = session
        self.queue = queue
        self.workers = int(workers)
        self.batch_max = int(batch_max)
        self.batch_window_ms = float(batch_window_ms)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._busy_lock = threading.Lock()
        self.busy = 0

    # -- lifecycle
    def start(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"mosaic-serve-worker-{i}")
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        deadline = time.perf_counter() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        self._threads = [t for t in self._threads if t.is_alive()]

    def idle(self) -> bool:
        with self._busy_lock:
            return self.busy == 0

    def _run(self) -> None:
        while not self._stop.is_set():
            req = self.queue.take(timeout=0.05)
            if req is None:
                continue
            with self._busy_lock:
                self.busy += 1
                if metrics.enabled:
                    metrics.gauge("serve/workers_busy",
                                  float(self.busy))
            try:
                self.dispatch(req)
            finally:
                self.queue.release(req)
                with self._busy_lock:
                    self.busy -= 1
                    if metrics.enabled:
                        metrics.gauge("serve/workers_busy",
                                      float(self.busy))

    # -- the per-request operator boundary
    def dispatch(self, req: ServeRequest) -> None:
        """Execute one admitted request and resolve its future.  Never
        raises: every outcome — including an injected ``serve.
        dispatch`` fault — becomes a response, and ticket lifecycle is
        owned by the paths below (sql() completes its own ticket in
        its finally; the batcher completes per-member tickets), so a
        worker unwinding mid-query leaks neither tickets nor threads."""
        checkpoint("serve.dispatch")     # boundary probe (no-op unless
        # this worker thread somehow still carries a query trace)
        try:
            faults.maybe_fail("serve.dispatch")
        except InjectedFault as exc:
            if metrics.enabled:
                metrics.count("serve/dispatch_errors")
            req.resolve(500, {"error": f"{type(exc).__name__}: {exc}"},
                        "error")
            return
        if req.cancel_reason is not None:
            # disconnected (or deadline-cancelled) while queued: no
            # ticket was ever opened, nothing ran — just answer
            outcome = "deadline" if req.cancel_reason == "deadline" \
                else "cancelled"
            req.resolve(499 if outcome == "cancelled" else 504,
                        {"error": outcome}, outcome)
            return
        if req.lookup is not None and self.batch_max > 0:
            members = [req]
            if self.batch_max > 1:
                if self.batch_window_ms > 0:
                    # brief window so a concurrent burst of lookups
                    # lands in this launch instead of the next
                    time.sleep(self.batch_window_ms / 1e3)
                members += self.queue.take_compatible(
                    req.lookup.signature, self.batch_max - 1)
            try:
                from .batching import execute_batch
                execute_batch(self.session, members)
            finally:
                for m in members[1:]:
                    self.queue.release(m)
            return
        self._run_single(req)

    def _run_single(self, req: ServeRequest) -> None:
        # link_traceparent parks the client's W3C trace context so the
        # engine's new_trace stitches this query into the caller's
        # cross-process tree (no-op when the client sent no header).
        # The micro-batch path skips linking: one device launch serves
        # many clients, and a batch trace has no single parent.
        with link_traceparent(req.traceparent), \
                ticket_observer(req.attach_ticket):
            try:
                out = self.session.sql(req.sql)
            except QueryCancelled as exc:
                req.resolve(499 if exc.outcome == "cancelled" else 504,
                            {"error": exc.outcome}, exc.outcome)
            except (SQLError, SQLParseError) as exc:
                req.resolve(400, {"error": str(exc)}, "error")
            except Exception as exc:
                if metrics.enabled:
                    metrics.count("serve/errors")
                req.resolve(500,
                            {"error": f"{type(exc).__name__}: {exc}"},
                            "error")
            else:
                req.resolve(200, out, "ok")
