"""Bounded admission queue with per-tenant quotas and priority shed.

Port copy of ``mosaic_tpu.serve.admission``; the logic is the JAX
package's line for line.  The scheduler half of the LocationSpark split
(arxiv 1907.03736): the server never throws concurrent load straight at
the executor.  Every request passes :meth:`AdmissionQueue.offer`, which
applies — in order of increasing cost — the tenant's rate quota
(admissions per second over a 1 s sliding window), the tenant's
concurrency quota (queued + running), the device-memory budget
(:meth:`~..obs.memwatch.MemoryBudget.admit` over the planner's byte
estimate — deny, never OOM), and finally the global queue depth.  A full
queue load-sheds the LOWEST-priority entry: an arriving request evicts a
strictly lower-priority queued one (which completes with 429), otherwise
it is itself shed.  Every deny carries a Retry-After hint; the
concurrency hint is derived from the tenant's own observed mean query
latency (the :class:`~..obs.accounting.PrincipalMeter` feed), so a
tenant running heavy queries is told to back off longer than one running
point lookups.

Workers drain the queue highest-priority-first (FIFO within a priority)
via :meth:`take`; :meth:`take_compatible` additionally pulls queued point
lookups that share a batch signature so one device call can serve
several queries (serve/batching.py).

Fleet mode (serve/supervisor.py): constructed with a shared
:class:`~.scoreboard.Scoreboard`, the rate and concurrency checks become
one atomic count-and-claim against the mmap'd scoreboard, so the same
quotas hold across every worker process; the claim token rides on the
request and is released on completion, shed, or flush — and by the
supervisor's reaper if this whole process dies holding it.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from ..obs.metrics import metrics
from ..obs.recorder import recorder

__all__ = ["ServeRequest", "Deny", "AdmissionQueue"]

_seq = itertools.count(1)

#: rate-quota sliding window (seconds) — quota.qps admissions per this
_RATE_WINDOW_S = 1.0


class Deny:
    """One admission refusal: HTTP status, machine reason, retry hint."""

    __slots__ = ("status", "reason", "retry_after")

    def __init__(self, status: int, reason: str, retry_after: float):
        self.status = status
        self.reason = reason
        self.retry_after = max(0.05, round(float(retry_after), 3))

    def payload(self) -> Dict[str, object]:
        return {"error": "denied", "reason": self.reason,
                "retry_after_s": self.retry_after}


class ServeRequest:
    """One admitted (or pending-admission) query riding through the
    server: identity, priority, the worker-resolved result future,
    and the cancellation plumbing that joins the asyncio side (client
    disconnect, server deadline) to the inflight ticket."""

    def __init__(self, sql: str, principal: str, priority: int = 0,
                 deadline_ms: float = 0.0, lookup=None,
                 traceparent: Optional[str] = None):
        import concurrent.futures
        #: fleet mode: the scoreboard CONC claim this request holds
        #: from admission until release/shed/flush (SlotToken)
        self.sb_token = None
        self.sql = sql
        self.label = " ".join(sql.split())[:60]
        self.principal = principal
        self.priority = int(priority)
        self.deadline_ms = float(deadline_ms)
        #: the client's W3C traceparent header, if it sent one — the
        #: worker links the query's trace to it (cross-process trees)
        self.traceparent = traceparent
        #: engine.BatchableLookup when the query may micro-batch
        self.lookup = lookup
        self.seq = next(_seq)
        self.t_enqueue = time.perf_counter()
        self.future: "concurrent.futures.Future" = \
            concurrent.futures.Future()
        self._lock = threading.Lock()
        self.cancel_reason: Optional[str] = None
        self.ticket = None

    # -- cancellation join (asyncio side calls these)
    def request_cancel(self, reason: str) -> None:
        """Flag the request; if a ticket is already attached the flag
        lands there too, so the running query raises at its next
        checkpoint (within one pipeline chunk)."""
        with self._lock:
            if self.cancel_reason is None:
                self.cancel_reason = reason
            ticket = self.ticket
        if ticket is not None:
            from ..obs.inflight import inflight
            inflight.cancel(ticket.query_id, reason)

    def attach_ticket(self, ticket) -> None:
        """Worker-side: bind the ticket ``SQLSession.sql`` registered
        (via ``obs.inflight.ticket_observer``).  Applies the
        per-request deadline and any cancel that raced registration."""
        with self._lock:
            self.ticket = ticket
            reason = self.cancel_reason
        if ticket is None:
            return
        # the shared session registers under its own principal; the
        # meter / audit / SLO feed must see the TENANT who sent this
        ticket.principal = self.principal
        if self.deadline_ms > 0:
            d = ticket._t0 + self.deadline_ms / 1e3
            ticket.deadline = d if ticket.deadline is None \
                else min(ticket.deadline, d)
        if reason is not None:
            ticket.request_cancel(reason)

    def resolve(self, status: int, body, outcome: str) -> None:
        """Deliver the response (idempotent — a shed racing a worker
        pick-up must not raise InvalidStateError)."""
        if not self.future.done():
            try:
                self.future.set_result((status, body, outcome))
            except Exception:
                pass

    def queued_ms(self) -> float:
        return (time.perf_counter() - self.t_enqueue) * 1e3


class AdmissionQueue:
    """Priority queue + quota book-keeping; every method thread-safe
    (callers: the asyncio loop thread offers, worker threads take)."""

    def __init__(self, depth: int, quota_concurrency: int,
                 quota_qps: float, scoreboard=None):
        self.depth = int(depth)
        self.quota_concurrency = int(quota_concurrency)
        self.quota_qps = float(quota_qps)
        #: fleet mode (serve/scoreboard.py): when set, the rate and
        #: concurrency quotas are enforced against the shared mmap
        #: scoreboard (atomic count-and-claim across every worker
        #: process) instead of this queue's process-local state
        self.scoreboard = scoreboard
        self._cond = threading.Condition()
        self._queued: List[ServeRequest] = []
        self._running: Dict[str, int] = collections.defaultdict(int)
        self._rate: Dict[str, Deque[float]] = \
            collections.defaultdict(collections.deque)
        self._admitted: Dict[str, int] = collections.defaultdict(int)
        self._shed: Dict[str, int] = collections.defaultdict(int)
        self.draining = False

    # -- admission -----------------------------------------------------
    def offer(self, req: ServeRequest,
              est_bytes: int = 0) -> Optional[Deny]:
        """Admit ``req`` (returns None) or refuse it (returns the
        :class:`Deny`; the request's future stays untouched so the
        caller writes the 429/503 itself)."""
        now = time.perf_counter()
        with self._cond:
            if self.draining:
                return self._deny(req, Deny(503, "draining", 1.0))
            if self.scoreboard is not None:
                deny = self._offer_scoreboard_locked(req)
                if deny is not None:
                    return deny
            else:
                win = self._rate[req.principal]
                while win and now - win[0] > _RATE_WINDOW_S:
                    win.popleft()
                if self.quota_qps > 0 and len(win) >= self.quota_qps:
                    return self._deny(req, Deny(
                        429, "rate_quota",
                        win[0] + _RATE_WINDOW_S - now))
                if self.quota_concurrency > 0:
                    held = self._running[req.principal] + \
                        sum(1 for r in self._queued
                            if r.principal == req.principal)
                    if held >= self.quota_concurrency:
                        return self._deny(req, Deny(
                            429, "concurrency_quota",
                            self._latency_hint(req.principal)))
            if est_bytes > 0:
                from ..obs.memwatch import mem_budget
                if not mem_budget.admit(est_bytes):
                    self._release_token(req)
                    return self._deny(req, Deny(429, "memory_budget",
                                                1.0))
            if len(self._queued) >= self.depth:
                victim = min(self._queued,
                             key=lambda r: (r.priority, -r.seq))
                if victim.priority >= req.priority:
                    self._release_token(req)
                    return self._shed_one(req, evicted=False)
                self._queued.remove(victim)
                self._shed_one(victim, evicted=True)
            self._queued.append(req)
            if self.scoreboard is None:
                self._rate[req.principal].append(now)
            self._admitted[req.principal] += 1
            self._cond.notify()
            if metrics.enabled:
                metrics.count("serve/admitted")
                metrics.gauge("serve/queue_depth",
                              float(len(self._queued)))
        return None

    def _offer_scoreboard_locked(self,
                                 req: ServeRequest) -> Optional[Deny]:
        """Fleet-wide admission: one atomic count-and-claim against
        the shared scoreboard.  On success the request carries the
        CONC token until release/shed/flush; a worker dying with it
        leaks nothing — the supervisor's reap (or the next admission
        for the tenant) frees dead-owner slots."""
        token, refused = self.scoreboard.admit(
            req.principal, self.quota_concurrency, self.quota_qps)
        if refused is not None:
            reason, retry_after = refused
            if reason == "concurrency_quota":
                retry_after = self._latency_hint(req.principal)
            status = 503 if reason == "scoreboard_full" else 429
            return self._deny(req, Deny(status, reason, retry_after))
        req.sb_token = token
        return None

    def _release_token(self, req: ServeRequest) -> None:
        """Give a held scoreboard claim back (idempotent)."""
        token, req.sb_token = req.sb_token, None
        if token is not None and self.scoreboard is not None:
            self.scoreboard.release(token)

    def _deny(self, req: ServeRequest, deny: Deny) -> Deny:
        if metrics.enabled:
            metrics.count("serve/denied")
            metrics.count(f"serve/denied_{deny.reason}")
        return deny

    def _shed_one(self, req: ServeRequest, evicted: bool) -> Deny:
        """Overload shed: count it, flight-record it, and — for an
        evicted queued request — resolve its future with the 429.
        Either way the victim's scoreboard claim goes back."""
        self._release_token(req)
        self._shed[req.principal] += 1
        deny = Deny(429, "shed", 1.0)
        if metrics.enabled:
            metrics.count("serve/shed")
            metrics.count(f"serve/shed/{req.principal}")
        recorder.record("serve_shed", principal=req.principal,
                        priority=req.priority, evicted=evicted,
                        sql=req.label)
        if evicted:
            req.resolve(deny.status, deny.payload(), "shed")
        return deny

    def _latency_hint(self, principal: str) -> float:
        """Retry-After for a concurrency deny: the tenant's own mean
        query latency (PrincipalMeter totals), clamped to [0.05, 5]s —
        heavier workloads are told to wait longer."""
        try:
            from ..obs.accounting import meter
            ms = meter.mean_wall_ms(principal)
            if ms is not None:
                return min(5.0, max(0.05, ms / 1e3))
        except Exception:
            pass
        return 0.1

    # -- worker side ---------------------------------------------------
    def take(self, timeout: float = 0.1) -> Optional[ServeRequest]:
        """Pop the highest-priority queued request (FIFO within a
        priority); None on timeout."""
        with self._cond:
            if not self._queued:
                self._cond.wait(timeout)
            if not self._queued:
                return None
            req = max(self._queued, key=lambda r: (r.priority, -r.seq))
            self._queued.remove(req)
            self._running[req.principal] += 1
            if metrics.enabled:
                metrics.gauge("serve/queue_depth",
                              float(len(self._queued)))
        return req

    def take_compatible(self, signature: tuple,
                        limit: int) -> List[ServeRequest]:
        """Pop up to ``limit`` queued point lookups sharing
        ``signature`` (arrival order) for one micro-batch launch."""
        if limit <= 0:
            return []
        out: List[ServeRequest] = []
        with self._cond:
            for r in sorted(self._queued, key=lambda r: r.seq):
                if r.lookup is not None and \
                        r.lookup.signature == signature and \
                        r.cancel_reason is None:
                    out.append(r)
                    if len(out) >= limit:
                        break
            for r in out:
                self._queued.remove(r)
                self._running[r.principal] += 1
            if out and metrics.enabled:
                metrics.gauge("serve/queue_depth",
                              float(len(self._queued)))
        return out

    def release(self, req: ServeRequest) -> None:
        """A worker finished (or abandoned) a taken request."""
        with self._cond:
            self._running[req.principal] = \
                max(0, self._running[req.principal] - 1)
            self._release_token(req)

    # -- drain + reads -------------------------------------------------
    def start_drain(self) -> None:
        with self._cond:
            self.draining = True

    def queued_count(self) -> int:
        with self._cond:
            return len(self._queued)

    def running_count(self) -> int:
        with self._cond:
            return sum(self._running.values())

    def flush(self, status: int, reason: str) -> int:
        """Resolve every still-queued request (drain deadline hit);
        returns how many were flushed."""
        with self._cond:
            pending, self._queued = self._queued, []
        for r in pending:
            self._release_token(r)
            r.resolve(status, {"error": "denied", "reason": reason,
                               "retry_after_s": 1.0}, reason)
        return len(pending)

    def snapshot(self) -> Dict[str, object]:
        """Per-principal queue state for ``/api/server``."""
        with self._cond:
            queued: Dict[str, int] = collections.defaultdict(int)
            for r in self._queued:
                queued[r.principal] += 1
            principals: Dict[str, Dict[str, int]] = {}
            for p in set(queued) | set(self._running) | \
                    set(self._admitted) | set(self._shed):
                principals[p] = {
                    "queued": queued.get(p, 0),
                    "running": self._running.get(p, 0),
                    "admitted": self._admitted.get(p, 0),
                    "shed": self._shed.get(p, 0),
                }
            return {"depth": self.depth,
                    "queued": len(self._queued),
                    "running": sum(self._running.values()),
                    "draining": self.draining,
                    "principals": principals}
