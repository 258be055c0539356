"""Per-principal metering and the bounded query audit log.

Port copy of ``mosaic_tpu.obs.accounting``: the same meter fields,
audit records, spool rotation and per-principal objectives.  Three
pieces, all fed by :mod:`~.inflight` tickets at completion:

* :class:`PrincipalMeter` — folds each completed ticket's cost vector
  (wall ms, device seconds joined from the :class:`~.profiler.
  KernelLedger` via trace attribution, rows in/out, H2D and D2H bytes,
  the memory ledger's peak bytes, compile count) into per-principal
  totals, and mirrors them into ``principal/<field>/<name>`` metrics so
  the sampler turns them into time series.  The port has no jit, so
  ``compiles`` is 0 (ROADMAP C14).
* :class:`AuditLog` — bounded in-memory ring of completion records
  (principal, cost vector, planner strategy decisions, outcome
  ok/error/cancelled/deadline), optionally spooled as JSONL when
  ``mosaic.audit.path`` is set (path re-read per write, rotated past
  ``mosaic.audit.rotate.bytes``, ``mosaic.audit.retain`` files kept).
* per-principal SLOs — the first completion for a new principal
  registers a loose ``gauge_max`` (per-query latency ceiling) and
  ``counter_rate`` (query-rate ceiling) pair with the global monitor.

:func:`accounted` opens a trace + ticket around arbitrary work (a
streamed join, say) and completes it with the right outcome.

:func:`complete` also hands each record to the durable workload history
(``obs/history.py``, ``history.record_completion``): one record per
completed query, whatever its outcome, when ``mosaic.history.dir`` is
set.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from .context import new_trace
from .inflight import QueryTicket, inflight
from .metrics import metrics
from .recorder import recorder
from .slo import principal_objectives
from .timeseries import timeseries

__all__ = ["PrincipalMeter", "AuditLog", "meter", "audit",
           "complete", "accounted", "principal_objectives"]

#: cost-vector fields the meter accumulates per principal
_METER_FIELDS = ("queries", "wall_ms", "device_s", "rows_in",
                 "rows_out", "h2d_bytes", "d2h_bytes",
                 "mem_peak_bytes", "compiles")


class PrincipalMeter:
    """Per-principal cost accumulator; cheap enough to stay always on
    (one dict update per completed query, nothing per operator)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, Dict[str, float]] = {}
        self._outcomes: Dict[str, Dict[str, int]] = {}

    def charge(self, principal: str, cost: Dict[str, float],
               outcome: str = "ok") -> None:
        """Fold one completed query's cost vector into the principal's
        totals and mirror it into ``principal/*`` metrics."""
        first = False
        with self._lock:
            tot = self._totals.get(principal)
            if tot is None:
                first = True
                tot = self._totals[principal] = \
                    {f: 0.0 for f in _METER_FIELDS}
                self._outcomes[principal] = collections.defaultdict(int)
            tot["queries"] += 1
            for f in _METER_FIELDS[1:]:
                tot[f] += float(cost.get(f, 0.0))
            self._outcomes[principal][outcome] += 1
        if metrics.enabled:
            metrics.count(f"principal/queries/{principal}")
            metrics.count(f"principal/wall_ms/{principal}",
                          float(cost.get("wall_ms", 0.0)))
            metrics.count(f"principal/device_s/{principal}",
                          float(cost.get("device_s", 0.0)))
            metrics.count(f"principal/rows_out/{principal}",
                          float(cost.get("rows_out", 0.0)))
            metrics.count(f"principal/h2d_bytes/{principal}",
                          float(cost.get("h2d_bytes", 0.0)))
            metrics.count(f"principal/d2h_bytes/{principal}",
                          float(cost.get("d2h_bytes", 0.0)))
            metrics.count(f"principal/mem_peak_bytes/{principal}",
                          float(cost.get("mem_peak_bytes", 0.0)))
            metrics.count(f"principal/compiles/{principal}",
                          float(cost.get("compiles", 0.0)))
            if outcome != "ok":
                metrics.count(f"principal/failures/{principal}")
        # a per-query latency point (the gauge_max SLO's series); the
        # sampler mirrors the counters above into same-named series
        timeseries.record(f"principal/query_ms/{principal}",
                          float(cost.get("wall_ms", 0.0)))
        if first:
            from .slo import monitor
            for obj in principal_objectives(principal):
                monitor.add_objective(obj)

    # -- reads
    def principals(self) -> List[str]:
        with self._lock:
            return sorted(self._totals)

    def report(self) -> Dict[str, Dict[str, object]]:
        """{principal: {totals..., outcomes: {...}}}."""
        with self._lock:
            return {
                p: dict({f: (int(v) if f in ("queries", "rows_in",
                                             "rows_out", "h2d_bytes",
                                             "d2h_bytes",
                                             "mem_peak_bytes",
                                             "compiles")
                             else round(v, 6))
                         for f, v in tot.items()},
                        outcomes=dict(self._outcomes[p]))
                for p, tot in self._totals.items()
            }

    def mean_wall_ms(self, principal: str) -> Optional[float]:
        """The principal's observed mean query latency, or None before
        its first completed query."""
        with self._lock:
            tot = self._totals.get(principal)
            if not tot or not tot.get("queries"):
                return None
            return float(tot["wall_ms"]) / float(tot["queries"])

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._outcomes.clear()


class AuditLog:
    """Bounded ring of query completion records + optional JSONL spool.

    One record per completed query — also for cancelled / deadline /
    errored ones, whose cost vector is the partial cost at the point
    the query stopped.  The ring keeps the last ``capacity`` records
    in memory for the console; the spool (``mosaic.audit.path``)
    appends every record as one JSON line for offline retention."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._written = 0
        self._spool_errors = 0

    def append(self, record: Dict[str, object]) -> None:
        with self._lock:
            self._ring.append(record)
            self._written += 1
        recorder.record("audit", **record)
        path = self._spool_path()
        if path:
            try:
                with open(path, "a", encoding="utf-8") as fh:
                    fh.write(json.dumps(record, default=str,
                                        sort_keys=True) + "\n")
                self._maybe_rotate(path)
            except OSError:
                # retention is best-effort; never fail the query over
                # a full disk — surface it as a counter instead
                with self._lock:
                    self._spool_errors += 1
                if metrics.enabled:
                    metrics.count("audit/spool_errors")

    @staticmethod
    def _spool_path() -> str:
        from .. import config as _config
        return getattr(_config.default_config(), "audit_path", "") or ""

    @staticmethod
    def _maybe_rotate(path: str) -> None:
        """Bound the spool: past ``mosaic.audit.rotate.bytes`` the
        live file renames to ``<path>.<ts>`` and at most
        ``mosaic.audit.retain`` rotated files survive.  Rotation
        trouble is swallowed (same best-effort contract as the write
        itself)."""
        from .. import config as _config
        cfg = _config.default_config()
        limit = int(getattr(cfg, "audit_rotate_bytes", 0))
        if limit <= 0:
            return
        try:
            if os.path.getsize(path) < limit:
                return
            rotated = f"{path}.{int(time.time() * 1e3):013d}"
            while os.path.exists(rotated):
                rotated += "x"
            os.replace(path, rotated)
        except OSError:
            return
        if metrics.enabled:
            metrics.count("audit/spool_rotations")
        retain = int(getattr(cfg, "audit_retain", 8))
        if retain > 0:
            old = sorted(p for p in glob.glob(f"{path}.*")
                         if p[len(path) + 1:].rstrip("x").isdigit())
            for p in old[:max(0, len(old) - retain)]:
                try:
                    os.remove(p)
                except OSError:
                    pass

    # -- reads
    def records(self, principal: Optional[str] = None,
                outcome: Optional[str] = None,
                limit: int = 0) -> List[Dict[str, object]]:
        """Newest-last view of the ring, optionally filtered."""
        with self._lock:
            recs = list(self._ring)
        if principal is not None:
            recs = [r for r in recs if r.get("principal") == principal]
        if outcome is not None:
            recs = [r for r in recs if r.get("outcome") == outcome]
        return recs[-limit:] if limit else recs

    def written(self) -> int:
        with self._lock:
            return self._written

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._written = 0
            self._spool_errors = 0


#: process-global meter + audit log (the completion path below feeds
#: both; flight-recorder bundles read them)
meter = PrincipalMeter()
audit = AuditLog()


def complete(ticket: Optional[QueryTicket], outcome: str = "ok",
             error: Optional[BaseException] = None,
             wall_ms: Optional[float] = None) -> Optional[Dict[str, object]]:
    """Close the books on one query: run the memory ledger's leak
    sentinel, build the final cost vector from the ticket, remove the
    ticket from the in-flight registry, write the audit record and
    charge the meter.  Safe no-op for a None ticket (accounting
    disabled).  Returns the audit record."""
    if ticket is None:
        return None
    if wall_ms is None:
        wall_ms = ticket.wall_ms
    try:
        # leak sentinel first: finalizes the ticket's mem peak and
        # force-releases (+ flight-records) any buffer still registered
        # to this query's trace, BEFORE the cost vector is built
        from .memwatch import memwatch
        memwatch.on_query_complete(ticket)
    except Exception:
        pass
    compiles = int(max(0.0, metrics.counter_value("jax/recompiles")
                       - ticket.compiles0))
    cost = {
        "wall_ms": round(float(wall_ms), 3),
        "device_s": round(ticket.device_s, 6),
        "rows_in": int(ticket.rows_in),
        "rows_out": int(ticket.rows),
        "h2d_bytes": int(ticket.h2d_bytes),
        "d2h_bytes": int(ticket.d2h_bytes),
        "mem_peak_bytes": int(ticket.mem_peak_bytes),
        "compiles": compiles,
        # adaptive-refinement columns (0 for queries that never ran a
        # refined join); the audit log carries them verbatim
        "cells_refined": int(ticket.refine.get("cells_refined", 0)),
        "cells_flat": int(ticket.refine.get("cells_flat", 0)),
    }
    record: Dict[str, object] = {
        "query_id": ticket.query_id,
        "principal": ticket.principal,
        "sql": ticket.sql,
        "trace": ticket.trace_id,
        "start_ts": round(ticket.start_ts, 3),
        "end_ts": round(time.time(), 3),
        "outcome": outcome,
        "operator": ticket.operator,
        "strategies": dict(ticket.strategies),
        "cost": cost,
    }
    if error is not None:
        record["error"] = f"{type(error).__name__}: {error}"
    inflight.finish(ticket, status=outcome)
    audit.append(record)
    # the durable workload history (obs/history.py): exactly one record
    # per completed query — every outcome, partial costs included —
    # widened with the ticket's mispredict, fusion and partition
    # columns.  Lazy import: history's fault probe pulls
    # resilience.faults, which imports obs back.
    from .history import history as _history
    _history.record_completion(record, ticket)
    meter.charge(ticket.principal,
                 {"wall_ms": cost["wall_ms"],
                  "device_s": cost["device_s"],
                  "rows_in": float(cost["rows_in"]),
                  "rows_out": float(cost["rows_out"]),
                  "h2d_bytes": float(cost["h2d_bytes"]),
                  "d2h_bytes": float(cost["d2h_bytes"]),
                  "mem_peak_bytes": float(cost["mem_peak_bytes"]),
                  "compiles": compiles},
                 outcome=outcome)
    return record


@contextlib.contextmanager
def accounted(name: str, principal: str = "anonymous",
              deadline_ms: float = 0.0) -> Iterator[Optional[QueryTicket]]:
    """Meter an arbitrary block of work as one query: opens a trace
    (so ledger/pipeline charges attribute here), registers a ticket,
    and completes it with the right outcome on exit."""
    from .inflight import QueryCancelled
    with new_trace(name):
        ticket = inflight.register(name, principal=principal,
                                   deadline_ms=deadline_ms)
        try:
            yield ticket
        except QueryCancelled as exc:
            complete(ticket, outcome=exc.outcome, error=exc)
            raise
        except BaseException as exc:
            complete(ticket, outcome="error", error=exc)
            raise
        else:
            complete(ticket, outcome="ok")
