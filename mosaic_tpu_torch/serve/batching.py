"""Micro-batching: several point-lookup queries, one device call.

Port of ``mosaic_tpu.serve.batching``.  Small cell-id lookups dominate
multi-tenant point workloads, and each one alone wastes a device round
trip on a few thousand rows.  Queries classified by
:func:`~..sql.engine.classify_batchable` share a batch signature
``(function, resolution)``; a worker that picks one up drains every
compatible queued request (``AdmissionQueue.take_compatible``, bounded
by ``mosaic.serve.batch.max``), concatenates the member tables'
coordinate columns and makes ONE call of the grid's
:meth:`~..core.index.base.IndexSystem.point_to_cell_device` on the
context's device: on H3 one launch of the cell kernel K3
(``csrc/h3_cell.cu``) with every low-margin point assigned again by the
f64 host path, on CUSTOM and BNG f64 torch ops.  Per-row math is
elementwise, so each member's slice of the batched output equals what
its query gives alone (``SQLSession.sql`` calls the same function), and
equals the host ``point_to_cell`` on every row.  The serial path
(``batch.max=1``) makes the same call one query at a time, which is what
the parity and fewer-launches drill compares via the
:class:`~..obs.profiler.KernelLedger`.

The JAX package jits the batch and pads it to a pow2 bucket so batch-size
jitter never recompiles; the port compiles nothing at run time, so the
batch is not padded, and the ledger key keeps the bucket.  Nothing here
catches a failure of the device call: a batch that fails resolves every
member with 500.

Accounting stays per-query: every member gets its own
:class:`~..obs.inflight.QueryTicket` under a synthetic trace id (so the
shared call's ledger charge does NOT auto-join any one member), and the
call's seconds and H2D / D2H bytes are split across members by row share
before each ticket completes through the normal
:func:`~..obs.accounting.complete` path — audit records, principal
meter, SLOs and the leak sentinel all see N queries, not one.  The
batch's device bytes are held in the memory ledger for the duration of
the call.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..obs import metrics
from ..obs.accounting import complete as _complete
from ..obs.inflight import inflight
from ..obs.jaxmon import device_key
from ..obs.memwatch import memwatch
from ..perf.bucketing import pow2_bucket
from ..sql.engine import Table
from .admission import ServeRequest

__all__ = ["execute_batch", "KERNEL_NAME"]

#: kernel-ledger name of the shared point-lookup call — the load test
#: and the parity drill count launches under this name
KERNEL_NAME = "serve/point_lookup"


def _member_tickets(members: List[ServeRequest]) -> list:
    """Open one ticket per member under a synthetic per-member trace
    id: tickets stay individually addressable (cancel-on-disconnect)
    while the batch call itself runs traceless, so the kernel ledger's
    automatic trace join charges nobody twice — the split below is the
    only device-seconds feed."""
    tickets = []
    for m in members:
        t = inflight.register(m.label, principal=m.principal,
                              deadline_ms=m.deadline_ms,
                              trace_id=f"serve-batch:{m.seq}")
        if t is not None:
            t.strategies["serve"] = f"batched[{len(members)}]"
        m.attach_ticket(t)
        tickets.append(t)
    return tickets


def _device_bytes(system, n: int) -> tuple:
    """(H2D, D2H) bytes of one ``point_to_cell_device`` call on ``n``
    points: the [n, 2] points in the grid's ``route_dtype`` up, the int64
    cells and the margins (``route_dtype``) back."""
    item = np.dtype(system.route_dtype).itemsize
    return 2 * n * item, n * (8 + item)


def execute_batch(session, members: List[ServeRequest]) -> None:
    """Run one micro-batch (possibly of size 1) and resolve every
    member's future.  Members must share a batch signature."""
    lookup = members[0].lookup
    mc = session.mc
    system = mc.index_system
    res = lookup.res
    tickets = _member_tickets(members)
    t0 = time.perf_counter()
    try:
        parts = []
        for m in members:
            table = session.table(m.lookup.table)
            parts.append(np.stack(
                [np.asarray(table.columns[m.lookup.lon], np.float64),
                 np.asarray(table.columns[m.lookup.lat], np.float64)],
                axis=-1))
        rows_list = [len(p) for p in parts]   # authoritative (the
        # catalog may have grown since classification froze .rows)
        xy = np.concatenate(parts, axis=0) if len(parts) > 1 \
            else parts[0]
        n = len(xy)
        key = (getattr(system, "name", type(system).__name__),
               repr(getattr(system, "conf", None)), res, pow2_bucket(n))
        bytes_in, bytes_out = _device_bytes(system, n)
        tok = memwatch.register(f"{KERNEL_NAME}/staged",
                                bytes_in + bytes_out,
                                devices=(device_key(mc.device),))
        try:
            launch_t = time.perf_counter()
            cells, _ = system.point_to_cell_device(xy, res, mc.device)
            launch_s = time.perf_counter() - launch_t
        finally:
            memwatch.release(tok)
        from ..obs.profiler import ledger
        ledger.observe(KERNEL_NAME, key, launch_s, rows=n)
        if metrics.enabled:
            metrics.count("serve/batches")
            metrics.count("serve/batched_queries", float(len(members)))
    except BaseException as exc:
        for m, t in zip(members, tickets):
            _complete(t, outcome="error", error=exc)
            m.resolve(500, {"error": f"{type(exc).__name__}: {exc}"},
                      "error")
        if metrics.enabled:
            metrics.count("serve/errors")
        return
    # split: per-member result slice + per-member cost share
    wall_ms = (time.perf_counter() - t0) * 1e3
    off = 0
    for m, t, rows in zip(members, tickets, rows_list):
        part = cells[off:off + rows]
        off += rows
        if t is not None:
            share = rows / max(1, n)
            t.device_s += launch_s * share
            t.h2d_bytes += int(bytes_in * share)
            t.d2h_bytes += int(bytes_out * share)
            t.rows_in = rows
            t.rows = rows
        if m.cancel_reason is not None or \
                (t is not None and t.cancel_requested):
            reason = m.cancel_reason or t._cancel_reason or "cancel"
            outcome = "deadline" if reason == "deadline" \
                else "cancelled"
            _complete(t, outcome=outcome, wall_ms=wall_ms)
            m.resolve(499 if outcome == "cancelled" else 504,
                      {"error": outcome}, outcome)
            continue
        table = session.table(m.lookup.table)
        cols = {}
        for name, src in m.lookup.outputs:
            cols[name] = part if src is None else table.columns[src]
        _complete(t, outcome="ok", wall_ms=wall_ms)
        m.resolve(200, Table(cols), "ok")
