"""Columnar SQL engine over the registered function surface.

Port of ``mosaic_tpu.sql.engine`` (reference: sql/extensions/
MosaicSQL.scala:21-47 exposes every registered expression to Spark SQL).
The Quickstart notebook's PIP join is written in exactly the query shapes
this engine executes:

    points  = SELECT *, grid_pointascellid(geom, 9) AS cell FROM trips
    chips   = SELECT zone_id, grid_tessellateexplode(geom, 9) FROM zones
    joined  = SELECT ... FROM points JOIN chips ON points.cell = chips.index_id
              WHERE is_core OR st_contains(wkb, geom)

Tables are dicts of equal-length columns; a column is a numpy array, a
``GeometryArray``, or a python list (e.g. WKB bytes).  Function calls
dispatch by name through the port's ``MosaicContext.call``, on the
context's device: on CUDA ``grid_pointascellid`` runs K3,
``grid_tessellateexplode`` K3's sampling, K7 and K8, points'
``st_contains`` K12 and ``st_area`` K11.  An eligible filter and
projection or aggregate run as one launch of the fused-group kernel K14
(``perf/fusion.py``, ``ops/fused_group.py``); everything else is host
numpy, as in the JAX package, whose names, behaviour, EXPLAIN columns,
conf keys and host-plane sites (tickets, accounting, the slow-query
dump, ``SET``) this module keeps.

Execution order: FROM/JOIN (inner or LEFT OUTER) -> explode generator
(if any select item is a generator call) -> WHERE -> GROUP BY/aggregate
(+ HAVING over the groups) -> projection -> ORDER BY -> LIMIT.  WHERE
runs after the explode so filters can reference the generated
``is_core``/``index_id``/``wkb`` columns, matching how the reference's
users filter tessellations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.geometry.array import GeometryArray
from ..obs import metrics, new_trace, recorder, tracer
from ..obs.devicemon import devicemon, format_device_ms
from .parser import (Binary, Call, Column, Literal, Query, SelectItem,
                     Star, TableRef, Unary, parse)
from .planner import planner

GENERATORS = {"grid_tessellateexplode", "mosaic_explode",
              "grid_cellkringexplode", "grid_cellkloopexplode",
              "grid_geometrykringexplode", "grid_geometrykloopexplode"}

AGGREGATES = {"count", "sum", "avg", "mean", "min", "max", "first"}


class SQLError(ValueError):
    pass


# ------------------------------------------------------------- columns

def col_len(col) -> int:
    return len(col)


def col_take_nullable(col, idx: np.ndarray):
    """col_take where idx -1 means NULL (the LEFT JOIN emission).

    FLOAT arrays host nulls as NaN; integer columns switch to python
    lists with None (a float cast would corrupt int64 cell ids above
    2^53); geometry columns cannot hold a null row — selecting one
    through an outer join raises rather than emitting a broken
    column."""
    idx = np.asarray(idx, np.int64)
    if -1 not in idx:
        return col_take(col, idx)
    if isinstance(col, GeometryArray):
        raise SQLError(
            "LEFT JOIN produced NULL geometry rows; geometry columns "
            "have no null slot — select the right side's non-geometry "
            "columns, or filter to matched rows first")
    if isinstance(col, np.ndarray) and \
            np.issubdtype(col.dtype, np.floating) and len(col):
        out = col.astype(np.float64)[np.maximum(idx, 0)]
        out[idx < 0] = np.nan
        return out
    return [None if (i < 0 or len(col) == 0) else col[int(i)]
            for i in idx]


def col_take(col, idx: np.ndarray):
    if isinstance(col, GeometryArray):
        return col.take(idx)
    if isinstance(col, np.ndarray):
        return col[idx]
    return [col[int(i)] for i in idx]


def _as_mask(col, n: int) -> np.ndarray:
    m = np.asarray(col)
    if m.shape == ():
        m = np.full(n, bool(m))
    return m.astype(bool)


class Table:
    """Ordered named columns of equal length."""

    def __init__(self, columns: Dict[str, object]):
        self.columns = dict(columns)
        lens = {col_len(c) for c in self.columns.values()}
        if len(lens) > 1:
            raise SQLError(f"ragged columns: "
                           f"{ {k: col_len(v) for k, v in columns.items()} }")
        self._n = lens.pop() if lens else 0

    def __len__(self) -> int:
        return self._n

    def column(self, name: str):
        if name not in self.columns:
            raise SQLError(f"no column {name!r}; have "
                           f"{list(self.columns)}")
        return self.columns[name]

    def take(self, idx: np.ndarray) -> "Table":
        return Table({k: col_take(v, idx) for k, v in self.columns.items()})

    def head(self, n: int) -> "Table":
        return self.take(np.arange(min(n, self._n)))

    def to_dict(self) -> Dict[str, object]:
        return dict(self.columns)

    def __repr__(self) -> str:
        return (f"Table[{self._n} rows x {len(self.columns)} cols: "
                f"{list(self.columns)}]")


# ---------------------------------------------------------- evaluation

class _Env:
    """Column resolution over one or two (joined) tables."""

    def __init__(self, tables: Dict[str, Table]):
        self.tables = tables            # qualifier -> Table

    def resolve(self, name: str, qualifier: Optional[str]):
        if qualifier is not None:
            if qualifier not in self.tables:
                raise SQLError(f"unknown table qualifier {qualifier!r}")
            return self.tables[qualifier].column(name)
        hits = [(q, t) for q, t in self.tables.items()
                if name in t.columns]
        if not hits:
            raise SQLError(f"no column {name!r} in "
                           f"{[list(t.columns) for t in self.tables.values()]}")
        if len({id(t) for _, t in hits}) > 1:
            raise SQLError(f"ambiguous column {name!r} "
                           f"(in {[q for q, _ in hits]})")
        return hits[0][1].column(name)


def _numeric(x):
    if isinstance(x, list):
        return np.asarray(x)
    return x


def _vectorized_equi_join(lk: np.ndarray, rk: np.ndarray):
    """Sort-based single-key equi-join emitting the exact pair order
    of the dict-loop: left ascending, right index-ascending within
    each key (stable argsort preserves insertion order of dups)."""
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    starts = np.searchsorted(rs, lk, "left")
    counts = np.searchsorted(rs, lk, "right") - starts
    total = int(counts.sum())
    li = np.repeat(np.arange(len(lk), dtype=np.int64), counts)
    offs = np.repeat(np.cumsum(counts) - counts, counts)
    out = np.arange(total, dtype=np.int64) - offs + \
        np.repeat(starts, counts)
    return li, order[out].astype(np.int64)


class SQLSession:
    """Named tables + query execution (reference: the SparkSession the
    MosaicSQL extension installs into)."""

    def __init__(self, context=None):
        from ..functions.context import MosaicContext
        self.mc = context or MosaicContext.context()
        self._tables: Dict[str, Table] = {}
        # out-of-core chip stores registered as scannable tables
        # (mosaic_tpu/store/): a store scan prunes partitions against
        # the WHERE clause's bbox before reading a data byte
        self._stores: Dict[str, object] = {}
        # Accounting identity: queries from this session are metered
        # under this principal; None falls back to the
        # ``mosaic.principal`` conf, then "anonymous" (obs/accounting).
        self.principal: Optional[str] = None

    # -- catalog
    def create_table(self, name: str, columns: Dict[str, object]) -> Table:
        t = Table(columns)
        self._tables[name.lower()] = t
        return t

    def table(self, name: str) -> Table:
        key = name.lower()
        if key not in self._tables:
            raise SQLError(f"unknown table {name!r}")
        return self._tables[key]

    def drop_table(self, name: str) -> None:
        self._tables.pop(name.lower(), None)

    def register_store(self, name: str, store) -> None:
        """Register a chip store (a path or an opened
        :class:`~..store.reader.ChipStore`) as a scannable table.
        Scans of it push the WHERE clause's bbox down into partition
        pruning (EXPLAIN's ``partitions`` column shows scanned/total);
        only the surviving partitions' rows materialize, in store
        order.  An in-memory table of the same name shadows the
        store."""
        if isinstance(store, str):
            from ..store.reader import ChipStore
            store = ChipStore(store)
        self._stores[name.lower()] = store

    def drop_store(self, name: str) -> None:
        self._stores.pop(name.lower(), None)

    def _store_for(self, name: str):
        """The store a table reference resolves to, or None (in-memory
        tables shadow stores of the same name)."""
        key = name.lower()
        if key in self._tables:
            return None
        return self._stores.get(key)

    def _store_scan(self, name: str, where) -> Table:
        """Materialize a store scan: bbox pushdown from the WHERE
        clause -> partition pruning -> read only the survivors.  The
        WHERE still runs over the scanned rows downstream, so pruning
        only has to be conservative, never exact."""
        from ..store.pushdown import bbox_from_where
        store = self._stores[name.lower()]
        bbox = bbox_from_where(where, *store.point_cols)
        return Table(store.read_columns(bbox=bbox))

    # -- query entry
    def sql(self, query: str) -> Table:
        """Run a query.  ``EXPLAIN ANALYZE SELECT ...`` executes the
        query and returns the per-operator profile instead of the
        result (operator, detail, rows out, wall ms); bare ``EXPLAIN``
        returns the plan without executing.  ``SET mosaic.key = value``
        updates the session-default :class:`MosaicConfig` through the
        validated conf path (reference: ``spark.conf.set`` on the
        mosaic.* namespace) and returns the applied pair.

        Every call runs under a fresh :class:`TraceContext` (the
        Spark-UI "one timeline per SQL execution" analogue): operator
        stages become child spans of an ``sql/query`` root span, keyed
        by the query's trace id in ``tracer.report()["traces"]`` and
        the Chrome-trace export.  Queries slower than
        ``mosaic.obs.slow.query.ms`` (when > 0) trigger an automatic
        flight-recorder dump.

        SLO feed: every call bumps ``sql/queries``; unexpected
        failures (not :class:`SQLError` — user mistakes are the
        client's fault, not the service's) bump ``sql/errors``; wall
        time lands as a ``sql/query_ms`` time-series point so the
        ``sql_latency`` burn-rate objective sees true per-query
        latency (``obs.slo``).  The ``sql.query`` fault site injects
        deterministic stalls for alert drills.

        Accounting: the call registers a ticket in the in-flight
        registry (``obs.inflight``) under ``session.principal`` /
        ``mosaic.principal`` for its whole lifetime — visible in the
        dashboard's ``/api/queries``, cancellable via
        ``inflight.cancel(query_id)`` or the console, subject to
        ``mosaic.query.deadline.ms``.  Cancellation is cooperative:
        :class:`~..obs.inflight.QueryCancelled` rises from the next
        operator boundary (or streamed-chunk boundary) and completes
        the ticket with a *partial* cost record in the audit log
        (outcome ``cancelled`` / ``deadline`` — never ``sql/errors``,
        which stays reserved for unexpected service faults)."""
        from ..resilience import faults as _faults
        from .. import config as _config
        from ..obs.inflight import QueryCancelled, checkpoint, inflight
        from ..obs import accounting as _accounting
        label = " ".join(query.split())[:60]
        cfg = _config.default_config()
        t0 = time.perf_counter()
        with new_trace(f"sql:{label}") as ctx:
            ticket = inflight.register(
                label,
                principal=self.principal or cfg.principal or "anonymous",
                deadline_ms=cfg.query_deadline_ms)
            outcome: str = "ok"
            err: Optional[BaseException] = None
            try:
                recorder.record("sql", query=label)
                _faults.stall("sql.query")
                metrics.count("sql/queries")
                # a cancel/deadline that landed during the stall (or
                # before any operator ran) surfaces here
                checkpoint("sql")
                with tracer.span("sql/query"):
                    out = self._sql_impl(query)
            except QueryCancelled as e:
                outcome, err = e.outcome, e
                raise               # operator action: not an SLO fault
            except SQLError as e:
                outcome, err = "error", e
                raise               # client error: not an SLO fault
            except Exception as e:
                outcome, err = "error", e
                metrics.count("sql/errors")
                raise
            finally:
                _accounting.complete(
                    ticket, outcome=outcome, error=err,
                    wall_ms=(time.perf_counter() - t0) * 1e3)
        dt_ms = (time.perf_counter() - t0) * 1e3
        if metrics.enabled:
            from ..obs.timeseries import timeseries
            timeseries.record("sql/query_ms", dt_ms)
        from .. import config as _config
        threshold = _config.default_config().obs_slow_query_ms
        if threshold and dt_ms > threshold:
            recorder.record("slow_query", query=label,
                            ms=round(dt_ms, 3), threshold_ms=threshold,
                            trace=ctx.trace_id)
            # throttled: at most one auto-dump per
            # mosaic.obs.dump.cooldown.ms across slow queries AND SLO
            # breaches — a sustained slow workload is otherwise a dump
            # storm.  The bundle embeds the profiler snapshot (host
            # stacks + kernel ledger), so a slow query leaves a
            # profile, not just a mark.
            try:
                recorder.dump_throttled(reason="slow_query")
            except OSError:
                pass
        return out

    def _sql_impl(self, query: str) -> Table:
        import re as _re
        m = _re.match(r"\s*SET\s+([A-Za-z][\w.]*)\s*=\s*(.+?)\s*;?\s*$",
                      query, _re.IGNORECASE)
        if m:
            key, raw = m.group(1), m.group(2)
            value = raw.strip("'\"")
            from .. import config as _config
            try:
                cfg = _config.apply_conf(
                    _config.default_config(), key, value)
            except _config.ConfigError as e:
                raise SQLError(str(e)) from e
            _config.set_default_config(cfg)
            return Table({"key": [key], "value": [value]})
        q = parse(query)
        if q.explain == "plan":
            ops = self._plan_ops(q)
            # strategy column: the planner's chosen path + why per
            # operator ("-" when the planner is off or has no choice);
            # fused column: the fusion group id each operator compiles
            # into ("-" = dispatches alone — see perf/fusion.py)
            plan = planner.plan_query(q, self) if planner.enabled \
                else None
            fplan = plan.fusion if plan is not None else None

            def _est_bytes(o: str) -> int:
                s = plan.steps.get(o) if plan is not None else None
                return s.est_bytes if s is not None else -1

            def _partitions(o: str) -> str:
                # store scans show the bbox pushdown's pruning as
                # "scanned/total" — computed from the manifest alone
                # (EXPLAIN moves no data bytes); "-" everywhere else
                store = self._store_for(q.table.name) \
                    if o == "scan" and q.join is None else None
                if store is None:
                    return "-"
                from ..store.pushdown import bbox_from_where
                bbox = bbox_from_where(q.where, *store.point_cols)
                scanned = len(store.prune(bbox, record=False))
                return f"{scanned}/{len(store.partitions)}"
            # est_bytes: the planner's byte pre-pass (cardinality x
            # source row width; -1 = no estimate) — what the memory
            # budget's admission check reads; refine: the adaptive
            # PIP-refinement pick per operator — static plans have
            # none (the decision needs the first batch's selectivity
            # probe), so the column is "-" until EXPLAIN ANALYZE
            return Table({"operator": [o for o, _ in ops],
                          "detail": [d for _, d in ops],
                          "strategy": [plan.label(o) if plan is not None
                                       else "-" for o, _ in ops],
                          "est_bytes": np.asarray(
                              [_est_bytes(o) for o, _ in ops],
                              np.int64),
                          "partitions": [_partitions(o)
                                         for o, _ in ops],
                          "refine": ["-" for _ in ops],
                          "fused": [fplan.gid_for(o) if fplan is not None
                                    else "-" for o, _ in ops]})
        if q.explain == "analyze":
            prof: List[tuple] = []
            self._execute(q, prof)
            # refine column: the per-call refinement summaries the
            # adaptive join noted on this query's ticket (levels used /
            # cells refined / cells flat), attributed to the operator
            # the ticket was in when each refined join ran; summaries
            # noted outside any operator stage roll up on the first
            # (scan/join) row.  The ticket is still open here — it
            # completes in sql()'s finally, after this table is built.
            from ..obs.context import current_trace_id
            from ..obs.inflight import inflight as _inflight
            tkt = _inflight.ticket_for_trace(current_trace_id())
            rops = list(tkt.refine_ops) if tkt is not None else []
            prof_ops = {p[0] for p in prof}

            def _refine_for(i: int, op: str) -> str:
                hits = [s for o, s in rops if o == op]
                if i == 0:
                    hits += [s for o, s in rops if o not in prof_ops]
                return "; ".join(hits) if hits else "-"
            # all_to_all_bytes / shard_skew attribute the sharded
            # exchange (parallel/overlay collective accounting) to the
            # operator row that moved the bytes — zero rows mean the
            # operator never left one device; est_rows is the planner's
            # pre-pass cardinality estimate (-1 = no estimate), placed
            # next to actual rows so mispredicts read off per operator;
            # device_ms is the per-device wall-time split the device
            # monitor attributed while the stage ran ("-" when the
            # operator never touched a process group — see obs.devicemon);
            # fused marks the operators a fusion group executed as one
            # K14 launch — the group's device/wall time rolls up on
            # its FIRST member's row, later members just unpack;
            # peak_bytes is the device-memory ledger's per-trace
            # allocation delta while the stage ran (obs.memwatch —
            # registered + transient bytes, 0 when the ledger is off)
            return Table({"operator": [p[0] for p in prof],
                          "detail": [p[1] for p in prof],
                          "rows": np.asarray([p[2] for p in prof],
                                             np.int64),
                          "est_rows": np.asarray([p[6] for p in prof],
                                                 np.int64),
                          "time_ms": np.asarray([p[3] * 1e3
                                                 for p in prof]),
                          "all_to_all_bytes": np.asarray(
                              [p[4] for p in prof], np.int64),
                          "shard_skew": np.asarray(
                              [p[5] for p in prof]),
                          "device_ms": [p[7] for p in prof],
                          "refine": [_refine_for(i, p[0])
                                     for i, p in enumerate(prof)],
                          "fused": [p[8] for p in prof],
                          "peak_bytes": np.asarray(
                              [p[9] for p in prof], np.int64)})
        return self._execute(q, None)

    def _plan_ops(self, q: Query) -> List[tuple]:
        """Static operator list in execution order (EXPLAIN output)."""
        ops = []
        if q.join is not None:
            ops.append((f"{q.join_kind}_join",
                        f"{q.table.name} ⋈ {q.join.name}"))
        else:
            ops.append(("scan", q.table.name))
        gens = [it.expr.name for it in q.items
                if isinstance(it.expr, Call) and
                it.expr.name in GENERATORS]
        if gens:
            ops.append(("generate", gens[0]))
        if q.where is not None:
            ops.append(("filter", "WHERE"))
        if q.group_by is not None or self._has_aggregate(q.items):
            ops.append(("aggregate",
                        f"{len(q.group_by or [])} group keys"))
        else:
            ops.append(("project", f"{len(q.items)} items"))
        if q.order_by:
            ops.append(("order", f"{len(q.order_by)} keys"))
        if q.limit is not None:
            ops.append(("limit", str(q.limit)))
        return ops

    #: skew-gauge sites the profiler checks when a stage moved
    #: all_to_all bytes (parallel/{overlay,pip_join} accounting)
    _SKEW_SITES = ("overlay", "overlay_pairs", "pip_join")

    def _execute(self, q: Query, prof: Optional[List[tuple]]) -> Table:
        # cost-based pre-pass: per-operator cardinality estimates +
        # strategy picks.  _equi_join reads the join decision off the
        # plan; every stage below closes its estimate so the planner's
        # coefficient store learns from this run (sql/planner.py)
        plan = planner.plan_query(q, self) if planner.enabled else None
        self._active_plan = plan
        from ..obs.inflight import (checkpoint as _checkpoint,
                                    note_rows as _note_rows,
                                    note_rows_in as _note_rows_in,
                                    note_strategies as _note_strategies)
        from ..obs.memwatch import mem_budget as _mem_budget, \
            memwatch as _memwatch
        if plan is not None:
            # advisory admission check against the planner's byte
            # pre-pass: a denial is counted + flight-recorded (the
            # admission-control arc's ground truth) but the query
            # still runs — the stream degrades via chunk shrink
            # instead of dying at the gate
            _mem_budget.admit(plan.est_bytes_peak())
        if plan is not None:
            # strategy picks land on the active ticket here (not read
            # off self._active_plan at completion — that attribute is
            # racy under concurrent sessions; the ticket is trace-local)
            _note_strategies(
                {op: plan.label(op) for op in plan.steps})

        # fusion: the planner's pre-pass may have stitched adjacent
        # eligible operators into one K14 program (perf/fusion.py).
        # The group runs inside its FIRST member's stage; later member
        # stages just unpack the cached FusedResult.  A runtime
        # bailout (dtype drift, sum bound, empty input) latches
        # "bailed" and every member falls back to the unfused path —
        # results stay bit-for-bit identical either way.  A K14 build
        # or launch error is not a bailout: it raises.
        fplan = plan.fusion if plan is not None else None
        fstate = {"res": None, "bailed": False}

        def _try_group(g, genv):
            from ..perf import fusion as _fusion
            try:
                fstate["res"] = _fusion.execute_group(g, q, genv, self)
                return fstate["res"]
            except _fusion.FusionBailout as e:
                fstate["bailed"] = True
                if metrics.enabled:
                    metrics.count("fusion/bailouts")
                recorder.record("fusion_bailout", group=g.gid,
                                reason=str(e))
                return None

        def _fused_gid(op: str) -> str:
            if fplan is None or fstate["res"] is None:
                return "-"
            return fplan.gid_for(op)

        def stage(op: str, detail: str, fn, rows_of, fused_of=None):
            # operator boundary: the cooperative cancellation probe —
            # a cancel()/expired deadline raises QueryCancelled before
            # the next operator starts, never mid-kernel
            _checkpoint(op)
            # nested under the sql/query root span -> qualified as
            # sql/query/<op>, a child in the query's trace tree
            a2a0 = metrics.counter_value("collective/all_to_all_bytes")
            dev0 = devicemon.busy_by_device() if prof is not None \
                else None
            mem0 = _memwatch.current_trace_alloc_bytes() \
                if prof is not None else 0
            with tracer.span(op):
                t0 = time.perf_counter()
                res = fn()
                dt = time.perf_counter() - t0
            rows = rows_of(res)
            _note_rows(rows)
            if op == "scan" or op.endswith("_join"):
                _note_rows_in(rows)
            gid = fused_of() if fused_of is not None else "-"
            step = plan.steps.get(op) if plan is not None else None
            if step is not None:
                if gid != "-":
                    # the stage ran inside a fusion group: its wall
                    # time belongs to the group's fusion/<opset> cost
                    # key (fed by execute_group), so only close the
                    # cardinality side here — feeding dt to the member
                    # op would poison the unfused coefficient the
                    # fusion gate compares against
                    planner.observe_ratio(step.op, step.key_n, rows)
                    planner.observe_estimate(step.op, step.est_rows,
                                             rows)
                else:
                    planner.observe_step(step, rows, dt)
            if prof is not None:
                # bytes this stage pushed through sharded exchanges;
                # when nonzero, the current shard/skew/* gauges were
                # (re)written by those exchanges, so snapshot the worst
                a2a = metrics.counter_value(
                    "collective/all_to_all_bytes") - a2a0
                skew = max((metrics.gauge_value(f"shard/skew/{s}")
                            or 0.0)
                           for s in self._SKEW_SITES) if a2a else 0.0
                # per-device wall-time split attributed while this
                # stage ran (sharded ops feed obs.devicemon by load
                # share) — the EXPLAIN ANALYZE device_ms column
                dev1 = devicemon.busy_by_device()
                delta = {k: v - (dev0.get(k, 0.0) if dev0 else 0.0)
                         for k, v in dev1.items()}
                # device bytes this stage allocated (registered +
                # transient) under the query's trace — the EXPLAIN
                # ANALYZE peak_bytes column; the per-trace allocation
                # total is monotone, so the diff is stage-local
                mem1 = _memwatch.current_trace_alloc_bytes()
                prof.append((op, detail, rows, dt, int(a2a),
                             float(skew),
                             step.est_rows if step is not None else -1,
                             format_device_ms(delta), gid,
                             max(0, int(mem1 - mem0))))
            if metrics.enabled:
                metrics.observe(f"sql/{op}_s", dt)
            return res

        if q.join is not None:
            base_env = stage(f"{q.join_kind}_join",
                             f"{q.table.name} ⋈ {q.join.name}",
                             lambda: self._from_clause(q),
                             self._env_len)
        else:
            base_env = stage("scan", q.table.name,
                             lambda: self._from_clause(q),
                             self._env_len)
        # explode generators before WHERE so filters see generated cols
        env, gen_items = stage(
            "generate",
            next((it.expr.name for it in q.items
                  if isinstance(it.expr, Call) and
                  it.expr.name in GENERATORS), "-"),
            lambda: self._apply_generators(q, base_env),
            lambda r: self._env_len(r[0]))
        if not gen_items and prof is not None:
            prof.pop()            # no generator ran; drop the stub row
        if q.where is not None:
            g_f = fplan.group_with("filter") if fplan is not None \
                else None

            def _filter():
                if g_f is not None and not fstate["bailed"]:
                    r = _try_group(g_f, env)
                    if r is not None:
                        # terminal output already computed on device;
                        # the filtered env is only materialised when a
                        # later stage still needs per-row host columns
                        # (ORDER BY against a projected query)
                        if g_f.terminal == "project" and q.order_by:
                            return self._take_env(
                                env, np.flatnonzero(r.mask))
                        return env
                n = self._env_len(env)
                mask = _as_mask(self._eval(q.where, env), n)
                return self._take_env(env, np.flatnonzero(mask))

            def _filter_rows(renv):
                r = fstate["res"]
                return r.rows_filter if r is not None \
                    else self._env_len(renv)

            env = stage("filter", "WHERE", _filter, _filter_rows,
                        fused_of=lambda: _fused_gid("filter"))
        if q.group_by is not None or self._has_aggregate(q.items):
            g_a = fplan.group_with("aggregate") if fplan is not None \
                else None

            def _agg():
                r = fstate["res"]
                if r is None and g_a is not None and \
                        not fstate["bailed"]:
                    # [aggregate]-only group (WHERE absent or unfused):
                    # runs here against the already-filtered env
                    r = _try_group(g_a, env)
                return r.out if r is not None \
                    else self._aggregate(q, env, gen_items)

            out = stage("aggregate",
                        f"{len(q.group_by or [])} group keys",
                        _agg, len,
                        fused_of=lambda: _fused_gid("aggregate"))
        else:
            def _proj():
                r = fstate["res"]
                return r.out if r is not None \
                    else self._project(q.items, env, gen_items)

            out = stage("project", f"{len(q.items)} items", _proj, len,
                        fused_of=lambda: _fused_gid("project"))
        if q.order_by:
            def _order():
                grouped = q.group_by is not None or \
                    self._has_aggregate(q.items)
                keys = []
                for e, desc in reversed(q.order_by):
                    try:
                        v = self._eval(e, _Env({"_t": out}))
                    except SQLError:
                        if grouped:
                            raise  # pre-aggregation rows no longer exist
                        # non-projected or qualified column: evaluate
                        # against the pre-projection env (same row count
                        # and order as the projected output)
                        v = self._eval(e, env)
                    k = np.asarray(_numeric(v))
                    if not np.issubdtype(k.dtype, np.number):
                        # rank-encode so lexsort and DESC negation apply
                        _, k = np.unique(k, return_inverse=True)
                    keys.append(-k if desc else k)
                idx = np.lexsort(keys)
                return out.take(idx)
            out = stage("order", f"{len(q.order_by)} keys", _order, len)
        if q.limit is not None:
            out = stage("limit", str(q.limit),
                        lambda: out.head(q.limit), len)
        return out

    # -- FROM / JOIN
    def _scan_source(self, ref: TableRef, where) -> Table:
        """One FROM side: in-memory table, or a registered chip store
        scan.  ``where`` enables bbox pushdown — passed only for the
        single-table scan (a join's WHERE filters post-join rows, so
        pushing it into a side is not generally sound; joined store
        sides full-scan)."""
        if self._store_for(ref.name) is not None:
            return self._store_scan(ref.name, where)
        return self.table(ref.name)

    def _from_clause(self, q: Query) -> _Env:
        left = self._scan_source(q.table,
                                 q.where if q.join is None else None)
        lq = (q.table.alias or q.table.name).lower()
        if q.join is None:
            return _Env({lq: left})
        right = self._scan_source(q.join, None)
        rq = (q.join.alias or q.join.name).lower()
        if lq == rq:
            raise SQLError(f"self-join needs distinct aliases "
                           f"(both sides are {lq!r})")
        li, ri = self._equi_join(left, lq, right, rq, q.join_on)
        if q.join_kind == "left":
            # unmatched left rows survive with nulls on the right
            matched = np.zeros(len(left), bool)
            matched[li] = True
            lost = np.nonzero(~matched)[0]
            li = np.concatenate([li, lost])
            ri = np.concatenate([ri, np.full(len(lost), -1, np.int64)])
            order = np.argsort(li, kind="stable")
            li, ri = li[order], ri[order]
            jl = left.take(li)
            jr = Table({name: col_take_nullable(col, ri)
                        for name, col in right.columns.items()})
            return _Env({lq: jl, rq: jr})
        jl, jr = left.take(li), right.take(ri)
        return _Env({lq: jl, rq: jr})

    def _equi_join(self, left, lq, right, rq, on):
        """Hash join on a conjunction of equality predicates."""
        conjuncts: List = []

        def flat(e):
            if isinstance(e, Binary) and e.op == "and":
                flat(e.left)
                flat(e.right)
            else:
                conjuncts.append(e)

        flat(on)
        lkeys, rkeys = [], []
        for c in conjuncts:
            if not (isinstance(c, Binary) and c.op == "="):
                raise SQLError("JOIN ON supports conjunctions of "
                               "equalities only")
            le, re = c.left, c.right
            lv = self._try_eval(le, _Env({lq: left}))
            if lv is None:                 # sides written right = left
                le, re = re, le
                lv = self._try_eval(le, _Env({lq: left}))
            rv = self._try_eval(re, _Env({rq: right}))
            if lv is None or rv is None:
                raise SQLError("each JOIN equality must reference one "
                               "table per side")
            lkeys.append(np.asarray(_numeric(lv)))
            rkeys.append(np.asarray(_numeric(rv)))
        # planner strategy: dict-loop (low fixed cost) vs. vectorized
        # sort-join (wins past a few thousand rows).  Both emit pairs
        # left-ascending with right rows index-ascending within each
        # key, so the choice is invisible in the result.  The decision
        # usually rides in on the query plan; direct _equi_join calls
        # decide here.
        d = None
        if getattr(self, "_active_plan", None) is not None:
            js = next((s for s in self._active_plan.steps.values()
                       if s.op.endswith("_join")), None)
            d = getattr(js, "decision", None)
        if d is None and planner.enabled:
            d = planner.decide_equi_join(len(left), len(right))
        use_vec = (d is not None and d.strategy == "vectorized" and
                   self._vector_join_ok(lkeys, rkeys))
        t0 = time.perf_counter()
        if use_vec:
            li, ri = _vectorized_equi_join(lkeys[0], rkeys[0])
        else:
            # composite key -> dict of right-row lists
            rmap: Dict[object, List[int]] = {}
            for j in range(len(right)):
                k = tuple(rk[j] for rk in rkeys)
                rmap.setdefault(k, []).append(j)
            li, ri = [], []
            for i in range(len(left)):
                k = tuple(lk[i] for lk in lkeys)
                for j in rmap.get(k, ()):
                    li.append(i)
                    ri.append(j)
            li = np.asarray(li, np.int64)
            ri = np.asarray(ri, np.int64)
        if d is not None:
            # feed the coefficient of the path that actually ran (a
            # vectorized pick can fall back on ineligible keys)
            key = d.cost_key if use_vec or d.strategy != "vectorized" \
                else "equi_join/loop"
            planner.observe_op(key, d.key_n,
                               time.perf_counter() - t0,
                               rows_out=int(len(li)))
        return li, ri

    @staticmethod
    def _vector_join_ok(lkeys, rkeys) -> bool:
        """The sort-join handles exactly the cases where its equality
        semantics match the dict loop: one key pair, same non-object
        dtype, and no NaN keys (NaN never equals itself in the dict
        but searchsorted would pair NaNs)."""
        if len(lkeys) != 1:
            return False
        lk, rk = lkeys[0], rkeys[0]
        if lk.dtype != rk.dtype or lk.dtype.kind not in "iufSU":
            return False
        if lk.dtype.kind == "f" and (np.isnan(lk).any() or
                                     np.isnan(rk).any()):
            return False
        return True

    @staticmethod
    def _take_env(env: "_Env", idx: np.ndarray) -> "_Env":
        return _Env({qn: t.take(idx) for qn, t in env.tables.items()})

    def _try_eval(self, e, env):
        try:
            return self._eval(e, env)
        except SQLError:
            return None

    # -- generators (explode)
    def _apply_generators(self, q: Query, env: _Env):
        gens = [it for it in q.items
                if isinstance(it.expr, Call) and it.expr.name in GENERATORS]
        if not gens:
            return env, {}
        if len(gens) > 1:
            raise SQLError("only one generator per SELECT "
                           "(reference: Spark's Generate operator)")
        it = gens[0]
        call = it.expr
        args = [self._eval(a, env) for a in call.args]
        name = call.name
        if name in ("grid_tessellateexplode", "mosaic_explode"):
            chips = self.mc.call(name, *args)
            src = chips.geom_id
            gcols = {"is_core": chips.is_core.copy(),
                     "index_id": chips.cell_id.copy(),
                     "wkb": chips.geoms}
        else:
            src, cells = self.mc.call(name, *args)
            gcols = {(it.alias or "cellid"): cells}
        src = np.asarray(src, np.int64)
        env2 = _Env({qn: t.take(src) for qn, t in env.tables.items()})
        gtab = Table(gcols)
        env2.tables["#gen"] = gtab
        return env2, {id(call): gtab}

    # -- aggregation
    def _has_aggregate(self, items: Sequence[SelectItem]) -> bool:
        return any(isinstance(it.expr, Call) and
                   it.expr.name in AGGREGATES for it in items)

    def _aggregate(self, q: Query, env: _Env, gen_items) -> Table:
        n = self._env_len(env)
        if q.group_by:
            gkeys = [np.asarray(_numeric(self._eval(e, env)))
                     for e in q.group_by]
            key_rows = list(zip(*[k.tolist() for k in gkeys])) \
                if n else []
            seen: Dict[object, int] = {}
            gid = np.empty(n, np.int64)
            for i, k in enumerate(key_rows):
                gid[i] = seen.setdefault(k, len(seen))
            ngroups = len(seen)
            group_idx = [np.flatnonzero(gid == g) for g in range(ngroups)]
        else:
            group_idx = [np.arange(n)]
        if q.having is not None:
            self._having_group_by = q.group_by
            keep = _as_mask(self._eval_grouped(q.having, env,
                                               group_idx),
                            len(group_idx))
            group_idx = [g for g, k in zip(group_idx, keep) if k]
        cols: Dict[str, object] = {}
        for pos, it in enumerate(q.items):
            name = it.alias or self._default_name(it.expr, pos)
            e = it.expr
            if isinstance(e, Call) and e.name in AGGREGATES:
                cols[name] = self._agg_call(e, env, group_idx)
            else:
                # must be a constant or match a grouping expression —
                # silently taking any column's first row per group
                # masks user errors a real engine rejects (round-4
                # ADVICE).  Constants are legal alongside aggregates;
                # Column matches ignore the table qualifier (t.x
                # groups by x, like Spark's resolution).
                def _matches(a, b):
                    if a == b:
                        return True
                    return (isinstance(a, Column) and
                            isinstance(b, Column) and a.name == b.name)
                if not isinstance(e, Literal) and (
                        q.group_by is None or
                        not any(_matches(e, g) for g in q.group_by)):
                    raise SQLError(
                        f"non-aggregate SELECT item {name!r} must "
                        "appear in GROUP BY")
                vals = self._eval(e, env)
                firsts = np.asarray([g[0] for g in group_idx], np.int64)
                cols[name] = col_take(vals, firsts)
        return Table(cols)

    def _eval_grouped(self, e, env: _Env, group_idx):
        """Evaluate a HAVING expression to one value per group:
        aggregate calls run per group, other columns take each group's
        first row (they are grouping expressions)."""
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, Call) and e.name in AGGREGATES:
            return self._agg_call(e, env, group_idx)
        if isinstance(e, Column):
            # same discipline as grouped SELECT items: a bare column in
            # HAVING must be a grouping expression, or the result would
            # silently depend on each group's arbitrary first row
            if self._having_group_by is None or not any(
                    e == g or (isinstance(g, Column) and
                               g.name == e.name)
                    for g in self._having_group_by):
                raise SQLError(
                    f"HAVING column {e.name!r} must appear in GROUP BY")
            vals = self._eval(e, env)
            firsts = np.asarray([g[0] for g in group_idx], np.int64)
            return _numeric(col_take(vals, firsts))
        if isinstance(e, Unary):
            if e.op == "not":
                return ~_as_mask(self._eval_grouped(e.operand, env,
                                                    group_idx),
                                 len(group_idx))
            v = self._eval_grouped(e.operand, env, group_idx)
            if e.op == "-":
                return -np.asarray(_numeric(v))
            arr = np.asarray(_numeric(v), np.float64)
            isna = np.asarray([x is None or (isinstance(x, float) and
                                             np.isnan(x))
                               for x in np.asarray(v).tolist()]) \
                if not np.issubdtype(arr.dtype, np.number) else \
                np.isnan(arr)
            return isna if e.op == "isnull" else ~isna
        if isinstance(e, Binary):
            a = self._eval_grouped(e.left, env, group_idx)
            b = self._eval_grouped(e.right, env, group_idx)
            if e.op in ("and", "or"):
                a = _as_mask(a, len(group_idx))
                b = _as_mask(b, len(group_idx))
                return (a & b) if e.op == "and" else (a | b)
            import operator as op_
            fn = {"+": op_.add, "-": op_.sub, "*": op_.mul,
                  "/": op_.truediv, "%": op_.mod,
                  "=": op_.eq, "!=": op_.ne, "<": op_.lt,
                  "<=": op_.le, ">": op_.gt, ">=": op_.ge}[e.op]
            return fn(_numeric(a), _numeric(b))
        raise SQLError(f"unsupported HAVING expression {e!r}")

    def _agg_call(self, e: Call, env: _Env, group_idx):
        if e.name == "count":
            if len(e.args) == 0 or isinstance(e.args[0], Star):
                return np.asarray([len(g) for g in group_idx],
                                  np.int64)
            # SQL semantics: count(col) skips NULL/NaN rows
            vals = self._eval(e.args[0], env)
            lst = vals if isinstance(vals, list) else \
                np.asarray(vals).tolist()
            ok = np.asarray(
                [not (v is None or (isinstance(v, float) and
                                    np.isnan(v))) for v in lst])
            return np.asarray([int(ok[g].sum()) for g in group_idx],
                              np.int64)
        if len(e.args) != 1:
            raise SQLError(f"{e.name} takes one argument")
        raw = self._eval(e.args[0], env)
        lst = raw if isinstance(raw, list) else \
            np.asarray(raw).tolist()
        # SQL NULL semantics: aggregates skip NULL (None / NaN) rows;
        # an all-null group aggregates to NULL (NaN here)
        vals = np.asarray(
            [np.nan if v is None else float(v) for v in lst])
        ok = ~np.isnan(vals)
        fn = {"sum": np.sum, "avg": np.mean, "mean": np.mean,
              "min": np.min, "max": np.max,
              "first": lambda v: v[0]}[e.name]
        out = []
        for g in group_idx:
            sel = np.asarray(g)[ok[g]] if len(g) else np.empty(0,
                                                               int)
            out.append(fn(vals[sel]) if len(sel) else np.nan)
        return np.asarray(out)

    # -- projection
    def _project(self, items, env: _Env, gen_items) -> Table:
        cols: Dict[str, object] = {}
        for pos, it in enumerate(items):
            if isinstance(it.expr, Star):
                for qn, t in env.tables.items():
                    if qn == "#gen":
                        continue
                    for cname, c in t.columns.items():
                        cols[cname if cname not in cols
                             else f"{qn}.{cname}"] = c
                if "#gen" in env.tables:
                    cols.update(env.tables["#gen"].columns)
                continue
            if isinstance(it.expr, Call) and id(it.expr) in gen_items:
                # resolve from the env's '#gen' table — _take_env has
                # already applied WHERE to it; the gen_items snapshot
                # predates the filter and only identifies generator
                # calls (round-4 ADVICE: a WHERE that dropped rows made
                # the stale snapshot ragged vs the other columns)
                cols.update(env.tables["#gen"].columns)
                continue
            name = it.alias or self._default_name(it.expr, pos)
            cols[name] = self._eval(it.expr, env)
        return Table(cols)

    @staticmethod
    def _default_name(e, pos: int) -> str:
        if isinstance(e, Column):
            return e.name
        if isinstance(e, Call):
            return e.name
        return f"col{pos}"

    # -- expression evaluation
    def _env_len(self, env: _Env) -> int:
        for t in env.tables.values():
            return len(t)
        return 0

    def _eval(self, e, env: _Env):
        if isinstance(e, Literal):
            return e.value
        if isinstance(e, Column):
            return env.resolve(e.name, e.table)
        if isinstance(e, Unary):
            v = self._eval(e.operand, env)
            if e.op == "-":
                return -np.asarray(_numeric(v))
            if e.op == "not":
                return ~_as_mask(v, self._env_len(env))
            a = np.asarray(
                [x is None or (isinstance(x, float) and np.isnan(x))
                 for x in (v if isinstance(v, list) else
                           np.asarray(v).tolist())])
            return a if e.op == "isnull" else ~a
        if isinstance(e, Binary):
            n = self._env_len(env)
            if e.op in ("and", "or"):
                a = _as_mask(self._eval(e.left, env), n)
                b = _as_mask(self._eval(e.right, env), n)
                return (a & b) if e.op == "and" else (a | b)
            a = self._eval(e.left, env)
            b = self._eval(e.right, env)
            a, b = _numeric(a), _numeric(b)
            import operator as op_
            fn = {"+": op_.add, "-": op_.sub, "*": op_.mul,
                  "/": op_.truediv, "%": op_.mod,
                  "=": op_.eq, "!=": op_.ne, "<": op_.lt,
                  "<=": op_.le, ">": op_.gt, ">=": op_.ge}[e.op]
            return fn(a, b)
        if isinstance(e, Call):
            if e.name in GENERATORS:
                raise SQLError(f"{e.name} is a generator — use it as a "
                               "top-level SELECT item")
            if e.name in AGGREGATES:
                raise SQLError(f"{e.name} requires GROUP BY context")
            from ..functions.registry import REGISTRY
            if e.name not in REGISTRY:     # pre-dispatch check so real
                raise SQLError(            # function errors surface as-is
                    f"unknown function {e.name!r}")
            args = [self._eval(a, env) for a in e.args]
            return self.mc.call(e.name, *args)
        raise SQLError(f"cannot evaluate {e!r}")


# ---------------------------------------------- batchable point lookups

#: calls the serve-layer micro-batcher may coalesce across queries:
#: elementwise cell-id assignment over scalar coordinate columns — one
#: row in, one row out, no cross-row state — so concatenating several
#: queries' rows into one padded device launch returns bit-identical
#: per-row results (serve/batching.py executes; this module only
#: classifies, because the query shape is the engine's contract)
BATCHABLE_CALLS = {"grid_longlatascellid"}


@dataclasses.dataclass(frozen=True)
class BatchableLookup:
    """Classification of one micro-batchable point-lookup query.

    ``outputs`` preserves the SELECT-item order the engine would
    produce: ``(name, column)`` entries echo a source column through
    unchanged, the single ``(name, None)`` entry is the lookup call's
    cell-id result — so the batcher can assemble a result table
    column-for-column identical to :meth:`SQLSession.sql`."""

    table: str                       # catalog name (lowercased)
    func: str                        # the BATCHABLE_CALLS member
    res: int                         # the call's literal resolution
    lon: str                         # x/longitude column name
    lat: str                         # y/latitude column name
    outputs: Tuple[Tuple[str, Optional[str]], ...]
    rows: int                        # table length at classification

    @property
    def signature(self) -> tuple:
        """Queries with equal signatures may share one device launch
        (same kernel, same static args; rows just concatenate)."""
        return (self.func, self.res)


def classify_batchable(query: str, session: "SQLSession",
                       max_rows: int = 0) -> Optional[BatchableLookup]:
    """Decide whether ``query`` is a micro-batchable point lookup.

    The shape is deliberately narrow: a single-table ``SELECT`` whose
    items are plain columns plus exactly one :data:`BATCHABLE_CALLS`
    call over ``(numeric column, numeric column, integer literal)`` —
    no join, filter, generator, aggregate, ordering, or limit, and at
    most ``max_rows`` source rows (0 = unlimited).  Anything else
    returns None and runs the ordinary ``sql()`` path; classification
    must never raise on arbitrary input (the serve layer probes every
    admitted query with it)."""
    try:
        q = parse(query)
    except Exception:
        return None                  # not even parseable SELECT syntax
    if q.explain is not None or q.join is not None or \
            q.where is not None or q.group_by is not None or \
            q.having is not None or q.order_by or q.limit is not None:
        return None
    call: Optional[Call] = None
    outputs: List[Tuple[str, Optional[str]]] = []
    for pos, it in enumerate(q.items):
        e = it.expr
        if isinstance(e, Call):
            if call is not None or e.name not in BATCHABLE_CALLS:
                return None
            if len(e.args) != 3 or \
                    not isinstance(e.args[0], Column) or \
                    not isinstance(e.args[1], Column) or \
                    not isinstance(e.args[2], Literal) or \
                    not isinstance(e.args[2].value, int):
                return None
            call = e
            outputs.append((it.alias or e.name, None))
        elif isinstance(e, Column) and e.table is None:
            outputs.append((it.alias or e.name, e.name))
        else:
            return None              # Star / expression / qualified col
    if call is None:
        return None
    try:
        table = session.table(q.table.name)
    except SQLError:
        return None
    lon, lat = call.args[0].name, call.args[1].name
    for name in {lon, lat} | {c for _, c in outputs if c is not None}:
        if name not in table.columns:
            return None
    for name in (lon, lat):
        col = table.columns[name]
        if not isinstance(col, np.ndarray) or \
                not np.issubdtype(col.dtype, np.number):
            return None
    if max_rows and len(table) > max_rows:
        return None
    return BatchableLookup(table=q.table.name.lower(), func=call.name,
                           res=int(call.args[2].value), lon=lon,
                           lat=lat, outputs=tuple(outputs),
                           rows=len(table))
