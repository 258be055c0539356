"""Cost-based adaptive query planner.

Port of ``mosaic_tpu.sql.planner``: the cost model and every decision —
dict-loop vs. vectorized SQL equi-join (:meth:`Planner.decide_equi_join`),
brute vs. ring KNN (:meth:`Planner.decide_knn`), monolithic vs. streamed
(per chunk class) vs. sharded PIP join (:meth:`Planner.decide_pip_join`),
fused vs. unfused SQL operator groups (:meth:`Planner.decide_fusion`) and
the refined vs. flat PIP join (:meth:`Planner.decide_refine`) — and the
SQL pre-pass (:meth:`Planner.plan_query`): exact scan cardinalities from
the catalog, learned ratios downstream, a byte estimate per operator and
the fusion pass.  Each decision comes from a cheap pre-pass plus
**observed** per-(operator, pow2 size-class) cost coefficients; after a
run the observed wall time and rows feed back into the bounded EWMA
store (:meth:`Planner.observe_decision`, :meth:`Planner.observe_step`),
so a workload's second run is planned from measurement.

Every candidate of a decision gives the same answer bit for bit: the
planner changes where and how fast an answer is computed, never the
answer.  Escape hatches: ``mosaic.planner.enabled`` and
``mosaic.planner.force.<op>`` (``config.py``).

Every decision is a ``planner_decision`` flight-recorder event and
every mispredict a ``planner_mispredict`` one (noted on the active
in-flight ticket), with the JAX package's ``planner/*`` counters.
Learned coefficients persist across processes through
``mosaic.planner.stats.path`` / ``MOSAIC_TPU_PLANNER_STATS`` in the JAX
package's file format (version 1, ``"op|bucket"`` keys), so a file
either package saves loads in the other; a corrupt file degrades to a
cold start (fault site ``planner.stats.load``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics
from ..obs.recorder import recorder

__all__ = ["Planner", "Decision", "PlanStep", "QueryPlan", "planner",
           "FORCE_CHOICES", "STATS_PATH_ENV", "STATS_VERSION",
           "MISPREDICT_FACTOR"]

#: env var mirroring the ``mosaic.planner.stats.path`` conf key
STATS_PATH_ENV = "MOSAIC_TPU_PLANNER_STATS"
#: on-disk schema version; a file with any other version is ignored
#: (treated as cold, never an error)
STATS_VERSION = 1
#: an estimate off by more than this factor counts as a mispredict
MISPREDICT_FACTOR = 2.0

#: plannable operators of the port and the strategies
#: ``mosaic.planner.force.<op>`` accepts ("auto" clears the pin)
FORCE_CHOICES = {
    "equi_join": ("auto", "loop", "vectorized"),
    "knn": ("auto", "brute", "ring"),
    "pip_join": ("auto", "monolithic", "streamed", "sharded"),
    "fusion": ("auto", "on", "off"),
    "refine": ("auto", "refined", "flat"),
}

#: EWMA weight of the newest observation in the coefficient store
_ALPHA = 0.4
#: coefficient-store entry cap (LRU beyond this)
_STORE_CAP = 1024
#: below this combined row count the dict-loop join beats the
#: vectorized sort-join's fixed overhead (cold-start crossover; the
#: learned per-size-class coefficients override it once calibrated)
_JOIN_VECTOR_CROSSOVER = 4096
#: below this input row count a fused group's launch+fetch overhead
#: beats the saved host round-trips (cold-start crossover; learned
#: fused-vs-unfused coefficients override it once calibrated)
_FUSION_CROSSOVER = 1024
#: cold-start crossover for adaptive PIP refinement: refine only when
#: at least this fraction of the estimated candidate pairs sits in the
#: dense cells; learned refined-vs-flat coefficients override it
_REFINE_PAIR_CROSSOVER = 0.5


@dataclasses.dataclass
class Decision:
    """One strategy choice, with enough context to close the loop."""

    op: str                 # plannable operator ("knn", "pip_join", ...)
    strategy: str           # chosen path
    reason: str             # human-readable why
    est_rows: int = -1      # estimated input/output rows (-1 unknown)
    cost_key: str = ""      # coefficient-store op key for feedback
    key_n: int = 0          # the n the size-class bucket was taken from
    forced: bool = False    # an escape hatch pinned this, not the model

    @property
    def label(self) -> str:
        return f"{self.strategy}: {self.reason}" if self.reason \
            else self.strategy


@dataclasses.dataclass
class PlanStep:
    """Per-operator estimate for one SQL query (EXPLAIN row)."""

    op: str
    est_rows: int
    strategy: str = "-"
    reason: str = ""
    key_n: int = 0          # input rows the ratio estimate was keyed on
    est_bytes: int = -1     # est_rows x source row width (-1 unknown)
                            # — the memory budget's admission estimate

    @property
    def label(self) -> str:
        return f"{self.strategy}: {self.reason}" if self.reason \
            else self.strategy


class QueryPlan:
    """Ordered per-operator :class:`PlanStep` map for one query."""

    def __init__(self):
        self.steps: "OrderedDict[str, PlanStep]" = OrderedDict()
        #: the fusion pass's :class:`~..perf.fusion.FusionPlan` (None
        #: when fusion is off, ineligible, or decided against)
        self.fusion = None

    def add(self, step: PlanStep) -> PlanStep:
        self.steps[step.op] = step
        return step

    def est(self, op: str) -> int:
        s = self.steps.get(op)
        return s.est_rows if s is not None else -1

    def est_bytes_peak(self) -> int:
        """The widest single operator's byte estimate (stages run one
        at a time, so the peak — not the sum — is what admission
        checks against the budget); 0 when no step has one."""
        return max((s.est_bytes for s in self.steps.values()
                    if s.est_bytes > 0), default=0)

    def label(self, op: str) -> str:
        s = self.steps.get(op)
        return s.label if s is not None else "-"


def _row_bytes(table) -> int:
    """Bytes per materialized row of a table: dtype itemsize summed
    over columns, 8 per column without a dtype (object/geometry refs).
    Feeds the ``est_bytes`` pre-pass — a width estimate, not an exact
    footprint."""
    try:
        cols = table.columns
    except Exception:
        return 0
    total = 0
    for c in cols.values():
        dt = getattr(c, "dtype", None)
        total += int(getattr(dt, "itemsize", 0) or 8)
    return total


def _bucket(n: int) -> int:
    """The size class of ``n`` rows: the smallest power of two >=
    max(n, 4)."""
    n = max(int(n), 1)
    return max(4, 1 << int(np.ceil(np.log2(n))))


def _fmt_rows(n: int) -> str:
    n = int(n)
    if n >= 10_000_000:
        return f"{n / 1e6:.0f}M"
    if n >= 1_000_000:
        return f"{n / 1e6:.1f}M"
    if n >= 10_000:
        return f"{n / 1e3:.0f}k"
    return str(n)


class Planner:
    """Process-level cost model + decision/feedback API.

    Thread-safe; all state lives in two bounded EWMA stores keyed
    ``(op, pow2 size-class)``:

    * ``ms_per_row`` — observed wall ms per input row of a strategy
      (the per-size-class key absorbs fixed setup cost);
    * ``ratio`` — observed output rows / input rows of an operator.
    """

    def __init__(self, stats_path: Optional[str] = None):
        self._lock = threading.RLock()
        self._ms: "OrderedDict[Tuple[str, int], float]" = OrderedDict()
        self._ratio: "OrderedDict[Tuple[str, int], float]" = \
            OrderedDict()
        self.decisions = 0
        self.mispredicts = 0
        self.observations = 0
        #: recent estimate-error ratios (>= 1.0), newest last
        self.error_history: "deque[float]" = deque(maxlen=2048)
        self._stats_path = stats_path
        self._loaded = False
        if stats_path:
            self.load(stats_path)

    # ------------------------------------------------------- switches

    @property
    def enabled(self) -> bool:
        from ..config import default_config
        return bool(default_config().planner_enabled)

    def force_for(self, op: str) -> str:
        """The ``mosaic.planner.force.<op>`` pin ("auto" = none)."""
        from ..config import default_config, planner_force_for
        return planner_force_for(default_config(), op)

    def chunk_rows(self) -> int:
        """The streamed join's configured chunk size
        (``mosaic.stream.chunk.rows``)."""
        from ..config import default_config
        return int(default_config().stream_chunk_rows)

    # ------------------------------------------------ coefficient store

    def _put(self, store: "OrderedDict", key: Tuple[str, int],
             value: float) -> None:
        prev = store.get(key)
        store[key] = value if prev is None else \
            (1.0 - _ALPHA) * prev + _ALPHA * value
        store.move_to_end(key)
        while len(store) > _STORE_CAP:
            store.popitem(last=False)

    def _get(self, store: "OrderedDict", op: str,
             n: int) -> Optional[float]:
        """Exact (op, bucket) hit, else the op's nearest known bucket
        (log-distance, the first of equals in store order)."""
        b = _bucket(n)
        v = store.get((op, b))
        if v is not None:
            return v
        best, best_d = None, None
        for (o, ob), val in store.items():
            if o != op:
                continue
            d = abs(ob.bit_length() - b.bit_length())
            if best_d is None or d < best_d:
                best, best_d = val, d
        return best

    def ms_per_row(self, op: str, n: int) -> Optional[float]:
        with self._lock:
            return self._get(self._ms, op, n)

    def ratio(self, op: str, n: int) -> Optional[float]:
        with self._lock:
            return self._get(self._ratio, op, n)

    def est_cost_ms(self, op: str, n: int) -> Optional[float]:
        c = self.ms_per_row(op, n)
        return None if c is None else c * max(int(n), 1)

    # ------------------------------------------------------- decisions

    def record_decision(self, d: Decision) -> Decision:
        with self._lock:
            self.decisions += 1
        if metrics.enabled:
            metrics.count("planner/decisions")
            metrics.count(f"planner/decisions/{d.op}")
            if d.forced:
                metrics.count("planner/forced")
        recorder.record("planner_decision", op=d.op,
                        strategy=d.strategy, reason=d.reason,
                        est_rows=int(d.est_rows), forced=d.forced)
        return d

    def decide_equi_join(self, nl: int, nr: int) -> Decision:
        """Dict-loop vs. vectorized sort-join (both emit pairs in the
        same left-ascending / right-ascending-within-key order)."""
        n = nl + nr
        forced = self.force_for("equi_join")
        if forced != "auto":
            return self.record_decision(Decision(
                "equi_join", forced, "forced by conf", n,
                cost_key=f"equi_join/{forced}", key_n=n, forced=True))
        c_loop = self.est_cost_ms("equi_join/loop", n)
        c_vec = self.est_cost_ms("equi_join/vectorized", n)
        if c_loop is not None and c_vec is not None:
            s = "loop" if c_loop <= c_vec else "vectorized"
            why = (f"learned {min(c_loop, c_vec):.3g}ms vs "
                   f"{max(c_loop, c_vec):.3g}ms at {n} rows")
        else:
            s = "loop" if n < _JOIN_VECTOR_CROSSOVER else "vectorized"
            why = (f"{nl}+{nr} rows "
                   f"{'<' if s == 'loop' else '>='} "
                   f"{_JOIN_VECTOR_CROSSOVER} crossover")
        return self.record_decision(Decision(
            "equi_join", s, why, n, cost_key=f"equi_join/{s}",
            key_n=n))

    def decide_knn(self, n_left: int, n_right: int,
                   default_max: int) -> Decision:
        """Brute all-pairs device pass vs. ring marching (both exact,
        both tie-break by right id).  The ``mosaic.knn.strategy`` pin is
        resolved by the caller; this is the "auto" path."""
        forced = self.force_for("knn")
        if forced != "auto":
            return self.record_decision(Decision(
                "knn", forced, "forced by conf", n_left,
                cost_key=f"knn/{forced}", key_n=n_left, forced=True))
        c_b = self.est_cost_ms("knn/brute", n_left)
        c_r = self.est_cost_ms("knn/ring", n_left)
        # memory guard: the brute pass streams left blocks against the
        # WHOLE right side — never pick it far past the threshold
        brute_ok = 0 < n_right <= 4 * max(default_max, 1)
        if c_b is not None and c_r is not None and brute_ok:
            s = "brute" if c_b <= c_r else "ring"
            why = (f"learned {min(c_b, c_r):.3g}ms vs "
                   f"{max(c_b, c_r):.3g}ms, right={n_right}")
        else:
            s = "brute" if 0 < n_right <= default_max else "ring"
            why = (f"right {n_right} "
                   f"{'<=' if s == 'brute' else '>'} "
                   f"threshold {default_max}")
        return self.record_decision(Decision(
            "knn", s, why, n_left, cost_key=f"knn/{s}", key_n=n_left))

    def pip_join_candidates(self, n: int, mesh_devices: int = 1
                            ) -> List[Tuple[str, int]]:
        """(strategy, chunk) candidates for an ``n``-point join — every
        one gives the same zones.  Streamed appears in two chunk classes
        (the configured one and one 8x smaller); sharded only over more
        than one device (``mesh_devices``: the process group's size)."""
        chunk = self.chunk_rows()
        cands: List[Tuple[str, int]] = []
        if n <= chunk:
            cands.append(("monolithic", max(n, 1)))
        cands.append(("streamed", chunk))
        if chunk >= (1 << 17) and n > chunk // 8:
            cands.append(("streamed", chunk // 8))
        if mesh_devices > 1:
            cands.append(("sharded", chunk))
        return cands

    @staticmethod
    def pip_cost_key(strategy: str, chunk: int) -> str:
        if strategy == "streamed":
            return f"pip_join/streamed/c{int(chunk).bit_length()}"
        return f"pip_join/{strategy}"

    def decide_pip_join(self, n: int, mesh_devices: int = 1,
                        in_extent_frac: Optional[float] = None
                        ) -> Decision:
        """Monolithic vs. streamed (per chunk class) vs. sharded.

        ``in_extent_frac`` is the cheap bbox-overlap sketch: the fraction
        of the point batch's bbox that intersects the polygons' extent
        (an upper bound on matched rows) — it feeds the estimate."""
        est = int(n if in_extent_frac is None
                  else round(n * max(0.0, min(1.0, in_extent_frac))))
        forced = self.force_for("pip_join")
        if forced != "auto":
            chunk = self.chunk_rows()
            return self.record_decision(Decision(
                "pip_join", forced, "forced by conf", est,
                cost_key=self.pip_cost_key(forced, chunk), key_n=n,
                forced=True))
        cands = self.pip_join_candidates(n, mesh_devices)
        costs = [(self.est_cost_ms(self.pip_cost_key(s, c), n), s, c)
                 for s, c in cands]
        known = [(ms, s, c) for ms, s, c in costs if ms is not None]
        if known:
            ms, s, chunk = min(known, key=lambda t: t[0])
            why = (f"learned {ms:.3g}ms at est {_fmt_rows(est)} rows "
                   f"({len(known)}/{len(cands)} candidates "
                   f"calibrated)")
        else:
            chunk = self.chunk_rows()
            if n <= chunk:
                s, why = "monolithic", (f"est {_fmt_rows(est)} rows "
                                        f"<= chunk {chunk}")
            else:
                s, why = "streamed", (f"est {_fmt_rows(est)} rows > "
                                      f"chunk {chunk}")
        d = Decision("pip_join", s, why, est,
                     cost_key=self.pip_cost_key(s, chunk), key_n=n)
        d.chunk = chunk           # dynamic attr: the chosen chunk rows
        return self.record_decision(d)

    def decide_fusion(self, opset: str, member_ops: List[str],
                      n: int) -> Decision:
        """Fused whole-group kernel (K14) vs. per-operator dispatch (the
        same answer either way — ``perf.fusion`` only admits ops whose
        fused evaluation provably matches the host path).

        Learned comparison: the group's ``fusion/<opset>`` coefficient
        (fed by every warm fused execution) against the SUM of the
        member operators' unfused coefficients at this size class;
        static row-count crossover while either side is cold."""
        forced = self.force_for("fusion")
        if forced != "auto":
            s = "fused" if forced == "on" else "unfused"
            return self.record_decision(Decision(
                "fusion", s, "forced by conf", n,
                cost_key=f"fusion/{opset}", key_n=n, forced=True))
        c_f = self.est_cost_ms(f"fusion/{opset}", n)
        mcosts = [self.est_cost_ms(op, n) for op in member_ops]
        c_u = sum(mcosts) if all(c is not None for c in mcosts) \
            else None
        if c_f is not None and c_u is not None:
            s = "fused" if c_f <= c_u else "unfused"
            why = (f"learned fused {c_f:.3g}ms vs unfused "
                   f"{c_u:.3g}ms at {_fmt_rows(n)} rows")
        else:
            s = "fused" if n >= _FUSION_CROSSOVER else "unfused"
            why = (f"{_fmt_rows(n)} rows "
                   f"{'>=' if s == 'fused' else '<'} "
                   f"{_FUSION_CROSSOVER} crossover (cold)")
        return self.record_decision(Decision(
            "fusion", s, why, n, cost_key=f"fusion/{opset}", key_n=n))

    def decide_refine(self, n: int, dense_pair_frac: float,
                      max_dup: int, depth: Optional[int] = None
                      ) -> Decision:
        """Adaptive per-cell PIP refinement vs. the flat single-level
        join (the same zones either way; see ``make_refined_pip_join``).

        ``dense_pair_frac`` is the fraction of estimated candidate pairs
        (sampled points x chips sharing their cell) that land in the
        dense-cell set; ``max_dup`` the base index's probe width.  The
        kill switch (``mosaic.join.refine.enabled = false``) beats any
        pin."""
        from ..config import default_config
        cfg = default_config()
        if depth is None:
            depth = int(cfg.join_refine_depth)
        if not cfg.join_refine_enabled:
            d = Decision("refine", "flat", "disabled by conf", n,
                         cost_key="refine/flat", key_n=n, forced=True)
            d.depth = depth
            return self.record_decision(d)
        forced = self.force_for("refine")
        if forced != "auto":
            d = Decision("refine", forced, "forced by conf", n,
                         cost_key=f"refine/{forced}", key_n=n,
                         forced=True)
            d.depth = depth
            return self.record_decision(d)
        dup_floor = int(cfg.join_refine_dup_threshold)
        c_r = self.est_cost_ms("refine/refined", n)
        c_f = self.est_cost_ms("refine/flat", n)
        if c_r is not None and c_f is not None:
            s = "refined" if c_r <= c_f else "flat"
            why = (f"learned {min(c_r, c_f):.3g}ms vs "
                   f"{max(c_r, c_f):.3g}ms at {_fmt_rows(n)} rows")
        elif dense_pair_frac >= _REFINE_PAIR_CROSSOVER and \
                max_dup >= dup_floor:
            s = "refined"
            why = (f"dense pair frac {dense_pair_frac:.2f} >= "
                   f"{_REFINE_PAIR_CROSSOVER} at dup {max_dup} (cold)")
        else:
            s = "flat"
            why = (f"dense pair frac {dense_pair_frac:.2f} < "
                   f"{_REFINE_PAIR_CROSSOVER} or dup {max_dup} < "
                   f"{dup_floor} (cold)")
        d = Decision("refine", s, why, n, cost_key=f"refine/{s}",
                     key_n=n)
        d.depth = depth           # dynamic attr: levels to deepen by
        return self.record_decision(d)

    # ----------------------------------------------------- SQL pre-pass

    def plan_query(self, q, session) -> Optional[QueryPlan]:
        """Cheap pre-pass over a parsed :class:`~.parser.Query`: exact
        scan cardinalities from the catalog, learned ratios for
        everything downstream.  Returns None when the referenced
        tables are unknown (the engine raises its own error)."""
        from .parser import Call
        from .engine import AGGREGATES, GENERATORS
        try:
            left = session.table(q.table.name)
        except Exception:
            return None
        plan = QueryPlan()
        nl = len(left)
        row_width = _row_bytes(left)
        if q.join is not None:
            try:
                right = session.table(q.join.name)
            except Exception:
                return None
            nr = len(right)
            row_width += _row_bytes(right)
            op = f"{q.join_kind}_join"
            n_in = nl + nr
            r = self.ratio(op, n_in)
            if r is not None:
                rows = int(round(r * max(n_in, 1)))
                why_est = "learned fanout"
            else:
                rows = max(nl, nr)
                why_est = "cold: max(sides)"
            d = self.decide_equi_join(nl, nr)
            step = plan.add(PlanStep(op, rows, d.strategy,
                                     f"{d.reason}; est "
                                     f"{_fmt_rows(rows)} rows "
                                     f"({why_est})", key_n=n_in))
            step.decision = d   # _equi_join executes this exact pick
        else:
            rows = nl
            plan.add(PlanStep("scan", rows, "scan",
                              f"{_fmt_rows(rows)} rows (exact)",
                              key_n=nl))
        gens = [it.expr.name for it in q.items
                if isinstance(it.expr, Call) and
                it.expr.name in GENERATORS]
        if gens:
            op = f"generate/{gens[0]}"
            r = self.ratio(op, rows)
            fan = r if r is not None else 4.0
            key_n = rows
            rows = int(round(fan * max(rows, 1)))
            plan.add(PlanStep("generate", rows, gens[0],
                              f"est {fan:.2g}x fanout "
                              f"{'(learned)' if r is not None else '(cold)'}",
                              key_n=key_n))
        if q.where is not None:
            r = self.ratio("filter", rows)
            sel = r if r is not None else 1.0
            key_n = rows
            rows = int(round(sel * rows))
            plan.add(PlanStep("filter", rows, "filter",
                              f"est selectivity {sel:.2g} "
                              f"{'(learned)' if r is not None else '(cold)'}",
                              key_n=key_n))
        has_agg = any(isinstance(it.expr, Call) and
                      it.expr.name in AGGREGATES for it in q.items)
        if q.group_by is not None or has_agg:
            r = self.ratio("aggregate", rows)
            key_n = rows
            if r is not None:
                rows = int(round(r * max(rows, 1)))
                why = "learned group count"
            elif q.group_by is None:
                rows, why = 1, "implicit single group"
            else:
                why = "cold: rows upper bound"
            plan.add(PlanStep("aggregate", rows, "hash-agg",
                              f"est {_fmt_rows(rows)} groups ({why})",
                              key_n=key_n))
        else:
            plan.add(PlanStep("project", rows, "project",
                              f"est {_fmt_rows(rows)} rows",
                              key_n=rows))
        if q.order_by:
            plan.add(PlanStep("order", rows, "sort",
                              f"est {_fmt_rows(rows)} rows",
                              key_n=rows))
        if q.limit is not None:
            key_n = rows
            rows = min(q.limit, rows)
            plan.add(PlanStep("limit", rows, "limit",
                              f"{_fmt_rows(rows)} rows (exact cap)",
                              key_n=key_n))
        # byte pre-pass: cardinality x source row width per operator —
        # the EXPLAIN est_bytes column and the memory budget's admit()
        # estimate (a width heuristic, not an exact footprint)
        if row_width > 0:
            for step in plan.steps.values():
                if step.est_rows >= 0:
                    step.est_bytes = int(step.est_rows) * row_width
        # fusion pass: group adjacent eligible operators into one K14
        # program (gated per size class by decide_fusion).  Degrade-
        # not-die: a fusion planning fault leaves the query unfused.
        try:
            from ..perf.fusion import plan_fusion
            plan.fusion = plan_fusion(q, session, plan)
        except Exception as e:
            recorder.record("fusion_plan_error",
                            error=f"{type(e).__name__}: {e}")
            if metrics.enabled:
                metrics.count("fusion/plan_errors")
        return plan

    # -------------------------------------------------------- feedback

    def observe_op(self, op: str, n: int, wall_s: float,
                   rows_out: Optional[int] = None) -> None:
        """Raw coefficient feedback: ``op`` processed ``n`` input rows
        in ``wall_s`` seconds (optionally emitting ``rows_out``)."""
        n = max(int(n), 1)
        with self._lock:
            self._put(self._ms, (op, _bucket(n)), wall_s * 1e3 / n)
            if rows_out is not None:
                self._put(self._ratio, (op, _bucket(n)), rows_out / n)
            self.observations += 1
        if metrics.enabled:
            metrics.observe(f"planner/op_ms/{op}", wall_s)
        self._maybe_autosave()

    def observe_ratio(self, op: str, n: int, rows_out: int) -> None:
        """Cardinality-only feedback: an operator's output ratio learns
        without touching its cost coefficient."""
        n = max(int(n), 1)
        with self._lock:
            self._put(self._ratio, (op, _bucket(n)), rows_out / n)
            self.observations += 1
        self._maybe_autosave()

    def observe_estimate(self, op: str, est_rows: int,
                         actual_rows: int) -> float:
        """Close one cardinality estimate; returns the error ratio
        (>= 1.0, where 1.0 is a perfect estimate)."""
        e = (est_rows + 1.0) / (actual_rows + 1.0)
        err = max(e, 1.0 / e)
        with self._lock:
            self.error_history.append(err)
            mis = err > MISPREDICT_FACTOR
            if mis:
                self.mispredicts += 1
        if metrics.enabled:
            metrics.observe("planner/estimate_error", err, scale=1.0)
            if mis:
                metrics.count("planner/mispredicts")
        if mis:
            from ..obs.inflight import note_mispredict
            note_mispredict()
            recorder.record("planner_mispredict", op=op,
                            est_rows=int(est_rows),
                            actual_rows=int(actual_rows),
                            error=round(err, 3))
        return err

    def observe_step(self, step: PlanStep, rows_out: int,
                     wall_s: float) -> None:
        """SQL-stage feedback: update the step's ratio/cost
        coefficients under the SAME (op, size-class) key the estimate
        was made with, and close the estimate."""
        self.observe_op(step.op if step.op not in ("generate",)
                        else f"generate/{step.strategy}",
                        step.key_n, wall_s, rows_out=rows_out)
        self.observe_estimate(step.op, step.est_rows, rows_out)

    def observe_decision(self, d: Decision, wall_s: float,
                         rows_out: Optional[int] = None) -> None:
        """Operator-dispatch feedback: the chosen strategy's cost
        coefficient learns from the run."""
        if d.cost_key:
            self.observe_op(d.cost_key, d.key_n, wall_s,
                            rows_out=rows_out)
        if rows_out is not None and d.est_rows >= 0:
            self.observe_estimate(d.op, d.est_rows, rows_out)

    # ------------------------------------------------------ persistence

    def _resolve_stats_path(self) -> Optional[str]:
        if self._stats_path:
            return self._stats_path
        path = os.environ.get(STATS_PATH_ENV)
        if path:
            return path
        from ..config import default_config
        return default_config().planner_stats_path or None

    def configure_stats(self, path: Optional[str] = None
                        ) -> Optional[str]:
        """Wire persistence (resolution: explicit arg >
        ``MOSAIC_TPU_PLANNER_STATS`` env > the conf key) and load any
        existing file."""
        if path:
            with self._lock:
                self._stats_path = str(path)
        resolved = self._resolve_stats_path()
        if resolved and not self._loaded:
            self.load(resolved)
        return resolved

    def load(self, path: Optional[str] = None) -> bool:
        """Warm-start the coefficient store from a stats file.

        Degrade-not-die: a missing, corrupt, or wrong-version file
        leaves the planner cold and records why — it never raises
        (fault site ``planner.stats.load``)."""
        path = path or self._resolve_stats_path()
        if not path:
            return False
        with self._lock:
            self._loaded = True
        from ..resilience import faults
        try:
            faults.maybe_fail("planner.stats.load")
            with open(path) as f:
                blob = json.load(f)
            if not isinstance(blob, dict) or \
                    blob.get("version") != STATS_VERSION:
                raise ValueError(
                    f"planner stats version "
                    f"{blob.get('version') if isinstance(blob, dict) else '?'}"
                    f" != {STATS_VERSION}")
            ms = {_parse_key(k): float(v)
                  for k, v in blob.get("ms_per_row", {}).items()}
            ratio = {_parse_key(k): float(v)
                     for k, v in blob.get("ratio", {}).items()}
        except FileNotFoundError:
            return False
        except Exception as e:          # corrupt file: cold start
            recorder.record("planner_stats_corrupt", path=path,
                            error=f"{type(e).__name__}: {e}")
            if metrics.enabled:
                metrics.count("planner/stats_corrupt")
            return False
        with self._lock:
            for k, v in ms.items():
                self._put(self._ms, k, v)
            for k, v in ratio.items():
                self._put(self._ratio, k, v)
        recorder.record("planner_stats_loaded", path=path,
                        ms_keys=len(ms), ratio_keys=len(ratio))
        return True

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Atomic (tmp + rename) versioned snapshot of the coefficient
        store; IO failure is recorded, not raised."""
        path = path or self._resolve_stats_path()
        if not path:
            return None
        with self._lock:
            blob = {
                "version": STATS_VERSION,
                "ms_per_row": {_fmt_key(k): v
                               for k, v in self._ms.items()},
                "ratio": {_fmt_key(k): v
                          for k, v in self._ratio.items()},
            }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(blob, f)
            os.replace(tmp, path)
        except OSError as e:
            recorder.record("planner_stats_save_failed", path=path,
                            error=str(e))
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        return path

    def _maybe_autosave(self) -> None:
        if self.observations % 32 == 0 and \
                self._resolve_stats_path():
            self.save()

    # ------------------------------------------------------- reporting

    def error_p95(self, window: int = 256) -> float:
        """p95 of the last ``window`` closed estimate errors (1.0 when
        none yet)."""
        with self._lock:
            errs = list(self.error_history)[-window:]
        return float(np.percentile(errs, 95)) if errs else 1.0

    def report(self) -> Dict[str, object]:
        with self._lock:
            return {
                "decisions": self.decisions,
                "mispredicts": self.mispredicts,
                "observations": self.observations,
                "mispredict_rate": round(
                    self.mispredicts / max(len(self.error_history), 1),
                    4),
                "estimate_error_p95": round(self.error_p95(), 3),
                "ms_keys": len(self._ms),
                "ratio_keys": len(self._ratio),
            }

    def reset(self) -> None:
        """Forget everything."""
        with self._lock:
            self._ms.clear()
            self._ratio.clear()
            self.decisions = self.mispredicts = self.observations = 0
            self.error_history.clear()
            self._loaded = False


def _fmt_key(k: Tuple[str, int]) -> str:
    return f"{k[0]}|{k[1]}"


def _parse_key(s: str) -> Tuple[str, int]:
    op, _, b = s.rpartition("|")
    return op, int(b)


#: the process-global planner every dispatch site consults
planner = Planner()
