"""Cost-based strategy planner for the port's join family and SpatialKNN.

Port of the decision half of ``mosaic_tpu.sql.planner``: the cost model
and the three decisions the port runs — brute vs. ring KNN
(:meth:`Planner.decide_knn`), monolithic vs. streamed PIP join per chunk
class (:meth:`Planner.decide_pip_join`) and the refined vs. flat PIP join
(:meth:`Planner.decide_refine`).  Each decision comes from a cheap
pre-pass (row counts, bbox overlap fraction) plus **observed**
per-(operator, pow2 size-class) cost coefficients; after a run the
observed wall time and rows feed back into the bounded EWMA store
(:meth:`Planner.observe_decision`), so a workload's second run is planned
from measurement.

Every candidate of a decision gives the same answer bit for bit: the
planner changes where and how fast an answer is computed, never the
answer.  Escape hatches: ``mosaic.planner.enabled`` and
``mosaic.planner.force.<op>`` (``config.py``).

Left out here: the JAX package's metrics and flight-recorder hooks, the
stats file (``load``, ``save``, ``configure_stats``) and the SQL
decisions (``decide_equi_join``, ``decide_fusion``, ``plan_query``,
``observe_step``).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Planner", "Decision", "planner", "FORCE_CHOICES",
           "MISPREDICT_FACTOR"]

#: an estimate off by more than this factor counts as a mispredict
MISPREDICT_FACTOR = 2.0

#: plannable operators of the port and the strategies
#: ``mosaic.planner.force.<op>`` accepts ("auto" clears the pin)
FORCE_CHOICES = {
    "knn": ("auto", "brute", "ring"),
    "pip_join": ("auto", "monolithic", "streamed"),
    "refine": ("auto", "refined", "flat"),
}

#: EWMA weight of the newest observation in the coefficient store
_ALPHA = 0.4
#: coefficient-store entry cap (LRU beyond this)
_STORE_CAP = 1024
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

    def __init__(self):
        self._lock = threading.RLock()
        self._ms: "OrderedDict[Tuple[str, int], float]" = OrderedDict()
        self._ratio: "OrderedDict[Tuple[str, int], float]" = \
            OrderedDict()
        self.decisions = 0
        self.mispredicts = 0
        self.observations = 0
        #: recent estimate-error ratios (>= 1.0), newest last
        self.error_history: "deque[float]" = deque(maxlen=2048)

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
        return d

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

    def pip_join_candidates(self, n: int) -> List[Tuple[str, int]]:
        """(strategy, chunk) candidates for an ``n``-point join on one
        device — every one gives the same zones.  Streamed appears in
        two chunk classes (the configured one and one 8x smaller)."""
        chunk = self.chunk_rows()
        cands: List[Tuple[str, int]] = []
        if n <= chunk:
            cands.append(("monolithic", max(n, 1)))
        cands.append(("streamed", chunk))
        if chunk >= (1 << 17) and n > chunk // 8:
            cands.append(("streamed", chunk // 8))
        return cands

    @staticmethod
    def pip_cost_key(strategy: str, chunk: int) -> str:
        if strategy == "streamed":
            return f"pip_join/streamed/c{int(chunk).bit_length()}"
        return f"pip_join/{strategy}"

    def decide_pip_join(self, n: int,
                        in_extent_frac: Optional[float] = None
                        ) -> Decision:
        """Monolithic vs. streamed (per chunk class).

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
        cands = self.pip_join_candidates(n)
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

    def observe_ratio(self, op: str, n: int, rows_out: int) -> None:
        """Cardinality-only feedback: an operator's output ratio learns
        without touching its cost coefficient."""
        n = max(int(n), 1)
        with self._lock:
            self._put(self._ratio, (op, _bucket(n)), rows_out / n)
            self.observations += 1

    def observe_estimate(self, op: str, est_rows: int,
                         actual_rows: int) -> float:
        """Close one cardinality estimate; returns the error ratio
        (>= 1.0, where 1.0 is a perfect estimate)."""
        e = (est_rows + 1.0) / (actual_rows + 1.0)
        err = max(e, 1.0 / e)
        with self._lock:
            self.error_history.append(err)
            if err > MISPREDICT_FACTOR:
                self.mispredicts += 1
        return err

    def observe_decision(self, d: Decision, wall_s: float,
                         rows_out: Optional[int] = None) -> None:
        """Operator-dispatch feedback: the chosen strategy's cost
        coefficient learns from the run."""
        if d.cost_key:
            self.observe_op(d.cost_key, d.key_n, wall_s,
                            rows_out=rows_out)
        if rows_out is not None and d.est_rows >= 0:
            self.observe_estimate(d.op, d.est_rows, rows_out)

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


#: the process-global planner every dispatch site consults
planner = Planner()
