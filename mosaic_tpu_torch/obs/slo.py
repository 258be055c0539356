"""Declarative SLO objectives with multi-window burn-rate alerting.

Port copy of ``mosaic_tpu.obs.slo``: the same objectives, kinds,
transitions, events and gauges.  A small set of :class:`SLObjective`
records is evaluated against the ``obs.timeseries`` store on every
sampler tick (or a direct :meth:`SLOMonitor.evaluate`).

Burn-rate semantics (the Google-SRE multi-window pattern): an
objective with target ``objective`` has error budget ``1 −
objective``; it breaches when the bad fraction exceeds ``burn ×
budget`` in **both** the short and the long window.  The short window
makes alerts fast, the long window keeps one-sample blips from
paging.  Rate/ceiling objectives compare the windowed rate / max
against a fixed threshold in both windows instead.

On a breach *transition* (ok → breached) the monitor emits exactly
one ``slo_breach`` flight-recorder event, bumps ``slo/breaches``,
flips ``slo/active/<name>`` to 1 and raises the ``obs/alerts_active``
gauge.  Staying breached is silent (no alert storms); recovery emits
``slo_recovered`` and drops the gauges.  ``mosaic.obs.slo.dump``
additionally writes a flight-recorder bundle at each breach transition.

Objective kinds:

* ``latency``   — fraction of ``series`` points above ``threshold_ms``
  (ms-valued series) vs. the error budget;
* ``error_rate`` — windowed rate of ``bad`` counter over rate of
  ``total`` counter vs. the error budget;
* ``counter_rate`` — windowed rate of ``series`` vs. ``max_rate``
  events/s;
* ``gauge_max`` — windowed max of ``series`` vs. ``ceiling`` (the
  shard-skew ceiling, the device-memory pressure).

The JAX package's ``fleet_objectives`` and ``evaluate_fleet`` read the
fleet aggregator's merged store and its supervisor's series; they come
with ``obs/fleet.py`` and ``serve/`` (ROADMAP §A9c).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from .metrics import metrics
from .recorder import recorder
from .timeseries import TimeSeriesStore, timeseries

__all__ = ["SLObjective", "SLOMonitor", "monitor",
           "default_objectives", "principal_objectives",
           "serve_objectives", "KINDS"]

KINDS = ("latency", "error_rate", "counter_rate", "gauge_max")


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective; see module docstring for kinds."""

    name: str
    kind: str
    series: str = ""                 # latency / counter_rate / gauge_max
    bad: str = ""                    # error_rate: failure counter
    total: str = ""                  # error_rate: attempt counter
    threshold_ms: float = 0.0        # latency: a point above this is bad
    objective: float = 0.99          # latency/error_rate good-fraction
    burn: float = 1.0                # budget multiplier before alerting
    max_rate: float = 0.0            # counter_rate ceiling (events/s)
    ceiling: float = 0.0             # gauge_max ceiling
    windows: Tuple[float, float] = (60.0, 300.0)   # (short, long) s
    min_points: int = 1              # latency: short-window floor

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"SLO {self.name!r}: unknown kind "
                             f"{self.kind!r} (have {KINDS})")

    def _bad_frac(self, store: TimeSeriesStore, win: float,
                  now: float) -> Tuple[float, float]:
        """(bad fraction, observation weight) over one window."""
        if self.kind == "latency":
            bad, total = store.fraction_over(
                self.series, self.threshold_ms, win, now)
            return (bad / total if total else 0.0), float(total)
        if self.kind == "error_rate":
            bad = max(0.0, store.rate(self.bad, win, now))
            total = max(0.0, store.rate(self.total, win, now))
            return (bad / total if total > 0 else 0.0), total
        if self.kind == "counter_rate":
            r = max(0.0, store.rate(self.series, win, now))
            # normalized so the shared burn×budget compare applies
            return (r / self.max_rate if self.max_rate > 0 else 0.0), r
        st = store.window_stats(self.series, win, now)   # gauge_max
        if not st["count"] or self.ceiling <= 0:
            return 0.0, 0.0
        return st["max"] / self.ceiling, float(st["count"])

    def evaluate(self, store: TimeSeriesStore,
                 now: Optional[float] = None) -> Dict[str, object]:
        """One multi-window check -> {breached, short, long, budget}."""
        now = time.time() if now is None else now
        short_w, long_w = self.windows
        f_short, w_short = self._bad_frac(store, short_w, now)
        f_long, _ = self._bad_frac(store, long_w, now)
        if self.kind in ("latency", "error_rate"):
            budget = self.burn * (1.0 - self.objective)
        else:
            budget = self.burn       # rates/ceilings are pre-normalized
        breached = f_short > budget and f_long > budget
        if self.kind == "latency" and w_short < self.min_points:
            breached = False
        return {"name": self.name, "kind": self.kind,
                "breached": breached, "budget": budget,
                "short": f_short, "long": f_long,
                "windows": list(self.windows)}


def default_objectives() -> List[SLObjective]:
    """The shipped objectives, the JAX package's — deliberately loose
    enough that a clean run with the sampler on raises zero alerts.  The
    SQL objectives read what ``sql.engine.SQLSession.sql`` feeds (the
    ``sql/query_ms`` series, the ``sql/queries`` and ``sql/errors``
    counters); the compile objective's series stays empty, since the
    port compiles nothing at run time."""
    return [
        # per-operator latency: a sql() call taking > 30 s is bad; more
        # than 5% bad in both windows pages
        SLObjective(name="sql_latency", kind="latency",
                    series="sql/query_ms", threshold_ms=30_000.0,
                    objective=0.95, min_points=3),
        # internal query failures (SQLError user mistakes excluded —
        # engine counts only unexpected errors into sql/errors)
        SLObjective(name="sql_errors", kind="error_rate",
                    bad="sql/errors", total="sql/queries",
                    objective=0.90),
        # compile-storm budget: sustained > 2 XLA compiles/s means
        # ragged shapes are defeating every cache layer
        SLObjective(name="compile_storm", kind="counter_rate",
                    series="jax/recompiles", max_rate=2.0),
        # shard-skew ceiling: max/mean per-device load above 8x for
        # five minutes means placement has collapsed
        SLObjective(name="shard_skew", kind="gauge_max",
                    series="shard/skew/pip_join", ceiling=8.0,
                    windows=(60.0, 300.0)),
        # device-memory pressure: ledger-attributed live bytes at the
        # effective capacity (budget or HBM) in both windows — the
        # breach dump's bundle embeds the full ledger snapshot, so the
        # post-mortem names the holders.  Clean runs sit near zero
        # pressure; only a configured tiny budget (the mem-smoke
        # drill) or real saturation crosses 1.0.
        SLObjective(name="device_mem_pressure", kind="gauge_max",
                    series="mem/pressure_max", ceiling=1.0,
                    windows=(60.0, 300.0)),
    ]


def principal_objectives(principal: str,
                         query_ms_ceiling: float = 60_000.0,
                         max_qps: float = 50.0) -> List[SLObjective]:
    """The per-principal objective pair the accounting plane registers
    on first sight of each principal (obs/accounting.py): a
    ``gauge_max`` ceiling on the tenant's per-query latency series and
    a ``counter_rate`` ceiling on its query rate.  Deliberately loose,
    like :func:`default_objectives` — tenants get burn-rate alerting
    with zero per-tenant config, operators tighten via
    :meth:`SLOMonitor.add_objective` (same-name replace)."""
    return [
        SLObjective(name=f"principal_latency:{principal}",
                    kind="gauge_max",
                    series=f"principal/query_ms/{principal}",
                    ceiling=query_ms_ceiling),
        SLObjective(name=f"principal_qps:{principal}",
                    kind="counter_rate",
                    series=f"principal/queries/{principal}",
                    max_rate=max_qps),
    ]


def serve_objectives(queue_depth: int,
                     request_ms_ceiling: float = 30_000.0
                     ) -> List[SLObjective]:
    """The query-server objective pair ``QueryServer.start``
    registers: a ``gauge_max`` ceiling on end-to-end request latency
    (the serve/request_ms series the server records per request) and a
    ``gauge_max`` on admission-queue occupancy at 90% of the
    configured depth — sustained near-full queue means the server is
    living off the shed path, which is degrade-not-die working as
    designed but an operator signal all the same."""
    return [
        SLObjective(name="serve_request_latency",
                    kind="gauge_max",
                    series="serve/request_ms",
                    ceiling=request_ms_ceiling),
        SLObjective(name="serve_queue_saturation",
                    kind="gauge_max",
                    series="serve/queue_depth",
                    ceiling=max(1.0, 0.9 * float(queue_depth))),
    ]


class SLOMonitor:
    """Evaluates objectives against the store; owns breach-episode
    state so each breach alerts exactly once."""

    def __init__(self, objectives: Optional[List[SLObjective]] = None,
                 store: Optional[TimeSeriesStore] = None):
        self._lock = threading.Lock()
        self._objectives = list(objectives) if objectives is not None \
            else default_objectives()
        self._store = store if store is not None else timeseries
        self._breached: Dict[str, Dict[str, object]] = {}
        self._breach_count = 0

    # -- objective management
    def objectives(self) -> List[SLObjective]:
        with self._lock:
            return list(self._objectives)

    def set_objectives(self, objectives: List[SLObjective]) -> None:
        with self._lock:
            self._objectives = list(objectives)

    def add_objective(self, obj: SLObjective) -> None:
        with self._lock:
            self._objectives = [o for o in self._objectives
                                if o.name != obj.name] + [obj]

    def reset(self, objectives: Optional[List[SLObjective]] = None) -> None:
        """Clear episode state (and optionally swap objectives);
        clears the alert gauges it owns."""
        with self._lock:
            for name in self._breached:
                metrics.gauge(f"slo/active/{name}", 0.0)
            self._breached.clear()
            self._breach_count = 0
            if objectives is not None:
                self._objectives = list(objectives)
        metrics.gauge("obs/alerts_active", 0.0)

    # -- evaluation
    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, object]]:
        """Evaluate every objective; returns the state *transitions*
        this call produced (new breaches + recoveries).  Called from
        the sampler tick; safe to call directly."""
        now = time.time() if now is None else now
        with self._lock:
            objectives = list(self._objectives)
        transitions: List[Dict[str, object]] = []
        for obj in objectives:
            try:
                res = obj.evaluate(self._store, now)
            except Exception:
                continue              # a bad objective must not stop
                                      # the others from evaluating
            with self._lock:
                was = obj.name in self._breached
                if res["breached"] and not was:
                    self._breached[obj.name] = res
                    self._breach_count += 1
                    transitions.append(dict(res, transition="breach"))
                elif not res["breached"] and was:
                    self._breached.pop(obj.name)
                    transitions.append(dict(res, transition="recovery"))
                elif res["breached"]:
                    self._breached[obj.name] = res   # refresh values
                n_active = len(self._breached)
            if res["breached"] and not was:
                self._on_breach(obj, res)
            elif was and not res["breached"]:
                recorder.record("slo_recovered", objective=obj.name,
                                slo_kind=obj.kind)
                metrics.gauge(f"slo/active/{obj.name}", 0.0)
            metrics.gauge("obs/alerts_active", float(n_active))
        return transitions

    def _on_breach(self, obj: SLObjective, res: Dict[str, object]) -> None:
        recorder.record(
            "slo_breach", objective=obj.name, slo_kind=obj.kind,
            short=round(float(res["short"]), 6),
            long=round(float(res["long"]), 6),
            budget=round(float(res["budget"]), 6),
            windows=res["windows"])
        metrics.count("slo/breaches")
        metrics.count(f"slo/breaches/{obj.name}")
        metrics.gauge(f"slo/active/{obj.name}", 1.0)
        from .. import config as _config
        if getattr(_config.default_config(), "obs_slo_dump", False):
            # throttled: shares the mosaic.obs.dump.cooldown.ms gate
            # with slow-query dumps (no dump storms under sustained
            # breach churn); the bundle embeds the profiler snapshot
            try:
                recorder.dump_throttled(reason=f"slo_{obj.name}")
            except OSError:
                pass

    # -- reads
    def active_alerts(self) -> List[Dict[str, object]]:
        with self._lock:
            return [dict(v) for v in self._breached.values()]

    def alerts_active(self) -> int:
        with self._lock:
            return len(self._breached)

    def breach_count(self) -> int:
        with self._lock:
            return self._breach_count

    def report(self) -> Dict[str, object]:
        with self._lock:
            return {
                "objectives": [dataclasses.asdict(o)
                               for o in self._objectives],
                "active": [dict(v) for v in self._breached.values()],
                "breaches": self._breach_count,
            }


#: the process-global monitor the sampler drives
monitor = SLOMonitor()
