"""The port's SLO objectives and monitor against the JAX package's.

* The same objectives over the same seeded store give the same
  evaluations (bad fractions, budgets, breaches) in both packages, for
  every kind (``latency``, ``error_rate``, ``counter_rate``,
  ``gauge_max``), at every step of a timeline that breaches, stays
  breached, recovers and breaches again.
* The monitors make the same transitions, and record the same
  ``slo_breach`` / ``slo_recovered`` events (timestamps, ``seq`` and
  trace ids aside) and the same ``slo/*`` and ``obs/alerts_active``
  gauges and counters.
* The shipped objective sets are the JAX package's
  (``default_objectives``, ``principal_objectives``,
  ``serve_objectives``, ``fleet_objectives``), and ``evaluate_fleet``
  over a store gives the JAX package's rows, skipping a failing
  objective alike.
* ``mosaic.obs.slo.dump`` writes one throttled bundle at a breach.
"""

import dataclasses

import numpy as np
import pytest

from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.obs.slo import SLObjective as JObjective
from mosaic_tpu.obs.slo import SLOMonitor as JMonitor
from mosaic_tpu.obs.slo import default_objectives as jdefault
from mosaic_tpu.obs.slo import principal_objectives as jprincipal
from mosaic_tpu.obs.slo import serve_objectives as jserve
from mosaic_tpu.obs.timeseries import TimeSeriesStore as JStore
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics, recorder, slo
from mosaic_tpu_torch.obs.slo import (SLObjective, SLOMonitor,
                                      default_objectives,
                                      principal_objectives,
                                      serve_objectives)
from mosaic_tpu_torch.obs.timeseries import TimeSeriesStore


@pytest.fixture
def planes():
    """Both packages' registries and recorders on and empty."""
    was = metrics.enabled, jmetrics.enabled, jrec.enabled
    for reg in (metrics, jmetrics):
        reg.reset()
        reg.enable()
    for rec in (recorder, jrec):
        rec.reset()
        rec.enable()
    yield
    for reg, w in ((metrics, was[0]), (jmetrics, was[1])):
        reg.reset()
        if not w:
            reg.disable()
    recorder.reset()
    jrec.reset()
    if not was[2]:
        jrec.disable()


#: one objective of each kind (windows 10 s / 40 s)
OBJECTIVES = {
    "latency": dict(name="lat", kind="latency", series="q_ms",
                    threshold_ms=100.0, objective=0.9, min_points=3,
                    windows=(10.0, 40.0)),
    "error_rate": dict(name="err", kind="error_rate", bad="bad",
                       total="total", objective=0.9,
                       windows=(10.0, 40.0)),
    "counter_rate": dict(name="storm", kind="counter_rate",
                         series="compiles", max_rate=2.0,
                         windows=(10.0, 40.0)),
    "gauge_max": dict(name="skew", kind="gauge_max", series="skew",
                      ceiling=4.0, windows=(10.0, 40.0)),
}


def _feed(store, kind, seed):
    """A seeded timeline over t = 0..199 s: calm, a hot stretch from 60 s
    to 110 s, calm again, a second hot stretch from 150 s."""
    rng = np.random.default_rng(seed)
    hot = lambda t: 60 <= t < 110 or t >= 150        # noqa: E731
    bad = total = comp = 0.0
    for t in range(200):
        h = hot(t)
        if kind == "latency":
            store.record("q_ms", float(rng.uniform(300, 900) if h
                                       else rng.uniform(1, 90)), t)
        elif kind == "error_rate":
            total += 10.0
            bad += float(rng.integers(4, 8) if h else rng.integers(0, 1))
            store.record("total", total, t)
            store.record("bad", bad, t)
        elif kind == "counter_rate":
            comp += float(rng.integers(3, 9) if h else rng.integers(0, 2))
            store.record("compiles", comp, t)
        else:
            store.record("skew", float(rng.uniform(5, 9) if h
                                       else rng.uniform(1, 3)), t)


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "seq", "trace")}


@pytest.mark.parametrize("kind", sorted(OBJECTIVES))
@pytest.mark.parametrize("seed", [3, 4])
def test_evaluations_equal_jax(kind, seed):
    ts, js = TimeSeriesStore(), JStore()
    _feed(ts, kind, seed)
    _feed(js, kind, seed)
    t = SLObjective(**OBJECTIVES[kind])
    j = JObjective(**OBJECTIVES[kind])
    breached = []
    for now in np.arange(5.0, 240.0, 2.5):
        rt, rj = t.evaluate(ts, float(now)), j.evaluate(js, float(now))
        assert rt == rj, now
        breached.append(rt["breached"])
    assert any(breached) and not all(breached)


@pytest.mark.parametrize("kind", sorted(OBJECTIVES))
def test_monitor_transitions_events_and_gauges_equal_jax(planes, kind):
    ts, js = TimeSeriesStore(), JStore()
    _feed(ts, kind, 5)
    _feed(js, kind, 5)
    mt = SLOMonitor([SLObjective(**OBJECTIVES[kind])], store=ts)
    mj = JMonitor([JObjective(**OBJECTIVES[kind])], store=js)
    seq_t, seq_j = [], []
    for now in np.arange(5.0, 260.0, 5.0):
        seq_t += [(float(now), x["transition"])
                  for x in mt.evaluate(now=float(now))]
        seq_j += [(float(now), x["transition"])
                  for x in mj.evaluate(now=float(now))]
        assert mt.alerts_active() == mj.alerts_active()
    assert seq_t == seq_j
    assert [x[1] for x in seq_t][:2] == ["breach", "recovery"]
    assert mt.breach_count() == mj.breach_count() >= 1
    for kind_ in ("slo_breach", "slo_recovered"):
        assert [_strip(e) for e in recorder.events(kind_)] == \
            [_strip(e) for e in jrec.events(kind_)]
    rt, rj = metrics.report(), jmetrics.report()
    for k in ("counters", "gauges"):
        assert {n: v for n, v in rt[k].items() if n.startswith(
            ("slo/", "obs/alerts"))} == \
            {n: v for n, v in rj[k].items() if n.startswith(
                ("slo/", "obs/alerts"))}
    assert mt.report() == mj.report() | {
        "objectives": mt.report()["objectives"]}
    mt.reset()
    assert mt.alerts_active() == 0
    assert metrics.gauge_value("obs/alerts_active") == 0.0


@pytest.mark.parametrize("which", ["default", "principal", "serve"])
def test_shipped_objectives_equal_jax(which):
    t = {"default": lambda: default_objectives(),
         "principal": lambda: principal_objectives("tenant-a"),
         "serve": lambda: serve_objectives(64)}[which]()
    j = {"default": lambda: jdefault(),
         "principal": lambda: jprincipal("tenant-a"),
         "serve": lambda: jserve(64)}[which]()
    assert [dataclasses.asdict(o) for o in t] == \
        [dataclasses.asdict(o) for o in j]


def test_unknown_kind_raises_in_both():
    for cls in (SLObjective, JObjective):
        with pytest.raises(ValueError, match="unknown kind"):
            cls(name="x", kind="vibes")


def test_fleet_objectives_and_evaluation_equal_jax():
    from mosaic_tpu.obs.slo import evaluate_fleet as jevaluate_fleet
    from mosaic_tpu.obs.slo import fleet_objectives as jfleet
    assert [dataclasses.asdict(o) for o in slo.fleet_objectives()] == \
        [dataclasses.asdict(o) for o in jfleet()]
    ts, js = TimeSeriesStore(), JStore()
    for kind in sorted(OBJECTIVES):
        _feed(ts, kind, 3)
        _feed(js, kind, 3)
    objs = [SLObjective(**OBJECTIVES[k]) for k in sorted(OBJECTIVES)]
    jobjs = [JObjective(**OBJECTIVES[k]) for k in sorted(OBJECTIVES)]
    for now in (50.0, 100.0, 160.0):
        rows = slo.evaluate_fleet(ts, objectives=objs, now=now)
        assert rows == jevaluate_fleet(js, objectives=jobjs, now=now)
        assert len(rows) == len(objs)
    assert slo.evaluate_fleet(ts, now=100.0) == \
        jevaluate_fleet(js, now=100.0)
    # an objective whose series read fails is skipped, not raised
    assert slo.evaluate_fleet(object(), objectives=objs, now=1.0) == [] \
        == jevaluate_fleet(object(), objectives=jobjs, now=1.0)


def test_slo_dump_conf_writes_one_bundle_at_a_breach(planes, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("MOSAIC_TPU_DUMP_DIR", str(tmp_path))
    prev = tconfig.default_config()
    cfg = tconfig.apply_conf(prev, "mosaic.obs.slo.dump", "true")
    cfg = tconfig.apply_conf(cfg, "mosaic.obs.dump.cooldown.ms", "0")
    tconfig._default_config = cfg
    try:
        store = TimeSeriesStore()
        mon = SLOMonitor([SLObjective(**OBJECTIVES["gauge_max"])],
                         store=store)
        store.record("skew", 9.0, 99.0)
        assert [x["transition"] for x in mon.evaluate(now=100.0)] == \
            ["breach"]
        (path,) = tmp_path.glob("*_slo_skew.json")
        assert mon.evaluate(now=100.5) == []      # staying breached
        assert len(list(tmp_path.glob("*.json"))) == 1
        assert path.stat().st_size > 0
    finally:
        tconfig._default_config = prev
