"""The port's fleet aggregator (``obs.fleet``) against the JAX package's.

* Exactness: merging N spools — written in turns by the port and by the
  JAX package — gives counters, histogram buckets and p50/p95/p99
  bit-equal to one registry fed every sample, and both aggregators give
  the same view (seeds as in tests/test_fleet.py).
* Degrade paths: a torn spool, an alien version, a stale worker and a
  histogram scale mismatch mark the view and record the same
  ``fleet_merge_error`` / ``fleet_worker_stale`` events in both
  packages; stale workers keep their counters and lose their gauges.
* Fleet SLOs: the re-hydrated per-worker series sum their rates, and
  ``evaluate_fleet`` breaches on the sum as the JAX package's does.
* ``stitched_traces`` joins spans of different pids under one W3C trace
  id; the bundle carries them.
* A directory that holds one spool of each package gives equal views in
  both aggregators (pids and timestamps compared as sets).
* Operator surfaces: ``fleet_to_openmetrics``, the dashboard's fleet
  panel and ``tools/fleetctl_torch.py`` give what the JAX package's
  give.
"""

import json
import os
import random
import sys
import time

import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.dashboard import _fleet_payload as j_fleet_payload
from mosaic_tpu.obs.fleet import FleetAggregator as JFleetAggregator
from mosaic_tpu.obs.fleet import FleetStore as JFleetStore
from mosaic_tpu.obs.openmetrics import \
    fleet_to_openmetrics as j_fleet_to_openmetrics
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.obs.slo import SLObjective as JObjective
from mosaic_tpu.obs.slo import evaluate_fleet as jevaluate_fleet
from mosaic_tpu.obs.slo import monitor as jmonitor
from mosaic_tpu.obs.spool import spool_path as jspool_path
from mosaic_tpu.obs.spool import spool_snapshot as jspool_snapshot
from mosaic_tpu.obs.timeseries import timeseries as jts
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics, recorder
from mosaic_tpu_torch.obs.dashboard import _fleet_payload
from mosaic_tpu_torch.obs.fleet import (FleetAggregator, FleetStore,
                                        aggregator_for)
from mosaic_tpu_torch.obs.openmetrics import fleet_to_openmetrics
from mosaic_tpu_torch.obs.slo import SLObjective, evaluate_fleet, monitor
from mosaic_tpu_torch.obs.spool import (SpoolError, read_spool, spool_path,
                                        spool_snapshot, write_spool)
from mosaic_tpu_torch.obs.timeseries import Sampler, timeseries

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")

P = dict(metrics=metrics, rec=recorder, ts=timeseries, monitor=monitor,
         snapshot=spool_snapshot, path=spool_path, agg=FleetAggregator,
         store=FleetStore, obj=SLObjective, evaluate=evaluate_fleet)
J = dict(metrics=jmetrics, rec=jrec, ts=jts, monitor=jmonitor,
         snapshot=jspool_snapshot, path=jspool_path, agg=JFleetAggregator,
         store=JFleetStore, obj=JObjective, evaluate=jevaluate_fleet)


@pytest.fixture
def fleet_env():
    """Both packages' registries, recorders, series and monitors fresh,
    their configs restored after."""
    prev = tconfig.default_config(), jconfig.default_config()
    was = metrics.enabled, jmetrics.enabled, jrec.enabled
    for K in (P, J):
        K["metrics"].reset()
        K["metrics"].enable()
        K["rec"].reset()
        K["rec"].enable()
        K["ts"].reset()
        K["monitor"].reset()
    yield
    tconfig._default_config, jconfig._default_config = prev
    for K, w in ((P, was[0]), (J, was[1])):
        K["metrics"].reset()
        if not w:
            K["metrics"].disable()
        K["rec"].reset()
        K["ts"].reset()
        K["monitor"].reset()
    if not was[2]:
        jrec.disable()


def _write_worker(K, directory, pid, feed):
    """Spool one fabricated worker through package ``K``: reset its
    registry, run ``feed`` against it, snapshot through the real spool
    machinery, and write the file under the fabricated pid."""
    K["metrics"].reset()
    feed(K["metrics"])
    snap = K["snapshot"]()
    snap["pid"] = pid
    path = K["path"](str(directory), pid)
    os.makedirs(str(directory), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(snap, fh)
    return path


def _events(K, kind):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq", "trace")}
            for e in K["rec"].events(kind)]


def _both_scans(directory, now=None, **kw):
    now = time.time() if now is None else now
    tv = FleetAggregator(str(directory), **kw).scan(now=now)
    jv = JFleetAggregator(str(directory), **kw).scan(now=now)
    return tv, jv


# ------------------------------------------------- the exactness property

@pytest.mark.parametrize("seed", [11, 23, 47])
def test_merge_equals_single_registry(tmp_path, fleet_env, seed):
    """Aggregating N spools of both packages is indistinguishable from
    one registry that saw every sample, in either aggregator."""
    rng = random.Random(seed)
    n_workers = rng.randint(2, 5)
    hists = [("q/wall_ms", 1e-6), ("q/bytes", 1.0)]
    counters = ["sql/queries", "sql/errors", "serve/admitted"]
    all_samples = {n: [] for n, _ in hists}
    all_counts = {n: 0.0 for n in counters}
    for i in range(n_workers):
        samples = {n: [rng.lognormvariate(3.0, 2.0)
                       for _ in range(rng.randint(5, 200))]
                   for n, _ in hists}
        counts = {n: float(rng.randint(0, 50)) for n in counters}

        def feed(reg, samples=samples, counts=counts):
            for (name, scale) in hists:
                for v in samples[name]:
                    reg.observe(name, v, scale=scale)
            for name, v in counts.items():
                if v:
                    reg.count(name, v)

        _write_worker((P, J)[i % 2], tmp_path, 50_000 + i, feed)
        for n, _ in hists:
            all_samples[n].extend(samples[n])
        for n in counters:
            all_counts[n] += counts[n]

    view, jview = _both_scans(tmp_path)
    assert view.merge_errors == 0 and len(view.workers) == n_workers
    assert view.payload() == jview.payload()

    metrics.reset()                 # the oracle: one registry, every sample
    for name, scale in hists:
        for v in all_samples[name]:
            metrics.observe(name, v, scale=scale)
    for name, v in all_counts.items():
        if v:
            metrics.count(name, v)
    oracle = metrics.full_snapshot()
    for name, v in oracle["counters"].items():
        assert view.counters[name] == v          # bit-equal, not approx
    for name, _ in hists:
        want = metrics.histogram(name).snapshot()
        got = view.histograms[name].snapshot()
        assert got["count"] == want["count"]
        assert got["sum"] == pytest.approx(want["sum"], rel=1e-12)
        assert (got["min"], got["max"]) == (want["min"], want["max"])
        for q in ("p50", "p95", "p99"):
            assert got[q] == want[q], (name, q)
        assert view.histograms[name].counts == \
            metrics.histogram(name).counts


# ------------------------------------------------------- spool mechanics

def test_spool_roundtrip_and_unconfigured_noop(tmp_path, fleet_env):
    assert write_spool() is None          # no dir configured: no-op
    metrics.count("a/b", 3.0)
    metrics.observe("a/ms", 1.5)
    path = write_spool(str(tmp_path))
    snap = read_spool(path)
    assert snap["metrics"]["counters"]["a/b"] == 3.0
    assert metrics.counter_value("fleet/spool_writes") == 1.0
    view, jview = _both_scans(tmp_path)
    assert view.payload() == jview.payload()
    assert view.counters["a/b"] == 3.0
    assert view.histograms["a/ms"].count == 1


def test_spool_rides_sampler_tick(tmp_path, fleet_env):
    cfg = tconfig.apply_conf(tconfig.default_config(),
                             "mosaic.obs.fleet.dir", str(tmp_path))
    tconfig.set_default_config(cfg)
    metrics.count("tick/works")
    Sampler(1000.0, timeseries).tick(now=time.time())
    view = aggregator_for(str(tmp_path)).scan()
    assert view.counters["tick/works"] == 1.0
    assert [w.pid for w in view.workers] == [os.getpid()]
    assert view.payload()["counters"] == \
        JFleetAggregator(str(tmp_path)).scan(now=view.ts) \
        .payload()["counters"]


def test_torn_spool_degrades_not_raises(tmp_path, fleet_env):
    _write_worker(J, tmp_path, 50_001, lambda reg: reg.count("ok/seen", 7.0))
    torn = spool_path(str(tmp_path), 50_002)
    with open(torn, "w", encoding="utf-8") as fh:
        fh.write('{"version": 1, "pid": 50002, "metri')   # mid-write
    with pytest.raises(SpoolError):
        read_spool(torn)
    view, jview = _both_scans(tmp_path)
    assert view.payload() == jview.payload()
    assert view.merge_errors == 1
    assert view.counters["ok/seen"] == 7.0    # good worker still merged
    bad = [w for w in view.workers if w.pid == 50_002][0]
    assert not bad.readable and "torn" in bad.error
    assert _events(P, "fleet_merge_error") == \
        _events(J, "fleet_merge_error")
    assert _events(P, "fleet_merge_error")[-1]["pid"] == 50_002


def test_version_mismatch_degrades(tmp_path, fleet_env):
    path = _write_worker(P, tmp_path, 50_003,
                         lambda reg: reg.count("x/y", 1.0))
    snap = json.load(open(path))
    snap["version"] = 99
    json.dump(snap, open(path, "w"))
    view, jview = _both_scans(tmp_path)
    assert view.payload() == jview.payload()
    assert view.merge_errors == 1
    assert "version" in view.workers[0].error
    assert view.counters == {}


def test_stale_worker_flagged_once_counters_kept(tmp_path, fleet_env):
    fresh = _write_worker(
        P, tmp_path, 50_010, lambda reg: (reg.count("work/done", 2.0),
                                          reg.gauge("q/depth", 3.0)))
    stale = _write_worker(
        J, tmp_path, 50_011, lambda reg: (reg.count("work/done", 5.0),
                                          reg.gauge("q/depth", 9.0)))
    old = time.time() - 3600.0
    os.utime(stale, (old, old))
    os.utime(fresh, None)
    for K in (P, J):
        agg = K["agg"](str(tmp_path), stale_ms=5_000.0)
        view = agg.scan()
        by_pid = {w.pid: w for w in view.workers}
        assert by_pid[50_011].stale and not by_pid[50_010].stale
        assert view.counters["work/done"] == 7.0   # stale counters kept
        assert view.gauges["q/depth"] == {"value": 3.0, "worker": 50_010}
        agg.scan()
        agg.scan()
    evs = _events(P, "fleet_worker_stale")
    assert [e["pid"] for e in evs] == [50_011]      # once a transition
    assert [(e["pid"], e["path"]) for e in evs] == \
        [(e["pid"], e["path"]) for e in _events(J, "fleet_worker_stale")]


def test_histogram_scale_mismatch_skipped(tmp_path, fleet_env):
    _write_worker(P, tmp_path, 50_020,
                  lambda reg: reg.observe("h/ms", 5.0, scale=1e-6))
    _write_worker(J, tmp_path, 50_021,
                  lambda reg: reg.observe("h/ms", 5.0, scale=1.0))
    view, jview = _both_scans(tmp_path)
    assert view.payload() == jview.payload()
    assert view.merge_errors == 1
    assert view.histograms["h/ms"].count == 1
    assert "scale" in _events(P, "fleet_merge_error")[-1]["why"]
    assert _events(P, "fleet_merge_error") == \
        _events(J, "fleet_merge_error")


# --------------------------------------------------- series + fleet SLO

def test_fleet_rates_sum_and_slo_evaluates(tmp_path, fleet_env):
    """Counter rate over the fleet = sum of per-worker rates, and a
    counter_rate objective breaches on the sum though every worker is
    under its ceiling alone — in both packages, on one directory."""
    now = time.time()
    per_worker_rate = 1.5
    for i, pid in enumerate((50_030, 50_031, 50_032)):
        K = (P, J)[i % 2]
        K["ts"].reset()
        for k in range(7):
            t = now - 60.0 + k * 10.0
            K["ts"].record("sql/queries",
                           per_worker_rate * (60.0 - (now - t)), t)
        _write_worker(K, tmp_path, pid,
                      lambda reg: reg.count("sql/queries",
                                            per_worker_rate * 60.0))
        K["ts"].reset()
    rows = {}
    for name, K in (("port", P), ("jax", J)):
        agg = K["agg"](str(tmp_path))
        store = agg.fleet_store(agg.scan(now=now))
        assert isinstance(store, K["store"])
        assert store.rate("sql/queries", 60.0, now) == \
            pytest.approx(3 * per_worker_rate, rel=0.05)
        obj = K["obj"](name="rate_fleet", kind="counter_rate",
                       series="sql/queries", max_rate=2.0,
                       windows=(60.0, 60.0))
        one = K["store"]({50_030: {
            "sql/queries": store._workers[50_030]["sql/queries"]}})
        rows[name] = (K["evaluate"](store, objectives=[obj], now=now),
                      K["evaluate"](one, objectives=[obj], now=now),
                      agg.evaluate_slo(objectives=[obj], now=now))
    assert rows["port"] == rows["jax"]
    fleet, solo, via_agg = rows["port"]
    assert fleet[0]["breached"] and not solo[0]["breached"]
    assert via_agg == fleet


# --------------------------------------------------- stitched traces

def test_stitched_traces_across_pids(tmp_path, fleet_env):
    w3c = "0af7651916cd43dd8448eb211c80319c"

    def feed_client(reg):
        recorder.reset()
        recorder.record("trace_link", trace="t50040-00001",
                        w3c_trace=w3c, w3c_parent="b7ad6b7169203331",
                        name="client:load")
        recorder.record("span", trace="t50040-00001",
                        name="client/request", span="s1", parent=None,
                        dur_s=0.2)

    def feed_server(reg):
        jrec.reset()
        jrec.record("trace_link", trace="t50041-00007",
                    w3c_trace=w3c, w3c_parent="b7ad6b7169203331",
                    name="sql:SELECT 1")
        jrec.record("span", trace="t50041-00007", name="sql/query",
                    span="s2", parent=None, dur_s=0.1)
        jrec.record("span", trace="t99999-00001", name="unlinked/other",
                    span="s3", parent=None, dur_s=0.1)

    _write_worker(P, tmp_path, 50_040, feed_client)
    _write_worker(J, tmp_path, 50_041, feed_server)
    agg, jagg = FleetAggregator(str(tmp_path)), JFleetAggregator(
        str(tmp_path))
    traces = agg.stitched_traces()
    assert traces == jagg.stitched_traces()
    assert set(traces) == {w3c}
    tree = traces[w3c]
    assert sorted(tree["workers"]) == [50_040, 50_041]
    assert {s["name"] for s in tree["spans"]} == {"client/request",
                                                  "sql/query"}
    bundle = agg.bundle()
    assert bundle["reason"] == "fleet" and w3c in bundle["traces"]
    assert set(bundle["events_by_worker"]) == {50_040, 50_041}
    jb = jagg.bundle(jagg.scan(now=bundle["ts"]))
    assert {k: v for k, v in bundle.items() if k != "fleet"} == \
        {k: v for k, v in jb.items() if k != "fleet"}


def test_one_spool_of_each_package_merges_alike(tmp_path, fleet_env):
    """Real spools (this process's pid in turn) written by each package
    through ``write_spool``: equal views, pids and timestamps compared
    as sets."""
    from mosaic_tpu.obs.spool import write_spool as jwrite_spool
    for K, w, sub in ((P, write_spool, "a"), (J, jwrite_spool, "b")):
        K["metrics"].count("sql/queries", 3.0)
        K["metrics"].gauge("mem/pressure", 0.25)
        for v in (1.5, 20.0, 300.0):
            K["metrics"].observe("sql/query_ms", v, scale=1e-3)
        K["ts"].record("sql/query_ms", 20.0, time.time())
        w(str(tmp_path / sub))
    # one directory, the two pids apart: rename the JAX package's
    os.makedirs(tmp_path / "mixed")
    os.replace(spool_path(str(tmp_path / "a")),
               spool_path(str(tmp_path / "mixed"), 60_001))
    os.replace(jspool_path(str(tmp_path / "b")),
               spool_path(str(tmp_path / "mixed"), 60_002))
    view, jview = _both_scans(tmp_path / "mixed")
    a, b = view.payload(), jview.payload()
    assert {(w["pid"], w["ts"]) for w in a["workers"]} == \
        {(w["pid"], w["ts"]) for w in b["workers"]}
    assert {k: v for k, v in a.items() if k != "workers"} == \
        {k: v for k, v in b.items() if k != "workers"}
    assert a["counters"]["sql/queries"] == 6.0
    assert a["histograms"]["sql/query_ms"]["count"] == 6
    assert fleet_to_openmetrics(view) == j_fleet_to_openmetrics(jview)


# --------------------------------------------- operator surfaces

def _fleetctl(name):
    sys.path.insert(0, _TOOLS)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_fleetctl_openmetrics_and_dashboard(tmp_path, fleet_env, capsys):
    path = _write_worker(P, tmp_path, 50_050,
                         lambda reg: (reg.count("serve/admitted", 4.0),
                                      reg.observe("q/ms", 2.5)))
    future = time.time() + 3600.0           # age 0.00 for both tools
    os.utime(path, (future, future))
    metrics.reset()
    view, jview = _both_scans(tmp_path)
    text = fleet_to_openmetrics(view)
    assert text == j_fleet_to_openmetrics(jview)
    assert 'worker="50050"' in text and "mosaic_fleet_workers 1" in text
    assert text.endswith("# EOF\n")

    fleetctl, fleetctl_torch = _fleetctl("fleetctl"), \
        _fleetctl("fleetctl_torch")
    outs = {}
    for argv in (["list"], ["alerts"], ["alerts", "--all"], ["metrics"],
                 ["traces"]):
        rt = fleetctl_torch.main(["--dir", str(tmp_path)] + argv)
        out_t = capsys.readouterr()
        rj = fleetctl.main(["--dir", str(tmp_path)] + argv)
        out_j = capsys.readouterr()
        assert (rt, out_t.out, out_t.err) == (rj, out_j.out, out_j.err)
        assert rt == 0
        outs[" ".join(argv)] = out_t.out
    assert "50050" in outs["list"] and "fresh" in outs["list"]
    assert outs["metrics"] == text
    for tool, out in ((fleetctl_torch, "t.json"), (fleetctl, "j.json")):
        assert tool.main(["--dir", str(tmp_path), "bundle",
                          "--out", str(tmp_path / out)]) == 0
    capsys.readouterr()
    bt, bj = (json.load(open(tmp_path / o)) for o in ("t.json", "j.json"))
    assert bt["reason"] == "fleet"
    assert bt["traces"] == bj["traces"] and \
        bt["events_by_worker"] == bj["events_by_worker"]
    empty = tmp_path / "nothing"
    empty.mkdir()
    assert fleetctl_torch.main(["--dir", str(empty), "list"]) == \
        fleetctl.main(["--dir", str(empty), "list"]) == 1
    capsys.readouterr()

    assert _fleet_payload({}) == j_fleet_payload({}) == {"enabled": False}
    payload = _fleet_payload({"dir": [str(tmp_path)]})
    jpayload = j_fleet_payload({"dir": [str(tmp_path)]})
    assert payload["enabled"]
    assert payload["fleet"]["counters"]["serve/admitted"] == 4.0
    for p in (payload, jpayload):
        p["fleet"].pop("ts")
    assert payload == jpayload


def test_aggregator_for_is_cached(tmp_path, fleet_env):
    a = aggregator_for(str(tmp_path))
    assert aggregator_for(str(tmp_path)) is a
    assert isinstance(a, FleetAggregator)
