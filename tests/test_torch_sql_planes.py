"""The host-plane cases that waited for the port's SQL engine, each run
through both packages and held equal.

* tests/test_resilience.py::test_sql_set_statement_updates_default_config;
* tests/test_recorder.py's SQL cases: the slow-query dump
  (``mosaic.obs.slow.query.ms``) and no dump without the threshold, two
  interleaved queries' distinct trace trees, EXPLAIN ANALYZE rows as
  trace spans (the port has no Chrome-trace exporter yet, ROADMAP §A9c,
  so the trees are read from ``tracer.report()``);
* tests/test_refine.py::test_explain_analyze_refine_column;
* tests/test_chaos.py's ``planner.stats.load`` cold start and the
  ``fusion.group`` stall, each package armed through its own
  ``faults.arm`` with the same spec;
* tests/test_memwatch.py::test_fused_query_books_balance and
  ``::test_interleaved_queries_disjoint_attribution`` (two concurrent
  accounted streams, each query's ``mem_peak_bytes`` its own);
* the SQL objectives of ``obs/slo.py``: the engine feeds ``sql/queries``,
  ``sql/errors`` (unexpected failures only) and the ``sql/query_ms``
  series, and ``sql_latency`` and ``sql_errors`` evaluate alike.
"""

import json
import threading

import numpy as np
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.functions.context import MosaicContext as JContext
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs import recorder as jrecorder
from mosaic_tpu.obs import tracer as jtracer
from mosaic_tpu.resilience import faults as jfaults
from mosaic_tpu.sql import SQLSession as JSession
from mosaic_tpu.sql.engine import SQLError as JSQLError
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.functions.context import MosaicContext as TContext
from mosaic_tpu_torch.obs import metrics, recorder, tracer
from mosaic_tpu_torch.resilience import faults
from mosaic_tpu_torch.sql import SQLSession
from mosaic_tpu_torch.sql.engine import SQLError

GRID = "CUSTOM(-180,180,-90,90,2,360,180)"
PKGS = ("jax", "torch")


def _mods(pkg):
    """(config, SQLSession, metrics, recorder, tracer, faults, SQLError)
    of one package."""
    if pkg == "jax":
        return (jconfig, JSession, jmetrics, jrecorder, jtracer, jfaults,
                JSQLError)
    return tconfig, SQLSession, metrics, recorder, tracer, faults, SQLError


@pytest.fixture(scope="module")
def mcs():
    return {"jax": JContext.build(GRID),
            "torch": TContext.build(GRID, device="cpu")}


@pytest.fixture(autouse=True)
def clean():
    """Both packages' configs, recorders, tracers and fault plans fresh
    and restored."""
    prev = jconfig.default_config(), tconfig.default_config()
    jf, tf = jfaults.active(), faults.active()
    for rec in (jrecorder, recorder):
        rec.reset()
        rec.enable()
    yield
    jconfig.set_default_config(prev[0])
    tconfig.set_default_config(prev[1])
    for f, p in ((jfaults, jf), (faults, tf)):
        if p is None:
            f.disarm()
        else:
            f.arm(p)
    for tr in (jtracer, tracer):
        tr.disable()
        tr.reset()
    for rec in (jrecorder, recorder):
        rec.reset()


def _session(mcs, pkg):
    s = _mods(pkg)[1](mcs[pkg])
    s.create_table("pts", {"x": np.arange(100.0),
                           "y": np.arange(100.0) / 10.0})
    return s


def _set(pkg, key, value):
    m = _mods(pkg)[0]
    m.set_default_config(m.apply_conf(m.default_config(), key, value))


# ------------------------------------------------------------- SET

def test_sql_set_statement_updates_default_config(mcs):
    got = []
    for pkg in PKGS:
        conf, Session, *_, Err = _mods(pkg)
        s = Session(mcs[pkg])
        out = s.sql("SET mosaic.raster.blocksize = 256")
        assert out.columns["key"] == ["mosaic.raster.blocksize"]
        assert conf.default_config().raster_blocksize == 256
        msgs = []
        for q, match in (("SET mosaic.raster.blocksize = banana",
                          "mosaic.raster.blocksize"),
                         ("SET mosaic.raster.blocksized = 128",
                          "unknown conf key")):
            with pytest.raises(Err, match=match) as e:
                s.sql(q)
            msgs.append(str(e.value).split(" (known:")[0])
        # the SQL engine's own keys go through SET too
        s.sql("SET mosaic.fusion.max.ops = 3")
        assert conf.default_config().fusion_max_ops == 3
        got.append((out.to_dict(), msgs))
    assert got[0] == got[1]


# --------------------------------------------------- slow-query dump

@pytest.mark.parametrize("pkg", PKGS)
def test_slow_query_triggers_dump(mcs, pkg, tmp_path, monkeypatch):
    conf, _, _, rec, tr, *_ = _mods(pkg)
    tr.enable()
    monkeypatch.setenv("MOSAIC_TPU_DUMP_DIR", str(tmp_path))
    s = _session(mcs, pkg)
    _set(pkg, "mosaic.obs.slow.query.ms", "0.0001")
    s.sql("SELECT x FROM pts WHERE y > 1.0")
    dumps = list(tmp_path.glob("*_slow_query.json"))
    assert len(dumps) == 1
    b = json.loads(dumps[0].read_text())
    (sq,) = [e for e in b["events"] if e["kind"] == "slow_query"]
    assert sq["ms"] > sq["threshold_ms"] == 0.0001
    assert sq["query"].startswith("SELECT x FROM pts")
    q_spans = [e for e in b["events"]
               if e["kind"] == "span" and e.get("trace") == sq["trace"]]
    assert any(e["name"] == "sql/query" for e in q_spans)
    (ev,) = [e for e in b["events"] if e["kind"] == "sql"]
    assert ev["query"] == "SELECT x FROM pts WHERE y > 1.0"


@pytest.mark.parametrize("pkg", PKGS)
def test_no_dump_when_threshold_unset(mcs, pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("MOSAIC_TPU_DUMP_DIR", str(tmp_path))
    _session(mcs, pkg).sql("SELECT x FROM pts")
    assert list(tmp_path.glob("*.json")) == []


# ------------------------------------------------------ trace trees

def _trees(mcs, pkg):
    *_, tr, _, _ = _mods(pkg)
    tr.enable()
    s = _session(mcs, pkg)
    barrier = threading.Barrier(2, timeout=30)
    results = {}

    def run(tag, query):
        barrier.wait()
        results[tag] = s.sql(query)

    ts = [threading.Thread(target=run,
                           args=("a", "SELECT x FROM pts WHERE y > 1.0")),
          threading.Thread(target=run,
                           args=("b", "SELECT y FROM pts ORDER BY y DESC"))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(results["a"]) == 89 and len(results["b"]) == 100
    traces = {tid: t for tid, t in tr.report()["traces"].items()
              if t["name"].startswith("sql:")}
    assert len(traces) == 2
    shapes = []
    for t in traces.values():
        by_name = {s["name"]: s for s in t["spans"]}
        root = by_name["sql/query"]
        assert root["parent_id"] is None
        stages = [s for n, s in by_name.items()
                  if n.startswith("sql/query/")]
        assert stages, t
        assert all(s["parent_id"] == root["span_id"] for s in stages)
        shapes.append((t["name"], sorted(by_name)))
    ids_a, ids_b = [set(s["span_id"] for s in t["spans"])
                    for t in traces.values()]
    assert not (ids_a & ids_b)
    return sorted(shapes)


def test_interleaved_queries_get_distinct_trace_trees(mcs):
    assert _trees(mcs, "torch") == _trees(mcs, "jax")


def test_explain_analyze_rows_are_trace_spans(mcs):
    got = []
    for pkg in PKGS:
        tr = _mods(pkg)[4]
        tr.enable()
        out = _session(mcs, pkg).sql(
            "EXPLAIN ANALYZE SELECT x FROM pts WHERE y > 5.0")
        ops = list(out.columns["operator"])
        (trace,) = [t for t in tr.report()["traces"].values()
                    if t["name"].startswith("sql:EXPLAIN")]
        span_names = {s["name"] for s in trace["spans"]}
        for op in ops:
            assert f"sql/query/{op}" in span_names
        got.append(ops)
    assert got[0] == got[1]


# ------------------------------------------------------- refine column

def test_explain_analyze_refine_column(mcs):
    got = []
    for pkg in PKGS:
        if pkg == "jax":
            from mosaic_tpu.obs.inflight import note_refine, ticket_observer
        else:
            from mosaic_tpu_torch.obs.inflight import (note_refine,
                                                       ticket_observer)
        s = _mods(pkg)[1](mcs[pkg])
        rng = np.random.default_rng(8)
        s.create_table("rpts", {"cell": rng.integers(0, 20, 500),
                                "v": rng.normal(size=500)})
        s.create_table("rz", {"index_id": np.arange(20)})
        q = "SELECT count(*) FROM rpts JOIN rz ON rpts.cell = rz.index_id"
        plan = s.sql("EXPLAIN " + q).to_dict()
        assert all(r == "-" for r in plan["refine"])

        def obs(tkt):
            note_refine({"cells_refined": 2, "cells_flat": 3},
                        summary="L5+1: 2 refined / 3 flat cells")
        with ticket_observer(obs):
            out = s.sql("EXPLAIN ANALYZE " + q).to_dict()
        assert any("L5+1" in r for r in out["refine"])
        got.append((plan["refine"], out["refine"], out["operator"],
                    out["rows"].tolist()))
    assert got[0] == got[1]


# ------------------------------------------------------------- chaos

def test_planner_stats_load_transient_io_cold_start(tmp_path):
    """An injected read failure on ``planner.stats.load`` degrades to a
    cold start; once spent, the same file warm-starts a fresh planner.
    The file is the JAX planner's, loaded by both."""
    from mosaic_tpu.sql.planner import Planner as JPlanner
    from mosaic_tpu_torch.sql.planner import Planner as TPlanner
    path = str(tmp_path / "stats.json")
    p = JPlanner()
    p.observe_op("pip_join/streamed/c16", 32768, 0.050, rows_out=900)
    assert p.save(path) == path
    spec = "seed=41;site=planner.stats.load,fails=1,error=OSError"
    for f, Planner in ((jfaults, JPlanner), (faults, TPlanner)):
        plan = f.arm(spec)
        p2 = Planner()
        assert p2.load(path) is False
        assert p2.ms_per_row("pip_join/streamed/c16", 32768) is None
        assert ("planner.stats.load", 0, "OSError") in plan.injected
        p3 = Planner()
        assert p3.load(path) is True
        assert p3.ms_per_row("pip_join/streamed/c16", 32768) == \
            pytest.approx(0.050 * 1e3 / 32768)
        f.disarm()
    assert [e["kind"] for e in recorder.events()
            if e["kind"].startswith("planner_stats")] == \
        [e["kind"] for e in jrecorder.events()
         if e["kind"].startswith("planner_stats")] == \
        ["planner_stats_corrupt", "planner_stats_loaded"]


def test_fusion_group_stall_keeps_parity(mcs):
    q = "SELECT sum(k) AS t, count(*) AS n FROM cx WHERE k < 50"
    got = []
    for pkg in PKGS:
        _, Session, _, _, _, f, _ = _mods(pkg)
        s = Session(mcs[pkg])
        rng = np.random.default_rng(11)
        s.create_table("cx", {"px": rng.normal(size=256),
                              "k": rng.integers(0, 100, size=256)})
        _set(pkg, "mosaic.planner.force.fusion", "on")
        plan = f.arm("seed=42;site=fusion.group,mode=delay,fails=1,"
                     "delay_ms=1")
        fused = s.sql(q)
        assert ("fusion.group", 0, "delay") in plan.injected
        f.disarm()
        _set(pkg, "mosaic.planner.force.fusion", "off")
        unfused = s.sql(q)
        assert np.array_equal(np.asarray(fused.columns["t"]),
                              np.asarray(unfused.columns["t"]))
        got.append(fused.columns["t"].tolist())
    assert got[0] == got[1]


# ------------------------------------------------------------ memory

@pytest.fixture
def mem():
    """Both ledgers, registries and meters fresh; restored after."""
    from mosaic_tpu.obs.accounting import audit as jaudit
    from mosaic_tpu.obs.accounting import meter as jmeter
    from mosaic_tpu.obs.memwatch import memwatch as jmw
    from mosaic_tpu_torch.obs.accounting import audit, meter
    from mosaic_tpu_torch.obs.memwatch import memwatch
    was = metrics.enabled, jmetrics.enabled
    keep = (memwatch, jmw, audit, jaudit, meter, jmeter)
    for reg in (metrics, jmetrics):
        reg.reset()
        reg.enable()
    for x in keep:
        x.reset()
    yield {"jax": jmw, "torch": memwatch}
    for reg, w in ((metrics, was[0]), (jmetrics, was[1])):
        reg.reset()
        if not w:
            reg.disable()
    for x in keep:
        x.reset()


def test_fused_query_books_balance(mcs, mem):
    got = []
    for pkg in PKGS:
        mw = mem[pkg]
        reg = _mods(pkg)[2]
        s = _mods(pkg)[1](mcs[pkg])
        rng = np.random.default_rng(3)
        s.create_table("pts", {"x": rng.uniform(0, 100, 2000),
                               "y": rng.uniform(0, 1, 2000)})
        _set(pkg, "mosaic.planner.force.fusion", "on")
        out = s.sql("SELECT count(*) AS n FROM pts WHERE x < 50 AND "
                    "y > 0.5")
        assert len(out) == 1
        assert reg.counter_value("fusion/groups") >= 1
        snap = mw.snapshot()
        t = snap["totals"]
        assert mw.total_live() == 0 and mw.live_buffers() == 0
        assert t["registered"] == t["released"] >= 1
        assert any(site.startswith("fusion/")
                   for site in snap["site_peak_bytes"])
        assert mw.leak_count() == 0
        got.append(out.columns["n"].tolist())
    assert got[0] == got[1]


def _torch_stream(data, chunk):
    import torch
    from mosaic_tpu_torch.perf.pipeline import chunk_rows, stream
    out = []

    def stage(sl, buf):
        buf[:, 0] = data[sl]

    stream(chunk_rows(len(data), chunk), stage, 1,
           lambda i, x: (x[:, 0] * 2.0,),
           lambda i, sl, host: out.append(host[0].copy()),
           torch.device("cpu"))
    return np.concatenate(out)


def _jax_stream(data, chunk):
    import jax
    import jax.numpy as jnp
    from mosaic_tpu.perf.pipeline import chunk_rows, stream
    fn = jax.jit(lambda x: x * 2.0)
    out = stream(chunk_rows(len(data), chunk), compute=fn,
                 put=lambda sl: jax.device_put(jnp.asarray(data[sl])),
                 consume=lambda i, sl, host: np.asarray(host))
    return np.concatenate(out)


@pytest.mark.parametrize("pkg", PKGS)
def test_interleaved_queries_disjoint_attribution(mem, pkg):
    """Two concurrent accounted streams: the small query's recorded peak
    stays below even ONE of the big query's chunks (cross-charging would
    blow past it); each query's ``mem_peak_bytes`` is its own."""
    if pkg == "jax":
        from mosaic_tpu.obs.accounting import accounted, audit
        run_stream, item = _jax_stream, 8          # float64 chunks
    else:
        from mosaic_tpu_torch.obs.accounting import accounted, audit
        run_stream, item = _torch_stream, 4        # float32 staging
    small = np.arange(512, dtype=np.float64)
    big = np.arange(65536, dtype=np.float64)
    barrier = threading.Barrier(2)
    errs, outs = [], {}

    def run(name, data, chunk):
        try:
            barrier.wait(timeout=10)
            with accounted(name, principal=name):
                outs[name] = run_stream(data, chunk)
        except Exception as e:
            errs.append(e)

    ts = [threading.Thread(target=run, args=("small", small, 128)),
          threading.Thread(target=run, args=("big", big, 16384))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs
    assert np.array_equal(outs["big"], big * 2.0)
    recs = {r["principal"]: r for r in audit.records()}
    big_chunk_bytes = 16384 * item
    assert recs["big"]["cost"]["mem_peak_bytes"] >= big_chunk_bytes
    assert 0 < recs["small"]["cost"]["mem_peak_bytes"] < big_chunk_bytes
    assert recs["small"]["trace"] != recs["big"]["trace"]
    assert mem[pkg].total_live() == 0
    assert mem[pkg].leak_count() == 0


# ----------------------------------------------------- SQL objectives

def test_sql_objectives_see_the_engine(mcs, mem):
    """The engine feeds the SQL objectives' series: every query counts
    in ``sql/queries``, an unexpected failure (a function raising) in
    ``sql/errors`` and a user mistake (an SQLError) in neither errors
    nor the latency series; ``sql_latency`` and ``sql_errors`` evaluate
    alike in both packages."""
    from mosaic_tpu.obs.slo import default_objectives as jobjectives
    from mosaic_tpu.obs.timeseries import timeseries as jts
    from mosaic_tpu_torch.obs.slo import default_objectives
    from mosaic_tpu_torch.obs.timeseries import timeseries as tts
    got = []
    for pkg, store, objectives in (("jax", jts, jobjectives),
                                   ("torch", tts, default_objectives)):
        _, Session, reg, *_, Err = _mods(pkg)
        store.reset()
        s = Session(mcs[pkg])
        s.create_table("w", {"s": ["NOT A WKT"], "v": np.ones(1)})
        for _ in range(4):
            s.sql("SELECT v FROM w WHERE v > 0.5")
        with pytest.raises(ValueError):
            s.sql("SELECT st_geomfromwkt(s) AS g FROM w")
        with pytest.raises(Err):
            s.sql("SELECT nope FROM w")
        series = store.series("sql/query_ms")
        objs = {o.name: o for o in objectives()}
        lat = objs["sql_latency"].evaluate(store)
        got.append((reg.counter_value("sql/queries"),
                    reg.counter_value("sql/errors"), len(series),
                    lat["breached"], lat["short"],
                    (objs["sql_errors"].bad, objs["sql_errors"].total)))
        store.reset()
    assert got[0] == got[1]
    assert got[1][:3] == (6, 1, 4)
