"""The port's exporters (``obs.openmetrics``, ``obs.chrometrace``,
``utils.trace``) and ops dashboard (``obs.dashboard``) against the JAX
package's.

* OpenMetrics: for equal registry contents — counters, gauges,
  histograms, per-principal families with hostile labels, the planner's
  series — the two packages' expositions are the same string, and
  ``metrics.to_openmetrics()`` renders through the exporter;
  ``serve_metrics`` scrapes live values and its handle stops.
* Chrome trace: the host spans export as Perfetto-loadable JSON with one
  lane per (trace, thread), as the JAX package's; the process label
  names the port (ROADMAP C14).  ``utils.trace`` re-exports the obs
  singletons.
* Dashboard: every route of tests/test_slo.py, tests/test_profiler.py,
  tests/test_accounting.py and tests/test_memwatch.py answers on the
  port's ``sql.SQLSession`` and planes (``Cache-Control: no-store`` on
  JSON, a JSON 404 for an unknown ``/api/*`` path, a 405 for a GET
  cancel); a POST cancel stops a live query; the server panel equals
  the JAX package's with no server up and with a server of each package
  up; a leak shows in the exposition and on the memory route as in the
  JAX package.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.bench.workloads import build_workload as jbuild_workload
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs import tracer as jtracer
from mosaic_tpu.obs.accounting import accounted as jaccounted
from mosaic_tpu.obs.accounting import audit as jaudit
from mosaic_tpu.obs.accounting import meter as jmeter
from mosaic_tpu.obs.chrometrace import \
    chrome_trace_events as j_chrome_trace_events
from mosaic_tpu.obs.dashboard import _memory_payload as j_memory_payload
from mosaic_tpu.obs.memwatch import memwatch as jmw
from mosaic_tpu.obs.openmetrics import to_openmetrics as j_to_openmetrics
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.resilience import faults as jfaults
from mosaic_tpu.serve import QueryServer as JQueryServer
from mosaic_tpu.sql.planner import Decision as JDecision
from mosaic_tpu.sql.planner import planner as jplanner
import mosaic_tpu_torch as mt
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.functions.context import MosaicContext
from mosaic_tpu_torch.obs import (accounted, audit, chrome_trace_events,
                                  export_chrome_trace, ledger, memwatch,
                                  meter, metrics, recorder, serve_dashboard,
                                  serve_metrics, start_profiler,
                                  stop_profiler, timeseries, to_openmetrics,
                                  tracer)
from mosaic_tpu_torch.obs.inflight import QueryCancelled
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.resilience import faults
from mosaic_tpu_torch.serve import QueryServer
from mosaic_tpu_torch.sql import SQLSession
from mosaic_tpu_torch.sql.planner import Decision, planner

GRID = "CUSTOM(-180,180,-90,90,2,360,180)"


@pytest.fixture
def planes():
    """Both packages' registries, recorders, tracers, meters, audit logs
    and ledgers fresh, no fault plan armed; restored after."""
    prev = tconfig.default_config(), jconfig.default_config()
    was = metrics.enabled, jmetrics.enabled, jrec.enabled
    jf, tf = jfaults.active(), faults.active()
    faults.disarm()
    jfaults.disarm()
    for x in (metrics, jmetrics, recorder, jrec, meter, jmeter, audit,
              jaudit, memwatch, jmw, ledger, timeseries):
        x.reset()
    for x in (metrics, jmetrics, recorder, jrec):
        x.enable()
    yield
    tconfig._default_config, jconfig._default_config = prev
    for f, p in ((jfaults, jf), (faults, tf)):
        if p is None:
            f.disarm()
        else:
            f.arm(p)
    for x in (meter, jmeter, audit, jaudit, memwatch, jmw, ledger,
              timeseries, recorder, jrec):
        x.reset()
    for reg, w in ((metrics, was[0]), (jmetrics, was[1])):
        reg.reset()
        if not w:
            reg.disable()
    if not was[2]:
        jrec.disable()
    for tr in (tracer, jtracer):
        tr.disable()
        tr.reset()


@pytest.fixture(scope="module")
def ctx():
    return MosaicContext.build(GRID, device="cpu")


@pytest.fixture
def session(ctx, planes):
    s = SQLSession(ctx)
    s.create_table("pts", {"x": np.arange(100.0),
                           "y": np.arange(100.0) / 10.0})
    return s


def _jax_session():
    from mosaic_tpu.functions.context import MosaicContext as JContext
    from mosaic_tpu.sql import SQLSession as JSession
    s = JSession(JContext("H3"))
    s.create_table("pts", {"x": np.arange(100.0),
                           "y": np.arange(100.0) / 10.0})
    return s


def _shape(payload):
    """The nested key structure of a JSON payload."""
    if isinstance(payload, dict):
        return {k: _shape(v) for k, v in payload.items()}
    return type(payload).__name__


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        assert r.status == 200
        return r.read().decode("utf-8")


def _req(base, path, method="GET"):
    req = urllib.request.Request(base + path, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _feed_both(fn):
    for reg in (metrics, jmetrics):
        fn(reg)


# ------------------------------------------------------------ OpenMetrics

def test_to_openmetrics_exposition(planes):
    def feed(reg):
        reg.count("io/records_dropped", 3)
        reg.gauge("shard/skew/pip_join", 1.25)
        for v in (0.001, 0.002, 0.004):
            reg.observe("sql/scan_s", v)
        reg.observe("mem/bytes", 3e9, scale=1.0)
        reg.gauge("odd-name.with:chars", float("inf"))
        reg.count("9starts/with/digit", 0.1)
    _feed_both(feed)
    txt = to_openmetrics()
    assert txt == j_to_openmetrics() == metrics.to_openmetrics()
    assert txt.endswith("# EOF\n")
    assert "mosaic_io_records_dropped_total 3" in txt
    assert "mosaic_shard_skew_pip_join 1.25" in txt
    assert 'mosaic_sql_scan_s_bucket{le="+Inf"} 3' in txt
    cums = [int(line.rsplit(" ", 1)[1]) for line in txt.splitlines()
            if line.startswith("mosaic_sql_scan_s_bucket")]
    assert cums == sorted(cums) and cums[-1] == 3
    assert "mosaic__9starts_with_digit_total 0.1" in txt


def test_openmetrics_roundtrip_through_scrape(planes):
    metrics.count("sql/queries", 2)
    metrics.observe("sql/project_s", 0.01)
    server = serve_metrics(port=0)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            body = r.read().decode("utf-8")
        assert body == to_openmetrics()
        assert "mosaic_sql_queries_total 2" in body
        assert "mosaic_sql_project_s_sum 0.01" in body
        metrics.count("sql/queries", 1)           # scrapes see live values
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert "mosaic_sql_queries_total 3" in r.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
    finally:
        server.shutdown()
        server.server_close()


def test_serve_metrics_handle_start_scrape_stop(planes):
    metrics.count("handle/test", 7)
    handle = serve_metrics(port=0)
    try:
        assert handle.port > 0
        body = _get(f"http://127.0.0.1:{handle.port}/metrics")
        assert "mosaic_handle_test_total 7" in body
    finally:
        handle.close()
    handle.close()                            # idempotent
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{handle.port}/metrics",
                               timeout=2)


def test_openmetrics_escapes_hostile_principal_label(planes):
    hostile = 'evil"name\nwith\\stuff'
    meter.charge(hostile, {"wall_ms": 5.0})
    jmeter.charge(hostile, {"wall_ms": 5.0})
    txt = to_openmetrics()
    assert txt == j_to_openmetrics()
    assert 'mosaic_principal_queries_total{principal=' \
        '"evil\\"name\\nwith\\\\stuff"} 1' in txt
    assert [ln for ln in txt.splitlines()
            if ln.startswith("# HELP mosaic_principal_")]


def test_openmetrics_principal_series_share_one_family(planes):
    for m in (meter, jmeter):
        m.charge("a", {"wall_ms": 1.0})
        m.charge("b", {"wall_ms": 2.0, "compiles": 0.0})
    txt = to_openmetrics()
    assert txt == j_to_openmetrics()
    fam = [ln for ln in txt.splitlines()
           if ln.startswith("mosaic_principal_queries_total{")]
    assert len(fam) == 2
    assert txt.count("# TYPE mosaic_principal_queries_total") == 1
    assert 'mosaic_principal_compiles_total{principal="a"} 0' in txt


def test_planner_metrics_in_openmetrics(planes):
    for pl, D in ((planner, Decision), (jplanner, JDecision)):
        pl.reset()
        pl.record_decision(D("pip_join", "streamed", "test", 100,
                             key_n=100))
        pl.observe_estimate("pip_join", 100, 90)
    try:
        text = to_openmetrics()
        assert "mosaic_planner_decisions_total" in text
        assert "mosaic_planner_estimate_error" in text
        assert text == j_to_openmetrics()
    finally:
        planner.reset()
        jplanner.reset()


# ------------------------------------------------------------ Chrome trace

def test_chrome_trace_export(tmp_path, planes):
    docs = {}
    for name, tr, events in (("port", tracer, chrome_trace_events),
                             ("jax", jtracer, j_chrome_trace_events)):
        tr.reset()
        tr.enable()
        with tr.span("outer"):
            with tr.span("inner"):
                pass
            with pytest.raises(ValueError):
                with tr.span("failing"):
                    raise ValueError("boom")
        docs[name] = events()
        tr.disable()
    doc = docs["port"]
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {"outer", "outer/inner"} <= {e["name"] for e in evs}
    for e in evs:
        assert {"name", "ph", "ts", "dur", "pid", "tid", "cat"} <= set(e)
        assert e["ts"] > 0 and e["dur"] >= 0

    def shape(d):
        return [(e["ph"], e["name"], e.get("tid"), e.get("cat"),
                 sorted(e.get("args", {})))
                for e in d["traceEvents"]]
    assert shape(docs["port"]) == shape(docs["jax"])
    meta = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert meta[0]["args"]["name"] == "mosaic_tpu_torch host"
    path = tmp_path / "trace.json"
    tracer.enable()
    with tracer.span("again"):
        pass
    assert export_chrome_trace(str(path)) == str(path)
    tracer.disable()
    ondisk = json.loads(path.read_text())
    assert ondisk["displayTimeUnit"] == "ms"
    assert any(e.get("name") == "again" for e in ondisk["traceEvents"])
    assert [p.name for p in tmp_path.iterdir()] == ["trace.json"]


def test_chrome_trace_lanes_per_trace(planes):
    tracer.enable()
    with mt.obs.new_trace("a"):
        with tracer.span("q"):
            pass
    with mt.obs.new_trace("b"):
        with tracer.span("q"):
            pass
    doc = chrome_trace_events()
    lanes = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"]
    assert len(lanes) == 2 and len(names) == 2
    assert all(n.endswith(" a") or n.endswith(" b") for n in names)


def test_utils_trace_shim_is_obs():
    from mosaic_tpu_torch import obs
    from mosaic_tpu_torch.utils import trace as shim
    from mosaic_tpu.utils import trace as jshim
    assert shim.tracer is obs.tracer
    assert shim.metrics is obs.metrics
    assert shim.device_trace is obs.device_trace
    assert shim.__all__ == jshim.__all__


# --------------------------------------------------------------- dashboard

def test_dashboard_endpoints(session):
    session.sql("SELECT x FROM pts")
    timeseries.record("demo/series", 1.5)
    handle = serve_dashboard(port=0)
    base = f"http://127.0.0.1:{handle.port}"
    try:
        page = _get(base + "/")
        assert "mosaic_tpu_torch ops dashboard" in page
        assert "/api/summary" in page
        summary = json.loads(_get(base + "/api/summary"))
        assert summary["metrics_enabled"] is True
        assert summary["series"] >= 1
        names = json.loads(_get(base + "/api/series?prefix=demo/"))
        assert names["names"] == ["demo/series"]
        ts = json.loads(_get(
            base + "/api/timeseries?name=demo/series&window=60"))
        assert ts["found"] and ts["stats"]["count"] == 1
        missing = json.loads(_get(
            base + "/api/timeseries?name=nope&window=60"))
        assert missing["found"] is False
        for route in ("/api/alerts", "/api/traces", "/api/planner",
                      "/api/devices", "/api/memory", "/metrics",
                      "/memory", "/api/fleet", "/api/history"):
            assert _get(base + route)
        # the server panel equals the JAX package's: with no server up,
        # then with a server of each package up (their live values —
        # pid, port, uptime, queue counts — aside)
        from mosaic_tpu.obs.dashboard import \
            _server_payload as j_server_payload
        assert json.loads(_get(base + "/api/server")) == \
            j_server_payload() == {"running": False}
        with QueryServer(session, workers=1) as srv, \
                JQueryServer(_jax_session(), workers=1) as jsrv:
            panel, jpanel = json.loads(_get(base + "/api/server")), \
                j_server_payload()
            assert panel["addr"].endswith(f":{srv.port}")
            assert jpanel["addr"].endswith(f":{jsrv.port}")
            assert _shape(panel) == _shape(jpanel)
            for k in ("running", "draining", "workers", "quotas",
                      "batching", "jit"):
                assert panel[k] == jpanel[k], k
        assert json.loads(_get(base + "/api/server")) == \
            j_server_payload() == {"running": False}
        assert json.loads(_get(base + "/api/fleet")) == {"enabled": False}
        assert json.loads(_get(base + "/api/history"))["enabled"] is False
        assert "sql_queries_total" in _get(base + "/metrics")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=5)
    finally:
        handle.close()


def _busy_until(stop):
    x = 0
    while not stop.is_set():
        x += sum(i * i for i in range(500))


def test_dashboard_profile_routes(session):
    ledger.observe("pip/streamed", (64,), 0.2, rows=640)
    start_profiler(hz=200.0)
    stop = threading.Event()
    t = threading.Thread(target=_busy_until, args=(stop,), daemon=True)
    t.start()
    handle = serve_dashboard(port=0)
    base = f"http://127.0.0.1:{handle.port}"
    try:
        deadline = time.time() + 10
        prof = json.loads(_get(base + "/api/profile"))
        while prof["host"].get("samples", 0) == 0 and \
                time.time() < deadline:
            time.sleep(0.05)
            prof = json.loads(_get(base + "/api/profile"))
        assert prof["running"] is True
        assert prof["host"]["samples"] > 0
        assert prof["collapsed"]
        assert "pip/streamed" in [k["name"] for k in
                                  prof["ledger"]["kernels"]]
        empty = json.loads(_get(base + "/api/profile?trace=t0-nope"))
        assert empty["collapsed"] == "" and empty["host"]["stacks"] == []
        page = _get(base + "/profile")
        assert "Flame graph" in page and "/api/profile" in page
        assert "mosaic_tpu_torch profile" in page
        assert "/profile" in _get(base + "/")
    finally:
        stop.set()
        t.join()
        handle.close()
        stop_profiler()


def test_dashboard_query_console_routes(session):
    session.principal = "carol"
    session.sql("SELECT x FROM pts LIMIT 5")
    with serve_dashboard(port=0) as h:
        base = f"http://127.0.0.1:{h.port}"
        st, hd, body = _req(base, "/api/queries")
        assert st == 200 and hd.get("Cache-Control") == "no-store"
        q = json.loads(body)
        assert q["inflight"] == []
        assert q["recent"][-1]["principal"] == "carol"
        assert q["recent"][-1]["cost"]["compiles"] == 0
        st, hd, body = _req(base, "/api/principals")
        assert st == 200 and hd.get("Cache-Control") == "no-store"
        assert json.loads(body)["principals"]["carol"]["queries"] == 1
        st, hd, body = _req(base, "/api/bogus")
        assert st == 404 and hd.get("Cache-Control") == "no-store"
        assert json.loads(body) == {"error": "not found",
                                    "path": "/api/bogus"}
        st, hd, body = _req(base, "/api/bogus", "POST")
        assert st == 404 and json.loads(body)["error"] == "not found"
        st, hd, body = _req(base, "/api/queries/qx/cancel")
        assert st == 405 and hd.get("Allow") == "POST"
        st, _, body = _req(base, "/api/queries/qx/cancel", "POST")
        assert st == 404
        assert json.loads(body) == {"query_id": "qx", "cancelled": False}
        st, _, body = _req(base, "/")
        assert st == 200 and b"Queries in flight" in body


def test_dashboard_cancels_live_query_via_post(session):
    session.principal = "carol"
    faults.arm("site=sql.query,mode=delay,fails=1,delay_ms=700")
    res = {}

    def run():
        try:
            session.sql("SELECT x FROM pts")
        except QueryCancelled as e:
            res["exc"] = e

    with serve_dashboard(port=0) as h:
        base = f"http://127.0.0.1:{h.port}"
        th = threading.Thread(target=run)
        th.start()
        try:
            deadline = time.time() + 0.5
            q = []
            while not q and time.time() < deadline:
                q = json.loads(_req(base, "/api/queries")[2])["inflight"]
                time.sleep(0.01)
            assert q and q[0]["principal"] == "carol"
            st, _, body = _req(
                base, f"/api/queries/{q[0]['query_id']}/cancel", "POST")
            assert st == 200 and json.loads(body)["cancelled"] is True
        finally:
            th.join(timeout=10)
    assert not th.is_alive()
    assert res["exc"].outcome == "cancelled"
    assert audit.records()[-1]["outcome"] == "cancelled"


@pytest.fixture(scope="module")
def flagship():
    polys, grid, res = mt.build_workload(n_side=2, grid_name="H3")
    jpolys, jgrid, jres = jbuild_workload(n_side=2, grid_name="H3")
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    jidx = jpj.build_pip_index(jpolys, jres, jgrid)
    ext = polys.bboxes()
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(ext[:, 0].min(), ext[:, 2].max(), 5000),
                    rng.uniform(ext[:, 1].min(), ext[:, 3].max(), 5000)],
                   1)
    return (tpj.make_streamed_pip_join(idx, grid, polys, chunk=2048,
                                       device="cpu"),
            jpj.make_streamed_pip_join(jidx, jgrid, polys=jpolys,
                                       chunk=2048), pts)


def test_leak_drill_in_openmetrics_and_dashboard(planes, flagship):
    """The exposition and dashboard halves of tests/test_memwatch.py's
    leak drill: one leak shows as ``mosaic_mem_leaks_total 1`` and on the
    memory route and page, as in the JAX package."""
    run, jrun, pts = flagship
    jrun(pts)                                   # warm (compile)
    jmw.reset()
    spec = "seed=3;site=memwatch.release,fails=1,error=OSError"
    faults.arm(spec)
    jfaults.arm(spec)
    with accounted("leak-drill", principal="mallory"):
        run(pts)
    with jaccounted("leak-drill", principal="mallory"):
        jrun(pts)
    assert memwatch.leak_count() == jmw.leak_count() == 1
    om = to_openmetrics()
    assert "mosaic_mem_leaks_total 1" in om
    assert "mosaic_mem_leaks_total 1" in j_to_openmetrics()
    with serve_dashboard(port=0) as h:
        base = f"http://127.0.0.1:{h.port}"
        snap = json.loads(_get(base + "/api/memory"))
        assert "mosaic_tpu_torch device memory" in _get(base + "/memory")
    want = json.loads(json.dumps(j_memory_payload(), default=str))
    assert snap["totals"]["leaks"] == want["totals"]["leaks"] == 1
    assert [(x["site"], x["bytes"], x["buffers"]) for x in snap["leaks"]] \
        == [(x["site"], x["bytes"], x["buffers"]) for x in want["leaks"]]
    assert snap["leaks"][0]["site"].startswith("pip_join/streamed")
    assert snap["counters"] == want["counters"]
    assert snap["budget"] == want["budget"]
