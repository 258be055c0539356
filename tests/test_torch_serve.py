"""The port's query service (``mosaic_tpu_torch.serve``) against the JAX
package's.

* The 17 cases of ``tests/test_serve.py``, each run on the port's
  server over a ``device="cpu"`` session: HTTP basics, the W3C trace
  stitch, ``/stats`` and the dashboard's server panel, rate and
  concurrency quotas with Retry-After, priority shed, drain answers 503,
  two-tenant isolation, cancel on disconnect, the 504 deadline,
  micro-batched point lookups (fewer ``serve/point_lookup`` launches
  than queries, rows equal to the serial engine) and the serial arm,
  drain on SIGTERM, the ``serve.accept`` / ``serve.dispatch`` fault
  sites, a torn response and the ``mosaic.serve.*`` keys.
* Micro-batching on every grid (CUSTOM, BNG, H3): each client's cells
  equal the port's serial ``session.sql``, the JAX package's serial
  ``SQLSession.sql`` and the host ``point_to_cell`` on every row, with
  fewer launches than queries; the six as one batch carry the JAX
  package's kernel-ledger key, and on CUSTOM and BNG its batched cells.
* H3 hex edges (ROADMAP C18): the JAX package's ``execute_batch``, f32
  with no re-check, strays from its own serial answer on points placed
  on hex edges and a hair beside them; the port's batch does not, and
  it agrees with the JAX batch wherever the JAX f32 margin is at least
  ``DEVICE_MARGIN_BAND``.
* A batch whose device call fails resolves every member 500: nothing
  answers from a fallback.
* ``tools/loadtest_torch.py`` takes a 200 answer cut short by a killed
  worker for a torn connection, where ``tools/loadtest.py`` counts it ok
  (ROADMAP C19).
* The same requests sent to both packages' servers give the same
  status and the same rows.
* ``install_sigterm_drain`` puts the previous handler back on ``stop``.
"""

import http.client
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from mosaic_tpu.functions.context import MosaicContext as JContext
from mosaic_tpu.obs.profiler import ledger as jledger
from mosaic_tpu.serve import QueryServer as JQueryServer
from mosaic_tpu.serve import ServeRequest as JServeRequest
from mosaic_tpu.serve.batching import execute_batch as jexecute_batch
from mosaic_tpu.sql import SQLSession as JSession
from mosaic_tpu.sql.engine import classify_batchable as jclassify
from mosaic_tpu_torch import config as _config
from mosaic_tpu_torch.core.index.base import DEVICE_MARGIN_BAND
from mosaic_tpu_torch.functions.context import MosaicContext
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.obs.accounting import audit, meter
from mosaic_tpu_torch.obs.inflight import inflight
from mosaic_tpu_torch.obs.memwatch import memwatch
from mosaic_tpu_torch.obs.profiler import ledger
from mosaic_tpu_torch.obs.recorder import recorder
from mosaic_tpu_torch.resilience import faults
from mosaic_tpu_torch.resilience.testing import fault_plan  # noqa: F401
from mosaic_tpu_torch.serve import (AdmissionQueue, KERNEL_NAME,
                                    QueryServer, ServeRequest)
from mosaic_tpu_torch.serve.batching import execute_batch
from mosaic_tpu_torch.sql import SQLSession
from mosaic_tpu_torch.sql.engine import classify_batchable

CUSTOM = "CUSTOM(-180,180,-90,90,2,360,180)"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(seed=7):
    rng = np.random.default_rng(seed)
    n = 50_000
    pts = {"lon": rng.uniform(-170.0, 170.0, n),
           "lat": rng.uniform(-80.0, 80.0, n),
           "v": rng.uniform(0.0, 1.0, n)}
    small = {"lon": rng.uniform(-170.0, 170.0, 256),
             "lat": rng.uniform(-80.0, 80.0, 256),
             "id": np.arange(256)}
    return pts, small


@pytest.fixture(scope="module")
def mc():
    return MosaicContext(CUSTOM, device="cpu")


@pytest.fixture(scope="module")
def session(mc):
    s = SQLSession(mc)
    pts, small = _tables()
    s.create_table("pts", pts)
    s.create_table("small", small)
    return s


@pytest.fixture(scope="module")
def jsession():
    s = JSession(JContext(CUSTOM))
    pts, small = _tables()
    s.create_table("pts", pts)
    s.create_table("small", small)
    return s


@pytest.fixture
def serve_env():
    """Clean obs singletons + config around each server test."""
    prev = _config.default_config()
    audit.reset()
    meter.reset()
    metrics.reset()
    metrics.enable()
    recorder.reset()
    recorder.enable()
    memwatch.reset()
    yield
    faults.disarm()
    _config.set_default_config(prev)
    audit.reset()
    meter.reset()
    metrics.disable()
    metrics.reset()
    recorder.reset()
    memwatch.reset()


def _conf(**keys):
    """Apply ``mosaic.serve.*`` (or any) conf keys to the port's process
    default config; serve_env restores the previous config."""
    cfg = _config.default_config()
    for k, v in keys.items():
        cfg = _config.apply_conf(cfg, k.replace("_", "."), str(v))
    _config.set_default_config(cfg)


def _post(port, sql, principal="t", priority=None, deadline_ms=None,
          timeout=30.0, traceparent=None):
    """POST /query; returns (status, headers dict, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=timeout)
    try:
        headers = {"X-Mosaic-Principal": principal}
        if priority is not None:
            headers["X-Mosaic-Priority"] = str(priority)
        if deadline_ms is not None:
            headers["X-Mosaic-Deadline-Ms"] = str(deadline_ms)
        if traceparent is not None:
            headers["traceparent"] = traceparent
        conn.request("POST", "/query", body=sql.encode(),
                     headers=headers)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _rows(body: bytes):
    """Decode a 200 JSON-lines response -> (columns, row list)."""
    lines = body.decode().splitlines()
    head = json.loads(lines[0])
    rows = []
    for ln in lines[1:]:
        rows.extend(json.loads(ln))
    assert len(rows) == head["rows"]
    return head["columns"], rows


def _launches(led):
    return sum(e["launches"] for e in led.report()["kernels"]
               if e["name"] == KERNEL_NAME)


def _burst(port, sql, k, prefix="tenant"):
    """k concurrent POSTs of ``sql`` released by one barrier, each its
    own principal; returns the k (status, headers, body)."""
    results = [None] * k
    barrier = threading.Barrier(k)

    def client(i):
        barrier.wait(10)
        results[i] = _post(port, sql, principal=f"{prefix}{i}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return results


_POINT_SQL = ("SELECT id, grid_longlatascellid(lon, lat, 5) AS cell "
              "FROM small")
_SLOW_SQL = ("SELECT count(*) AS n, max(v) AS mx FROM pts "
             "WHERE v > 0.25")


# ------------------------------------------------------------- basics

def test_http_basics_and_bad_requests(session, serve_env):
    with QueryServer(session, workers=2) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=10)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read())["status"] == "ok"
        conn.close()

        status, _, body = _post(srv.port,
                                "SELECT id FROM small LIMIT 3")
        assert status == 200
        cols, rows = _rows(body)
        assert cols == ["id"] and rows == [[0], [1], [2]]

        status, _, body = _post(srv.port, "SELECT FROM nothing ((")
        assert status == 400
        status, _, body = _post(srv.port, "SELECT x FROM no_table")
        assert status == 400

        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=10)
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
        conn.close()

        # JSON body form
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=10)
        conn.request("POST", "/query",
                     body=json.dumps(
                         {"sql": "SELECT id FROM small LIMIT 1"}),
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 200
        conn.close()


def test_traceparent_stitches_cross_process_trace(session, serve_env,
                                                  tmp_path):
    """A request carrying a W3C traceparent comes back with the SAME
    trace id in its response header, the worker's local trace is linked
    to it, and the port's fleet aggregator stitches client + server
    spans into one tree under that id."""
    from mosaic_tpu_torch.obs.context import (link_traceparent, new_trace,
                                              parse_traceparent)
    from mosaic_tpu_torch.obs.fleet import FleetAggregator
    from mosaic_tpu_torch.obs.spool import write_spool
    from mosaic_tpu_torch.obs.tracer import tracer
    tracer.enable()
    try:
        w3c_trace = "4bf92f3577b34da6a3ce929d0e0e4736"
        tp = f"00-{w3c_trace}-00f067aa0ba902b7-01"
        with QueryServer(session, workers=2) as srv:
            with link_traceparent(tp), new_trace("client:test"):
                with tracer.span("client/request"):
                    status, headers, body = _post(
                        srv.port, "SELECT id FROM small LIMIT 3",
                        traceparent=tp)
        assert status == 200
        parsed = parse_traceparent(headers.get("traceparent", ""))
        assert parsed is not None and parsed[0] == w3c_trace
        local = headers.get("X-Mosaic-Trace", "")
        assert local.startswith("t")

        links = [e for e in recorder.events("trace_link")
                 if e["w3c_trace"] == w3c_trace]
        linked_traces = {e["trace"] for e in links}
        assert local in linked_traces
        assert len(linked_traces) >= 2
        spans = [e for e in recorder.events("span")
                 if e.get("trace") == local]
        assert spans, "linked query trace recorded no spans"

        assert write_spool(str(tmp_path)) is not None
        agg = FleetAggregator(str(tmp_path))
        traces = agg.stitched_traces(agg.scan())
        assert w3c_trace in traces
        tree = traces[w3c_trace]
        stitched = {s["local_trace"] for s in tree["spans"]}
        assert local in stitched and len(stitched) >= 2
        assert any(s["name"] == "client/request"
                   for s in tree["spans"])
    finally:
        tracer.disable()


def test_stats_and_dashboard_payload(session, serve_env):
    from mosaic_tpu_torch import _kernels
    from mosaic_tpu_torch.obs.dashboard import _server_payload
    assert _server_payload() == {"running": False}
    _kernels.reset_cache_stats()
    with QueryServer(session, workers=1) as srv:
        _post(srv.port, "SELECT id FROM small LIMIT 1", principal="a")
        st = srv.stats()
        assert st["running"] and st["workers"]["total"] == 1
        assert st["queue"]["principals"]["a"]["admitted"] == 1
        # the persistent kernel cache's counters: no kernel loads on
        # the CPU, so both stay 0
        assert st["jit"] == _kernels.cache_stats() == {
            "persistent_hits": 0, "persistent_misses": 0}
        assert _server_payload()["addr"].endswith(str(srv.port))
    assert _server_payload() == {"running": False}


# ----------------------------------------------------------- admission

def test_rate_quota_denies_with_retry_after(session, serve_env):
    _conf(mosaic_serve_quota_qps=2)
    with QueryServer(session, workers=2) as srv:
        outcomes = []
        for _ in range(6):
            status, headers, body = _post(
                srv.port, "SELECT id FROM small LIMIT 1")
            outcomes.append(status)
            if status == 429:
                assert "Retry-After" in headers
                assert json.loads(body)["reason"] == "rate_quota"
        assert outcomes.count(200) >= 2
        assert 429 in outcomes
        assert metrics.counter_value("serve/denied_rate_quota") >= 1


def test_concurrency_quota_denies(session, serve_env, fault_plan):
    _conf(mosaic_serve_quota_concurrency=1)
    fault_plan("seed=3;site=sql.query,mode=delay,fails=1,delay_ms=400")
    with QueryServer(session, workers=2) as srv:
        results = {}

        def slow():
            results["slow"] = _post(srv.port, _SLOW_SQL,
                                    principal="heavy")[0]

        t = threading.Thread(target=slow, daemon=True)
        t.start()
        time.sleep(0.15)
        deadline = time.perf_counter() + 2.0
        denied = None
        while time.perf_counter() < deadline:
            status, headers, body = _post(
                srv.port, "SELECT id FROM small LIMIT 1",
                principal="heavy")
            if status == 429:
                denied = json.loads(body)
                assert "Retry-After" in headers
                break
            time.sleep(0.02)
        t.join(10)
        assert denied is not None and \
            denied["reason"] == "concurrency_quota"
        assert results["slow"] == 200


def test_queue_full_sheds_lowest_priority_first(serve_env):
    q = AdmissionQueue(depth=2, quota_concurrency=0, quota_qps=0.0)
    low1 = ServeRequest("SELECT 1", "bulk", priority=-1)
    low2 = ServeRequest("SELECT 2", "bulk", priority=-1)
    assert q.offer(low1) is None and q.offer(low2) is None
    high = ServeRequest("SELECT 3", "interactive", priority=5)
    assert q.offer(high) is None
    assert low2.future.done() and not low1.future.done()
    status, body, outcome = low2.future.result()
    assert status == 429 and outcome == "shed"
    low3 = ServeRequest("SELECT 4", "bulk", priority=-1)
    deny = q.offer(low3)
    assert deny is not None and deny.reason == "shed"
    sheds = recorder.events("serve_shed")
    assert len(sheds) == 2
    assert {e["principal"] for e in sheds} == {"bulk"}
    assert metrics.counter_value("serve/shed") == 2
    snap = q.snapshot()
    assert snap["queued"] == 2
    assert snap["principals"]["bulk"]["shed"] == 2


def test_draining_queue_answers_503(serve_env):
    q = AdmissionQueue(depth=4, quota_concurrency=0, quota_qps=0.0)
    q.start_drain()
    deny = q.offer(ServeRequest("SELECT 1", "t"))
    assert deny is not None and deny.status == 503
    assert deny.reason == "draining"


# ----------------------------------------------------- tenant isolation

def test_two_tenant_isolation_under_flood(session, serve_env):
    _conf(mosaic_serve_quota_concurrency=2,
          mosaic_serve_workers=4, mosaic_serve_queue_depth=4)
    with QueryServer(session) as srv:
        stop = threading.Event()
        flood_status = []

        def flooder():
            while not stop.is_set():
                try:
                    flood_status.append(
                        _post(srv.port, _SLOW_SQL,
                              principal="flood")[0])
                except Exception:
                    flood_status.append(-1)

        threads = [threading.Thread(target=flooder, daemon=True)
                   for _ in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.1)
        calm_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            status, _, _ = _post(srv.port,
                                 "SELECT id FROM small LIMIT 5",
                                 principal="calm")
            calm_ms.append((time.perf_counter() - t0) * 1e3)
            assert status == 200
        stop.set()
        for t in threads:
            t.join(10)
        assert flood_status.count(429) > 0
        assert metrics.counter_value("serve/denied") > 0
        calm_p99 = float(np.percentile(calm_ms, 99))
        assert calm_p99 < 5_000.0, \
            f"calm tenant p99 {calm_p99:.0f} ms under flood"
        snap = srv.queue.snapshot()["principals"]
        assert "calm" not in {p for p, v in snap.items()
                              if v["shed"] > 0}


# ------------------------------------------- cancellation + deadlines

def test_disconnect_cancels_running_query(session, serve_env,
                                          fault_plan):
    fault_plan("seed=5;site=sql.query,mode=delay,fails=1,delay_ms=600")
    with QueryServer(session, workers=2) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=10)
        conn.request("POST", "/query", body=_SLOW_SQL.encode(),
                     headers={"X-Mosaic-Principal": "dropper"})
        time.sleep(0.15)
        conn.close()
        deadline = time.perf_counter() + 5.0
        rec = None
        while time.perf_counter() < deadline:
            recs = [r for r in audit.records()
                    if r["principal"] == "dropper"]
            if recs:
                rec = recs[-1]
                break
            time.sleep(0.02)
        assert rec is not None, "query never completed after hangup"
        assert rec["outcome"] == "cancelled"
        assert rec["cost"]["wall_ms"] < 3_000.0
        assert len(inflight) == 0
        assert memwatch.total_live() == 0
        assert memwatch.leak_count() == 0
        assert metrics.counter_value("serve/disconnects") == 1


def test_deadline_yields_504(session, serve_env, fault_plan):
    fault_plan("seed=6;site=sql.query,mode=delay,fails=1,delay_ms=500")
    with QueryServer(session, workers=2) as srv:
        status, _, body = _post(srv.port, _SLOW_SQL,
                                principal="sla", deadline_ms=100)
        assert status == 504
        assert json.loads(body)["error"] == "deadline"
        rec = [r for r in audit.records()
               if r["principal"] == "sla"][-1]
        assert rec["outcome"] == "deadline"
        assert len(inflight) == 0


# --------------------------------------------------- micro-batching

def test_microbatch_parity_and_fewer_launches(session, serve_env):
    """K concurrent compatible point lookups: one worker drains them
    into fewer device calls than queries (kernel ledger), and every
    tenant's rows equal its query run alone."""
    _conf(mosaic_serve_workers=1, mosaic_serve_batch_window_ms=60,
          mosaic_serve_batch_max=32)
    out = session.sql(_POINT_SQL)
    direct = {"id": np.asarray(out.columns["id"]),
              "cell": np.asarray(out.columns["cell"])}
    ledger.reset()
    k = 6
    with QueryServer(session) as srv:
        results = _burst(srv.port, _POINT_SQL, k)
    launches = _launches(ledger)
    assert 0 < launches < k, \
        f"{launches} launches for {k} batchable queries"
    assert metrics.counter_value("serve/batched_queries") == k
    for i, res in enumerate(results):
        status, _, body = res
        assert status == 200, f"tenant{i}: {res}"
        cols, rows = _rows(body)
        assert cols == ["id", "cell"]
        got = np.asarray(rows, dtype=np.int64)
        assert np.array_equal(got[:, 0], direct["id"])
        assert np.array_equal(got[:, 1], direct["cell"])
    rep = meter.report()
    for i in range(k):
        assert rep[f"tenant{i}"]["queries"] == 1
    assert len(inflight) == 0
    assert memwatch.leak_count() == 0
    assert memwatch.total_live() == 0


def test_batch_max_one_runs_serially_same_kernel(session, serve_env):
    _conf(mosaic_serve_workers=1, mosaic_serve_batch_max=1)
    ledger.reset()
    k = 3
    with QueryServer(session) as srv:
        for i in range(k):
            status, _, _ = _post(srv.port, _POINT_SQL,
                                 principal=f"s{i}")
            assert status == 200
    assert _launches(ledger) == k


# ----------------------------------------------------------- draining

def test_drain_on_sigterm(session, serve_env, fault_plan):
    """SIGTERM -> drain: the in-flight query finishes (200), new
    admissions answer 503/refused, the drain event is flight-recorded,
    workers exit clean, and stop() puts the previous SIGTERM handler
    back."""
    fault_plan("seed=8;site=sql.query,mode=delay,fails=1,delay_ms=300")
    before = signal.getsignal(signal.SIGTERM)
    srv = QueryServer(session, workers=2).start()
    srv.install_sigterm_drain()
    try:
        inflight_result = {}

        def slow():
            inflight_result["status"] = _post(
                srv.port, _SLOW_SQL, principal="finisher")[0]

        t = threading.Thread(target=slow, daemon=True)
        t.start()
        time.sleep(0.1)
        os.kill(os.getpid(), signal.SIGTERM)
        t.join(15)
        assert inflight_result["status"] == 200
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline and \
                srv._thread is not None:
            time.sleep(0.05)
        try:
            status, _, _ = _post(srv.port, _SLOW_SQL, timeout=2.0)
            assert status == 503
        except OSError:
            pass
        assert recorder.events("serve_drain")
        assert srv.pool.idle()
        assert len(inflight) == 0
    finally:
        srv.stop()
    assert signal.getsignal(signal.SIGTERM) is before


# -------------------------------------------------------------- chaos

def test_serve_accept_fault_degrades_one_connection(session, serve_env,
                                                    fault_plan):
    plan = fault_plan("seed=9;site=serve.accept,fails=1,error=OSError")
    with QueryServer(session, workers=1) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=10)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 503
        assert "Retry-After" in dict(r.getheaders())
        conn.close()
        assert ("serve.accept", 0, "OSError") in plan.injected
        status, _, _ = _post(srv.port, "SELECT id FROM small LIMIT 1")
        assert status == 200
        assert metrics.counter_value("serve/accept_errors") == 1


def test_serve_dispatch_fault_leaks_nothing(session, serve_env,
                                            fault_plan):
    threads_before = threading.active_count()
    plan = fault_plan(
        "seed=10;site=serve.dispatch,fails=1,error=OSError")
    with QueryServer(session, workers=2) as srv:
        status, _, body = _post(srv.port,
                                "SELECT id FROM small LIMIT 1")
        assert status == 500
        assert ("serve.dispatch", 0, "OSError") in plan.injected
        assert metrics.counter_value("serve/dispatch_errors") == 1
        assert len(inflight) == 0
        assert memwatch.total_live() == 0
        assert memwatch.leak_count() == 0
        status, _, _ = _post(srv.port, "SELECT id FROM small LIMIT 1")
        assert status == 200
    deadline = time.perf_counter() + 5.0
    while time.perf_counter() < deadline and \
            threading.active_count() > threads_before:
        time.sleep(0.05)
    assert threading.active_count() <= threads_before


def test_torn_connection_mid_response_keeps_serving(session,
                                                    serve_env):
    with QueryServer(session, workers=2) as srv:
        sock = socket.create_connection(("127.0.0.1", srv.port),
                                        timeout=10)
        sql = ("SELECT lon, lat, v FROM pts").encode()
        sock.sendall(b"POST /query HTTP/1.1\r\n"
                     b"Host: x\r\nX-Mosaic-Principal: torn\r\n"
                     b"Content-Length: %d\r\n\r\n%s" %
                     (len(sql), sql))
        sock.recv(64)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        b"\x01\x00\x00\x00\x00\x00\x00\x00")
        sock.close()
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            if [r for r in audit.records()
                    if r["principal"] == "torn"]:
                break
            time.sleep(0.02)
        status, _, _ = _post(srv.port, "SELECT id FROM small LIMIT 1")
        assert status == 200
        assert len(inflight) == 0
        assert memwatch.leak_count() == 0


# ------------------------------------------------- config validation

def test_serve_conf_keys_validate(serve_env):
    cfg = _config.default_config()
    cfg = _config.apply_conf(cfg, "mosaic.serve.port", "8817")
    assert cfg.serve_port == 8817
    with pytest.raises(ValueError):
        _config.apply_conf(cfg, "mosaic.serve.port", "70000")
    cfg = _config.apply_conf(cfg, "mosaic.serve.batch.max", "0")
    assert cfg.serve_batch_max == 0
    with pytest.raises(ValueError):
        _config.apply_conf(cfg, "mosaic.serve.batch.max", "-1")
    cfg = _config.apply_conf(cfg, "mosaic.serve.quota.qps", "2.5")
    assert cfg.serve_quota_qps == 2.5


# ------------------------------------------ micro-batching on each grid

def _grid_points(grid: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if grid == "BNG":
        return rng.uniform(1e5, 6e5, n), rng.uniform(1e5, 1.2e6, n)
    if grid == "H3":
        return rng.uniform(-74.05, -73.85, n), rng.uniform(40.6, 40.9, n)
    return rng.uniform(-170.0, 170.0, n), rng.uniform(-80.0, 80.0, n)


_GRID_RES = {CUSTOM: 5, "BNG": 3, "H3": 9}


@pytest.mark.parametrize("grid", [CUSTOM, "BNG", "H3"])
def test_microbatch_equals_host_and_serial_on_every_grid(grid,
                                                         serve_env):
    """Six tenants, each its own table of seeded points, batched into
    fewer calls than queries; each tenant's cells equal the port's
    serial path, the JAX package's serial path and the host
    ``point_to_cell`` on every row; on CUSTOM and BNG they also equal
    the JAX package's batched cells."""
    res = _GRID_RES[grid]
    k = 6
    port_s = SQLSession(MosaicContext(grid, device="cpu"))
    jax_s = JSession(JContext(grid))
    tables = []
    for i in range(k):
        lon, lat = _grid_points(grid, 300 + 17 * i, seed=100 + i)
        cols = {"lon": lon, "lat": lat, "id": np.arange(len(lon))}
        port_s.create_table(f"t{i}", cols)
        jax_s.create_table(f"t{i}", cols)
        tables.append(cols)
    sql = "SELECT id, grid_longlatascellid(lon, lat, {res}) AS cell " \
          "FROM t{i}"
    _conf(mosaic_serve_workers=1, mosaic_serve_batch_window_ms=60,
          mosaic_serve_batch_max=32)
    ledger.reset()
    results = [None] * k
    barrier = threading.Barrier(k)
    with QueryServer(port_s) as srv:
        def client(i):
            barrier.wait(10)
            results[i] = _post(srv.port, sql.format(res=res, i=i),
                               principal=f"g{i}")
        threads = [threading.Thread(target=client, args=(i,),
                                    daemon=True) for i in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    assert 0 < _launches(ledger) < k
    system = port_s.mc.index_system
    for i, (status, _, body) in enumerate(results):
        assert status == 200, (i, body[:200])
        got = np.asarray(_rows(body)[1], dtype=np.int64)
        xy = np.stack([tables[i]["lon"], tables[i]["lat"]], -1)
        host = system.point_to_cell(xy, res)
        q = sql.format(res=res, i=i)
        assert np.array_equal(got[:, 0], tables[i]["id"])
        assert np.array_equal(got[:, 1], host)
        assert np.array_equal(port_s.sql(q).columns["cell"], host)
        assert np.array_equal(jax_s.sql(q).columns["cell"], host)
    # all six as one batch in each package: the same ledger key
    # (grid, conf, res, pow2 bucket); on CUSTOM and BNG the same cells
    qs = [sql.format(res=res, i=i) for i in range(k)]
    jm = [JServeRequest(q, f"j{i}", lookup=jclassify(q, jax_s))
          for i, q in enumerate(qs)]
    pm = [ServeRequest(q, f"p{i}", lookup=classify_batchable(q, port_s))
          for i, q in enumerate(qs)]
    jledger.reset()
    ledger.reset()
    jexecute_batch(jax_s, jm)
    execute_batch(port_s, pm)
    assert [e["key"] for e in ledger.report()["kernels"]] == \
        [e["key"] for e in jledger.report()["kernels"]
         if e["name"] == KERNEL_NAME]
    for i, (r, jr) in enumerate(zip(pm, jm)):
        (status, table, _), (jstatus, jtable, _) = \
            r.future.result(10), jr.future.result(10)
        assert status == jstatus == 200
        xy = np.stack([tables[i]["lon"], tables[i]["lat"]], -1)
        cells = np.asarray(table.columns["cell"])
        assert np.array_equal(cells, system.point_to_cell(xy, res))
        if grid != "H3":
            assert np.array_equal(cells, np.asarray(jtable.columns["cell"]))
    assert memwatch.leak_count() == 0 and memwatch.total_live() == 0


def _hex_edge_points(system, res: int, seed: int):
    """Points on the edges of seeded H3 cells around NYC (each edge's
    quarter, half and three-quarter points) and a hair (1e-7 degree) to
    either side of each, then 2,048 seeded points of the same area:
    [M, 2] (lon, lat)."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(-74.05, -73.85, 64),
                        rng.uniform(40.6, 40.9, 64)], -1)
    cells = np.unique(system.point_to_cell(centers, res))
    verts, counts = system.cell_boundary(cells)
    out = []
    for v, c in zip(verts, counts):
        v = v[:c]
        a, b = v, np.roll(v, -1, axis=0)
        d = b - a
        normal = np.stack([-d[:, 1], d[:, 0]], -1)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        for t in (0.25, 0.5, 0.75):
            p = a + t * d
            out += [p, p + 1e-7 * normal, p - 1e-7 * normal]
    # and seeded points off the edges, most of them wide of the band
    out.append(np.stack([rng.uniform(-74.05, -73.85, 2048),
                         rng.uniform(40.6, 40.9, 2048)], -1))
    return np.concatenate(out, 0)


def test_h3_hex_edges_jax_batch_strays_port_exact(serve_env):
    """ROADMAP C18: on points placed on H3 hex edges and a hair beside
    them, the JAX package's ``execute_batch`` (f32, no re-check) answers
    cells other than its own serial answer on some rows; the port's
    batch equals the host on every row and agrees with the JAX batch
    wherever the JAX f32 margin is at least ``DEVICE_MARGIN_BAND``."""
    import jax
    import jax.numpy as jnp
    res = 9
    port_s = SQLSession(MosaicContext("H3", device="cpu"))
    jax_s = JSession(JContext("H3"))
    system = port_s.mc.index_system
    xy = _hex_edge_points(system, res, seed=18)
    cols = {"lon": xy[:, 0], "lat": xy[:, 1], "id": np.arange(len(xy))}
    port_s.create_table("edges", cols)
    jax_s.create_table("edges", cols)
    q = f"SELECT id, grid_longlatascellid(lon, lat, {res}) AS cell " \
        "FROM edges"
    host = system.point_to_cell(xy, res)
    jserial = np.asarray(jax_s.sql(q).columns["cell"])
    assert np.array_equal(jserial, host)
    jr = JServeRequest(q, "j", lookup=jclassify(q, jax_s))
    jexecute_batch(jax_s, [jr])
    status, table, _ = jr.future.result(10)
    assert status == 200
    jbatch = np.asarray(table.columns["cell"])
    strays = int((jbatch != jserial).sum())
    assert strays > 0, "the JAX batch never strayed: C18 is absent"
    ledger.reset()
    r = ServeRequest(q, "p", lookup=classify_batchable(q, port_s))
    execute_batch(port_s, [r])
    status, table, _ = r.future.result(10)
    assert status == 200 and _launches(ledger) == 1
    pbatch = np.asarray(table.columns["cell"])
    assert np.array_equal(pbatch, host)
    # the margin the JAX batch's cells came with, in degrees as the
    # port's DEVICE_MARGIN_BAND
    jsys = jax_s.mc.index_system
    _, margin = jax.jit(lambda a: jsys.point_to_cell_jax_margin(a, res))(
        jnp.asarray(xy))
    wide = np.asarray(margin) >= DEVICE_MARGIN_BAND
    assert wide.any()
    assert np.array_equal(pbatch[wide], jbatch[wide])
    assert not (jbatch != host)[wide].any()


def test_batch_failure_resolves_every_member_500(serve_env,
                                                 monkeypatch):
    """An error raised inside ``point_to_cell_device`` (here the grid's
    device hook) fails the whole batch: every member answers 500, the
    batch books ``serve/errors``, no ledger launch and no member answer
    comes from a fallback, and nothing leaks."""
    res = 9
    s = SQLSession(MosaicContext("H3", device="cpu"))
    lon, lat = _grid_points("H3", 500, seed=5)
    s.create_table("small", {"lon": lon, "lat": lat,
                             "id": np.arange(500)})
    system = s.mc.index_system
    calls = []

    def broken(xy, r):
        calls.append(len(xy))
        raise RuntimeError("injected: the cell kernel failed to launch")

    monkeypatch.setattr(system, "point_to_cell_torch_margin", broken)
    _conf(mosaic_serve_workers=1, mosaic_serve_batch_window_ms=60,
          mosaic_serve_batch_max=32)
    ledger.reset()
    q = f"SELECT id, grid_longlatascellid(lon, lat, {res}) AS cell " \
        "FROM small"
    k = 5
    with QueryServer(s) as srv:
        results = _burst(srv.port, q, k, prefix="f")
    assert len(calls) >= 1 and len(calls) < k
    for status, _, body in results:
        assert status == 500, body[:200]
        assert "injected" in json.loads(body)["error"]
    assert _launches(ledger) == 0
    assert metrics.counter_value("serve/errors") == len(calls)
    assert metrics.counter_value("serve/batched_queries") == 0
    assert [r["outcome"] for r in audit.records()] == ["error"] * k
    assert len(inflight) == 0
    assert memwatch.total_live() == 0 and memwatch.leak_count() == 0


# ------------------------------------------------ both packages' servers

_PARITY = [
    ("POST", "SELECT id FROM small LIMIT 3"),
    ("POST", "SELECT FROM nothing (("),
    ("POST", "SELECT x FROM no_table"),
    ("POST", _POINT_SQL),
    ("POST", _SLOW_SQL),
    ("POST", "SELECT id, lon FROM small WHERE id < 40 ORDER BY id DESC"),
    ("GET", "/nope"),
    ("GET", "/healthz"),
]


@pytest.fixture(scope="module")
def both_servers(session, jsession):
    with QueryServer(session, workers=2) as srv, \
            JQueryServer(jsession, workers=2) as jsrv:
        yield srv.port, jsrv.port


def _ask(port, method, what):
    if method == "POST":
        status, _, body = _post(port, what, principal="parity")
    else:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", what)
            r = conn.getresponse()
            status, body = r.status, r.read()
        finally:
            conn.close()
    if status == 200 and method == "POST":
        return status, _rows(body)
    payload = json.loads(body)
    for k in ("error", "pid", "workers"):
        payload.pop(k, None)
    return status, payload


@pytest.mark.parametrize("method,what", _PARITY,
                         ids=[f"{m} {w[:30]}" for m, w in _PARITY])
def test_same_requests_same_answers_in_both_servers(both_servers,
                                                    method, what):
    port, jport = both_servers
    assert _ask(port, method, what) == _ask(jport, method, what)


# --------------------------------------------- the load test's torn answer

def _cut_short_server():
    """A listener that answers every request with a 200 JSON-lines head
    promising 10 rows, sends 3, and closes (a worker killed while writing
    its answer); returns (port, stop)."""
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(0.2)
    stop = threading.Event()

    def run():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                continue
            with conn:
                conn.settimeout(5)
                data = b""
                while b"\r\n\r\n" not in data:
                    data += conn.recv(4096)
                head, _, rest = data.partition(b"\r\n\r\n")
                n = int([ln.split(b":")[1] for ln in head.split(b"\r\n")
                         if ln.lower().startswith(b"content-length")][0])
                while len(rest) < n:
                    rest += conn.recv(4096)
                conn.sendall(b"HTTP/1.1 200 OK\r\n"
                             b"Content-Type: application/jsonl\r\n"
                             b"Connection: close\r\n\r\n"
                             b'{"columns": ["id"], "rows": 10}\n'
                             b"[[0], [1], [2]]\n")
        srv.close()

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1], stop


def test_loadtest_counts_a_cut_short_answer_torn():
    """ROADMAP C19: a 200 JSON-lines answer that ends early (no length,
    a clean EOF) is ok to ``tools/loadtest.py``; ``tools/
    loadtest_torch.py`` counts its rows against the head's, takes it for
    a torn connection and, in fleet mode, fails over once, then books
    the request lost."""
    import importlib
    import sys
    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    try:
        jlt = importlib.import_module("loadtest")
        tlt = importlib.import_module("loadtest_torch")
    finally:
        sys.path.remove(tools)
    from mosaic_tpu_torch.obs.tracer import tracer
    was = tracer.enabled, metrics.enabled
    port, stop = _cut_short_server()
    try:
        assert jlt._post_query("127.0.0.1", port, "SELECT 1", "p") == \
            (200, "")
        with pytest.raises(ConnectionError, match="3 of 10 rows"):
            tlt._post_query("127.0.0.1", port, "SELECT 1", "p")
        counters = tlt.ClientCounters()
        with pytest.raises(ConnectionError):
            tlt._post_query("127.0.0.1", port, "SELECT 1", "p",
                            counters=counters, failover=True)
        assert counters.get("failovers") == 1
        rep = tlt.run_loadtest("127.0.0.1", port, [("SELECT 1", 1.0)],
                               clients=1, duration_s=0.2, failover=True)
        assert rep["lost"] == rep["requests"] > 0
        assert rep["outcomes"] == {"lost": rep["requests"]}
    finally:
        stop.set()
        # run_loadtest turns the port's tracer and registry on
        if not was[0]:
            tracer.disable()
        if not was[1]:
            metrics.disable()
