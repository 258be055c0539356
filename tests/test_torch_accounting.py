"""The port's accounting plane (``obs.accounting``) against the JAX
package's.

* The same ticket sequence (principals, outcomes, charged rows, bytes,
  device seconds and ledger bytes, strategies) completed in both
  packages gives equal audit records and meters, timestamps, trace and
  query ids and wall times aside; the same per-principal objectives are
  registered with each monitor.
* ``accounted`` around two principals' streamed joins in both packages:
  equal H2D and D2H bytes and rows charged, one audit record each with
  outcome ``ok``; a cancel inside ``accounted`` completes as
  ``cancelled`` and re-raises.
* ``compiles`` is 0 in the port's cost vector: it has no jit, so
  nothing counts ``jax/recompiles`` (ROADMAP C14).
* The JSONL spool rotates and retains as the JAX package's does
  (``mosaic.audit.path``, ``.rotate.bytes``, ``.retain``).
* ``complete`` hands each record to the workload history when
  ``mosaic.history.dir`` is set: the same widened records as the JAX
  package's, one per ticket and outcome, ``compiles`` 0.
* The flight bundle's ``queries`` entry carries the in-flight tickets,
  the recent records and the meters.
"""

import json

import numpy as np
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.bench.workloads import build_workload as jbuild_workload
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs import new_trace as jnew_trace
from mosaic_tpu.obs.accounting import accounted as jaccounted
from mosaic_tpu.obs.accounting import audit as jaudit
from mosaic_tpu.obs.accounting import complete as jcomplete
from mosaic_tpu.obs.accounting import meter as jmeter
from mosaic_tpu.obs.inflight import QueryCancelled as JQueryCancelled
from mosaic_tpu.obs.inflight import inflight as jinflight
from mosaic_tpu.obs.inflight import note_strategies as jnote_strategies
from mosaic_tpu.obs.memwatch import memwatch as jmw
from mosaic_tpu.obs.profiler import ledger as jledger
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.obs.slo import default_objectives as jdefault_objectives
from mosaic_tpu.obs.slo import monitor as jmonitor
from mosaic_tpu.parallel import pip_join as jpj
import mosaic_tpu_torch as mt
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics, new_trace, recorder
from mosaic_tpu_torch.obs.accounting import (accounted, audit, complete,
                                             meter)
from mosaic_tpu_torch.obs.inflight import (QueryCancelled, inflight,
                                           note_strategies)
from mosaic_tpu_torch.obs.memwatch import memwatch
from mosaic_tpu_torch.obs.profiler import ledger
from mosaic_tpu_torch.obs.slo import default_objectives, monitor
from mosaic_tpu_torch.parallel import pip_join as tpj

T = dict(new_trace=new_trace, inflight=inflight, complete=complete,
         ledger=ledger, memwatch=memwatch, note=note_strategies,
         audit=audit, meter=meter, metrics=metrics, recorder=recorder,
         monitor=monitor, config=tconfig, accounted=accounted,
         cancelled=QueryCancelled)
J = dict(new_trace=jnew_trace, inflight=jinflight, complete=jcomplete,
         ledger=jledger, memwatch=jmw, note=jnote_strategies,
         audit=jaudit, meter=jmeter, metrics=jmetrics, recorder=jrec,
         monitor=jmonitor, config=jconfig, accounted=jaccounted,
         cancelled=JQueryCancelled)


@pytest.fixture
def books():
    """Both packages' meters, audit logs, ledgers, registries, recorders
    and monitors fresh; restored after."""
    prev = tconfig.default_config(), jconfig.default_config()
    was = metrics.enabled, jmetrics.enabled, jrec.enabled
    for P in (T, J):
        for k in ("audit", "meter", "memwatch", "ledger", "metrics",
                  "recorder"):
            P[k].reset()
        P["metrics"].enable()
        P["recorder"].enable()
    monitor.reset(default_objectives())
    jmonitor.reset(jdefault_objectives())
    yield
    tconfig._default_config, jconfig._default_config = prev
    for P, w in ((T, was[0]), (J, was[1])):
        for k in ("audit", "meter", "memwatch", "ledger", "metrics"):
            P[k].reset()
        if not w:
            P["metrics"].disable()
    recorder.reset()
    jrec.reset()
    if not was[2]:
        jrec.disable()
    monitor.reset(default_objectives())
    jmonitor.reset(jdefault_objectives())


#: (principal, outcome, rows_in, rows, h2d, d2h, device seconds, ledger
#: bytes registered, ledger bytes released, strategies)
TICKETS = [
    ("alice", "ok", 100, 40, 8000, 5000, 0.125, 4096, 4096,
     {"pip_join": "streamed"}),
    ("bob", "error", 7, 0, 64, 0, 0.0, 0, 0, {}),
    ("alice", "cancelled", 50, 10, 800, 500, 0.25, 2048, 1024,
     {"knn": "ring"}),
    ("carol", "deadline", 0, 0, 0, 0, 0.5, 512, 512, {}),
    ("bob", "ok", 3, 3, 24, 15, 0.0625, 0, 0, {"pip_join": "sharded"}),
]


def _run_tickets(P):
    out = []
    for (who, outcome, rows_in, rows, h2d, d2h, dev_s, reg, rel,
         strat) in TICKETS:
        with P["new_trace"](f"q-{who}"):
            t = P["inflight"].register(f"work of {who}", principal=who)
            t.rows_in, t.rows = rows_in, rows
            t.h2d_bytes, t.d2h_bytes = h2d, d2h
            P["ledger"].observe("k", 0, dev_s)
            P["note"](strat)
            toks = [P["memwatch"].register("s", reg // 2),
                    P["memwatch"].register("s", reg - reg // 2)]
            if rel >= reg:
                for tok in toks:
                    P["memwatch"].release(tok)
            err = ValueError("boom") if outcome == "error" else None
            out.append(P["complete"](t, outcome=outcome, error=err,
                                     wall_ms=12.5))
    return out


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("start_ts", "end_ts", "trace", "query_id")}


def test_ticket_sequence_gives_equal_records_and_meters(books):
    t, j = _run_tickets(T), _run_tickets(J)
    assert [_strip(r) for r in t] == [_strip(r) for r in j]
    assert [_strip(r) for r in audit.records()] == \
        [_strip(r) for r in jaudit.records()]
    assert meter.report() == jmeter.report()
    assert meter.principals() == jmeter.principals() == \
        ["alice", "bob", "carol"]
    assert meter.mean_wall_ms("alice") == jmeter.mean_wall_ms("alice")
    # the unreleased half of alice's cancelled query: one leak each
    assert len(recorder.events("mem_leak")) == \
        len(jrec.events("mem_leak")) == 1
    assert memwatch.total_live() == jmw.total_live() == 0
    names = lambda m: sorted(o.name for o in m.objectives()  # noqa: E731
                             if o.name.startswith("principal_"))
    assert names(monitor) == names(jmonitor)
    assert len(names(monitor)) == 6
    for who in ("alice", "bob"):
        assert audit.records(principal=who) and \
            [_strip(r) for r in audit.records(principal=who)] == \
            [_strip(r) for r in jaudit.records(principal=who)]
    assert [r["outcome"] for r in audit.records(outcome="ok", limit=1)] \
        == ["ok"]
    rt, rj = metrics.report(), jmetrics.report()
    assert {k: v for k, v in rt["counters"].items()
            if k.startswith("principal/")} == \
        {k: v for k, v in rj["counters"].items()
         if k.startswith("principal/")}


def test_compiles_stay_zero_without_jit(books):
    """C14: the port has no jit, so no compile is ever counted."""
    (rec,) = _run_tickets(T)[:1]
    assert rec["cost"]["compiles"] == 0
    assert metrics.counter_value("jax/recompiles") == 0
    assert meter.report()["alice"]["compiles"] == 0


def test_complete_writes_one_history_record_as_jax(books, tmp_path,
                                                   monkeypatch):
    """The same ticket sequence through both packages' ``complete`` with
    a history directory each: one record per ticket, equal to the JAX
    package's but for ids, times and ``compiles`` (0 in the port)."""
    import importlib
    monkeypatch.delenv("MOSAIC_TPU_HISTORY_DIR", raising=False)
    got = {}
    for name, P in (("port", T), ("jax", J)):
        h = importlib.import_module(
            f"{P['config'].__name__.rsplit('.', 1)[0]}.obs.history")
        h.history.reset()
        cfg = P["config"].apply_conf(P["config"].default_config(),
                                     "mosaic.history.dir",
                                     str(tmp_path / name))
        P["config"].set_default_config(cfg)
        try:
            recs = _run_tickets(P)
        finally:
            P["config"].set_default_config(P["config"].apply_conf(
                cfg, "mosaic.history.dir", ""))
            h.history.reset()
        assert h.history.directory() == ""
        stored = h.load_records(str(tmp_path / name))
        assert [r["query_id"] for r in stored] == \
            [r["query_id"] for r in recs]
        got[name] = stored
    assert [r["outcome"] for r in got["port"]] == [t[1] for t in TICKETS]
    assert all(r["cost"]["compiles"] == 0 for r in got["port"])

    def cols(r):
        r = _strip(r)
        r["cost"] = {k: v for k, v in r["cost"].items() if k != "compiles"}
        return r
    assert [cols(r) for r in got["port"]] == [cols(r) for r in got["jax"]]


@pytest.fixture(scope="module")
def flagship():
    polys, grid, res = mt.build_workload(n_side=2, grid_name="H3")
    jpolys, jgrid, jres = jbuild_workload(n_side=2, grid_name="H3")
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    jidx = jpj.build_pip_index(jpolys, jres, jgrid)
    ext = polys.bboxes()
    rng = np.random.default_rng(11)
    pts = [np.stack([rng.uniform(ext[:, 0].min(), ext[:, 2].max(), n),
                     rng.uniform(ext[:, 1].min(), ext[:, 3].max(), n)], 1)
           for n in (3000, 1700)]
    return (tpj.make_streamed_pip_join(idx, grid, polys, chunk=1024,
                                       device="cpu"),
            jpj.make_streamed_pip_join(jidx, jgrid, polys=jpolys,
                                       chunk=1024), pts)


def test_accounted_streamed_joins_equal_jax(books, flagship):
    run, jrun, pts = flagship
    jrun(pts[0])                              # warm (compile)
    jaudit.reset()
    jmeter.reset()
    for P, r in ((T, run), (J, jrun)):
        for who, p in zip(("tenant-a", "tenant-b"), pts):
            with P["accounted"](f"flagship {who}", principal=who):
                r(p)
    rep, jrep = meter.report(), jmeter.report()
    for who, p in zip(("tenant-a", "tenant-b"), pts):
        # the JAX package counts compiles once a listener is installed
        # (C14: the port has none, its count is 0)
        for k in ("queries", "h2d_bytes", "d2h_bytes", "rows_in",
                  "rows_out"):
            assert rep[who][k] == jrep[who][k], (who, k)
        assert rep[who]["compiles"] == 0
        assert rep[who]["h2d_bytes"] == 8 * len(p)
        assert rep[who]["d2h_bytes"] == 5 * len(p)
        assert rep[who]["device_s"] > 0 and rep[who]["mem_peak_bytes"] > 0
        assert rep[who]["outcomes"] == {"ok": 1}
    assert metrics.counter_value("pipeline/h2d_bytes") == \
        sum(rep[w]["h2d_bytes"] for w in rep)
    assert [(r["principal"], r["outcome"]) for r in audit.records()] == \
        [(r["principal"], r["outcome"]) for r in jaudit.records()]
    assert len(recorder.events("audit")) == 2


def test_accounted_cancel_completes_as_cancelled(books, flagship):
    run, _, pts = flagship
    for P in (T, J):
        with pytest.raises(P["cancelled"]):
            with P["accounted"]("cancel me", principal="p") as t:
                P["inflight"].cancel(t.query_id)
                t.check()
    # the error text names each package's own query id
    same = lambda r: _strip(r) | {"cost": None,  # noqa: E731
                                  "error": r["error"].split(" query ")[0]}
    assert [same(r) for r in audit.records()] == \
        [same(r) for r in jaudit.records()]
    assert audit.records()[0]["outcome"] == "cancelled"


@pytest.mark.parametrize("rotate,retain", [(0, 8), (200, 2), (1, 0)])
def test_audit_spool_rotates_as_jax(books, tmp_path, rotate, retain):
    counts = []
    for P, sub in ((T, "port"), (J, "jax")):
        d = tmp_path / sub
        d.mkdir()
        path = d / "audit.jsonl"
        cfg = P["config"].default_config()
        for k, v in (("mosaic.audit.path", str(path)),
                     ("mosaic.audit.rotate.bytes", str(rotate)),
                     ("mosaic.audit.retain", str(retain))):
            cfg = P["config"].apply_conf(cfg, k, v)
        P["config"]._default_config = cfg
        for i in range(6):
            with P["new_trace"]("q"):
                t = P["inflight"].register(f"q{i}", principal="spool")
                P["complete"](t, wall_ms=1.0)
        files = sorted(p.name for p in d.iterdir())
        lines = [json.loads(line) for f in sorted(d.iterdir())
                 for line in f.read_text().splitlines()]
        # which rotated files survive can differ: two rotations in one
        # millisecond take suffixed names in either package
        counts.append((len(files), len(lines),
                       P["metrics"].counter_value("audit/spool_rotations")))
    assert counts[0] == counts[1]
    if rotate == 0:
        assert counts[0][:2] == (1, 6)


def test_bundle_carries_the_query_console(books, flagship):
    run, _, pts = flagship
    with accounted("flagship bundle", principal="tenant-c"):
        run(pts[1])
    b = recorder.bundle(reason="unit")
    q = b["queries"]
    assert set(q) == {"inflight", "recent", "principals"}
    assert q["recent"][-1]["principal"] == "tenant-c"
    assert q["principals"]["tenant-c"]["queries"] == 1
    assert b["device_memory"]["totals"]["registered"] > 0
    assert b["profile"]["ledger"]["kernels"]
