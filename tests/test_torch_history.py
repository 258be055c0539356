"""The port's workload history plane (``obs.history``) against the JAX
package's.

* The store: size and age rotation, retention, torn tails, alien
  versions and per-pid open segments give the same records, counters
  and events in both packages; a writer killed mid-append leaves a
  directory that both packages load alike.
* The format is shared: a directory that the JAX package's
  ``HistoryStore`` writes, with rotation, retention and compaction,
  gives the port's ``report``, ``merged_windows`` and ``load_records``
  results equal to the JAX package's, and the other way round.
* Exact merges: compaction equals the in-memory fold, and
  ``fleet.merge_history`` over workers of either package equals the
  single-store oracle bit for bit.
* The feed: ``accounting.complete`` writes exactly one record per query
  (ok, error, cancelled) in both packages, equal but for ids, times and
  ``compiles`` (0 in the port, ROADMAP C14); a write fault costs
  ``history/write_errors``, never the query; the plane follows
  ``mosaic.history.dir``.
* ``tools/mosaicstat_torch.py`` prints what ``tools/mosaicstat.py``
  prints and exits alike, and runs in a process with no JAX.
* The heat halves of tests/test_history.py's heat cases live in
  tests/test_torch_store.py; here only their history half: a store scan
  under a query fills its record's partition columns as in the JAX
  package, and the dashboard's history panel carries the heat report.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.accounting import accounted as jaccounted
from mosaic_tpu.obs.accounting import audit as jaudit
from mosaic_tpu.obs.accounting import meter as jmeter
from mosaic_tpu.obs.dashboard import _history_payload as j_history_payload
from mosaic_tpu.obs.fleet import merge_history as jmerge_history
from mosaic_tpu.obs.heat import heat as jheat
from mosaic_tpu.obs.inflight import QueryCancelled as JQueryCancelled
from mosaic_tpu.obs.inflight import checkpoint as jcheckpoint
from mosaic_tpu.obs.inflight import inflight as jinflight
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.resilience import faults as jfaults
from mosaic_tpu.store import ChipStore as JChipStore
from mosaic_tpu.store import write_store as jwrite_store
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics, recorder
from mosaic_tpu_torch.obs.accounting import accounted, audit, meter
from mosaic_tpu_torch.obs.dashboard import serve_dashboard
from mosaic_tpu_torch.obs.fleet import merge_history
from mosaic_tpu_torch.obs.heat import heat
from mosaic_tpu_torch.obs.inflight import (QueryCancelled, checkpoint,
                                           inflight)
from mosaic_tpu_torch.resilience.testing import fault_plan  # noqa: F401
from mosaic_tpu_torch.store import ChipStore, write_store

# the packages re-export their ``history`` feed under the module's name,
# so the modules are taken from the import system
jh = importlib.import_module("mosaic_tpu.obs.history")
th = importlib.import_module("mosaic_tpu_torch.obs.history")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(_REPO, "tools")
RES = 4096

P = dict(h=th, metrics=metrics, rec=recorder, audit=audit, meter=meter,
         heat=heat, config=tconfig, accounted=accounted,
         cancelled=QueryCancelled, inflight=inflight,
         checkpoint=checkpoint)
J = dict(h=jh, metrics=jmetrics, rec=jrec, audit=jaudit, meter=jmeter,
         heat=jheat, config=jconfig, accounted=jaccounted,
         cancelled=JQueryCancelled, inflight=jinflight,
         checkpoint=jcheckpoint)


def _reset(K):
    for k in ("audit", "meter", "heat", "metrics", "rec"):
        K[k].reset()
    K["h"].history.reset()


@pytest.fixture
def planes(monkeypatch):
    """Both packages' history feeds, audit logs, meters, heat, registries
    and recorders fresh, the history env pin off; restored after."""
    monkeypatch.delenv("MOSAIC_TPU_HISTORY_DIR", raising=False)
    monkeypatch.delenv("MOSAIC_TPU_HISTORY_WINDOW_MS", raising=False)
    prev = tconfig.default_config(), jconfig.default_config()
    was = metrics.enabled, jmetrics.enabled, jrec.enabled
    for K in (P, J):
        _reset(K)
        K["metrics"].enable()
        K["rec"].enable()
    yield
    tconfig._default_config, jconfig._default_config = prev
    for K, w in ((P, was[0]), (J, was[1])):
        _reset(K)
        if not w:
            K["metrics"].disable()
    if not was[2]:
        jrec.disable()


def _conf(K, **kv):
    cfg = K["config"].default_config()
    for k, v in kv.items():
        cfg = K["config"].apply_conf(cfg, k, v)
    K["config"].set_default_config(cfg)


def _rec(i, ts=100.0, principal="alice", outcome="ok", wall=5.0,
         operator="pip_join"):
    return {"query_id": f"q{i}", "principal": principal,
            "sql": f"SELECT {i}", "trace": f"t{i}",
            "start_ts": ts - 0.01, "end_ts": ts, "outcome": outcome,
            "operator": operator,
            "strategies": {"join": "bnl" if i % 2 else "hash"},
            "cost": {"wall_ms": wall, "device_s": 0.25,
                     "rows_in": 100, "rows_out": 50,
                     "h2d_bytes": 4096, "d2h_bytes": 128,
                     "mem_peak_bytes": 1 << 20, "compiles": 1},
            "mispredicts": i % 3, "fusion_groups": ["pip.fused"],
            "partitions": {"3": {"rows": 100, "bytes": 800},
                           "9": {"rows": 2, "bytes": 16}}}


def _counters(K, prefix="history/"):
    return {k: v for k, v in K["metrics"].report()["counters"].items()
            if k.startswith(prefix)}


def _events(K, kind):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq", "trace")}
            for e in K["rec"].events(kind)]


def _segment_records(K, directory):
    closed, opens = K["h"].segment_paths(directory)
    return ([K["h"].read_segment(p) for p in closed],
            [K["h"].read_segment(p) for p in opens])


def _cols(rec):
    """A record's columns but its ids (also where an error message names
    the query), times, measured wall and ``compiles`` (0 in the port,
    ROADMAP C14)."""
    out = {k: v for k, v in rec.items()
           if k not in ("query_id", "trace", "start_ts", "end_ts")}
    if "error" in out:
        out["error"] = out["error"].replace(rec["query_id"], "<query>")
    out["cost"] = {k: v for k, v in rec["cost"].items()
                   if k not in ("compiles", "wall_ms")}
    return out


def _tool(name):
    sys.path.insert(0, _TOOLS)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


# ------------------------------------------------------------ the format

def test_constants_and_names_equal_jax():
    assert th.HISTORY_VERSION == jh.HISTORY_VERSION == 1
    assert th._WALL_SCALE == jh._WALL_SCALE
    assert th._COST_FIELDS == jh._COST_FIELDS
    assert th.SLIP_THRESHOLD == jh.SLIP_THRESHOLD
    assert th.__all__ == jh.__all__


# ------------------------------------------------- rotation/retention

def test_append_rotates_and_retains(tmp_path, planes):
    got = {}
    for name, K in (("port", P), ("jax", J)):
        d = str(tmp_path / name)
        st = K["h"].HistoryStore(d, segment_bytes=600, retain=3)
        for i in range(30):
            st.append(_rec(i))
        st.close()
        closed, _ = K["h"].segment_paths(d)
        assert closed and len(closed) <= 3          # retention held
        assert closed == sorted(closed)
        got[name] = (_segment_records(K, d), _counters(K))
    assert got["port"] == got["jax"]
    c = got["port"][1]
    assert c["history/records_written"] == 30
    assert c["history/segments_rotated"] > 0
    assert c["history/segments_dropped"] > 0


def test_age_rotation(tmp_path, planes):
    got = {}
    for name, K in (("port", P), ("jax", J)):
        d = str(tmp_path / name)
        st = K["h"].HistoryStore(d, segment_bytes=1 << 20,
                                 segment_age_ms=1.0)
        st.append(_rec(0))
        time.sleep(0.02)
        st.append(_rec(1))                 # over age: rotates first
        st.close()
        got[name] = _segment_records(K, d)
    assert got["port"] == got["jax"]
    closed, opens = got["port"]
    assert [len(c) for c in closed] == [1] and [len(o) for o in opens] == [1]


# ------------------------------------------------------ degrade paths

def test_torn_tail_keeps_prefix(tmp_path, planes):
    st = th.HistoryStore(str(tmp_path))
    for i in range(5):
        st.append(_rec(i))
    st.close()
    path = th.segment_paths(str(tmp_path))[1][0]
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:len(raw) - 30])   # tear mid-record
    for K in (P, J):
        recs = K["h"].read_segment(path)
        assert [r["query_id"] for r in recs] == ["q0", "q1", "q2", "q3"]
        assert K["metrics"].counter_value("history/segments_torn") == 1
    assert _events(P, "history_segment_torn") == \
        _events(J, "history_segment_torn") != []


def test_alien_version_segment_skipped_whole(tmp_path, planes):
    path = tmp_path / "history-123.open.jsonl"
    with open(path, "w") as fh:
        fh.write(json.dumps({"history": th.HISTORY_VERSION + 99,
                             "pid": 123}) + "\n")
        fh.write(json.dumps(_rec(0)) + "\n")
    for K in (P, J):
        assert K["h"].read_segment(str(path)) == []
    ev = _events(P, "history_segment_torn")
    assert ev == _events(J, "history_segment_torn")
    assert "version" in ev[-1]["why"]
    with open(path, "w") as fh:                    # an unparseable header
        fh.write("{torn json\n")
    for K in (P, J):
        assert K["h"].read_segment(str(path)) == []
        assert K["metrics"].counter_value("history/segments_torn") == 2
    assert _events(P, "history_segment_torn") == \
        _events(J, "history_segment_torn")


def test_write_fault_costs_counter_not_query(tmp_path, planes, monkeypatch,
                                             fault_plan):
    spec = "seed=23;site=history.write,fails=1"
    fault_plan(spec)
    prev = jfaults.active()
    jfaults.arm(spec)
    got = {}
    try:
        for name, K in (("port", P), ("jax", J)):
            monkeypatch.setenv("MOSAIC_TPU_HISTORY_DIR", str(tmp_path / name))
            with K["accounted"]("join-a", principal="alice"):
                pass                               # survives the fault
            with K["accounted"]("join-b", principal="alice"):
                pass
            assert K["h"].history.write_errors() == 1
            assert K["metrics"].counter_value("history/write_errors") == 1
            assert len(K["audit"].records(limit=10)) == 2
            got[name] = K["h"].load_records(str(tmp_path / name))
    finally:
        if prev is None:
            jfaults.disarm()
        else:
            jfaults.arm(prev)
    assert [r["sql"] for r in got["port"]] == ["join-b"]
    assert [r["cost"]["compiles"] for r in got["port"]] == [0]
    assert [_cols(r) for r in got["port"]] == [_cols(r) for r in got["jax"]]


# -------------------------------------------------------- crash drill

def test_two_pids_one_directory(tmp_path, planes):
    """Per-pid open segments keep writers apart; a reader of either
    package merges both."""
    st = th.HistoryStore(str(tmp_path))
    st.append(_rec(0))
    st.close()
    other = tmp_path / "history-99999999.open.jsonl"
    with open(other, "w") as fh:
        fh.write(json.dumps({"history": th.HISTORY_VERSION,
                             "pid": 99999999,
                             "opened_ts": time.time()}) + "\n")
        fh.write(json.dumps(_rec(1, principal="bob")) + "\n")
    recs = th.load_records(str(tmp_path))
    assert {r["query_id"] for r in recs} == {"q0", "q1"}
    assert recs == jh.load_records(str(tmp_path))
    assert metrics.counter_value("history/segments_torn") == 0
    assert jmetrics.counter_value("history/segments_torn") == 0


_KILL_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["mosaic_tpu"] = None
sys.path.insert(0, {repo!r})
from mosaic_tpu_torch.obs.history import HistoryStore
st = HistoryStore({d!r}, segment_bytes=2000)
i = 0
while True:
    st.append({{"query_id": f"q{{i}}", "principal": "p",
               "outcome": "ok", "end_ts": 100.0, "operator": "scan",
               "cost": {{"wall_ms": 1.0}}}})
    i += 1
"""


def test_sigkill_mid_write_leaves_store_loadable(tmp_path):
    """kill -9 a port writer (a process with no JAX) mid-append: the
    directory loads in both packages, the loss confined to the open
    segment's torn tail."""
    child = subprocess.Popen(
        [sys.executable, "-c",
         _KILL_CHILD.format(repo=_REPO, d=str(tmp_path))],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and child.poll() is None:
            if len(th.segment_paths(str(tmp_path))[0]) >= 2:
                break                  # it rotated at least twice
            time.sleep(0.05)
    finally:
        os.kill(child.pid, signal.SIGKILL)
        _, err = child.communicate(timeout=30)
    closed, _ = th.segment_paths(str(tmp_path))
    assert len(closed) >= 2, err.decode()[-2000:]
    recs = th.load_records(str(tmp_path))         # must not raise
    assert recs and all(r["principal"] == "p" for r in recs)
    assert [r["query_id"] for r in jh.load_records(str(tmp_path))] == \
        [r["query_id"] for r in recs]
    assert sum(len(th.read_segment(p)) for p in closed) > 0


# --------------------------------------------- compaction/fleet merge

def test_compaction_matches_in_memory_oracle(tmp_path, planes):
    recs = [_rec(i, ts=100.0 + (i % 3), wall=float(2 ** (i % 8)))
            for i in range(40)]
    got = {}
    for name, K in (("port", P), ("jax", J)):
        d = str(tmp_path / name)
        st = K["h"].HistoryStore(d, window_ms=1_000.0)
        for r in recs:
            st.append(r)
        st.rotate()
        stats = st.compact()
        st.close()
        assert stats["records"] == 40 and stats["summaries"] == 3
        assert not K["h"].segment_paths(d)[0]     # segments gone
        assert K["metrics"].counter_value("history/segments_compacted") > 0
        got[name] = ([open(p).read() for p in K["h"].summary_paths(d)],
                     {k: v for k, v in stats.items()
                      if not k.startswith("bytes")})
    assert got["port"] == got["jax"]             # summary files byte-equal
    oracle = th.summarize_records(recs, 1_000.0)
    assert oracle == jh.summarize_records(recs, 1_000.0)
    merged = th.merged_windows(str(tmp_path / "jax"), 1_000.0)
    assert set(merged) == set(oracle)
    for wid in oracle:
        assert th.summary_payload(merged[wid]) == \
            jh.summary_payload(oracle[wid])


def _write_history(K, d, recs, seg_bytes, retain):
    """Three windows of records through one package's store, with
    rotation, retention and a compaction between two batches."""
    st = K["h"].HistoryStore(d, segment_bytes=seg_bytes, retain=retain,
                             window_ms=1_000.0)
    for r in recs[:24]:
        st.append(r)
    st.rotate()
    st.compact()
    for r in recs[24:]:
        st.append(r)
    st.rotate()
    for r in recs[:3]:                              # an open segment too
        st.append(dict(r, query_id=r["query_id"] + "-open"))
    st.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_directory(tmp_path, planes, writer):
    recs = [_rec(i, ts=100.0 + (i % 3),
                 principal=("alice", "bob")[i % 2],
                 outcome=("ok", "error", "cancelled")[i % 3],
                 wall=float(3 ** (i % 5)))
            for i in range(48)]
    d = str(tmp_path / writer)
    _write_history(P if writer == "port" else J, d, recs, 900, 6)
    assert th.summary_paths(d) and th.segment_paths(d)[0] and \
        th.segment_paths(d)[1]
    assert th.load_records(d) == jh.load_records(d)
    tw, jw = th.merged_windows(d, 1_000.0), jh.merged_windows(d, 1_000.0)
    assert tw == jw
    assert th.report(d, 1_000.0) == jh.report(d, 1_000.0)
    assert th.report(d, 500.0) == jh.report(d, 500.0)
    assert metrics.counter_value("history/segments_dropped") + \
        jmetrics.counter_value("history/segments_dropped") > 0


def test_fleet_merge_equals_single_oracle_bit_for_bit(tmp_path, planes):
    """One workload split across three workers, two written by the port
    and one by the JAX package: either package's merge equals the
    single-store summary exactly."""
    recs = [_rec(i, ts=100.0 + (i % 2),
                 principal=("alice", "bob", "carol")[i % 3],
                 outcome=("ok", "ok", "error", "cancelled")[i % 4],
                 wall=float(3 ** (i % 6)))
            for i in range(60)]
    dirs = []
    for w, K in enumerate((P, J, P)):
        d = tmp_path / f"worker{w}"
        st = K["h"].HistoryStore(str(d), window_ms=1_000.0)
        for r in recs[w::3]:
            st.append(r)
        st.rotate()
        if w == 1:
            st.compact()               # mixed: summaries + segments
        st.close()
        dirs.append(str(d))
    merged = merge_history(dirs, window_ms=1_000.0)
    assert merged == jmerge_history(dirs, window_ms=1_000.0)
    assert merged["errors"] == 0
    oracle = th.summarize_records(recs, 1_000.0)
    assert merged["windows"] == [th.summary_payload(oracle[w])
                                 for w in sorted(oracle)]
    assert merged["totals"]["queries"] == 60
    assert merged["totals"]["outcomes"] == {"cancelled": 15, "error": 15,
                                            "ok": 30}
    bad = merge_history(dirs + [str(tmp_path / "nope")], window_ms=1_000.0)
    assert bad == jmerge_history(dirs + [str(tmp_path / "nope")],
                                 window_ms=1_000.0)
    assert bad["totals"]["queries"] == 60


def test_window_diff_flags_regression(planes):
    for K in (P, J):
        h = K["h"]
        a = h.summarize_records([_rec(i, ts=1.0, wall=10.0)
                                 for i in range(20)], 1_000.0)[1]
        b = h.summarize_records([_rec(i, ts=2.5, wall=30.0)
                                 for i in range(20)], 1_000.0)[2]
        K["diff"] = h.window_diff(h.summary_payload(a), h.summary_payload(b))
        K["flat"] = h.window_diff(h.summary_payload(a), h.summary_payload(a))
    try:
        assert P["diff"] == J["diff"] and P["flat"] == J["flat"]
        assert P["diff"]["flagged"] == ["pip_join"]
        assert P["diff"]["operators"]["pip_join"]["slip_p50"] > 0.20
        assert P["flat"]["flagged"] == []
    finally:
        for K in (P, J):
            K.pop("diff", None)
            K.pop("flat", None)


# ------------------------------------------------------------ the feed

def _three_outcomes(K):
    with K["accounted"]("ok-query", principal="alice"):
        pass
    with pytest.raises(RuntimeError):
        with K["accounted"]("err-query", principal="alice"):
            raise RuntimeError("boom")
    with pytest.raises(K["cancelled"]):
        with K["accounted"]("cancel-query", principal="alice") as t:
            K["inflight"].cancel(t.query_id)
            K["checkpoint"]("test")


def test_one_record_per_query_all_outcomes(tmp_path, planes):
    got = {}
    for name, K in (("port", P), ("jax", J)):
        _conf(K, **{"mosaic.history.dir": str(tmp_path / name)})
        _three_outcomes(K)
        got[name] = th.load_records(str(tmp_path / name))
        assert K["metrics"].counter_value("history/records_written") == 3
    recs = got["port"]
    assert [r["outcome"] for r in recs] == ["ok", "error", "cancelled"]
    for r in recs:                        # widened columns present
        assert {"mispredicts", "fusion_groups", "partitions"} <= set(r)
        assert r["cost"]["compiles"] == 0
    assert [_cols(r) for r in recs] == [_cols(r) for r in got["jax"]]
    assert [sorted(r["cost"]) for r in recs] == \
        [sorted(r["cost"]) for r in got["jax"]]


def test_feed_off_by_default_and_follows_conf(tmp_path, planes):
    with accounted("q", principal="alice"):
        pass
    assert th.history.store() is None and th.history.directory() == ""
    _conf(P, **{"mosaic.history.dir": str(tmp_path)})
    with accounted("q2", principal="alice"):
        pass
    assert [r["sql"] for r in th.load_records(str(tmp_path))] == ["q2"]
    _conf(P, **{"mosaic.history.dir": ""})
    with accounted("q3", principal="alice"):
        pass
    assert th.history.store() is None
    assert [r["sql"] for r in th.load_records(str(tmp_path))] == ["q2"]


def test_store_scan_fills_the_partition_columns(tmp_path, planes):
    """The history half of the heat cases: a store scan inside a query
    charges its partitions to the query's record, as in the JAX
    package (the heat half is tests/test_torch_store.py's)."""
    rng = np.random.default_rng(5)
    pts = np.column_stack([rng.uniform(-74.3, -73.7, 8_000),
                           rng.uniform(40.5, 40.95, 8_000)])
    bbox = (-74.05, 40.6, -73.9, 40.75)
    got = {}
    for name, K, write, Store in (("port", P, write_store, ChipStore),
                                  ("jax", J, jwrite_store, JChipStore)):
        root = str(tmp_path / f"store_{name}")
        write(root, pts, grid_res=RES, shard_rows=1024)
        _conf(K, **{"mosaic.history.dir": str(tmp_path / name)})
        st = Store(root)
        with K["accounted"]("scan", principal="alice"):
            for _ in st.iter_chunks(bbox=bbox, chunk_rows=1024):
                pass
        (rec,) = th.load_records(str(tmp_path / name))
        got[name] = rec["partitions"]
    assert got["port"] == got["jax"] != {}
    assert sum(v["rows"] for v in got["port"].values()) > 0


# ------------------------------------------------- operator surfaces

def _stat_dir(tmp_path, K):
    d = tmp_path / "hist"
    st = K["h"].HistoryStore(str(d), window_ms=1_000.0)
    for i in range(10):
        st.append(_rec(i, ts=1.0, wall=10.0))
    for i in range(10):
        st.append(_rec(i + 10, ts=2.5, wall=40.0,
                       principal=("bob", "carol")[i % 2]))
    st.close()
    return d


@pytest.mark.parametrize("argv", [
    ["top", "--by", "wall_ms"], ["top", "--by", "rows_out", "--top", "3"],
    ["principals"], ["strategies"], ["heatmap"], ["heatmap", "--top", "1"],
    ["report"], ["diff"], ["diff", "--json"], ["layout", "--json"],
])
def test_mosaicstat_matches_the_jax_tool(tmp_path, planes, capsys, argv):
    mosaicstat, mosaicstat_torch = _tool("mosaicstat"), \
        _tool("mosaicstat_torch")
    d = _stat_dir(tmp_path, P)
    base = ["--dir", str(d), "--window-ms", "1000"]
    rt = mosaicstat_torch.main(base + argv)
    out_t = capsys.readouterr()
    rj = mosaicstat.main(base + argv)
    out_j = capsys.readouterr()
    assert (rt, out_t.out, out_t.err) == (rj, out_j.out, out_j.err)
    assert rt == (3 if argv[0] == "diff" else 0)


def test_mosaicstat_cli_and_diff_gate(tmp_path, planes, capsys):
    mosaicstat, mosaicstat_torch = _tool("mosaicstat"), \
        _tool("mosaicstat_torch")
    d = _stat_dir(tmp_path, J)
    for argv in (["--dir", str(d), "--dir", str(d), "--window-ms", "1000",
                  "principals"],
                 ["--dir", str(tmp_path / "void"), "--window-ms", "1000",
                  "top"],
                 ["principals", "--dir", str(d)],
                 ["diff", "--window-ms", "1000", "--dir", str(d)]):
        rt = mosaicstat_torch.main(argv)
        out_t = capsys.readouterr()
        rj = mosaicstat.main(argv)
        out_j = capsys.readouterr()
        assert (rt, out_t.out, out_t.err) == (rj, out_j.out, out_j.err)
    assert mosaicstat_torch.main(["--dir", str(tmp_path / "void"),
                                  "top"]) == 1
    capsys.readouterr()


def test_mosaicstat_runs_without_jax(tmp_path, planes):
    d = _stat_dir(tmp_path, P)
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['mosaic_tpu'] = None; "
            f"sys.argv = ['mosaicstat_torch.py', '--dir', {str(d)!r}, "
            "'--window-ms', '1000', 'report']; "
            f"runpy.run_path({os.path.join(_TOOLS, 'mosaicstat_torch.py')!r},"
            " run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout) == jh.report(str(d), 1_000.0)


def test_dashboard_history_endpoint(tmp_path, planes, monkeypatch):
    for K in (P, J):
        _conf(K, **{"mosaic.heat.halflife.ms": "0"})
    monkeypatch.setenv("MOSAIC_TPU_HISTORY_DIR", str(tmp_path / "port"))
    with accounted("q-dash", principal="alice"):
        pass
    for K in (P, J):
        K["heat"].touch(5, rows=42, nbytes=84)
    handle = serve_dashboard(port=0)
    try:
        url = f"http://127.0.0.1:{handle.port}/api/history"
        resp = urllib.request.urlopen(url, timeout=30)
        assert resp.headers["Cache-Control"] == "no-store"
        payload = json.loads(resp.read())
        assert payload["enabled"] is True
        assert payload["totals"]["queries"] == 1
        assert payload["heat"]["cells"][0]["cell"] == 5
        want = json.loads(json.dumps(j_history_payload({}), default=str))
        assert {k: v for k, v in payload.items() if k != "heat"} == \
            {k: v for k, v in want.items() if k != "heat"}
        assert payload["heat"]["cells"] == want["heat"]["cells"]
        monkeypatch.setenv("MOSAIC_TPU_HISTORY_DIR", "")
        payload = json.loads(urllib.request.urlopen(url, timeout=30).read())
        assert payload["enabled"] is False
    finally:
        handle.close()
