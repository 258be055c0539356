"""The port's SQL engine (``mosaic_tpu_torch.sql``) against the JAX
package's: a counterpart of each of tests/test_sql.py's 28 cases.

Each case builds the same tables (the same numpy data, each package's own
geometry arrays) in a session of each package and runs the same queries
through both; the result tables have the same columns in the same order,
numeric, id, boolean and text columns bit-equal and geometry buffers
equal, and the port's also satisfies the JAX case's own assertions.
Results of registry calls keep the tolerance the function's
tests/test_torch_functions.py case states: ``st_area`` within 1e-12 of
the row's sum of |terms| (``area_terms``); every other name here is
bit-equal there.  Both contexts are CUSTOM(-180,180,-90,90,2,360,180) as
in tests/test_sql.py; the port runs on the CPU (``device="cpu"``), where
every kernel wrapper runs its plain version, and the JAX package's
tessellation on its numpy branches (ROADMAP C4).

The sharded case binds a gloo world of one process to the port's context
(``use_mesh``), where the JAX case binds a mesh of four devices: the
port's exchange moves its rows through one rank's ``all_to_all``.
"""

import threading

import numpy as np
import pytest

import mosaic_tpu as J
import mosaic_tpu.core.tessellate as jtess_module
import mosaic_tpu_torch as T
from mosaic_tpu import config as jconfig
from mosaic_tpu.functions.context import MosaicContext as JContext
from mosaic_tpu.sql import SQLError as JSQLError
from mosaic_tpu.sql import SQLSession as JSession
from mosaic_tpu.sql import parse as jparse
from mosaic_tpu.sql import prettified as jprettified
from mosaic_tpu.sql.planner import planner as jplanner
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.functions.context import MosaicContext as TContext
from mosaic_tpu_torch.sql import (SQLError, SQLParseError, SQLSession,
                                  parse, prettified)
from mosaic_tpu_torch.sql.planner import planner as tplanner

from test_torch_functions import area_terms, same

GRID = "CUSTOM(-180,180,-90,90,2,360,180)"


@pytest.fixture(autouse=True)
def jax_numpy_branches(monkeypatch):
    """The JAX package's tessellation on its numpy branches, which the
    port copies (ROADMAP C4)."""
    monkeypatch.setattr(jtess_module, "_f64_jit_enabled",
                        lambda disable_env=None: False)


@pytest.fixture(autouse=True)
def restore_configs():
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)


@pytest.fixture(scope="module")
def mcs():
    return JContext.build(GRID), TContext.build(GRID, device="cpu")


@pytest.fixture(scope="module")
def sessions(mcs):
    return JSession(mcs[0]), SQLSession(mcs[1])


def both(sessions, name, make):
    """Create table ``name`` in both sessions from ``make(pkg)``."""
    js, ts = sessions
    js.create_table(name, make(J))
    ts.create_table(name, make(T))


def same_table(j, t, tol=None):
    assert list(t.columns) == list(j.columns)
    assert len(t) == len(j)
    for c in t.columns:
        same(j.columns[c], t.columns[c], (tol or {}).get(c))


def run(sessions, query, tol=None):
    """``query`` through both sessions: equal tables; the port's."""
    js, ts = sessions
    j, t = js.sql(query), ts.sql(query)
    same_table(j, t, tol)
    return t


def raises_both(sessions, query, exc_pair, match=None):
    js, ts = sessions
    with pytest.raises(exc_pair[0], match=match) as je:
        js.sql(query)
    with pytest.raises(exc_pair[1], match=match) as te:
        ts.sql(query)
    assert str(te.value) == str(je.value)


def _zones(pkg):
    b = pkg.GeometryBuilder()
    b.add_polygon(np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 10.0],
                            [0.0, 10.0], [0.0, 0.0]]))
    b.add_polygon(np.array([[10.0, 0.0], [20.0, 0.0], [20.0, 10.0],
                            [10.0, 10.0], [10.0, 0.0]]))
    return b.finish()


def _points(pkg, n=200, seed=7):
    rng = np.random.default_rng(seed)
    xy = np.column_stack([rng.uniform(0.5, 19.5, n),
                          rng.uniform(0.5, 9.5, n)])
    return pkg.GeometryArray.from_points(xy)


def test_select_where_order_limit(sessions):
    both(sessions, "t", lambda p: {
        "a": np.array([3.0, 1.0, 2.0, 4.0]),
        "b": np.array([1, 2, 3, 4], np.int64)})
    out = run(sessions, "SELECT a, b FROM t WHERE a > 1.5 ORDER BY a DESC "
                        "LIMIT 2")
    assert out.columns["a"].tolist() == [4.0, 3.0]
    assert out.columns["b"].tolist() == [4, 1]


def test_expressions_and_aliases(sessions):
    both(sessions, "e", lambda p: {"x": np.array([1.0, 2.0, 3.0])})
    out = run(sessions, "SELECT x * 2 + 1 AS y, -x AS neg FROM e")
    assert out.columns["y"].tolist() == [3.0, 5.0, 7.0]
    assert out.columns["neg"].tolist() == [-1.0, -2.0, -3.0]


def test_st_functions_from_sql(sessions):
    both(sessions, "geoms", lambda p: {"geom": _zones(p),
                                       "name": ["west", "east"]})
    tol = area_terms(_zones(T))
    out = run(sessions, "SELECT name, st_area(geom) AS area FROM geoms",
              tol={"area": tol})
    assert np.allclose(out.columns["area"], [100.0, 100.0], rtol=0,
                       atol=tol)
    out2 = run(sessions, "SELECT st_xmin(geom) AS x0 FROM geoms "
                         "WHERE name = 'east'")
    assert out2.columns["x0"].tolist() == [10.0]


def test_group_by_aggregates(sessions):
    both(sessions, "g", lambda p: {
        "k": np.array([1, 1, 2, 2, 2], np.int64),
        "v": np.array([1.0, 3.0, 5.0, 7.0, 9.0])})
    out = run(sessions, "SELECT k, count(*) AS n, avg(v) AS m, sum(v) s "
                        "FROM g GROUP BY k ORDER BY k")
    assert out.columns["n"].tolist() == [2, 3]
    assert out.columns["m"].tolist() == [2.0, 7.0]
    assert out.columns["s"].tolist() == [4.0, 21.0]


def test_tessellate_explode_generator(sessions, mcs):
    both(sessions, "zones", lambda p: {"geom": _zones(p),
                                       "zid": np.array([10, 20], np.int64)})
    out = run(sessions, "SELECT zid, grid_tessellateexplode(geom, 3) "
                        "FROM zones")
    assert set(out.columns) == {"zid", "is_core", "index_id", "wkb"}
    chips = mcs[1].grid_tessellate(_zones(T), 3, keep_core_geom=False)
    assert len(out) == len(chips)
    assert np.array_equal(np.sort(out.columns["index_id"]),
                          np.sort(chips.cell_id))
    assert set(out.columns["zid"].tolist()) == {10, 20}


def test_quickstart_pip_join_in_sql(sessions, mcs):
    """The reference Quickstart join, written in SQL: equal in both
    packages and to the host-truth assignment."""
    js, ts = sessions
    res = 3
    for s, mc, p in ((js, mcs[0], J), (ts, mcs[1], T)):
        s.create_table("zones", {"geom": _zones(p),
                                 "zid": np.arange(2, dtype=np.int64)})
        s.create_table("chips", s.sql(
            "SELECT zid, grid_tessellateexplode(geom, 3) FROM zones"
        ).to_dict())
        pts = _points(p)
        s.create_table("pts", {
            "pgeom": pts, "cell": mc.grid_pointascellid(pts, res),
            "pid": np.arange(len(pts), dtype=np.int64)})
    same_table(js.table("chips"), ts.table("chips"))
    same_table(js.table("pts"), ts.table("pts"))
    out = run(sessions,
              "SELECT pid, zid FROM pts JOIN chips ON pts.cell = "
              "chips.index_id WHERE is_core OR st_contains(wkb, pgeom)")
    xy = _points(T).coords
    want = (xy[:, 0] >= 10.0).astype(np.int64)
    got = np.full(len(xy), -1, np.int64)
    got[out.columns["pid"]] = out.columns["zid"]
    assert np.array_equal(got, want)
    assert len(out) == len(xy)


def test_kring_explode_generator(sessions, mcs):
    cells = mcs[1].grid_pointascellid(_points(T, 5), 3)
    assert np.array_equal(cells, mcs[0].grid_pointascellid(_points(J, 5),
                                                           3))
    both(sessions, "c", lambda p: {"cell": cells.copy(),
                                   "row": np.arange(5, dtype=np.int64)})
    out = run(sessions, "SELECT row, grid_cellkringexplode(cell, 1) AS nbr "
                        "FROM c")
    src, flat = mcs[1].grid_cellkringexplode(cells, 1)
    assert np.array_equal(out.columns["nbr"], flat)
    assert np.array_equal(out.columns["row"], src)


def test_join_requires_equality(sessions):
    both(sessions, "a1", lambda p: {"x": np.array([1, 2], np.int64)})
    both(sessions, "b1", lambda p: {"y": np.array([1, 2], np.int64)})
    raises_both(sessions, "SELECT x FROM a1 JOIN b1 ON x < y",
                (JSQLError, SQLError))


@pytest.mark.parametrize("q", ["SELECT FROM t", "SELECT a FROM t WHERE ???"])
def test_parse_errors(q):
    from mosaic_tpu.sql import SQLParseError as JParseError
    with pytest.raises(JParseError) as je:
        jparse(q)
    with pytest.raises(SQLParseError) as te:
        parse(q)
    assert str(te.value) == str(je.value)


def test_unknown_function_and_table(sessions):
    both(sessions, "u", lambda p: {"x": np.array([1.0])})
    raises_both(sessions, "SELECT nope_fn(x) FROM u", (JSQLError, SQLError))
    raises_both(sessions, "SELECT x FROM missing_table",
                (JSQLError, SQLError))


def test_prettified(sessions):
    both(sessions, "p", lambda p: {
        "geom": _zones(p), "blob": [b"\x01\x02\x03" * 10, b"\x04"],
        "v": np.array([1.234567890123, 2.0])})
    txt = prettified(sessions[1].table("p"))
    assert txt == jprettified(sessions[0].table("p"))
    assert "POLYGON" in txt
    assert "0x" in txt and "…" in txt
    assert txt.count("\n") >= 5


def test_star_and_qualified_columns(sessions):
    both(sessions, "s1", lambda p: {"k": np.array([1, 2], np.int64),
                                    "v": np.array([10.0, 20.0])})
    both(sessions, "s2", lambda p: {"k": np.array([2, 1], np.int64),
                                    "w": np.array([7.0, 8.0])})
    out = run(sessions, "SELECT s1.k AS k, v, w FROM s1 JOIN s2 "
                        "ON s1.k = s2.k ORDER BY k")
    assert out.columns["k"].tolist() == [1, 2]
    assert out.columns["w"].tolist() == [8.0, 7.0]
    allc = run(sessions, "SELECT * FROM s1")
    assert set(allc.columns) == {"k", "v"}


def test_geometry_kring_explode_functions(mcs):
    jmc, tmc = mcs
    src, cells = tmc.grid_geometrykringexplode(_zones(T), 3, 1)
    jsrc, jcells = jmc.grid_geometrykringexplode(_zones(J), 3, 1)
    assert np.array_equal(src, jsrc) and np.array_equal(cells, jcells)
    assert len(src) == len(cells) and len(cells) > 0
    loops_src, loops = tmc.grid_geometrykloopexplode(_zones(T), 3, 2)
    jl_src, jloops = jmc.grid_geometrykloopexplode(_zones(J), 3, 2)
    assert np.array_equal(loops_src, jl_src)
    assert np.array_equal(loops, jloops)
    ring1 = set(cells[src == 0].tolist())
    loop2 = set(loops[loops_src == 0].tolist())
    assert ring1.isdisjoint(loop2)


def test_function_errors_pass_through(sessions):
    """A ValueError raised INSIDE a registered function surfaces as-is,
    not relabelled 'unknown function'."""
    both(sessions, "w", lambda p: {"s": ["NOT A WKT"]})
    raises_both(sessions, "SELECT st_geomfromwkt(s) AS g FROM w",
                (ValueError, ValueError), match="WKT parse error")


def test_self_join_requires_aliases(sessions):
    both(sessions, "sj", lambda p: {"k": np.array([1, 2], np.int64)})
    raises_both(sessions, "SELECT k FROM sj JOIN sj ON sj.k = sj.k",
                (JSQLError, SQLError), match="distinct aliases")
    out = run(sessions, "SELECT a.k AS ka, b.k AS kb FROM sj a JOIN sj b "
                        "ON a.k = b.k ORDER BY ka")
    assert out.columns["ka"].tolist() == [1, 2]
    assert out.columns["kb"].tolist() == [1, 2]


def test_explode_with_where_filter(sessions):
    both(sessions, "zones", lambda p: {"geom": _zones(p),
                                       "zid": np.array([10, 20], np.int64)})
    allrows = run(sessions, "SELECT zid, grid_tessellateexplode(geom, 3) "
                            "FROM zones")
    core = run(sessions, "SELECT zid, grid_tessellateexplode(geom, 3) "
                         "FROM zones WHERE is_core")
    ncore = int(np.asarray(allrows.columns["is_core"]).sum())
    assert len(core) == ncore
    assert np.asarray(core.columns["is_core"]).all()
    assert len(core.columns["zid"]) == len(core.columns["index_id"])


def test_group_by_rejects_ungrouped_column(sessions):
    both(sessions, "g2", lambda p: {
        "k": np.array([1, 1, 2], np.int64),
        "v": np.array([1.0, 2.0, 3.0])})
    raises_both(sessions, "SELECT v, count(*) FROM g2 GROUP BY k",
                (JSQLError, SQLError), match="GROUP BY")


def test_count_column_skips_nulls(sessions):
    both(sessions, "g3", lambda p: {
        "k": np.array([1, 1, 2], np.int64),
        "v": np.array([1.0, np.nan, 3.0])})
    out = run(sessions, "SELECT k, count(v) AS n FROM g3 GROUP BY k "
                        "ORDER BY k")
    assert out.columns["n"].tolist() == [1, 1]


def test_order_by_non_projected_column(sessions):
    both(sessions, "g4", lambda p: {
        "a": np.array([3, 1, 2], np.int64),
        "b": np.array([30, 10, 20], np.int64)})
    out = run(sessions, "SELECT b FROM g4 ORDER BY a")
    assert out.columns["b"].tolist() == [10, 20, 30]


def test_left_join(sessions):
    both(sessions, "l", lambda p: {"k": np.array([1, 2, 3], np.int64),
                                   "a": np.array([10., 20., 30.])})
    both(sessions, "r", lambda p: {"k": np.array([1, 3], np.int64),
                                   "b": np.array([100., 300.])})
    out = run(sessions, "SELECT l.k, a, b FROM l LEFT JOIN r "
                        "ON l.k = r.k ORDER BY a")
    assert out.columns["k"].tolist() == [1, 2, 3]
    b = np.asarray(out.columns["b"], np.float64)
    assert b[0] == 100.0 and np.isnan(b[1]) and b[2] == 300.0
    out2 = run(sessions, "SELECT l.k FROM l LEFT OUTER JOIN r "
                         "ON l.k = r.k")
    assert len(out2) == 3


def test_left_join_null_semantics(sessions):
    both(sessions, "l2", lambda p: {"k": np.array([1, 2, 3], np.int64),
                                    "a": np.array([10., 20., 30.])})
    both(sessions, "r0", lambda p: {"k": np.empty(0, np.int64),
                                    "b": np.empty(0)})
    out = run(sessions, "SELECT l2.k, b FROM l2 LEFT JOIN r0 "
                        "ON l2.k = r0.k")
    assert len(out) == 3
    assert all(v is None or (isinstance(v, float) and np.isnan(v))
               for v in list(out.columns["b"]))
    big = 613196571542765567
    both(sessions, "rc", lambda p: {"k": np.array([1], np.int64),
                                    "cell": np.array([big], np.int64)})
    out2 = run(sessions, "SELECT l2.k, cell FROM l2 LEFT JOIN rc "
                         "ON l2.k = rc.k ORDER BY a")
    assert list(out2.columns["cell"])[0] == big
    assert list(out2.columns["cell"])[1] is None
    both(sessions, "rv", lambda p: {"k": np.array([1, 3], np.int64),
                                    "v": np.array([100., 300.])})
    js, ts = sessions
    for s in sessions:
        s.create_table("lj", s.sql(
            "SELECT l2.k AS k, v FROM l2 LEFT JOIN rv ON l2.k = rv.k"
        ).to_dict())
    agg = run(sessions, "SELECT sum(v) AS s, count(v) AS n FROM lj")
    assert agg.columns["s"].tolist() == [400.0]
    assert agg.columns["n"].tolist() == [2]
    both(sessions, "rg", lambda p: {"k": np.array([1], np.int64),
                                    "g": p.read_wkt(["POINT (0 0)"])})
    raises_both(sessions, "SELECT l2.k, g FROM l2 LEFT JOIN rg "
                          "ON l2.k = rg.k", (JSQLError, SQLError),
                match="null")


def test_group_by_having(sessions):
    both(sessions, "h1", lambda p: {
        "k": np.array([1, 1, 2, 2, 2, 3], np.int64),
        "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])})
    out = run(sessions, "SELECT k, count(*) AS n, sum(v) AS s FROM h1 "
                        "GROUP BY k HAVING count(*) >= 2 ORDER BY k")
    assert out.columns["k"].tolist() == [1, 2]
    assert out.columns["n"].tolist() == [2, 3]
    out2 = run(sessions, "SELECT k FROM h1 GROUP BY k "
                         "HAVING sum(v) > 3 AND k < 3")
    assert sorted(np.asarray(out2.columns["k"]).tolist()) == [2]


def test_having_edge_cases(sessions):
    both(sessions, "h2", lambda p: {
        "k": np.array([1, 1, 2], np.int64),
        "v": np.array([1.0, 2.0, 3.0])})
    out = run(sessions, "SELECT count(*) AS n FROM h2 HAVING count(*) > 5")
    assert len(out) == 0
    out2 = run(sessions, "SELECT count(*) AS n FROM h2 "
                         "HAVING count(*) > 2")
    assert out2.columns["n"].tolist() == [3]
    out3 = run(sessions, "SELECT k FROM h2 GROUP BY k "
                         "HAVING -sum(v) < -2.5")
    assert sorted(np.asarray(out3.columns["k"]).tolist()) == [1, 2]
    raises_both(sessions, "SELECT k FROM h2 GROUP BY k HAVING v > 1.5",
                (JSQLError, SQLError), match="GROUP BY")


#: EXPLAIN ANALYZE columns measured by each run (wall time, allocations)
MEASURED = ("time_ms", "peak_bytes")


def same_profile(j, t):
    """EXPLAIN ANALYZE tables: every column but the measured ones equal."""
    assert list(t.columns) == list(j.columns)
    for c in t.columns:
        if c not in MEASURED:
            same(j.columns[c], t.columns[c])
    for c in MEASURED:
        assert np.asarray(t.columns[c]).dtype == \
            np.asarray(j.columns[c]).dtype
        assert len(t.columns[c]) == len(j.columns[c])


def test_explain_and_explain_analyze(sessions):
    jplanner.reset()
    tplanner.reset()
    both(sessions, "ea", lambda p: {
        "k": np.array([1, 2, 3, 4], np.int64),
        "v": np.array([1.0, 2.0, 3.0, 4.0])})
    plan = run(sessions, "EXPLAIN SELECT k FROM ea WHERE v > 1.5")
    ops = list(plan.columns["operator"])
    assert ops == ["scan", "filter", "project"]
    assert "rows" not in plan.columns
    assert all(isinstance(s, str) and s for s in plan.columns["strategy"])
    js, ts = sessions
    q = "EXPLAIN ANALYZE SELECT k, v FROM ea WHERE v > 1.5 ORDER BY v " \
        "DESC LIMIT 2"
    j, out = js.sql(q), ts.sql(q)
    same_profile(j, out)
    ops = list(out.columns["operator"])
    assert ops == ["scan", "filter", "project", "order", "limit"]
    rows = dict(zip(ops, out.columns["rows"].tolist()))
    assert rows["scan"] == 4 and rows["filter"] == 3 and rows["limit"] == 2
    assert out.columns["rows"].dtype == np.int64
    assert all(t >= 0.0 for t in out.columns["time_ms"].tolist())
    assert dict(zip(ops, out.columns["est_rows"].tolist()))["scan"] == 4
    q = "EXPLAIN ANALYZE SELECT k, count(*) AS n FROM ea GROUP BY k"
    j, agg = js.sql(q), ts.sql(q)
    same_profile(j, agg)
    aops = list(agg.columns["operator"])
    assert "aggregate" in aops and "project" not in aops
    assert dict(zip(aops, agg.columns["rows"].tolist()))["aggregate"] == 4
    assert agg.columns["all_to_all_bytes"].tolist() == [0, 0]
    assert agg.columns["shard_skew"].tolist() == [0.0, 0.0]
    assert list(agg.columns["device_ms"]) == ["-", "-"]
    assert list(plan.columns["fused"]) == ["-", "-", "-"]
    assert list(out.columns["fused"]) == ["-"] * len(ops)
    assert list(agg.columns["fused"]) == ["-", "-"]


def test_explain_est_bytes_and_peak_bytes(sessions):
    both(sessions, "eb", lambda p: {
        "k": np.arange(8, dtype=np.int64),
        "v": np.arange(8, dtype=np.float64)})
    plan = run(sessions, "EXPLAIN SELECT k FROM eb WHERE v > 1.5")
    est = dict(zip(plan.columns["operator"],
                   plan.columns["est_bytes"].tolist()))
    assert plan.columns["est_bytes"].dtype == np.int64
    assert est["scan"] == 8 * 16
    js, ts = sessions
    q = "EXPLAIN ANALYZE SELECT k FROM eb WHERE v > 1.5"
    j, out = js.sql(q), ts.sql(q)
    same_profile(j, out)
    peak = out.columns["peak_bytes"]
    assert peak.dtype == np.int64 and len(peak) == 3
    assert all(b >= 0 for b in peak.tolist())
    for s in sessions:
        s.drop_table("eb")


def test_explain_fused_column(sessions):
    rng = np.random.default_rng(7)
    n = 4096
    a, b = rng.normal(size=n), rng.integers(0, 9, size=n)
    both(sessions, "eaf", lambda p: {"a": a.copy(), "b": b.copy()})
    q = ("SELECT count(*) AS n, max(a) AS mx FROM eaf "
         "WHERE a > 0.0 AND b < 5")
    for m in (jconfig, tconfig):
        m.set_default_config(m.apply_conf(
            m.default_config(), "mosaic.planner.force.fusion", "on"))
    plan = run(sessions, "EXPLAIN " + q)
    fused = dict(zip(plan.columns["operator"], plan.columns["fused"]))
    assert fused["filter"] == fused["aggregate"] == "g1"
    assert fused["scan"] == "-"
    js, ts = sessions
    j, out = js.sql("EXPLAIN ANALYZE " + q), ts.sql("EXPLAIN ANALYZE " + q)
    same_profile(j, out)
    fused = dict(zip(out.columns["operator"], out.columns["fused"]))
    assert fused["filter"] == fused["aggregate"] == "g1"
    times = dict(zip(out.columns["operator"],
                     out.columns["time_ms"].tolist()))
    assert times["aggregate"] <= times["filter"]
    run(sessions, q)
    for s in sessions:
        s.drop_table("eaf")


def test_explain_analyze_sharded_columns(sessions, mcs, tmp_path):
    """The sharded overlay under EXPLAIN ANALYZE: skew and all_to_all
    bytes on the operator row that moved them, in both packages (the
    port over a gloo world of one, the JAX package over four devices)."""
    import re

    import jax
    import torch.distributed as dist
    from mosaic_tpu.obs import metrics as jmetrics
    from mosaic_tpu_torch.obs import metrics
    both(sessions, "shpairs", lambda p: {"ga": _zones(p),
                                         "gb": _zones(p)})
    was = metrics.enabled, jmetrics.enabled
    metrics.enable()
    jmetrics.enable()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    q = ("EXPLAIN ANALYZE SELECT grid_intersects_sharded(ga, gb, 2) "
         "AS hit FROM shpairs")
    try:
        mcs[0].use_mesh(mesh)
        mcs[1].use_mesh(dist.group.WORLD)
        for out in (sessions[0].sql(q), sessions[1].sql(q)):
            by_op = {out.columns["operator"][i]: i
                     for i in range(len(out))}
            proj, scan = by_op["project"], by_op["scan"]
            assert out.columns["all_to_all_bytes"][proj] > 0
            assert out.columns["shard_skew"][proj] >= 1.0
            assert out.columns["all_to_all_bytes"][scan] == 0
            assert out.columns["shard_skew"][scan] == 0.0
            assert re.search(r"cpu:\d+=\d", out.columns["device_ms"][proj])
            assert out.columns["device_ms"][scan] == "-"
        res = run(sessions, "SELECT grid_intersects_sharded(ga, gb, 2) "
                            "AS hit FROM shpairs")
        assert np.asarray(res.columns["hit"]).tolist() == [True, True]
    finally:
        mcs[0].use_mesh(None)
        mcs[1].use_mesh(None)
        dist.destroy_process_group()
        if not was[0]:
            metrics.disable()
        if not was[1]:
            jmetrics.disable()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_concurrent_queries_interleave_with_disjoint_accounting(mcs, pkg):
    """Two sessions querying from two threads: disjoint tickets and
    per-trace span profiles, per-principal meter splits that add up —
    the same records in each package."""
    if pkg == "jax":
        from mosaic_tpu.obs import metrics, tracer
        from mosaic_tpu.obs.accounting import audit, meter
        mc, Session = mcs[0], JSession
    else:
        from mosaic_tpu_torch.obs import metrics, tracer
        from mosaic_tpu_torch.obs.accounting import audit, meter
        mc, Session = mcs[1], SQLSession
    audit.reset()
    meter.reset()
    metrics.reset()
    metrics.enable()
    tracer.enable()
    barrier = threading.Barrier(2)

    def worker(principal, n):
        s = Session(mc)
        s.principal = principal
        s.create_table("t", {"v": np.arange(float(n))})
        barrier.wait()
        for _ in range(4):
            s.sql("SELECT v FROM t WHERE v < 1e9")

    try:
        ts = [threading.Thread(target=worker, args=("alice", 30)),
              threading.Thread(target=worker, args=("bob", 70))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
        recs = audit.records()
        assert len(recs) == 8
        assert len({r["query_id"] for r in recs}) == 8
        assert len({r["trace"] for r in recs}) == 8
        traces = tracer.report()["traces"]
        for r in recs:
            assert r["trace"] in traces
            assert traces[r["trace"]]["spans"]
        rep = meter.report()
        assert rep["alice"]["queries"] == rep["bob"]["queries"] == 4
        assert rep["alice"]["rows_out"] == 4 * 30
        assert rep["bob"]["rows_out"] == 4 * 70
        assert rep["alice"]["outcomes"] == {"ok": 4}
    finally:
        tracer.disable()
        tracer.reset()
        metrics.disable()
        metrics.reset()
        audit.reset()
        meter.reset()


def test_classify_batchable_and_table_surface(sessions):
    """``classify_batchable`` (the serve layer's probe) and the
    ``Table`` surface give the JAX package's answers."""
    from mosaic_tpu.sql.engine import classify_batchable as jclassify
    from mosaic_tpu_torch.sql import classify_batchable
    both(sessions, "bp", lambda p: {"lon": np.array([1.0, 2.0]),
                                    "lat": np.array([3.0, 4.0]),
                                    "id": np.array([7, 8], np.int64)})
    js, ts = sessions
    for q in ("SELECT id, grid_longlatascellid(lon, lat, 3) AS c FROM bp",
              "SELECT grid_longlatascellid(lon, lat, 3) FROM bp",
              "SELECT id FROM bp WHERE lon > 1",
              "SELECT grid_longlatascellid(lon, lat, 3) FROM missing",
              "NOT SQL AT ALL"):
        j, t = jclassify(q, js), classify_batchable(q, ts)
        assert (j is None) == (t is None)
        if t is not None:
            assert (t.table, t.func, t.res, t.lon, t.lat, t.outputs,
                    t.rows, t.signature) == \
                (j.table, j.func, j.res, j.lon, j.lat, j.outputs, j.rows,
                 j.signature)
    assert classify_batchable("SELECT grid_longlatascellid(lon, lat, 3) "
                              "FROM bp", ts, max_rows=1) is None
    t = ts.table("bp")
    assert repr(t) == repr(js.table("bp"))
    same_table(js.table("bp").head(1), t.head(1))


def test_rowwise_predicates_in_blocks(mcs):
    """``st_contains`` over more rows than a block (256 on the CPU)
    equals the JAX package's one [N, N] call's diagonal."""
    from mosaic_tpu_torch.functions.context import ROWWISE_ROWS
    n = 3 * ROWWISE_ROWS["cpu"] + 17
    rng = np.random.default_rng(21)
    xy = np.column_stack([rng.uniform(-1, 21, n), rng.uniform(-1, 11, n)])
    which = rng.integers(0, 2, n)
    got, want = [], []
    for mc, p, out in ((mcs[1], T, got), (mcs[0], J, want)):
        polys = _zones(p).take(which)
        pts = p.GeometryArray.from_points(xy)
        out.append(mc.st_contains(polys, pts))
        out.append(mc.st_within(pts, polys))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    assert 0 < got[0].sum() < n
