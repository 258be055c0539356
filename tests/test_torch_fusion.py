"""The port's whole-query fusion (``perf/fusion.py``, K14's plain version
``ops/fused_group.fused_group_ref``) against the JAX package's.

* A counterpart of each of tests/test_fusion.py's 16 cases, run through
  a session of each package over the same tables: group formation and
  every eligibility break give the same EXPLAIN ``fused`` column; fused
  and unfused results are bit-equal in each package and to each other;
  the runtime bailouts, one XLA program per (group, pow2 bucket) and one
  encoded K14 program per group (the port's ``kernel_cache`` entry), the
  kernel-ledger rows, the planner's learned flip, the pins, the
  ``mosaic.fusion.max.ops`` cap and the conf keys' validation.
* Group by group, the port's encoded program through
  ``fused_group_ref`` against the JAX package's ``_build_program`` run
  on the CPU over the same padded columns: the passing-row count, the
  mask, every projected value of a live row and every aggregate output
  bit-equal (float aggregates compared as float64 bits, the JAX
  program's float32 values widened exactly).
* The hazards, each a case: an FMA-sensitive product-sum (XLA:CPU
  contracts it, and divides int / 3 by a reciprocal, so there the JAX
  package's fused values stray an ulp from its own unfused ones; the
  port's fused values equal the unfused, numpy's, bit for bit); float
  literals against int64 and float32 columns (torch alone would
  promote int64 x float to float32) and int / int; int64 and int32
  overflow, int8 and int16 wrap, float16 rounded a node at a time; NaN
  in masks, comparisons and IS NULL, IS NULL on an integer
  column; -0.0 beside 0.0 in min and max (XLA's order: -0.0 below +0.0;
  numpy's unfused min is order-dependent, and the two compare equal);
  ``n`` below the bucket, whose padded rows never count.
* The tile edges of K14 (``tests/torch_fusion_cases.py`` EDGE_CASES and
  the deep WHERE): n = 1, n below a tile, n not a multiple of the tile
  rows, n equal to the bucket, first() in the last tile, bool, int8 and
  float16 columns at an odd n, and 127 instructions that force the
  smallest tile, each against ``_build_program``.
* K14's plan (``plan_program``): no slot is overwritten while an
  instruction that reads it has still to run, over every group here and
  over random programs of up to 128 instructions; P is the peak live
  count; the largest admitted programs fit a block; one that cannot fit
  raises in ``pack_inputs`` with the limit named.

The port's session runs on the CPU (``device="cpu"``), where
``fused_group`` runs ``fused_group_ref``.  The tables and queries live
in ``tests/torch_fusion_cases.py``, where ``chip_smoke.py`` phase 22b
takes them to hold K14 to ``fused_group_ref`` on the card.
"""

import numpy as np
import pytest
import torch

import jax

from mosaic_tpu import config as jconfig
from mosaic_tpu.functions.context import MosaicContext as JContext
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs import recorder as jrecorder
from mosaic_tpu.obs.profiler import ledger as jledger
from mosaic_tpu.perf import fusion as jfusion
from mosaic_tpu.perf.bucketing import pad_rows
from mosaic_tpu.perf.jit_cache import kernel_cache as jcache
from mosaic_tpu.sql import SQLSession as JSession
from mosaic_tpu.sql import parse as jparse
from mosaic_tpu.sql.planner import planner as jplanner
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.functions.context import MosaicContext as TContext
from mosaic_tpu_torch.obs import metrics, recorder
from mosaic_tpu_torch.obs.profiler import ledger
from mosaic_tpu_torch.ops import fused_group as fg
from mosaic_tpu_torch.perf import fusion as tfusion
from mosaic_tpu_torch.perf.bucketing import pow2_bucket
from mosaic_tpu_torch.perf.jit_cache import kernel_cache
from mosaic_tpu_torch.sql import SQLSession, parse
from mosaic_tpu_torch.sql.planner import planner as tplanner
from hypothesis import given, settings
from hypothesis import strategies as st
from torch_fusion_cases import (EDGE_CASES, HAZARDS, PADDING_QUERY,
                                PADDING_ROWS, PROGRAM_CASES,
                                SIGNED_ZERO_QUERY, XLA_REWRITES, deep_query,
                                deep_table, edge_table, hazard_table,
                                padding_table, signed_zero_tables)
from torch_fusion_cases import fx_table as _fx

GRID = "CUSTOM(-180,180,-90,90,2,360,180)"
PKGS = (jconfig, tconfig)


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
    js, ts = JSession(mcs[0]), SQLSession(mcs[1])
    for s in (js, ts):
        s.create_table("fx", {k: v.copy() for k, v in _fx().items()})
    return js, ts


def _set(key, value):
    for m in PKGS:
        m.set_default_config(m.apply_conf(m.default_config(), key, value))


def pin(mode):
    _set("mosaic.planner.force.fusion", mode)


def _assert_identical(a, b):
    assert list(a.columns) == list(b.columns)
    for col in a.columns:
        x, y = np.asarray(a.columns[col]), np.asarray(b.columns[col])
        assert x.dtype == y.dtype, (col, x.dtype, y.dtype)
        nan_ok = np.issubdtype(x.dtype, np.floating)
        assert np.array_equal(x, y, equal_nan=nan_ok), col


def _ab(s, q):
    pin("on")
    fused = s.sql(q)
    pin("off")
    unfused = s.sql(q)
    pin("auto")
    return fused, unfused


def _ab_both(sessions, q):
    """Fused and unfused in each package: all four equal."""
    (jf, ju), (tf, tu) = _ab(sessions[0], q), _ab(sessions[1], q)
    _assert_identical(jf, ju)
    _assert_identical(tf, tu)
    _assert_identical(jf, tf)
    return tf, tu


def _fused_ops(sessions, q):
    """The EXPLAIN ``fused`` column, equal in both packages."""
    got = []
    for s in sessions:
        plan = s.sql("EXPLAIN " + q)
        got.append({o: f for o, f in zip(plan.columns["operator"],
                                         plan.columns["fused"])})
    assert got[0] == got[1]
    return got[1]


# ------------------------------------------------- group formation

def test_group_covers_filter_and_aggregate(sessions):
    pin("on")
    fused = _fused_ops(sessions, "SELECT count(*) AS n, max(px) AS mx "
                                 "FROM fx WHERE py > 0.0 AND k < 50")
    assert fused["filter"] == fused["aggregate"] == "g1"
    assert fused["scan"] == "-"


def test_group_covers_filter_and_project(sessions):
    pin("on")
    fused = _fused_ops(sessions, "SELECT px + py AS s FROM fx "
                                 "WHERE k < 50")
    assert fused["filter"] == fused["project"] == "g1"


def test_lone_aggregate_still_fuses(sessions):
    pin("on")
    fused = _fused_ops(sessions, "SELECT sum(k) AS s, count(*) AS n "
                                 "FROM fx")
    assert fused["aggregate"] == "g1"


def test_lone_filter_does_not_fuse(sessions):
    pin("on")
    fused = _fused_ops(sessions, "SELECT * FROM fx WHERE k < 50")
    assert set(fused.values()) == {"-"}


# ------------------------------------------------- eligibility breaks

@pytest.mark.parametrize("q,expect", [
    ("SELECT count(*) AS n FROM fx WHERE tag = 'a' AND k < 50",
     {"filter": "-", "aggregate": "g1"}),
    ("SELECT k, count(*) AS n FROM fx WHERE py > 0.0 GROUP BY k",
     {"filter": "-", "aggregate": "-"}),
    ("SELECT tag AS t FROM fx WHERE k < 50",
     {"filter": "-", "project": "-"}),
    ("SELECT count(*) AS n FROM fx WHERE b32 + k > 10",
     {"filter": "-", "aggregate": "g1"}),
    ("SELECT count(*) AS n FROM fx WHERE k % 7 = 0",
     {"filter": "-", "aggregate": "g1"}),
    ("SELECT sum(px) AS s FROM fx WHERE k < 50",
     {"filter": "-", "aggregate": "-"}),
])
def test_eligibility_breaks(sessions, q, expect):
    pin("on")
    fused = _fused_ops(sessions, q)
    for op, want in expect.items():
        assert fused[op] == want, (q, fused)
    _ab_both(sessions, q)


# ------------------------------------------------- bit-for-bit parity

PARITY = [
    "SELECT count(*) AS n, max(px) AS mx, min(py) AS mn, sum(k) AS sk"
    " FROM fx WHERE px*px + py*py < 1.44 AND px > 0.1",
    "SELECT count(px) AS c, max(px) AS mx, avg(k) AS ak FROM fx "
    "WHERE py > 0.0",
    "SELECT -px AS np_, (k + 1) / 2 AS h, px * 0.5 + py AS m FROM fx "
    "WHERE flag OR py > 1.0",
    "SELECT count(*) AS n FROM fx WHERE px IS NULL OR k < 5",
    "SELECT count(*) AS n, first(k) AS f FROM fx "
    "WHERE px IS NOT NULL AND py < 0.0",
    "SELECT count(*) AS n FROM fx WHERE not flag",
    "SELECT min(b32) AS mn, max(b32) AS mx FROM fx WHERE b32 > 2",
    "SELECT px + py AS s FROM fx WHERE k < 30 ORDER BY s LIMIT 11",
]


@pytest.mark.parametrize("q", PARITY)
def test_bit_parity_fused_vs_unfused(sessions, q):
    _ab_both(sessions, q)


def test_empty_table_bails_out_identically(mcs):
    ss = JSession(mcs[0]), SQLSession(mcs[1])
    for s in ss:
        s.create_table("empty0", {"x": np.zeros(0),
                                  "k": np.zeros(0, np.int64)})
    _ab_both(ss, "SELECT count(*) AS n, max(x) AS mx "
                 "FROM empty0 WHERE k < 5")


# ------------------------------------------------- runtime bailouts

def _bailouts(reg):
    return reg.counter_value("fusion/bailouts")


def test_sum_exactness_bound_bails_out(mcs):
    ss = JSession(mcs[0]), SQLSession(mcs[1])
    for s in ss:
        s.create_table("big", {"v": np.full(64, 2 ** 50, dtype=np.int64)})
    was = metrics.enabled, jmetrics.enabled
    metrics.enable()
    jmetrics.enable()
    b0 = _bailouts(jmetrics), _bailouts(metrics)
    _ab_both(ss, "SELECT sum(v) AS s, count(*) AS n FROM big")
    b1 = _bailouts(jmetrics), _bailouts(metrics)
    if not was[0]:
        metrics.disable()
    if not was[1]:
        jmetrics.disable()
    assert b1[0] - b0[0] >= 1 and b1[1] - b0[1] == b1[0] - b0[0]
    for rec in (recorder, jrecorder):
        assert any("2**53" in e["reason"]
                   for e in rec.events("fusion_bailout"))


def test_left_join_null_conversion_bails_out(mcs):
    ss = JSession(mcs[0]), SQLSession(mcs[1])
    for s in ss:
        s.create_table("lj_l", {"k": np.arange(10, dtype=np.int64),
                                "px": np.linspace(-1, 1, 10)})
        s.create_table("lj_r", {"k": np.arange(5, dtype=np.int64),
                                "w": np.arange(5, dtype=np.int64) * 10})
    _ab_both(ss, "SELECT count(*) AS n, max(w) AS mw FROM lj_l "
                 "LEFT JOIN lj_r ON lj_l.k = lj_r.k WHERE px > -0.5")
    for rec in (recorder, jrecorder):
        assert any("at runtime" in e["reason"]
                   for e in rec.events("fusion_bailout"))


# ------------------------------------------------- program accounting

def test_one_program_per_group_and_bucket(mcs):
    """The JAX package: one cache miss (a compile) per (group, bucket),
    hits after.  The port: one miss (the K14 program encoded) per group,
    whatever the bucket, since the program does not depend on it."""
    rng = np.random.default_rng(5)
    # not tests/test_fusion.py's own query (c < 3): its cache entry, made
    # here first, would turn that test's one compile into a hit
    q = "SELECT count(*) AS n, max(x) AS mx FROM cb WHERE c < 4"
    pin("on")
    deltas = []
    for Session, mc, cache in ((JSession, mcs[0], jcache),
                               (SQLSession, mcs[1], kernel_cache)):
        s = Session(mc)
        rng = np.random.default_rng(5)

        def make(n):
            s.create_table("cb", {"x": rng.normal(size=n),
                                  "c": rng.integers(0, 7, size=n)})
        make(100)
        st0 = cache.stats()
        s.sql(q)
        st1 = cache.stats()
        s.sql(q)
        make(100)
        s.sql(q)
        st2 = cache.stats()
        make(1000)
        s.sql(q)
        st3 = cache.stats()
        deltas.append((st1["misses"] - st0["misses"],
                       st2["misses"] - st1["misses"],
                       st2["hits"] - st1["hits"],
                       st3["misses"] - st2["misses"]))
    pin("auto")
    assert deltas[0] == (1, 0, 2, 1)
    assert deltas[1] == (1, 0, 2, 0)


def test_ledger_attribution_for_fused_kernels(mcs):
    pin("on")
    for Session, mc, led in ((JSession, mcs[0], jledger),
                             (SQLSession, mcs[1], ledger)):
        s = Session(mc)
        s.create_table("lg", {"x": np.linspace(0, 1, 300),
                              "c": np.arange(300, dtype=np.int64)})
        s.sql("SELECT count(*) AS n, min(x) AS mn FROM lg WHERE c > 10")
        rows = [k for k in led.report()["kernels"]
                if k["name"].startswith("fused:filter+aggregate:")]
        assert rows, "fused launch missing from the kernel ledger"
        assert any(k["launches"] >= 1 and k["seconds"] >= 0.0
                   and k["rows"] >= 300 for k in rows)
    pin("auto")


# ------------------------------------------------- planner decision

def test_learned_flip_and_cold_crossover():
    from mosaic_tpu.sql.planner import _FUSION_CROSSOVER as JX
    from mosaic_tpu_torch.sql.planner import _FUSION_CROSSOVER as TX
    assert JX == TX
    opset, members, n = "filter+aggregate", ["filter", "aggregate"], 2048

    def decide(m):
        pair = (jplanner.decide_fusion(opset, members, m),
                tplanner.decide_fusion(opset, members, m))
        for f in ("op", "strategy", "reason", "est_rows", "cost_key",
                  "key_n", "forced"):
            assert getattr(pair[0], f) == getattr(pair[1], f), f
        return pair[1]

    for p in (jplanner, tplanner):
        p.reset()
    try:
        d = decide(n)
        assert d.strategy == "fused" and "cold" in d.reason
        assert decide(TX - 1).strategy == "unfused"
        for _ in range(12):
            for p in (jplanner, tplanner):
                p.observe_op(f"fusion/{opset}", n, 0.10)
                p.observe_op("filter", n, 0.001)
                p.observe_op("aggregate", n, 0.001)
        d = decide(n)
        assert d.strategy == "unfused" and "learned" in d.reason
        for _ in range(40):
            for p in (jplanner, tplanner):
                p.observe_op(f"fusion/{opset}", n, 0.0001)
        d = decide(n)
        assert d.strategy == "fused" and "learned" in d.reason
    finally:
        for p in (jplanner, tplanner):
            p.reset()


def test_forced_pins_and_kill_switch(sessions):
    q = "SELECT count(*) AS n FROM fx WHERE k < 50 AND py > 0.0"
    pin("off")
    assert set(_fused_ops(sessions, q).values()) == {"-"}
    pin("on")
    assert _fused_ops(sessions, q)["filter"] == "g1"
    _set("mosaic.fusion.enabled", "false")
    assert set(_fused_ops(sessions, q).values()) == {"-"}


def test_max_ops_truncates_from_the_front(sessions):
    _set("mosaic.fusion.max.ops", "1")
    pin("on")
    fused = _fused_ops(sessions, "SELECT count(*) AS n, max(px) AS mx "
                                 "FROM fx WHERE k < 50")
    assert fused["filter"] == "-"
    assert fused["aggregate"] == "g1"


# ------------------------------------------------- config validation

@pytest.mark.parametrize("key,bad", [
    ("mosaic.fusion.enabled", "maybe"),
    ("mosaic.fusion.max.ops", "zero"),
    ("mosaic.fusion.max.ops", "-3"),
    ("mosaic.planner.force.fusion", "sideways"),
])
def test_config_validation_names_the_key(key, bad):
    msgs = []
    for m in PKGS:
        with pytest.raises(m.ConfigError) as ei:
            m.apply_conf(m.default_config(), key, bad)
        assert key in str(ei.value)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_config_keys_accept_valid_values():
    for m in PKGS:
        cfg = m.apply_conf(m.default_config(), "mosaic.fusion.enabled",
                           "false")
        assert cfg.fusion_enabled is False
        cfg = m.apply_conf(cfg, "mosaic.fusion.max.ops", "4")
        assert cfg.fusion_max_ops == 4
        for mode in ("on", "off", "auto"):
            m.apply_conf(m.default_config(), "mosaic.planner.force.fusion",
                         mode)


# ------------------------------- the program against _build_program

def _groups(mcs, tables, q):
    """The fused group of ``q`` in each package (fusion pinned on)."""
    ss = JSession(mcs[0]), SQLSession(mcs[1])
    for s in ss:
        for name, cols in tables.items():
            s.create_table(name, {k: v.copy() for k, v in cols.items()})
    pin("on")
    jplan = jplanner.plan_query(jparse(q), ss[0])
    tplan = tplanner.plan_query(parse(q), ss[1])
    assert jplan.fusion is not None and tplan.fusion is not None
    (jg,), (tg,) = jplan.fusion.groups, tplan.fusion.groups
    assert (tg.name, tg.ops, tg.cols, tg.terminal) == \
        (jg.name, jg.ops, jg.cols, jg.terminal)
    return ss, jg, tg


def _bits(v):
    """A scalar output as comparable bits: floats widened to float64."""
    a = np.asarray(v)
    if a.dtype.kind == "f":
        return int(np.float64(a).view(np.int64))
    return int(a)


def program_vs_jax(mcs, tables, q, n=None, xla_ulps=0):
    """``fused_group_ref`` on the encoded group against the JAX
    package's ``_build_program`` over the same padded columns; returns
    the two sessions for the engine-level comparison.  ``xla_ulps``: the
    projected floats may differ from XLA's by this many units in the
    last place (where XLA:CPU contracts or divides by a reciprocal)."""
    ss, jg, tg = _groups(mcs, tables, q)
    (tname, cols), = tables.items()
    n = len(next(iter(cols.values()))) if n is None else n
    srcs = [cols[name][:n] for _, name, _ in tg.cols]
    bucket = pow2_bucket(n)
    assert jax.config.jax_enable_x64        # importing mosaic_tpu sets it
    jout = jfusion._build_program(jg, bucket)(
        *[pad_rows(np.ascontiguousarray(c), bucket) for c in srcs],
        np.int64(n))
    jhost = [np.asarray(o) for o in jax.device_get(jout)]
    prog = tfusion.encode_group(tg)
    buf = torch.from_numpy(fg.pack_inputs(prog, srcs, n, bucket))
    out = fg.fused_group_ref(prog, buf, n, bucket)
    assert torch.equal(out, fg.fused_group(prog, buf.clone(), n, bucket))
    host = fg.unpack_outputs(prog, out.numpy(), bucket)
    assert len(host) == len(jhost)
    assert int(host[0]) == int(jhost[0])
    if tg.terminal == "project":
        assert np.array_equal(host[1], jhost[1])
        live = np.arange(bucket) < n
        for t, j in zip(host[2:], jhost[2:]):
            assert t.dtype == j.dtype, (t.dtype, j.dtype)
            w = {2: np.int16, 4: np.int32, 8: np.int64}.get(t.itemsize)
            tv, jv = (t[live].view(w), j[live].view(w)) if \
                t.dtype.kind == "f" else (t[live], j[live])
            if xla_ulps and t.dtype.kind == "f":
                # same sign, |bits apart| <= xla_ulps, NaN with NaN
                nan = np.isnan(t[live]) & np.isnan(j[live])
                near = np.abs(tv - jv) <= xla_ulps
                assert np.all(nan | near)
            else:
                assert np.array_equal(tv, jv)
    else:
        for t, j in zip(host[1:], jhost[1:]):
            assert _bits(t) == _bits(j), (t, j)
    return ss


@pytest.mark.parametrize("q", PROGRAM_CASES)
def test_program_equals_build_program(mcs, q):
    ss = program_vs_jax(mcs, {"fx": _fx()}, q)
    _ab_both(ss, q)


# ------------------------------------------------------------ hazards

@pytest.mark.parametrize("name", list(HAZARDS))
def test_hazard(mcs, name):
    q = HAZARDS[name]
    rewrites = name in XLA_REWRITES
    ss = program_vs_jax(mcs, {"h": hazard_table()}, q,
                        xla_ulps=1 if rewrites else 0)
    if not rewrites:
        _ab_both(ss, q)
        return
    (jf, ju), (tf, tu) = _ab(ss[0], q), _ab(ss[1], q)
    _assert_identical(tf, tu)
    _assert_identical(tf, ju)
    # the JAX package's fused group leaves numpy here; the port does not
    assert any(not np.array_equal(jf.columns[c], ju.columns[c],
                                  equal_nan=True) for c in jf.columns)


def test_hazard_signed_zero_bits(mcs):
    """XLA orders -0.0 below +0.0 in min and max; so does K14's plain
    version, whichever order the zeros come in."""
    for t in signed_zero_tables():
        q = SIGNED_ZERO_QUERY
        ss = program_vs_jax(mcs, {"h": t}, q)
        pin("on")
        out = ss[1].sql(q)
        assert np.signbit(out.columns["mn"][0])
        assert not np.signbit(out.columns["mx"][0])


@pytest.mark.parametrize("n", PADDING_ROWS)
def test_hazard_padding_never_counts(mcs, n):
    """``n`` below the bucket: the zero-padded rows would pass ``k >= 0``
    and give min 0; they never count."""
    q = PADDING_QUERY
    ss = program_vs_jax(mcs, {"h": padding_table(n)}, q)
    tf, _ = _ab_both(ss, q)
    assert tf.columns["n"].tolist() == [n]
    assert tf.columns["mn"][0] >= 1.0


def test_fused_group_raises_off_cpu_and_cuda():
    prog = fg.ProgramBuilder([np.dtype(np.int64)]).finish("aggregate", -1,
                                                          specs=[(0, -1, 0)])
    buf = torch.from_numpy(fg.pack_inputs(prog, [np.arange(4)], 4, 4))
    with pytest.raises(ValueError):
        fg.fused_group(prog, buf.to(torch.int64), 4, 4)
    with pytest.raises(ValueError):
        fg.fused_group(prog, buf, 0, 4)
    with pytest.raises(ValueError):
        fg.fused_group(prog, buf.to("meta"), 4, 4)


# ------------------------------------------------------ K14's tile edges

def _port_program(tables, q):
    """The port's encoded program of ``q``'s fused group (CPU session)."""
    s = SQLSession(TContext.build(GRID, device="cpu"))
    for name, cols in tables.items():
        s.create_table(name, {k: v.copy() for k, v in cols.items()})
    pin("on")
    plan = tplanner.plan_query(parse(q), s)
    assert plan.fusion is not None
    (group,) = plan.fusion.groups
    return tfusion.encode_group(group)


@pytest.mark.parametrize("label,rows,q", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_tile_edge(mcs, label, rows, q):
    ss = program_vs_jax(mcs, {"e": edge_table(rows)}, q)
    _ab_both(ss, q)


def test_tile_edges_reach_the_edges():
    """Each edge group sits where its label says against its own plan."""
    got = {}
    for label, rows, q in EDGE_CASES:
        t = edge_table(rows)
        prog = _port_program({"e": t}, q)
        plan = fg.plan_program(prog)
        got[label] = (rows, plan.tile, pow2_bucket(rows), prog, t)
    for label, (n, T, bucket, prog, t) in got.items():
        if label.startswith("one row"):
            assert n == 1
        if label.startswith("below a tile"):
            assert 1 < n < T
        if label.startswith("ragged"):
            assert n > T and n % T != 0
        if label.startswith("full bucket"):
            assert n == bucket and n >= T
        if label.startswith("narrow"):
            assert n % 2 == 1
            dts = {fg.DTYPES[d] for d in prog.col_dtypes}
            assert {np.dtype(bool), np.dtype(np.int8),
                    np.dtype(np.float16)} <= dts
        if label == "first in the last tile":
            passing = np.flatnonzero(t["r"] >= n - 3)
            assert passing.min() >= (n - 1) // T * T and n > T


def test_deep_where_takes_the_smallest_tile(mcs):
    q = deep_query()
    prog = _port_program({"d": deep_table()}, q)
    assert len(prog.instrs) >= fg.MAX_REGS - 1
    assert fg.plan_program(prog).tile == fg.TILE_STEP
    ss = program_vs_jax(mcs, {"d": deep_table()}, q)
    _ab_both(ss, q)


# ------------------------------------------------------ K14's plan

def _check_plan(prog):
    """Walk the program as K14 runs it: each slot-held operand still in
    its slot when read (by an instruction or the terminal), each location
    inside its region of the block's shared memory."""
    plan = fg.plan_program(prog)
    kinds = fg.held(prog)
    holder = {}
    for i, (op, _, a, b, _) in enumerate(prog.instrs.tolist()):
        for r in fg.operands(op, a, b):
            if kinds[r] == "slot":
                assert holder.get(plan.slot_of[r]) == r, (i, r)
        if kinds[i] == "slot":
            holder[plan.slot_of[i]] = i
    for r in fg.terminal_regs(prog):
        if kinds[r] == "slot":
            assert holder[plan.slot_of[r]] == r, r
    T = plan.tile
    assert T % fg.TILE_STEP == 0 and fg.TILE_STEP <= T <= fg.MAX_TILE
    assert plan.smem <= fg.block_budget(plan.blocks_per_sm) <= 232_448
    code, spec, part, staged, front = plan.front
    assert 8 * (fg.SMEM_CONST_WORD + len(kinds)) <= code <= spec <= part \
        <= staged <= front and front % 16 == 0 and code % 16 == 0
    stage0 = front + 8 * plan.slots * T
    for i, (loc, kind) in enumerate(zip(plan.locs, kinds)):
        if kind == "const":
            assert loc == fg.LOC_CONST | (fg.SMEM_CONST_WORD + i)
        elif kind == "stage":
            col = int(prog.instrs[i, 2])
            assert loc == fg.LOC_STAGE | (plan.col_stage[col] // 8)
        else:
            assert 0 <= plan.slot_of[i] < plan.slots
            assert loc == front // 8 + plan.slot_of[i] * T
    for c, off in enumerate(plan.col_stage):
        if off >= 0:
            size = fg.DTYPES[prog.col_dtypes[c]].itemsize
            assert off % 16 == 0 and stage0 <= off
            assert off + T * size <= stage0 + plan.stage_bytes
    assert stage0 + plan.stages * plan.stage_bytes == plan.smem
    return plan


def _peak_live(prog):
    """The most slot-held values alive at once: defined before
    instruction i and read after it, or i's own."""
    kinds = fg.held(prog)
    last = fg.last_readers(prog)
    peak = 0
    for i in range(len(kinds)):
        live = sum(1 for v in range(i) if kinds[v] == "slot" and
                   last[v] > i) + (kinds[i] == "slot")
        peak = max(peak, live)
    return peak


def _case_programs():
    yield {"fx": _fx()}, PROGRAM_CASES
    yield {"h": hazard_table()}, list(HAZARDS.values())
    yield {"h": signed_zero_tables()[0]}, [SIGNED_ZERO_QUERY]
    yield {"h": padding_table(100)}, [PADDING_QUERY]
    for _, rows, q in EDGE_CASES:
        yield {"e": edge_table(rows)}, [q]
    yield {"d": deep_table()}, [deep_query()]


def test_plan_of_every_case_program():
    n = 0
    for tables, queries in _case_programs():
        for q in queries:
            prog = _port_program(tables, q)
            plan = _check_plan(prog)
            assert plan.slots == _peak_live(prog), q
            n += 1
    assert n == len(PROGRAM_CASES) + len(HAZARDS) + 2 + len(EDGE_CASES) + 1


_BINARY = ("+", "-", "*", "/", "=", "!=", "<", "<=", ">", ">=", "and", "or")
_UNARY = ("cast", "neg", "not", "isnan", "mask")


@st.composite
def programs(draw):
    """A random well-formed program of up to MAX_REGS instructions: loads
    of columns of any dtype, constants, unary and binary nodes on earlier
    registers, a project or aggregate terminal."""
    ncols = draw(st.integers(1, 12))
    col_dts = [draw(st.integers(0, 7)) for _ in range(ncols)]
    size = draw(st.integers(1, fg.MAX_REGS))
    rows = []
    for i in range(size):
        kind = draw(st.sampled_from(("load", "const", "unary", "binary")
                                    if i else ("load", "const")))
        if kind == "load":
            c = draw(st.integers(0, ncols - 1))
            rows.append((fg.OPS["load"], col_dts[c], c, -1, 0))
        elif kind == "const":
            rows.append((fg.OPS["const"], draw(st.integers(0, 7)), -1, -1,
                         draw(st.integers(-5, 5))))
        else:
            op = draw(st.sampled_from(_UNARY if kind == "unary"
                                      else _BINARY))
            a = draw(st.integers(0, i - 1))
            b = draw(st.integers(0, i - 1)) if kind == "binary" else -1
            rows.append((fg.OPS[op], draw(st.integers(0, 7)), a, b, 0))
    regs = st.integers(0, size - 1)
    mask = draw(st.one_of(st.just(-1), regs))
    instrs = np.asarray(rows, np.int64)
    if draw(st.booleans()):
        items = draw(st.lists(st.tuples(regs, st.integers(0, 7)),
                              min_size=1, max_size=8))
        return fg.Program(instrs, tuple(col_dts), "project", mask,
                          items=tuple(items))
    specs = draw(st.lists(st.tuples(st.integers(1, 6), regs,
                                    st.integers(0, 7)),
                          min_size=1, max_size=fg.MAX_SPECS))
    return fg.Program(instrs, tuple(col_dts), "aggregate", mask,
                      specs=tuple(specs))


@settings(max_examples=300, deadline=None)
@given(programs())
def test_plan_of_random_programs(prog):
    plan = _check_plan(prog)
    assert plan.slots == _peak_live(prog)


@pytest.mark.parametrize("dt", range(len(fg.DTYPES)))
@pytest.mark.parametrize("terminal", ["project", "aggregate"])
def test_largest_programs_fit(dt, terminal):
    """MAX_REGS loads of distinct columns of one dtype, every one read by
    the terminal (all live at the end: P at its most, or every column
    staged), fit one block at TILE_STEP rows or more."""
    n = fg.MAX_REGS
    instrs = np.asarray([(fg.OPS["load"], dt, c, -1, 0) for c in range(n)],
                        np.int64)
    if terminal == "project":
        prog = fg.Program(instrs, (dt,) * n, "project", -1,
                          items=tuple((r, dt) for r in range(n)))
    else:
        specs = [(fg.AGG_KINDS["min"], r, dt) for r in range(fg.MAX_SPECS)]
        instrs[fg.MAX_SPECS:, 0] = fg.OPS["neg"]    # the rest live too
        instrs[fg.MAX_SPECS:, 2] = np.arange(fg.MAX_SPECS, n) - fg.MAX_SPECS
        prog = fg.Program(instrs, (dt,) * n, "aggregate", n - 1,
                          specs=tuple(specs))
    plan = _check_plan(prog)
    assert plan.smem <= fg.SMEM_BLOCK == 232_448
    assert plan.tile >= fg.TILE_STEP
    cols = [np.zeros(3, fg.DTYPES[dt]) for _ in range(n)]
    buf = fg.pack_inputs(prog, cols, 3, 4)
    words = buf[:8 * fg.HDR_FIXED].view(np.int64)
    assert (words[7], words[8], words[9], words[10]) == \
        (plan.tile, plan.stages, plan.slots, plan.smem)


def test_program_that_cannot_fit_raises_in_pack_inputs(monkeypatch):
    b = fg.ProgramBuilder([np.float64])
    x = b.load(0)
    for _ in range(fg.MAX_REGS):
        x = b.emit("+", fg.F64, x, x)
    big = b.finish("aggregate", -1, specs=[(fg.AGG_KINDS["min"], x, fg.F64)])
    with pytest.raises(ValueError, match=str(fg.MAX_REGS)):
        fg.pack_inputs(big, [np.zeros(4)], 4, 4)
    b = fg.ProgramBuilder([np.float32] * 4)
    regs = [b.load(c) for c in range(4)]
    prog = b.finish("project", -1, items=[(r, 6) for r in regs])
    monkeypatch.setattr(fg, "_PLANS", {})
    monkeypatch.setattr(fg, "SMEM_BLOCK", 6_000)
    with pytest.raises(ValueError, match="6000 B"):
        fg.pack_inputs(prog, [np.zeros(4, np.float32)] * 4, 4, 4)
