"""The port's config and cost planner against the JAX package's.

* Each conf key the port carries (``mosaic.planner.enabled``,
  ``mosaic.planner.force.<op>``, ``mosaic.stream.chunk.rows``,
  ``mosaic.knn.strategy``, ``mosaic.shard.skew.refresh``,
  ``mosaic.crs.strict.datum``, the five ``mosaic.join.refine.*``
  keys and the host planes' ``mosaic.trace.enabled``,
  ``mosaic.metrics.enabled`` and ``mosaic.obs.dump.cooldown.ms``;
  the raster and ``mosaic.io.on.error`` keys are held in
  tests/test_torch_raster.py), with the SQL engine's
  ``mosaic.planner.stats.path``, ``mosaic.obs.slow.query.ms``,
  ``mosaic.fusion.{enabled,max.ops}`` and the ``equi_join`` and
  ``fusion`` pins, accepts and rejects the same values as the JAX
  package's, with the same defaults and the same error class.  The
  stated exception: the keys of later slices (the serve and history
  planes, ``mosaic.obs.fleet.stale.ms``) and ``mosaic.device.dtype``,
  ``mosaic.exact.fallback`` and ``mosaic.jit.cache.dir``, which nothing
  in the port reads (ROADMAP C14), raise ``ConfigError``.
* A stats file saved by either planner loads in the other: the same
  coefficients and the same decisions after.
* Pins give the same Decision fields (strategy, reason, est_rows,
  cost_key, key_n, forced, chunk, depth) in both planners, the PIP join's
  on one device and over four (the ``sharded`` candidate).
* Cold heuristics, and decisions learned after the same ``observe_op``
  sequence fed into both planners, are equal on a seeded grid of
  ``(n, m, frac, max_dup)``.
* The nearest-bucket fallback, the store cap (LRU), ``error_p95`` and
  ``report`` match.
* The stream chunk of ``make_streamed_pip_join`` comes from
  ``mosaic.stream.chunk.rows`` when the caller gives none.

No decision here comes from a measured time: every coefficient is fed
by the test, in the same order, to both planners.
"""

import dataclasses

import numpy as np
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.sql import planner as jplanner_mod
from mosaic_tpu.sql.planner import Planner as JPlanner
from mosaic_tpu.sql.planner import planner as jplanner
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.sql import planner as tplanner_mod
from mosaic_tpu_torch.sql.planner import Planner as TPlanner
from mosaic_tpu_torch.sql.planner import planner as tplanner

FIELDS = ("op", "strategy", "reason", "est_rows", "cost_key", "key_n",
          "forced")

#: each ported key and values it must accept or reject alike
KEY_VALUES = {
    "mosaic.index.system": ["H3", "BNG", "CUSTOM(0,16,0,16,2,1,1)", ""],
    "mosaic.geometry.api": ["JAX", "other"],
    "mosaic.planner.enabled": ["true", "false", "1", "0", "yes", "off",
                               " ON ", "maybe", "", 1, 0],
    "mosaic.stream.chunk.rows": ["65536", "1", " 4096 ", "abc", "0", "-4",
                                 "1.5", 262144],
    "mosaic.knn.strategy": ["auto", "brute", "ring", "RING", " brute ",
                            "2048", "1", "bogus", "0", "-3", "1.5"],
    "mosaic.join.refine.enabled": ["true", "false", "no", "x"],
    "mosaic.join.refine.depth": ["1", "2", "0", "-1", "x"],
    "mosaic.join.refine.dup.threshold": ["0", "2", "8", "-1", "x"],
    "mosaic.join.refine.max.cells": ["4096", "1", "0", "x"],
    "mosaic.join.refine.sample.rows": ["65536", "1", "0", "x"],
    "mosaic.planner.force.knn": ["auto", "brute", "ring", "RING",
                                 "warp_drive", ""],
    "mosaic.planner.force.pip_join": ["auto", "monolithic", "streamed",
                                      "Streamed", "sharded", "bogus"],
    "mosaic.shard.skew.refresh": ["16", "2", "1", "0", "-1", "x", 8],
    "mosaic.planner.force.refine": ["auto", "refined", "flat", "deep"],
    "mosaic.planner.force.bogus_op": ["loop"],
    "mosaic.store.dir": ["/tmp/s", "", " x "],
    "mosaic.store.grid.res": ["2048", "1", "0", "-8", "x", 1024],
    "mosaic.store.shard.rows": ["65536", "1", "0", "x"],
    "mosaic.store.mmap": ["true", "false", "maybe"],
    "mosaic.heat.halflife.ms": ["0", "1000", "2.5", "-1", "x"],
    "mosaic.heat.prior": ["true", "false", "on", "perhaps"],
    "mosaic.layout.rows.per.cell": ["65536", "1", "0", "x"],
    "mosaic.layout.min.res": ["64", "128", "0", "x"],
    "mosaic.layout.max.res": ["16384", "512", "-2", "x"],
    "mosaic.crs.strict.datum": ["true", "false", "1", "maybe"],
    "mosaic.trace.enabled": ["true", "false", "on", "perhaps"],
    "mosaic.metrics.enabled": ["true", "false", "0", "x"],
    "mosaic.obs.dump.cooldown.ms": ["0", "30000", "2.5", "-1", "x"],
    "mosaic.planner.force.equi_join": ["auto", "loop", "vectorized",
                                       "LOOP", "hash", ""],
    "mosaic.planner.force.fusion": ["auto", "on", "off", "ON", "maybe"],
    "mosaic.planner.stats.path": ["/tmp/ps.json", "", " x "],
    "mosaic.obs.slow.query.ms": ["0", "250", "0.0001", "-1", "x"],
    "mosaic.fusion.enabled": ["true", "false", "off", "maybe"],
    "mosaic.fusion.max.ops": ["8", "1", "0", "-3", "zero"],
}

#: the config fields those keys set, with the JAX package's defaults
FIELDS_PORTED = ("index_system", "geometry_api", "planner_enabled",
                 "planner_force", "stream_chunk_rows",
                 "knn_strategy", "join_refine_enabled", "join_refine_depth",
                 "join_refine_dup_threshold", "join_refine_max_cells",
                 "join_refine_sample_rows", "raster_checkpoint",
                 "raster_use_checkpoint", "raster_tmp_prefix",
                 "raster_blocksize", "io_on_error", "shard_skew_refresh",
                 "store_dir", "store_grid_res", "store_shard_rows",
                 "store_mmap", "heat_halflife_ms", "heat_prior",
                 "layout_rows_per_cell", "layout_min_res",
                 "layout_max_res", "crs_strict_datum", "trace_enabled",
                 "metrics_enabled", "obs_dump_cooldown_ms",
                 # the memory and device planes' keys
                 "obs_sample_ms", "obs_slo_dump", "obs_profile_hz",
                 "obs_profile_trace_ms", "principal", "query_deadline_ms",
                 "audit_path", "audit_rotate_bytes", "audit_retain",
                 "mem_budget_bytes", "mem_pressure_high",
                 "obs_mem_enabled", "obs_fleet_dir",
                 "obs_fleet_window_ms", "obs_fleet_events",
                 # the SQL engine's and fusion's
                 "planner_stats_path", "obs_slow_query_ms",
                 "fusion_enabled", "fusion_max_ops")


@pytest.fixture(autouse=True)
def clean_state():
    """Both packages' configs snapshotted and restored, both singleton
    planners reset."""
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    jplanner.reset()
    tplanner.reset()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)
    jplanner.reset()
    tplanner.reset()


def _set(key, val):
    for m in (jconfig, tconfig):
        m.set_default_config(m.apply_conf(m.default_config(), key, val))


def _apply(mod, key, val):
    try:
        cfg = mod.apply_conf(mod.MosaicConfig(), key, val)
    except mod.ConfigError as e:
        return ("ConfigError", type(e).__mro__[1].__name__)
    return tuple(getattr(cfg, f) for f in FIELDS_PORTED)


def test_defaults_equal():
    j, t = jconfig.MosaicConfig(), tconfig.MosaicConfig()
    for f in FIELDS_PORTED:
        assert getattr(j, f) == getattr(t, f), f
    assert {f.name for f in dataclasses.fields(t)} == set(FIELDS_PORTED)


@pytest.mark.parametrize("key", list(KEY_VALUES))
def test_conf_key_accepts_and_rejects_alike(key):
    for val in KEY_VALUES[key]:
        assert _apply(tconfig, key, val) == _apply(jconfig, key, val), \
            (key, val)
    assert issubclass(tconfig.ConfigError, ValueError)


def test_force_pins_stack_and_clear_alike():
    seq = [("mosaic.planner.force.knn", "brute"),
           ("mosaic.planner.force.refine", "flat"),
           ("mosaic.planner.force.knn", "ring"),
           ("mosaic.planner.force.pip_join", "streamed"),
           ("mosaic.planner.force.refine", "auto")]
    j, t = jconfig.MosaicConfig(), tconfig.MosaicConfig()
    for key, val in seq:
        j = jconfig.apply_conf(j, key, val)
        t = tconfig.apply_conf(t, key, val)
        assert t.planner_force == j.planner_force
        for op in ("knn", "pip_join", "refine"):
            assert tconfig.planner_force_for(t, op) == \
                jconfig.planner_force_for(j, op)


@pytest.mark.parametrize("key,val", [
    ("mosaic.serve.port", "8080"),
    ("mosaic.serve.batch.max", "64"),
    ("mosaic.serve.fleet.workers", "2"),
    ("mosaic.history.dir", "/tmp/hist"),
    ("mosaic.history.retain", "4"),
    ("mosaic.obs.fleet.stale.ms", "1000"),
    ("mosaic.device.dtype", "float64"),
    ("mosaic.exact.fallback", "false"),
    ("mosaic.jit.cache.dir", "/tmp/jc"),
    ("mosaic.jit.cache.dir", ""),
])
def test_left_out_pins_and_keys_raise(key, val):
    """The stated divergence: what the JAX package takes for a later
    slice (the serve and history planes) and the keys nothing in the
    port reads, the port refuses."""
    jconfig.apply_conf(jconfig.MosaicConfig(), key, val)
    with pytest.raises(tconfig.ConfigError):
        tconfig.apply_conf(tconfig.MosaicConfig(), key, val)


def _same(t, j):
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), (f, t, j)
    assert getattr(t, "chunk", None) == getattr(j, "chunk", None)
    assert getattr(t, "depth", None) == getattr(j, "depth", None)


def _decide_all(pl_t, pl_j, n, m, frac, max_dup, thr=128):
    """Every decision of both planners on one grid point, held equal;
    returns the strategies the port's planner picked."""
    pf = frac if frac is not None else 0.0
    pairs = [(pl_t.decide_knn(n, m, thr), pl_j.decide_knn(n, m, thr)),
             (pl_t.decide_pip_join(n, in_extent_frac=frac),
              pl_j.decide_pip_join(n, 1, in_extent_frac=frac)),
             (pl_t.decide_pip_join(n, 4, in_extent_frac=frac),
              pl_j.decide_pip_join(n, 4, in_extent_frac=frac)),
             (pl_t.decide_refine(n, pf, max_dup),
              pl_j.decide_refine(n, pf, max_dup)),
             (pl_t.decide_refine(n, 0.9, max_dup, depth=2),
              pl_j.decide_refine(n, 0.9, max_dup, depth=2))]
    for t, j in pairs:
        _same(t, j)
    return {t.strategy for t, _ in pairs}


GRID = [(n, m, frac, dup)
        for n in (1, 100, 5_000, 262_144, 262_145, 3_000_000)
        for m in (0, 64, 128, 512, 513, 10_000)
        for frac in (None, 0.0, 0.49, 0.5, 1.0, 1.7)
        for dup in (1, 7, 8, 30)]


@pytest.mark.parametrize("pins", [
    {"mosaic.planner.force.knn": "brute"},
    {"mosaic.planner.force.knn": "ring"},
    {"mosaic.planner.force.pip_join": "monolithic"},
    {"mosaic.planner.force.pip_join": "streamed",
     "mosaic.stream.chunk.rows": "4096"},
    {"mosaic.planner.force.pip_join": "sharded"},
    {"mosaic.planner.force.refine": "refined",
     "mosaic.join.refine.depth": "3"},
    {"mosaic.planner.force.refine": "flat"},
    {"mosaic.join.refine.enabled": "false",
     "mosaic.planner.force.refine": "refined"},
], ids=lambda p: ",".join(f"{k.split('.')[-1]}={v}" for k, v in p.items()))
def test_pins_give_equal_decisions(pins):
    for key, val in pins.items():
        _set(key, val)
    pl_t, pl_j = TPlanner(), JPlanner()
    for n, m, frac, dup in GRID[::7]:
        _decide_all(pl_t, pl_j, n, m, frac, dup)
    assert pl_t.decisions == pl_j.decisions


def _feed(pl, seq):
    for op, n, wall, rows in seq:
        pl.observe_op(op, n, wall, rows_out=rows)


def _seeded_observations(seed, chunk):
    """A seeded sequence of (op, n, wall_s, rows_out) over every cost key
    the three decisions read, at several size classes."""
    rng = np.random.default_rng(seed)
    ops = ["knn/brute", "knn/ring", "refine/refined", "refine/flat",
           "pip_join/monolithic",
           TPlanner.pip_cost_key("streamed", chunk),
           TPlanner.pip_cost_key("streamed", chunk // 8)]
    seq = []
    for _ in range(60):
        op = ops[int(rng.integers(len(ops)))]
        n = int(rng.choice([7, 100, 4_000, 70_000, 300_000, 2_000_000]))
        seq.append((op, n, float(rng.uniform(1e-4, 3.0)),
                    int(rng.integers(0, n + 1))))
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cold_and_learned_decisions_equal(seed):
    """Cold, then after half and after all of a seeded observe_op
    sequence (learned coefficient flips included), both planners decide
    alike on the whole grid."""
    chunk = tconfig.default_config().stream_chunk_rows
    pl_t, pl_j = TPlanner(), JPlanner()
    for n, m, frac, dup in GRID:
        _decide_all(pl_t, pl_j, n, m, frac, dup)
    seq = _seeded_observations(seed, chunk)
    strategies = set()
    for part in (seq[:30], seq[30:]):
        _feed(pl_t, part)
        _feed(pl_j, part)
        for n, m, frac, dup in GRID:
            strategies |= _decide_all(pl_t, pl_j, n, m, frac, dup)
    # the learned comparisons reached both sides of every decision
    assert strategies >= {"brute", "ring", "monolithic", "streamed",
                          "refined", "flat"}
    assert pl_t.report() == pl_j.report()


@pytest.mark.parametrize("mesh_devices", [1, 4])
def test_sharded_candidate_learned_alike(mesh_devices):
    """The sharded candidate exists over more than one device only; once
    its learned cost is the lowest, both planners pick it there."""
    pl_t, pl_j = TPlanner(), JPlanner()
    chunk = tconfig.default_config().stream_chunk_rows
    for n in (100, chunk, 3_000_000):
        assert pl_t.pip_join_candidates(n, mesh_devices) == \
            pl_j.pip_join_candidates(n, mesh_devices)
    for pl in (pl_t, pl_j):
        for s, c in pl.pip_join_candidates(3_000_000, 4):
            pl.observe_op(pl.pip_cost_key(s, c), 3_000_000,
                          0.1 if s == "sharded" else 2.0)
    t = pl_t.decide_pip_join(3_000_000, mesh_devices, in_extent_frac=0.5)
    _same(t, pl_j.decide_pip_join(3_000_000, mesh_devices,
                                  in_extent_frac=0.5))
    assert t.strategy == ("sharded" if mesh_devices > 1 else "streamed")


def test_knn_memory_guard_past_four_thresholds():
    """Learned costs pick brute only while the right side is within four
    times the threshold; past it the cold rule (ring) stands."""
    pl_t, pl_j = TPlanner(), JPlanner()
    for pl in (pl_t, pl_j):
        pl.observe_op("knn/brute", 1000, 0.001)
        pl.observe_op("knn/ring", 1000, 1.0)
    for m in (1, 128, 129, 512, 513, 100_000):
        t, j = pl_t.decide_knn(1000, m, 128), pl_j.decide_knn(1000, m, 128)
        _same(t, j)
        assert t.strategy == ("brute" if m <= 512 else "ring")


def test_nearest_bucket_fallback_and_store_cap():
    pl_t, pl_j = TPlanner(), JPlanner()
    for pl in (pl_t, pl_j):
        pl.observe_op("x", 1 << 10, 0.5)
        pl.observe_op("x", 1 << 15, 2.0)
        pl.observe_op("x", 1 << 12, 1.0)
        pl.observe_op("x", 1 << 12, 3.0)          # EWMA
        pl.observe_op("y", 3, 0.1, rows_out=2)
    for n in (1, 3, 4, 5, 600, 1 << 10, 3000, 1 << 13, 1 << 14, 20_000,
              1 << 20):
        assert pl_t.ms_per_row("x", n) == pl_j.ms_per_row("x", n), n
        assert pl_t.est_cost_ms("x", n) == pl_j.est_cost_ms("x", n)
        assert pl_t.ratio("y", n) == pl_j.ratio("y", n)
        assert pl_t.ms_per_row("z", n) is None
    assert tplanner_mod._bucket(0) == jplanner_mod._bucket(0) == 4
    assert [tplanner_mod._bucket(n) for n in range(1, 70)] == \
        [jplanner_mod._bucket(n) for n in range(1, 70)]
    assert tplanner_mod._STORE_CAP == jplanner_mod._STORE_CAP
    cap = tplanner_mod._STORE_CAP
    for pl in (pl_t, pl_j):
        for i in range(cap + 40):
            pl.observe_op(f"op{i % (cap // 2 + 30)}", 1 << (i % 20),
                          0.01 * (i + 1))
    assert list(pl_t._ms.items()) == list(pl_j._ms.items())
    assert len(pl_t._ms) == cap
    assert pl_t.report() == pl_j.report()


def test_error_p95_and_observe_decision():
    pl_t, pl_j = TPlanner(), JPlanner()
    assert pl_t.error_p95() == pl_j.error_p95() == 1.0
    rng = np.random.default_rng(4)
    for _ in range(300):
        n = int(rng.integers(1, 10_000))
        est, rows = int(rng.integers(0, n)), int(rng.integers(0, n))
        wall = float(rng.uniform(0, 1))
        td = tplanner_mod.Decision("pip_join", "streamed", "", est,
                                   cost_key="pip_join/streamed/c19",
                                   key_n=n)
        jd = jplanner_mod.Decision("pip_join", "streamed", "", est,
                                   cost_key="pip_join/streamed/c19",
                                   key_n=n)
        pl_t.observe_decision(td, wall, rows_out=rows)
        pl_j.observe_decision(jd, wall, rows_out=rows)
        assert pl_t.observe_estimate("q", est, rows) == \
            pl_j.observe_estimate("q", est, rows)
    for w in (1, 16, 256, 2048):
        assert pl_t.error_p95(w) == pl_j.error_p95(w)
    assert pl_t.report() == pl_j.report()
    assert pl_t.mispredicts > 0
    pl_t.reset()
    assert pl_t.report()["observations"] == 0 and pl_t.error_p95() == 1.0


def test_switches_read_the_config():
    assert tplanner.enabled and tplanner.chunk_rows() == 262_144
    _set("mosaic.planner.enabled", "false")
    _set("mosaic.stream.chunk.rows", "1000")
    _set("mosaic.planner.force.knn", "ring")
    assert tplanner.enabled is jplanner.enabled is False
    assert tplanner.chunk_rows() == jplanner.chunk_rows() == 1000
    assert tplanner.force_for("knn") == jplanner.force_for("knn") == "ring"
    assert tplanner.force_for("refine") == "auto"


def test_streamed_join_chunk_from_config():
    """``chunk=None`` reads mosaic.stream.chunk.rows: 700 rows in chunks
    of 256 are three stream steps."""
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.parallel import pip_join as tpj
    polys = mt.read_wkt(["POLYGON ((-74.02 40.70, -73.95 40.70, "
                         "-73.95 40.76, -74.02 40.76, -74.02 40.70))"])
    grid = mt.get_index_system("H3")
    idx = mt.build_pip_index(polys, 9, grid, device="cpu")
    steps = []
    real = tpj.stream

    def counting(slices, *a, **k):
        steps.append(len(slices))
        return real(slices, *a, **k)

    _set("mosaic.stream.chunk.rows", "256")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpj, "stream", counting)
        run = mt.make_streamed_pip_join(idx, grid, polys, device="cpu")
        rng = np.random.default_rng(0)
        pts = np.stack([rng.uniform(-74.03, -73.94, 700),
                        rng.uniform(40.69, 40.77, 700)], -1)
        zone, _ = run(pts)
    assert steps == [3]
    assert np.array_equal(zone, mt.pip_host_truth(pts, polys))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_stats_file_round_trip(tmp_path, writer):
    """A stats file either planner saves loads in the other: equal
    coefficients, equal decisions (the SQL slice's state carried
    across)."""
    path = str(tmp_path / "stats.json")
    src, dst = (JPlanner(), TPlanner()) if writer == "jax" else \
        (TPlanner(), JPlanner())
    feed = [("equi_join/loop", 3000, 0.004, 2900),
            ("equi_join/vectorized", 3000, 0.001, 2900),
            ("fusion/filter+aggregate", 70_000, 0.002, None),
            ("filter", 70_000, 0.010, 35_000),
            ("aggregate", 70_000, 0.020, 1),
            ("knn/brute", 5000, 0.3, None),
            ("pip_join/streamed/c19", 1 << 20, 0.8, None)]
    for op, n, s, rows in feed:
        src.observe_op(op, n, s, rows_out=rows)
    assert src.save(path) == path
    assert dst.load(path) is True
    for op, n, _, rows in feed:
        assert dst.ms_per_row(op, n) == src.ms_per_row(op, n)
        if rows is not None:
            assert dst.ratio(op, n) == src.ratio(op, n)
    for pl in (src, dst):
        pl.decisions = 0
    for n in (100, 3000, 9000):
        _same(dst.decide_equi_join(n, n), src.decide_equi_join(n, n))
    for n in (500, 70_000, 1 << 20):
        _same(dst.decide_fusion("filter+aggregate", ["filter",
                                                     "aggregate"], n),
              src.decide_fusion("filter+aggregate", ["filter",
                                                     "aggregate"], n))
    _same(dst.decide_knn(5000, 64, 128), src.decide_knn(5000, 64, 128))
    # a corrupt or wrong-version file leaves either planner cold
    with open(path, "w") as f:
        f.write('{"version": 99}')
    assert TPlanner().load(path) is False and JPlanner().load(path) is False


def test_sql_decisions_equal():
    """decide_equi_join and decide_fusion, cold, pinned and learned,
    equal in both planners."""
    for n in (1, 2000, 2048, 4096, 10**6):
        _same(tplanner.decide_equi_join(n, n), jplanner.decide_equi_join(n,
                                                                         n))
        _same(tplanner.decide_fusion("filter+project", ["filter",
                                                        "project"], n),
              jplanner.decide_fusion("filter+project", ["filter",
                                                        "project"], n))
    for key, val in (("mosaic.planner.force.equi_join", "vectorized"),
                     ("mosaic.planner.force.fusion", "off")):
        _set(key, val)
    _same(tplanner.decide_equi_join(3, 3), jplanner.decide_equi_join(3, 3))
    _same(tplanner.decide_fusion("x", ["filter"], 10),
          jplanner.decide_fusion("x", ["filter"], 10))
