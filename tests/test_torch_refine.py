"""The port's join strategies against the JAX package's: the refined join,
``tessellate_subset`` and the planned join.

Both packages run on the CPU (the port on ``device="cpu"``, where the cell
kernel runs its plain version); the JAX package tessellates on its float64
numpy branches (``_f64_jit_enabled`` patched off), the arithmetic the port
copies.  Every compared output is exact, so nothing has a tolerance.

* tests/test_refine.py's four point kinds (12,000 points, 40 cluster
  polygons, H3 res 5, chunk 4,096, ``dup.threshold`` 2, the ``refined``
  pin): port zones == JAX zones == ``pip_host_truth``, ``run.stats`` equal,
  and every id the port routed equal to the host ``point_to_cell``;
* the kill switch and the ``flat`` and ``refined`` pins, decisions equal;
* overlapping polygon sets that decline to refine, at the base level and
  at the refined level, with the JAX package's reasons;
* the route on CUSTOM and BNG grids equal to the host ``point_to_cell``;
* ``tessellate_subset``'s ChipSet bit-equal to the JAX package's;
* the planned join: ``pip_join_candidates``, decisions under pins, and
  zones equal to the JAX planned join's over a dense and a sorted index,
  ``calibrate`` included.

Both packages' configs and planners are process globals: every test runs
between a snapshot and a restore of both configs and a reset of both
planners.
"""

import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu import config as jconfig
from mosaic_tpu.bench.workloads import build_workload as jbuild
from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.sql.planner import planner as jplanner
import mosaic_tpu_torch as mt
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.bench.workloads import build_workload as tbuild
from mosaic_tpu_torch.bench.workloads import nyc_points
from mosaic_tpu_torch.core.geometry.array import GeometryBuilder as TBuilder
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.sql.planner import planner as tplanner

RES = 5
N_POINTS = 12_000
CHUNK = 4096
DECISION_FIELDS = ("op", "strategy", "reason", "est_rows", "cost_key",
                   "key_n", "forced")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    """Both packages' configs snapshotted and restored, both planners
    reset; the JAX package on its numpy tessellation branches."""
    monkeypatch.setattr(jtess_module, "_f64_jit_enabled",
                        lambda disable_env=None: False)
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    jplanner.reset()
    tplanner.reset()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)
    jplanner.reset()
    tplanner.reset()


def _set(key, val):
    """One conf assignment in both packages."""
    for m in (jconfig, tconfig):
        m.set_default_config(m.apply_conf(m.default_config(), key, val))


def _cluster_polys(make, n=40, radius=0.004, spread=0.1, seed=0):
    """tests/test_refine.py's tight cluster of small polygons sharing
    coarse cells, built by either package's GeometryBuilder."""
    rng = np.random.default_rng(seed)
    b = make()
    for cx, cy in rng.uniform(-spread, spread, size=(n, 2)):
        ang = np.linspace(0.0, 2.0 * np.pi, 8)[:-1]
        b.add_polygon(np.stack([cx + radius * np.cos(ang),
                                cy + radius * np.sin(ang)], 1), [])
    return b.finish()


def _points(kind, n, seed):
    """tests/test_refine.py's point kinds."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-0.15, 0.15, size=(n, 2))
    if kind == "skewed":
        return np.concatenate([
            rng.uniform(-0.12, 0.12, size=(n * 3 // 4, 2)),
            rng.uniform(-2.0, 2.0, size=(n - n * 3 // 4, 2))])
    if kind == "clustered":
        c = rng.uniform(-0.1, 0.1, size=(8, 2))
        return (c[rng.integers(0, 8, n)]
                + rng.normal(0.0, 0.01, size=(n, 2)))
    if kind == "empty_cells":
        return rng.uniform(50.0, 60.0, size=(n, 2))
    raise AssertionError(kind)


class RoutedGrid:
    """A port grid whose ``point_to_cell_device`` keeps every (points,
    routed ids) pair it returned."""

    def __init__(self, grid):
        self.grid = grid
        self.routed = []

    def __getattr__(self, name):
        return getattr(self.grid, name)

    def point_to_cell_device(self, xy, res, device):
        cells, host = self.grid.point_to_cell_device(xy, res, device)
        self.routed.append((np.array(xy), res, cells))
        return cells, host

    def assert_routes_exact(self):
        assert self.routed
        for xy, res, cells in self.routed:
            assert np.array_equal(cells, self.grid.point_to_cell(xy, res))


def _decisions_equal(a, b):
    for f in DECISION_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert getattr(a, "depth", None) == getattr(b, "depth", None)


def _both(polys_seed, grid_name="H3", res=RES, chunk=CHUNK, make_polys=None):
    """The same polygons in both packages and a refined join over each;
    the port's grid records its routes."""
    make_polys = make_polys or (lambda mk: _cluster_polys(mk,
                                                          seed=polys_seed))
    jp, tp = make_polys(JBuilder), make_polys(TBuilder)
    rgrid = RoutedGrid(mt.get_index_system(grid_name))
    jrun = jpj.make_refined_pip_join(jp, jget(grid_name), res, chunk=chunk)
    trun = tpj.make_refined_pip_join(tp, rgrid, res, chunk=chunk,
                                     device="cpu")
    return jp, tp, jrun, trun, rgrid


@pytest.mark.parametrize("kind", ["uniform", "skewed", "clustered",
                                  "empty_cells"])
def test_refined_equals_jax_and_oracle(kind):
    _set("mosaic.planner.force.refine", "refined")
    _set("mosaic.join.refine.dup.threshold", "2")
    jp, tp, jrun, trun, rgrid = _both(3)
    pts = _points(kind, N_POINTS, seed=11)
    jz, jre = jrun(pts)
    tz, tre = trun(pts)
    truth = mt.pip_host_truth(pts, tp)
    assert np.array_equal(truth, jpj.pip_host_truth(pts, jp))
    assert np.array_equal(np.asarray(jz), truth)
    assert np.array_equal(tz, truth)
    assert trun.stats == jrun.stats
    _decisions_equal(trun.last_decision, jrun.last_decision)
    rgrid.assert_routes_exact()
    # one route per chunk after the probe's; one base-part call per
    # chunk with a cold point, one refined-part call per chunk with a
    # hot one
    counts = trun.counts
    assert counts["route_points"] == min(
        N_POINTS, tconfig.default_config().join_refine_sample_rows) + \
        (N_POINTS if trun.stats["strategy"] == "refined" else 0)
    assert counts["refined"] == (3 if trun.stats["strategy"] == "refined"
                                 else 0)
    if kind == "skewed":
        assert trun.stats["strategy"] == "refined"
        assert trun.stats["levels"] == [RES, RES + 1]
        assert trun.stats["refined_points"] > 0
        assert counts["route"] == 1 + 3
    if kind == "empty_cells":
        assert trun.stats["strategy"] == "flat"
        assert trun.stats["refined_points"] == 0


def test_refine_kill_switch_beats_pin():
    _set("mosaic.join.refine.enabled", "false")
    _set("mosaic.planner.force.refine", "refined")
    jp, tp, jrun, trun, _ = _both(7)
    pts = _points("skewed", 8_000, seed=31)
    jz, _ = jrun(pts)
    tz, _ = trun(pts)
    d = trun.last_decision
    assert d.strategy == "flat" and d.forced
    assert d.reason == "disabled by conf"
    _decisions_equal(d, jrun.last_decision)
    assert trun.stats == jrun.stats
    assert trun.stats["strategy"] == "flat"
    assert np.array_equal(tz, np.asarray(jz))
    assert np.array_equal(tz, mt.pip_host_truth(pts, tp))


def test_refine_pins_flat_and_refined():
    _set("mosaic.join.refine.dup.threshold", "2")
    jp, tp, jrun, trun, rgrid = _both(9)
    pts = _points("skewed", 8_000, seed=41)
    _set("mosaic.planner.force.refine", "refined")
    jz_ref, _ = jrun(pts)
    tz_ref, _ = trun(pts)
    assert trun.last_decision.forced
    assert trun.stats["strategy"] == "refined"
    assert trun.stats == jrun.stats
    _decisions_equal(trun.last_decision, jrun.last_decision)
    _set("mosaic.planner.force.refine", "flat")
    jz_flat, _ = jrun(pts)
    tz_flat, _ = trun(pts)
    assert trun.last_decision.forced
    assert trun.stats["strategy"] == "flat"
    assert trun.stats == jrun.stats
    assert trun.counts["route"] == 0
    assert np.array_equal(tz_ref, tz_flat)
    assert np.array_equal(tz_ref, np.asarray(jz_ref))
    assert np.array_equal(tz_flat, np.asarray(jz_flat))
    rgrid.assert_routes_exact()


def _overlap_at_base(make):
    """Two large overlapping squares: they share core cells at res 5."""
    b = make()
    for x0 in (0.0, 0.3):
        b.add_polygon(np.array([[x0, 0.0], [x0 + 1.0, 0.0],
                                [x0 + 1.0, 1.0], [x0, 1.0]]), [])
    return b.finish()


def _overlap_when_refined(make):
    """Two overlapping hexagons of ~0.06 degrees: no core cell at res 5,
    shared core cells at res 6."""
    b = make()
    ang = np.linspace(0.0, 2.0 * np.pi, 7)[:-1]
    for cx in (0.0, 0.01):
        b.add_polygon(np.stack([cx + 0.06 * np.cos(ang),
                                0.06 * np.sin(ang)], 1), [])
    return b.finish()


@pytest.mark.parametrize("make_polys,reason", [
    (_overlap_at_base, "overlap regime at base level (parity gate)"),
    (_overlap_when_refined, "overlap regime at refined level (parity gate)"),
], ids=["base", "refined"])
def test_overlapping_polygons_decline_to_refine(make_polys, reason):
    _set("mosaic.planner.force.refine", "refined")
    _set("mosaic.join.refine.dup.threshold", "2")
    jp, tp, jrun, trun, rgrid = _both(None, make_polys=make_polys)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.2, 1.4, size=(6_000, 2))
    jz, _ = jrun(pts)
    tz, _ = trun(pts)
    d = trun.last_decision
    assert d.strategy == "flat" and d.forced and d.reason == reason
    _decisions_equal(d, jrun.last_decision)
    assert trun.stats == jrun.stats
    assert trun.stats["strategy"] == "flat"
    assert np.array_equal(tz, np.asarray(jz))
    # an unclean index does not pin which zone wins where two contain a
    # point; everywhere else the zones are the oracle's
    inside = np.stack([mt.pip_host_truth(pts, tp.take([g])) >= 0
                       for g in range(len(tp))])
    one = inside.sum(axis=0) <= 1
    assert (~one).any() and one.any()
    assert np.array_equal(tz[one], mt.pip_host_truth(pts, tp)[one])


@pytest.mark.parametrize("grid_name,res,lo,hi", [
    ("CUSTOM(-180,180,-90,90,2,360,180)", 3, -0.15, 0.15),
    ("BNG", 3, 100_000.0, 200_000.0),
], ids=["custom", "bng"])
def test_route_on_custom_and_bng_equals_host(grid_name, res, lo, hi):
    """The route of a non-H3 grid: its torch hook on f64 points, exactly
    the host's ids, on the polygons' cells and points on cell edges."""
    grid = mt.get_index_system(grid_name)
    rng = np.random.default_rng(17)
    pts = rng.uniform(lo, hi, size=(20_000, 2))
    cells = np.unique(grid.point_to_cell(pts, res))
    verts, _ = grid.cell_boundary(cells)
    edge = np.concatenate([verts.reshape(-1, 2),
                           0.5 * (verts + np.roll(verts, 1, axis=1)
                                  ).reshape(-1, 2)])
    for xy in (pts, edge, np.nextafter(edge, np.inf),
               np.nextafter(edge, -np.inf)):
        got, _ = grid.point_to_cell_device(xy, res, "cpu")
        assert np.array_equal(got, grid.point_to_cell(xy, res))


def test_refined_join_on_custom_grid_equals_jax():
    """The refined join off H3: CUSTOM at res 3 (about 0.083 degree
    cells), the cluster's polygons deepened to res 4."""
    name = "CUSTOM(-180,180,-90,90,2,360,180)"
    _set("mosaic.planner.force.refine", "refined")
    _set("mosaic.join.refine.dup.threshold", "2")
    jp, tp, jrun, trun, rgrid = _both(3, grid_name=name, res=3)
    pts = _points("skewed", 8_000, seed=23)
    jz, _ = jrun(pts)
    tz, _ = trun(pts)
    assert trun.stats == jrun.stats
    assert trun.stats["strategy"] == "refined"
    assert np.array_equal(tz, np.asarray(jz))
    assert np.array_equal(tz, mt.pip_host_truth(pts, tp))
    rgrid.assert_routes_exact()


def test_tessellate_subset_bit_equal():
    jp = _cluster_polys(JBuilder, seed=3)
    tp = _cluster_polys(TBuilder, seed=3)
    ids = np.array([31, 2, 17, 5, 39, 0])
    jsub, jchips = jtess_module.tessellate_subset(jp, ids, RES + 1,
                                                  jget("H3"),
                                                  keep_core_geom=False)
    tsub, tchips = mt.tessellate_subset(tp, ids, RES + 1,
                                        mt.get_index_system("H3"),
                                        keep_core_geom=False, device="cpu")
    assert len(tsub) == len(ids) and len(tchips) > 0
    assert np.array_equal(np.asarray(jsub.coords), tsub.coords)
    assert np.array_equal(jchips.cell_id, tchips.cell_id)
    assert np.array_equal(jchips.geom_id, tchips.geom_id)
    assert np.array_equal(jchips.is_core, tchips.is_core)
    for f in ("coords", "ring_offsets", "part_offsets", "geom_offsets",
              "types"):
        assert np.array_equal(np.asarray(getattr(jchips.geoms, f)),
                              np.asarray(getattr(tchips.geoms, f))), f
    # subset-local ids map back through geom_ids
    assert set(ids[tchips.geom_id]) <= set(ids)


# ------------------------------------------------------ the planned join

@pytest.fixture(scope="module")
def planned_indexes():
    """The n_side=4 taxi workload in both packages, each as a dense and
    a sorted index (the JAX package on its numpy tessellation branches)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtess_module, "_f64_jit_enabled",
                   lambda disable_env=None: False)
        jp, jg, res = jbuild(n_side=4, grid_name="H3", zones="taxi")
        jidx = {"dense": jpj.build_pip_index(jp, res, jg),
                "sorted": jpj.build_pip_index(jp, res, jg, dense="never")}
    tp, tg, _ = tbuild(n_side=4, grid_name="H3", zones="taxi")
    tidx = {"dense": tpj.build_pip_index(tp, res, tg, device="cpu"),
            "sorted": tpj.build_pip_index(tp, res, tg, dense="never",
                                          device="cpu")}
    assert isinstance(jidx["dense"], jpj.DensePIPIndex)
    assert isinstance(tidx["dense"], tpj.DensePIPIndex)
    return jp, jg, jidx, tp, tg, tidx


@pytest.mark.parametrize("chunk", [1 << 14, 1 << 17, 1 << 18])
def test_pip_join_candidates_equal(chunk):
    _set("mosaic.stream.chunk.rows", str(chunk))
    for n in (0, 1, 100, chunk // 8, chunk // 8 + 1, chunk, chunk + 1,
              5 * chunk):
        assert tplanner.pip_join_candidates(n) == \
            jplanner.pip_join_candidates(n, 1), n


@pytest.mark.parametrize("kind", ["dense", "sorted"])
def test_planned_join_equals_jax(planned_indexes, kind):
    """Cold decisions, the pins, then ``calibrate`` (every candidate,
    equal zones) and the learned pick: zones equal to the JAX planned
    join's and the oracle at every step; decisions equal where the
    timings do not decide them."""
    jp, jg, jidx, tp, tg, tidx = planned_indexes
    _set("mosaic.stream.chunk.rows", "4096")
    jrun = jpj.make_planned_pip_join(jidx[kind], jg, polys=jp)
    trun = tpj.make_planned_pip_join(tidx[kind], tg, polys=tp)
    for n, seed in ((1_500, 1), (9_000, 2)):
        pts = nyc_points(n, seed=seed)
        truth = mt.pip_host_truth(pts, tp)
        for pin in ("auto", "monolithic", "streamed"):
            _set("mosaic.planner.force.pip_join", pin)
            jz, _ = jrun(pts)
            tz, _ = trun(pts)
            assert np.array_equal(tz, np.asarray(jz))
            assert np.array_equal(tz, truth)
            if pin != "auto" or n == 1_500:
                # cold, or pinned: no timing decides these
                _decisions_equal(trun.last_decision, jrun.last_decision)
            assert trun.last_decision.strategy == (
                pin if pin != "auto" else
                ("monolithic" if n <= 4096 else "streamed"))
        _set("mosaic.planner.force.pip_join", "auto")
        assert np.array_equal(trun.calibrate(pts), truth)
        tz, _ = trun(pts)
        assert np.array_equal(tz, truth)
        d = trun.last_decision
        assert d.reason.startswith("learned") and not d.forced
        assert (d.strategy, d.chunk) in tplanner.pip_join_candidates(n)
        tplanner.reset()
        jplanner.reset()


def test_planned_join_decision_fields_under_pins():
    """Each pin's Decision equals the JAX package's field for field, the
    chunk included (read as the join reads it)."""
    for pin in ("monolithic", "streamed"):
        _set("mosaic.planner.force.pip_join", pin)
        for n, frac in ((10, None), (300_000, 0.25), (5_000, 1.7)):
            t = tplanner.decide_pip_join(n, in_extent_frac=frac)
            j = jplanner.decide_pip_join(n, 1, in_extent_frac=frac)
            _decisions_equal(t, j)
            assert getattr(t, "chunk", tplanner.chunk_rows()) == \
                getattr(j, "chunk", jplanner.chunk_rows())


@pytest.mark.parametrize("n", [1, 7, 1023, 1024, 1025, 5000, 70_001])
def test_planned_join_bbox_sketch_equals_jax(n):
    """The sketch (torch's ``aminmax`` over the rows) gives the JAX
    package's ``_overlap_frac`` (``points.min(axis=0)`` and ``max``)
    exactly, on a column view, a NaN included, inside, across and outside
    the extent."""
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3))
    if n > 10:
        pts[n // 2, 1] = np.nan
    view = pts[:, :2]

    def jax_form(points64, poly_ext):
        lo = points64.min(axis=0)
        hi = points64.max(axis=0)
        w = max(hi[0] - lo[0], 1e-12) * max(hi[1] - lo[1], 1e-12)
        iw = max(0.0, min(hi[0], poly_ext[2]) - max(lo[0], poly_ext[0]))
        ih = max(0.0, min(hi[1], poly_ext[3]) - max(lo[1], poly_ext[1]))
        return min(1.0, (iw * ih) / w)

    for ext in ((-0.5, -0.5, 0.5, 0.5), (0.2, -3.0, 9.0, 0.1),
                (5.0, 5.0, 6.0, 6.0)):
        assert np.array_equal(tpj._overlap_frac(view, ext),
                              jax_form(view, ext), equal_nan=True), ext
    assert tpj._overlap_frac(view, None) is None
    assert tpj._overlap_frac(view[:0], (0, 0, 1, 1)) is None
