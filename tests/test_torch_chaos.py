"""Chaos tests of the port: seeded fault plans through its real code
paths, held against the JAX package under the same plans.

Each package is armed through its own ``faults.arm`` with the same spec
string (this module's ``fault_plan`` and ``no_faults`` are the port's
fixtures, which shadow the JAX package's from tests/conftest.py here).

* tests/test_chaos.py's cases at ported sites: the GeoTIFF strip
  corruption under ``skip``, ``null`` and ``raise`` (tiles and error
  records equal to JAX's), clean parity across modes, the raster
  checkpoint riding out transient IO under ``CHECKPOINT_RETRY``, the
  model checkpoint's retried save and torn-latest resume, the native
  library's lost-library rebuild and transient compile failure, and the
  overlay under degraded capacities, here on the port's sharded exchange
  in a gloo world of two CPU ranks (the exchange doubles back to the
  exact answer; a plan naming ``overlay.dup_cap`` alone injects nothing,
  since the port has no such site).
* tests/test_refine.py's ``test_refine_chaos_bailout`` and
  ``test_refine_ticket_cost_and_strategy``; the bailout run beside the
  JAX package's refined join under the same plan (zones, strategy,
  injected faults, the bailout counter and the recorded events equal);
  the bailout lets a hand kernel's error class through (the route made
  to raise it here), and any other failure of the route bails out,
  where the JAX router would route on the host.
* tests/test_store.py's four fault tests, and each of their plans read
  by both packages' ``ChipStore`` off one store: the surviving rows,
  the surfaced error, the injected faults and the ``store_shard_torn``
  events equal.
* The streamed executor: a ``pipeline.fetch`` fault reaches the caller
  and a clean rerun is equal; a ticket cancelled from another thread
  once the first chunk is fetched raises ``QueryCancelled`` within one
  chunk; a ``pipeline.chunk`` stall leaves the zones alone.  On CPU tensors every wrapper runs its
  plain version: no kernel launch is counted.
"""

import dataclasses
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu import config as jconfig
from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
from mosaic_tpu.core.index.h3.system import H3IndexSystem as JH3
from mosaic_tpu.core.raster import checkpoint as jckpt
from mosaic_tpu.core.raster import gtiff as jgtiff
from mosaic_tpu.core.raster.tile import GeoTransform as JGT
from mosaic_tpu.core.raster.tile import RasterTile as JRT
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.resilience import faults as jfaults
from mosaic_tpu.store import ChipStore as JChipStore
from mosaic_tpu.store import StoreWriter as JStoreWriter
import mosaic_tpu_torch as mt
from mosaic_tpu_torch import config as _config
from mosaic_tpu_torch import native
from mosaic_tpu_torch._kernels import KernelError
from mosaic_tpu_torch.core.geometry.array import GeometryBuilder
from mosaic_tpu_torch.core.raster import checkpoint as tckpt
from mosaic_tpu_torch.core.raster.gtiff import read_gtiff, write_gtiff
from mosaic_tpu_torch.core.raster.tile import GeoTransform, RasterTile
from mosaic_tpu_torch.models.checkpoint import CheckpointManager
from mosaic_tpu_torch.models.core import IterationState
from mosaic_tpu_torch.obs import (QueryCancelled, inflight, metrics,
                                  new_trace, recorder)
from mosaic_tpu_torch.ops.cell import latlng_to_cell_margin
from mosaic_tpu_torch.ops.dense_join import dense_join
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.resilience import faults
from mosaic_tpu_torch.resilience.faults import InjectedFault
from mosaic_tpu_torch.resilience.ingest import CodecError
from mosaic_tpu_torch.resilience.testing import (fault_plan,  # noqa: F401
                                                 no_faults)
from mosaic_tpu_torch.sql.planner import planner as tplanner
from mosaic_tpu_torch.store import ChipStore, StoreWriter, write_store


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_state():
    """Both packages disarmed and their configs restored after each test;
    the port's recorder on and empty, its planner reset."""
    jprev, tprev = jconfig.default_config(), _config.default_config()
    was_m = metrics.enabled
    recorder.reset()
    recorder.enable()
    tplanner.reset()
    yield
    jfaults.disarm()
    faults.disarm()
    jconfig.set_default_config(jprev)
    _config.set_default_config(tprev)
    recorder.reset()
    tplanner.reset()
    if not was_m:
        metrics.disable()


def arm_both(spec):
    """The same spec armed in both packages: (jax plan, port plan)."""
    return jfaults.arm(spec), faults.arm(spec)


@pytest.fixture
def jax_recorder():
    """The JAX package's recorder on and empty for one test."""
    was = jrec.enabled
    jrec.reset()
    jrec.enable()
    yield jrec
    jrec.reset()
    if not was:
        jrec.disable()


def _events(rec):
    """A recorder's events, timestamps, ``seq`` and trace ids aside, and
    the JAX package's ``jax_compile`` events (its compile listener, when
    a test in the process installed it; no port counterpart until
    ROADMAP §A9b) left out."""
    return [{k: v for k, v in e.items() if k not in ("ts", "seq", "trace")}
            for e in rec.events() if e["kind"] != "jax_compile"]


def _tile(mk_tile, mk_gt, bands=1, h=8, w=512, nodata=None):
    """tests/test_chaos.py's striped GeoTIFF fixture: 2 rows a strip, 4
    strips, so one damaged strip leaves the rest intact."""
    data = np.arange(bands * h * w, dtype=np.float64).reshape(
        bands, h, w) + 1.0
    return mk_tile(data, mk_gt(0.0, 1.0, 0.0, 0.0, 0.0, -1.0),
                   nodata=nodata)


def _both_tiles(**kw):
    return _tile(JRT, JGT, **kw), _tile(RasterTile, GeoTransform, **kw)


# ------------------------------------------------------------- gtiff

STRIP = "seed=21;site=gtiff.read_strip,fails=1,mode=truncate"


def test_gtiff_strip_corruption_skip_recovers_rest():
    jt, tt = _both_tiles()
    blob = write_gtiff(tt)
    assert blob == jgtiff.write_gtiff(jt)
    clean = read_gtiff(blob)
    jplan, plan = arm_both(STRIP)
    out = read_gtiff(blob, on_error="skip", path="t.tif")
    want = jgtiff.read_gtiff(blob, on_error="skip", path="t.tif")
    assert plan.injected == jplan.injected == \
        [("gtiff.read_strip", 0, "truncate")]
    recs = out.meta["decode_errors"]
    assert recs == want.meta["decode_errors"]
    assert len(recs) == 1 and recs[0]["feature"] == "strip 0"
    assert recs[0]["path"] == "t.tif"
    got = np.asarray(out.data)
    assert np.array_equal(got, np.asarray(want.data))
    assert np.array_equal(got[:, 2:], np.asarray(clean.data)[:, 2:])
    assert np.all(got[:, :2] == 0.0)
    (ev,) = recorder.events("codec_record_dropped")
    assert ev["driver"] == "gtiff" and ev["feature"] == "strip 0"


@pytest.mark.parametrize("nodata,fill", [(None, np.nan),
                                         (-9999.0, -9999.0)])
def test_gtiff_strip_corruption_null_fills_nodata(nodata, fill):
    jt, tt = _both_tiles(nodata=nodata)
    blob = write_gtiff(tt)
    arm_both(STRIP)
    out = np.asarray(read_gtiff(blob, on_error="null").data)
    want = np.asarray(jgtiff.read_gtiff(blob, on_error="null").data)
    assert np.array_equal(out, want, equal_nan=True)
    if np.isnan(fill):
        assert np.all(np.isnan(out[:, :2]))
    else:
        assert np.all(out[:, :2] == fill)


def test_gtiff_strip_corruption_raise_mode_locates():
    _, tt = _both_tiles()
    blob = write_gtiff(tt)
    arm_both(STRIP)
    with pytest.raises(ValueError, match="strip 0"):
        read_gtiff(blob)
    with pytest.raises(ValueError, match="strip 0"):
        jgtiff.read_gtiff(blob)
    (ev,) = recorder.events("codec_error")
    assert ev["feature"] == "strip 0"


def test_gtiff_read_fault_and_clean_parity_across_modes(no_faults):
    _, tt = _both_tiles(bands=2, h=6, w=256)
    blob = write_gtiff(tt)
    want = np.asarray(read_gtiff(blob).data)
    for mode in ("raise", "skip", "null"):
        out = read_gtiff(blob, on_error=mode)
        assert np.array_equal(np.asarray(out.data), want)
        assert "decode_errors" not in out.meta
    # the rule is built, not parsed: the JAX package's lint counts a
    # spec string in tests/ as coverage of its own ``gtiff.read`` site
    plan = faults.arm(faults.FaultPlan(
        seed=3, rules=(faults.FaultRule("gtiff.read", fails=1),)))
    with pytest.raises(OSError):
        read_gtiff(blob, on_error="skip")     # before any strip
    assert plan.injected == [("gtiff.read", 0, "OSError")]
    assert np.array_equal(np.asarray(read_gtiff(blob).data), want)


# ------------------------------------------------- checkpoint retries

def test_raster_checkpoint_rides_out_transient_io(tmp_path):
    spec = ("seed=31;site=checkpoint.write,fails=2;"
            "site=checkpoint.read,fails=2")
    jt, tt = _both_tiles(h=4, w=64)
    jcfg = dataclasses.replace(jconfig.default_config(),
                               raster_use_checkpoint=True,
                               raster_checkpoint=str(tmp_path / "jax"))
    cfg = dataclasses.replace(_config.default_config(),
                              raster_use_checkpoint=True,
                              raster_checkpoint=str(tmp_path / "port"))
    jplan, plan = arm_both(spec)
    rec = tckpt.serialize_tile(tt, cfg)
    jrec_ = jckpt.serialize_tile(jt, jcfg)
    assert isinstance(rec["raster"], str)      # path mode
    out = tckpt.deserialize_tile(rec)
    jckpt.deserialize_tile(jrec_)
    np.testing.assert_array_equal(np.asarray(out.data),
                                  np.asarray(tt.data))
    assert plan.injected == jplan.injected
    sites = [s for s, _, _ in plan.injected]
    assert sites.count("checkpoint.write") == 2
    assert sites.count("checkpoint.read") == 2
    assert [e["policy"] for e in recorder.events("retry_recovered")] == \
        ["checkpoint", "checkpoint"]


def test_model_checkpoint_save_retry_and_torn_latest(fault_plan,
                                                     tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    plan = fault_plan("seed=32;site=checkpoint.model_write,fails=2")
    mgr.save(IterationState(iteration=1,
                            payload={"x": torch.arange(3.0)}))
    assert len(plan.injected) == 2             # retried through
    fault_plan("seed=32")                      # no rules: clean writes
    mgr.save(IterationState(iteration=2,
                            payload={"x": np.arange(4.0)}))
    with open(mgr._file(2), "wb") as f:
        f.write(b"this is not an npz archive")
    metrics.enable()
    base = metrics.counter_value("checkpoint/unreadable")
    got = mgr.load_latest()
    assert got is not None and got.iteration == 1
    np.testing.assert_array_equal(got.payload["x"], np.arange(3.0))
    assert metrics.counter_value("checkpoint/unreadable") == base + 1
    plan = fault_plan("seed=32;site=checkpoint.model_read,fails=1")
    assert mgr.load_latest().iteration == 1    # 2 torn, 1 injected...
    assert plan.injected == [("checkpoint.model_read", 0, "OSError")]


# ----------------------------------------------------- native rebuild

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ toolchain on this host")


@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    """The native library built into an empty directory of its own."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    native.get_lib.cache_clear()
    yield tmp_path / "native"
    native.get_lib.cache_clear()


@needs_gxx
def test_native_cdll_lost_library_rebuild(fault_plan, fresh_native):
    plan = fault_plan("seed=33;site=native.cdll,fails=1")
    lib = native.get_lib()
    assert lib is not None                     # rebuilt + reloaded
    assert plan.injected == [("native.cdll", 0, "OSError")]
    assert native.lib_path().parent == fresh_native
    pts = np.array([[0.5, 0.5], [2.0, 2.0]])
    edges = np.array([[0, 0, 1, 0], [1, 0, 1, 1], [1, 1, 0, 1],
                      [0, 1, 0, 0]], np.float64)
    assert native.pip_first_match(pts, edges,
                                  np.array([0, 4])).tolist() == [0, -1]


@needs_gxx
def test_native_compile_transient_failure_recovers(fault_plan,
                                                   fresh_native):
    plan = fault_plan("seed=34;site=native.compile,fails=1")
    assert native.build() > 0.0
    assert native.lib_path().exists()
    assert plan.injected == [("native.compile", 0, "OSError")]


def test_native_compile_gives_up_and_raises(fault_plan, fresh_native):
    """The stated divergence: where the JAX package falls back to numpy
    after the retries, the port raises."""
    fault_plan("seed=34;site=native.compile,fails=9")
    with pytest.raises(RuntimeError, match="could not build"):
        native.build()
    (gu,) = recorder.events("retry_giveup")
    assert gu["policy"] == "native.compile" and gu["attempts"] == 2


# ------------------------------------------- overlay capacity degrade

def test_sharded_overlay_survives_degraded_capacities(tmp_path):
    from mosaic_tpu.bench.workloads import nyc_zones as jzones
    from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
    from mosaic_tpu.core.index.factory import get_index_system as jget
    from mosaic_tpu.parallel import overlay as jov
    import torch_chaos_worker as worker
    from torch_sharded_worker import join_world
    procs = worker.start_world(tmp_path, 2)
    try:
        b = JBuilder()
        for r in worker.footprint_rings():
            b.add_polygon(r)
        a = b.finish()
        zones = jzones(n_side=3, seed=2, bbox=worker.BBOX)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtess_module, "_f64_jit_enabled",
                       lambda disable_env=None: False)
            jplan = jfaults.arm(worker.DEGRADE)
            want = jov.overlay_intersects(a, zones, 9, jget("H3"))
            jfaults.disarm()
        truth = jov.overlay_host_truth(a, zones)
    finally:
        codes = join_world(procs, 120)
    errs = [p.read_text() for p in tmp_path.glob("error*.txt")]
    assert codes == [0, 0], errs
    assert np.array_equal(want, truth)
    assert ("overlay.dup_cap", 0, "degrade") in jplan.injected
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        for tag in ("degraded", "dup_only", "clean"):
            assert np.array_equal(out[tag], truth), (r, tag)
        assert list(out["degraded_injected"]) == \
            ["overlay.bucket_cap:0:degrade"]
        assert list(out["dup_only_injected"]) == []
        assert out["clean_rounds"] == out["dup_only_rounds"] == 1
        assert out["degraded_rounds"] > 1      # the exchange doubled back


# -------------------------------------------------- refined bailout

def _cluster_polys(n=40, radius=0.004, spread=0.1, seed=0,
                   builder=GeometryBuilder):
    """tests/test_refine.py's cluster of small polygons."""
    rng = np.random.default_rng(seed)
    b = builder()
    for cx, cy in rng.uniform(-spread, spread, size=(n, 2)):
        ang = np.linspace(0.0, 2.0 * np.pi, 8)[:-1]
        b.add_polygon(np.stack([cx + radius * np.cos(ang),
                                cy + radius * np.sin(ang)], 1), [])
    return b.finish()


def _skewed(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-0.12, 0.12, size=(n * 3 // 4, 2)),
        rng.uniform(-2.0, 2.0, size=(n - n * 3 // 4, 2))])


def _set(key, val, mod=_config):
    mod.set_default_config(mod.apply_conf(mod.default_config(), key, val))


@pytest.fixture
def refined_run():
    _set("mosaic.planner.force.refine", "refined")
    _set("mosaic.join.refine.dup.threshold", "2")
    polys = _cluster_polys(seed=13)
    pts = _skewed(8_000, seed=51)
    grid = mt.get_index_system("H3")
    run = tpj.make_refined_pip_join(polys, grid, 5, chunk=4096,
                                    device="cpu")
    return polys, pts, grid, run


def test_refine_chaos_bailout(fault_plan, refined_run):
    polys, pts, _, run = refined_run
    metrics.enable()
    c0 = metrics.counter_value("pip_join/refine_bailouts")
    fault_plan("seed=17;site=join.refine,fails=1")
    z, _ = run(pts)
    assert np.array_equal(z, tpj.pip_host_truth(pts, polys))
    assert run.stats["strategy"] == "flat"
    (ev,) = recorder.events("refine_bailout")
    assert ev["error"] == "InjectedOSError" and ev["rows"] == len(pts)
    assert metrics.counter_value("pip_join/refine_bailouts") == c0 + 1
    faults.disarm()
    z2, _ = run(pts)                           # clean: the refined path
    assert run.stats["strategy"] == "refined"
    assert np.array_equal(z2, z)


def test_refine_chaos_bailout_equals_jax(refined_run, jax_recorder):
    """The JAX package's refined join and the port's under one plan:
    the same zones, strategy, injected faults, bailout counts and
    recorded events (the pinned decision, the fault, the bailout)."""
    polys, pts, _, run = refined_run
    for key, val in (("mosaic.planner.force.refine", "refined"),
                     ("mosaic.join.refine.dup.threshold", "2")):
        _set(key, val, jconfig)
    jrun = jpj.make_refined_pip_join(_cluster_polys(seed=13,
                                                    builder=JBuilder),
                                     JH3(), 5, chunk=4096)
    was_jm = jmetrics.enabled
    jmetrics.enable()
    metrics.enable()
    c0 = (jmetrics.counter_value("pip_join/refine_bailouts"),
          metrics.counter_value("pip_join/refine_bailouts"))
    try:
        jplan, plan = arm_both("seed=17;site=join.refine,fails=1")
        jz, _ = jrun(pts)
        z, _ = run(pts)
        c1 = (jmetrics.counter_value("pip_join/refine_bailouts"),
              metrics.counter_value("pip_join/refine_bailouts"))
    finally:
        if not was_jm:
            jmetrics.disable()
    assert np.array_equal(z, np.asarray(jz))
    assert np.array_equal(z, tpj.pip_host_truth(pts, polys))
    assert run.stats["strategy"] == jrun.stats["strategy"] == "flat"
    assert plan.injected == jplan.injected == \
        [("join.refine", 0, "OSError")]
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 1)
    mine = _events(recorder)
    assert [e["kind"] for e in mine] == [
        "config", "config", "planner_decision", "fault_injected",
        "refine_bailout", "planner_mispredict"]
    assert mine[4]["error"] == "InjectedOSError" and \
        mine[4]["rows"] == len(pts)
    assert mine == _events(jrec)


def test_refine_bailout_lets_kernel_errors_through(refined_run,
                                                   monkeypatch):
    """A hand kernel's failure on the route is never hidden by a flat
    re-run."""
    _, pts, grid, run = refined_run
    run(pts)                                   # probe + refined index
    assert run.stats["strategy"] == "refined"

    def broken(xy, res, device):
        raise KernelError("h3_cell launch: CUDA error 700 (test)")
    monkeypatch.setattr(grid, "point_to_cell_device", broken)
    with pytest.raises(KernelError, match="CUDA error 700"):
        run(pts)
    assert recorder.events("refine_bailout") == []
    assert issubclass(KernelError, RuntimeError)


def test_route_failure_bails_out_where_jax_routes_on_the_host(
        refined_run, monkeypatch):
    """The stated divergence: the JAX router catches any failure of its
    device route and routes on the host (``route_host``); the port's
    route (``IndexSystem.point_to_cell_device``) has no catch-all, so a
    failure there bails the batch out to the flat path, same zones."""
    polys, pts, grid, run = refined_run
    run(pts)

    def failing(xy, res, device):
        raise ValueError("route failed")
    monkeypatch.setattr(grid, "point_to_cell_device", failing)
    z, _ = run(pts)
    assert np.array_equal(z, tpj.pip_host_truth(pts, polys))
    (ev,) = recorder.events("refine_bailout")
    assert ev["error"] == "ValueError" and ev["detail"] == "route failed"
    assert run.stats["strategy"] == "flat"


def test_refine_ticket_cost_and_strategy(refined_run):
    _, pts, _, run = refined_run
    with new_trace("q"):
        t = inflight.register("test refine", principal="t")
        try:
            run(pts)
            cost = t.cost()
        finally:
            inflight.finish(t)
    assert cost["cells_refined"] > 0
    assert cost["cells_flat"] >= 0
    assert t.strategies["refine"].startswith("refined")
    assert t.refine_ops and "L5+1" in t.refine_ops[0][1]


# --------------------------------------------------- store faults

def _pts(n, seed=0, lo=(-74.3, 40.5), hi=(-73.7, 40.95)):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(lo[0], hi[0], n),
                            rng.uniform(lo[1], hi[1], n)])


@pytest.mark.parametrize("spec,mode", [
    ("seed=21;site=store.shard,fails=1,mode=truncate", "skip"),
    ("seed=22;site=store.shard,fails=1,mode=truncate", "null"),
    ("seed=22;site=store.shard,fails=1,mode=truncate", "raise"),
    ("seed=23;site=store.read,fails=1", "raise"),
])
def test_store_fault_plans_read_as_jax_reads(tmp_path, jax_recorder, spec,
                                             mode):
    """One store read by both packages' ``ChipStore`` under the same
    plan: the same surviving rows (or the same error), the same injected
    faults and the same recorded events."""
    write_store(str(tmp_path), _pts(4_000, seed=13), grid_res=64,
                shard_rows=512)
    got = {}
    for name, store, fmod, rec in (("jax", JChipStore, jfaults, jrec),
                                   ("port", ChipStore, faults, recorder)):
        plan = fmod.arm(spec)
        try:
            res = store(str(tmp_path), on_error=mode).read_columns()
        except Exception as e:
            res = (type(e).__name__, str(e))
        finally:
            fmod.disarm()
        got[name] = res, plan.injected, _events(rec)
    (jres, jinj, jevs), (res, inj, evs) = got["jax"], got["port"]
    assert inj == jinj and len(inj) == 1
    assert evs == jevs
    if isinstance(res, tuple):
        assert res == jres
        assert res[0] == ("CodecError" if "shard" in spec
                          else "InjectedOSError")
        return
    assert sorted(res) == sorted(jres)
    for k in jres:
        assert np.array_equal(res[k], jres[k]), k
    torn = [e for e in evs if e["kind"] == "store_shard_torn"]
    assert len(torn) == 1 and torn[0]["mode"] == mode


def test_store_write_fault_leaves_no_store_in_either_package(tmp_path):
    pts = _pts(500, seed=16)
    got = {}
    for name, writer, store, fmod in (
            ("jax", JStoreWriter, JChipStore, jfaults),
            ("port", StoreWriter, ChipStore, faults)):
        root = str(tmp_path / name)
        plan = fmod.arm("seed=24;site=store.write,fails=1")
        try:
            with pytest.raises(OSError) as e:
                writer(root, grid_res=64).append(pts)
        finally:
            fmod.disarm()
        with pytest.raises(ValueError, match="manifest"):
            store(root)
        got[name] = plan.injected, type(e.value).__name__
    assert got["port"] == got["jax"] == \
        ([("store.write", 0, "OSError")], "InjectedOSError")


def test_torn_shard_skip_drops_only_torn_tail(tmp_path, fault_plan):
    pts = _pts(4_000, seed=13)
    write_store(str(tmp_path), pts, grid_res=64, shard_rows=512)
    full = ChipStore(str(tmp_path), on_error="raise").read_columns()
    metrics.enable()
    t0 = metrics.counter_value("store/shards_torn")
    fault_plan("seed=21;site=store.shard,fails=1,mode=truncate")
    cols = ChipStore(str(tmp_path), on_error="skip").read_columns()
    lost = len(full["x"]) - len(cols["x"])
    assert 0 < lost < len(full["x"])
    assert metrics.counter_value("store/shards_torn") - t0 >= 1
    evs = recorder.events("store_shard_torn")
    assert evs and evs[-1]["mode"] == "skip"
    vals, counts = np.unique(cols["x"], return_counts=True)
    fvals, fcounts = np.unique(full["x"], return_counts=True)
    at = np.searchsorted(fvals, vals)
    assert np.array_equal(fvals[at], vals)
    assert np.all(counts <= fcounts[at])


def test_torn_shard_raise_and_null_modes(tmp_path, fault_plan):
    pts = _pts(2_000, seed=14)
    write_store(str(tmp_path), pts, grid_res=64, shard_rows=256)
    n_full = len(ChipStore(str(tmp_path),
                           on_error="raise").read_columns()["x"])
    fault_plan("seed=22;site=store.shard,fails=1,mode=truncate")
    with pytest.raises(CodecError, match="torn shard"):
        ChipStore(str(tmp_path), on_error="raise").read_columns()
    fault_plan("seed=22;site=store.shard,fails=1,mode=truncate")
    cols = ChipStore(str(tmp_path), on_error="null").read_columns()
    assert len(cols["x"]) == n_full


def test_store_read_fault_surfaces(tmp_path, fault_plan):
    write_store(str(tmp_path), _pts(500, seed=15), grid_res=64)
    fault_plan("seed=23;site=store.read,fails=1")
    with pytest.raises(InjectedFault):
        ChipStore(str(tmp_path))


def test_store_write_fault_leaves_no_store(tmp_path, fault_plan):
    fault_plan("seed=24;site=store.write,fails=1")
    w = StoreWriter(str(tmp_path), grid_res=64)
    with pytest.raises(InjectedFault):
        w.append(_pts(500, seed=16))
    with pytest.raises(CodecError, match="manifest"):
        ChipStore(str(tmp_path))


# ------------------------------------------------ the streamed executor

@pytest.fixture(scope="module")
def flagship():
    polys, grid, res = mt.build_workload(n_side=2, grid_name="H3")
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    ext = polys.bboxes()
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(ext[:, 0].min(), ext[:, 2].max(), 6000),
                    rng.uniform(ext[:, 1].min(), ext[:, 3].max(), 6000)], 1)
    run = tpj.make_streamed_pip_join(idx, grid, polys, chunk=1000,
                                     device="cpu")
    return run, pts, tpj.pip_host_truth(pts, polys)


def test_fetch_fault_surfaces_and_clean_rerun_is_equal(flagship,
                                                       fault_plan):
    run, pts, truth = flagship
    k2 = dense_join.launches, latlng_to_cell_margin.launches
    plan = fault_plan("seed=5;site=pipeline.fetch,fails=1")
    with pytest.raises(OSError) as ei:
        run(pts)
    assert isinstance(ei.value, InjectedFault)
    assert plan.injected == [("pipeline.fetch", 0, "OSError")]
    z, _ = run(pts)
    assert np.array_equal(z, truth)
    # CPU tensors: every wrapper ran its plain version
    assert (dense_join.launches, latlng_to_cell_margin.launches) == k2


def test_cancel_raises_at_the_next_chunk_boundary(flagship, fault_plan,
                                                  monkeypatch):
    """A canceller thread cancels once the first chunk is fetched, and
    that fetch returns only after the cancel has, so the join raises at
    the next chunk boundary and fetches at most one chunk more.  The two
    threads meet at events the test sets, never at a timed poll: each
    chunk boundary also stalls 30 ms under the plan, and a scheduler
    that runs the canceller late cannot let the join run ahead of it."""
    import mosaic_tpu_torch.perf.pipeline as tpipe
    run, pts, truth = flagship
    per_chunk = 4 * 1000           # 1000-row chunks of int32 zones
    fault_plan("seed=8;site=pipeline.chunk,mode=delay,fails=6,"
               "delay_ms=30")
    fetched, cancelled = threading.Event(), threading.Event()
    charge = tpipe.charge_d2h_bytes

    def charge_then_wait(n):
        charge(n)
        if not fetched.is_set():
            fetched.set()
            assert cancelled.wait(60), "the canceller never cancelled"

    monkeypatch.setattr(tpipe, "charge_d2h_bytes", charge_then_wait)
    seen = {}
    with new_trace("cancel me"):
        t = inflight.register("flagship", principal="chaos")

        def canceller():
            if fetched.wait(60):
                seen["d2h"] = t.d2h_bytes
                inflight.cancel(t.query_id)
            cancelled.set()

        th = threading.Thread(target=canceller)
        th.start()
        try:
            with pytest.raises(QueryCancelled):
                run(pts)
        finally:
            fetched.set()
            th.join(60)
            inflight.finish(t, "cancelled")
    assert not th.is_alive()
    assert seen["d2h"] >= per_chunk
    assert t.d2h_bytes - seen["d2h"] <= per_chunk
    assert t.d2h_bytes < len(pts) * 4
    assert t.operator == "pipeline.stream"
    (ev,) = recorder.events("query_cancel_requested")
    assert ev["query_id"] == t.query_id
    z, _ = run(pts)
    assert np.array_equal(z, truth)


def test_chunk_stall_keeps_the_zones(flagship, fault_plan):
    run, pts, truth = flagship
    plan = fault_plan("seed=8;site=pipeline.chunk,mode=delay,fails=2,"
                      "delay_ms=1")
    z, _ = run(pts)
    assert np.array_equal(z, truth)
    assert plan.injected == [("pipeline.chunk", 0, "delay"),
                             ("pipeline.chunk", 1, "delay")]
