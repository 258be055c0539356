"""The port's span tracer against the JAX package's.

* The cases of tests/test_trace.py whose code the port carries: nested
  spans, counters, the raster provenance helpers (``record_error``,
  ``warp``'s ``last_command``), histogram and span percentiles, the
  metrics registry merged into the tracer's report, and the disabled
  tracer and registry.  The ``MosaicContext.call`` and map-algebra cases
  are held in tests/test_torch_functions.py and
  test_torch_functions_raster.py; the JAX compile listener
  has no torch counterpart until §A9b; the Chrome-trace export of host
  spans, the collective byte accounting and the ``utils.trace`` shim
  wait for §A9b and §A9c.
* Parity: the tracer's span names and call counts are equal in both
  packages over the overlay (its three entry points), the raster halo
  (both forms, a world of one) and the streamed join.
* ``device_trace`` writes a ``torch.profiler`` Chrome trace into its
  directory (CPU activities here) and records a ``device_trace`` event.
"""

import json
import time

import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu.bench.workloads import nyc_zones as jzones
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.core.raster.tile import GeoTransform as JGT
from mosaic_tpu.core.raster.tile import RasterTile as JRT
from mosaic_tpu.obs import tracer as jtracer
from mosaic_tpu.parallel import overlay as jov
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.parallel import raster_halo as jhalo
from mosaic_tpu_torch.bench.workloads import nyc_zones as tzones
from mosaic_tpu_torch.core.geometry.array import GeometryBuilder as TBuilder
from mosaic_tpu_torch.core.index.factory import get_index_system as tget
from mosaic_tpu_torch.core.raster.tile import GeoTransform, RasterTile
from mosaic_tpu_torch.obs import (Histogram, device_trace, metrics,
                                  record_command, record_error, recorder,
                                  tracer)
from mosaic_tpu_torch.parallel import overlay as tov
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.parallel import raster_halo as thalo

BBOX = (-74.05, 40.65, -73.90, 40.80)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_tracer():
    was_m = metrics.enabled
    tracer.reset()
    tracer.enable()
    yield tracer
    tracer.disable()
    tracer.reset()
    if was_m:
        metrics.enable()


@pytest.fixture
def both_tracers(clean_tracer):
    was = jtracer.enabled
    jtracer.reset()
    jtracer.enable()
    yield
    jtracer.reset()
    if not was:
        jtracer.disable()


def _tile():
    gt = GeoTransform(0.0, 0.1, 0.0, 10.0, 0.0, -0.1)
    return RasterTile(np.arange(100.0).reshape(10, 10)[None], gt)


def test_nested_spans_qualify(clean_tracer):
    with clean_tracer.span("outer"):
        with clean_tracer.span("inner"):
            pass
    spans = clean_tracer.report()["spans"]
    assert "outer" in spans and "outer/inner" in spans
    assert "outer/inner" in clean_tracer.format_report()


def test_counters(clean_tracer):
    clean_tracer.count("chips", 5)
    clean_tracer.count("chips", 2)
    assert clean_tracer.report()["counters"]["chips"] == 7


def test_warp_records_last_command():
    from mosaic_tpu_torch.core.raster.rops import warp
    gt = GeoTransform(-74.0, 0.01, 0.0, 41.0, 0.0, -0.01)
    t = RasterTile(np.ones((1, 20, 20)), gt, srid=4326)
    w = warp(t, 3857)
    assert w.meta["last_command"].startswith("warp(")
    assert w.meta["warped_from"] == "4326"


def test_record_error_metadata():
    t = _tile()
    record_command(t, "rst_custom(x)")
    try:
        raise RuntimeError("boom with a very long message " + "x" * 400)
    except RuntimeError as e:
        record_error(t, e)
    assert t.meta["last_command"] == "rst_custom(x)"
    assert t.meta["last_error"].startswith("RuntimeError")
    assert len(t.meta["last_error"]) <= 200
    assert "full_error" in t.meta


def test_histogram_percentiles():
    h = Histogram("t")
    for v in [0.001] * 95 + [1.0] * 5:
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 100
    assert abs(snap["sum"] - (0.095 + 5.0)) < 1e-9
    assert snap["min"] == 0.001 and snap["max"] == 1.0
    assert 0.001 <= snap["p50"] < 0.0013
    assert 0.5 <= snap["p99"] <= 1.0
    assert snap["p50"] <= snap["p95"] <= snap["p99"]


def test_span_report_percentiles(clean_tracer):
    for _ in range(20):
        with clean_tracer.span("stage"):
            pass
    s = clean_tracer.report()["spans"]["stage"]
    assert s["calls"] == 20
    assert 0.0 <= s["p50_s"] <= s["p95_s"] <= s["p99_s"] <= s["max_s"]
    assert "p95" in clean_tracer.format_report()


def test_metrics_registry(clean_tracer):
    assert metrics.enabled        # tracer.enable() turns metrics on
    metrics.count("x", 2)
    metrics.count("x", 3)
    metrics.gauge("g", 1.5)
    metrics.gauge_max("gm", 1.0)
    metrics.gauge_max("gm", 3.0)
    metrics.gauge_max("gm", 2.0)
    metrics.observe("lat_s", 0.01)
    rep = metrics.report()
    assert rep["counters"]["x"] == 5
    assert rep["gauges"]["g"] == 1.5 and rep["gauges"]["gm"] == 3.0
    assert rep["histograms"]["lat_s"]["count"] == 1
    trep = clean_tracer.report()
    assert trep["counters"]["x"] == 5
    assert trep["gauges"]["gm"] == 3.0


def test_disabled_metrics_record_nothing():
    was = metrics.enabled
    tracer.reset()
    tracer.disable()
    try:
        assert not metrics.enabled
        metrics.count("nope", 1)
        metrics.gauge("nope_g", 1.0)
        metrics.observe("nope_h", 1.0)
        rep = metrics.report()
        assert rep["counters"] == {} and rep["gauges"] == {}
        assert rep["histograms"] == {}
    finally:
        if was:
            metrics.enable()


# ------------------------------------------------------- span parity

@pytest.fixture(scope="module")
def overlay_inputs():
    rng = np.random.default_rng(7)
    boxes = []
    for _ in range(8):
        cx, cy = rng.uniform(BBOX[0], BBOX[2]), rng.uniform(BBOX[1],
                                                            BBOX[3])
        w, h = rng.uniform(2e-4, 2e-3, 2)
        boxes.append(np.array([[cx - w, cy - h], [cx + w, cy - h],
                               [cx + w, cy + h], [cx - w, cy + h],
                               [cx - w, cy - h]]))
    from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
    out = []
    for mk in (JBuilder, TBuilder):
        b = mk()
        for r in boxes:
            b.add_polygon(r)
        out.append(b.finish())
    return (out[0], jzones(n_side=2, seed=2, bbox=BBOX), out[1],
            tzones(n_side=2, seed=2, bbox=BBOX))


def _span_calls(rep):
    return {n: s["calls"] for n, s in rep["spans"].items()}


def test_disabled_tracer_records_nothing():
    tracer.reset()
    tracer.disable()
    thalo.sharded_convolve(_tile(), np.ones((3, 3)), device="cpu")
    assert tracer.report()["spans"] == {}


def test_span_names_equal_jax_over_overlay(overlay_inputs, both_tracers,
                                          monkeypatch):
    monkeypatch.setattr(jtess_module, "_f64_jit_enabled",
                        lambda disable_env=None: False)
    ja, jb, ta, tb = overlay_inputs
    jg, tg = jget("H3"), tget("H3")
    want = jov.overlay_intersects(ja, jb, 9, jg)
    got = tov.overlay_intersects(ta, tb, 9, tg, device="cpu")
    assert np.array_equal(got, want)
    jov.overlay_intersection_area(ja, jb, 9, jg)
    tov.overlay_intersection_area(ta, tb, 9, tg, device="cpu")
    mine, theirs = tracer.report(), jtracer.report()
    assert _span_calls(mine) == _span_calls(theirs) == {
        "overlay/intersects": 1, "overlay/intersection_area": 1,
        "overlay/intersection_area/overlay/row_pairs": 1}
    # one trace a top-level call
    assert [t["name"] for t in mine["traces"].values()] == ["overlay"] * 2
    # the nested row-pairs span is a child of the area span in one trace
    spans = {s["name"]: s for s in
             max(mine["traces"].values(),
                 key=lambda t: len(t["spans"]))["spans"]}
    assert spans["overlay/intersection_area/overlay/row_pairs"][
        "parent_id"] == spans["overlay/intersection_area"]["span_id"]


def test_span_names_equal_jax_over_raster_halo(both_tracers):
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]), axis_names=("data",))
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 1, 16, 12))
    k = rng.normal(size=(3, 3))
    jt = [JRT(d, JGT(0.0, 1.0, 0.0, 0.0, 0.0, -1.0)) for d in data]
    tt = [RasterTile(d, GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, -1.0))
          for d in data]
    jhalo.sharded_convolve(jt[0], k, mesh)
    jhalo.sharded_convolve_stream(jt, k, mesh)
    thalo.sharded_convolve(tt[0], k, device="cpu")
    thalo.sharded_convolve_stream(tt, k, device="cpu")
    assert _span_calls(tracer.report()) == \
        _span_calls(jtracer.report()) == {"halo/convolve": 1,
                                          "halo/convolve_stream": 1}


def test_span_names_equal_jax_over_streamed_join(both_tracers,
                                                 monkeypatch):
    from mosaic_tpu.bench.workloads import build_workload as jbuild
    from mosaic_tpu_torch.bench.workloads import build_workload as tbuild
    monkeypatch.setattr(jtess_module, "_f64_jit_enabled",
                        lambda disable_env=None: False)
    jp, jg, res = jbuild(n_side=2, grid_name="H3")
    tp, tg, _ = tbuild(n_side=2, grid_name="H3")
    rng = np.random.default_rng(11)
    ext = tp.bboxes()
    pts = np.stack([rng.uniform(ext[:, 0].min(), ext[:, 2].max(), 3000),
                    rng.uniform(ext[:, 1].min(), ext[:, 3].max(), 3000)], 1)
    jidx = jpj.build_pip_index(jp, res, jg)
    tidx = tpj.build_pip_index(tp, res, tg, device="cpu")
    jz, _ = jpj.make_streamed_pip_join(jidx, jg, polys=jp, chunk=1024)(pts)
    tz, _ = tpj.make_streamed_pip_join(tidx, tg, tp, chunk=1024,
                                       device="cpu")(pts)
    assert np.array_equal(np.asarray(jz), tz)
    mine, theirs = tracer.report(), jtracer.report()
    assert _span_calls(mine) == _span_calls(theirs) == \
        {"pip_join/streamed": 1}
    for rep in (mine, theirs):
        assert rep["counters"]["pip_join/streamed_points"] == 3000
        assert rep["counters"]["pip_join/streamed_chunks"] == 3
    assert mine["counters"]["pipeline/d2h_bytes"] == 3000 * (4 + 1)


# ------------------------------------------------------- device trace

def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The body's ops are in the trace, ops run before it are not; the
    window is padded only where CUDA is captured."""
    recorder.reset()
    recorder.enable()
    torch.ones(64).cumprod(0)
    t0 = time.perf_counter()
    with device_trace(str(tmp_path), pad_s=30.0) as logdir:
        assert logdir == str(tmp_path)
        torch.ones(64).cumsum(0)
    assert time.perf_counter() - t0 < 30.0
    (ev,) = recorder.events("device_trace")
    doc = json.loads(open(ev["path"]).read())
    assert ev["path"].startswith(str(tmp_path))
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("cumsum" in n for n in names)
    assert not any("cumprod" in n for n in names)
    recorder.reset()
