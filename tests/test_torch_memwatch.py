"""The port's device-memory plane (``obs.memwatch``, ``obs.jaxmon``)
against the JAX package's.

* The streamed flagship join in both packages under the same budget (a
  budget whose pressure mark sits below one 64-row chunk's bytes, so
  every decision after the first chunk halves, whatever the JAX
  package's fetch worker has released by then): zones equal to each
  other, to the unshrunk run and to ``pip_host_truth``; the same split
  boundaries, ``mem/chunk_shrink`` count and single ``mem_chunk_shrink``
  event; both books balanced (every registration released, nothing
  live).  Under budgets that press only some decisions, the port's
  boundaries and halvings equal ``tools/split_model.py``'s host model
  of the executor (the JAX package's then depend on its worker's
  timing).
* The leak drill (one release lost at the ``memwatch.release`` fault
  site under ``accounted``): one ``mem_leak`` event naming the same site
  and bytes in each package, one ``mem/leaks``, the live bytes back to
  0; a clean query fires nothing.
* Stated divergences pinned: bytes are logical (``numel *
  element_size``, not the allocator's 512-byte blocks); device keys are
  ``<type>:<index>``; ``sample_memory`` on a CPU host reads the host's
  peak RSS and never initializes CUDA.
* The ledger's register / release / pressure / budget / snapshot reads
  equal the JAX package's for the same calls.
"""

import os
import sys

import numpy as np
import pytest
import torch

from mosaic_tpu import config as jconfig
from mosaic_tpu.bench.workloads import build_workload as jbuild_workload
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.accounting import accounted as jaccounted
from mosaic_tpu.obs.accounting import audit as jaudit
from mosaic_tpu.obs.accounting import meter as jmeter
from mosaic_tpu.obs.memwatch import mem_budget as jbudget
from mosaic_tpu.obs.memwatch import memwatch as jmw
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.resilience import faults as jfaults
import mosaic_tpu_torch as mt
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics, recorder
from mosaic_tpu_torch.obs.accounting import accounted, audit, meter
from mosaic_tpu_torch.obs.jaxmon import (device_capacity, last_watermarks,
                                         sample_memory)
from mosaic_tpu_torch.obs.memwatch import (device_keys_of, mem_budget,
                                           memwatch, tensor_bytes)
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.perf.pipeline import chunk_rows, stream
from mosaic_tpu_torch.resilience import faults

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools.split_model import split_model  # noqa: E402

#: a budget whose pressure mark (0.5 of 1,000 bytes) sits below one
#: 64-row chunk of the dense join (64 x (8 staged + 5 fetched) bytes)
TIGHT = {"mosaic.mem.budget.bytes": "1000",
         "mosaic.mem.pressure.high": "0.5"}


@pytest.fixture
def planes():
    """Both packages' ledgers, registries, recorders, meters and configs
    fresh; restored after."""
    prev = tconfig.default_config(), jconfig.default_config()
    was = metrics.enabled, jmetrics.enabled, jrec.enabled
    for reg in (metrics, jmetrics):
        reg.reset()
        reg.enable()
    for rec in (recorder, jrec):
        rec.reset()
        rec.enable()
    for x in (memwatch, jmw, audit, jaudit, meter, jmeter):
        x.reset()
    yield
    faults.disarm()
    jfaults.disarm()
    tconfig._default_config, jconfig._default_config = prev
    for reg, w in ((metrics, was[0]), (jmetrics, was[1])):
        reg.reset()
        if not w:
            reg.disable()
    recorder.reset()
    jrec.reset()
    if not was[2]:
        jrec.disable()
    for x in (memwatch, jmw, audit, jaudit, meter, jmeter):
        x.reset()


def _conf(settings):
    for mod in (tconfig, jconfig):
        cfg = mod.default_config()
        for k, v in settings.items():
            cfg = mod.apply_conf(cfg, k, v)
        mod._default_config = cfg


@pytest.fixture(scope="module")
def flagship():
    """The dense flagship shape (taxi zones, H3 res 9) in both packages,
    5,000 seeded points in its extent and their f64 truth."""
    polys, grid, res = mt.build_workload(n_side=2, grid_name="H3")
    jpolys, jgrid, jres = jbuild_workload(n_side=2, grid_name="H3")
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    jidx = jpj.build_pip_index(jpolys, jres, jgrid)
    ext = polys.bboxes()
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(ext[:, 0].min(), ext[:, 2].max(), 5000),
                    rng.uniform(ext[:, 1].min(), ext[:, 3].max(), 5000)],
                   1)
    return ((idx, grid, polys), (jidx, jgrid, jpolys), pts,
            tpj.pip_host_truth(pts, polys))


def _spy(mod, monkeypatch):
    """The slices each ``stream`` call hands its consumer, in order."""
    seen = []
    real = mod.stream

    def spy(*args, **kw):
        args = list(args)
        key = "consume" if "consume" in kw else 4
        c = kw[key] if key == "consume" else args[key]

        def consume(i, sl, host):
            seen.append((sl.start, sl.stop))
            return c(i, sl, host)
        if key == "consume":
            kw[key] = consume
        else:
            args[key] = consume
        return real(*args, **kw)

    monkeypatch.setattr(mod, "stream", spy)
    return seen


def _strip(evs):
    return [{k: v for k, v in e.items()
             if k not in ("ts", "seq", "trace", "query_id")} for e in evs]


def _books(mw):
    t = mw.snapshot()["totals"]
    return (t["live_bytes"], t["live_buffers"],
            t["registered"] == t["released"], mw.leak_count())


@pytest.mark.parametrize("chunk", [2048, 1000])
def test_streamed_flagship_shrink_equals_jax(planes, flagship, chunk,
                                            monkeypatch):
    (idx, grid, polys), (jidx, jgrid, jpolys), pts, truth = flagship
    run = tpj.make_streamed_pip_join(idx, grid, polys, chunk=chunk,
                                     device="cpu")
    jrun = jpj.make_streamed_pip_join(jidx, jgrid, polys=jpolys,
                                      chunk=chunk)
    z_free, _ = run(pts)
    metrics.reset()
    jmetrics.reset()
    seen_t, seen_j = _spy(tpj, monkeypatch), _spy(jpj, monkeypatch)
    _conf(TIGHT)
    z, r = run(pts)
    jz, jr = jrun(pts)
    assert np.array_equal(z, truth) and np.array_equal(z, z_free)
    assert np.array_equal(z, jz) and r == jr
    assert seen_t == seen_j
    assert len(seen_t) > -(-len(pts) // chunk)
    shrinks = metrics.counter_value("mem/chunk_shrink")
    assert shrinks > 0 and shrinks == jmetrics.counter_value(
        "mem/chunk_shrink")
    (ev,) = recorder.events("mem_chunk_shrink")
    assert _strip([ev]) == _strip(jrec.events("mem_chunk_shrink"))
    assert ev["site"] == "pip_join/streamed" and ev["rows"] == chunk
    assert _books(memwatch) == _books(jmw) == (0, 0, True, 0)
    # and the host model of the executor
    slices, model_shrinks = split_model(len(pts), chunk, 8, 5, 1000, 0.5)
    assert seen_t == slices and shrinks == model_shrinks


@pytest.mark.parametrize("chunks_live", [1.0, 1.5, 2.2, 3.1])
def test_stream_splits_as_the_host_model(planes, flagship, chunks_live,
                                         monkeypatch):
    """Budgets whose pressure mark sits at ``chunks_live`` chunks' worth
    of staged and fetched bytes press only some decisions."""
    (idx, grid, polys), _, pts, truth = flagship
    chunk = 1024
    budget = int(chunks_live * chunk * 13 / 0.75)
    run = tpj.make_streamed_pip_join(idx, grid, polys, chunk=chunk,
                                     device="cpu")
    seen = _spy(tpj, monkeypatch)
    _conf({"mosaic.mem.budget.bytes": str(budget),
           "mosaic.mem.pressure.high": "0.75"})
    z, _ = run(pts)
    slices, shrinks = split_model(len(pts), chunk, 8, 5, budget, 0.75)
    assert np.array_equal(z, truth)
    assert seen == slices
    assert metrics.counter_value("mem/chunk_shrink") == shrinks
    assert len(recorder.events("mem_chunk_shrink")) == (1 if shrinks
                                                        else 0)
    assert _books(memwatch) == (0, 0, True, 0)


def test_leak_drill_one_event_in_each_package(planes, flagship):
    (idx, grid, polys), (jidx, jgrid, jpolys), pts, truth = flagship
    run = tpj.make_streamed_pip_join(idx, grid, polys, chunk=2048,
                                     device="cpu")
    jrun = jpj.make_streamed_pip_join(jidx, jgrid, polys=jpolys,
                                      chunk=2048)
    jrun(pts)                                 # warm (compile)
    jmw.reset()
    spec = "seed=3;site=memwatch.release,fails=1,error=OSError"
    faults.arm(spec)
    jfaults.arm(spec)
    with accounted("leak-drill", principal="mallory"):
        z, _ = run(pts)
    with jaccounted("leak-drill", principal="mallory"):
        jrun(pts)
    assert np.array_equal(z, truth)
    evs, jevs = recorder.events("mem_leak"), jrec.events("mem_leak")
    assert len(evs) == len(jevs) == 1
    assert _strip(evs) == _strip(jevs)
    assert evs[0]["site"] == "pip_join/streamed/out"
    assert evs[0]["bytes"] == 2048 * 5 and evs[0]["buffers"] == 1
    for reg, mw in ((metrics, memwatch), (jmetrics, jmw)):
        assert reg.counter_value("mem/leaks") == 1
        assert reg.counter_value("mem/release_skipped") == 1
        assert mw.leak_count() == 1
        assert mw.total_live() == 0 and mw.live_buffers() == 0
    for d in memwatch.live_by_device():
        assert metrics.gauge_value(f"mem/live_bytes/{d}") == 0.0
    # a clean follow-up query adds no leak
    faults.disarm()
    with accounted("clean", principal="mallory"):
        run(pts)
    assert len(recorder.events("mem_leak")) == 1


def test_cancelled_stream_leaves_no_live_bytes(planes, flagship):
    """A cancel at a chunk boundary drops the staged-but-unfetched
    chunks' registrations: no leak at completion."""
    from mosaic_tpu_torch.obs import QueryCancelled, inflight
    (idx, grid, polys), _, pts, _ = flagship
    run = tpj.make_streamed_pip_join(idx, grid, polys, chunk=1000,
                                     device="cpu")
    with pytest.raises(QueryCancelled):
        with accounted("cancel", principal="p") as t:
            inflight.cancel(t.query_id)
            run(pts)
    assert _books(memwatch) == (0, 0, True, 0)
    assert recorder.events("mem_leak") == []
    (rec,) = audit.records()
    assert rec["outcome"] == "cancelled"


def test_logical_bytes_not_allocator_blocks(planes):
    """A 1,001-row chunk of two f32 columns registers 8,008 bytes, not
    the allocator's 8,192-byte block; a strided view counts its own
    elements, not its storage."""
    data = np.arange(2002, dtype=np.float32).reshape(1001, 2)
    got = []

    def stage(sl, out):
        out[...] = data[sl]

    stream(chunk_rows(1001, 1001), stage, 2, lambda i, x: (x[:, :1] * 2,),
           lambda i, sl, host: got.append(host[0].copy()),
           torch.device("cpu"), site="unit")
    snap = memwatch.snapshot()
    assert snap["site_peak_bytes"] == {"unit/staged": 8008,
                                       "unit/out": 4004}
    assert snap["totals"]["live_bytes"] == 0
    assert np.array_equal(got[0][:, 0], data[:, 0] * 2)
    x = torch.zeros(100, 8)
    assert tensor_bytes(x[:, ::2]) == 100 * 4 * 4
    assert tensor_bytes((x, (x[:10], np.zeros(3)))) == \
        3200 + 320 + 24


def test_device_keys(planes):
    x = torch.zeros(4)
    assert device_keys_of(x) == ["cpu:0"]
    assert device_keys_of((x, [x, {"a": x}])) == ["cpu:0"]
    assert device_keys_of(np.zeros(4)) == []
    assert device_keys_of(None) == []


def test_sample_memory_reads_the_host_and_never_initializes_cuda(planes):
    out = sample_memory()
    assert list(out) == ["cpu:0"]
    assert out["cpu:0"]["source"] == "host_rss"
    assert out["cpu:0"]["peak_bytes"] > 0
    assert last_watermarks() == out
    assert metrics.gauge_value("mem/peak_bytes/cpu:0") == \
        out["cpu:0"]["peak_bytes"]
    assert metrics.gauge_value("mem/source/cpu:0") == 0.0
    assert not torch.cuda.is_initialized()
    from mosaic_tpu.obs.jaxmon import _host_total_bytes
    assert device_capacity()["cpu:0"] == float(_host_total_bytes())
    assert memwatch.capacity("cpu:0") == float(_host_total_bytes())


def _ledger_script(mw, budget, reg):
    """One register / release / pressure / budget sequence; its reads."""
    out = []
    t1 = mw.register("a/staged", 3000, devices=["cpu:0"], trace="t1")
    t2 = mw.register("a/out", 1001, devices=["cpu:0", "cpu:1"],
                     trace="t1")
    out.append((mw.total_live(), mw.live_by_device(), mw.live_buffers(),
                mw.trace_live_bytes("t1"), mw.trace_peak_bytes("t1"),
                round(mw.pressure("cpu:0"), 12), budget.shrink_needed(),
                budget.admit(5000), budget.admit(6000)))
    mw.release(t1)
    out.append((mw.total_live(), mw.live_by_device(),
                budget.shrink_needed(), mw.trace_peak_bytes("t1")))
    mw.release(t2)
    mw.release(None)
    snap = mw.snapshot()
    out.append((snap["totals"], snap["site_peak_bytes"],
                sorted(snap["devices"]),
                reg.counter_value("mem/admit_denied")))
    return out


def test_ledger_reads_equal_jax(planes):
    _conf({"mosaic.mem.budget.bytes": "10000",
           "mosaic.mem.pressure.high": "0.3"})
    assert _ledger_script(memwatch, mem_budget, metrics) == \
        _ledger_script(jmw, jbudget, jmetrics)
    assert _strip(recorder.events("mem_admit_denied")) == \
        _strip(jrec.events("mem_admit_denied"))
    assert len(recorder.events("mem_admit_denied")) == 1
    assert set(memwatch.snapshot()) == set(jmw.snapshot())


def test_disabled_ledger_tracks_nothing(planes, flagship):
    (idx, grid, polys), _, pts, truth = flagship
    _conf({"mosaic.obs.mem.enabled": "false",
           "mosaic.mem.budget.bytes": "1"})
    assert memwatch.register("x", 100) is None
    assert mem_budget.admit(1 << 30) and not mem_budget.shrink_needed()
    z, _ = tpj.make_streamed_pip_join(idx, grid, polys, chunk=1000,
                                      device="cpu")(pts)
    assert np.array_equal(z, truth)
    assert memwatch.snapshot()["totals"]["registered"] == 0
    assert metrics.counter_value("mem/chunk_shrink") == 0


def test_store_fed_join_registers_its_blocks(planes, flagship, tmp_path):
    """The store-fed join's memory site (``pip_join/store/staged``, the
    JAX package's ``mosaic_tpu/parallel/pip_join.py:671``), its kernel
    ledger rows (``pip/sharded_stream``), the skew gauge and the
    one-device devicemon share; zones equal to the oracle's in store
    order, and the books balance."""
    from mosaic_tpu_torch.obs import devicemon, ledger
    from mosaic_tpu_torch.store import ChipStore, write_store
    (idx, grid, polys), _, pts, truth = flagship
    write_store(str(tmp_path), pts, grid_res=64, shard_rows=1024)
    store = ChipStore(str(tmp_path))
    devicemon.reset()
    ledger.reset()
    try:
        run = tpj.make_store_sharded_pip_join(store, idx, grid,
                                              polys=polys, chunk=2048,
                                              device="cpu")
        z, _ = run()
        cols = store.read_columns()
        got = np.stack([cols["x"], cols["y"]], 1)
        assert np.array_equal(z, tpj.pip_host_truth(got, polys))
        snap = memwatch.snapshot()
        assert set(snap["site_peak_bytes"]) == {"pip_join/store/staged",
                                                "pip_join/store/out"}
        assert _books(memwatch) == (0, 0, True, 0)
        # one row a padded chunk size (the JAX package's key)
        es = [e for e in ledger.report()["kernels"]
              if e["name"] == "pip/sharded_stream"]
        assert sum(e["rows"] for e in es) == len(z)
        assert sum(e["launches"] for e in es) == \
            metrics.counter_value("pip_join/store_chunks") > 1
        assert metrics.gauge_value("shard/skew/pip_join") == 1.0
        assert list(devicemon.busy_by_device()) == ["cpu:0"]
        assert metrics.counter_value("collective/points_scatter_bytes") \
            == 8 * len(z)
    finally:
        devicemon.reset()
        ledger.reset()
