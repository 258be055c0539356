"""The port's profiling plane (``obs.profiler``) against the JAX package's.

* :class:`KernelLedger`: the same seeded ``register`` / ``observe`` /
  ``record_cost`` sequence, its seconds the test's own (an injected
  clock), gives equal reports in both packages (launches, seconds,
  rows, rates, cost joins, the entry bound and its drops); a launch
  observed under a registered query charges its ticket's ``device_s``.
* The streamed join feeds the ledger as the JAX package's does:
  ``pip/streamed``, one launch a chunk, every row, under a key of the
  JAX call site's shape (``(id(idx), id(grid), eps, margin_eps,
  precision)``).
* :class:`HostProfiler`: both packages' profilers sample the same
  parked thread inside both packages' traces, by hand (``sample()``, no
  thread): equal reports (stacks, counts, per-trace rollups), collapsed
  text and speedscope profiles; the same bounds.
* ``capture_snapshot`` has the JAX package's shape; the conf-driven
  lifecycle (``configure_profiler``, ``MOSAIC_TPU_PROFILE_HZ``) starts
  and stops a thread only on a change, and every thread a test starts is
  stopped before it returns; ``maybe_device_capture`` is off unless
  ``mosaic.obs.profile.trace.ms`` is set.
"""

import importlib
import threading

import numpy as np
import pytest

from mosaic_tpu.bench.workloads import build_workload as jbuild_workload
from mosaic_tpu.obs import new_trace as jnew_trace
from mosaic_tpu.obs.inflight import inflight as jinflight
from mosaic_tpu.obs.profiler import HostProfiler as JHostProfiler
from mosaic_tpu.obs.profiler import KernelLedger as JLedger
from mosaic_tpu.obs.profiler import capture_snapshot as jcapture
from mosaic_tpu.obs.profiler import ledger as jledger
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.parallel import pip_join as jpj
import mosaic_tpu_torch as mt
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import inflight, new_trace, recorder
from mosaic_tpu_torch.obs.profiler import (HostProfiler, KernelLedger,
                                           capture_snapshot,
                                           configure_profiler, ledger,
                                           maybe_device_capture, profiler,
                                           start_profiler, stop_profiler)
from mosaic_tpu_torch.parallel import pip_join as tpj

prof_mod = importlib.import_module("mosaic_tpu_torch.obs.profiler")


def _ledger_script(led, seed):
    rng = np.random.default_rng(seed)
    names = ["pip/streamed", "pip/sharded_wrap", "pip/sharded_stream"]
    led.register("pip/unseen", ("k", 1))
    for _ in range(200):
        name = names[int(rng.integers(0, 3))]
        key = (int(rng.integers(0, 3)), "data", None, 1e-6)
        led.observe(name, key, float(rng.uniform(1e-4, 5e-2)),
                    rows=int(rng.integers(0, 1 << 18)))
    led.record_cost("pip/streamed", {"flops": 1.5e9,
                                     "bytes_accessed": 3.0e6})
    return led.report(), led.seconds(), led.seconds("pip/streamed")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_ledger_reports_equal_jax(seed):
    assert _ledger_script(KernelLedger(), seed) == \
        _ledger_script(JLedger(), seed)


def test_kernel_ledger_bound_equals_jax():
    t, j = KernelLedger(max_entries=3), JLedger(max_entries=3)
    for led in (t, j):
        for i in range(7):
            led.observe("k", i, 0.01)
        led.enabled = False
        led.observe("k", 0, 1.0)              # off: ignored
    assert t.report() == j.report()
    assert t.dropped == j.dropped == 4


def test_observe_charges_the_query_ticket():
    for ctx, reg, led in ((new_trace, inflight, KernelLedger()),
                          (jnew_trace, jinflight, JLedger())):
        with ctx("q"):
            t = reg.register("q", principal="p")
            led.observe("k", 0, 0.25)
            led.observe("k", 0, 0.5)
        reg.finish(t)
        assert t.device_s == 0.75


@pytest.fixture(scope="module")
def flagship():
    polys, grid, res = mt.build_workload(n_side=2, grid_name="H3")
    jpolys, jgrid, jres = jbuild_workload(n_side=2, grid_name="H3")
    idx = tpj.build_pip_index(polys, res, grid, device="cpu")
    jidx = jpj.build_pip_index(jpolys, jres, jgrid)
    ext = polys.bboxes()
    rng = np.random.default_rng(9)
    pts = np.stack([rng.uniform(ext[:, 0].min(), ext[:, 2].max(), 3500),
                    rng.uniform(ext[:, 1].min(), ext[:, 3].max(), 3500)],
                   1)
    return (idx, grid, polys), (jidx, jgrid, jpolys), pts


def test_streamed_join_feeds_the_ledger_as_jax(flagship):
    (idx, grid, polys), (jidx, jgrid, jpolys), pts = flagship
    tpj.make_streamed_pip_join(idx, grid, polys, chunk=1000,
                               device="cpu")(pts)
    jpj.make_streamed_pip_join(jidx, jgrid, polys=jpolys, chunk=1000)(pts)
    try:
        (t,) = [e for e in ledger.report()["kernels"]
                if e["name"] == "pip/streamed" and
                e["key"].startswith(f"({id(idx)}, {id(grid)},")]
        (j,) = [e for e in jledger.report()["kernels"]
                if e["name"] == "pip/streamed" and
                e["key"].startswith(f"({id(jidx)}, {id(jgrid)},")]
        assert t["launches"] == j["launches"] == 4
        assert t["rows"] == j["rows"] == len(pts)
        assert t["seconds"] > 0 and j["seconds"] > 0
        assert t["key"].split(", ", 2)[2] == j["key"].split(", ", 2)[2] \
            == "None, None, 'auto')"
    finally:
        ledger.reset()
        jledger.reset()


def _parked(ready, release):
    ready.set()
    release.wait(30)


@pytest.fixture
def parked():
    """A thread parked inside both packages' traces; stopped after."""
    ready, release = threading.Event(), threading.Event()

    def body():
        with jnew_trace("parked"), new_trace("parked"):
            _parked(ready, release)

    th = threading.Thread(target=body, name="parked", daemon=True)
    th.start()
    assert ready.wait(30)
    yield th
    release.set()
    th.join(30)


def _parked_view(p, name):
    rep = p.report()
    stacks = [s for s in rep["stacks"]
              if s["frames"] and any(":_parked" in f for f in s["frames"])]
    return {"stacks": [(s["trace_name"], s["frames"], s["count"])
                       for s in stacks],
            "traces": sorted((v["name"], v["samples"])
                             for v in rep["traces"].values()
                             if v["name"] == name),
            "keys": sorted(rep), "samples": rep["samples"],
            "collapsed": [line.rsplit(" ", 1)[0] for line in
                          p.collapsed().splitlines() if ":_parked" in line]}


def test_host_profiler_reports_equal_jax(parked):
    t, j = HostProfiler(hz=50.0), JHostProfiler(hz=50.0)
    for _ in range(5):
        t.sample()
        j.sample()
    vt, vj = _parked_view(t, "parked"), _parked_view(j, "parked")
    assert vt == vj
    assert vt["samples"] == 5 and vt["traces"] == [("parked", 5)]
    (stack,) = vt["stacks"]
    assert stack[1][-1].endswith(":wait") and stack[2] == 5
    assert not t.alive and not j.alive       # sample() starts no thread
    st, sj = t.speedscope(), j.speedscope()
    for s in (st, sj):
        s.pop("exporter")
        s.pop("name")
        s["profiles"][0].pop("name")
    assert set(st) == set(sj)
    assert st["profiles"][0]["type"] == "sampled"
    assert st["profiles"][0]["endValue"] == sum(st["profiles"][0]["weights"])


def test_host_profiler_bounds_equal_jax(parked):
    views = []
    for cls in (HostProfiler, JHostProfiler):
        p = cls(max_stacks=1, max_depth=2)
        for _ in range(4):
            p.sample()
        rep = p.report()
        assert rep["distinct_stacks"] <= 1
        assert all(len(s["frames"]) <= 2 for s in rep["stacks"])
        views.append((p.hz, p.max_stacks, p.max_depth, rep["samples"]))
        p.reset()
        assert p.report()["distinct_stacks"] == 0 and p.samples == 0
    assert views[0] == views[1]
    assert HostProfiler(hz=5000).hz == JHostProfiler(hz=5000).hz == 1000.0


def test_capture_snapshot_shape_equals_jax():
    assert profiler() is None
    t, j = capture_snapshot(), jcapture()
    assert set(t) == set(j) == {"ledger", "host", "collapsed"}
    assert t["host"] == {} and t["collapsed"] == ""
    assert set(t["ledger"]) == set(j["ledger"])


@pytest.fixture
def clean_profiler(monkeypatch):
    monkeypatch.delenv("MOSAIC_TPU_PROFILE_HZ", raising=False)
    stop_profiler()
    prev = prof_mod._conf_hz, tconfig.default_config()
    prof_mod._conf_hz = None
    recorder.reset()
    jrec.reset()
    yield
    stop_profiler()
    prof_mod._conf_hz, tconfig._default_config = prev
    recorder.reset()


def test_configure_profiler_lifecycle(clean_profiler):
    configure_profiler(0.0)
    assert profiler() is None
    configure_profiler(40.0)
    p = profiler()
    assert p is not None and p.alive and p.hz == 40.0
    (ev,) = recorder.events("profiler")
    assert {k: ev[k] for k in ("action", "hz")} == {"action": "start",
                                                    "hz": 40.0}
    configure_profiler(40.0)
    assert profiler() is p
    configure_profiler(0.0)
    assert profiler() is None and not p.alive
    start_profiler(30.0)                      # programmatic: survives
    configure_profiler(0.0)
    assert profiler() is not None


def test_env_pins_the_rate(clean_profiler, monkeypatch):
    monkeypatch.setenv("MOSAIC_TPU_PROFILE_HZ", "97")
    configure_profiler(40.0)
    assert profiler() is None


def test_profile_hz_conf_starts_the_profiler(clean_profiler):
    cfg = tconfig.apply_conf(tconfig.default_config(),
                             "mosaic.obs.profile.hz", "25")
    tconfig.set_default_config(cfg)
    p = profiler()
    assert p is not None and p.alive and p.hz == 25.0
    tconfig.set_default_config(tconfig.apply_conf(
        cfg, "mosaic.obs.profile.hz", "0"))
    assert profiler() is None and not p.alive


def test_device_capture_is_off_by_default(clean_profiler):
    assert maybe_device_capture("unit") is None
