"""The port's time-series store, sampler and the plane's conf keys against
the JAX package's.

* The same seeded ``(ts, value)`` sequence through both packages'
  :class:`Series` gives equal window stats, rates, quantiles,
  ``fraction_over`` and window maxima (exact: the same float operations
  in the same order), in the raw ring, past it into the mid rollups and
  past those into the coarse ones; equal snapshots, and each package
  restores the other's snapshot to equal reads.
* :meth:`Sampler.tick` with an explicit ``now`` (no thread) records the
  registry's counters, gauges and histogram count/sum under the same
  names and values in both packages.
* The sampler's lifecycle: ``configure_sampler`` starts and stops a
  thread only on a change, ``MOSAIC_TPU_OBS_SAMPLE_MS`` pins it, and
  ``mosaic.obs.sample.ms`` through ``set_default_config`` starts it, as
  the JAX package's ``config.py:690`` does.  Every thread a test starts
  is stopped before it returns.
* The slice's conf keys accept and reject what the JAX package's do.
"""

import importlib
import json

import numpy as np
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.timeseries import Sampler as JSampler
from mosaic_tpu.obs.timeseries import Series as JSeries
from mosaic_tpu.obs.timeseries import TimeSeriesStore as JStore
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.obs.timeseries import (BUCKET_CAP, FOLD, RAW_CAP,
                                             Sampler, Series,
                                             TimeSeriesStore,
                                             configure_sampler, sampler,
                                             stop_sampler)

# the package re-exports the store singleton under the module's name
ts_mod = importlib.import_module("mosaic_tpu_torch.obs.timeseries")

#: point counts: inside the raw ring, into the mid rollups, into coarse
SIZES = (RAW_CAP - 7, RAW_CAP + FOLD * 37 + 3,
         RAW_CAP + FOLD * BUCKET_CAP + FOLD * FOLD * 23 + 5)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    ts = 1000.0 + np.cumsum(rng.uniform(0.1, 2.0, n))
    vals = rng.normal(50.0, 20.0, n)
    vals[rng.random(n) < 0.05] *= 10.0       # a few spikes
    return [(float(t), float(v)) for t, v in zip(ts, vals)]


def _both(n, seed):
    pts = _points(n, seed)
    t, j = Series("s"), JSeries("s")
    for ts, v in pts:
        t.append(ts, v)
        j.append(ts, v)
    return t, j, pts


def _reads(s, pts):
    now = pts[-1][0] + 0.5
    span = pts[-1][0] - pts[0][0]
    out = {"len": len(s), "dropped": s.dropped}
    for frac in (0.001, 0.05, 0.3, 0.9, 2.0):
        w = span * frac
        out[f"stats{frac}"] = s.window_stats(w, now)
        out[f"rate{frac}"] = s.rate(w, now)
        out[f"max{frac}"] = s.max_over_window(w, now)
        for q in (0.0, 50.0, 95.0, 99.0, 100.0):
            out[f"q{q}@{frac}"] = s.quantile_over_window(q, w, now)
        for thr in (20.0, 50.0, 120.0):
            out[f"over{thr}@{frac}"] = s.fraction_over(thr, w, now)
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", [1, 2])
def test_series_reads_equal_jax(n, seed):
    t, j, pts = _both(n, seed)
    assert _reads(t, pts) == _reads(j, pts)
    assert (len(t.mid) > 0) == (n > RAW_CAP)


@pytest.mark.parametrize("n", SIZES)
def test_snapshots_equal_and_restore_across_packages(n):
    t, j, pts = _both(n, 7)
    snap = t.snapshot()
    assert json.loads(json.dumps(snap)) == json.loads(json.dumps(
        j.snapshot()))
    # each package restores the other's store snapshot to equal reads
    ts, js = TimeSeriesStore(), JStore()
    for ts_, v in pts:
        ts.record("a/b", v, ts_)
        js.record("a/b", v, ts_)
    t_from_j, j_from_t = TimeSeriesStore(), JStore()
    assert t_from_j.restore(json.loads(json.dumps(js.snapshot()))) == 1
    assert j_from_t.restore(json.loads(json.dumps(ts.snapshot()))) == 1
    assert _reads(t_from_j.series("a/b"), pts) == \
        _reads(j_from_t.series("a/b"), pts) == _reads(j, pts)


def test_store_degrades_like_jax():
    t, j = TimeSeriesStore(), JStore()
    for s in (t, j):
        assert s.window_stats("nope", 60.0, now=1.0)["count"] == 0
        assert s.rate("nope", 60.0, now=1.0) == 0.0
        assert s.fraction_over("nope", 1.0, 60.0, now=1.0) == (0, 0)
    assert t.restore({"version": 2}) == j.restore({"version": 2}) == 0


@pytest.fixture
def registries():
    """Both packages' registries on and empty; restored after."""
    was_t, was_j = metrics.enabled, jmetrics.enabled
    metrics.reset()
    jmetrics.reset()
    metrics.enable()
    jmetrics.enable()
    yield
    metrics.reset()
    jmetrics.reset()
    if not was_t:
        metrics.disable()
    if not was_j:
        jmetrics.disable()


def _own_names(store):
    # device folds differ by host (the JAX CPU mesh has 8 devices, the
    # port one CPU) and carry the host's RSS: compare the registry's
    return {n for n in store.names()
            if not n.startswith(("mem/", "device/", "obs/alerts"))}


def test_sampler_tick_records_the_registry_as_jax(registries):
    for reg in (metrics, jmetrics):
        reg.count("pipeline/h2d_bytes", 4096.0)
        reg.count("mem/chunk_shrink", 3.0)
        reg.gauge("shard/skew/pip_join", 1.25)
        for v in (1.0, 2.0, 40.0):
            reg.observe("pipeline/chunk_ms", v)
    ts, js = TimeSeriesStore(), JStore()
    t = Sampler(50.0, ts)
    j = JSampler(50.0, js)
    for now in (5000.0, 5000.5):
        t.tick(now=now)
        j.tick(now=now)
    assert t.ticks == j.ticks == 2
    assert not t.alive                    # tick() starts no thread
    names = _own_names(ts)
    assert names == _own_names(js)
    assert {"pipeline/h2d_bytes", "shard/skew/pip_join",
            "pipeline/chunk_ms:count", "pipeline/chunk_ms:sum"} <= names
    for n in names:
        assert ts.series(n).snapshot() == js.series(n).snapshot(), n
    # the device fold ran: the port's own CPU device
    assert ts.series("device/peak_bytes/cpu:0") is not None


@pytest.fixture
def clean_sampler(monkeypatch):
    monkeypatch.delenv("MOSAIC_TPU_OBS_SAMPLE_MS", raising=False)
    stop_sampler()
    prev_conf, prev_cfg = ts_mod._conf_ms, tconfig.default_config()
    ts_mod._conf_ms = None
    yield
    stop_sampler()
    ts_mod._conf_ms = prev_conf
    tconfig._default_config = prev_cfg


def test_configure_sampler_lifecycle(clean_sampler):
    configure_sampler(0.0)
    assert sampler() is None
    configure_sampler(40.0)
    s = sampler()
    assert s is not None and s.alive and s.interval_ms == 40.0
    configure_sampler(40.0)               # unchanged: the same thread
    assert sampler() is s
    configure_sampler(0.0)
    assert sampler() is None and not s.alive


def test_env_pins_the_cadence(clean_sampler, monkeypatch):
    monkeypatch.setenv("MOSAIC_TPU_OBS_SAMPLE_MS", "250")
    configure_sampler(40.0)
    assert sampler() is None              # the pin ignores the conf


def test_sample_ms_conf_starts_and_stops_the_sampler(clean_sampler,
                                                     registries):
    cfg = tconfig.apply_conf(tconfig.default_config(),
                             "mosaic.obs.sample.ms", "30")
    tconfig.set_default_config(cfg)
    s = sampler()
    assert s is not None and s.alive and metrics.enabled
    tconfig.set_default_config(tconfig.apply_conf(
        cfg, "mosaic.obs.sample.ms", "0"))
    assert sampler() is None and not s.alive


#: (key, value): every key of the slice with values the JAX package
#: accepts and rejects
CONF_CASES = [
    ("mosaic.mem.budget.bytes", v) for v in ("0", "1048576", "-1", "x",
                                             "1.5")
] + [
    ("mosaic.mem.pressure.high", v) for v in ("0.85", "1", "0", "1.5",
                                              "nan", "x")
] + [
    ("mosaic.obs.mem.enabled", v) for v in ("true", "off", "maybe")
] + [
    ("mosaic.obs.sample.ms", v) for v in ("0", "12.5", "-1", "x")
] + [
    ("mosaic.obs.slo.dump", v) for v in ("true", "0", "sometimes")
] + [
    ("mosaic.obs.profile.hz", v) for v in ("0", "97", "-3", "fast")
] + [
    ("mosaic.obs.profile.trace.ms", v) for v in ("0", "250", "-1")
] + [
    ("mosaic.principal", v) for v in ("", "tenant-a")
] + [
    ("mosaic.query.deadline.ms", v) for v in ("0", "1500", "-2", "soon")
] + [
    ("mosaic.audit.path", v) for v in ("", "/x/audit.jsonl")
] + [
    ("mosaic.audit.rotate.bytes", v) for v in ("0", "65536", "-5")
] + [
    ("mosaic.audit.retain", v) for v in ("0", "8", "-1", "many")
] + [
    ("mosaic.obs.fleet.dir", v) for v in ("", "/x/fleet")
] + [
    ("mosaic.obs.fleet.window.ms", v) for v in ("0", "300000", "-1")
] + [
    ("mosaic.obs.fleet.events", v) for v in ("0", "512", "-1", "lots")
]


def _apply(mod, key, value):
    cfg = mod.MosaicConfig()
    try:
        new = mod.apply_conf(cfg, key, value)
    except mod.ConfigError as e:
        return "raise", str(e)
    changed = {f: getattr(new, f) for f in vars(new)
               if getattr(new, f) != getattr(cfg, f)}
    return "ok", changed


@pytest.mark.parametrize("key,value", CONF_CASES)
def test_conf_keys_validate_as_jax(key, value):
    assert _apply(tconfig, key, value) == _apply(jconfig, key, value)


@pytest.mark.parametrize("key", ["mosaic.obs.fleet.stale.ms",
                                 "mosaic.history.dir"])
def test_fleet_and_history_keys_validate_as_jax(key):
    """``mosaic.obs.fleet.stale.ms`` and the history keys, read by the
    fleet aggregator and the history plane, accept and reject what the
    JAX package's do."""
    for value in ("1", "0", "-5", "x", ""):
        assert _apply(tconfig, key, value) == _apply(jconfig, key, value)
    assert _apply(tconfig, key, "1")[0] == "ok"
