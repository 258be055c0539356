"""The port's telemetry spool (``obs.spool``) against the JAX package's.

* Format: a spool the port writes reads back through the JAX package's
  ``read_spool`` and the other way round; the same version, file name
  and sections (metrics with histogram buckets, windowed series, SLO
  state, in-flight tickets, the last recorder events).
* The spool is written on the sampler's tick when
  ``mosaic.obs.fleet.dir`` is set (``fleet/spool_writes``) and not at all
  when it is not; ``mosaic.obs.fleet.window.ms`` clips the series and
  ``mosaic.obs.fleet.events`` the events, as in the JAX package.
* Torn JSON, a wrong version, a non-object and a missing metrics section
  raise ``SpoolError`` in both packages.
* The aggregator that merges spools (``obs/fleet.py``) is held in
  tests/test_torch_fleet.py.
"""

import json
import os

import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.obs.spool import SPOOL_VERSION as JVERSION
from mosaic_tpu.obs.spool import SpoolError as JSpoolError
from mosaic_tpu.obs.spool import read_spool as jread
from mosaic_tpu.obs.spool import spool_path as jspool_path
from mosaic_tpu.obs.spool import spool_snapshot as jsnapshot
from mosaic_tpu.obs.spool import write_spool as jwrite
from mosaic_tpu.obs.timeseries import timeseries as jts
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics, recorder
from mosaic_tpu_torch.obs.spool import (SPOOL_VERSION, SpoolError,
                                        read_spool, spool_path,
                                        spool_snapshot, write_spool)
from mosaic_tpu_torch.obs.timeseries import Sampler, timeseries


@pytest.fixture
def planes():
    prev = tconfig.default_config(), jconfig.default_config()
    was = metrics.enabled, jmetrics.enabled, jrec.enabled
    for reg in (metrics, jmetrics):
        reg.reset()
        reg.enable()
    for rec in (recorder, jrec):
        rec.reset()
        rec.enable()
    timeseries.reset()
    jts.reset()
    yield
    tconfig._default_config, jconfig._default_config = prev
    for reg, w in ((metrics, was[0]), (jmetrics, was[1])):
        reg.reset()
        if not w:
            reg.disable()
    recorder.reset()
    jrec.reset()
    if not was[2]:
        jrec.disable()
    timeseries.reset()
    jts.reset()


def _conf(mod, **kv):
    cfg = mod.default_config()
    for k, v in kv.items():
        cfg = mod.apply_conf(cfg, k, v)
    mod._default_config = cfg


def _feed(reg, rec, store):
    reg.count("pipeline/h2d_bytes", 4096.0)
    reg.gauge("shard/skew/pip_join", 1.5)
    for v in (0.5, 3.0, 70.0):
        reg.observe("pipeline/chunk_ms", v)
    for i in range(30):
        store.record("s/a", float(i), 1000.0 + i)
    for i in range(5):
        rec.record("unit", i=i)


def test_constants_and_paths_equal_jax(tmp_path):
    assert SPOOL_VERSION == JVERSION == 1
    assert spool_path(str(tmp_path), 42) == jspool_path(str(tmp_path), 42)
    assert spool_path(str(tmp_path)).endswith(f"worker-{os.getpid()}.json")


def test_snapshots_have_the_jax_shape(planes):
    _feed(metrics, recorder, timeseries)
    _feed(jmetrics, jrec, jts)
    t = spool_snapshot(now=1029.0, window_s=10.0, events_cap=3)
    j = jsnapshot(now=1029.0, window_s=10.0, events_cap=3)
    assert set(t) == set(j)
    assert t["metrics"] == j["metrics"]
    assert t["series"] == j["series"]
    assert len(t["series"]["s/a"]["raw"]) == 11   # the 10 s window
    assert t["slo"] == j["slo"] == {"active": [], "breaches": 0}
    assert [e["i"] for e in t["events"]] == [e["i"] for e in j["events"]] \
        == [2, 3, 4]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_spool(planes, tmp_path, writer):
    _feed(metrics, recorder, timeseries)
    _feed(jmetrics, jrec, jts)
    d = tmp_path / writer
    w = write_spool if writer == "port" else jwrite
    path = w(str(d), now=1029.0)
    assert path == spool_path(str(d))
    a, b = read_spool(path), jread(path)
    assert a == b
    assert a["version"] == 1 and a["pid"] == os.getpid()
    assert a["metrics"]["counters"]["pipeline/h2d_bytes"] == 4096.0
    assert not os.path.exists(f"{path}.tmp.{os.getpid()}")


def test_sampler_tick_writes_the_spool(planes, tmp_path):
    _conf(tconfig, **{"mosaic.obs.fleet.dir": str(tmp_path),
                      "mosaic.obs.fleet.window.ms": "5000",
                      "mosaic.obs.fleet.events": "2"})
    _feed(metrics, recorder, timeseries)
    s = Sampler(1000.0, timeseries)
    s.tick(now=1029.0)
    assert not s.alive
    snap = read_spool(spool_path(str(tmp_path)))
    assert snap["ts"] == 1029.0 and len(snap["events"]) == 2
    assert len(snap["series"]["s/a"]["raw"]) == 6   # 1024..1029
    assert metrics.counter_value("fleet/spool_writes") == 1
    s.tick(now=1030.0)
    assert read_spool(spool_path(str(tmp_path)))["ts"] == 1030.0
    assert metrics.counter_value("fleet/spool_writes") == 2


def test_no_directory_no_spool(planes, tmp_path):
    assert write_spool() is None is jwrite()
    Sampler(1000.0, timeseries).tick(now=5.0)
    assert metrics.counter_value("fleet/spool_writes") == 0


def test_write_failure_is_counted_not_raised(planes, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    for w, reg in ((write_spool, metrics), (jwrite, jmetrics)):
        assert w(str(blocker / "sub")) is None
        assert reg.counter_value("fleet/spool_write_errors") == 1


@pytest.mark.parametrize("body", ["{torn", json.dumps({"version": 2,
                                                       "metrics": {}}),
                                  json.dumps([1, 2]),
                                  json.dumps({"version": 1})])
def test_bad_spools_raise_in_both(tmp_path, body):
    path = tmp_path / "worker-1.json"
    path.write_text(body)
    for read, err in ((read_spool, SpoolError), (jread, JSpoolError)):
        with pytest.raises(err):
            read(str(path))
    assert issubclass(SpoolError, ValueError)
