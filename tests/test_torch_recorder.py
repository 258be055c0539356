"""The port's flight recorder, trace contexts and in-flight tickets
against the JAX package's.

* The cases of tests/test_recorder.py whose code the port carries: ring
  bounds, the disabled recorder, the dump-on-error bundle (the failing
  span chain, the located codec error, a metrics snapshot), the error
  sink's drop event, config events, trace ids across threads (once a
  caller installs the propagation, which importing the port does not),
  ``root_trace``, fault and retry events, the bundle's platform entry
  and the dump event.  The SQL cases (the slow-query conf and its dumps,
  interleaved queries, EXPLAIN ANALYZE) are in
  tests/test_torch_sql_planes.py.  The JAX compile listener has no torch counterpart
  (no jit, ROADMAP C14); the OpenMetrics cases wait for §A9c.
* Parity: the same calls in both packages record events equal in kind
  and fields (timestamps, ``seq`` and trace ids aside): the config,
  fault, ingest and retry primitives, and the planner's
  ``planner_decision`` and ``planner_mispredict`` and the layout
  advisor's ``layout_advice`` events.
* The stated divergence: the bundle's ``"jax"`` entry is a ``"device"``
  entry from ``torch.cuda``, read only when CUDA is initialized, so a
  dump on this CPU host reads ``{"initialized": False}`` and initializes
  nothing.  Its ``timeseries``, ``device_memory``, ``profile`` and
  ``queries`` entries carry the JAX package's keys.
* The event catalogue: every ``recorder.record`` kind in the port's
  source is in ``EVENTS``, and every kind in ``EVENTS`` is recorded
  somewhere.
* In-flight tickets: cancel, deadline, checkpoints, the observer, the
  notes and the cancel event.
"""

import ast
import json
import struct
import threading
from pathlib import Path

import pytest
import torch

import mosaic_tpu_torch
from mosaic_tpu import config as jconfig
from mosaic_tpu.obs import context as jcontext
from mosaic_tpu.obs.recorder import EVENTS as JEVENTS
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.resilience import faults as jfaults
from mosaic_tpu.resilience import ingest as jingest
from mosaic_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from mosaic_tpu_torch import config as _config
from mosaic_tpu_torch.obs import (context, current_trace_id, inflight,
                                  metrics, new_trace, recorder, root_trace,
                                  tracer)
from mosaic_tpu_torch.obs.inflight import (QueryCancelled, checkpoint,
                                           note_partition_bytes,
                                           note_partitions, note_refine,
                                           note_strategies,
                                           ticket_observer)
from mosaic_tpu_torch.obs.recorder import EVENTS
from mosaic_tpu_torch.resilience import faults, ingest
from mosaic_tpu_torch.resilience.ingest import (CodecError, ErrorSink,
                                                decode_guard)
from mosaic_tpu_torch.resilience.retry import RetryPolicy
from mosaic_tpu_torch.resilience.testing import (fault_plan,  # noqa: F401
                                                 no_faults)

PORT = Path(mosaic_tpu_torch.__file__).resolve().parent


@pytest.fixture
def clean_obs():
    """Fresh tracer + recorder + registry for one test."""
    was_m = metrics.enabled
    recorder.reset()
    recorder.enable()
    tracer.reset()
    tracer.enable()
    yield
    tracer.disable()
    tracer.reset()
    recorder.reset()
    if was_m:
        metrics.enable()


@pytest.fixture
def clean_config():
    prev = _config.default_config()
    yield
    _config.set_default_config(prev)


# ------------------------------------------------------------- ring

def test_ring_is_bounded(clean_obs):
    recorder.reset(capacity=32)
    try:
        for i in range(100):
            recorder.record("tick", i=i)
        evs = recorder.events("tick")
        assert len(evs) == 32
        assert evs[0]["i"] == 68 and evs[-1]["i"] == 99
        seqs = [e["seq"] for e in evs]
        assert seqs == sorted(seqs)
        assert recorder.dropped == 68
        assert metrics.counter_value("obs/recorder_dropped") == 68
    finally:
        recorder.reset(capacity=4096)


def test_disabled_recorder_records_nothing(clean_obs):
    recorder.disable()
    recorder.record("tick")
    assert recorder.events() == []
    recorder.enable()
    recorder.record("tick")
    assert len(recorder.events("tick")) == 1


# ------------------------------------------------- dump-on-error

def test_dump_on_error_bundle_shape(clean_obs, clean_config, tmp_path,
                                    monkeypatch):
    monkeypatch.setenv("MOSAIC_TPU_DUMP_DIR", str(tmp_path))
    metrics.count("io/records_dropped")
    with pytest.raises(CodecError):
        with recorder.dump_on_error(reason="test_error"):
            with new_trace("ingest:broken") as ctx:
                with tracer.span("read_file"):
                    with tracer.span("decode_strip"):
                        with decode_guard(path="f.bin",
                                          feature="strip 3", offset=77):
                            raise struct.error("unpack requires more")
    dumps = list(tmp_path.glob("*_test_error.json"))
    assert len(dumps) == 1
    b = json.loads(dumps[0].read_text())
    assert b["reason"] == "test_error"
    assert b["error"].startswith("CodecError")
    assert b["metrics"]["counters"]["io/records_dropped"] == 1
    assert b["config"]["io_on_error"] == "raise"
    assert "jax" not in b and b["device"] == {"initialized": False}
    # the memory and device planes fill the JAX package's entries, each
    # with the JAX package's own keys
    jb = jrec.bundle(reason="shape")
    for key in ("timeseries", "device_memory", "profile", "queries"):
        assert b[key] and set(b[key]) == set(jb[key]), key
    assert isinstance(b["memory"], dict)
    (ce,) = [e for e in b["events"] if e["kind"] == "codec_error"]
    assert ce["feature"] == "strip 3" and ce["offset"] == 77
    assert ce["trace"] == ctx.trace_id
    spans = {e["name"]: e for e in b["events"] if e["kind"] == "span"}
    child = spans["read_file/decode_strip"]
    parent = spans["read_file"]
    assert child["parent"] == parent["span"]
    assert child["error"].startswith("CodecError")
    assert parent["error"].startswith("CodecError")
    assert child["trace"] == parent["trace"] == ctx.trace_id


def test_error_sink_drop_lands_in_recorder(clean_obs):
    sink = ErrorSink("skip", driver="grib", path="g.grib")
    try:
        with decode_guard(path="g.grib", feature="message 2", offset=9):
            raise IndexError("short buffer")
    except CodecError as e:
        sink.handle(e)
    (ev,) = recorder.events("codec_record_dropped")
    assert ev["driver"] == "grib" and ev["feature"] == "message 2"
    assert sink.dropped() == 1


def test_slow_query_conf_waits_for_the_sql_engine(clean_config):
    """The slow-query threshold waited for the port's SQL engine, which
    reads it now (tests/test_torch_sql_planes.py drives the dump): the
    key takes and refuses what the JAX package's does, with the same
    message."""
    for val in ("250", "0", "0.0001", "-5", "soon"):
        try:
            want = jconfig.apply_conf(jconfig.default_config(),
                                      "mosaic.obs.slow.query.ms",
                                      val).obs_slow_query_ms
        except jconfig.ConfigError as e:
            with pytest.raises(_config.ConfigError) as got:
                _config.apply_conf(_config.default_config(),
                                   "mosaic.obs.slow.query.ms", val)
            assert str(got.value) == str(e)
            continue
        assert _config.apply_conf(_config.default_config(),
                                  "mosaic.obs.slow.query.ms",
                                  val).obs_slow_query_ms == want


def test_config_mutation_is_recorded(clean_obs, clean_config):
    _config.apply_conf(_config.default_config(),
                       _config.MOSAIC_IO_ON_ERROR, "skip")
    _config.apply_conf(_config.default_config(),
                       "mosaic.planner.force.refine", "flat")
    evs = recorder.events("config")
    assert [(e["key"], e["value"]) for e in evs] == [
        (_config.MOSAIC_IO_ON_ERROR, "skip"),
        ("mosaic.planner.force.refine", "flat")]
    with pytest.raises(_config.ConfigError):
        _config.apply_conf(_config.default_config(),
                           _config.MOSAIC_IO_ON_ERROR, "maybe")
    assert len(recorder.events("config")) == 2   # a refused SET: no event


def test_dump_throttled_cooldown(clean_obs, clean_config, tmp_path,
                                 monkeypatch):
    monkeypatch.setenv("MOSAIC_TPU_DUMP_DIR", str(tmp_path))
    _config.set_default_config(_config.apply_conf(
        _config.default_config(), "mosaic.obs.dump.cooldown.ms", "60000"))
    assert recorder.dump_throttled(reason="auto") is not None
    assert recorder.dump_throttled(reason="auto") is None
    assert recorder.dump_throttled(reason="auto") is None
    assert [e["suppressed"] for e in
            recorder.events("dump_suppressed")] == [1, 2]
    _config.set_default_config(_config.apply_conf(
        _config.default_config(), "mosaic.obs.dump.cooldown.ms", "0"))
    assert recorder.dump_throttled(reason="auto") is not None
    (fl,) = recorder.events("dump_suppressed_flush")
    assert fl["suppressed"] == 2
    assert len(list(tmp_path.glob("*_auto.json"))) == 2


# --------------------------------------------------- trace contexts

@pytest.fixture
def propagation(monkeypatch):
    """The port's thread propagation installed for one test, and
    ``Thread.start`` restored after it."""
    monkeypatch.setattr(threading.Thread, "start", threading.Thread.start)
    monkeypatch.setattr(context, "_patched", False)
    assert context.install_thread_propagation()
    assert not context.install_thread_propagation()     # once only


def test_trace_id_propagates_across_threads(clean_obs, propagation):
    seen = {}

    def worker():
        seen["trace"] = current_trace_id()
        with tracer.span("worker_span"):
            pass

    with new_trace("parent") as ctx:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["trace"] == ctx.trace_id
    spans = tracer.report()["traces"][ctx.trace_id]["spans"]
    assert [s["name"] for s in spans] == ["worker_span"]
    (ev,) = recorder.events("span")
    assert ev["trace"] == ctx.trace_id


def test_thread_without_trace_is_untouched(clean_obs, propagation):
    seen = {}
    t = threading.Thread(
        target=lambda: seen.update(trace=current_trace_id()))
    t.start()
    t.join()
    assert seen["trace"] is None


def test_both_packages_propagate_their_own_trace(clean_obs, propagation):
    """Both packages wrap ``Thread.start``; a thread started under both
    packages' traces sees each package's own trace id."""
    seen = {}

    def worker():
        seen["port"] = current_trace_id()
        seen["jax"] = jcontext.current_trace_id()

    with new_trace("port") as mine, jcontext.new_trace("jax") as theirs:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen == {"port": mine.trace_id, "jax": theirs.trace_id}


def test_root_trace_joins_active_trace(clean_obs):
    with new_trace("outer") as outer:
        with root_trace("inner") as inner:
            assert inner.trace_id == outer.trace_id
    with root_trace("standalone") as alone:
        assert alone.trace_id != outer.trace_id
        assert alone.name == "standalone"


@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "garbage", "", None])
def test_traceparent_helpers_equal_jax(header, clean_obs):
    assert context.parse_traceparent(header) == \
        jcontext.parse_traceparent(header)
    ctx = context.TraceContext("t1-00001", "x")
    jctx = jcontext.TraceContext("t1-00001", "x")
    assert context.make_traceparent(ctx) == jcontext.make_traceparent(jctx)
    with context.link_traceparent(header) as link:
        with new_trace("linked") as t:
            assert (t.w3c_trace, t.w3c_parent) == (link or (None, None))
    assert len(recorder.events("trace_link")) == (1 if link else 0)


# ------------------------------------------------ resilience events

def test_fault_plan_firings_land_in_recorder(clean_obs, fault_plan):
    plan = fault_plan("seed=7;site=recorder.test,fails=2")
    for _ in range(2):
        with pytest.raises(OSError):
            faults.maybe_fail("recorder.test")
    faults.maybe_fail("recorder.test")       # third call: clean
    evs = recorder.events("fault_injected")
    assert [(e["site"], e["call"]) for e in evs] == \
        [("recorder.test", 0), ("recorder.test", 1)]
    assert all(e["seed"] == 7 for e in evs)
    assert len(plan.injected) == 2


def test_retry_attempts_land_in_recorder(clean_obs):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(f"blip {calls['n']}")
        return "ok"

    policy = RetryPolicy(name="rec.test", max_attempts=4,
                         base_delay_s=0.0, jitter=0.0)
    assert policy.call(flaky, sleep=lambda _s: None) == "ok"
    attempts = recorder.events("retry")
    assert [e["attempt"] for e in attempts] == [0, 1]
    assert all(e["policy"] == "rec.test" and "blip" in e["error"]
               for e in attempts)
    (rec_ev,) = recorder.events("retry_recovered")
    assert rec_ev["attempts"] == 3
    with pytest.raises(OSError):
        policy.call(lambda: (_ for _ in ()).throw(OSError("dead")),
                    sleep=lambda _s: None)
    (gu,) = recorder.events("retry_giveup")
    assert gu["policy"] == "rec.test" and "dead" in gu["error"]


def _scenario(pkg):
    """One sequence of recorder-feeding calls through either package:
    (config, faults, ingest, RetryPolicy, recorder, context)."""
    cfgmod, fmod, imod, Policy, rec, ctxmod = pkg
    plan = fmod.FaultPlan.from_spec(
        "seed=5;site=ev.*,fails=2;site=ev.cap,mode=degrade,rate=1.0")
    fmod.arm(plan)
    try:
        cfgmod.apply_conf(cfgmod.default_config(), "mosaic.io.on.error",
                          "null")
        with ctxmod.new_trace("scenario"):
            for _ in range(3):
                try:
                    fmod.maybe_fail("ev.site")
                except OSError:
                    pass
            fmod.degrade("ev.cap", 64)
            sink = imod.ErrorSink("skip", driver="gtiff", path="x.tif")
            try:
                with imod.decode_guard(path="x.tif", feature="strip 1",
                                       offset=40):
                    struct.unpack("<d", b"\x00\x01")
            except imod.CodecError as e:
                sink.handle(e)
            n = {"k": 0}

            def flaky():
                n["k"] += 1
                if n["k"] < 2:
                    raise OSError("transient")
                return 1
            Policy(name="scn", base_delay_s=0.0, jitter=0.0).call(
                flaky, sleep=lambda _s: None)
    finally:
        fmod.disarm()
    return [{k: v for k, v in e.items() if k not in ("ts", "seq", "trace")}
            for e in rec.events()]


def test_recorder_events_equal_jax_in_kind_and_fields(clean_obs,
                                                      both_configs):
    was = jrec.enabled
    jrec.reset()
    jrec.enable()
    prev_plan = jfaults.active(), faults.active()
    try:
        theirs = _scenario((jconfig, jfaults, jingest, JRetryPolicy, jrec,
                            jcontext))
        mine = _scenario((_config, faults, ingest, RetryPolicy, recorder,
                          context))
    finally:
        jrec.reset()
        if not was:
            jrec.disable()
        for mod, p in zip((jfaults, faults), prev_plan):
            mod.arm(p) if p is not None else mod.disarm()
    assert [e["kind"] for e in mine] == [
        "config", "fault_injected", "fault_injected", "fault_injected",
        "codec_error", "codec_record_dropped", "retry", "retry_recovered"]
    assert mine == theirs


@pytest.fixture
def both_configs():
    jprev, tprev = jconfig.default_config(), _config.default_config()
    yield
    jconfig.set_default_config(jprev)
    _config.set_default_config(tprev)


# ------------------------------------------------------ bundle misc

def test_bundle_device_entry_never_initializes_cuda(clean_obs):
    """The stated divergence: a ``"device"`` entry where the JAX package
    has ``"jax"``; read only when CUDA is already initialized."""
    initialized = torch.cuda.is_initialized()
    b = recorder.bundle(reason="t")
    assert "jax" not in b
    assert b["device"]["initialized"] == initialized
    assert torch.cuda.is_initialized() == initialized
    if not initialized:
        assert b["device"] == {"initialized": False}
    assert b["config"]["io_on_error"] in ("raise", "skip", "null")
    theirs = set(jrec.bundle(reason="t"))
    assert theirs - set(b) == {"jax"} and set(b) - theirs == {"device"}


def test_dump_event_is_appended(clean_obs, tmp_path):
    p = recorder.dump(path=str(tmp_path / "x.json"), reason="manual")
    assert p == str(tmp_path / "x.json")
    (ev,) = recorder.events("dump")
    assert ev["path"] == p and ev["reason"] == "manual"
    assert json.loads(Path(p).read_text())["reason"] == "manual"


# ------------------------------------------------------- the catalogue

def _recorded_kinds():
    kinds = {}
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            # timeseries.record(<series>, value) names a time series,
            # not a recorder event
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "record" and node.args and \
                    not (isinstance(node.func.value, ast.Name) and
                         node.func.value.id == "timeseries") and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                kinds.setdefault(node.args[0].value, []).append(
                    f"{path.relative_to(PORT)}:{node.lineno}")
    return kinds


def test_every_recorded_kind_is_in_the_catalogue():
    kinds = _recorded_kinds()
    assert set(kinds) <= EVENTS, {k: v for k, v in kinds.items()
                                  if k not in EVENTS}
    assert EVENTS <= set(kinds), EVENTS - set(kinds)
    # the port's kinds are the JAX package's names
    assert EVENTS <= JEVENTS


def _planner_layout_events(config_mod, planner_cls, heat_mod, advise,
                           rec):
    """One package's planner decisions (a pinned one and two learned
    ones), a close estimate and a mispredict, and two layout advices,
    recorded into that package's recorder: its events, ``ts``, ``seq``
    and trace ids aside."""
    cfg = config_mod.default_config()
    for key, val in (("mosaic.planner.force.knn", "brute"),
                     ("mosaic.heat.halflife.ms", "0")):
        cfg = config_mod.apply_conf(cfg, key, val)
    config_mod.set_default_config(cfg)
    rec.reset()
    heat_mod.reset()
    pl = planner_cls()
    pl.decide_knn(5_000, 64, 128)
    pl.decide_refine(262_144, 0.5, 30)
    pl.decide_refine(100, 0.9, 1, depth=2)
    pl.observe_estimate("pip_join", 100, 101)
    pl.observe_estimate("pip_join", 10, 5_000)
    advise(total_rows=3_000_000, partitions=40, current_res=512,
           record=True)
    for cell, rows in ((3, 900), (5, 100), (9, 40)):
        heat_mod.touch(cell, rows=rows)
    advise(record=True)
    advise(record=False)
    heat_mod.reset()
    return [{k: v for k, v in e.items() if k not in ("ts", "seq", "trace")}
            for e in rec.events()
            if e["kind"] not in ("config", "jax_compile")]


def test_planner_and_layout_events_equal_jax(clean_obs, both_configs):
    from mosaic_tpu.obs.heat import heat as jheat
    from mosaic_tpu.sql.layout import advise_layout as jadvise
    from mosaic_tpu.sql.planner import Planner as JPlanner
    from mosaic_tpu_torch.obs.heat import heat
    from mosaic_tpu_torch.sql.layout import advise_layout
    from mosaic_tpu_torch.sql.planner import Planner
    was = jrec.enabled
    jrec.enable()
    try:
        theirs = _planner_layout_events(jconfig, JPlanner, jheat, jadvise,
                                        jrec)
    finally:
        jrec.reset()
        if not was:
            jrec.disable()
    mine = _planner_layout_events(_config, Planner, heat, advise_layout,
                                  recorder)
    assert [e["kind"] for e in mine] == [
        "planner_decision", "planner_decision", "planner_decision",
        "planner_mispredict", "layout_advice", "layout_advice"]
    assert mine[0]["forced"] and mine[0]["strategy"] == "brute"
    assert mine[3]["est_rows"] == 10 and mine[3]["actual_rows"] == 5_000
    assert mine[5]["evidence"]["heat"]["tracked"] == 3
    assert mine == theirs


# ------------------------------------------------------- in-flight

def test_cancel_raises_at_next_checkpoint(clean_obs):
    with new_trace("q") as ctx:
        t = inflight.register("unit", principal="p")
        try:
            assert inflight.ticket_for_trace(ctx.trace_id) is t
            checkpoint("a")
            assert t.operator == "a"
            assert inflight.cancel(t.query_id)
            with pytest.raises(QueryCancelled) as ei:
                checkpoint("b")
            assert ei.value.outcome == "cancelled"
            assert ei.value.query_id == t.query_id
        finally:
            inflight.finish(t, "cancelled")
    assert not inflight.cancel(t.query_id)     # gone once finished
    (ev,) = recorder.events("query_cancel_requested")
    assert ev["query_id"] == t.query_id and ev["principal"] == "p"
    assert ev["trace"] == ctx.trace_id


def test_deadline_raises_and_outside_a_query_is_free(clean_obs):
    checkpoint("no query")                     # quiescent: no ticket
    with new_trace("q"):
        t = inflight.register("unit", deadline_ms=1e-6)
        try:
            with pytest.raises(QueryCancelled) as ei:
                checkpoint()
            assert ei.value.outcome == "deadline"
        finally:
            inflight.finish(t)
    assert len(inflight) == 0


def test_notes_charge_the_active_ticket(clean_obs):
    seen = []
    with new_trace("q"):
        with ticket_observer(seen.append):
            t = inflight.register("notes")
        try:
            note_strategies({"refine": "refined (forced)"})
            note_refine({"cells_refined": 3, "cells_flat": 5,
                         "refined_points": 10, "flat_points": 20},
                        summary="L5+1")
            note_partitions([(7, 100), (9, 50)])
            note_partition_bytes({7: 800, 11: 16})
            cost = t.cost()
        finally:
            inflight.finish(t)
    assert seen == [t]
    assert t.strategies == {"refine": "refined (forced)"}
    assert cost["cells_refined"] == 3 and cost["cells_flat"] == 5
    assert t.refine_ops == [("-", "L5+1")]
    assert t.partitions == {7: [100, 800], 9: [50, 0], 11: [0, 16]}
    # outside the query: nothing is charged anywhere
    note_partitions([(7, 1)])
    assert t.partitions[7] == [100, 800]
