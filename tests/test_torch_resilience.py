"""The port's fault plans, retry policies and degrade-not-die ingestion
against the JAX package's.

* The cases of tests/test_resilience.py whose code the port carries:
  spec parsing, transient ``fails=N`` rules, deterministic rates, site
  patterns, corruption, degrade, disarmed probes, the retry policy
  (recovery, give-up, allowlist, jitter, hook and counters), the
  ``decode_guard`` / ``ErrorSink`` primitives, the conf keys they read
  and the fixture's restore.  The SQL ``SET`` case is in
  tests/test_torch_sql_planes.py.
* Parity: one spec string armed in both packages, each through its own
  ``faults.arm``, injects the same ``(site, call, kind)`` list over a
  seeded probe sequence; ``corrupt`` returns the same bytes, ``degrade``
  the same values, ``stall`` the same delays; a policy's retry delays are
  equal for a seed.
"""

import dataclasses
import struct

import numpy as np
import pytest

from mosaic_tpu.resilience import faults as jfaults
from mosaic_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from mosaic_tpu_torch import config as _config
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.resilience import faults
from mosaic_tpu_torch.resilience.faults import FaultPlan, InjectedFault
from mosaic_tpu_torch.resilience.ingest import (CodecError, ErrorSink,
                                                decode_guard)
from mosaic_tpu_torch.resilience.retry import (CHECKPOINT_RETRY,
                                               NATIVE_COMPILE_RETRY,
                                               NATIVE_LOAD_RETRY,
                                               RetryPolicy)
from mosaic_tpu_torch.resilience.testing import (fault_plan,  # noqa: F401
                                                 no_faults)


@pytest.fixture
def both_disarmed():
    """Neither package armed during the test; both restored after."""
    prev = jfaults.active(), faults.active()
    jfaults.disarm()
    faults.disarm()
    yield
    for mod, plan in zip((jfaults, faults), prev):
        if plan is None:
            mod.disarm()
        else:
            mod.arm(plan)


# ------------------------------------------------------------ fault plans

def test_spec_parsing():
    plan = FaultPlan.from_spec(
        "seed=7;site=checkpoint.*,rate=0.5,error=OSError;"
        "site=native.compile,fails=1;"
        "site=overlay.*,mode=degrade,rate=1.0,factor=8")
    assert plan.seed == 7
    assert len(plan.rules) == 3
    assert plan.rules[0].pattern == "checkpoint.*"
    assert plan.rules[0].rate == 0.5
    assert plan.rules[1].fails == 1
    assert plan.rules[2].mode == "degrade"
    assert plan.rules[2].factor == 8


@pytest.mark.parametrize("bad", [
    "site=x,mode=explode",            # unknown mode
    "site=x,error=Nope",              # unknown error type
    "rate=0.5",                       # clause without site=
    "site=x,whatever",                # item without key=value
])
def test_spec_rejects_bad_clauses(bad):
    with pytest.raises(ValueError):
        FaultPlan.from_spec(bad)
    with pytest.raises(ValueError):
        jfaults.FaultPlan.from_spec(bad)


def test_fails_n_then_recovers(fault_plan):
    plan = fault_plan("seed=1;site=x.y,fails=2")
    for _ in range(2):
        with pytest.raises(OSError) as ei:
            faults.maybe_fail("x.y")
        assert isinstance(ei.value, InjectedFault)
    faults.maybe_fail("x.y")          # third call passes
    assert [s for s, _, _ in plan.injected] == ["x.y", "x.y"]


def test_rate_decisions_deterministic():
    spec = "seed=3;site=s,rate=0.5,error=ValueError"
    hits = []
    for _ in range(2):
        plan = FaultPlan.from_spec(spec)
        h = []
        for i in range(64):
            try:
                plan.maybe_fail("s")
                h.append(False)
            except ValueError:
                h.append(True)
        hits.append(h)
    assert hits[0] == hits[1]
    assert any(hits[0]) and not all(hits[0])


def test_site_pattern_scoping(fault_plan):
    fault_plan("seed=1;site=checkpoint.*,fails=1")
    faults.maybe_fail("native.compile")          # unmatched site: no-op
    with pytest.raises(OSError):
        faults.maybe_fail("checkpoint.write")


def test_corrupt_truncate_deterministic():
    spec = "seed=5;site=c,rate=1.0,mode=truncate"
    data = bytes(range(64))
    out = [FaultPlan.from_spec(spec).corrupt("c", data)
           for _ in range(2)]
    assert out[0] == out[1]
    assert len(out[0]) < len(data)


def test_corrupt_flip_changes_one_byte(fault_plan):
    plan = fault_plan("seed=5;site=c,rate=1.0,mode=flip")
    data = bytes(range(64))
    out = plan.corrupt("c", data)
    assert len(out) == len(data)
    assert sum(a != b for a, b in zip(out, data)) == 1


def test_degrade_shrinks_capacity(fault_plan):
    fault_plan("seed=2;site=overlay.*,mode=degrade,rate=1.0,factor=4")
    assert faults.degrade("overlay.bucket_cap", 100) == 25
    assert faults.degrade("overlay.dup_cap", 2) == 1    # floor of 1
    assert faults.degrade("other.site", 100) == 100


def test_disarmed_probes_are_noops(no_faults):
    assert faults.active() is None
    faults.maybe_fail("anything")
    assert faults.corrupt("anything", b"abc") == b"abc"
    assert faults.degrade("anything", 7) == 7
    assert faults.stall("anything") == 0.0


# ---------------------------------------------------- parity with the JAX

SITES = ("checkpoint.write", "checkpoint.read", "gtiff.read_strip",
         "store.shard", "overlay.bucket_cap", "native.cdll",
         "pipeline.fetch", "pipeline.chunk")

PARITY_SPECS = [
    "seed=1234;site=checkpoint.*,rate=0.3,error=OSError;"
    "site=native.*,fails=2",
    "seed=9;site=checkpoint.*,rate=0.5,error=ValueError;"
    "site=pipeline.*,rate=0.5,error=ValueError;"
    "site=native.*,rate=0.5,error=ValueError",
    "seed=21;site=gtiff.read_strip,rate=0.4,mode=truncate;"
    "site=store.shard,rate=0.4,mode=flip",
    "seed=35;site=overlay.*,mode=degrade,rate=0.6,factor=3",
    "seed=77;site=pipeline.chunk,mode=delay,rate=0.5,delay_ms=0.01;"
    "site=pipeline.fetch,rate=0.25,error=TimeoutError",
]


def _drive(mod, rng_seed: int):
    """A seeded sequence of probes through one package's module API;
    returns every probe's outcome."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(200):
        site = SITES[int(rng.integers(len(SITES)))]
        kind = int(rng.integers(4))
        if kind == 0:
            try:
                mod.maybe_fail(site)
                out.append(("ok",))
            except Exception as e:
                out.append((type(e).__mro__[1].__name__, str(e)))
        elif kind == 1:
            data = rng.integers(0, 256, int(rng.integers(1, 64)),
                                dtype=np.uint8).tobytes()
            out.append(("bytes", mod.corrupt(site, data)))
        elif kind == 2:
            out.append(("cap", mod.degrade(site,
                                           int(rng.integers(1, 10_000)))))
        else:
            out.append(("stall", mod.stall(site)))
    return out


@pytest.mark.parametrize("spec", PARITY_SPECS)
def test_same_spec_injects_alike_in_both_packages(spec, both_disarmed):
    jplan, tplan = jfaults.arm(spec), faults.arm(spec)
    assert _drive(faults, 5) == _drive(jfaults, 5)
    assert tplan.injected == jplan.injected
    assert tplan.injected      # every spec here fires somewhere


@pytest.mark.parametrize("mode", ["truncate", "flip"])
def test_corrupt_bytes_equal_byte_for_byte(mode):
    spec = f"seed=13;site=s.*,rate=1.0,mode={mode}"
    jp, tp = jfaults.FaultPlan.from_spec(spec), FaultPlan.from_spec(spec)
    rng = np.random.default_rng(3)
    for n in (1, 2, 17, 512, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tp.corrupt("s.a", data) == jp.corrupt("s.a", data)


@pytest.mark.parametrize("policy,seed", [
    ("checkpoint", 0), ("checkpoint", 31), ("native.compile", 7),
    ("native.load", 7), ("serve.spawn", 5), ("fleet.respawn", 0),
    ("loadtest.connect", 3)])
def test_retry_delays_equal_for_a_seed(policy, seed):
    from mosaic_tpu.resilience import retry as jretry
    from mosaic_tpu_torch.resilience import retry as tretry
    mine = {"checkpoint": CHECKPOINT_RETRY,
            "native.compile": NATIVE_COMPILE_RETRY,
            "native.load": NATIVE_LOAD_RETRY,
            "serve.spawn": tretry.SERVE_SPAWN_RETRY,
            "fleet.respawn": tretry.FLEET_RESPAWN_BACKOFF,
            "loadtest.connect": tretry.LOADTEST_CONNECT_RETRY}[policy]
    theirs = {"checkpoint": jretry.CHECKPOINT_RETRY,
              "native.compile": jretry.NATIVE_COMPILE_RETRY,
              "native.load": jretry.NATIVE_LOAD_RETRY,
              "serve.spawn": jretry.SERVE_SPAWN_RETRY,
              "fleet.respawn": jretry.FLEET_RESPAWN_BACKOFF,
              "loadtest.connect": jretry.LOADTEST_CONNECT_RETRY}[policy]
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for a in range(6):
        assert mine.delay(a, seed=seed) == theirs.delay(a, seed=seed)
    pol = RetryPolicy(name="p", base_delay_s=0.05, jitter=0.4)
    jpol = JRetryPolicy(name="p", base_delay_s=0.05, jitter=0.4)
    assert [pol.delay(a, seed=seed) for a in range(8)] == \
        [jpol.delay(a, seed=seed) for a in range(8)]


def test_retry_delay_seed_comes_from_the_armed_plan(both_disarmed):
    pol = RetryPolicy(name="armed", base_delay_s=0.1, jitter=0.25)
    jpol = JRetryPolicy(name="armed", base_delay_s=0.1, jitter=0.25)
    unarmed = pol.delay(2)
    assert unarmed == jpol.delay(2) == pol.delay(2, seed=0)
    faults.arm("seed=99")
    jfaults.arm("seed=99")
    assert pol.delay(2) == jpol.delay(2) == pol.delay(2, seed=99)
    assert pol.delay(2) != unarmed


# ----------------------------------------------------------- retry policy

def test_retry_recovers_after_transient(fault_plan):
    plan = fault_plan("seed=1;site=r.t,fails=2")
    pol = RetryPolicy(name="t", max_attempts=3, base_delay_s=0.001,
                      jitter=0.0, retry_on=(OSError,))
    delays = []

    def fn():
        faults.maybe_fail("r.t")
        return 42

    assert pol.call(fn, sleep=delays.append) == 42
    assert delays == [0.001, 0.002]   # exponential, jitter off
    assert len(plan.injected) == 2


def test_retry_gives_up_and_reraises(fault_plan):
    fault_plan("seed=1;site=r.g,fails=9")
    pol = RetryPolicy(name="g", max_attempts=3, base_delay_s=0.0,
                      jitter=0.0)
    calls = []

    def fn():
        calls.append(1)
        faults.maybe_fail("r.g")

    with pytest.raises(OSError) as ei:
        pol.call(fn, sleep=lambda d: None)
    assert isinstance(ei.value, InjectedFault)
    assert len(calls) == 3


def test_retry_allowlist_passes_other_exceptions_through():
    pol = RetryPolicy(name="a", max_attempts=5, retry_on=(OSError,))
    calls = []

    def fn():
        calls.append(1)
        raise KeyError("not retryable")

    with pytest.raises(KeyError):
        pol.call(fn, sleep=lambda d: None)
    assert len(calls) == 1            # no retries for unlisted types


def test_retry_jitter_is_deterministic():
    pol = RetryPolicy(name="j", base_delay_s=0.1, jitter=0.25)
    assert pol.delay(1, seed=5) == pol.delay(1, seed=5)
    lo, hi = 0.2 * 0.75, 0.2 * 1.25
    assert lo <= pol.delay(1, seed=5) <= hi


def test_retry_on_retry_hook_and_counters(fault_plan):
    fault_plan("seed=1;site=r.h,fails=1")
    pol = RetryPolicy(name="hooked", max_attempts=2, base_delay_s=0.0,
                      jitter=0.0)
    seen = []
    was = metrics.enabled
    metrics.enable()
    try:
        base_a = metrics.counter_value("retry/attempts/hooked")
        base_r = metrics.counter_value("retry/recovered/hooked")

        def fn():
            faults.maybe_fail("r.h")
            return "ok"

        out = pol.call(fn, on_retry=lambda e, a: seen.append((e, a)),
                       sleep=lambda d: None)
        assert out == "ok"
        assert len(seen) == 1 and seen[0][1] == 0
        assert metrics.counter_value("retry/attempts/hooked") \
            == base_a + 1
        assert metrics.counter_value("retry/recovered/hooked") \
            == base_r + 1
    finally:
        if not was:
            metrics.disable()


# ------------------------------------------------- degrade-not-die sinks

def test_decode_guard_locates_raw_errors():
    with pytest.raises(ValueError) as ei:
        with decode_guard(path="f.tif", feature="strip 3", offset=128):
            struct.unpack(">i", b"\x00")
    e = ei.value
    assert isinstance(e, CodecError)
    msg = str(e)
    assert "f.tif" in msg and "strip 3" in msg
    assert "byte offset 128" in msg and "error" in msg
    rec = e.record()
    assert rec.offset == 128 and rec.feature == "strip 3"


def test_decode_guard_passes_codec_errors_through():
    inner = CodecError("boom", path="a", feature="b", offset=1)
    with pytest.raises(CodecError) as ei:
        with decode_guard(path="other"):
            raise inner
    assert ei.value is inner


def test_error_sink_raise_mode_reraises():
    sink = ErrorSink("raise", driver="t")
    with pytest.raises(ValueError):
        sink.handle(ValueError("bad"))
    assert sink.dropped() == 0


def test_error_sink_skip_mode_records():
    sink = ErrorSink("skip", driver="t", path="p.bin")
    sink.handle(ValueError("bad"), feature="record 3", offset=9)
    sink.handle(CodecError("worse", feature="record 5", offset=11))
    assert sink.dropped() == 2
    assert sink.records[0].path == "p.bin"
    assert sink.records[0].feature == "record 3"
    assert sink.records[1].path == "p.bin"     # backfilled from sink
    out = []
    sink.export(out)
    assert len(out) == 2


def test_error_sink_counts_dropped_records():
    was = metrics.enabled
    metrics.enable()
    try:
        base = metrics.counter_value("io/records_dropped")
        base_d = metrics.counter_value("io/records_dropped/gtiff")
        sink = ErrorSink("null", driver="gtiff")
        sink.handle(ValueError("bad"), feature="strip 0")
        sink.handle(ValueError("bad"), feature="strip 2")
        assert metrics.counter_value("io/records_dropped") == base + 2
        assert metrics.counter_value("io/records_dropped/gtiff") == \
            base_d + 2
    finally:
        if not was:
            metrics.disable()


def test_error_sink_rejects_unknown_mode():
    with pytest.raises(ValueError, match="on_error"):
        ErrorSink("explode")


def test_error_sink_default_comes_from_config():
    prev = _config.default_config()
    try:
        _config.set_default_config(
            dataclasses.replace(prev, io_on_error="skip"))
        assert ErrorSink().on_error == "skip"
    finally:
        _config.set_default_config(prev)
    assert ErrorSink().on_error == "raise"


# ------------------------------------------------------ config satellites

def test_blocksize_error_names_key():
    for bad in ("not-an-int", "-4"):
        with pytest.raises(_config.ConfigError,
                           match="mosaic.raster.blocksize"):
            _config.apply_conf(_config.MosaicConfig(),
                               "mosaic.raster.blocksize", bad)


def test_io_on_error_conf():
    cfg = _config.apply_conf(_config.MosaicConfig(),
                             "mosaic.io.on.error", "skip")
    assert cfg.io_on_error == "skip"
    with pytest.raises(_config.ConfigError, match="mosaic.io.on.error"):
        _config.apply_conf(_config.MosaicConfig(), "mosaic.io.on.error",
                           "maybe")


def test_unknown_keys_are_strict():
    with pytest.raises(_config.ConfigError, match="unknown conf key"):
        _config.apply_conf(_config.MosaicConfig(),
                           "mosaic.raster.blocksized", "128")


def test_obs_conf_keys_turn_instruments_on():
    from mosaic_tpu_torch.obs import tracer
    prev = _config.default_config()
    was_t, was_m = tracer.enabled, metrics.enabled
    try:
        tracer.disable()
        metrics.disable()
        cfg = _config.apply_conf(prev, "mosaic.metrics.enabled", "true")
        _config.set_default_config(cfg)
        assert metrics.enabled and not tracer.enabled
        _config.set_default_config(_config.apply_conf(
            cfg, "mosaic.trace.enabled", "true"))
        assert tracer.enabled
        # conf keys only ever turn instruments on
        _config.set_default_config(prev)
        assert tracer.enabled and metrics.enabled
    finally:
        _config.set_default_config(prev)
        tracer.enable() if was_t else tracer.disable()
        metrics.enable() if was_m else metrics.disable()


# --------------------------------------------- fixture restore semantics

def test_fault_plan_fixture_restores_previous(fault_plan):
    outer = faults.arm("seed=11;site=outer,fails=1")
    try:
        prev = faults.active()
        assert prev is outer
        # nested arm via the fixture's callable replaces...
        fault_plan("seed=12;site=inner,fails=1")
        assert faults.active() is not outer
    finally:
        faults.disarm()


def test_port_fixture_arms_only_the_port(fault_plan):
    """The port's fixture shadows the JAX package's in this module and
    arms the port's plan alone."""
    before = jfaults.active()
    plan = fault_plan("seed=3;site=only.port,fails=1")
    assert faults.active() is plan
    assert jfaults.active() is before
