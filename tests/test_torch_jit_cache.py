"""The persistent kernel cache (``mosaic.jit.cache.dir``) on the CPU.

``perf.jit_cache.configure_persistent_cache`` resolves its directory as
the JAX package's does (argument, then ``MOSAIC_TPU_JIT_CACHE_DIR``, then
the config's ``jit_cache_dir``), records the same ``config`` event, and
points the hand kernels' build directory (``_kernels``) at it.  No kernel
builds here: the hit and miss counters are moved with a stub library that
``ctypes.CDLL`` never opens (it is replaced for the test), and a miss with
no ``nvcc`` still raises ``KernelError``.  The JAX side runs with
``jax.config.update`` replaced, so no XLA cache is wired in this process.
"""

import os
from pathlib import Path

import jax
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.obs.recorder import recorder as jrecorder
from mosaic_tpu.perf import jit_cache as jjc
from mosaic_tpu_torch import _kernels
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.functions.context import MosaicContext
from mosaic_tpu_torch.obs.recorder import recorder as trecorder
from mosaic_tpu_torch.perf import jit_cache as tjc
from mosaic_tpu_torch.serve import QueryServer
from mosaic_tpu_torch.sql import SQLSession

ENV = "MOSAIC_TPU_JIT_CACHE_DIR"


@pytest.fixture
def clean(monkeypatch):
    """Both packages' cache state, recorders and env restored; the JAX
    side's XLA settings captured instead of applied."""
    xla = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: xla.__setitem__(k, v))
    monkeypatch.setattr(jjc, "_persist_dir", None)
    monkeypatch.setattr(tjc, "_persist_dir", None)
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(_kernels, "_loaded", {})
    was = (jrecorder.enabled, trecorder.enabled)
    for r in (jrecorder, trecorder):
        r.reset()
        r.enable()
    _kernels.reset_cache_stats()
    yield xla
    _kernels.set_build_dir(None)
    _kernels.reset_cache_stats()
    for r, on in zip((jrecorder, trecorder), was):
        r.reset()
        if not on:
            r.disable()


def _configure_both(monkeypatch, tmp_path, source):
    """Run both packages' ``configure_persistent_cache`` with the three
    sources set so that ``source`` is the one that should win."""
    d = {s: str(tmp_path / s) for s in ("arg", "env", "conf")}
    arg = d["arg"] if source == "arg" else None
    if source in ("arg", "env"):
        monkeypatch.setenv(ENV, d["env"])
    if source in ("arg", "env", "conf"):
        for mod in (jconfig, tconfig):
            monkeypatch.setattr(mod, "_default_config", mod.MosaicConfig(
                jit_cache_dir=d["conf"]))
    return (jjc.configure_persistent_cache(arg),
            tjc.configure_persistent_cache(arg), d)


@pytest.mark.parametrize("source", ["arg", "env", "conf", "none"])
def test_resolution_order_and_event_as_jax(clean, monkeypatch, tmp_path,
                                           source):
    j, t, d = _configure_both(monkeypatch, tmp_path, source)
    assert t == j
    assert tjc.persistent_cache_dir() == jjc.persistent_cache_dir()
    tev = [(e["key"], e["value"]) for e in trecorder.events("config")]
    jev = [(e["key"], e["value"]) for e in jrecorder.events("config")]
    assert tev == jev
    if source == "none":
        assert t is None and tev == []
        assert _kernels.build_dir() == _kernels.BUILD_DIR
        assert clean == {}
    else:
        assert t == d[source]
        assert tev == [("mosaic.jit.cache.dir", d[source])]
        assert _kernels.build_dir() == Path(d[source])
        assert os.path.isdir(d[source])
        assert clean["jax_compilation_cache_dir"] == d[source]


def test_idempotent_and_last_call_wins(clean, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for path in (a, a, b):
        assert tjc.configure_persistent_cache(path) == \
            jjc.configure_persistent_cache(path) == path
    assert [e["value"] for e in trecorder.events("config")] == \
        [e["value"] for e in jrecorder.events("config")] == [a, b]
    assert _kernels.build_dir() == Path(b)


def test_conf_key_wires_the_cache_as_jax(clean, monkeypatch, tmp_path):
    """``set_default_config`` of a config with the key set wires the cache
    in both packages (``apply_conf`` alone does not)."""
    path = str(tmp_path / "kc")
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "_default_config", mod.MosaicConfig())
        cfg = mod.apply_conf(mod.MosaicConfig(), "mosaic.jit.cache.dir", path)
        assert cfg.jit_cache_dir == path
    assert tjc.persistent_cache_dir() is None
    for mod in (jconfig, tconfig):
        mod.set_default_config(mod.MosaicConfig(jit_cache_dir=path))
    assert tjc.persistent_cache_dir() == jjc.persistent_cache_dir() == path
    assert _kernels.lib_path("h3_cell").parent == Path(path)


@pytest.mark.parametrize("name", ["h3_cell", "knn_ring_step",
                                  "fused_group"])
def test_lib_path_under_configured_dir(clean, tmp_path, name):
    default = _kernels.lib_path(name)
    assert default.parent == _kernels.BUILD_DIR
    tjc.configure_persistent_cache(str(tmp_path))
    moved = _kernels.lib_path(name)
    # the same source-hash key, only the directory moves
    assert moved.parent == tmp_path and moved.name == default.name


def test_hit_and_miss_counters(clean, monkeypatch, tmp_path):
    opened = []
    monkeypatch.setattr(_kernels.ctypes, "CDLL",
                        lambda p: opened.append(p) or object())
    tjc.configure_persistent_cache(str(tmp_path))
    # a library another process built: a hit, no build
    stub = _kernels.lib_path("h3_cell")
    stub.write_bytes(b"not a library")
    monkeypatch.setattr(_kernels, "build", lambda n: pytest.fail(
        "a hit must not build"))
    _kernels.load("h3_cell")
    _kernels.load("h3_cell")             # loaded already: not counted
    assert _kernels.cache_stats() == {"persistent_hits": 1,
                                      "persistent_misses": 0}
    # nothing there: a miss that builds (here a stand-in for nvcc)
    built = []
    monkeypatch.setattr(_kernels, "build", lambda n: built.append(n) or
                        _kernels.lib_path(n).write_bytes(b"stub") or 0.0)
    _kernels.load("knn_ring_step")
    assert built == ["knn_ring_step"]
    assert _kernels.cache_stats() == {"persistent_hits": 1,
                                      "persistent_misses": 1}
    assert opened == [str(stub), str(_kernels.lib_path("knn_ring_step"))]
    # the server's warm-fleet proof reads the same counters
    srv = QueryServer(SQLSession(MosaicContext(
        "CUSTOM(-180,180,-90,90,2,360,180)", device="cpu")), workers=1)
    assert srv.stats()["jit"] == {"persistent_hits": 1,
                                  "persistent_misses": 1}


def test_miss_without_nvcc_raises(clean, monkeypatch, tmp_path):
    """No fallback: a miss whose build fails raises KernelError, and is
    counted as a miss all the same."""
    def no_nvcc():
        raise _kernels.KernelError("nvcc not found")
    monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
    tjc.configure_persistent_cache(str(tmp_path))
    with pytest.raises(_kernels.KernelError, match="nvcc"):
        _kernels.load("h3_cell")
    assert _kernels.cache_stats() == {"persistent_hits": 0,
                                      "persistent_misses": 1}
    assert not _kernels.lib_path("h3_cell").exists()
    assert "h3_cell" not in _kernels._loaded
