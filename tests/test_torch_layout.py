"""The port's layout advisor (``sql/layout.py``) against the JAX package's,
on the CPU, at tests/test_layout.py's sizes.

* ``advise_layout`` gives JAX's advice (``grid_res``, ``shard_rows``,
  ``reason``, ``evidence``) under the same heat and conf: no evidence,
  the resolution clamps and pow2 rounding, a skewed heat plane, an
  existing store's manifest, and explicit overrides (exact).
* ``StoreWriter(grid_res="auto")`` resolves through the port's advisor.
* ``rewrite_store`` re-buckets with its read-back multiset proof,
  NaN payloads and -0.0 included, into files byte-equal to JAX's
  ``rewrite_store`` of the same source.
* ``history_dir`` raises ``NotImplementedError`` (the history plane waits
  for ROADMAP §A9); the new conf keys are registered and validated.
"""

import filecmp

import numpy as np
import pytest

from mosaic_tpu import config as jconfig
from mosaic_tpu.obs.heat import heat as jheat
from mosaic_tpu.sql import layout as jlayout
from mosaic_tpu.store import ChipStore as JChipStore
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.obs.heat import heat
from mosaic_tpu_torch.sql.layout import (LayoutAdvice, _canonical_rows,
                                         advise_layout, rewrite_store)
from mosaic_tpu_torch.store import ChipStore, StoreWriter, write_store


@pytest.fixture(autouse=True)
def clean_state():
    """Both configs snapshotted and restored (heat half-life pinned to no
    decay), both heat planes reset."""
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    _set("mosaic.heat.halflife.ms", "0")
    heat.reset()
    jheat.reset()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)
    heat.reset()
    jheat.reset()


def _set(key, val):
    for m in (jconfig, tconfig):
        m.set_default_config(m.apply_conf(m.default_config(), key, val))


def _touch(cell, rows):
    for h in (heat, jheat):
        h.touch(cell, rows=rows)


def _same(**kw):
    mine = advise_layout(record=False, **kw)
    theirs = jlayout.advise_layout(record=False, **kw)
    assert isinstance(mine, LayoutAdvice)
    assert (mine.grid_res, mine.shard_rows, mine.reason, mine.evidence) == \
        (theirs.grid_res, theirs.shard_rows, theirs.reason,
         theirs.evidence), kw
    return mine


def test_no_evidence_is_the_configured_default():
    adv = _same()
    assert adv.grid_res == tconfig.default_config().store_grid_res
    assert adv.reason.startswith("no evidence")


@pytest.mark.parametrize("rows", [10, 1 << 22, 1 << 26, 1 << 40])
def test_clamps_and_pow2(rows):
    _set("mosaic.layout.min.res", "128")
    _set("mosaic.layout.max.res", "512")
    adv = _same(total_rows=rows)
    assert 128 <= adv.grid_res <= 512
    assert adv.grid_res & (adv.grid_res - 1) == 0
    assert adv.grid_res == {10: 128, 1 << 40: 512}.get(rows, adv.grid_res)


@pytest.mark.parametrize("conf", [
    {}, {"mosaic.layout.rows.per.cell": "1000"},
    {"mosaic.stream.chunk.rows": "100000",
     "mosaic.store.shard.rows": "3000000"},
    {"mosaic.store.shard.rows": "1000", "mosaic.store.grid.res": "256"}])
def test_skew_concentrates_the_grid(conf):
    for k, v in conf.items():
        _set(k, v)
    uniform = _same(total_rows=1 << 26)
    _touch(1, 1_000_000)
    for c in range(2, 10):
        _touch(c, 100)
    skewed = _same(total_rows=1 << 26)
    assert skewed.evidence["heat"]["skew"] > 2.0
    assert skewed.grid_res >= uniform.grid_res
    # heat alone stands in for the row count
    _same()
    _same(partitions=40, current_res=512)


def test_advice_from_a_store_manifest(tmp_path):
    rng = np.random.default_rng(6)
    write_store(str(tmp_path), rng.normal(0, 5, size=(10_000, 2)),
                grid_res=64)
    adv = _same(store_root=str(tmp_path))
    assert adv.evidence["manifest"]["total_rows"] == 10_000
    _same(store_root=str(tmp_path), total_rows=1 << 24, partitions=9)
    _touch(5, 400)
    _same(store_root=str(tmp_path), current_res=32)


def test_history_dir_waits_for_the_history_plane(tmp_path):
    with pytest.raises(NotImplementedError, match="§A9"):
        advise_layout(history_dir=str(tmp_path))


def test_writer_auto_resolves_through_the_advisor(tmp_path):
    w = StoreWriter(str(tmp_path / "auto"), grid_res="auto")
    adv = advise_layout()
    assert (w.grid_res, w.shard_rows) == (adv.grid_res, adv.shard_rows) == \
        (tconfig.default_config().store_grid_res, adv.shard_rows)
    _touch(3, 1 << 30)
    w2 = StoreWriter(str(tmp_path / "hot"), grid_res="auto", shard_rows=77)
    assert w2.grid_res == advise_layout().grid_res != w.grid_res
    assert w2.shard_rows == 77
    with pytest.raises(ValueError):
        StoreWriter(str(tmp_path / "bad"), grid_res="bogus")


def test_rewrite_store_roundtrip_bit_parity(tmp_path):
    rng = np.random.default_rng(4)
    n = 20_000
    pts = rng.normal(0.0, 10.0, size=(n, 2))
    v = rng.normal(size=n)
    v[:7] = np.nan
    v[7] = -0.0
    cols = {"v": v, "k": rng.integers(0, 99, n).astype(np.int32)}
    src = str(tmp_path / "src")
    write_store(src, pts, cols, grid_res=32)
    was = metrics.enabled
    metrics.enable()
    try:
        r0 = metrics.counter_value("layout/rows_rewritten")
        man, adv = rewrite_store(src, str(tmp_path / "dst"), grid_res=256)
        assert metrics.counter_value("layout/rows_rewritten") - r0 == n
    finally:
        if not was:
            metrics.disable()
    assert man.grid_res == 256 and man.total_rows == n
    assert isinstance(adv, LayoutAdvice)
    a = ChipStore(src).read_columns()
    b = ChipStore(str(tmp_path / "dst")).read_columns()
    assert np.array_equal(_canonical_rows(a), _canonical_rows(b))
    assert np.array_equal(_canonical_rows(a), jlayout._canonical_rows(a))
    assert len(ChipStore(str(tmp_path / "dst")).partitions) != \
        len(ChipStore(src).partitions)
    # JAX's rewrite of the same source writes the same files
    jman, jadv = jlayout.rewrite_store(src, str(tmp_path / "jdst"),
                                       grid_res=256)
    assert jman.to_obj() == man.to_obj()
    files = sorted(str(p.relative_to(tmp_path / "jdst"))
                   for p in (tmp_path / "jdst").rglob("*") if p.is_file())
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jdst",
                                           tmp_path / "dst", files,
                                           shallow=False)
    assert mismatch == errors == [] and len(files) > 2


def test_rewrite_store_uses_source_advice(tmp_path):
    rng = np.random.default_rng(5)
    src = str(tmp_path / "s2")
    write_store(src, rng.uniform(-1.0, 1.0, size=(5_000, 2)), grid_res=64)
    man, adv = rewrite_store(src, str(tmp_path / "d2"))
    jadv = jlayout.advise_layout(store_root=src, record=False)
    assert man.grid_res == adv.grid_res == jadv.grid_res
    assert man.total_rows == 5_000
    assert np.array_equal(
        ChipStore(str(tmp_path / "d2")).read_columns()["x"],
        JChipStore(str(tmp_path / "d2")).read_columns()["x"])


def test_rewrite_proof_catches_a_lost_row(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    src = str(tmp_path / "s3")
    write_store(src, rng.uniform(-1.0, 1.0, size=(2_000, 2)), grid_res=16)
    real = StoreWriter.append

    def lossy(self, points, columns=None):
        return real(self, points[1:], columns)

    monkeypatch.setattr(StoreWriter, "append", lossy)
    with pytest.raises(AssertionError, match="parity proof failed"):
        rewrite_store(src, str(tmp_path / "d3"), grid_res=32)


@pytest.mark.parametrize("key,good,bad", [
    ("mosaic.store.dir", "/tmp/s", None),
    ("mosaic.store.grid.res", "2048", "0"),
    ("mosaic.store.shard.rows", "65536", "-1"),
    ("mosaic.store.mmap", "false", "maybe"),
    ("mosaic.heat.halflife.ms", "250.5", "-1"),
    ("mosaic.heat.prior", "true", "sometimes"),
    ("mosaic.layout.rows.per.cell", "4096", "0"),
    ("mosaic.layout.min.res", "128", "x"),
    ("mosaic.layout.max.res", "512", "0")])
def test_conf_keys_registered(key, good, bad):
    field = tconfig._CONF_FIELDS[key][0]
    mine = tconfig.apply_conf(tconfig.MosaicConfig(), key, good)
    theirs = jconfig.apply_conf(jconfig.MosaicConfig(), key, good)
    assert getattr(mine, field) == getattr(theirs, field)
    assert getattr(tconfig.MosaicConfig(), field) == \
        getattr(jconfig.MosaicConfig(), field)
    if bad is not None:
        with pytest.raises(tconfig.ConfigError):
            tconfig.apply_conf(tconfig.MosaicConfig(), key, bad)
