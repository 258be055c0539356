"""The port's chip store, WHERE pushdown, parser, heat plane and store-fed
join against the JAX package, on the CPU.

* Stores are interchangeable: a store written by either package reads
  bit-equal in the other, with equal manifests, and the two packages
  write byte-equal files from the same points (exact).
* The port's store on its own: multi-block ingest equals one shot, an
  unfinalized store is invisible, prune counts show in the port's
  ``metrics``.
* ``iter_chunks`` equals JAX's chunk by chunk (offset, points, spans),
  with and without a bbox; the bbox-pruning fuzz keeps every matching
  row and prunes the partitions JAX's prunes; a shard truncated on disk
  reads under ``raise``, ``skip`` and ``null`` as JAX reads it (exact).
* The parser's trees equal JAX's (class names and fields) on every
  literal query of tests/test_sql.py and tests/test_store.py, and its
  errors raise alike; ``bbox_from_where`` equals JAX's.
* The metrics registry's counters, gauges and histograms, and its
  environment switches, equal JAX's, and so do their
  ``to_openmetrics`` expositions.
* Heat: ``touch``, ``report`` and ``prior`` equal JAX's ``HeatTracker``
  (tests/test_history.py's cases); a scan feeds heat, a pruned partition
  stays cold.
* The store-fed join with ``group=None`` on a sorted CUSTOM workload and a
  dense H3 one: zones and ``rechecked`` equal to JAX's
  ``make_store_sharded_pip_join`` on a 4-device mesh (on the dense index
  ``rechecked`` at least JAX's, which flags fewer points, ROADMAP C6, and
  equal to the port's streamed join); the staging ledger
  equal to JAX's at the same world size (one device); one rebalancer
  observation a chunk; a bbox query stages nothing for a pruned cell and
  the ledger's sum is the staged ``pipeline/h2d_bytes``; a heat-primed
  run bit-equal to a cold one (exact).
* The lazy ``stream``: a list and an equal generator give the same
  consumed outputs; a generator needs its row bound.

Sizes are tests/test_store.py's; every torch call stays below 32,768
elements (ROADMAP C10).
"""

import ast
import dataclasses
import filecmp
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mosaic_tpu import config as jconfig
from mosaic_tpu.bench.workloads import build_workload as jbuild
from mosaic_tpu.obs.heat import HeatTracker as JHeatTracker
from mosaic_tpu.obs.heat import heat as jheat
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu.sql import parser as jparser
from mosaic_tpu.store import ChipStore as JChipStore
from mosaic_tpu.store import Manifest as JManifest
from mosaic_tpu.store import bbox_from_where as jbbox_from_where
from mosaic_tpu.store import write_store as jwrite_store
from mosaic_tpu.store import write_store_from_chunks as jwrite_from_chunks
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.bench.workloads import build_workload as tbuild
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.obs.heat import HeatTracker, heat
from mosaic_tpu_torch.parallel import pip_join as tpj
from mosaic_tpu_torch.perf.pipeline import chunk_rows, stream
from mosaic_tpu_torch.resilience.ingest import CodecError
from mosaic_tpu_torch.sql import parser as tparser
from mosaic_tpu_torch.store import (ChipStore, Manifest, StoreWriter,
                                    bbox_from_where, grid_cells,
                                    write_store, write_store_from_chunks)

RES = 4096
TESTS = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def clean_state():
    """Both packages' configs snapshotted and restored, both heat planes
    reset, one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    heat.reset()
    jheat.reset()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)
    heat.reset()
    jheat.reset()
    torch.set_num_threads(n)


def _set(key, val):
    for m in (jconfig, tconfig):
        m.set_default_config(m.apply_conf(m.default_config(), key, val))


def _pts(n, seed=0, lo=(-74.3, 40.5), hi=(-73.7, 40.95)):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(lo[0], hi[0], n),
                            rng.uniform(lo[1], hi[1], n)])


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


# ------------------------------------------------------------ interop

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reads_bit_equal_in_the_other_package(tmp_path, writer):
    pts = _pts(20_000, seed=1)
    w = np.random.default_rng(2).standard_normal(20_000)
    tag = np.arange(20_000, dtype=np.int64)
    write = jwrite_store if writer == "jax" else write_store
    write(str(tmp_path), pts, columns={"w": w, "tag": tag}, grid_res=RES,
          shard_rows=2048)
    mine, theirs = ChipStore(str(tmp_path)), JChipStore(str(tmp_path))
    a, b = mine.read_columns(), theirs.read_columns()
    assert list(a) == list(b) == ["x", "y", "w", "tag"]
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    order = np.argsort(grid_cells(pts[:, 0], pts[:, 1], RES), kind="stable")
    assert np.array_equal(a["tag"], tag[order])
    assert Manifest.load(str(tmp_path)).to_obj() == \
        JManifest.load(str(tmp_path)).to_obj()
    assert mine.nbytes() == theirs.nbytes() == 20_000 * 32


@pytest.mark.parametrize("blocks", [1, 7])
def test_both_packages_write_byte_equal_files(tmp_path, blocks):
    pts = _pts(9_000, seed=3)
    v = np.random.default_rng(4).integers(0, 9, 9_000).astype(np.int32)
    cuts = np.linspace(0, 9_000, blocks + 1).astype(int)
    items = [(pts[a:b], {"v": v[a:b]}) for a, b in zip(cuts, cuts[1:])]
    for write, name in ((jwrite_from_chunks, "j"),
                        (write_store_from_chunks, "t")):
        write(str(tmp_path / name), iter(items), grid_res=RES,
              shard_rows=1024)
    files = _files(tmp_path / "j")
    assert files == _files(tmp_path / "t") and "manifest.json" in files
    assert len(files) > 20
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "j", tmp_path / "t", files, shallow=False)
    assert mismatch == errors == [] and len(match) == len(files)


# ------------------------------------------------ the port's store alone

def test_multi_block_ingest_matches_one_shot(tmp_path):
    pts = _pts(9_000, seed=3)
    write_store(str(tmp_path / "one"), pts, grid_res=RES, shard_rows=1024)
    write_store_from_chunks(
        str(tmp_path / "many"),
        (pts[i:i + 1_000] for i in range(0, 9_000, 1_000)),
        grid_res=RES, shard_rows=1024)
    a = ChipStore(str(tmp_path / "one")).read_columns()
    b = ChipStore(str(tmp_path / "many")).read_columns()
    assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["y"], b["y"])


def test_unfinalized_store_is_invisible(tmp_path):
    w = StoreWriter(str(tmp_path), grid_res=RES)
    w.append(_pts(500, seed=5))
    with pytest.raises(CodecError, match="manifest"):
        ChipStore(str(tmp_path))
    w.finalize()
    assert ChipStore(str(tmp_path)).total_rows == 500
    with pytest.raises(ValueError, match="finalized"):
        w.append(_pts(5, seed=5))


def test_prune_counts_metrics(tmp_path):
    write_store(str(tmp_path), _pts(5_000, seed=8), grid_res=RES)
    st = ChipStore(str(tmp_path))
    was = metrics.enabled
    metrics.enable()
    try:
        p0 = metrics.counter_value("store/partitions_pruned")
        s0 = metrics.counter_value("store/partitions_scanned")
        scanned = st.prune((-74.0, 40.6, -73.9, 40.7))
        assert metrics.counter_value("store/partitions_scanned") - s0 == \
            len(scanned)
        assert metrics.counter_value("store/partitions_pruned") - p0 == \
            len(st.partitions) - len(scanned) > 0
    finally:
        if not was:
            metrics.disable()


# ------------------------------------------------ against the JAX reader

@pytest.mark.parametrize("bbox", [None, (-74.05, 40.6, -73.9, 40.75)])
@pytest.mark.parametrize("chunk", [512, 1500])
def test_iter_chunks_equals_jax(tmp_path, bbox, chunk):
    pts = _pts(10_000, seed=4)
    write_store(str(tmp_path), pts, grid_res=RES, shard_rows=512)
    mine = list(ChipStore(str(tmp_path)).iter_chunks(bbox=bbox,
                                                     chunk_rows=chunk))
    theirs = list(JChipStore(str(tmp_path)).iter_chunks(bbox=bbox,
                                                        chunk_rows=chunk))
    assert len(mine) == len(theirs) >= 2
    for a, b in zip(mine, theirs):
        assert a.offset == b.offset and a.parts == b.parts
        assert a.points.dtype == np.float64
        assert np.array_equal(a.points, b.points)
    assert sum(c.rows for c in mine) == \
        sum(p.rows for p in ChipStore(str(tmp_path)).prune(bbox,
                                                            record=False))


def test_bbox_pruning_never_drops_a_matching_row_fuzz(tmp_path):
    pts = _pts(30_000, seed=6)
    write_store(str(tmp_path), pts, grid_res=RES, shard_rows=4096)
    st, jst = ChipStore(str(tmp_path)), JChipStore(str(tmp_path))
    rng = np.random.default_rng(7)
    pruned_any = False
    for _ in range(25):
        x0, x1 = np.sort(rng.uniform(-74.35, -73.65, 2))
        y0, y1 = np.sort(rng.uniform(40.45, 41.0, 2))
        bbox = (x0, y0, x1, y1)
        scanned = st.prune(bbox, record=False)
        assert [dataclasses.astuple(p) for p in scanned] == \
            [dataclasses.astuple(p) for p in jst.prune(bbox, record=False)]
        pruned_any |= len(scanned) < len(st.partitions)
        cols = st.read_columns(bbox=bbox)
        ref = jst.read_columns(bbox=bbox)
        assert all(np.array_equal(cols[k], ref[k]) for k in ref)
        inside = ((cols["x"] >= x0) & (cols["x"] <= x1) &
                  (cols["y"] >= y0) & (cols["y"] <= y1))
        want = ((pts[:, 0] >= x0) & (pts[:, 0] <= x1) &
                (pts[:, 1] >= y0) & (pts[:, 1] <= y1))
        assert int(inside.sum()) == int(want.sum())
    assert pruned_any


def _torn_store(tmp_path):
    """tests/test_store.py's torn-shard store, a shard of its biggest
    partition cut mid-value on disk (x and w), its last shard deleted
    outright for a missing-file case."""
    pts = _pts(4_000, seed=13)
    w = np.random.default_rng(14).standard_normal(4_000)
    write_store(str(tmp_path), pts, columns={"w": w}, grid_res=64,
                shard_rows=512)
    man = Manifest.load(str(tmp_path))
    part = max(man.partitions, key=lambda p: p.rows)
    assert len(part.shards) > 2
    from mosaic_tpu_torch.store.manifest import shard_path
    for col, cut in (("x", 8 * 100 + 3), ("w", 8 * 300)):
        path = shard_path(str(tmp_path), part.cell, 1, col)
        with open(path, "r+b") as f:
            f.truncate(cut)
    return part


@pytest.mark.parametrize("mmap", [True, False])
@pytest.mark.parametrize("mode", ["raise", "skip", "null"])
def test_torn_shard_reads_as_jax_reads_it(tmp_path, mode, mmap):
    part = _torn_store(tmp_path)
    mine = ChipStore(str(tmp_path), on_error=mode, mmap=mmap)
    theirs = JChipStore(str(tmp_path), on_error=mode, mmap=mmap)
    if mode == "raise":
        with pytest.raises(CodecError, match="torn shard") as e:
            mine.read_columns()
        with pytest.raises(ValueError) as je:
            theirs.read_columns()
        assert str(e.value) == str(je.value)
        assert e.value.offset == je.value.offset == 8 * 100
        return
    was = metrics.enabled
    metrics.enable()
    try:
        t0 = metrics.counter_value("store/shards_torn")
        got = mine.read_columns()
        assert metrics.counter_value("store/shards_torn") - t0 == 2
    finally:
        if not was:
            metrics.disable()
    ref = theirs.read_columns()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    full = 4_000 if mode == "null" else 4_000 - (512 - 100)
    assert len(got["x"]) == full
    chunks = [c.points for c in mine.iter_chunks(chunk_rows=1024)]
    jchunks = [c.points for c in theirs.iter_chunks(chunk_rows=1024)]
    assert all(np.array_equal(a, b) for a, b in zip(chunks, jchunks))
    assert len(chunks) == len(jchunks)


def test_missing_shard_raises(tmp_path):
    part = _torn_store(tmp_path)
    from mosaic_tpu_torch.store.manifest import shard_path
    os.remove(shard_path(str(tmp_path), part.cell, 0, "y"))
    with pytest.raises(CodecError, match="shard file missing"):
        ChipStore(str(tmp_path), on_error="skip").read_columns()


# ------------------------------------------------- parser and pushdown

def _literal_queries():
    """Every literal string given to ``sql(...)``/``parse(...)`` in
    tests/test_sql.py and tests/test_store.py, and the store tests'
    pushdown queries."""
    out = []
    for name in ("test_sql.py", "test_store.py"):
        tree = ast.parse((TESTS / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    getattr(node.func, "attr",
                            getattr(node.func, "id", None)) in ("sql",
                                                                "parse"):
                out.append(node.args[0].value)
    return sorted(set(out))


QUERIES = _literal_queries()
PUSHDOWN = [
    "SELECT * FROM t WHERE x >= 1 AND x < 2 AND y > 3 AND y <= 4",
    "SELECT * FROM t WHERE 1 <= x AND y = -2",
    "SELECT * FROM t WHERE x > 1 OR y > 2",
    "SELECT * FROM t WHERE w > 9",
    "SELECT * FROM t WHERE x > y",
    "SELECT * FROM t",
    "SELECT * FROM t WHERE x >= -74.0 AND x <= -73.9 AND y >= 40.6 "
    "AND y <= 40.7",
    "SELECT * FROM t a WHERE a.x > 1 AND b.y < 2 AND y == 3 AND -x < 4",
    "SELECT * FROM t WHERE x > 1 AND (y > 2 OR y < 0) AND 5 >= y",
    "SELECT * FROM t WHERE x = TRUE AND y > 'a' AND y < --3",
]


def _tree(node):
    """A parse tree as (class name, fields), recursively."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,
                {f.name: _tree(getattr(node, f.name))
                 for f in dataclasses.fields(node)})
    if isinstance(node, (list, tuple)):
        return type(node).__name__, [_tree(v) for v in node]
    return node


def _parse(mod, sql):
    try:
        return _tree(mod.parse(sql))
    except mod.SQLParseError as e:
        return ("SQLParseError", str(e))


def test_parser_trees_equal_jax():
    assert len(QUERIES) > 40
    errors = 0
    for q in QUERIES + PUSHDOWN:
        mine, theirs = _parse(tparser, q), _parse(jparser, q)
        assert mine == theirs, q
        errors += mine[0] == "SQLParseError"
        if mine[0] != "SQLParseError":
            assert dataclasses.asdict(tparser.parse(q)) == \
                dataclasses.asdict(jparser.parse(q)), q
    assert errors >= 2               # test_sql.py's two parse errors


@pytest.mark.parametrize("sql", ["SELECT FROM t",
                                 "SELECT a FROM t WHERE ???",
                                 "SELECT a FROM", "SELECT a, FROM t",
                                 "SELECT a FROM t LIMIT x",
                                 "SELECT f(a FROM t"])
def test_parse_errors_raise(sql):
    with pytest.raises(tparser.SQLParseError) as e:
        tparser.parse(sql)
    with pytest.raises(jparser.SQLParseError) as je:
        jparser.parse(sql)
    assert str(e.value) == str(je.value)
    assert issubclass(tparser.SQLParseError, ValueError)


@pytest.mark.parametrize("qualifier", [None, "a", "t"])
def test_bbox_from_where_equals_jax(qualifier):
    for q in PUSHDOWN + QUERIES:
        try:
            jw = jparser.parse(q).where
        except jparser.SQLParseError:
            continue
        for cols in (("x", "y"), ("a", "b"), ("k", "v")):
            mine = bbox_from_where(tparser.parse(q).where, *cols,
                                   qualifier=qualifier)
            assert mine == jbbox_from_where(jw, *cols,
                                            qualifier=qualifier), (q, cols)
    bb = bbox_from_where(tparser.parse(PUSHDOWN[0]).where, "x", "y")
    assert bb == (1.0, 3.0, 2.0, 4.0)


# --------------------------------------------------------------- metrics

def test_metrics_registry_equals_jax(monkeypatch):
    from mosaic_tpu.obs.metrics import MetricsRegistry as JRegistry
    from mosaic_tpu_torch.obs.metrics import MetricsRegistry
    for env, on in (({}, False), ({"MOSAIC_TPU_METRICS": "1"}, True),
                    ({"MOSAIC_TPU_TRACE": "1"}, True)):
        for k in ("MOSAIC_TPU_METRICS", "MOSAIC_TPU_TRACE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert MetricsRegistry().enabled is on
        assert JRegistry().enabled is on
    monkeypatch.delenv("MOSAIC_TPU_TRACE")
    mine, theirs = MetricsRegistry(), JRegistry()
    rng = np.random.default_rng(12)
    for reg in (mine, theirs):
        reg.count("dropped")              # disabled: nothing recorded
        reg.enable()
    vals = rng.lognormal(-6, 3, 500)
    for reg in (mine, theirs):
        for i, v in enumerate(vals):
            reg.count("store/rows_scanned", float(i))
            reg.gauge("shard/skew", v)
            reg.gauge_max("hbm/peak", v)
            reg.observe("span/s", v)
            reg.observe("bytes", v * 1e9, scale=1.0)
        reg.observe("zero", 0.0)
    assert mine.report() == theirs.report()
    assert mine.full_snapshot() == theirs.full_snapshot()
    for q in (0, 1, 50, 95, 99, 100):
        assert mine.percentile("span/s", q) == theirs.percentile("span/s", q)
    assert mine.percentile("absent", 50) == 0.0
    assert mine.counter_value("dropped") == 0.0
    assert sorted(mine.histograms()) == ["bytes", "span/s", "zero"]
    mine.disable()
    mine.count("store/rows_scanned", 1e9)
    assert mine.counter_value("store/rows_scanned") == \
        theirs.counter_value("store/rows_scanned")
    assert mine.to_openmetrics() == theirs.to_openmetrics()
    mine.reset()
    assert mine.report() == {"counters": {}, "gauges": {}, "histograms": {}}


# ------------------------------------------------------------------ heat

def _heat_feed(ht, now):
    for _ in range(9):
        ht.touch(3, rows=100, nbytes=800, now=now)
    ht.touch(7, rows=10, nbytes=40, now=now)
    ht.touch(11, rows=0, nbytes=64, scans=0, now=now + 0.25)


@pytest.mark.parametrize("halflife", [0, 1_000.0])
def test_heat_equals_jax(halflife):
    mine, theirs = HeatTracker(halflife_ms=halflife), \
        JHeatTracker(halflife_ms=halflife)
    for ht in (mine, theirs):
        _heat_feed(ht, 1_000.0)
    rep = mine.report(now=1_000.25)
    assert [c["cell"] for c in rep["cells"]] == [3, 7, 11]
    assert rep["cells"][0]["bytes_per_row"] == 8.0 and rep["skew"] > 1.5
    for now in (1_000.25, 1_000.5, 1_001.0, 1_004.0):
        for top in (0, 1, 10):
            assert mine.report(top=top, now=now) == \
                theirs.report(top=top, now=now)
        centers = {3: (-73.95, 40.7), 7: (-74.2, 40.55), 11: (-73.8, 40.9),
                   99: (0.0, 0.0)}
        for nbins in (1, 4, 16):
            a = mine.prior(nbins, (-74.3, 40.5, -73.7, 40.95), centers,
                           now=now)
            b = theirs.prior(nbins, (-74.3, 40.5, -73.7, 40.95), centers,
                             now=now)
            assert np.array_equal(a, b)
        if halflife and now == 1_001.0:
            assert mine.report(now=now)["cells"][0]["rows"] == 450.0
    assert mine.prior(4, (0, 0, 1, 1), {5: (0.5, 0.5)}) is None
    mine.reset()
    assert mine.report()["tracked"] == 0


def test_heat_half_life_from_conf_and_touches_counted():
    _set("mosaic.heat.halflife.ms", "2000")
    mine, theirs = HeatTracker(), JHeatTracker()
    for ht in (mine, theirs):
        ht.touch(1, rows=64, now=10.0)
    assert mine.report(now=12.0) == theirs.report(now=12.0)
    assert mine.report(now=12.0)["cells"][0]["rows"] == 32.0
    was = metrics.enabled
    metrics.enable()
    try:
        t0 = metrics.counter_value("heat/touches")
        mine.touch(2, rows=1)
        assert metrics.counter_value("heat/touches") - t0 == 1
        assert metrics.gauge_value("heat/partitions_tracked") == 2
    finally:
        if not was:
            metrics.disable()


def test_store_scan_feeds_heat_and_pruned_stays_cold(tmp_path):
    _set("mosaic.heat.halflife.ms", "0")
    pts = _pts(8_000, seed=5)
    write_store(str(tmp_path), pts, grid_res=RES, shard_rows=1024)
    st, jst = ChipStore(str(tmp_path)), JChipStore(str(tmp_path))
    bbox = (-74.05, 40.6, -73.9, 40.75)
    scanned = {p.cell for p in st.prune(bbox, record=False)}
    pruned = {p.cell for p in st.partitions} - scanned
    assert scanned and pruned
    for s in (st, jst):
        for _ in s.iter_chunks(bbox=bbox, chunk_rows=1024):
            pass
    rep = heat.report(top=len(st.partitions))
    hot = {c["cell"] for c in rep["cells"]}
    assert hot == scanned and not (hot & pruned)
    assert rep == jheat.report(top=len(st.partitions))
    st.read_partition(st.partitions[0])
    assert heat.report(top=len(st.partitions))["total_rows"] == \
        rep["total_rows"] + st.partitions[0].rows


# ------------------------------------------------- the store-fed join

def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


@pytest.fixture(scope="module")
def workloads():
    """tests/test_store.py's sorted CUSTOM workload and a small dense H3
    one, each built by both packages."""
    out = {}
    for name, kw in (("custom", dict(n_side=6, res_cells=64)),
                     ("h3", dict(n_side=4, grid_name="H3"))):
        jpolys, jgrid, jres = jbuild(**kw)
        polys, grid, res = tbuild(**kw)
        idx = tpj.build_pip_index(polys, res, grid, device="cpu")
        out[name] = (polys, grid, idx, jpolys, jgrid,
                     jpj.build_pip_index(jpolys, jres, jgrid))
    assert type(out["custom"][2]).__name__ == "PIPIndex"
    assert type(out["h3"][2]).__name__ == "DensePIPIndex"
    return out


def _joins(st, jst, wl, bbox=None, chunk=4096, refresh=2):
    polys, grid, idx, jpolys, jgrid, jidx = wl
    run = tpj.make_store_sharded_pip_join(st, idx, grid, polys=polys,
                                          chunk=chunk, refresh=refresh,
                                          device="cpu")
    z, rc = run(bbox=bbox)
    ref = {}
    for n in (4, 1):
        jrun = jpj.make_store_sharded_pip_join(jst, jidx, jgrid, _mesh(n),
                                               polys=jpolys, chunk=chunk,
                                               refresh=refresh)
        jz, jrc = jrun(bbox=bbox)
        ref[n] = (np.asarray(jz), jrc, jrun.staged_bytes_by_partition)
    return run, z, rc, ref


@pytest.mark.parametrize("name", ["custom", "h3"])
@pytest.mark.parametrize("bbox", [None, (-74.05, 40.6, -73.9, 40.75)])
def test_store_fed_join_equals_jax(tmp_path, workloads, name, bbox):
    wl = workloads[name]
    pts = _pts(20_000, seed=11)
    write_store(str(tmp_path), pts, grid_res=RES, shard_rows=2048)
    st, jst = ChipStore(str(tmp_path)), JChipStore(str(tmp_path))
    was = metrics.enabled
    metrics.enable()
    try:
        h2d0 = metrics.counter_value("pipeline/h2d_bytes")
        run, z, rc, ref = _joins(st, jst, wl, bbox=bbox)
        h2d = metrics.counter_value("pipeline/h2d_bytes") - h2d0
    finally:
        if not was:
            metrics.disable()
    for n in (4, 1):
        assert np.array_equal(z, ref[n][0]), n
        # the dense join flags a superset of JAX's points (ROADMAP C6)
        assert rc == ref[n][1] if name == "custom" else rc >= ref[n][1], n
    ledger = run.staged_bytes_by_partition
    assert ledger == ref[1][2]
    scanned = st.prune(bbox, record=False)
    rows = sum(p.rows for p in scanned)
    assert len(z) == rows
    assert run.rebalancer.observations == -(-rows // 4096)
    assert sum(ledger.values()) == int(h2d) > 0
    cells = {p.cell for p in scanned}
    assert set(ledger) == cells
    if bbox is not None:
        assert cells < {p.cell for p in st.partitions}
    # the same rows through the single-device streamed join
    cols = st.read_columns(cols=st.point_cols, bbox=bbox)
    polys, grid, idx = wl[:3]
    want, nre = tpj.make_streamed_pip_join(idx, grid, polys, chunk=4096,
                                           device="cpu")(
        np.column_stack([cols["x"], cols["y"]]))
    assert np.array_equal(z, want) and rc == nre


def test_store_fed_join_heat_prior_is_a_pure_hint(tmp_path, workloads):
    _set("mosaic.heat.halflife.ms", "0")
    polys, grid, idx = workloads["custom"][:3]
    write_store(str(tmp_path), _pts(12_000, seed=6), grid_res=RES,
                shard_rows=2048)
    st = ChipStore(str(tmp_path))

    def once():
        run = tpj.make_store_sharded_pip_join(st, idx, grid, polys=polys,
                                              chunk=4096, device="cpu")
        return run, run()

    _, (z_cold, rc_cold) = once()       # also seeds the heat plane
    assert heat.report()["tracked"] == len(st.partitions)
    _set("mosaic.heat.prior", "true")
    was = metrics.enabled
    metrics.enable()
    try:
        p0 = metrics.counter_value("heat/prior_primes")
        run, (z_hot, rc_hot) = once()
        assert metrics.counter_value("heat/prior_primes") - p0 == 1
    finally:
        if not was:
            metrics.disable()
    assert run.rebalancer.rebalances >= 1
    assert np.array_equal(z_cold, z_hot) and rc_cold == rc_hot
    # the staged bytes were charged to the partitions' heat
    rep = heat.report(top=len(st.partitions))
    assert rep["total_bytes"] == 2 * sum(
        run.staged_bytes_by_partition.values())


def test_store_fed_join_on_an_empty_scan(tmp_path, workloads):
    polys, grid, idx = workloads["custom"][:3]
    write_store(str(tmp_path), _pts(3_000, seed=9), grid_res=RES)
    run = tpj.make_store_sharded_pip_join(ChipStore(str(tmp_path)), idx,
                                          grid, polys=polys, device="cpu")
    z, rc = run(bbox=(10.0, 10.0, 11.0, 11.0))
    assert z.dtype == np.int32 and len(z) == 0 and rc == 0
    assert run.staged_bytes_by_partition == {}


# ------------------------------------------------------- the lazy stream

def test_stream_list_and_generator_consume_alike():
    """A list of slices and an equal generator: the same consumed outputs
    in the same order; the generator needs its row bound."""
    data = np.random.default_rng(3).normal(size=(10_037, 2))

    def drive(chunks, **kw):
        got = []

        def stage(sl, out):
            out[...] = data[sl]

        def consume(i, sl, host):
            got.append((i, sl.start, sl.stop, host[0].copy()))

        stream(chunks, stage, 2, lambda i, x: (x.sum(1) * (i + 1),),
               consume, torch.device("cpu"), **kw)
        return got

    sl = chunk_rows(len(data), 4096)
    a, b = drive(sl), drive((s for s in sl), rows=4096)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x[:3] == y[:3] and np.array_equal(x[3], y[3])
    assert drive([]) == drive(iter([]), rows=8) == []
    with pytest.raises(ValueError, match="row bound"):
        drive(s for s in sl)
    with pytest.raises(ValueError, match="exceeds"):
        drive((s for s in sl), rows=2048)
