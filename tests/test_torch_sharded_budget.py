"""The sharded streamed join under a memory budget: a gloo world of 4 CPU
ranks against the JAX package's 4-device mesh.

The ranks run ``tests/torch_sharded_worker.py``'s ``budget_cases``: the
dense flagship shape (taxi zones at H3 res 9, 5,000 seeded points,
2,048-row chunks) through ``make_sharded_streamed_pip_join`` under one
``mosaic.mem.budget.bytes`` whose pressure mark (0.5 of 1,000 bytes) sits
below one 64-row slot block's bytes on a device (64 x (8 staged + 5
fetched)), so every halving decision after the first chunk halves in
both packages, whatever the JAX package's fetch worker has released by
then; then the same join with no budget.  The parent runs the JAX
package's join on ``jax.devices()[:4]`` under the same settings.

* Each rank halves at the same boundaries as the JAX mesh, counts the
  same ``mem/chunk_shrink`` and records the same single
  ``mem_chunk_shrink`` event; its zones equal the JAX package's, the
  single-device streamed join's and ``pip_host_truth``.
* Unbudgeted, the stream takes no collective beyond the join's own: one
  ``all_gather`` a chunk and the one ``all_reduce`` of the rechecked
  count; budgeted, one ``all_reduce`` a halving decision more.
* The counterpart of ``tests/test_memwatch.py::test_sharded_join_books_balance``:
  every rank's books balance (nothing live, every registration
  released, no leak) with its staged blocks registered under
  ``pip_join/sharded/staged``, and so do the JAX package's.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from mosaic_tpu import config as jconfig
from mosaic_tpu.bench.workloads import build_workload as jbuild_workload
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.obs.memwatch import memwatch as jmw
from mosaic_tpu.obs.recorder import recorder as jrec
from mosaic_tpu.parallel import pip_join as jpj

from torch_sharded_worker import join_world, start_world

WORLD = 4
#: seconds the spawned world may take before it is killed
WORLD_TIMEOUT_S = 150
CHUNK = 2048
#: (budget bytes, pressure mark)
TIGHT = (1000, 0.5)


def _points():
    polys, _, _ = jbuild_workload(n_side=2, grid_name="H3")
    ext = polys.bboxes()
    rng = np.random.default_rng(5)
    return np.stack([rng.uniform(ext[:, 0].min(), ext[:, 2].max(), 5000),
                     rng.uniform(ext[:, 1].min(), ext[:, 3].max(), 5000)],
                    1)


def _jax_refs(pts) -> dict:
    polys, grid, res = jbuild_workload(n_side=2, grid_name="H3")
    idx = jpj.build_pip_index(polys, res, grid)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    seen = []
    real = jpj.stream

    def spy(chunks, compute, put=None, consume=None, **kw):
        def spied(i, sl, host):
            seen.append((sl.start, sl.stop))
            return consume(i, sl, host)
        return real(chunks, compute, put=put, consume=spied, **kw)

    prev = jconfig.default_config()
    was = jmetrics.enabled, jrec.enabled
    ref = {}
    jpj.stream = spy
    try:
        for tag, budget in (("tight", TIGHT), ("free", None)):
            cfg = prev
            if budget is not None:
                cfg = jconfig.apply_conf(cfg, "mosaic.mem.budget.bytes",
                                         str(budget[0]))
                cfg = jconfig.apply_conf(cfg, "mosaic.mem.pressure.high",
                                         str(budget[1]))
            jconfig.set_default_config(cfg)
            jmetrics.reset()
            jmetrics.enable()
            jrec.reset()
            jrec.enable()
            jmw.reset()
            seen.clear()
            run = jpj.make_sharded_streamed_pip_join(idx, grid, mesh,
                                                     polys=polys,
                                                     chunk=CHUNK)
            z, r = run(pts)
            t = jmw.snapshot()["totals"]
            ref[tag] = {
                "zone": np.asarray(z), "rechecked": int(r),
                "slices": list(seen),
                "shrinks": jmetrics.counter_value("mem/chunk_shrink"),
                "events": [(e["site"], str(e["rows"]))
                           for e in jrec.events("mem_chunk_shrink")],
                "books": [t["live_bytes"], t["live_buffers"],
                          int(t["registered"] == t["released"]),
                          jmw.leak_count()],
                "staged_peak": jmw.snapshot()["site_peak_bytes"].get(
                    "pip_join/sharded/staged", 0)}
    finally:
        jpj.stream = real
        jconfig.set_default_config(prev)
        jmetrics.reset()
        if not was[0]:
            jmetrics.disable()
        jrec.reset()
        if not was[1]:
            jrec.disable()
        jmw.reset()
    ref["truth"] = jpj.pip_host_truth(pts, polys)
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(every rank's outputs, the JAX references)."""
    path = tmp_path_factory.mktemp("budget_world")
    pts = _points()
    np.savez(path / "inputs.npz", budget_pts=pts,
             budget_chunk=np.array(CHUNK),
             budget_tight=np.array(TIGHT, np.float64),
             cases=np.array(["budget_cases"]))
    procs = start_world(path, WORLD)
    try:
        ref = _jax_refs(pts)        # while the ranks work
    finally:
        codes = join_world(procs, WORLD_TIMEOUT_S)
    if codes != [0] * WORLD:
        errors = "\n".join(f.read_text()
                           for f in sorted(path.glob("error*.txt")))
        pytest.fail(f"rank exit codes {codes} (None: killed after "
                    f"{WORLD_TIMEOUT_S} s)\n{errors}")
    outs = [dict(np.load(path / f"out{r}.npz")) for r in range(WORLD)]
    return outs, ref


def _slices(o, tag):
    return [tuple(int(v) for v in row) for row in o[f"{tag}_slices"]]


def test_halves_at_the_jax_boundaries(world):
    outs, ref = world
    j = ref["tight"]
    assert j["shrinks"] > 0
    assert len(j["slices"]) > -(-5000 // CHUNK)
    assert j["events"] == [("pip_join/sharded", str(CHUNK))]
    for o in outs:
        assert _slices(o, "tight") == j["slices"]
        assert float(o["tight_shrinks"]) == j["shrinks"]
        assert [tuple(e) for e in o["tight_events"]] == j["events"]


@pytest.mark.parametrize("tag", ["tight", "free"])
def test_zones_equal_jax_and_the_single_device_join(world, tag):
    outs, ref = world
    for o in outs:
        assert np.array_equal(o[f"{tag}_zone"], ref[tag]["zone"])
        assert np.array_equal(o[f"{tag}_zone"], ref["truth"])
        assert np.array_equal(o[f"{tag}_zone"], outs[0]["single_zone"])
        assert int(o[f"{tag}_rechecked"]) == ref[tag]["rechecked"]


def test_disarmed_stream_takes_no_extra_collective(world):
    outs, ref = world
    chunks = [(s, min(s + CHUNK, 5000)) for s in range(0, 5000, CHUNK)]
    assert ref["free"]["slices"] == chunks and ref["free"]["shrinks"] == 0
    for o in outs:
        assert _slices(o, "free") == chunks
        assert float(o["free_shrinks"]) == 0
        assert int(o["free_all_gather"]) == len(chunks)
        assert int(o["free_all_reduce"]) == 1
        # budgeted: one agreement a halving decision, the same count on
        # every rank (a decision is taken for every slice above 64 rows)
        n = len(_slices(o, "tight"))
        assert int(o["tight_all_gather"]) == n
        assert int(o["tight_all_reduce"]) > 1
        assert int(o["tight_all_reduce"]) == \
            int(outs[0]["tight_all_reduce"])


@pytest.mark.parametrize("tag", ["tight", "free"])
def test_sharded_join_books_balance(world, tag):
    outs, ref = world
    assert ref[tag]["books"] == [0, 0, 1, 0]
    assert ref[tag]["staged_peak"] > 0
    for o in outs:
        assert o[f"{tag}_books"].tolist() == [0, 0, 1, 0]
        assert int(o[f"{tag}_staged_peak"]) > 0


@pytest.mark.parametrize("budget", [0, 1000])
def test_agreement_asked_only_under_a_budget(budget):
    """``stream``'s ``agree`` hook, one process: with no budget it is
    never asked (the disarmed path takes no collective); under one it is
    asked at each halving decision, and its answer, not the rank's own
    flag, decides."""
    import torch
    from mosaic_tpu_torch import config
    from mosaic_tpu_torch.obs.memwatch import memwatch
    from mosaic_tpu_torch.perf.pipeline import chunk_rows, stream
    prev = config.default_config()
    asked, seen = [], []
    cfg = prev
    for k, v in (("mosaic.mem.budget.bytes", str(budget)),
                 ("mosaic.mem.pressure.high", "0.5")):
        cfg = config.apply_conf(cfg, k, v)
    config.set_default_config(cfg)
    memwatch.reset()
    data = np.arange(4096, dtype=np.float64)

    def agree(flag):
        asked.append(flag)
        return True            # the group says halve, whatever this rank saw

    def stage(sl, buf):
        buf[:, 0] = data[sl]

    try:
        stream(chunk_rows(len(data), 1024), stage, 1,
               lambda i, x: (x[:, 0] * 2.0,),
               lambda i, sl, host: seen.append((sl.start, sl.stop)),
               torch.device("cpu"), agree=agree)
    finally:
        config.set_default_config(prev)
        memwatch.reset()
    if budget == 0:
        assert asked == [] and seen == [(s, s + 1024)
                                         for s in range(0, 4096, 1024)]
    else:
        # every slice above 64 rows was put to the group, the first one
        # too (nothing live yet: this rank's own flag False), and halved:
        # each 1,024-row chunk in 15 halvings down to 16 slices of 64
        assert asked and not asked[0]
        assert all(e - s == 64 for s, e in seen) and len(seen) == 64
        assert len(asked) == 4 * 15
