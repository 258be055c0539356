"""The dense join kernel's work split (csrc/h3_dense_join.cu), modelled in
numpy on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it bit-equal
to ``dense_join_ref``.  Here a numpy model of how it splits the work is
held to the same answers:

* phase A: a thread projects ``kPoints`` points (the plain projection),
  tests the window and reads each entry; empty, far, out-of-window and
  core points, and border points whose group has no edge, are answered
  at once.  Each block of ``kThreads * kPoints`` points queues its other
  border points (the model takes the warps in order, where the card's
  shared atomicAdd takes them in any) and lays their edges end to end:
  point s owns the flat edges [off[s], off[s] + count), off rising with
  s, since one atomicAdd a warp hands out both;
* phase B: warp w walks the flat range [w * per, (w + 1) * per), per the
  flat edges over the warps rounded up to 32, 32 edges a step, lane l
  the step's edge l.  A lane's owner is the step's first owner plus the
  points that start in (f0, f0 + l], read as bits of one OR over the
  next 32 points' offsets.  A crossing left of the point flips bit
  zs - 32 w of its owner's word, and a flag sets its owner's; after the
  barrier a thread a queued point takes the first odd slot, and passes
  of 32 slots go on while a point has none and slots remain.

``kThreads`` and ``kPoints`` are read from the kernel's source.  The
model equals ``dense_join_ref`` bit for bit on the fixture's seeded and
adversarial points, with the flagship's slots, zone slots widened past
32 (``widen_zone_slots``) and pool edges widened past 32
(``widen_pool_edges``), and on another split of the points into blocks.
On the index the JAX package built, the model's flags are a superset of
the JAX join's (ROADMAP C6: the port also flags points beside a
straddling edge's line) and its zones equal the JAX join's wherever
neither flags.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu_torch.bench.workloads import (adversarial_points, nyc_points,
                                              widen_pool_edges,
                                              widen_zone_slots)
from mosaic_tpu_torch.ops import dense_join as dj
from mosaic_tpu_torch.ops.projection import project_lattice_ref
from mosaic_tpu_torch.parallel import pip_join as tpj
from test_torch_pip_join import flagship, one_torch_thread  # noqa: F401
from test_torch_pip_join import tables_of

SOURCE = Path(dj.__file__).resolve().parent.parent / "csrc" / \
    "h3_dense_join.cu"


def kernel_constant(name: str) -> int:
    text = SOURCE.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def phase_a(x, tables, consts, block):
    """(zone, uncertain, entry, queue): the answers phase A writes (queued
    points still -1 and their margin, face-gap or wide-group flag), and
    per block the points it queues, in queue order."""
    face, a, b, margin, gap = [t.numpy() for t in project_lattice_ref(
        x, consts.res, consts.origin)]
    pts = x.numpy()
    far = (np.abs(pts) > np.float32(consts.far_lim)).any(axis=1)
    ia, ib = a - consts.a0, b - consts.b0
    inw = ~far & (face == consts.face0) & (ia >= 0) & (ia < consts.W) & \
        (ib >= 0) & (ib < consts.H)
    entry = tables.entry.numpy()
    e = np.where(inw, entry[np.where(inw, ia * consts.H + ib, 0)], -1)
    core = (e >= 0) & ((e & dj.CORE_FLAG) != 0)
    border = (e >= 0) & ~core
    zone = np.where(core, e & ~dj.CORE_FLAG, -1).astype(np.int32)
    unc = ~far & ((margin < np.float32(consts.err32)) |
                  (gap < np.float32(consts.gap32)))
    g = np.where(border, e, 0)
    unc = unc | (border & tables.gwide.numpy()[g])
    queued = border & (tables.ecount.numpy()[g] > 0)
    n_blocks = -(-len(pts) // block)
    queue = [np.flatnonzero(queued[k * block:(k + 1) * block]) + k * block
             for k in range(n_blocks)]
    return zone, unc, e, queue


def owners(off, nf, warps):
    """The owner of each flat edge as phase B's warps find it: each warp's
    run from a search, then step by step by the OR of the next 32
    points' starts.  Also checks that the runs cover the flat edges
    once."""
    nq = len(off)
    per = (-(-nf // warps) + 31) // 32 * 32
    own = np.full(nf, -1, np.int64)
    for w in range(warps):
        f_begin, f_end = w * per, min(nf, (w + 1) * per)
        sb = int(np.searchsorted(off, f_begin, side="right")) - 1
        for f0 in range(f_begin, f_end, 32):
            nxt = sb + 1 + np.arange(32)
            d = np.where(nxt < nq, off[np.minimum(nxt, nq - 1)] - f0, 0)
            starts = np.zeros(33, bool)
            hit = (d >= 1) & (d <= 32)
            starts[d[hit]] = True
            lane = np.arange(32)
            mine = sb + np.concatenate([[0], np.cumsum(starts[1:32])])
            f = f0 + lane
            live = f < f_end
            assert (own[f[live]] == -1).all()
            own[f[live]] = mine[live]
            sb += int(starts[1:].sum())
    assert (own >= 0).all()
    return own


def walk(q, tables, consts, warps):
    """(zone, flag) of one block's queued points ``q``: their edges laid
    end to end and walked by the warps' runs, crossing bits XORed into a
    word a point, flags ORed."""
    edges, eslot = tables.edges.numpy(), tables.eslot.numpy()
    gz = tables.gzones.numpy()
    Z = int(gz.shape[1])
    eps = np.float32(consts.eps32)
    g = q["g"]
    cnt = tables.ecount.numpy()[g].astype(np.int64)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    nf = int(cnt.sum())
    s = owners(off, nf, warps)
    assert np.array_equal(s, np.repeat(np.arange(len(g)), cnt))
    j = np.arange(nf) - off[s]
    ed = edges[g[s], j]
    zs = eslot[g[s], j].astype(np.int64)
    px, py = q["px"][s], q["py"][s]
    ax, ay, bx, by = (ed[:, c] for c in range(4))
    flag = np.zeros(len(g), bool)
    near_v = (np.abs(py - ay) < eps) & (px < np.maximum(ax, bx) + eps)
    np.logical_or.at(flag, s, near_v)
    st = (ay <= py) != (by <= py)
    # only a straddling edge divides
    ss, px, py, zs = s[st], px[st], py[st], zs[st]
    ax, ay, bx, by = ax[st], ay[st], bx[st], by[st]
    dx, dy = bx - ax, by - ay
    xi = ax + ((py - ay) / dy) * dx
    cr = dx * (py - ay) - dy * (px - ax)
    near_c = (np.abs(px - xi) < eps) | \
        (cr * cr < (eps * eps) * (dx * dx + dy * dy))
    np.logical_or.at(flag, ss, near_c)
    zone = np.full(len(g), -1, np.int64)
    done = np.zeros(len(g), bool)
    for w in range(-(-Z // 32)):
        bit = zs - 32 * w
        hit = (px < xi) & (zs < Z) & (bit >= 0) & (bit < 32) & ~done[ss]
        word = np.zeros(len(g), np.uint32)
        np.bitwise_xor.at(word, ss[hit], np.left_shift(
            np.uint32(1), bit[hit].astype(np.uint32)))
        low = (word & (~word + np.uint32(1))).astype(np.uint64)
        first = np.log2(np.maximum(low, 1)).astype(np.int64)
        found = ~done & (word != 0)
        zone[found] = gz[g[found], 32 * w + first[found]]
        done |= found
        if done.all():
            break
    return zone, flag


def kernel_model(x, tables, consts, threads=None, points=None):
    """(zone, uncertain) as the kernel computes them, checking on the way
    that each block queues each of its border points with an edge once,
    within its kThreads * kPoints slots."""
    threads = kernel_constant("kThreads") if threads is None else threads
    points = kernel_constant("kPoints") if points is None else points
    block = threads * points
    zone, unc, e, queue = phase_a(x, tables, consts, block)
    pts = x.numpy()
    border = (e >= 0) & ((e & dj.CORE_FLAG) == 0)
    qi = np.concatenate(queue)
    assert np.array_equal(np.flatnonzero(border)[np.isin(
        np.flatnonzero(border), qi)], qi)
    for q in queue:
        if not len(q):
            continue
        assert len(q) <= block
        z, f = walk({"g": e[q].astype(np.int64), "px": pts[q, 0],
                     "py": pts[q, 1]}, tables, consts, threads // 32)
        zone[q] = z
        unc[q] |= f
    return zone, unc


def joined(idx):
    fn = tpj.make_pip_join_fn(idx)
    return fn.keywords["tables"], fn.keywords["consts"]


def fixture_points(flagship):  # noqa: F811
    tidx = flagship["tidx"]
    return np.concatenate([
        nyc_points(20_000, seed=13),
        adversarial_points(tidx.aux["flat_a"], tidx.aux["flat_b"],
                           flagship["tg"], flagship["res"], 200,
                           seed=5)[0]])


@pytest.mark.parametrize("slots", ["flagship", "over_32", "edges_over_32"])
def test_model_equals_dense_join_ref(flagship, slots):  # noqa: F811
    tidx = flagship["tidx"]
    tables = tables_of(tidx)
    if slots == "over_32":
        tables = widen_zone_slots(tables)
        assert tables["gzones"].shape[1] > 32
    if slots == "edges_over_32":
        tables = widen_pool_edges(tables)
        assert tables["pool"].shape[1] > 32
    idx = tpj.dense_index_from_arrays(tables, device="cpu")
    t, consts = joined(idx)
    x = torch.from_numpy(tpj.localize(idx, fixture_points(flagship)))
    zr, ur = dj.dense_join_ref(x, t, consts)
    zm, um = kernel_model(x, t, consts)
    assert np.array_equal(zm, zr.numpy()) and np.array_equal(um, ur.numpy())
    assert (zm >= 0).sum() > len(zm) // 2 and um.any()
    if slots == "edges_over_32":
        # a point's edges span more than one step of a warp
        assert int(t.ecount.max()) > 32


@pytest.mark.parametrize("split", [(256, 1), (64, 4)])
def test_model_block_splits_agree(flagship, split):  # noqa: F811
    """Other splits of the points into blocks and warps reduce to the same
    bits: XOR and OR do not depend on which warp, lane or step holds an
    edge, and the owners' search holds on every split."""
    threads, points = split
    idx = tpj.dense_index_from_arrays(widen_pool_edges(tables_of(
        flagship["tidx"])), device="cpu")
    t, consts = joined(idx)
    x = torch.from_numpy(tpj.localize(idx, fixture_points(flagship)))
    zr, ur = dj.dense_join_ref(x, t, consts)
    zm, um = kernel_model(x, t, consts, threads=threads, points=points)
    assert np.array_equal(zm, zr.numpy()) and np.array_equal(um, ur.numpy())


def test_model_against_jax_join(flagship):  # noqa: F811
    """The model on the index the JAX package built, against the JAX
    package's dense join on the CPU: flags a superset of the JAX join's
    (C6), zones equal where neither flags."""
    jidx = flagship["jidx"]
    pidx = tpj.dense_index_from_arrays(tables_of(jidx), device="cpu")
    t, consts = joined(pidx)
    pts64 = fixture_points(flagship)
    jfn = jax.jit(jpj.make_pip_join_fn(jidx, flagship["jg"]))
    jz, ju = [np.asarray(v) for v in jfn(jnp.asarray(
        jpj.localize(jidx, pts64)))]
    zm, um = kernel_model(torch.from_numpy(tpj.localize(pidx, pts64)), t,
                          consts)
    assert not (ju & ~um).any()
    sure = ~um & ~ju
    assert np.array_equal(zm[sure], jz[sure])
    assert sure.sum() > len(zm) // 2 and (um & ~ju).any()


def test_widen_pool_edges_keeps_parity(flagship):  # noqa: F811
    tables = tables_of(flagship["tidx"])
    for copies in (1, 3, -2):
        with pytest.raises(ValueError, match="even"):
            widen_pool_edges(tables, copies)
    wide = widen_pool_edges(tables, 4)
    assert wide["pool"].shape[1] == 5 * tables["pool"].shape[1]
    assert "aux" not in wide
    assert np.array_equal(wide["gzones"], tables["gzones"])
    same = widen_pool_edges(tables, 0)
    assert np.array_equal(same["pool"].view(np.int32),
                          np.asarray(tables["pool"]).view(np.int32))
