"""Dense H3 PIP join of the PyTorch port against the JAX package's.

* The port's DensePIPIndex tables are bit-equal to the JAX one's, built
  from the same workload (the JAX side on its numpy tessellation branches
  and with the df margin bound, the arithmetic the port runs).
* The very index the JAX package built, carried across with
  ``dense_index_from_arrays``, joins 50,000 NYC points: after the f64
  recheck both packages give the same zones, and both equal the exact
  oracle ``pip_host_truth``.
* The streamed join equals the one-shot join; the zone histogram equals
  ``np.bincount`` of the matched zones.
* Points placed on chip vertices, edge midpoints and a hair either side
  of chip and hex edges go through both packages' joins and rechecks:
  the port flags every point the JAX package flags (and those beside a
  straddling edge's line), the zones agree where neither flags, and the
  port's final zones equal the oracle on every point, where the JAX
  package's recheck still misses some; a dense index carried across
  from arrays rechecks only with its polygons.
* Beside a nearly horizontal zone edge far from the index origin the
  JAX join is certain and wrong on points within 1e-8 degrees of it
  (ROADMAP C6); the port flags them and ends equal to the oracle.
* ``dense_join_ref`` (the plain version of the fused CUDA join kernel)
  gives the join body it was moved from bit for bit, also on an index
  with more than 32 zone slots and on one with more than 32 pool edges a
  group; ``dense_join`` rejects what the kernel does not take and counts
  no launch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu.bench.workloads import build_workload as jbuild
from mosaic_tpu.bench.workloads import nyc_points as jnyc_points
from mosaic_tpu.core.geometry.wkt import read_wkt as jread_wkt
from mosaic_tpu.core.index.factory import get_index_system as \
    jget_index_system
from mosaic_tpu.parallel import pip_join as jpj
from mosaic_tpu_torch.bench.workloads import HAIRS_DEG, adversarial_points
from mosaic_tpu_torch.bench.workloads import build_workload as tbuild
from mosaic_tpu_torch.bench.workloads import (nyc_points, widen_pool_edges,
                                              widen_zone_slots)
from mosaic_tpu_torch.core.geometry.wkt import read_wkt
from mosaic_tpu_torch.core.index.factory import get_index_system
from mosaic_tpu_torch.ops import dense_join as dj
from mosaic_tpu_torch.ops.projection import (project_lattice,
                                             project_lattice_ref)
from mosaic_tpu_torch.parallel import pip_join as tpj

STATICS = ("face0", "a0", "b0", "W", "H", "res", "err_lattice", "n_zones",
           "ext_deg")

AUX = ("flat_a", "flat_b", "edge_zslot", "gstart", "gzones64")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tables_of(idx) -> dict:
    out = {k: np.asarray(getattr(idx, k)) for k in
           ("entry", "pool", "gzones", "gwide", "origin")}
    out.update({k: getattr(idx, k) for k in STATICS})
    out["aux"] = {k: np.asarray(idx.aux[k]) for k in AUX}
    return out


@pytest.fixture(scope="module")
def flagship():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtess_module, "_f64_jit_enabled",
                   lambda disable_env=None: False)
        jp, jg, res = jbuild(n_side=4, grid_name="H3", zones="taxi")
        jidx = jpj.build_dense_pip_index(jp, res, jg, precision="df")
    tp, tg, _ = tbuild(n_side=4, grid_name="H3", zones="taxi")
    tidx = tpj.build_pip_index(tp, res, tg, device="cpu")
    return {"jp": jp, "jg": jg, "jidx": jidx, "tp": tp, "tg": tg,
            "tidx": tidx, "res": res}


def test_index_tables_bit_equal(flagship):
    jidx, tidx = flagship["jidx"], flagship["tidx"]
    assert isinstance(jidx, jpj.DensePIPIndex)
    assert isinstance(tidx, tpj.DensePIPIndex)
    assert tidx.device == torch.device("cpu")
    for k in ("entry", "pool", "gzones", "gwide"):
        a, b = np.asarray(getattr(jidx, k)), getattr(tidx, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert np.array_equal(jidx.origin, tidx.origin)
    for k in STATICS:
        assert getattr(jidx, k) == getattr(tidx, k), k
    for k in AUX:
        assert np.array_equal(jidx.aux[k], tidx.aux[k]), k
    pts = nyc_points(1000, seed=3)
    assert np.array_equal(jpj.localize(jidx, pts), tpj.localize(tidx, pts))


def test_join_parity_on_carried_index(flagship):
    jidx, jp = flagship["jidx"], flagship["jp"]
    pidx = tpj.dense_index_from_arrays(tables_of(jidx), device="cpu")
    pts64 = nyc_points(50_000, seed=7)
    assert np.array_equal(pts64, jnyc_points(50_000, seed=7))

    jfn = jax.jit(jpj.make_pip_join_fn(jidx, flagship["jg"]))
    jz, ju = [np.asarray(v) for v in jfn(jnp.asarray(
        jpj.localize(jidx, pts64)))]
    j_final = jpj.host_recheck_fn(jidx)(pts64, jz, ju)

    tfn = tpj.make_pip_join_fn(pidx, flagship["tg"])
    tz, tu = tfn(torch.from_numpy(tpj.localize(pidx, pts64)))
    assert tz.dtype == torch.int32 and tu.dtype == torch.bool
    tz, tu = tz.numpy(), tu.numpy()
    t_final = tpj.host_recheck_fn(pidx, flagship["tp"])(pts64, tz, tu)

    truth = tpj.pip_host_truth(pts64, flagship["tp"])
    assert np.array_equal(truth, jpj.pip_host_truth(pts64, jp))
    assert np.array_equal(t_final, j_final)
    assert np.array_equal(t_final, truth)
    assert tu.mean() < 5e-3
    # certain points agree before any recheck
    sure = ~tu & ~ju
    assert np.array_equal(tz[sure], jz[sure])


def test_streamed_equals_one_shot_and_histogram(flagship):
    tidx, tp = flagship["tidx"], flagship["tp"]
    pts64 = nyc_points(30_000, seed=11)
    fn = tpj.make_pip_join_fn(tidx, flagship["tg"])
    z, u = fn(torch.from_numpy(tpj.localize(tidx, pts64)))
    one_shot = tpj.host_recheck_fn(tidx)(pts64, z.numpy(), u.numpy())
    run = tpj.make_streamed_pip_join(tidx, flagship["tg"], tp, chunk=4096,
                                     device="cpu")
    streamed, rechecked = run(pts64)
    assert np.array_equal(streamed, one_shot)
    assert rechecked == int(u.sum())
    # -1 rows (and out-of-range ids) are dropped, not wrapped
    zones = np.concatenate([streamed, [-1, -1, len(tp)]]).astype(np.int32)
    hist = tpj.zone_histogram(torch.from_numpy(zones), len(tp)).numpy()
    want = np.bincount(streamed[streamed >= 0], minlength=len(tp))
    assert np.array_equal(hist, want)
    assert int(hist.sum()) == int(np.sum(streamed >= 0))


def test_non_dense_workloads_raise_with_reason(flagship):
    """Workloads the dense path refuses name the reason and get the
    sorted-table index, whose join equals the oracle (the name predates
    the sorted path, when they raised)."""
    grid = get_index_system("CUSTOM(-75,-73,40,42,2,2,2)")
    assert tpj.build_dense_pip_index(flagship["tp"], 5, grid,
                                     device="cpu") is None
    assert tpj.LAST_DENSE_REJECT == "non_h3_grid"
    pts64 = nyc_points(5_000, seed=13)
    truth = tpj.pip_host_truth(pts64, flagship["tp"])
    for idx, g in ((tpj.build_pip_index(flagship["tp"], 5, grid,
                                        device="cpu"), grid),
                   (tpj.build_pip_index(flagship["tp"], flagship["res"],
                                        flagship["tg"], dense="never",
                                        device="cpu"), flagship["tg"])):
        assert isinstance(idx, tpj.PIPIndex)
        z, u = tpj.make_pip_join_fn(idx, g)(
            torch.from_numpy(tpj.localize(idx, pts64)))
        final = tpj.host_recheck_fn(idx, flagship["tp"])(
            pts64, z.numpy(), u.numpy())
        assert np.array_equal(final, truth)


def test_adversarial_points_both_packages(flagship):
    """Points on chip vertices (py == ay in f32), edge midpoints and a hair
    either side of chip and hex edges.  The port flags every point the
    JAX package flags, and more: it also flags points within eps of a
    straddling edge's line, which the JAX body misses beside nearly
    horizontal edges (ROADMAP C6); where neither flags, the zones are
    equal.  Both flag every point whose chip-only answer could be
    wrong here.  The chips are clipped to the straight lon/lat hexagon while
    the recheck takes the cell from the true H3 lattice, so a point in
    the cell-edge sagitta, or exactly on a chip edge under the half-open
    rule, can find no chip or the wrong one: the JAX package's recheck
    keeps that answer and misses the oracle on some of these points (all
    within the 1e-6 degree hazard band; beyond it both equal the oracle).
    The port's recheck sends every flagged point that ends -1, or lies
    within EPS_EDGE_DEG of an edge of its cell's chips, to the full
    polygon test, so its final zones equal ``pip_host_truth`` on every
    point."""
    jidx, jp, tp = flagship["jidx"], flagship["jp"], flagship["tp"]
    pidx = tpj.dense_index_from_arrays(tables_of(jidx), device="cpu")
    n_edges = 300
    pts64, offset = adversarial_points(
        pidx.aux["flat_a"], pidx.aux["flat_b"], flagship["tg"],
        flagship["res"], n_edges, seed=4)
    loc = tpj.localize(pidx, pts64)
    # a chip's start vertex lands on its pool row's ay in f32
    assert np.isin(loc[:n_edges, 1], pidx.pool[..., 1].numpy()).all()
    assert set(np.unique(offset)) == {0.0, *HAIRS_DEG}

    jfn = jax.jit(jpj.make_pip_join_fn(jidx, flagship["jg"]))
    jz, ju = [np.asarray(v) for v in jfn(jnp.asarray(
        jpj.localize(jidx, pts64)))]
    j_final = jpj.host_recheck_fn(jidx)(pts64, jz, ju)
    tz, tu = tpj.make_pip_join_fn(pidx, flagship["tg"])(
        torch.from_numpy(loc))
    tz, tu = tz.numpy(), tu.numpy()
    recheck = tpj.host_recheck_fn(pidx, tp)
    t_final = recheck(pts64, tz, tu)

    truth = tpj.pip_host_truth(pts64, tp)
    assert np.array_equal(truth, jpj.pip_host_truth(pts64, jp))
    print(f"flags: port {int(tu.sum())}, JAX {int(ju.sum())}, port only "
          f"{int((tu & ~ju).sum())} of {len(tu)} points")
    assert not (ju & ~tu).any()
    sure = ~tu & ~ju
    assert np.array_equal(tz[sure], jz[sure])
    assert np.array_equal(t_final, truth)
    j_wrong = j_final != truth
    assert j_wrong.sum() > 100 and not (j_wrong & ~ju).any()
    beyond = offset > tpj.EPS_EDGE_DEG
    assert beyond.sum() > 1000 and not (j_wrong & beyond).any()
    # the fallback took the points the chips could not settle, not all
    assert j_wrong.sum() <= recheck.fallbacks < tu.sum()


def _ring_wkt(pts) -> str:
    return "POLYGON((" + ", ".join(f"{x!r} {y!r}" for x, y in
                                   pts + pts[:1]) + "))"


def test_near_horizontal_edge_flagged_by_port_only():
    """ROADMAP C6.  Two zones share an edge that rises 1.5e-5 degrees over
    1e-2, 0.25 degrees from the index origin (a third zone far off puts
    the origin there).  At that distance f32 rounds a latitude by up to
    1.5e-8, and the crossing abscissa of a chip edge this flat moves
    |dx / dy| ~ 667 times as much, beyond the JAX body's 1e-6 band: on
    points within 1e-8 degrees of the edge the JAX join is certain and
    wrong, and no recheck sees them.  The port also flags points within
    eps of a straddling edge's line, so it flags every one of them, every
    point the JAX join flags, and its final zones equal the oracle."""
    x0, y0, dx, rise = -73.66, 41.05, 1e-2, 1.5e-5
    x1, y1 = x0 + dx, y0 + rise
    wkt = [_ring_wkt([(x0, y0), (x0, y0 - 0.006), (x1, y0 - 0.006),
                      (x1, y1)]),
           _ring_wkt([(x0, y0), (x1, y1), (x1, y1 + 0.006),
                      (x0, y0 + 0.006)]),
           _ring_wkt([(-74.41, 40.44), (-74.40, 40.44), (-74.40, 40.45),
                      (-74.41, 40.45)])]
    res = 9
    tp = read_wkt(wkt)
    tidx = tpj.build_pip_index(tp, res, get_index_system("H3"),
                               device="cpu")
    assert isinstance(tidx, tpj.DensePIPIndex)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtess_module, "_f64_jit_enabled",
                   lambda disable_env=None: False)
        jp, jg = jread_wkt(wkt), jget_index_system("H3")
        jidx = jpj.build_dense_pip_index(jp, res, jg, precision="df")
    assert np.array_equal(np.asarray(jidx.origin), tidx.origin)
    assert np.abs(tpj.localize(tidx, np.array([[x0, y0]]))).min() > 0.2
    r = np.random.default_rng(0)
    n = 1000
    t = r.uniform(0.02, 0.98, n)
    normal = np.array([-rise, dx]) / np.hypot(dx, rise)
    off = r.choice([0.0, 1e-9, -1e-9, 3e-9, -3e-9, 1e-8, -1e-8], n)
    pts64 = np.stack([x0 + t * dx, y0 + t * rise], -1) + \
        off[:, None] * normal

    truth = tpj.pip_host_truth(pts64, tp)
    assert np.array_equal(truth, jpj.pip_host_truth(pts64, jp))
    assert set(np.unique(truth)) == {0, 1}
    jz, ju = [np.asarray(v) for v in jax.jit(jpj.make_pip_join_fn(
        jidx, jg))(jnp.asarray(jpj.localize(jidx, pts64)))]
    j_missed = (jz != truth) & ~ju
    assert j_missed.sum() > 10
    assert (jpj.host_recheck_fn(jidx)(pts64, jz, ju) != truth).any()

    tz, tu = tpj.make_pip_join_fn(tidx)(
        torch.from_numpy(tpj.localize(tidx, pts64)))
    tz, tu = tz.numpy(), tu.numpy()
    assert tu[j_missed].all() and not (ju & ~tu).any()
    assert not ((tz != truth) & ~tu).any()
    assert np.array_equal(tpj.host_recheck_fn(tidx)(pts64, tz, tu), truth)


def test_recheck_of_an_index_from_arrays_needs_its_polygons(flagship):
    """``dense_index_from_arrays`` without the polygons' edges: the
    recheck raises unless the caller passes the polygons; the index that
    ``build_pip_index`` made carries them and rechecks alone, to the same
    zones."""
    tidx, tp = flagship["tidx"], flagship["tp"]
    bare = tpj.dense_index_from_arrays(tables_of(tidx), device="cpu")
    assert "oracle_edges" not in bare.aux and "oracle_edges" in tidx.aux
    with pytest.raises(ValueError, match="original polygons"):
        tpj.host_recheck_fn(bare)
    pts64 = nyc_points(5_000, seed=21)
    z, u = tpj.make_pip_join_fn(tidx)(torch.from_numpy(
        tpj.localize(tidx, pts64)))
    z, u = z.numpy(), u.numpy()
    u[::7] = True
    got = tpj.host_recheck_fn(bare, tp)(pts64, z, u)
    assert np.array_equal(got, tpj.host_recheck_fn(tidx)(pts64, z, u))
    assert np.array_equal(got, tpj.pip_host_truth(pts64, tp))


def _pre_move_body(idx, points, eps=tpj.EPS_EDGE_DEG):
    """make_dense_pip_join_fn's join as it was before the body moved to
    ops/dense_join.py: the projection wrapper then torch ops, with the
    near-crossing band widened since by the distance to the edge's line
    (ROADMAP C6)."""
    Z = int(idx.gzones.shape[1])
    err_lat = max(idx.err_lattice, tpj.err_lattice_bound(
        idx.res, "df", idx.ext_deg, localized=True))
    err32 = float(np.float32(err_lat))
    gap32 = float(np.float32(tpj.FACEGAP_EPS))
    eps32 = float(np.float32(eps))
    far_lim = float(np.float32(idx.ext_deg + 0.05))
    origin = (float(idx.origin[0]), float(idx.origin[1]))
    face, ai, bi, margin, facegap = project_lattice(points, idx.res, origin)
    far = (points[:, 0].abs() > far_lim) | (points[:, 1].abs() > far_lim)
    ia = ai - idx.a0
    ib = bi - idx.b0
    inw = ((face == idx.face0) & (ia >= 0) & (ia < idx.W) &
           (ib >= 0) & (ib < idx.H))
    lidx = torch.where(inw, ia * idx.H + ib, 0).long()
    e = torch.where(inw, idx.entry[lidx], -1)
    is_core = (e >= 0) & ((e & int(tpj.CORE_FLAG)) != 0)
    zone_core = torch.where(is_core, e & ~int(tpj.CORE_FLAG), -1)
    is_border = (e >= 0) & ~is_core
    g = torch.where(is_border, e, 0).long()
    rec = idx.pool[g]
    ax, ay = rec[..., 0], rec[..., 1]
    bx, by = rec[..., 2], rec[..., 3]
    zs = rec[..., 4].to(torch.int32)
    px = points[:, None, 0]
    py = points[:, None, 1]
    straddle = (ay <= py) != (by <= py)
    t = (py - ay) / torch.where(by == ay, torch.ones_like(by), by - ay)
    xi = ax + t * (bx - ax)
    crossed = straddle & (px < xi)
    dx, dy = bx - ax, by - ay
    cross = dx * (py - ay) - dy * (px - ax)
    eps2 = torch.tensor(eps32, dtype=torch.float32) ** 2
    near_line = cross * cross < eps2 * (dx * dx + dy * dy)
    near_cross = straddle & (((px - xi).abs() < eps32) | near_line)
    near_vertex = ((py - ay).abs() < eps32) & \
        (px < torch.maximum(ax, bx) + eps32)
    edge_flag = (near_cross | near_vertex).any(dim=-1) & is_border
    inside = torch.stack(
        [((crossed & (zs == z)).sum(dim=-1) & 1).bool()
         for z in range(Z)], dim=-1)
    first = torch.argmax(inside.to(torch.uint8), dim=-1)
    any_in = inside.any(dim=-1)
    gz = idx.gzones[g]
    zone_border = torch.where(any_in & is_border,
                              gz.gather(1, first[:, None])[:, 0], -1)
    zone = torch.where(is_core, zone_core, zone_border)
    wide = idx.gwide[g] & is_border
    uncertain = (margin < err32) | (facegap < gap32) | edge_flag | wide
    zone = torch.where(far, -1, zone).to(torch.int32)
    uncertain = uncertain & ~far
    return zone, uncertain


@pytest.mark.parametrize("slots", ["flagship", "over_32", "edges_over_32"])
def test_dense_join_ref_equals_pre_move_body(flagship, slots):
    tidx = flagship["tidx"]
    tables = tables_of(tidx)
    if slots == "over_32":
        tables = widen_zone_slots(tables)
        assert tables["gzones"].shape[1] > 32
    if slots == "edges_over_32":
        tables = widen_pool_edges(tables)
        assert tables["pool"].shape[1] == 3 * tidx.pool.shape[1] > 32
    idx = tpj.dense_index_from_arrays(tables, device="cpu")
    pts64 = np.concatenate([
        nyc_points(20_000, seed=13),
        adversarial_points(tidx.aux["flat_a"], tidx.aux["flat_b"],
                           flagship["tg"], flagship["res"], 200, seed=5)[0]])
    x = torch.from_numpy(tpj.localize(idx, pts64))
    zone, unc = tpj.make_pip_join_fn(idx)(x)
    want_zone, want_unc = _pre_move_body(idx, x)
    assert zone.dtype == torch.int32 and unc.dtype == torch.bool
    assert torch.equal(zone, want_zone) and torch.equal(unc, want_unc)
    if slots != "flagship":
        # the widened slots name the same zones, and each copied edge
        # crosses an even number of times more: the answer is unchanged
        z0, u0 = tpj.make_pip_join_fn(tidx)(x)
        assert torch.equal(zone, z0) and torch.equal(unc, u0)
        assert bool((zone >= 0).any())


def test_dense_join_rejects_and_counts_no_cpu_launch(flagship):
    tidx = flagship["tidx"]
    fn = tpj.make_pip_join_fn(tidx)
    tables, consts = fn.keywords["tables"], fn.keywords["consts"]
    x = torch.from_numpy(tpj.localize(tidx, nyc_points(500, seed=2)))
    before = (dj.dense_join.launches, project_lattice.launches)
    zone, unc = dj.dense_join(x, tables, consts)
    assert (dj.dense_join.launches, project_lattice.launches) == before
    ref = dj.dense_join_ref(x, tables, consts)
    assert torch.equal(zone, ref[0]) and torch.equal(unc, ref[1])
    assert torch.equal(ref[0], dj.join_body(
        x, project_lattice_ref(x, consts.res, consts.origin), tables,
        consts)[0])
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        dj.dense_join(torch.zeros((4, 3)), tables, consts)
    with pytest.raises(ValueError, match="float32"):
        dj.dense_join(x.double(), tables, consts)
    with pytest.raises(ValueError, match="contiguous"):
        dj.dense_join(x.t().contiguous().t(), tables, consts)
    meta = dj.JoinTables(*(t.to("meta") for t in tables))
    with pytest.raises(ValueError, match="tables on meta"):
        dj.dense_join(x, meta, consts)
    with pytest.raises(ValueError, match="unsupported device"):
        dj.dense_join(x.to("meta"), meta, consts)
    with pytest.raises(ValueError, match="points on meta, tables on cpu"):
        fn(x.to("meta"))


@pytest.mark.parametrize("slots", ["flagship", "over_32", "edges_over_32"])
def test_kernel_pool_layout_unpacks_to_pool(flagship, slots):
    """The fused kernel reads its own copy of the pool: edges as float4,
    zone slots apart, and per group the edges before its trailing pads.
    It holds the pool's values bit for bit, and every edge it skips is a
    pad (ay == by at 1e9, slot -1), which no point's test can reach."""
    tables = tables_of(flagship["tidx"])
    if slots == "over_32":
        tables = widen_zone_slots(tables)
    if slots == "edges_over_32":
        tables = widen_pool_edges(tables)
    idx = tpj.dense_index_from_arrays(tables, device="cpu")
    t = dj.join_tables(idx.entry, idx.pool, idx.gzones, idx.gwide)
    assert t.edges.is_contiguous() and t.eslot.is_contiguous()
    assert t.edges.dtype == torch.float32 and t.eslot.dtype == torch.int32
    unpacked = torch.cat([t.edges, t.eslot[..., None].float()], dim=-1)
    assert torch.equal(unpacked.view(torch.int32),
                       idx.pool.view(torch.int32))
    E = idx.pool.shape[1]
    past = torch.arange(E)[None, :] >= t.ecount[:, None].long()
    assert past.any() and bool((t.ecount > 0).all())
    skipped = idx.pool[past]
    assert bool((skipped[:, 1] == skipped[:, 3]).all())
    assert bool((skipped[:, 1].abs() >= dj.PAD_MIN_DEG).all())
    assert bool((skipped[:, 4] == -1).all())
    # the last edge walked is a real one
    last = idx.pool[torch.arange(len(t.ecount)), t.ecount.long() - 1]
    assert bool((last[:, 4] >= 0).all())
    if slots == "edges_over_32":
        # each group walks its real edges three times over
        src = flagship["tidx"]
        t0 = dj.join_tables(src.entry, src.pool, src.gzones, src.gwide)
        assert torch.equal(t.ecount, 3 * t0.ecount)
