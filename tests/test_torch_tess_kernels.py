"""The tessellation kernels' plain versions, the candidate sampling and
polyfill of the PyTorch port against the JAX package.

The port's classify and clip passes (``ops/tess_classify.py``,
``ops/tess_clip.py``) run on the CPU here through their plain versions,
which must give the JAX package's numpy branches (its bit-exact parity
path) bit for bit: ``classify_cells_multi`` (``_parity_block`` +
``_pair_check``) and ``convex_clip_tasks``.  Inputs: seeded random
cells and star polygons, and ``tess_adversarial``'s degenerate set
(edges along cell sides and through cell vertices, horizontal edges, a
pentagon, cells of up to 10 vertices, concave rings beyond the clip's
convex capacity).  The JAX package's jitted f64 kernels (x64 on, as the
tier-1 run has it) agree on the random set; on the degenerate set its
jitted clip drops or adds vertices where a vertex lies on a clip line
(ROADMAP C4), and there the port's vertex counts are those of an exact
rational Sutherland-Hodgman.  The CUDA kernels run only on the card;
numpy models of their lane widths, queues and scans are held here to
the plain versions, on these inputs and on the tessellate calls' own.
"""

import functools
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess
from mosaic_tpu import read_wkt as jread_wkt
from mosaic_tpu.bench.workloads import conus_counties as jcounties
from mosaic_tpu.core.index.custom import CustomIndexSystem as JCustom
from mosaic_tpu.core.index.custom import GridConf as JConf
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu_torch.bench.workloads import conus_counties as tcounties
from mosaic_tpu_torch.bench.workloads import tess_adversarial
from mosaic_tpu_torch.core import tessellate as ttess
from mosaic_tpu_torch.core.geometry.wkt import read_wkt as tread_wkt
from mosaic_tpu_torch.core.index.custom import CustomIndexSystem as TCustom
from mosaic_tpu_torch.core.index.custom import GridConf as TConf
from mosaic_tpu_torch.core.index.factory import get_index_system as tget
from mosaic_tpu_torch.core.index.h3 import system as tsys
from mosaic_tpu_torch.ops import tess_classify as tc
from mosaic_tpu_torch.ops import tess_clip as tcl

CLASSIFY_KEYS = ("edges", "edge_off", "pair_geo", "pair_cell", "cell_verts",
                 "cell_counts", "centers")
CLIP_KEYS = ("ring_xy", "ring_off", "task_ring", "task_cell", "cell_verts",
             "cell_counts")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_branches(monkeypatch):
    monkeypatch.setattr(jtess, "_f64_jit_enabled",
                        lambda disable_env=None: False)


def random_case(seed: int, n_cells: int = 40, n_geoms: int = 30) -> dict:
    """Seeded convex cells of 3-10 vertices and star polygons (one with a
    hole in every fifth), as tess_adversarial's CSR dict."""
    r = np.random.default_rng(seed)
    kmax = 10
    counts = r.integers(3, kmax + 1, n_cells).astype(np.int32)
    centers = r.uniform(-1, 1, (n_cells, 2)) + np.array([-73.9, 40.7])
    verts = np.zeros((n_cells, kmax, 2))
    for u in range(n_cells):
        th = np.sort(r.uniform(0, 2 * np.pi, counts[u]))
        v = centers[u] + r.uniform(0.05, 0.2) * np.stack(
            [np.cos(th), np.sin(th)], -1)
        verts[u, :counts[u]] = v
        verts[u, counts[u]:] = v[-1]
    rings = []
    for g in range(n_geoms):
        k = int(r.integers(3, 40))
        th = np.sort(r.uniform(0, 2 * np.pi, k))
        rad = r.uniform(0.05, 0.6, k)
        ctr = r.uniform(-1, 1, 2) + np.array([-73.9, 40.7])
        shell = ctr + rad[:, None] * np.stack([np.cos(th), np.sin(th)], -1)
        geom = [shell]
        if g % 5 == 0:
            geom.append(ctr + 0.03 * np.array([[1, 1], [1, -1], [-1, -1],
                                               [-1, 1]]))
        rings.append(geom)
    return csr_case(rings, verts, counts, centers)


def csr_case(rings, verts, counts, centers) -> dict:
    """CSR inputs of both kernels: every geometry paired with every cell,
    clip tasks every pair's rings."""
    edges_by = [np.concatenate([np.concatenate([x, np.roll(x, -1, 0)], 1)
                                for x in geom]) for geom in rings]
    pool = [x for geom in rings for x in geom]
    first = np.concatenate([[0], np.cumsum([len(g) for g in rings])])
    G, U = len(rings), len(verts)
    pair_geo = np.repeat(np.arange(G), U)
    pair_cell = np.tile(np.arange(U), G)
    task_ring = np.concatenate([np.arange(first[g], first[g + 1])
                                for g in pair_geo])
    task_cell = np.repeat(pair_cell, [len(rings[g]) for g in pair_geo])
    return {"edges": np.concatenate(edges_by),
            "edge_off": np.concatenate([[0], np.cumsum(
                [len(e) for e in edges_by])]).astype(np.int64),
            "pair_geo": pair_geo.astype(np.int64),
            "pair_cell": pair_cell.astype(np.int64), "cell_verts": verts,
            "cell_counts": counts, "centers": centers,
            "ring_xy": np.concatenate(pool),
            "ring_off": np.concatenate([[0], np.cumsum(
                [len(x) for x in pool])]).astype(np.int64),
            "task_ring": task_ring.astype(np.int64),
            "task_cell": task_cell.astype(np.int64), "rings": rings}


CASES = {"random": lambda: random_case(5),
         "adversarial": lambda: tess_adversarial(tget("H3"))}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return request.param, CASES[request.param]()


def tensors(d, keys):
    return [torch.from_numpy(np.ascontiguousarray(d[k])) for k in keys]


def edges_pad(d, extra: int = 0) -> np.ndarray:
    """The JAX form of the edges: [G, Epad, 2, 2], +inf past each
    geometry's own."""
    ne = np.diff(d["edge_off"])
    out = np.full((len(ne), int(ne.max()) + extra, 2, 2), np.inf)
    for g in range(len(ne)):
        out[g, :ne[g]] = d["edges"][d["edge_off"][g]:d["edge_off"][g + 1]
                                    ].reshape(-1, 2, 2)
    return out


def jax_classify(d, extra: int = 0):
    c = d["pair_cell"]
    return jtess.classify_cells_multi(
        d["cell_verts"][c], d["cell_counts"][c], d["centers"][c],
        d["pair_geo"], edges_pad(d, extra))


def port_classify(d):
    t, c = tc.classify_pairs_ref(*tensors(d, CLASSIFY_KEYS))
    return t.numpy(), c.numpy()


def ring_pool(d):
    o = d["ring_off"]
    return [d["ring_xy"][a:b] for a, b in zip(o[:-1], o[1:])]


def jax_clip(d):
    c = d["task_cell"]
    return jtess.convex_clip_tasks(ring_pool(d), d["task_ring"],
                                   d["cell_verts"][c], d["cell_counts"][c])


def port_clip(d):
    xy, off, count = tcl.clip_tasks_ref(*tensors(d, CLIP_KEYS))
    return tcl.closed_rings(xy, off, count), count.numpy()


def same_bits(a, b) -> bool:
    if (a is None) != (b is None):
        return False
    return a is None or (a.shape == b.shape and
                         np.array_equal(a.view(np.int64), b.view(np.int64)))


def exact_clip_count(ring, cell) -> int:
    """Vertices of Sutherland-Hodgman in rational arithmetic (the f64
    inputs taken exactly)."""
    poly = [(Fraction(x), Fraction(y)) for x, y in ring]
    cv = [(Fraction(x), Fraction(y)) for x, y in cell]
    for k in range(len(cv)):
        (x0, y0), (x1, y1) = cv[k], cv[(k + 1) % len(cv)]
        ex, ey = x1 - x0, y1 - y0
        out = []
        for i, (cx, cy) in enumerate(poly):
            nx, ny = poly[(i + 1) % len(poly)]
            dc = ex * (cy - y0) - ey * (cx - x0)
            dn = ex * (ny - y0) - ey * (nx - x0)
            if dc >= 0:
                out.append((cx, cy))
            if (dc >= 0) != (dn >= 0):
                t = dc / (dc - dn)
                out.append((cx + t * (nx - cx), cy + t * (ny - cy)))
        poly = out
    return len(poly)


# ------------------------------------------------ classify: plain version

def test_classify_ref_bit_equal_numpy_branches(case, monkeypatch):
    name, d = case
    numpy_branches(monkeypatch)
    jt, jc = jax_classify(d)
    pt, pc = port_classify(d)
    assert np.array_equal(jt, pt) and np.array_equal(jc, pc)
    # the set exercises every outcome
    assert pt.any() and (~pt).any() and (pt & ~pc).any()
    if name == "random":
        assert pc.any()


def test_pair_check_ref_bit_equal_numpy_branch(monkeypatch):
    numpy_branches(monkeypatch)
    r = np.random.default_rng(11)
    P, K = 2000, 6
    # a 1/4 lattice: many collinear, touching and shared-vertex pairs
    a1 = np.round(r.uniform(0, 3, (P, K, 2)) * 4) / 4
    b1 = np.roll(a1, -1, axis=1)
    a2 = np.round(r.uniform(0, 3, (P, 2)) * 4) / 4
    b2 = np.round(r.uniform(0, 3, (P, 2)) * 4) / 4
    vmask = r.random((P, K)) > 0.3
    vmask[:, 0] = True
    jh, ji = jtess._pair_check(a1, b1, a2, b2, vmask)
    th, ti = tc.pair_check_ref(*(torch.from_numpy(x) for x in
                                 (a1, b1, a2, b2, vmask)))
    assert np.array_equal(jh, th.numpy()) and np.array_equal(ji, ti.numpy())
    assert jh.any() and (~jh).any() and ji.any()


def test_bbox_filter_changes_no_boolean(case, monkeypatch):
    """The pair check over EVERY (pair, edge) gives the same crossed and
    inside flags as over the bbox-overlapping ones only: the kernel's
    comment argues it, the kernel keeps the filter as a branch."""
    _, d = case
    numpy_branches(monkeypatch)
    c = d["pair_cell"]
    verts, counts = d["cell_verts"][c], d["cell_counts"][c]
    K = verts.shape[1]
    k = np.arange(K)
    vmask = k[None] < counts[:, None]
    nxt = np.where(k[None] + 1 >= counts[:, None], 0, k[None] + 1)
    vnext = np.take_along_axis(verts, nxt[..., None], axis=1)
    ne = np.diff(d["edge_off"])[d["pair_geo"]]
    pi = np.repeat(np.arange(len(c)), ne)
    ei = np.concatenate([np.arange(d["edge_off"][g], d["edge_off"][g + 1])
                         for g in d["pair_geo"]])
    e = d["edges"][ei]
    hit, inside = jtess._pair_check(verts[pi], vnext[pi], e[:, :2], e[:, 2:],
                                    vmask[pi])
    inf = np.inf
    cb = np.stack([np.where(vmask, verts[..., 0], inf).min(1),
                   np.where(vmask, verts[..., 1], inf).min(1),
                   np.where(vmask, verts[..., 0], -inf).max(1),
                   np.where(vmask, verts[..., 1], -inf).max(1)], -1)[pi]
    ov = (cb[:, 0] <= np.maximum(e[:, 0], e[:, 2])) & \
        (np.minimum(e[:, 0], e[:, 2]) <= cb[:, 2]) & \
        (cb[:, 1] <= np.maximum(e[:, 1], e[:, 3])) & \
        (np.minimum(e[:, 1], e[:, 3]) <= cb[:, 3])
    for flag in (hit, inside):
        every = np.zeros(len(c), bool)
        filtered = np.zeros(len(c), bool)
        np.logical_or.at(every, pi, flag)
        np.logical_or.at(filtered, pi, flag & ov)
        assert np.array_equal(every, filtered)
        assert every.any()
    assert (~ov).any()


def test_sentinel_edges_change_no_boolean(monkeypatch):
    """+inf edges straddle no query and overlap no bbox: padding the JAX
    form wider, or not at all (the plain version's blocks; the kernel),
    gives the same booleans."""
    numpy_branches(monkeypatch)
    d = tess_adversarial(tget("H3"))
    narrow, wide = jax_classify(d), jax_classify(d, extra=37)
    for a, b in zip(narrow, wide):
        assert np.array_equal(a, b)
    one_geometry = port_classify({**d, "pair_geo": np.zeros_like(
        d["pair_geo"]), "edge_off": np.array([0, len(d["edges"])])})
    assert one_geometry[0].any()
    assert np.array_equal(port_classify(d)[0], narrow[0])


def test_classify_cells_single_polygon_equal_jax(monkeypatch):
    numpy_branches(monkeypatch)
    d = random_case(7)
    edges = d["edges"][:d["edge_off"][1]].reshape(-1, 2, 2)
    args = (d["cell_verts"], d["cell_counts"], d["centers"], edges)
    for a, b in zip(jtess.classify_cells(*args), ttess.classify_cells(*args)):
        assert np.array_equal(a, b)


# ---------------------------------------------------- clip: plain version

def test_clip_ref_bit_equal_numpy_branch(case, monkeypatch):
    name, d = case
    numpy_branches(monkeypatch)
    want = jax_clip(d)
    got, count = port_clip(d)
    assert len(got) == len(want)
    assert all(same_bits(a, b) for a, b in zip(want, got))
    assert sum(g is not None for g in got) > 10
    if name == "adversarial":
        # concave rings past the kernel's convex capacity (V + K + 1), in
        # its shared-memory (<= 64) and global-memory tiers
        lens = np.diff(d["ring_off"])[d["task_ring"]]
        cap = lens + d["cell_verts"].shape[1] + 1
        assert ((count > cap) & (cap <= 64)).any()
        assert ((count > cap) & (cap > 64)).any()


@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("source", ["random0", "random1", "adversarial"])
def test_convex_clip_rings_equal_jax(source, closed):
    """convex_clip_rings, every (ring, cell) a task of the clip, against
    the JAX package's numpy convex_clip_rings: the same ring or None per
    (cell, ring), bit for bit, the rings given open or closed, and a
    two-vertex ring that both skip."""
    d = tess_adversarial(tget("H3"), n_random=2) \
        if source == "adversarial" else \
        random_case(int(source[-1]), n_cells=12, n_geoms=6)
    rings = [x for geom in d["rings"] for x in geom]
    rings = [np.vstack([r, r[:1]]) if closed else r for r in rings]
    rings.append(rings[0][:2])
    verts, counts = d["cell_verts"], d["cell_counts"]
    want = jtess.convex_clip_rings(rings, verts, counts)
    got = ttess.convex_clip_rings(rings, verts, counts, device="cpu")
    assert len(got) == len(want) == len(verts)
    for w, g in zip(want, got):
        assert len(w) == len(g) == len(rings) and g[-1] is None
        assert all(same_bits(a, b) for a, b in zip(w, g))
    assert sum(x is not None for row in got for x in row) > 5


def test_clip_ref_counts_equal_exact_rational():
    d = tess_adversarial(tget("H3"))
    got, count = port_clip(d)
    pool = ring_pool(d)
    for i, (r, u) in enumerate(zip(d["task_ring"], d["task_cell"])):
        cell = d["cell_verts"][u, :d["cell_counts"][u]]
        assert exact_clip_count(pool[r], cell) == count[i], i


# ------------------------------------ the JAX package's jitted f64 kernels

def test_jitted_kernels_agree_on_random_inputs(monkeypatch):
    """x64 on: the JAX package's tess/parity, tess/pair_check and tess/clip
    give the plain versions' booleans, and chips within 1e-13 degrees
    (C4: XLA rounds them in other last bits)."""
    import jax
    assert jax.config.jax_enable_x64
    monkeypatch.delenv("MOSAIC_TPU_DISABLE_CLIP_JIT", raising=False)
    monkeypatch.setattr(jtess, "_f64_jit_enabled",
                        lambda disable_env=None: True)
    d = random_case(9)
    jt, jc = jax_classify(d)
    pt, pc = port_classify(d)
    assert np.array_equal(jt, pt) and np.array_equal(jc, pc)
    got, _ = port_clip(d)
    n = 0
    for a, b in zip(jax_clip(d), got):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-13
            n += 1
    assert n > 10


def test_jitted_clip_diverges_on_ties_c4(monkeypatch):
    """On the degenerate set the JAX package's jitted clip changes the
    vertex count of tasks whose ring has vertices on the cell's side lines
    (a vertex exactly on a clip plane emits itself and its crossing in
    Sutherland-Hodgman; the jitted body drops or adds one).  The plain
    version's counts there are the exact rational ones; the booleans of
    the jitted classify equal the plain version's.  Pinned: ROADMAP C4."""
    monkeypatch.delenv("MOSAIC_TPU_DISABLE_CLIP_JIT", raising=False)
    monkeypatch.setattr(jtess, "_f64_jit_enabled",
                        lambda disable_env=None: True)
    d = tess_adversarial(tget("H3"))
    jt, jc = jax_classify(d)
    pt, pc = port_classify(d)
    assert np.array_equal(jt, pt) and np.array_equal(jc, pc)
    got, count = port_clip(d)
    pool = ring_pool(d)
    differ = [i for i, (a, b) in enumerate(zip(jax_clip(d), got))
              if (a is None) != (b is None) or
              (a is not None and (a.shape != b.shape or
                                  np.abs(a - b).max() > 1e-13))]
    assert len(differ) > 10
    for i in differ:
        u = d["task_cell"][i]
        cell = d["cell_verts"][u, :d["cell_counts"][u]]
        assert exact_clip_count(pool[d["task_ring"][i]], cell) == count[i]


# --------------------------------------------------- tessellate, sampling

def test_counties_res5_chipset_equal_jax(monkeypatch):
    numpy_branches(monkeypatch)
    ja, ta = jcounties(n_side=8), tcounties(n_side=8)
    assert np.asarray(ja.coords).tobytes() == np.asarray(ta.coords).tobytes()
    before = dict(tsys.SAMPLE_COUNTS)
    j = jtess.tessellate(ja, 5, jget("H3"), keep_core_geom=False)
    t = ttess.tessellate(ta, 5, tget("H3"), keep_core_geom=False,
                         device="cpu")
    assert len(t) > 50_000 and t.is_core.any()
    assert np.array_equal(j.cell_id, t.cell_id)
    assert np.array_equal(j.geom_id, t.geom_id)
    assert np.array_equal(j.is_core, t.is_core)
    for f in ("coords", "ring_offsets", "part_offsets", "geom_offsets",
              "types"):
        assert np.array_equal(np.asarray(getattr(j.geoms, f)),
                              np.asarray(getattr(t.geoms, f))), f
    # the sampling lattice went through the cell kernel's plain version
    assert tsys.SAMPLE_COUNTS["points"] > before["points"] + 100_000


def test_sampled_candidates_equal_host_sets():
    """The cell kernel's plain version over the counties' sampling lattice,
    its low-margin points sent to the host: every lattice id is the host's,
    and so is every candidate set."""
    grid = tget("H3")
    bboxes = tcounties(n_side=8).bboxes()
    before = dict(tsys.SAMPLE_COUNTS)
    dev = grid.candidate_cells_batch(bboxes, 5, device=torch.device("cpu"))
    points = tsys.SAMPLE_COUNTS["points"] - before["points"]
    host_points = tsys.SAMPLE_COUNTS["host_points"] - before["host_points"]
    host = grid.candidate_cells_batch(bboxes, 5)
    assert all(np.array_equal(a, b) for a, b in zip(dev, host))
    assert points >= tsys.SAMPLE_MIN_POINTS and 0 < host_points < points
    r = np.random.default_rng(3)
    xy = np.stack([r.uniform(-125, -66, 40_000), r.uniform(24, 50, 40_000)],
                  -1)
    assert np.array_equal(grid._point_to_cell_sample(xy, 5, "cpu"),
                          grid.point_to_cell(xy, 5))
    # small lattices and fine resolutions take the host path alone
    n = tsys.SAMPLE_COUNTS["points"]
    grid._point_to_cell_sample(xy[:1000], 5, "cpu")
    grid._point_to_cell_sample(xy, 11, "cpu")
    assert tsys.SAMPLE_COUNTS["points"] == n


def test_polyfill_square_custom_equal_jax():
    wkt = ["POLYGON ((1.2 1.2, 3.2 1.2, 3.2 3.2, 1.2 3.2, 1.2 1.2))"]
    j = jtess.polyfill(jread_wkt(wkt), 0,
                       JCustom(JConf(0, 16, 0, 16, 2, 1.0, 1.0)))
    t = ttess.polyfill(tread_wkt(wkt), 0,
                       TCustom(TConf(0, 16, 0, 16, 2, 1.0, 1.0)),
                       device="cpu")
    assert len(t) == 1 and len(t[0]) == 4
    assert np.array_equal(j[0], t[0])


def test_polyfill_county_h3_equal_jax():
    ja, ta = jcounties(n_side=8).take([3, 20]), tcounties(n_side=8).take(
        [3, 20])
    j = jtess.polyfill(ja, 5, jget("H3"))
    t = ttess.polyfill(ta, 5, tget("H3"), device="cpu")
    assert len(t) == 2 and all(len(x) > 100 for x in t)
    assert all(np.array_equal(a, b) for a, b in zip(j, t))


# ------------------------------------------------------------- wrappers

def test_wrappers_on_cpu_run_the_plain_versions():
    d = tess_adversarial(tget("H3"), n_random=4)
    l7, l8 = tc.tess_classify.launches, tcl.tess_clip.launches
    for a, b in zip(tc.tess_classify(*tensors(d, CLASSIFY_KEYS)),
                    tc.classify_pairs_ref(*tensors(d, CLASSIFY_KEYS))):
        assert torch.equal(a, b)
    for a, b in zip(tcl.tess_clip(*tensors(d, CLIP_KEYS)),
                    tcl.clip_tasks_ref(*tensors(d, CLIP_KEYS))):
        assert torch.equal(a, b)
    assert (tc.tess_classify.launches, tcl.tess_clip.launches) == (l7, l8)


@pytest.mark.parametrize("which", ["classify", "clip"])
def test_wrappers_reject_what_the_kernels_do_not_take(which):
    d = tess_adversarial(tget("H3"), n_random=0)
    if which == "classify":
        fn, args = tc.tess_classify, tensors(d, CLASSIFY_KEYS)
        with pytest.raises(ValueError, match="edges"):
            fn(args[0].float(), *args[1:])
        with pytest.raises(ValueError, match="at most 10"):
            fn(*args[:4], torch.zeros(3, 11, 2, dtype=torch.float64),
               *args[5:])
    else:
        fn, args = tcl.tess_clip, tensors(d, CLIP_KEYS)
        with pytest.raises(ValueError, match="cell_counts"):
            fn(*args[:5], args[5].long())
        with pytest.raises(ValueError, match="differ"):
            fn(*args[:3], args[3][:-1], *args[4:])
    # a count past the cell table's width would read the next cell's
    # vertices; a negative one is no cell
    verts, counts = args[4], args[5]
    assert int(counts.max()) > 6
    with pytest.raises(ValueError, match="table's width"):
        fn(*args[:4], verts[:, :6].contiguous(), *args[5:])
    negative = counts.clone()
    negative[0] = -1
    with pytest.raises(ValueError, match="table's width"):
        fn(*args[:5], negative, *args[6:])


def test_compact_and_closed_rings():
    xy = torch.arange(40, dtype=torch.float64).reshape(20, 2)
    off = torch.tensor([0, 6, 12])
    count = torch.tensor([3, 0, 4], dtype=torch.int32)
    flat, new_off = tcl.compact(xy, off, count)
    assert new_off.tolist() == [0, 4, 4]
    assert torch.equal(flat[:4], xy[0:4]) and torch.equal(flat[4:], xy[12:17])
    rings = tcl.closed_rings(xy, off, count)
    assert rings[1] is None and rings[0].shape == (4, 2)
    assert np.array_equal(rings[2], xy[12:17].numpy())
    assert tcl.closed_rings(xy, off, count, min_count=4)[0] is None


# ------------------------------------------ numpy models of the kernels'
# schedules: the wrappers' plans and the kernels' splits of the work, in
# numpy f64, against the plain versions

@functools.cache
def kernel_inputs(source: str):
    """(classify args, clip args) as numpy arrays: a CASES set, or the
    tessellate calls' own (a small taxi index build, 256 footprints) as
    the port's CPU path hands them to the wrappers."""
    if source in CASES:
        d = CASES[source]()
        return [d[k] for k in CLASSIFY_KEYS], [d[k] for k in CLIP_KEYS]
    kept = {}

    def keep(name, fn):
        def run(*args):
            kept[name] = [a.numpy() for a in args]
            return fn(*args)
        return run

    if source == "taxi":
        from mosaic_tpu_torch.bench.workloads import build_workload
        arr, grid, res = build_workload(n_side=4, grid_name="H3",
                                        zones="taxi")
        core_geom = False
    else:
        from mosaic_tpu_torch.bench.workloads import footprints
        arr, grid, res, core_geom = footprints(256), tget("H3"), 9, True
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ttess, "tess_classify",
                   keep("classify", ttess.tess_classify))
        mp.setattr(ttess, "tess_clip", keep("clip", ttess.tess_clip))
        ttess.tessellate(arr, res, grid, keep_core_geom=core_geom,
                         device="cpu")
    finally:
        mp.undo()
    return kept["classify"], kept["clip"]


MODEL_SOURCES = ("random", "adversarial", "taxi", "footprints")




def _orient(p, q, r):
    return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - \
        (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])


def k7_model(args, lanes):
    """K7 in numpy, warp by warp: ``lanes`` (None: the wrapper's
    ``lanes_for`` on an H100's 132 SMs) a pair, 32 / lanes pairs a warp, lane l of a pair's
    group on its edges l, l + lanes, ...  Phase A: the parity bits an
    edge settles without a divide (the query left of both the edge's
    start and its rounded end) XORed into the lane's word; edges with
    queries between them, or whose bboxes overlap, appended to the warp's
    queue.  Phase B, a warp's worth at a time and the rest at the end:
    the queued queries' crossings by the divide XORed in, the
    overlapping edges' flags ORed in.  Returns (touching, core, drains of
    a full warp, divides)."""
    edges, edge_off, pair_geo, pair_cell, verts, counts, centers = args
    P, K = len(pair_geo), verts.shape[1]
    ne = np.diff(edge_off)[pair_geo]
    W = tc.lanes_for(int(ne.sum()), P, 132) if lanes is None else lanes
    assert W in tc.LANES
    G = 32 // W
    n = counts[pair_cell].astype(np.int64)
    qx = np.concatenate([centers[pair_cell, None, 0],
                         verts[pair_cell, :, 0]], 1)       # [P, K + 1]
    qy = np.concatenate([centers[pair_cell, None, 1],
                         verts[pair_cell, :, 1]], 1)
    qreal = np.arange(K + 1)[None] <= n[:, None]
    vmask = qreal[:, 1:]
    inf = np.inf
    bb = np.stack([np.where(vmask, verts[pair_cell, :, 0], inf).min(1),
                   np.where(vmask, verts[pair_cell, :, 1], inf).min(1),
                   np.where(vmask, verts[pair_cell, :, 0], -inf).max(1),
                   np.where(vmask, verts[pair_cell, :, 1], -inf).max(1)], 1)
    tame = (np.abs(qy) < 2.0 ** 1000).all(1, where=qreal)
    par = np.zeros(P, np.int64)
    flags = np.zeros(P, np.int64)
    full_drains = divides = 0

    def pair_check(p, e):
        a, b = edges[e, None, 0:2], edges[e, None, 2:4]
        v = np.stack([verts[pair_cell[p], :, 0], verts[pair_cell[p], :, 1]],
                     -1)
        k = np.arange(K)[None]
        nxt = np.where(k + 1 >= n[p, None], 0, k + 1)
        w = np.take_along_axis(v, nxt[..., None], 1)
        m = vmask[p]
        d1, d2 = _orient(a, b, v), _orient(a, b, w)
        d3, d4 = _orient(v, w, a), _orient(v, w, b)
        proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & \
            (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)

        def on_seg(p_, q_, r_, d):
            return (d == 0) & \
                (np.minimum(p_[..., 0], q_[..., 0]) <= r_[..., 0]) & \
                (r_[..., 0] <= np.maximum(p_[..., 0], q_[..., 0])) & \
                (np.minimum(p_[..., 1], q_[..., 1]) <= r_[..., 1]) & \
                (r_[..., 1] <= np.maximum(p_[..., 1], q_[..., 1]))

        touch = on_seg(a, b, v, d1) | on_seg(a, b, w, d2) | \
            on_seg(v, w, a, d3) | on_seg(v, w, b, d4)
        hit = ((proper | touch) & m).any(1)
        inside = ((d3 >= 0) | ~m).all(1)
        np.bitwise_or.at(flags, p, hit | (inside << 1))

    def drain(queue):
        nonlocal divides
        for qp, qe, _, qexact in queue:
            divides += int(qexact.sum())
            ax, ay, bx, by = edges[qe]
            den = 1.0 if by == ay else by - ay
            with np.errstate(invalid="ignore", divide="ignore"):
                xi = ax + (qy[qp] - ay) / den * (bx - ax)
            par[qp] ^= int(((qexact & (qx[qp] < xi))
                            << np.arange(K + 1)).sum())
        over = [(qp, qe) for qp, qe, qov, _ in queue if qov]
        if over:
            pair_check(*(np.array(x) for x in zip(*over)))

    for p0 in range(0, P, G):
        pairs = np.arange(p0, min(p0 + G, P))
        queue = []
        for it in range(int((-(-ne[pairs] // W)).max())):
            # lane (slot, l) on edge it * W + l of the slot's pair
            slot, lane = np.divmod(np.arange(len(pairs) * W), W)
            p, k = pairs[slot], it * W + lane
            p, k = p[k < ne[p]], k[k < ne[p]]
            e = edge_off[pair_geo[p]] + k
            ax, ay, bx, by = (edges[e, c, None] for c in range(4))
            st = (ay <= qy[p]) != (by <= qy[p])
            # the crossing's x lies between ax and xe: a query left of
            # both is a crossing, one at or right of both is none
            xe = ax + (bx - ax)
            sure = tame[p, None] & (np.abs(edges[e]) < 2.0 ** 1000).all(
                1, keepdims=True)
            left = sure & (qx[p] < ax) & (qx[p] < xe)
            right = sure & (qx[p] >= ax) & (qx[p] >= xe)
            bits = st & left & qreal[p]
            exact = st & ~left & ~right & qreal[p]
            np.bitwise_xor.at(par, p, (bits << np.arange(K + 1)).sum(1))
            ov = (bb[p, 0] <= np.maximum(ax, bx)[:, 0]) & \
                (np.minimum(ax, bx)[:, 0] <= bb[p, 2]) & \
                (bb[p, 1] <= np.maximum(ay, by)[:, 0]) & \
                (np.minimum(ay, by)[:, 0] <= bb[p, 3])
            keep = ov | exact.any(1)
            queue += list(zip(p[keep], e[keep], ov[keep], exact[keep]))
            assert len(queue) < tc.QUEUE
            if len(queue) >= 32:
                full_drains += 1
                drain(queue[:32])
                queue = queue[32:]
        drain(queue)
    vm = (1 << n) - 1
    vin = (par >> 1) & vm
    hit, inside = (flags & 1) > 0, (flags & 2) > 0
    core = (vin == vm) & ~hit & ~inside
    touching = hit | ((par & 1) > 0) | (vin != 0) | inside | core
    return touching, core, full_drains, divides


@pytest.mark.parametrize("name,lanes", [
    (name, lanes) for name in MODEL_SOURCES
    for lanes in ((None, *tc.LANES) if name in CASES else (None, 1))])
def test_k7_lane_model_equals_plain(name, lanes):
    """K7's lanes and queue, modelled in numpy at every lane width the
    kernel has on the CASES sets, and at the wrapper's pick and a thread
    a pair on the tessellate calls' own inputs, with the parity
    settled without a divide where the edge's ends bracket the crossing:
    the plain version's booleans."""
    a7 = kernel_inputs(name)[0]
    want = [t.numpy() for t in tc.classify_pairs_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in a7))]
    touching, core, full_drains, divides = k7_model(a7, lanes)
    assert np.array_equal(touching, want[0])
    assert np.array_equal(core, want[1])
    # a box's straddling edges are vertical: ax == xe, no divide
    assert (divides == 0) == (name == "footprints")
    # the degenerate set's warps drain full warps of queued items
    assert full_drains > 0 or name != "adversarial"
    assert want[0].any() and (want[0] & ~want[1]).any()


def test_k7_lanes_for():
    """At least EDGES_PER_LANE edges a lane, widened to fill the card:
    the county run's 16.8 edges a pair and the taxi zones' 27.4 take 2
    lanes a pair on an H100's 132 SMs, the footprints' 4 a thread, the
    degenerate set's 533 pairs a warp a pair; prefixes of the county
    run's pairs, halved again and again, take every other width."""
    assert tc.lanes_for(3_551_032, 211_466, 132) == 2
    assert tc.lanes_for(4_807_440, 175_454, 132) == 2
    assert tc.lanes_for(6_280_040, 1_570_010, 132) == 1
    assert tc.lanes_for(8_900, 533, 132) == 32
    assert tc.lanes_for(10**9, 10**6, 1) == 32
    assert tc.lanes_for(10**6, 10**6, 1) == 1
    picks = {tc.lanes_for(3_551_032 >> h, 211_466 >> h, 132)
             for h in range(8)}
    assert picks == set(tc.LANES) - {1}


def test_k8_lanes_for():
    """A thread a task on the footprints' boxes (capacity 11), 4 lanes on
    the counties' 17-vertex rings (24), a warp past the 4-lane shared
    budget (47 vertices a buffer at K = 6); the rings past it launched
    apart, so a few long rings leave the rest on 4 lanes, and the
    degenerate set (cells of 10 slots, capacities 16-93) takes both."""
    assert tcl.lanes_for(11, 6) == 1
    assert tcl.lanes_for(24, 6) == 4
    assert tcl.lanes_for(47, 6) == 4
    assert tcl.lanes_for(48, 6) == 32
    assert (tcl.shared_verts(4, 6), tcl.shared_verts(32, 6)) == (47, 397)
    assert tcl.smem_verts(32, 300, 6) == 300
    county = torch.full((68_387,), 24)
    assert [len(p) for p in tcl.classes(county, 6)] == [68_387]
    county[::100] = 279
    parts = tcl.classes(county, 6)
    assert [len(p) for p in parts] == [67_703, 684]
    assert [tcl.lanes_for(int(county[p].max()), 6) for p in parts] == \
        [4, 32]
    assert torch.equal(torch.sort(torch.cat(parts)).values,
                       torch.arange(68_387))
    d = tess_adversarial(tget("H3"))
    cap = torch.from_numpy(np.diff(d["ring_off"])[d["task_ring"]] + 11)
    assert [tcl.lanes_for(int(cap[p].max()), 10)
            for p in tcl.classes(cap, 10)] == [4, 32]
    assert [len(p) for p in tcl.classes(cap[cap > 45], 10)] == \
        [int((cap > 45).sum())]


def k8_model(args, lanes):
    """K8 in numpy, launch by launch as the wrapper plans them: capacity
    V + K + 1, then twice it for the jobs that overflowed.  Per plane a
    job's vertices go to its lanes in rounds of ``lanes`` (None: each
    launch's ``lanes_for``); a round's emit positions are the job's
    count so far plus the segmented shuffle scan of the lanes' emit
    counts, as the kernel's __shfl_up_sync(width) steps compute it, and
    one lane walks the ring carrying d_nxt into d_cur.  Returns (xy, off,
    count) with the kernel's offsets (a job's capacity + 1 rows), the
    launches and the lane widths they took."""
    ring_xy, ring_off, task_ring, task_cell, verts, counts = args
    T, K = len(task_ring), verts.shape[1]
    lens = np.diff(ring_off)[task_ring]
    cap = lens + K + 1
    count = np.full(T, -1, np.int64)
    rings = [None] * T

    def clip_jobs(jobs, w):
        for t in jobs:
            C = int(cap[t])
            src = ring_xy[ring_off[task_ring[t]]:ring_off[task_ring[t] + 1]]
            n, ok = len(src), len(src) <= C
            cc = int(counts[task_cell[t]])
            cv = verts[task_cell[t]]
            for k in range(cc if ok else 0):
                p0, p1 = cv[k], cv[0 if k + 1 >= cc else k + 1]
                ev = p1 - p0
                d = ev[0] * (src[:, 1] - p0[1]) - ev[1] * (src[:, 0] - p0[0])
                dn = np.roll(d, -1)                 # d_nxt is d_cur of i + 1
                emit_v = (d >= 0).astype(np.int64)
                emit_i = ((d >= 0) != (dn >= 0)).astype(np.int64)
                cnt = emit_v + emit_i
                if w == 1:
                    pos = np.cumsum(cnt) - cnt
                else:
                    rounds = -(-n // w)
                    c2 = np.zeros(rounds * w, np.int64)
                    c2[:n] = cnt
                    incl = c2.reshape(rounds, w).copy()
                    lane = np.arange(w)[None]
                    o = 1
                    while o < w:
                        up = np.roll(incl, o, axis=1)
                        incl = np.where(lane >= o, incl + up, incl)
                        o <<= 1
                    before = np.concatenate([[0], np.cumsum(incl[:, -1])])
                    pos = (before[:-1, None] + incl - c2.reshape(rounds, w)
                           ).reshape(-1)[:n]
                m = int(cnt.sum())
                dst = np.zeros((min(m, C), 2))
                nxt = np.roll(src, -1, axis=0)
                denom = d - dn
                with np.errstate(invalid="ignore", divide="ignore"):
                    tt = np.where(denom != 0, d / np.where(denom == 0, 1.0,
                                                           denom), 0.0)
                inter = src + tt[:, None] * (nxt - src)
                for i in range(n):
                    if emit_v[i] and pos[i] < C:
                        dst[pos[i]] = src[i]
                    if emit_i[i] and pos[i] + emit_v[i] < C:
                        dst[pos[i] + emit_v[i]] = inter[i]
                src, n = dst, m
                if m > C:
                    ok = False
                    break
            if ok:
                count[t] = n
                rings[t] = src

    jobs, widths = np.arange(T), []
    while len(jobs):
        for part in tcl.classes(torch.from_numpy(cap[jobs]), K):
            w = tcl.lanes_for(int(cap[jobs[part]].max()), K) \
                if lanes is None else lanes
            assert w in tcl.LANES
            widths.append(w)
            clip_jobs(jobs[part.numpy()], w)
        jobs = np.nonzero(count < 0)[0]
        cap[jobs] *= 2
    size = cap + 1
    off = np.cumsum(size) - size
    xy = np.zeros((int(size.sum()), 2))
    for t in range(T):
        if count[t] >= 1:
            xy[off[t]:off[t] + count[t]] = rings[t]
            xy[off[t] + count[t]] = rings[t][0]
    return xy, off, count, widths


@pytest.mark.parametrize("name,lanes", [
    (name, lanes) for name in MODEL_SOURCES
    for lanes in ((None, *tcl.LANES) if name in CASES else (None, 1))])
def test_k8_lane_model_equals_plain(name, lanes):
    """K8 at every lane width the kernel has, and the wrapper's own pick,
    modelled in numpy (every width on the CASES sets; the wrapper's pick
    and a thread on the tessellate calls' own inputs):
    compacted, the clipped rings, their offsets and counts equal
    clip_tasks_ref's bit for bit; rings past shared memory at 4 lanes
    are launched apart, and the degenerate set relaunches its concave
    rings."""
    a8 = kernel_inputs(name)[1]
    want = tcl.clip_tasks_ref(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in a8))
    xy, off, count, widths = k8_model(a8, lanes)
    flat, new_off = tcl.compact(torch.from_numpy(xy), torch.from_numpy(off),
                                torch.from_numpy(count.astype(np.int32)))
    assert torch.equal(torch.from_numpy(count.astype(np.int32)), want[2])
    assert torch.equal(new_off, want[1])
    assert torch.equal(flat.view(torch.int64), want[0].view(torch.int64))
    # one launch per class of ring length, then the relaunches
    K = a8[4].shape[1]
    first = len(tcl.classes(torch.from_numpy(np.diff(a8[1])[a8[2]] + K + 1),
                            K))
    assert len(widths) > first if name == "adversarial" else \
        len(widths) == first
    assert lanes is None or set(widths) == {lanes}
