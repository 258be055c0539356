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
rational Sutherland-Hodgman.
"""

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
