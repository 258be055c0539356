"""Polygon x polygon overlay of the PyTorch port against the JAX package.

The fixture is tests/test_overlay.py's: 150 footprint boxes (seed 1) x
``nyc_zones(n_side=3, seed=2)`` over its bbox, at H3 res 9.  The JAX side
tessellates on its float64 numpy branches (``_f64_jit_enabled`` patched
off, as tests/test_torch_tessellate.py does), so both packages pack
bit-equal chip rows; the port runs on ``device="cpu"``, where the
chip-pair probe is its plain version.

* ``pack_chip_rows``: cells, geometry ids, edges, valid and origin
  bit-equal.
* The device body on the JAX package's own rows (carried across by
  ``overlay_rows_from_arrays``): raw hits equal wherever neither package
  flags a hazard.  XLA:CPU may reorder or contract f32 arithmetic where
  torch does not, so hazard flags may differ in the last bit; their
  count is printed and bounded at 1e-3 of the candidate pairs.
* ``overlay_intersects`` equal to the JAX package's and to the f64 host
  oracle bit for bit, on the fixture, on disjoint sets, on a corner
  within 1e-8 degrees of a zone edge and on a cell crowded with more
  than 8 footprint chips.
* ``overlay_row_pairs`` and ``overlay_intersection_area``: pair sets
  equal to the JAX package's, and the area contract of
  tests/test_overlay.py (1e-12 + 1e-9 area) against the JAX package's
  areas, its host oracle and the exact areas of the footprint boxes.
  The port computes its areas in a local frame, so they differ from the
  JAX package's global-frame shoelace by that one's rounding (~1e-12 at
  |lon| ~74), not bit for bit.
* The pairs probe's relaunch when its key buffer is short.
* The chip-pair kernel's host-side pieces, which run here: its flat
  match list (the prefix sum of the B rows' range lengths) gives the
  pairs of ``probe``'s ranges, and so
  does a model of the kernel's walk of it (the even split over warps,
  the 32-ary search of the prefix sum, a lane's row from the next 32
  range ends); the plain version of its B-row pre-pass gives lengths
  bit-equal to ``_lengths``; its hazard band's reciprocal shortcut
  decides as the rounded quotient does.
"""

import numpy as np
import pytest
import torch

import mosaic_tpu.core.tessellate as jtess_module
from mosaic_tpu.bench.workloads import nyc_zones as jzones
from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
from mosaic_tpu.core.geometry.clip import _normalize_rings as jnormalize
from mosaic_tpu.core.geometry.clip import geometry_rings as jrings
from mosaic_tpu.core.geometry.clip import ring_signed_area as jarea
from mosaic_tpu.core.geometry.clip import rings_boolean as jboolean
from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.parallel import overlay as jov
from mosaic_tpu_torch import overlay_intersects, overlay_rows_from_arrays
from mosaic_tpu_torch.bench.workloads import footprints as tfootprints
from mosaic_tpu_torch.bench.workloads import nyc_zones as tzones
from mosaic_tpu_torch.core.geometry.array import GeometryBuilder as TBuilder
from mosaic_tpu_torch.core.index.factory import get_index_system as tget
from mosaic_tpu_torch.core.tessellate import tessellate as ttess
from mosaic_tpu_torch.ops import overlay_pairs as tops
from mosaic_tpu_torch.parallel import overlay as tov
from test_torch_clip import exact_box_area

BBOX = (-74.05, 40.65, -73.90, 40.80)
RES = 9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops here are small; one intra-op thread keeps this
    file from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def jax_numpy_branches():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtess_module, "_f64_jit_enabled",
                   lambda disable_env=None: False)
        yield


def boxes(builder, centers, half):
    """Axis-aligned boxes [cx ± w, cy ± h] in one GeometryArray."""
    b = builder()
    for (cx, cy), (w, h) in zip(centers, half):
        b.add_polygon(np.array([[cx - w, cy - h], [cx + w, cy - h],
                                [cx + w, cy + h], [cx - w, cy + h],
                                [cx - w, cy - h]]))
    return b.finish()


def fixture_boxes(n, seed):
    """tests/test_overlay.py's footprints: centers and half-sizes."""
    rng = np.random.default_rng(seed)
    centers, half = [], []
    for _ in range(n):
        cx = rng.uniform(BBOX[0], BBOX[2])
        cy = rng.uniform(BBOX[1], BBOX[3])
        w = rng.uniform(2e-4, 2e-3)
        h = rng.uniform(2e-4, 2e-3)
        centers.append((cx, cy))
        half.append((w, h))
    return centers, half


def both(centers, half):
    return boxes(JBuilder, centers, half), boxes(TBuilder, centers, half)


def one_polygon(ring):
    out = []
    for builder in (JBuilder, TBuilder):
        b = builder()
        b.add_polygon(np.asarray(ring, float))
        out.append(b.finish())
    return out


@pytest.fixture(scope="module")
def data():
    ja, ta = both(*fixture_boxes(150, 1))
    jb = jzones(n_side=3, seed=2, bbox=BBOX)
    tb = tzones(n_side=3, seed=2, bbox=BBOX)
    return ja, jb, ta, tb


@pytest.fixture(scope="module")
def grids():
    return jget("H3"), tget("H3")


@pytest.fixture(scope="module")
def packed(data, grids):
    ja, jb, ta, tb = data
    jg, tg = grids
    jra = jov.pack_chip_rows(ja, RES, jg)
    jrb = jov.pack_chip_rows(jb, RES, jg, origin=jra[4])
    tra = tov.pack_chip_rows(ta, RES, tg, device="cpu")
    trb = tov.pack_chip_rows(tb, RES, tg, origin=tra[4], device="cpu")
    return jra, jrb, tra, trb


@pytest.mark.parametrize("side", [0, 1])
def test_pack_chip_rows_bit_equal(packed, side):
    j, t = packed[side], packed[2 + side]
    for k, name in enumerate(("cell", "geom", "edges", "valid", "origin")):
        assert j[k].dtype == t[k].dtype, name
        assert np.array_equal(j[k], t[k]), name
    assert t[2].shape[2] == 4 and t[3].any()
    assert np.all(np.abs(t[2][~t[3]]) == np.float32(1e9))


def test_raw_hits_match_jax_outside_hazards(data, packed):
    import jax.numpy as jnp
    jra, jrb = packed[:2]
    ga, gb = len(data[0]), len(data[1])
    eps = tov.hazard_eps(jra[2], jrb[2])
    dup = jov._exact_dup_cap(jra[0], jra[3], jrb[0], jrb[3])
    jfn = jov.make_overlay_fn(ga, gb, jra[2].shape[1], jrb[2].shape[1],
                              dup_cap=dup, eps=eps)
    jh, jz, diag = jfn(*[jnp.asarray(v) for v in jra[:4] + jrb[:4]])
    assert int(np.asarray(diag)[2]) <= dup
    a = overlay_rows_from_arrays(jra, "cpu")
    b = overlay_rows_from_arrays(jrb, "cpu")
    th, tz = tops.overlay_dense(a, b, ga, gb, eps)
    jh, jz = np.asarray(jh) > 0, np.asarray(jz) > 0
    th, tz = th.numpy() > 0, tz.numpy() > 0
    order, start, upper = tops.probe(a, b)
    candidates = int((upper - start).sum())
    flag_diff = int(np.sum(jz != tz))
    print(f"{candidates} candidate chip pairs, {int(jz.sum())} hazard "
          f"geometry pairs; hazard flags differ at {flag_diff}")
    assert candidates > 100 and jz.any()
    assert flag_diff <= 1e-3 * candidates
    clean = ~jz & ~tz
    assert np.array_equal(jh[clean], th[clean])
    assert th.any() and not th.all()


def test_intersects_equals_jax_and_oracle(data, grids):
    ja, jb, ta, tb = data
    got = overlay_intersects(ta, tb, RES, grids[1], device="cpu")
    want = tov.overlay_host_truth(ta, tb)
    assert got.dtype == bool and got.shape == (len(ta), len(tb))
    assert np.array_equal(got, want)
    assert np.array_equal(got, jov.overlay_intersects(ja, jb, RES,
                                                      grids[0]))
    assert np.array_equal(want, jov.overlay_host_truth(ja, jb))
    # the workload exercises both outcomes
    assert want.any() and not want.all()


def near_touch_corner():
    """A footprint corner 1e-8 degrees outside a zone edge: the f32
    crossing test can miscall it, so the band must flag it and the f64
    recheck must say False (tests/test_overlay.py)."""
    zone_ring = np.array([[-74.0, 40.7], [-73.95, 40.7],
                          [-73.99538953140, 40.77723034],
                          [-74.0, 40.75], [-74.0, 40.7]])
    p1, p2 = zone_ring[1], zone_ring[2]
    t = 0.63
    px = p1[0] + t * (p2[0] - p1[0]) + 1e-8
    py = p1[1] + t * (p2[1] - p1[1])
    w = 5e-4
    foot = np.array([[px, py - w], [px + w, py - w], [px + w, py + w],
                     [px, py + w], [px, py - w]])
    (jf, tf), (jz, tz) = one_polygon(foot), one_polygon(zone_ring)
    return jf, jz, tf, tz


def disjoint_sets():
    """Far-apart sets share no cells: all False, no pairs tested."""
    ja, ta = both(*fixture_boxes(20, 3))
    ring = [[-73.5, 41.2], [-73.4, 41.2], [-73.4, 41.3], [-73.5, 41.3],
            [-73.5, 41.2]]
    jb, tb = one_polygon(ring)
    return ja, jb, ta, tb


def crowded_cell():
    """16 small boxes in one res-9 cell under a zone whose edge runs
    through them: more than 8 footprint chips in a cell, beyond the JAX
    package's first duplicate cap."""
    grid = tget("H3")
    cell = grid.point_to_cell(np.array([[-73.98, 40.75]]), RES)
    cx, cy = grid.cell_center(cell)[0]
    off = (np.arange(4) - 1.5) * 2.5e-4
    centers = [(cx + dx, cy + dy) for dx in off for dy in off]
    ja, ta = both(centers, [(6e-5, 6e-5)] * len(centers))
    ring = [[cx - 0.01, cy - 0.01], [cx + 1e-4, cy - 0.01],
            [cx + 1.3e-4, cy + 0.01], [cx - 0.01, cy + 0.01],
            [cx - 0.01, cy - 0.01]]
    jb, tb = one_polygon(ring)
    return ja, jb, ta, tb


@pytest.mark.parametrize("case", [near_touch_corner, disjoint_sets,
                                  crowded_cell])
def test_intersects_edge_cases(case, grids):
    ja, jb, ta, tb = case()
    jg, tg = grids
    got = overlay_intersects(ta, tb, RES, tg, device="cpu")
    want = tov.overlay_host_truth(ta, tb)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jov.overlay_intersects(ja, jb, RES, jg))
    if case is disjoint_sets:
        assert not got.any()
    if case is crowded_cell:
        ra = tov.pack_chip_rows(ta, RES, tg, device="cpu")
        rb = tov.pack_chip_rows(tb, RES, tg, origin=ra[4], device="cpu")
        _, start, upper = tops.probe(overlay_rows_from_arrays(ra, "cpu"),
                                     overlay_rows_from_arrays(rb, "cpu"))
        assert int((upper - start).max()) > 8
        assert want.any() and not want.all()


def test_row_pairs_equal_jax(data, grids):
    ja, jb, ta, tb = data
    jg, tg = grids
    jca = jtess_module.tessellate(ja, RES, jg, keep_core_geom=True)
    jcb = jtess_module.tessellate(jb, RES, jg, keep_core_geom=True)
    tca = ttess(ta, RES, tg, keep_core_geom=True, device="cpu")
    tcb = ttess(tb, RES, tg, keep_core_geom=True, device="cpu")
    j = jov.overlay_row_pairs(jca, jcb, ja, jb, RES, jg)
    t = tov.overlay_row_pairs(tca, tcb, ta, tb, RES, tg, device="cpu")
    assert len(t[0]) > 100
    assert np.array_equal(j[0], t[0]) and np.array_equal(j[1], t[1])


def _host_pair_area(a, b, i, j):
    rings = jboolean(jnormalize(jrings(a, i)), jnormalize(jrings(b, j)),
                     "intersection")
    return sum(jarea(r) for r in jnormalize(rings))


def test_intersection_area_equals_jax(data, grids):
    ja, jb, ta, tb = data
    ga, gb, area = tov.overlay_intersection_area(ta, tb, RES, grids[1],
                                                 device="cpu")
    jga, jgb, jarea_ = jov.overlay_intersection_area(ja, jb, RES, grids[0])
    assert np.array_equal(ga, jga) and np.array_equal(gb, jgb)
    np.testing.assert_allclose(area, jarea_, rtol=1e-9, atol=1e-12)
    # the footprints are boxes: every pair against its exact area
    box = ta.bboxes().reshape(-1, 2, 2)
    for k in range(len(ga)):
        exact = exact_box_area(box[ga[k]], jnormalize(jrings(jb, int(gb[k]))))
        assert abs(area[k] - exact) < 1e-12 + 1e-9 * exact
    # tests/test_overlay.py's contract against the host oracle
    want = tov.overlay_host_truth(ta, tb)
    got_pairs = set(zip(ga.tolist(), gb.tolist()))
    want_pairs = set(zip(*np.nonzero(want)))
    for i, j in want_pairs - got_pairs:
        assert _host_pair_area(ja, jb, int(i), int(j)) < 1e-15
    assert not (got_pairs - want_pairs)
    rng = np.random.default_rng(5)
    for k in rng.choice(len(ga), size=min(25, len(ga)), replace=False):
        want_a = _host_pair_area(ja, jb, int(ga[k]), int(gb[k]))
        assert abs(area[k] - want_a) < 1e-12 + 1e-9 * want_a


def test_pairs_relaunch_on_short_buffer(packed, monkeypatch):
    jra, jrb = packed[:2]
    eps = tov.hazard_eps(jra[2], jrb[2])
    rows = lambda r: overlay_rows_from_arrays(  # noqa: E731
        (r[0], np.arange(len(r[0])), r[2], r[3]), "cpu")
    a, b = rows(jra), rows(jrb)
    row_mult = len(jrb[0]) + 1
    full = tops.overlay_pairs(a, b, row_mult, eps, 1 << 20)
    caps = []
    once = tops._pairs_once

    def spy(*args):
        caps.append(args[-1])
        return once(*args)

    monkeypatch.setattr(tops, "_pairs_once", spy)
    short = tops.overlay_pairs(a, b, row_mult, eps, 7)
    assert caps == [7, int(full.numel())]
    assert full.numel() > 7
    assert np.array_equal(np.sort(short.numpy()), np.sort(full.numpy()))
    assert len(np.unique(full.numpy())) == full.numel()


def test_chip_pair_test_ref_against_jax(packed):
    """The plain version's hit and hazard per chip pair against the JAX
    package's _chip_pair_test on matched pairs of the fixture's rows
    (hits compared where neither side flags a hazard)."""
    import jax
    import jax.numpy as jnp
    jra, jrb = packed[:2]
    a = overlay_rows_from_arrays(jra, "cpu")
    b = overlay_rows_from_arrays(jrb, "cpu")
    eps = tov.hazard_eps(jra[2], jrb[2])
    order, start, upper = tops.probe(a, b)
    rb = torch.nonzero(upper > start).squeeze(1)
    ra = order[start[rb]]
    th, tz = tops.chip_pair_test_ref(a.edges[ra], b.edges[rb], eps)
    jfn = jax.vmap(lambda ea, eb: jov._chip_pair_test(ea, eb,
                                                      jnp.float32(eps)))
    jh, jz = jfn(jnp.asarray(jra[2][ra.numpy()]),
                 jnp.asarray(jrb[2][rb.numpy()]))
    jh, jz = np.asarray(jh), np.asarray(jz)
    th, tz = th.numpy(), tz.numpy()
    assert len(th) > 100 and th.any() and tz.any()
    assert int(np.sum(jz != tz)) <= 1e-3 * len(th)
    clean = ~jz & ~tz
    assert np.array_equal(jh[clean], th[clean])


def test_kernel_wrappers_reject_bad_rows(packed):
    jra, jrb = packed[:2]
    a = overlay_rows_from_arrays(jra, "cpu")
    b = overlay_rows_from_arrays(jrb, "cpu")
    bad = a._replace(edges=a.edges.double())
    with pytest.raises(ValueError, match="float32"):
        tops.overlay_dense(bad, b, 150, 9, 1e-6)
    with pytest.raises(ValueError, match="length"):
        tops.overlay_pairs(a._replace(valid=a.valid[:-1]), b, 10, 1e-6, 8)
    with pytest.raises(ValueError, match="pair_cap"):
        tops.overlay_pairs(a, b, 10, 1e-6, 0)


def test_overlay_entry_points_default_to_cuda(data, grids):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    ta, tb = data[2], data[3]
    tg = grids[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overlay_intersects(ta, tb, RES, tg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tov.overlay_intersection_area(ta, tb, RES, tg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overlay_rows_from_arrays(tov.pack_chip_rows(tb, RES, tg,
                                                    device="cpu"))


def test_footprints_follow_bench_py():
    """The chip_smoke overlay's footprints: bench.py's generator (seed 41,
    the NYC box, half-sizes 2e-4..2e-3) box for box."""
    rng = np.random.default_rng(41)
    centers, half = [], []
    for _ in range(64):
        cx = rng.uniform(-74.2, -73.75)
        cy = rng.uniform(40.55, 40.85)
        w, h = rng.uniform(2e-4, 2e-3, 2)
        centers.append((cx, cy))
        half.append((w, h))
    want = boxes(TBuilder, centers, half)
    got = tfootprints(64)
    assert np.array_equal(np.asarray(got.coords), np.asarray(want.coords))
    for f in ("ring_offsets", "part_offsets", "geom_offsets", "types"):
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f


def _port_rows(packed):
    tra, trb = packed[2:]
    return (overlay_rows_from_arrays(tra, "cpu"),
            overlay_rows_from_arrays(trb, "cpu"))


def _probe_pairs(a, b):
    """(A row, B row) of every match, from probe's ranges."""
    order, start, upper = tops.probe(a, b)
    return sorted((int(order[s]), rb) for rb in range(len(start))
                  for s in range(int(start[rb]), int(upper[rb])))


def _sparse_rows(a, b):
    """The fixture's B rows with some invalid, some moved to cells no A
    row has, and the A rows' valid flags thinned: empty ranges between
    live ones, and invalid rows on both sides."""
    bv = b.valid.clone()
    bv[::5] = False
    cell = b.cell.clone()
    cell[1::7] = -12345
    av = a.valid.clone()
    av[::11] = False
    return a._replace(valid=av), b._replace(cell=cell, valid=bv)


@pytest.mark.parametrize("rows", ["fixture", "sparse"])
def test_match_list_gives_probe_pairs(packed, rows):
    a, b = _port_rows(packed)
    if rows == "sparse":
        a, b = _sparse_rows(a, b)
    ml = tops.match_list(a, b)
    order, start, upper = tops.probe(a, b)
    n = upper - start
    # empty ranges lie between live ones, as the kernel's walk meets them
    live = torch.nonzero(n > 0).squeeze(1)
    assert bool((n[live[0]:live[-1]] == 0).any())
    assert torch.equal(ml.order, order) and torch.equal(ml.start, start)
    assert ml.offs[0] == 0 and torch.equal(ml.offs[1:], n.cumsum(0))
    # expanded: match m -> (order[start[j] + m - offs[j]], j)
    total = int(ml.offs[-1])
    assert total > 100
    j = torch.repeat_interleave(torch.arange(len(n)), n)
    m = torch.arange(total)
    ra = ml.order[ml.start[j] + m - ml.offs[j]]
    got = sorted(zip(ra.tolist(), j.tolist()))
    assert got == _probe_pairs(a, b)


def _find_row(offs, m, lanes=32):
    """csrc/overlay_pairs.cu find_row: the 32-ary search, lane by lane."""
    lo, hi = 0, len(offs) - 1
    while hi - lo > 1:
        span = hi - lo
        q = [lo + span * (lane + 1) // (lanes + 1) for lane in range(lanes)]
        c = sum(int(offs[x] <= m) for x in q)
        assert all(offs[x] <= m for x in q[:c])     # a prefix of lanes
        lo, hi = (lo + span * c // (lanes + 1) if c else lo,
                  lo + span * (c + 1) // (lanes + 1) if c < lanes else hi)
    return lo


@pytest.mark.parametrize("rows", ["fixture", "sparse"])
def test_kernel_walk_of_the_match_list(packed, rows):
    """The kernel's walk of the flat list: warp w takes matches [M w /
    warps, M (w + 1) / warps), 32 a step, a lane each; it finds its first
    B row by the 32-ary search, and each step a lane's row is the step's
    first row j0 plus the rows from j0 whose ranges end at or before its
    match (the next 32 ends; past them, a search alone); every match
    once, the pairs of probe."""
    a, b = _port_rows(packed)
    if rows == "sparse":
        a, b = _sparse_rows(a, b)
    ml = tops.match_list(a, b)
    offs = ml.offs.tolist()
    nb, total = len(offs) - 1, offs[-1]
    want = _probe_pairs(a, b)
    for warps in (1, 3, total // 40, total + 5):
        got = []
        for w in range(warps):
            w0, w1 = total * w // warps, total * (w + 1) // warps
            if w0 >= w1:
                continue
            j0 = _find_row(offs, w0)
            for m0 in range(w0, w1, 32):
                ends = [offs[j0 + 1 + t] if j0 + t < nb else 2 ** 63
                        for t in range(32)]
                rows_ = []
                for lane in range(32):
                    mq = min(m0 + lane, w1 - 1)
                    c = sum(e <= mq for e in ends)
                    j = j0 + c if c < 32 else _find_row(offs, mq)
                    assert offs[j] <= mq < offs[j + 1]
                    rows_.append(j)
                    if m0 + lane < w1:
                        ra = int(ml.order[int(ml.start[j]) + mq - offs[j]])
                        got.append((ra, j))
                j0 = rows_[31]
        assert sorted(got) == want, warps


def test_row_staging_lengths_bit_equal(packed):
    a, b = _port_rows(packed)
    edges = torch.cat([a.edges, b.edges])
    # a row with its padding between real edges, and one all padding
    odd = edges[:2].clone()
    odd[0, 1] = 1e9
    odd[1] = 1e9
    edges = torch.cat([edges, odd])
    count, moved, lengths, rcp = tops.staged_rows_ref(edges)
    real = ~(edges[..., 0].abs() > tops.PAD_ABOVE)
    assert torch.equal(count, real.sum(1))
    assert count[-1] == 0 and count[-2] == real[-2].sum()
    want = tops._lengths(edges)
    for r in range(len(edges)):
        k = int(count[r])
        assert torch.equal(moved[r, :k].view(torch.int32),
                           edges[r][real[r]].view(torch.int32))
        assert torch.equal(lengths[r, :k].view(torch.int32),
                           want[r][real[r]].view(torch.int32))
        assert torch.equal(rcp[r, :k], 1.0 / lengths[r, :k])
        assert not lengths[r, k:].any()


def test_band_reciprocal_shortcut_is_the_quotient():
    """csrc/overlay_pairs.cu in_band: q = x * fl(1/len); below eps (1 -
    2^-20) the point is in the band, at or above eps (1 + 2^-20) it is
    not, and only between does the kernel divide.  Its answer equals
    fl(x / len) < eps, in f32, on values straddling the band's edge."""
    f32 = np.float32
    rng = np.random.default_rng(3)
    for eps in (1e-6, 3.5e-6, 7.62939453125e-6):
        e = f32(eps)
        lo = f32(float(e) * (1 - 2 ** -20))
        hi = f32(float(e) * (1 + 2 ** -20))
        lens = np.concatenate([
            f32(10.0) ** rng.uniform(-30, 3, 4000).astype(f32),
            np.array([1e-30, 1.0, 3.0, 1e-3], f32)]).astype(f32)
        lens = np.maximum(lens, f32(1e-30))
        steps = rng.integers(-40, 41, len(lens)).astype(np.float64)
        x = (e.astype(np.float64) * lens * (1 + steps * 2.0 ** -24)
             ).astype(f32)
        x = np.concatenate([x, rng.uniform(0, 1e-3, 500).astype(f32),
                            np.zeros(4, f32)])
        lens = np.concatenate([lens, lens[:500], lens[:4]])
        q = x * (f32(1) / lens)
        kernel = np.where(q < lo, True,
                          np.where(q >= hi, False, x / lens < e))
        assert np.array_equal(kernel, x / lens < e)
        assert ((q >= lo) & (q < hi)).any() and (q < lo).any()
