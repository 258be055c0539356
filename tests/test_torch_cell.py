"""H3 cell assignment of the PyTorch port (ops/cell.py, torchkernel.py).

On the CPU the wrapper runs the plain version of the CUDA cell kernel
(``latlng_to_cell_margin_ref``).  It is held against

* the JAX package's ``cell_from_lattice_jax`` on the same (face, a, b):
  int64 ids bit-equal at every resolution 0..15, pentagon base cells
  included (integer arithmetic: no tolerance);
* the JAX package's H3 device hook ``point_to_cell_jax_margin`` (which
  calls ``latlng_to_cell_jax_margin``; on the CPU under x64 the JAX
  package projects in native f64, the port in df from f32 sin/cos): ids
  equal wherever the port's margin is at least 3e-5 degrees, the sorted
  join's band, and margins within 3e-5 degrees where the ids agree
  (f32 inputs carry up to ~1.5e-5 degrees of rounding at |lon| ~180);
* the f64 host ``point_to_cell`` on the fixture of
  tests/test_h3.py::test_jax_kernel_matches_host: ids equal wherever the
  margin clears the band, and on more than 98% of all points (the JAX
  test's bound).

The kernel itself runs only on the card; chip_smoke.py holds it against
the plain version there, bit for bit.  Its packed tables are held here
against the tables they pack: every rotation word against the three
clamped table lookups it composes, digit 0 fixed by every rotation, the
entry words against the base-cell tables, the lead-digit shortcut
against the plain version's loop, the kernel's round_div7 against floor
division over the whole int32 range, and a numpy model of the kernel's
integer cell step on the packed tables against ``cell_from_lattice_ref``
at every resolution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.index.factory import get_index_system as jget
from mosaic_tpu.core.index.h3.jaxkernel import (cell_from_lattice_jax,
                                                latlng_to_cell_jax_margin)
from mosaic_tpu_torch.core.index.factory import get_index_system
from mosaic_tpu_torch.core.index.h3 import hexmath as hm
from mosaic_tpu_torch.core.index.h3 import index as ix
from mosaic_tpu_torch.core.index.h3.tables import tables
from mosaic_tpu_torch.core.index.h3.torchkernel import (cell_from_lattice_ref,
                                                        round_div7)
from mosaic_tpu_torch.core.index.h3.torchkernel import (cell_tables,
                                                        digit_fill)
from mosaic_tpu_torch.ops import cell as oc
from mosaic_tpu_torch.ops.cell import (latlng_to_cell_margin,
                                       latlng_to_cell_margin_ref)

BAND_DEG = 3e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def global_points(n: int, seed: int) -> np.ndarray:
    """[n, 2] f64 (lon, lat) degrees: uniform on the sphere, plus points
    within a few hundred km of each of the 12 pentagon centers."""
    rng = np.random.default_rng(seed)
    lat = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    lon = rng.uniform(-180, 180, n)
    t = tables()
    pent = np.nonzero(t.is_pentagon)[0]
    centers = ix.cell_to_latlng(ix.pack(pent, np.zeros((len(pent), 0),
                                                       np.int64), 0))
    near = np.degrees(centers)[:, ::-1][rng.integers(0, 12, n // 4)]
    near = near + rng.normal(0, 2.0, near.shape)
    near[:, 1] = np.clip(near[:, 1], -89.9, 89.9)
    near[:, 0] = (near[:, 0] + 180.0) % 360.0 - 180.0
    return np.concatenate([np.stack([lon, lat], -1), near])


def test_round_div7_is_floor():
    p = torch.arange(-200, 201, dtype=torch.int32)
    want = np.floor((2 * p.numpy() + 7) / 14).astype(np.int32)
    np.testing.assert_array_equal(round_div7(p).numpy(), want)
    # floor(-19/14) = -2 where truncation gives -1 (p = -13)
    assert int(round_div7(torch.tensor([-13]))[0]) == -2


@pytest.mark.parametrize("res", range(16))
def test_cell_from_lattice_bit_equal(res):
    pts = global_points(4000, seed=res)
    face, hex2d = hm.project_lattice(np.radians(pts[:, ::-1]), res)
    ijk = hm.hex2d_to_ijk(hex2d)
    a, b = ijk[:, 0] - ijk[:, 2], ijk[:, 1] - ijk[:, 2]
    ours = cell_from_lattice_ref(torch.from_numpy(face.astype(np.int32)),
                                 torch.from_numpy(a.astype(np.int32)),
                                 torch.from_numpy(b.astype(np.int32)), res)
    theirs = np.asarray(cell_from_lattice_jax(
        jnp.asarray(face, jnp.int32), jnp.asarray(a, jnp.int32),
        jnp.asarray(b, jnp.int32), res))
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # and they are the host's ids for the f64 points
    np.testing.assert_array_equal(
        ours.numpy(), ix.latlng_to_cell(np.radians(pts[:, ::-1]), res))
    base = (ours.numpy() >> 45) & 0x7F
    assert np.any(tables().is_pentagon[base])


@pytest.mark.parametrize("res", [0, 1, 2, 5, 9, 12, 15])
def test_latlng_to_cell_matches_jax_hook(res):
    pts = global_points(20_000, seed=100 + res).astype(np.float32)
    cells, margin = get_index_system("H3").point_to_cell_torch_margin(
        torch.from_numpy(pts), res)
    jc, jm = [np.asarray(v) for v in jget("H3").point_to_cell_jax_margin(
        jnp.asarray(pts), res)]
    cells, margin = cells.numpy(), margin.numpy()
    assert margin.dtype == np.float32
    sure = margin >= BAND_DEG
    differ = cells != jc
    print(f"res {res}: {int(differ.sum())} ids differ from the JAX hook, "
          f"{int((differ & sure).sum())} with margin >= {BAND_DEG}; "
          f"{int((~sure).sum())} below the band")
    assert not np.any(differ & sure)
    assert np.max(np.abs(margin - jm)[~differ]) <= BAND_DEG
    assert np.all(ix.is_valid_cell(cells))
    # the composed plain version is what the hook runs on the CPU
    c2, m2 = latlng_to_cell_margin_ref(torch.from_numpy(pts), res)
    np.testing.assert_array_equal(c2.numpy(), cells)
    np.testing.assert_array_equal(m2.numpy(), margin)


def test_latlng_to_cell_jax_entry_point_same_answer():
    """The JAX package's ``latlng_to_cell_jax_margin`` called with the
    hook's f32 radians is the hook: the comparison above is with it."""
    pts = global_points(5_000, seed=3).astype(np.float32)
    lat = jnp.radians(jnp.asarray(pts[:, 1]))
    lng = jnp.radians(jnp.asarray(pts[:, 0]))
    jc, _ = latlng_to_cell_jax_margin(lat, lng, 9)
    cells, margin = latlng_to_cell_margin_ref(torch.from_numpy(pts), 9)
    sure = margin.numpy() >= BAND_DEG
    assert not np.any((cells.numpy() != np.asarray(jc)) & sure)


def test_matches_host_on_h3_fixture():
    """tests/test_h3.py's fixture: 5000 uniform points on the sphere."""
    rng = np.random.default_rng(7)
    lat = np.arcsin(rng.uniform(-1, 1, 5000))
    lng = rng.uniform(-np.pi, np.pi, 5000)
    host = ix.latlng_to_cell(np.stack([lat, lng], -1), 9)
    pts = np.stack([np.degrees(lng), np.degrees(lat)], -1).astype(
        np.float32)
    cells, margin = latlng_to_cell_margin_ref(torch.from_numpy(pts), 9)
    cells, margin = cells.numpy(), margin.numpy()
    agree = np.mean(cells == host)
    print(f"agreement with the f64 host: {agree}")
    assert agree > 0.98
    assert np.array_equal(cells[margin >= BAND_DEG],
                          host[margin >= BAND_DEG])


def _rot(r, d):
    """rot_digit[r * 7 + d], the index clamped as the plain version does."""
    rot = cell_tables()["rot_digit"]
    return int(rot[min(max(r * 7 + d, 0), rot.size - 1)])


def test_rotation_words_compose_the_three_tables():
    words = oc.cell_words()[oc.N_ENTRIES:].view(np.uint32)
    assert words.shape == (oc.ROTATIONS * oc.ROTATIONS * 2,)
    for r0 in range(oc.ROTATIONS):
        for extra in range(oc.ROTATIONS):
            for relabel in range(2):
                w = int(words[(r0 * oc.ROTATIONS + extra) * 2 + relabel])
                assert w < 1 << 24
                for d in range(8):
                    want = _rot(relabel, _rot(extra, _rot(r0, d)))
                    assert (w >> (3 * d)) & 7 == want, (r0, extra, relabel,
                                                        d)


def test_every_rotation_keeps_digit_zero():
    rot = cell_tables()["rot_digit"].reshape(oc.ROTATIONS, 7)
    assert (rot[:, 0] == 0).all()
    # and each is a permutation of the digits 1-6
    assert all(sorted(row[1:]) == list(range(1, 7)) for row in rot)
    words = oc.cell_words()[oc.N_ENTRIES:].view(np.uint32)
    assert not (words & 7).any()


def test_entry_words_unpack_to_the_tables():
    t = cell_tables()
    w = oc.cell_words()[:oc.N_ENTRIES].astype(np.int64)
    base = w & 127
    np.testing.assert_array_equal(base, t["fijk_base"])
    np.testing.assert_array_equal((w >> 7) & 7, t["fijk_rot"])
    np.testing.assert_array_equal((w >> 10) & 7, t["fijk_extra"])
    np.testing.assert_array_equal((w >> 13) & 1, t["is_pent"][base])
    np.testing.assert_array_equal((w >> 14) & 7, t["pent_seam"][base])
    assert not (w >> 17).any()
    dod = oc.digit_of_diff_word()
    assert [(dod >> (3 * i)) & 7 for i in range(9)] == \
        list(cell_tables()["digit_of_diff"])


def _lead_shortcut(r0, raw):
    """csrc/h3_cell.cu's lead digit: ``raw`` holds the raw digits of
    levels 1..15 at bits 3 * (15 - level), the rotation word of ``r0``
    sends each to its rotated digit, and the lead is the rotation of the
    first (lowest level) raw digit not sent to 0, or 0."""
    rot0 = oc.rotation_word(r0, 0, 0)
    low = sum(1 << (3 * (15 - r)) for r in range(1, 16))
    live = (raw | raw >> 1 | raw >> 2) & low
    if (rot0 >> 21) & 7 == 0:
        live &= ~(raw & raw >> 1 & raw >> 2)
    if not live:
        return 0
    at = live.bit_length() - 1
    return (rot0 >> (3 * ((raw >> at) & 7))) & 7


def _lead_loop(r0, digits):
    """The plain version's lead digit: the first non-zero rotated digit."""
    for d in digits:
        rd = _rot(r0, d)
        if rd != 0:
            return rd
    return 0


def _packed(digits):
    return sum(d << (3 * (15 - r)) for r, d in enumerate(digits, 1))


def test_lead_digit_shortcut_equals_the_loop():
    import itertools
    rng = np.random.default_rng(0)
    cases = [list(c) for k in range(5)
             for c in itertools.product(range(7), repeat=k)]
    cases += [list(rng.integers(0, 7, rng.integers(5, 16)))
              for _ in range(3000)]
    # long runs of zeros before the lead, and the digit 7 no lattice
    # point makes but the clamped tables map
    cases += [[0] * k + [d] + list(rng.integers(0, 8, 14 - k))
              for k in range(15) for d in range(8)]
    cases += [list(rng.integers(0, 8, rng.integers(1, 16)))
              for _ in range(3000)]
    for r0 in range(oc.ROTATIONS):
        for digits in cases:
            digits = [int(d) for d in digits]
            assert _lead_shortcut(r0, _packed(digits)) == \
                _lead_loop(r0, digits), (r0, digits)


def _round_div7_kernel(p):
    """csrc/h3_cell.cu round_div7 in numpy: int32 wrap, arithmetic shift,
    the biased unsigned division by 7."""
    x = (2 * p.astype(np.int64) + 7).astype(np.uint32).view(np.int32)
    y = (x >> 1).astype(np.int32)
    u = (y.view(np.uint32).astype(np.uint64) + 0x70000000) % (1 << 32)
    return ((u // 7).astype(np.int64) - 0x10000000).astype(np.int32)


def test_kernel_round_div7_is_floor_on_all_int32():
    rng = np.random.default_rng(1)
    p = np.concatenate([
        np.arange(-5000, 5001), rng.integers(-2 ** 31, 2 ** 31, 200_000),
        [-2 ** 31, -2 ** 31 + 1, 2 ** 31 - 1, 2 ** 30, -2 ** 30,
         2 ** 30 - 4, -2 ** 30 - 4]]).astype(np.int32)
    want = round_div7(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(_round_div7_kernel(p), want)


def _cell_from_lattice_kernel(face, a, b, res):
    """csrc/h3_cell.cu's integer cell step in numpy on the packed tables
    (cell_words): aggregation with the kernel's round_div7, the raw
    digits packed, the entry word, the lead-digit shortcut, one composed
    rotation word per point."""
    words = oc.cell_words()
    ent = words[:oc.N_ENTRIES].astype(np.int64)
    rotw = words[oc.N_ENTRIES:].view(np.uint32).astype(np.int64)
    dod = oc.digit_of_diff_word()
    ai, bi = a.astype(np.int32), b.astype(np.int32)
    raw = np.zeros(len(a), np.int64)
    for rv in range(res, 0, -1):
        if rv % 2 == 0:
            ua = _round_div7_kernel(2 * ai + bi)
            ub = _round_div7_kernel(3 * bi - ai)
            ca, cb = 3 * ua - ub, ua + 2 * ub
        else:
            ua = _round_div7_kernel(3 * ai - bi)
            ub = _round_div7_kernel(ai + 2 * bi)
            ca, cb = 2 * ua + ub, -ua + 3 * ub
        at = np.clip((ai - ca + 1) * 3 + (bi - cb + 1), 0, 8)
        raw |= ((dod >> (3 * at)) & 7).astype(np.int64) << (3 * (15 - rv))
        ai, bi = ua, ub
    mn = np.minimum(np.minimum(ai, bi), 0)
    entry = ((face * 3 + (ai - mn)) * 3 + (bi - mn)) * 3 - mn
    w = ent[np.clip(entry, 0, oc.N_ENTRIES - 1)]
    base, r0, pent = w & 127, (w >> 7) & 7, (w >> 13) & 1 == 1
    lead = np.array([_lead_shortcut(int(r), int(v)) for r, v in zip(r0, raw)])
    seam_hit = pent & (lead != 0) & (lead == ((w >> 14) & 7))
    extra = np.where(seam_hit, (w >> 10) & 7, 0)
    lead_f = (rotw[extra * 2] >> (3 * lead)) & 7
    relabel = (pent & ((lead_f == 1) | (lead_f == 5))).astype(np.int64)
    rot = rotw[(r0 * 6 + extra) * 2 + relabel]
    h = (1 << 59) | (res << 52) | digit_fill(res) | (base << 45)
    for rv in range(1, res + 1):
        d = (raw >> (3 * (15 - rv))) & 7
        h = h | (((rot >> (3 * d)) & 7) << (3 * (15 - rv)))
    return h


@pytest.mark.parametrize("res", range(16))
def test_kernel_cell_step_on_packed_tables_equals_plain(res):
    pts = global_points(2000, seed=50 + res)
    face, hex2d = hm.project_lattice(np.radians(pts[:, ::-1]), res)
    ijk = hm.hex2d_to_ijk(hex2d)
    a, b = ijk[:, 0] - ijk[:, 2], ijk[:, 1] - ijk[:, 2]
    want = cell_from_lattice_ref(torch.from_numpy(face.astype(np.int32)),
                                 torch.from_numpy(a.astype(np.int32)),
                                 torch.from_numpy(b.astype(np.int32)), res)
    got = _cell_from_lattice_kernel(face.astype(np.int64), a, b, res)
    np.testing.assert_array_equal(got, want.numpy())
    base = (got >> 45) & 0x7F
    assert np.any(tables().is_pentagon[base])


def test_wrapper_runs_plain_on_cpu_and_rejects():
    pts = torch.from_numpy(global_points(1000, seed=9).astype(np.float32))
    before = latlng_to_cell_margin.launches
    c, m = latlng_to_cell_margin(pts, 7)
    assert latlng_to_cell_margin.launches == before
    c2, m2 = latlng_to_cell_margin_ref(pts, 7)
    assert torch.equal(c, c2) and torch.equal(m, m2)
    with pytest.raises(ValueError, match="resolution"):
        latlng_to_cell_margin(pts, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        latlng_to_cell_margin(pts.to("meta"), 7)
    with pytest.raises(ValueError, match="resolution"):
        get_index_system("H3").point_to_cell_torch(pts, -1)
    empty = latlng_to_cell_margin(torch.zeros((0, 2)), 3)
    assert empty[0].shape == (0,) and empty[0].dtype == torch.int64
