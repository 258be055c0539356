"""The port's boolean engine and dissolve against the JAX package.

``mosaic_tpu_torch.core.geometry.clip`` carries the JAX package's
edge-fragment boolean engine (``rings_boolean`` for the four ops,
``rings_to_array``, ``boolean_op``) and its dissolve
(``dissolve_disjoint_rings``, ``unary_union_rings``,
``LAST_DISSOLVE_REJECT``): float64 host numpy in both packages, so every
output is held bit for bit (the same rings, in the same order, with the
same coordinates; the same GeometryArray buffers; the same rejection
reason).  Cases: tests/test_clip.py's (overlapping, disjoint, contained,
shared edge, identical, a donut, empty inputs, seeded random concave
stars with holes and extra parts, the chain union),
tests/test_union_dissolve.py's (adjacent, disjoint, a 10 x 10 grid, hole
plug, kept hole, the rejections, CW input, a split mismatch, the general
union) and a seeded subset of tests/test_fuzz_boolean.py's four
coordinate regimes, where the port's areas also keep the
inclusion-exclusion identities.  ``rings_intersection`` is
``rings_boolean(..., "intersection")``; tests/test_torch_clip.py keeps
the C3 pins of the overlay's pair areas.
"""

import zlib

import numpy as np
import pytest

import mosaic_tpu as J
import mosaic_tpu_torch as T
from mosaic_tpu.core.geometry import clip as jclip
from mosaic_tpu_torch.core.geometry import clip as tclip

OPS = ["intersection", "union", "difference", "symdifference"]


def sq(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float)


def unit(x0, y0, s=1.0):
    return sq(x0, y0, x0 + s, y0 + s)


def _same_rings(j, t):
    if j is None or t is None:
        assert j is None and t is None
        return
    assert len(j) == len(t)
    for rj, rt in zip(j, t):
        assert np.array_equal(rj, rt)


def _same_array(j, t):
    for f in ("coords", "types", "geom_offsets", "part_offsets",
              "ring_offsets"):
        assert np.array_equal(np.asarray(getattr(j, f)),
                              np.asarray(getattr(t, f))), f
    assert j.srid == t.srid


def _star(cx, cy, rng, n=None):
    n = n or int(rng.integers(5, 12))
    while True:
        th = np.sort(rng.uniform(0, 2 * np.pi, n))
        gaps = np.diff(np.concatenate([th, [th[0] + 2 * np.pi]]))
        if gaps.max() < 2.6:
            break
    rad = rng.uniform(0.3, 1.5, n)
    return (np.stack([cx + rad * np.cos(th), cy + rad * np.sin(th)], -1),
            np.array([cx, cy]))


CASES = [
    ([sq(0, 0, 2, 2)], [sq(1, 1, 3, 3)]),
    ([sq(0, 0, 1, 1)], [sq(5, 5, 6, 6)]),
    ([sq(0, 0, 4, 4)], [sq(1, 1, 2, 2)]),
    ([sq(0, 0, 1, 1)], [sq(1, 0, 2, 1)]),
    ([sq(0, 0, 1, 1)], [sq(0, 0, 1, 1)]),
    ([sq(0, 0, 4, 4), sq(1, 1, 3, 3)[::-1]], [sq(2, 2, 5, 5)]),
    ([sq(0, 0, 1, 1)], []),
    ([], [sq(0, 0, 1, 1)]),
    ([], []),
]


@pytest.mark.parametrize("op", OPS)
def test_rings_boolean_cases(op):
    for A, B in CASES:
        _same_rings(jclip.rings_boolean(A, B, op),
                    tclip.rings_boolean(A, B, op))
    with pytest.raises(ValueError):
        tclip.rings_boolean(CASES[0][0], CASES[0][1], "xor")


def test_rings_boolean_known_areas():
    A, B = [sq(0, 0, 2, 2)], [sq(1, 1, 3, 3)]
    want = {"intersection": 1.0, "union": 7.0, "difference": 3.0,
            "symdifference": 6.0}
    for op, area in want.items():
        got = sum(tclip.ring_signed_area(r)
                  for r in tclip.rings_boolean(A, B, op))
        assert got == pytest.approx(area)
    assert len(tclip.rings_boolean([sq(0, 0, 4, 4)], [sq(1, 1, 2, 2)],
                                   "difference")) == 2


def test_rings_intersection_is_the_boolean_intersection():
    for A, B in CASES:
        _same_rings(tclip.rings_boolean(A, B, "intersection",
                                        tclip.SPLIT_EPS),
                    tclip.rings_intersection(A, B))


def test_random_concave_stars():
    """tests/test_clip.py's Monte Carlo inputs (40 seeded trials, holes
    every third, a far extra part every fifth): every op bit-equal."""
    rng = np.random.default_rng(42)
    for trial in range(40):
        s1, c1 = _star(rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng)
        s2, _ = _star(rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng)
        A, B = [s1], [s2]
        if trial % 3 == 1:
            A.append((c1[None] + (s1 - c1[None]) * 0.3)[::-1])
        if trial % 5 == 2:
            s3, _ = _star(rng.uniform(4.0, 5.0), rng.uniform(4.0, 5.0), rng)
            B.append(s3)
        for op in OPS:
            _same_rings(jclip.rings_boolean(A, B, op),
                        tclip.rings_boolean(A, B, op))


def test_boolean_op_and_rings_to_array():
    wa = ["POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))",
          "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 3 1, 3 3, 1 3, 1 1))",
          "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"]
    wb = ["POLYGON ((1 1, 3 1, 3 3, 1 3, 1 1))",
          "POLYGON ((2 2, 5 2, 5 5, 2 5, 2 2))",
          "POLYGON ((5 5, 6 5, 6 6, 5 6, 5 5))"]
    ja, jb = J.read_wkt(wa), J.read_wkt(wb)
    ta, tb = T.read_wkt(wa), T.read_wkt(wb)
    for op in OPS:
        _same_array(jclip.boolean_op(ja, jb, op), tclip.boolean_op(ta, tb,
                                                                   op))
    with pytest.raises(ValueError):
        tclip.boolean_op(ta, tb.take([0]), "union")
    rings = [unit(0, 0, 3), unit(1, 1)[::-1], unit(5, 5), np.zeros((2, 2))]
    _same_array(jclip.rings_to_array(rings), tclip.rings_to_array(rings))
    _same_array(jclip.rings_to_array([]), tclip.rings_to_array([]))
    assert tclip.rings_to_array([], empty_ok=False) is not None


DISSOLVE = [
    [[unit(0, 0)], [unit(1, 0)]],
    [[unit(0, 0)], [unit(3, 0)]],
    [[unit(i, j)] for i in range(10) for j in range(10)],
    [[unit(0, 0, 3), unit(1, 1)[::-1]], [unit(1, 1)]],
    [[unit(0, 0, 3), unit(1, 1)[::-1]], [unit(5, 5)]],
    [[unit(0, 0)], [unit(0, 0)]],                 # duplicated: rejected
    [[unit(0, 0, 3)], [unit(1, 1)]],              # nested: rejected
    [[unit(0, 0)[::-1]], [unit(1, 0)]],
    [[unit(0, 0)], [unit(1, 0) + np.array([[3e-7, 0], [0, 0], [0, 0],
                                           [0, 0]])]],
    [],
]


def test_dissolve_disjoint_rings():
    for parts in DISSOLVE:
        j = jclip.dissolve_disjoint_rings(parts)
        jr = jclip.LAST_DISSOLVE_REJECT
        t = tclip.dissolve_disjoint_rings(parts)
        _same_rings(j, t)
        assert tclip.LAST_DISSOLVE_REJECT == jr
    assert tclip.dissolve_disjoint_rings(DISSOLVE[5]) is None
    assert tclip.LAST_DISSOLVE_REJECT == "fully_cancelled"
    r = tclip.dissolve_disjoint_rings(DISSOLVE[2])
    assert len(r) == 1 and sum(tclip.ring_signed_area(x) for x in r) == \
        pytest.approx(100.0)


def test_dissolve_rejection_is_counted():
    from mosaic_tpu_torch.obs import metrics
    was = metrics.enabled
    metrics.enable()
    try:
        before = metrics.counter_value("dissolve_reject/fully_cancelled")
        tclip.dissolve_disjoint_rings(DISSOLVE[5])
        assert metrics.counter_value(
            "dissolve_reject/fully_cancelled") == before + 1
    finally:
        if not was:
            metrics.disable()


def test_unary_union_rings():
    cases = [
        ([[sq(i, 0, i + 1.5, 1)] for i in range(4)], False),
        ([[unit(0, 0)], [unit(0.5, 0)], [unit(5, 0)], [unit(6, 0)],
          [unit(7, 0)]], False),
        ([[unit(i, j)] for i in range(4) for j in range(3)], True),
        ([[unit(0, 0)], [unit(0, 0)], [unit(2, 0)], [unit(3, 0)],
          [unit(4, 0)]], True),                   # rejected, then folded
        ([], True),
    ]
    for parts, disjoint in cases:
        _same_rings(jclip.unary_union_rings(parts, assume_disjoint=disjoint),
                    tclip.unary_union_rings(parts,
                                            assume_disjoint=disjoint))
    out = tclip.unary_union_rings(cases[0][0])
    assert sum(tclip.ring_signed_area(r) for r in out) == \
        pytest.approx(4.5)


def _rand_poly(rng, cx, cy, r, n):
    ang = 2 * np.pi * (np.arange(n) + rng.uniform(-0.35, 0.35, n)) / n
    rad = r * rng.uniform(0.35, 1.0, n)
    ring = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)
    return np.vstack([ring, ring[:1]])


REGIMES = [("unit", 0.0, 0.0, 1.0), ("lonlat_nyc", -74.0, 40.7, 1e-3),
           ("lonlat_big", 151.2, -33.8, 0.5),
           ("offset_huge", 5000.0, -3000.0, 2.0)]


@pytest.mark.parametrize("name,cx,cy,scale", REGIMES)
def test_fuzz_subset(name, cx, cy, scale):
    """tests/test_fuzz_boolean.py's generator on 12 seeded pairs a
    regime: every op bit-equal, and union and difference tied to the
    intersection by inclusion-exclusion (within the envelope that file
    states: 1e-9 of the pair's area, 1e-6 at footprint scale)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 15)
    rel = 1e-6 if scale < 1e-2 else 1e-9
    for _ in range(12):
        dx, dy = rng.uniform(-0.8, 0.8, 2) * scale
        A = [_rand_poly(rng, cx, cy, scale, int(rng.integers(4, 12)))[:-1]]
        B = [_rand_poly(rng, cx + dx, cy + dy, scale,
                        int(rng.integers(4, 12)))[:-1]]
        got = {}
        for op in OPS:
            t = tclip.rings_boolean(A, B, op)
            _same_rings(jclip.rings_boolean(A, B, op), t)
            got[op] = sum(tclip.ring_signed_area(r)
                          for r in tclip._normalize_rings(t))
        a = abs(tclip.ring_signed_area(A[0]))
        b = abs(tclip.ring_signed_area(B[0]))
        tol = rel * (a + b)
        assert abs(got["union"] - (a + b - got["intersection"])) <= tol
        assert abs(got["difference"] - (a - got["intersection"])) <= tol
