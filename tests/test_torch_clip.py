"""Polygon boolean intersection and batched pair areas of the PyTorch
port's ``core/geometry/clip.py`` against the JAX package's.

Both packages run the same float64 numpy engine and the same native
``intersect_area_pairs`` source, so results are compared bit for bit:
``rings_intersection`` against ``rings_boolean(..., "intersection")``
ring for ring on the hand-built cases of tests/test_clip.py, and
``pairs_intersection_area`` on the pair batches of
tests/test_intersect_area.py plus a pair whose native area overflows the
kernel's split buffer (NaN) and goes through ``rings_intersection``.
Where the port repairs the JAX package's areas (touching rings, slivers,
the local frame at |lon| ~74) it is held against exact answers instead,
for box windows an exact rational clip (:func:`exact_box_area`).  The
port has no Python-engine fallback: its native library must build.
"""

from fractions import Fraction

import numpy as np
import pytest

from mosaic_tpu.core.geometry import clip as jclip
from mosaic_tpu.core.geometry.array import GeometryBuilder as JBuilder
from mosaic_tpu_torch.core.geometry import clip as tclip
from mosaic_tpu_torch.core.geometry.array import GeometryBuilder as TBuilder


def sq(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float)


def exact_box_area(box, rings) -> float:
    """area(box ∩ region) in exact rational arithmetic, rounded once: the
    even-odd region of ``rings`` (region-left oriented, holes clockwise)
    clipped ring by ring to the axis-aligned ``box`` (Sutherland-Hodgman,
    exact for a convex window), signed areas summed."""
    box = np.asarray(box, float)
    lo = [Fraction(float(v)) for v in box.min(axis=0)]
    hi = [Fraction(float(v)) for v in box.max(axis=0)]
    total = Fraction(0)
    for ring in rings:
        pts = [(Fraction(float(x)), Fraction(float(y))) for x, y in ring]
        for axis in (0, 1):
            for bound, keep in ((lo[axis], lambda v, b: v >= b),
                                (hi[axis], lambda v, b: v <= b)):
                clipped = []
                for p, q in zip(pts[-1:] + pts[:-1], pts):
                    if keep(p[axis], bound) != keep(q[axis], bound):
                        t = (bound - p[axis]) / (q[axis] - p[axis])
                        clipped.append(tuple(
                            bound if k == axis else p[k] + t * (q[k] - p[k])
                            for k in (0, 1)))
                    if keep(q[axis], bound):
                        clipped.append(q)
                pts = clipped
        total += sum(p[0] * q[1] - q[0] * p[1]
                     for p, q in zip(pts, pts[1:] + pts[:1])) / 2
    return float(total)


def comb():
    """A 100 x 1 strip against a sawtooth whose 600 edges cross the
    strip's bottom edge: more split points on one edge than the native
    kernel holds."""
    k = np.arange(601)
    saw = np.stack([k / 6.0, np.where(k % 2, 0.5, -0.5)], -1)
    return [sq(0, 0, 100, 1)], [np.vstack([saw, [[100, -2], [0, -2]]])]


# (rings A, rings B, expected intersection area or None)
CASES = {
    "overlapping": ([sq(0, 0, 2, 2)], [sq(1, 1, 3, 3)], 1.0),
    "disjoint": ([sq(0, 0, 1, 1)], [sq(5, 5, 6, 6)], 0.0),
    "contained": ([sq(0, 0, 4, 4)], [sq(1, 1, 2, 2)], 1.0),
    "shared_edge": ([sq(0, 0, 1, 1)], [sq(1, 0, 2, 1)], 0.0),
    "identical": ([sq(0, 0, 1, 1)], [sq(0, 0, 1, 1)], 1.0),
    "hole": ([sq(0, 0, 4, 4), sq(1, 1, 3, 3)[::-1]], [sq(2, 2, 5, 5)], 3.0),
    "empty_b": ([sq(0, 0, 1, 1)], [], 0.0),
    "empty_a": ([], [sq(0, 0, 1, 1)], 0.0),
    "comb": (*comb(), 12.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rings_boolean_intersection_equals_jax(name):
    ra, rb, area = CASES[name]
    got = tclip.rings_intersection(ra, rb)
    want = jclip.rings_boolean(ra, rb, "intersection")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    total = sum(tclip.ring_signed_area(r) for r in got)
    assert total == pytest.approx(area, abs=1e-9)


def _rand_poly(rng, cx, cy, r, n):
    ang = 2 * np.pi * (np.arange(n) + rng.uniform(-0.35, 0.35, n)) / n
    rad = r * rng.uniform(0.4, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)


def _arrays(rings_a, rings_b):
    """The same polygons as JAX and port GeometryArrays: (ja, jb, ta, tb);
    each entry of rings_* is (shell, holes)."""
    out = []
    for builder in (JBuilder, TBuilder):
        for rings in (rings_a, rings_b):
            b = builder()
            for shell, holes in rings:
                close = lambda r: np.vstack([r, r[:1]])  # noqa: E731
                b.add_polygon(close(shell), [close(h) for h in holes])
            out.append(b.finish())
    return out[0], out[1], out[2], out[3]


def random_pairs():
    """tests/test_intersect_area.py's batch of 120 star-shaped pairs."""
    rng = np.random.default_rng(3)
    pa, pb = [], []
    for _ in range(120):
        cx, cy = rng.uniform(-1, 1, 2)
        pa.append((_rand_poly(rng, cx, cy, 0.5, 8), []))
        pb.append((_rand_poly(rng, cx + rng.uniform(-0.3, 0.3),
                              cy + rng.uniform(-0.3, 0.3), 0.5, 7), []))
    ia = np.arange(120)
    return _arrays(pa, pb), ia, ia


def nested_and_shared():
    """A square with a hole against a box in the hole, a far box and
    itself; unit squares sharing an edge; identical squares."""
    outer = (sq(0, 0, 4, 4), [sq(1, 1, 3, 3)[::-1]])
    inner = (sq(1.5, 1.5, 2.5, 2.5), [])
    pa = [outer, outer, (sq(0, 0, 1, 1), []), (sq(0, 0, 1, 1), [])]
    pb = [inner, (sq(101.5, 101.5, 102.5, 102.5), []), (sq(1, 0, 2, 1), []),
          (sq(0, 0, 1, 1), []), outer]
    return _arrays(pa, pb), np.array([0, 1, 2, 3, 0]), \
        np.array([0, 1, 2, 3, 4])


def comb_pair():
    (ra,), (rb,) = comb()
    return _arrays([(ra, [])], [(rb, [])]), np.array([0]), np.array([0])


@pytest.mark.parametrize("case", [random_pairs, nested_and_shared,
                                  comb_pair])
def test_pairs_intersection_area_equals_jax(case):
    (ja, jb, ta, tb), ia, ib = case()
    got = tclip.pairs_intersection_area(ta, ia, tb, ib)
    want = jclip.pairs_intersection_area(ja, ia, jb, ib)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    for p in range(min(len(ia), 30)):
        rings = tclip.rings_intersection(
            tclip._normalize_rings(tclip.geometry_rings(ta, int(ia[p]))),
            tclip._normalize_rings(tclip.geometry_rings(tb, int(ib[p]))))
        exact = sum(tclip.ring_signed_area(r)
                    for r in tclip._normalize_rings(rings))
        assert got[p] == pytest.approx(exact, abs=1e-12), p
    if case is nested_and_shared:
        np.testing.assert_allclose(got, [0, 0, 0, 1, 12], atol=1e-12)


def test_pairs_intersection_area_rejects_ragged_pairs():
    (_, _, ta, tb), ia, ib = nested_and_shared()
    with pytest.raises(ValueError, match="length"):
        tclip.pairs_intersection_area(ta, ia, tb, ib[:-1])


@pytest.mark.parametrize("seed", [1, 3, 5])
def test_areas_in_a_local_frame(seed):
    """A footprint box against a 40-vertex star at lon -73.9, lat 40.7:
    the JAX package's global-frame shoelace rounds products of ~3e3 and
    misses the exact area by more than 1e-13; the port's local frame is
    exact to 1e-14 relative."""
    rng = np.random.default_rng(seed)
    star = _rand_poly(rng, -73.9, 40.7, 4e-3, 40)
    cx, cy = np.array([-73.9, 40.7]) + rng.uniform(-3e-3, 3e-3, 2)
    w, h = rng.uniform(5e-4, 2e-3, 2)
    box = sq(cx - w, cy - h, cx + w, cy + h)
    ja, jb, ta, tb = _arrays([(box, [])], [(star, [])])
    exact = exact_box_area(box, [star])
    assert exact > 1e-6
    got = tclip.pairs_intersection_area(ta, [0], tb, [0])[0]
    assert abs(got - exact) <= 1e-14 * exact
    assert np.all(tclip._frame_origin([[star], [box]]) == [-73.9, 40.7])
    theirs = jclip.pairs_intersection_area(ja, [0], jb, [0])[0]
    assert abs(theirs - exact) > 1e-13


@pytest.mark.parametrize("other, want", [
    (sq(12, 19, 15, 25), 6.0),          # covers the hole's side
    (sq(10.5, 20.5, 13.5, 23.5), 8.0),  # crosses the hole
    (sq(13, 21, 14, 23), 0.0),          # the hole itself
])
def test_hole_along_the_shell_edge(other, want):
    """A chip whose hole runs along its cell's boundary: the square
    [10, 14] x [20, 24] with the hole [13, 14] x [21, 23] on its right
    edge.  The hole's edge cancels part of the shell's, and half the
    hole's vertices lie on the shell, so nesting by vertex votes cannot
    tell its orientation.  The port's area path splits the rings at each
    other's vertices, orients each piece by the region on its two sides
    and drops the cancelled stretch, so the area is exact; the JAX
    package's raw ring edges give another answer."""
    shell = sq(10, 20, 14, 24)
    hole = sq(13, 21, 14, 23)[::-1]
    ja, jb, ta, tb = _arrays([(shell, [hole])], [(other, [])])
    got = tclip.pairs_intersection_area(ta, [0], tb, [0])
    assert got[0] == pytest.approx(want, abs=1e-12)
    rings = tclip._normalize_rings(tclip.geometry_rings(ta, 0))
    assert tclip._rings_touch(rings, 1e-9)
    edges = tclip._region_edges(rings, 1e-9)
    # the boundary of the square minus the hole, region on the left: no
    # piece on the shared stretch x = 14, 21 <= y <= 23
    x0, y0 = edges[:, 0, 0], edges[:, 0, 1]
    x1, y1 = edges[:, 1, 0], edges[:, 1, 1]
    assert 0.5 * np.sum(x0 * y1 - x1 * y0) == pytest.approx(14.0)
    assert not np.any((x0 == 14) & (x1 == 14) & (np.minimum(y0, y1) >= 21) &
                      (np.maximum(y0, y1) <= 23))
    if want:
        assert jclip.pairs_intersection_area(ja, [0], jb, [0])[0] != \
            pytest.approx(want, abs=1e-6)


#: a footprint chip that is a sliver (area 2.3e-13) along its H3 res-9
#: cell's edge, and that cell's core chip (the hexagon): footprint 13,732
#: of ``footprints(2**17)`` against taxi zone 167
SLIVER = np.array([[-73.87431417847688, 40.78577843369056],
                   [-73.87431417847688, 40.78577864038347],
                   [-73.87431472264025, 40.78577864038347]])
HEXAGON = np.array([[-73.87374211218892, 40.78903488416235],
                    [-73.87584933380526, 40.78809838069637],
                    [-73.87578440473271, 40.786336878747484],
                    [-73.87361241469402, 40.78551187844839],
                    [-73.87150526835943, 40.78644831232458],
                    [-73.87157003678135, 40.788209816086855]])


def test_sliver_along_the_cell_edge():
    """The fragment sum cannot close a sliver whose edges lie within the
    kernel's eps of the other chip's boundary: the JAX package returns
    an area of -3.5e-6 for a chip of area 2.3e-13.  The port sends every
    pair whose kernel area leaves [0, min(area A, area B)] through the
    boolean engine."""
    ja, jb, ta, tb = _arrays([(SLIVER, [])], [(HEXAGON[::-1], [])])
    sliver = tclip.ring_signed_area(SLIVER)
    assert 0 < abs(sliver) < 1e-12
    got = tclip.pairs_intersection_area(ta, [0], tb, [0])
    assert -1e-12 <= got[0] <= abs(sliver) + 1e-12
    assert jclip.pairs_intersection_area(ja, [0], jb, [0])[0] < -1e-9


#: taxi zone 161 of ``taxi_zones(16)`` and footprint 82,792 of
#: ``footprints(2**17)``, which overlap in a sliver along the zone's edge
ZONE_161 = np.array([
    [-73.8992916663877, 40.60038916222153],
    [-73.88934940981076, 40.60513076079749],
    [-73.87989038111401, 40.6107750498591],
    [-73.87029083309072, 40.603562783219644],
    [-73.85847631641676, 40.60570411647028],
    [-73.84915007381633, 40.61114077053174],
    [-73.8457865075046, 40.621398569033005],
    [-73.84584673462078, 40.631493136073466],
    [-73.84538884164172, 40.641577492525904],
    [-73.85950642905054, 40.6353556626436],
    [-73.8743193221383, 40.63966792883445],
    [-73.88836968313244, 40.633038033709965],
    [-73.90323545153022, 40.63755213199979],
    [-73.90268067671838, 40.62810749627487],
    [-73.9037480757165, 40.61870698679682],
    [-73.9006969564751, 40.60974827536724]])
FOOTPRINT_82792 = sq(-73.89475744464885, 40.634976248503804,
                     -73.89121040901237, 40.63708510782678)


def test_sliver_overlap_of_whole_polygons():
    """A footprint box that overlaps a zone in a sliver of exact area
    3.58e-12: the boolean engine's sliver filter (area under 8e-9 |x| x
    perimeter) returns no ring, the JAX package's global-frame fragment
    sum misses by 1.7e-13, and the port's local-frame sum is exact to
    1e-18."""
    exact = exact_box_area(FOOTPRINT_82792, [ZONE_161])
    assert 3.5e-12 < exact < 3.7e-12
    assert tclip.rings_intersection([FOOTPRINT_82792], [ZONE_161]) == []
    ja, jb, ta, tb = _arrays([(FOOTPRINT_82792, [])], [(ZONE_161, [])])
    got = tclip.pairs_intersection_area(ta, [0], tb, [0])[0]
    assert abs(got - exact) < 1e-18
    theirs = jclip.pairs_intersection_area(ja, [0], jb, [0])[0]
    assert abs(theirs - exact) > 1e-13
