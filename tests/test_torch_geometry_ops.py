"""The port's geometry operations, triangulation, CRS transforms and
resolution analyzer against the JAX package.

``ops.py``, ``triangulate.py``, ``crs.py`` (with its own
``epsg_params.npz`` and ``epsg_bounds.npz``) and ``analyzer.py`` are
copies of the JAX package's pure-numpy modules, ``ops`` over the port's
boolean engine.  Every output is held bit for bit against the JAX
package's on the same inputs: tests/test_hard_ops.py's cases (polygon,
negative, point and line buffers with each cap style, the buffer loop's
ring, Douglas-Peucker on a collinear ring and a noisy circle, convex and
concave hulls, validity of a donut, a bowtie and a hole crossing its
shell, Delaunay, conforming Delaunay with a constraint, barycentric z);
CRS transforms both ways for three codes of every projection method of
tests/test_crs_families.py's table (15 methods), the UTM, Web Mercator
and British National Grid routes, ``crs_bounds``,
``has_valid_coordinates`` and ``epsg_from_name``; and the analyzer's
resolution and report on H3 and CUSTOM grids.  The port's own checks
ride along: known areas, round-trip closure below 5e-7 degrees (on at
least 85% of the family codes, as the JAX package closes), and the
``mosaic.crs.strict.datum`` key raising where a code has no Helmert
parameters.
"""

import numpy as np
import pytest

import mosaic_tpu as J
import mosaic_tpu_torch as T
from mosaic_tpu import analyzer as janalyzer
from mosaic_tpu import config as jconfig
from mosaic_tpu.core.geometry import crs as jcrs
from mosaic_tpu.core.geometry import ops as jops
from mosaic_tpu.core.geometry import triangulate as jtri
from mosaic_tpu_torch import analyzer as tanalyzer
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.core.geometry import clip as tclip
from mosaic_tpu_torch.core.geometry import crs as tcrs
from mosaic_tpu_torch.core.geometry import ops as tops
from mosaic_tpu_torch.core.geometry import triangulate as ttri


def _same_array(j, t):
    for f in ("coords", "types", "geom_offsets", "part_offsets",
              "ring_offsets"):
        assert np.array_equal(np.asarray(getattr(j, f)),
                              np.asarray(getattr(t, f))), f


def _same(j, t):
    if isinstance(j, tuple):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same(a, b)
        return
    assert np.array_equal(np.asarray(j), np.asarray(t), equal_nan=True)


def _area(arr, i=0):
    return sum(tclip.ring_signed_area(r) for r in
               tclip._normalize_rings(tclip.geometry_rings(arr, i)))


BUFFERS = [
    ("POLYGON((0 0, 10 0, 10 10, 0 10, 0 0))", 1.0, "round"),
    ("POLYGON((0 0, 10 0, 10 10, 0 10, 0 0))", -1.0, "round"),
    ("POINT(3 3)", 2.0, "round"),
    ("POINT(3 3)", 2.0, "square"),
    ("LINESTRING(0 0, 10 0)", 1.0, "round"),
    ("LINESTRING(0 0, 10 0)", 1.0, "flat"),
    ("LINESTRING(0 0, 10 0)", 1.0, "square"),
    ("POLYGON((1 1, 9 1, 9 5, 5 5, 5 9, 1 9, 1 1))", 0.5, "round"),
    ("POLYGON((2 2, 8 2, 8 8, 2 8, 2 2))", 0.5, "round"),
    ("POLYGON((2 2, 8 2, 8 8, 2 8, 2 2))", 1.0, "round"),
]


@pytest.mark.parametrize("wkt,r,cap", BUFFERS)
def test_buffer_equal(wkt, r, cap):
    j = jops.buffer_geometry(J.read_wkt([wkt]), r, cap_style=cap)
    t = tops.buffer_geometry(T.read_wkt([wkt]), r, cap_style=cap)
    _same_array(j, t)


def test_buffer_known_areas():
    sq = T.read_wkt(["POLYGON((0 0, 10 0, 10 10, 0 10, 0 0))"])
    assert _area(tops.buffer_geometry(sq, 1.0)) == \
        pytest.approx(100 + 40 + np.pi, rel=1e-2)
    assert _area(tops.buffer_geometry(sq, -1.0)) == \
        pytest.approx(64.0, rel=1e-2)
    line = T.read_wkt(["LINESTRING(0 0, 10 0)"])
    assert _area(tops.buffer_geometry(line, 1.0, cap_style="flat")) == \
        pytest.approx(20.0, rel=1e-6)


def test_simplify_equal():
    r = np.array([[0, 0], [1, 0], [2, 0], [3, 0], [3, 3], [0, 3]], float)
    _same(jops.simplify_ring(r, 1e-9, closed=True),
          tops.simplify_ring(r, 1e-9, closed=True))
    assert len(tops.simplify_ring(r, 1e-9, closed=True)) == 4
    rng = np.random.default_rng(42)
    th = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    ring = np.stack([5 + 3 * np.cos(th) + rng.normal(0, .05, 100),
                     5 + 3 * np.sin(th) + rng.normal(0, .05, 100)], -1)
    wkt = "POLYGON((" + ", ".join(
        f"{x!r} {y!r}" for x, y in np.vstack([ring, ring[:1]]).tolist()) + \
        "))"
    lines = "LINESTRING (0 0, 1 0.01, 2 0, 3 0.5, 4 0)"
    for tol in (0.05, 0.5):
        _same_array(jops.simplify_geometry(J.read_wkt([wkt, lines]), tol),
                    tops.simplify_geometry(T.read_wkt([wkt, lines]), tol))


def test_hulls_equal():
    pts = np.vstack([np.random.default_rng(0).uniform(0, 1, (100, 2)),
                     [[0, 0], [1, 0], [1, 1], [0, 1]]])
    _same(jops.convex_hull_points(pts), tops.convex_hull_points(pts))
    assert tclip.ring_signed_area(tops.convex_hull_points(pts)) == \
        pytest.approx(1.0, rel=1e-9)
    rng = np.random.default_rng(42)
    th = np.linspace(0.3, 2 * np.pi - 0.3, 200)
    c = np.stack([np.cos(th), np.sin(th)], -1) * \
        rng.uniform(0.7, 1.0, (200, 1))
    _same(jtri.concave_hull_points(c, 0.2), ttri.concave_hull_points(c, 0.2))
    assert abs(tclip.ring_signed_area(ttri.concave_hull_points(c, 0.2))) < \
        abs(tclip.ring_signed_area(tops.convex_hull_points(c)))


def test_validity_equal():
    shell = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], float)
    cases = [
        [shell, np.array([[1, 1], [2, 1], [2, 2], [1, 2]], float)[::-1]],
        [np.array([[0, 0], [2, 2], [2, 0], [0, 2]], float)],
        [shell, np.array([[3, 3], [6, 3], [6, 6], [3, 6]], float)[::-1]],
    ]
    got = [tops.is_valid_rings(c) for c in cases]
    assert got == [jops.is_valid_rings(c) for c in cases]
    assert got == [True, False, False]


def test_triangulation_equal():
    rng = np.random.default_rng(42)
    pts = rng.uniform(0, 10, (60, 2))
    _same(jtri.delaunay(pts), ttri.delaunay(pts))
    verts, tri = ttri.delaunay(pts)
    total = sum(abs(tclip.ring_signed_area(verts[t])) for t in tri)
    assert total == pytest.approx(
        abs(tclip.ring_signed_area(tops.convex_hull_points(pts))), rel=1e-9)
    seg = np.array([[[1.0, 1.0], [9.0, 9.0]]])
    _same(jtri.conforming_delaunay(pts[:40], seg),
          ttri.conforming_delaunay(pts[:40], seg))
    xy = rng.uniform(0, 10, (50, 2))
    v, tr = ttri.delaunay(xy)
    zv = 2 * v[:, 0] + 3 * v[:, 1] + 1
    q = rng.uniform(2, 8, (30, 2))
    got = ttri.interpolate_z(v, zv, tr, q)
    _same(jtri.interpolate_z(v, zv, tr, q), got)
    np.testing.assert_allclose(got, 2 * q[:, 0] + 3 * q[:, 1] + 1,
                               rtol=1e-9)
    _same(jtri.convexish(pts), ttri.convexish(pts))


def _family_codes():
    """Three codes (first, middle, last) of every projection method in
    the EPSG parameter table."""
    t = tcrs._proj_table()
    out = []
    for m in np.unique(t["method"]):
        codes = t["epsg"][t["method"] == m]
        out += sorted({int(codes[0]), int(codes[len(codes) // 2]),
                       int(codes[-1])})
    return out


def test_npz_tables_are_the_ports_own_and_equal():
    import os
    for name in ("epsg_params.npz", "epsg_bounds.npz"):
        path = os.path.join(os.path.dirname(tcrs.__file__), name)
        assert os.path.exists(path)
        with open(path, "rb") as f, open(os.path.join(
                os.path.dirname(jcrs.__file__), name), "rb") as g:
            assert f.read() == g.read()
    t, j = tcrs._proj_table(), jcrs._proj_table()
    assert sorted(t) == sorted(j)
    assert len(np.unique(t["method"])) == 15


def test_crs_families_round_trip_equal():
    rng = np.random.default_rng(5)
    codes = _family_codes()
    assert len(codes) >= 40
    closed = 0
    for c in codes:
        p = tcrs._proj_entry(c)
        lat0 = p["sp1"] if p["method"] == 9829 else p["lat0"]
        if p["method"] in (9810, 9829, 9812) and abs(lat0) == 90:
            lat0 = 89.0 * np.sign(lat0)
        ll = np.stack([p["lon0"] + rng.uniform(-1, 1, 8),
                       np.clip(lat0 + rng.uniform(-1, 1, 8), -89, 89)], -1)
        with np.errstate(all="ignore"):
            fwd_t = tcrs.transform_xy(ll, 4326, c)
            back_t = tcrs.transform_xy(fwd_t, c, 4326)
            _same(jcrs.transform_xy(ll, 4326, c), fwd_t)
            _same(jcrs.transform_xy(fwd_t, c, 4326), back_t)
        # as in the JAX package, a few codes' samples lie off their
        # domain (NaN) or close coarsely (a Cassini code in links)
        closed += bool(np.isfinite(back_t).all() and
                       np.abs(back_t - ll).max() < 5e-7)
    assert closed >= 0.85 * len(codes), (closed, len(codes))


def test_crs_routes_and_bounds_equal():
    rng = np.random.default_rng(7)
    ll = np.stack([rng.uniform(-5, 1, 50), rng.uniform(50, 58, 50)], -1)
    nyc = np.stack([rng.uniform(-75, -73, 50), rng.uniform(40, 41.5, 50)],
                   -1)
    for epsg, ll in ((3857, ll), (27700, ll), (32630, ll), (32618, nyc),
                     (32718, nyc * [1, -1])):
        fwd = tcrs.transform_xy(ll, 4326, epsg)
        _same(jcrs.transform_xy(ll, 4326, epsg), fwd)
        _same(jcrs.transform_xy(fwd, epsg, 4326),
              tcrs.transform_xy(fwd, epsg, 4326))
        assert np.abs(tcrs.transform_xy(fwd, epsg, 4326) - ll).max() < 1e-6
    en = tcrs.transform_xy(np.array([[-0.1276, 51.5072]]), 4326, 27700)
    assert en[0] == pytest.approx([530042, 180358], abs=60)
    for code in (4326, 3857, 27700, 32618, 2263, 2154, 3035):
        for rep in (True, False):
            assert tcrs.crs_bounds(code, rep) == jcrs.crs_bounds(code, rep)
    xy = np.array([[0.0, 51.0], [3.0, 51.0]])
    assert tcrs.has_valid_coordinates(xy, 27700).tolist() == [True, False]
    assert tcrs.epsg_from_name("OSGB 1936 / British National Grid") == \
        jcrs.epsg_from_name("OSGB 1936 / British National Grid")
    with pytest.raises(ValueError, match="EPSG"):
        tcrs.transform_xy(np.zeros((1, 2)), 4326, 999999)


def test_strict_datum_key():
    t = tcrs._proj_table()
    nan_codes = t["epsg"][np.isnan(t["helmert_acc"])]
    code = int(nan_codes[0])
    p = tcrs._proj_entry(code)
    prev = tconfig.default_config()
    try:
        tconfig.set_default_config(tconfig.apply_conf(
            prev, "mosaic.crs.strict.datum", "true"))
        with pytest.raises(ValueError, match="Helmert"):
            tcrs._check_datum_registry(p, code)
    finally:
        tconfig.set_default_config(prev)
    assert jconfig.MosaicConfig().crs_strict_datum is False


@pytest.mark.parametrize("grid_name", ["H3", "CUSTOM(-180,180,-90,90,2,64,32)"])
def test_analyzer_equal(grid_name):
    wkts = ["POLYGON ((-74.02 40.70, -73.95 40.70, -73.95 40.76, "
            "-74.02 40.76, -74.02 40.70))",
            "POLYGON ((-73.95 40.70, -73.90 40.71, -73.91 40.76, "
            "-73.95 40.76, -73.95 40.70))"]
    jg = J.get_index_system(grid_name)
    tg = T.get_index_system(grid_name)
    j = janalyzer.get_optimal_resolution(J.read_wkt(wkts), jg)
    t = tanalyzer.get_optimal_resolution(T.read_wkt(wkts), tg)
    assert j == t
    jr = janalyzer.optimal_resolution_report(J.read_wkt(wkts), jg)
    tr = tanalyzer.optimal_resolution_report(T.read_wkt(wkts), tg)
    assert jr == tr
    with pytest.raises(ValueError, match="areal"):
        tanalyzer.get_optimal_resolution(T.read_wkt(["POINT (1 2)"]), tg)
