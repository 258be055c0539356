"""The port's function surface (``mosaic_tpu_torch.functions``) against
the JAX package's.

* The registry: the same 179 names in the same groups as
  ``mosaic_tpu.functions.registry.REGISTRY``.
* tests/test_functions_api.py's cases and tests/test_realdata.py's
  ``test_ingest_real_zones``/``test_tessellate_real_zones``, each run
  through both contexts, every intermediate result compared.
* One case per registered name outside the raster surface
  (tests/test_torch_functions_raster.py holds the ``rst_*`` names): the
  function called once through ``ctx.call`` in both packages on one
  small fixture, the results compared.
* The host-plane cases that waited for the surface (tests/test_trace.py's
  ``call`` spans), the grid conf keys ``enable_mosaic()`` reads, and the
  C14 pin: ``build`` installs no compile listener.

Tolerances: bit-equal (geometry buffers, ids, booleans, bytes and text)
except where the JAX body sums floats on the device in its own order:
``st_area``, ``st_length``/``st_perimeter``, ``st_centroid``,
``st_distance`` and ``st_haversine`` within 1e-12 of the row's sum of
|terms| (the shoelace's |ax by| + |ay bx|, the edge lengths, the
coordinates' magnitude for a distance), as tests/test_torch_measures.py
holds the measures.  The port runs on the CPU (``device="cpu"``), where
every kernel wrapper runs its plain version.  The JAX package's
tessellation runs on its numpy branches, which the port copies (ROADMAP
C4).
"""

import json
import os
import sys

import numpy as np
import pytest

import mosaic_tpu as J
import mosaic_tpu.core.tessellate as jtess_module
import mosaic_tpu_torch as T
from mosaic_tpu import config as jconfig
from mosaic_tpu import types as jtypes
from mosaic_tpu.functions.context import MosaicContext as JContext
from mosaic_tpu.functions.registry import REGISTRY as JREGISTRY
from mosaic_tpu.obs import tracer as jtracer
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch import types as ttypes
from mosaic_tpu_torch.core.geometry.padded import build_edges_np
from mosaic_tpu_torch.functions.context import MosaicContext as TContext
from mosaic_tpu_torch.functions.registry import REGISTRY as TREGISTRY
from mosaic_tpu_torch.obs import tracer as ttracer

CPU = "cpu"
DATA = os.path.join(os.path.dirname(__file__), "data")
CUSTOM = "CUSTOM(0,16,0,16,2,1,1)"


@pytest.fixture(autouse=True)
def jax_numpy_branches(monkeypatch):
    """The JAX package's tessellation on its numpy branches, which the
    port copies (its jitted f64 branch differs from them: ROADMAP C4)."""
    monkeypatch.setattr(jtess_module, "_f64_jit_enabled",
                        lambda disable_env=None: False)


@pytest.fixture(autouse=True)
def restore_configs():
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)


# ---------------------------------------------------------- comparing

def same_array(j, t, coord_tol=None):
    """Equal geometry buffers; coords within ``coord_tol`` when given."""
    for f in ("types", "geom_offsets", "part_offsets", "ring_offsets"):
        assert np.array_equal(np.asarray(getattr(j, f)),
                              np.asarray(getattr(t, f))), f
    if coord_tol is None:
        assert np.array_equal(j.coords, t.coords, equal_nan=True)
    else:
        assert np.all(np.abs(j.coords - t.coords) <= coord_tol)
    pj, pt = j.part_types, t.part_types
    assert (pj is None) == (pt is None)
    if pj is not None:
        assert np.array_equal(np.asarray(pj), np.asarray(pt))
    assert j.ndim == t.ndim and j.srid == t.srid


def same(j, t, tol=None):
    """Recursive equality of two packages' results (``tol``: an absolute
    bound for float arrays and point coordinates)."""
    if hasattr(t, "geom_offsets"):
        return same_array(j, t, tol)
    if hasattr(t, "cell_id") and hasattr(t, "is_core"):
        for f in ("geom_id", "cell_id", "is_core"):
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        return same_array(j.geoms, t.geoms, tol)
    if hasattr(t, "gt") and hasattr(t, "data"):
        assert np.array_equal(np.asarray(j.data), np.asarray(t.data),
                              equal_nan=True)
        assert np.asarray(j.data).dtype == np.asarray(t.data).dtype
        assert j.gt.to_tuple() == t.gt.to_tuple()
        assert np.array_equal(np.asarray(j.nodata, float),
                              np.asarray(t.nodata, float), equal_nan=True)
        assert j.srid == t.srid and j.meta == t.meta
        assert j.cell_id == t.cell_id
        return
    if isinstance(t, dict):
        assert list(j) == list(t)
        for k in t:
            same(j[k], t[k], tol)
        return
    if isinstance(t, (list, tuple)):
        assert type(j) is type(t) and len(j) == len(t)
        for a, b in zip(j, t):
            same(a, b, tol)
        return
    if isinstance(t, (bytes, str, bool, type(None))):
        assert j == t
        return
    ja, ta = np.asarray(j), np.asarray(t)
    assert ja.shape == ta.shape and ja.dtype == ta.dtype, \
        (ja.shape, ta.shape, ja.dtype, ta.dtype)
    if tol is None or ta.dtype.kind != "f":
        assert np.array_equal(ja, ta, equal_nan=True)
    else:
        assert np.all((np.abs(ja - ta) <= tol) |
                      (np.isnan(ja) & np.isnan(ta)))


def area_terms(g) -> float:
    """1e-12 x the largest row's sum of |terms| of the shoelace, the
    edge lengths and the coordinates' magnitude."""
    A, B, M = build_edges_np(g)
    cross = np.abs(A[..., 0] * B[..., 1]) + np.abs(A[..., 1] * B[..., 0])
    lens = np.hypot(*(B - A).transpose(2, 0, 1))
    s = np.where(M, cross + lens + np.abs(A).max(-1), 0.0).sum(-1)
    return 1e-12 * float(s.max() + np.abs(g.coords).max())


def run_both(body, jctx, tctx):
    """``body(ctx, pkg)`` through both contexts: results equal, the
    port's returned."""
    j, t = body(jctx, J), body(tctx, T)
    same(j, t)
    return t


# ------------------------------------------------------------ registry

def test_registry_equal_by_name_and_group():
    assert len(TREGISTRY) == len(JREGISTRY) == 179
    assert {n: i.group for n, i in TREGISTRY.items()} == \
        {n: i.group for n, i in JREGISTRY.items()}
    groups = {}
    for i in TREGISTRY.values():
        groups[i.group] = groups.get(i.group, 0) + 1
    assert groups == {"raster": 69, "geometry": 62, "grid": 25,
                      "aggregator": 12, "format": 7, "legacy": 4}
    tctx = TContext("H3", device=CPU)
    assert tctx.function_names() == sorted(JREGISTRY)
    assert tctx.function_names("grid") == \
        JContext.build("H3").function_names("grid")


def test_docstrings_applied():
    for name in ("st_aswkt", "st_astext", "rst_srid", "convert_to_wkb"):
        assert TREGISTRY[name].usage == JREGISTRY[name].usage != ""


# ------------------------------------------- tests/test_functions_api

@pytest.fixture(scope="module")
def ctxs():
    return JContext.build(CUSTOM), TContext(CUSTOM, device=CPU)


def test_enable_and_context():
    from mosaic_tpu_torch.functions.context import MosaicContext
    c1 = T.enable_mosaic(CUSTOM, device=CPU)
    assert MosaicContext.context() is c1 and c1.device.type == "cpu"
    c2 = T.enable_mosaic(CUSTOM, device=CPU)
    assert MosaicContext.context() is c2
    assert tconfig.default_config().index_system == \
        jconfig.MosaicConfig(index_system=c2.index_system.name).index_system
    assert c2.geometry_api == "JAX"


def test_context_without_cuda_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TContext("H3")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.enable_mosaic("H3")


def test_constructors(ctxs):
    def body(ctx, P):
        g = ctx.st_point([1.0, 2.0], [3.0, 4.0])
        g2 = ctx.st_geomfromwkt(["POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"])
        blobs = ctx.st_aswkb(g2)
        js = ctx.st_asgeojson(g2)
        return [g, ctx.st_aswkt(g), ctx.st_geometrytype(g2), blobs,
                ctx.st_geomfromwkb(blobs), js, ctx.st_geomfromgeojson(js)]
    g, wkt, gt, _, g3, _, g4 = run_both(body, *ctxs)
    assert len(g) == 2 and wkt[0] == "POINT (1 3)" and gt == ["POLYGON"]
    assert np.allclose(g3.coords, g4.coords)


def test_measures(ctxs):
    def body(ctx, P):
        g = ctx.st_geomfromwkt(["POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))"])
        env = ctx.st_envelope(ctx.st_geomfromwkt(["LINESTRING (1 2, 5 7)"]))
        c = ctx.st_centroid(g)
        return [ctx.st_area(g), ctx.st_perimeter(g), ctx.st_xmin(g),
                ctx.st_xmax(g), ctx.st_numpoints(g), ctx.st_dimension(g),
                c, ctx.st_x(c), ctx.st_area(env)]
    area, per, xmin, xmax, npts, dim, _, cx, env_area = run_both(body,
                                                                 *ctxs)
    assert area[0] == pytest.approx(16.0) and per[0] == pytest.approx(16.0)
    assert xmin[0] == 0 and xmax[0] == 4 and npts[0] == 5 and dim[0] == 2
    assert cx[0] == pytest.approx(2.0) and env_area[0] == pytest.approx(20.0)


def test_predicates_and_distance(ctxs):
    def body(ctx, P):
        polys = ctx.st_geomfromwkt(["POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))"])
        pts = ctx.st_point([2.0], [2.0])
        a = ctx.st_geomfromwkt(["POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))"])
        b = ctx.st_geomfromwkt(["POLYGON ((2 2, 6 2, 6 6, 2 6, 2 2))"])
        return [ctx.st_contains(polys, pts), ctx.st_within(pts, polys),
                ctx.st_distance(ctx.st_point([6.0], [2.0]), polys),
                ctx.st_distance(pts, polys), ctx.st_intersects(a, b)]
    con, wit, d, d0, inter = run_both(body, *ctxs)
    assert con[0] and wit[0] and d[0] == pytest.approx(2.0)
    assert d0[0] == 0.0 and inter[0]


def test_affine(ctxs):
    def body(ctx, P):
        g = ctx.st_point([1.0], [2.0])
        t, s, r = (ctx.st_translate(g, 10, 20), ctx.st_scale(g, 2, 3),
                   ctx.st_rotate(g, np.pi / 2))
        return [ctx.st_x(t), ctx.st_y(t), ctx.st_x(s), ctx.st_y(s),
                ctx.st_x(r), ctx.st_y(r)]
    tx, ty, sx, sy, rx, ry = run_both(body, *ctxs)
    assert tx[0] == 11 and ty[0] == 22 and sx[0] == 2 and sy[0] == 6
    assert rx[0] == pytest.approx(-2.0) and ry[0] == pytest.approx(1.0)


def test_dump(ctxs):
    def body(ctx, P):
        d = ctx.st_dump(ctx.st_geomfromwkt(
            ["MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)), "
             "((5 5, 6 5, 6 6, 5 6, 5 5)))"]))
        return [d, ctx.st_geometrytype(d)]
    d, types = run_both(body, *ctxs)
    assert len(d) == 2 and types == ["POLYGON", "POLYGON"]


def test_grid_functions(ctxs):
    def body(ctx, P):
        cells = ctx.grid_longlatascellid([1.5, 2.5], [3.5, 4.5], 0)
        pts = ctx.st_point([1.5], [3.5])
        b = ctx.grid_boundary(cells)
        g = ctx.st_geomfromwkt(["POLYGON ((1.2 1.2, 3.2 1.2, 3.2 3.2, "
                                "1.2 3.2, 1.2 1.2))"])
        s = ctx.grid_cellid_to_string(cells)
        return [cells, ctx.grid_pointascellid(pts, 0), b, ctx.st_area(b),
                ctx.grid_boundaryaswkb(cells), ctx.grid_cellarea(cells),
                ctx.grid_cellkringexplode(cells, 1),
                ctx.grid_polyfill(g, 0), ctx.grid_tessellate(g, 0),
                ctx.grid_geometrykring(g, 0, 1),
                ctx.grid_polyfill_union(g, 0),
                ctx.grid_geometrykloop(g, 0, 1), s,
                ctx.grid_cellid_from_string(s)]
    (cells, pcell, _, area, wkbs, carea, (src, _), pf, chips, kr, pu, kl,
     _, back) = run_both(body, *ctxs)
    assert len(cells) == 2 and pcell[0] == cells[0]
    assert area[0] == pytest.approx(1.0) and len(wkbs) == 2
    assert carea[0] == pytest.approx(1.0) and set(src.tolist()) == {0, 1}
    assert len(pf[0]) == 4 and len(chips) > 4
    assert len(kr[0]) > len(pu[0])
    assert len(np.intersect1d(kl[0], pu[0])) == 0
    assert np.array_equal(back, cells)


def test_multipoint_multicell_chips(ctxs):
    def body(ctx, P):
        return ctx.grid_tessellate(ctx.st_geomfromwkt(
            ["MULTIPOINT ((3.1 3.1), (3.2 3.2), (9.5 9.5))"]), 0)
    chips = run_both(body, *ctxs)
    assert len(chips) == 2
    assert sorted(chips.geoms.vertex_counts().tolist()) == [1, 2]


def test_hole_inside_single_cell_not_core(ctxs):
    from mosaic_tpu_torch.core.tessellate import _pip, _poly_edges

    def body(ctx, P):
        return ctx.grid_tessellate(ctx.st_geomfromwkt([
            "POLYGON ((0.5 0.5, 7.5 0.5, 7.5 7.5, 0.5 7.5, 0.5 0.5),"
            " (4.3 4.3, 4.7 4.3, 4.7 4.7, 4.3 4.7, 4.3 4.3))"]), 0)
    chips = run_both(body, *ctxs)
    cell = ctxs[1].index_system.point_to_cell(np.array([[4.5, 4.5]]), 0)[0]
    k = np.nonzero(chips.cell_id == cell)[0]
    assert len(k) == 1 and not chips.is_core[k[0]]
    e = _poly_edges(chips.geoms, int(k[0]))
    assert not _pip(np.array([[4.5, 4.5]]), e)[0]
    assert _pip(np.array([[4.1, 4.1]]), e)[0]


def test_multipolygon_part_inside_cell(ctxs):
    from mosaic_tpu_torch.core.tessellate import _pip, _poly_edges

    def body(ctx, P):
        return ctx.grid_tessellate(ctx.st_geomfromwkt([
            "MULTIPOLYGON (((0.5 0.5, 1.5 0.5, 1.5 1.5, 0.5 1.5, 0.5 0.5)),"
            " ((2.05 2.05, 2.2 2.05, 2.2 2.2, 2.05 2.2, 2.05 2.05)))"]), 0)
    chips = run_both(body, *ctxs)
    cell = ctxs[1].index_system.point_to_cell(np.array([[2.1, 2.1]]), 0)[0]
    k = np.nonzero(chips.cell_id == cell)[0]
    assert len(k) == 1
    e = _poly_edges(chips.geoms, int(k[0]))
    assert _pip(np.array([[2.1, 2.1]]), e)[0]
    assert not _pip(np.array([[2.5, 2.5]]), e)[0]


def test_empty_point_wkt_roundtrip(ctxs):
    def body(ctx, P):
        g2 = ctx.st_geomfromwkb(ctx.st_aswkb(ctx.st_geomfromwkt(
            ["POINT EMPTY"])))
        return ctx.st_aswkt(g2)
    assert run_both(body, *ctxs) == ["POINT EMPTY"]


def test_union_agg_no_core_chips(ctxs):
    def body(ctx, P):
        g = P.read_wkt(
            ["POLYGON ((-74.001 40.701, -73.9995 40.701, -73.9995 40.7025,"
             " -74.001 40.7025, -74.001 40.701))"])
        chips = ctx.grid_tessellate(g, 9, keep_core_geom=True)
        keep = np.nonzero(~chips.is_core)[0]
        b = P.ChipSet(chips.geom_id[keep], chips.cell_id[keep],
                      chips.is_core[keep], chips.geoms.take(keep))
        return [chips, ctx.st_union_agg(b), ctx.st_intersection_agg(b, b)]
    _, u, ia = run_both(body, *ctxs)
    assert len(u) >= 1 and len(ia) >= 1


# -------------------------------------------------- tests/test_realdata

@pytest.fixture(scope="module")
def real_zones():
    feats = [json.loads(line) for line in
             open(os.path.join(DATA, "nyc_taxi_zones.geojson"))
             if line.strip()]
    texts = [json.dumps(f["geometry"]) for f in feats]
    j, t = J.read_geojson(texts), T.read_geojson(texts)
    same(j, t)
    return j, t, [f["properties"]["zone"] for f in feats]


@pytest.fixture(scope="module")
def h3ctxs():
    return JContext.build("H3"), TContext("H3", device=CPU)


def test_ingest_real_zones(real_zones, h3ctxs):
    jz, tz, names = real_zones
    assert len(tz) == 35 and "Bloomingdale" in names
    want = h3ctxs[0].st_area(jz)
    areas = h3ctxs[1].st_area(tz)
    same(want, areas, area_terms(tz))
    assert np.all(areas > 0)
    assert areas[0] == pytest.approx(4.193691052023496e-05, rel=1e-12)


def test_tessellate_real_zones(real_zones, h3ctxs):
    jz, tz, _ = real_zones
    jc = h3ctxs[0].grid_tessellateexplode(jz, 9)
    chips = h3ctxs[1].grid_tessellateexplode(tz, 9)
    same(jc, chips)
    assert len(chips) > 500 and chips.is_core.sum() > 0
    zone_area = h3ctxs[1].st_area(tz)
    chip_area = h3ctxs[1].st_area(chips.geoms)
    same(h3ctxs[0].st_area(jc.geoms), chip_area, area_terms(chips.geoms))
    got = np.zeros(len(tz))
    np.add.at(got, chips.geom_id, chip_area)
    np.testing.assert_allclose(got, zone_area, rtol=1e-6)


def test_quickstart_2263_through_surface(real_zones, h3ctxs):
    """tests/test_crs_families.py's Quickstart check on the port: the
    2263 shapefile read by ``mt.io``, transformed back to 4326 and held
    to the GeoJSON zones."""
    jz, tz, _ = real_zones
    shp = os.path.join(DATA, "nyc_taxi_zones_2263.shp")
    jg, _ = J.io.read_shapefile(shp)
    tg, _ = T.io.read_shapefile(shp)
    assert tg.srid == 2263 and len(tg) == 35
    jback = h3ctxs[0].st_transform(jg, 4326)
    back = h3ctxs[1].st_transform(tg, 4326)
    same(jback, back)
    tol = area_terms(back)
    a_back = h3ctxs[1].st_area(back)
    same(h3ctxs[0].st_area(jback), a_back, tol)
    assert np.abs(a_back - h3ctxs[1].st_area(tz)).max() < 1e-11
    c_back = h3ctxs[1].st_centroid(back).coords[:, :2]
    c_true = h3ctxs[1].st_centroid(tz).coords[:, :2]
    assert np.abs(c_back - c_true).max() < 2e-5


def test_quickstart_join_through_surface(real_zones, h3ctxs):
    """The reference Quickstart as phase 20a runs it on the card: cells
    of the points, the chips, the core pairs accepted, the border pairs
    through ``st_contains`` in chunks; every point's zone equals
    ``pip_host_truth``."""
    from mosaic_tpu_torch.parallel.pip_join import pip_host_truth
    import csv
    _, tz, _ = real_zones
    ctx = h3ctxs[1]
    with open(os.path.join(DATA, "nyc_taxi_trips_sample.csv")) as f:
        trips = np.array([[float(r["pickup_longitude"]),
                           float(r["pickup_latitude"])]
                          for r in csv.DictReader(f)])
    bb = tz.bboxes()
    rng = np.random.default_rng(20)
    pts = np.concatenate([np.stack([
        rng.uniform(bb[:, 0].min(), bb[:, 2].max(), 3000),
        rng.uniform(bb[:, 1].min(), bb[:, 3].max(), 3000)], -1), trips])
    g = T.GeometryArray.from_points(pts)
    cells = ctx.grid_pointascellid(g, 9)
    assert np.array_equal(cells, ctx.index_system.point_to_cell(pts, 9))
    chips = ctx.grid_tessellateexplode(tz, 9)
    zone = quickstart_join(ctx, chips, g, cells, chunk=256)
    assert np.array_equal(zone, pip_host_truth(pts, tz))
    assert (zone >= 0).sum() > 100


def quickstart_join(ctx, chips, points, cells, chunk):
    """Zone per point from a cell-id join of points and chips: core
    pairs accepted, border pairs through ``ctx.st_contains`` in chunks
    (the lowest zone id wins, as ``pip_host_truth`` picks the first)."""
    order = np.argsort(chips.cell_id, kind="stable")
    sc = chips.cell_id[order]
    lo = np.searchsorted(sc, cells, "left")
    hi = np.searchsorted(sc, cells, "right")
    n = hi - lo
    pt = np.repeat(np.arange(len(cells)), n)
    ch = order[np.repeat(lo, n) + (np.arange(n.sum()) -
                                   np.repeat(np.cumsum(n) - n, n))]
    ok = chips.is_core[ch].copy()
    border = np.nonzero(~ok)[0]
    for s in range(0, len(border), chunk):
        sel = border[s:s + chunk]
        ok[sel] = ctx.st_contains(chips.geoms.take(ch[sel]),
                                  points.take(pt[sel]))
    zone = np.full(len(cells), np.iinfo(np.int64).max)
    np.minimum.at(zone, pt[ok], chips.geom_id[ch[ok]])
    zone[zone == np.iinfo(np.int64).max] = -1
    return zone


# --------------------------------------------- one case per name

POLYS = [
    "POLYGON ((-74.00 40.70, -73.98 40.70, -73.98 40.72, -74.00 40.72, "
    "-74.00 40.70))",
    "POLYGON ((-73.99 40.71, -73.97 40.71, -73.97 40.73, -73.99 40.73, "
    "-73.99 40.71), (-73.985 40.715, -73.975 40.715, -73.975 40.725, "
    "-73.985 40.725, -73.985 40.715))",
    "MULTIPOLYGON (((-74.02 40.68, -74.01 40.68, -74.01 40.69, "
    "-74.02 40.68)), ((-73.96 40.74, -73.95 40.74, -73.95 40.75, "
    "-73.96 40.75, -73.96 40.74)))",
]
POLYS2 = [
    "POLYGON ((-73.99 40.705, -73.97 40.705, -73.97 40.715, -73.99 40.715, "
    "-73.99 40.705))",
    "POLYGON ((-74.03 40.60, -74.02 40.60, -74.02 40.61, -74.03 40.60))",
    "POLYGON ((-73.955 40.745, -73.94 40.745, -73.94 40.76, -73.955 40.76, "
    "-73.955 40.745))",
]
POINTS = [(-73.99, 40.71), (-73.988, 40.712), (-73.955, 40.745)]
LINES = ["LINESTRING (-74.00 40.70, -73.99 40.71, -73.98 40.705)",
         "LINESTRING (-73.97 40.72, -73.96 40.73)",
         "MULTILINESTRING ((-74.01 40.70, -74.00 40.71), "
         "(-74.00 40.72, -73.99 40.73))"]
ZPOINTS = ["POINT Z (0 0 1)", "POINT Z (4 0 2)", "POINT Z (4 4 3)",
           "POINT Z (0 4 4)", "POINT Z (2 2 6)", "POINT Z (1 3 5)"]
CLOUD = ["MULTIPOINT ((0 0), (4 0), (4 4), (0 4), (2 1), (1 2), (3 3), "
         "(2 3.5), (0.5 0.5), (3.5 0.2))"]
RES = 9
TILE = (12, 1205, 1539)


def _inputs(P, ctx):
    """The fixture set of one package: its own geometry arrays and
    chips, made from the same WKT."""
    polys, polys2 = P.read_wkt(POLYS), P.read_wkt(POLYS2)
    xs, ys = np.array(POINTS).T
    pts = P.GeometryArray.from_points(np.array(POINTS))
    cells = ctx.index_system.point_to_cell(np.array(POINTS), RES)
    chips = ctx.grid_tessellate(polys, RES)
    ca, cb = (ctx.grid_tessellate(P.read_wkt([POLYS[i]]), RES)
              for i in (0, 1))
    common = np.intersect1d(ca.cell_id, cb.cell_id)
    ia = np.array([np.nonzero(ca.cell_id == c)[0][0] for c in common])
    ib = np.array([np.nonzero(cb.cell_id == c)[0][0] for c in common])
    types = jtypes if P is J else ttypes

    def rows(c, i):
        return types.ChipSet(c.geom_id[i], c.cell_id[i], c.is_core[i],
                             c.geoms.take(i))
    return {"polys": polys, "polys2": polys2, "pts": pts, "xs": xs,
            "ys": ys, "cells": cells, "chips": chips,
            "left": rows(ca, ia), "right": rows(cb, ib),
            "lines": P.read_wkt(LINES), "zpts": P.read_wkt(ZPOINTS),
            "cloud": P.read_wkt(CLOUD),
            "rings": P.read_wkt(["LINESTRING (0 0, 4 0, 4 4, 0 4, 0 0)"]),
            "holes": [P.read_wkt(["LINESTRING (1 1, 2 1, 2 2, 1 2, 1 1)"])],
            "segs": [P.GeometryArray.from_points(np.array([[0., 0], [1, 1]])),
                     P.GeometryArray.from_points(np.array([[2., 0], [3, 1],
                                                           [4, 0]]))],
            "query": P.GeometryArray.from_points(
                np.array([[1.0, 1.0], [2.5, 2.0], [3.0, 1.0]])),
            "attrs": {"name": ["a", "b", "c"], "v": [1, 2.5, None]},
            "wkts": POLYS, "ctx": ctx}


CASES = {
    # format
    "as_hex": lambda d: (d["polys"],),
    "as_json": lambda d: (d["wkts"],),
    "convert_to_coords": lambda d: (d["wkts"],),
    "convert_to_geojson": lambda d: (d["wkts"],),
    "convert_to_hex": lambda d: (d["wkts"],),
    "convert_to_wkb": lambda d: (d["wkts"],),
    "convert_to_wkt": lambda d: (d["ctx"].convert_to_wkb(d["wkts"]),),
    # legacy
    "flatten_polygons": lambda d: (d["polys"],),
    "mosaic_explode": lambda d: (d["polys"], RES),
    "mosaicfill": lambda d: (d["polys"], RES, False),
    "try_sql": lambda d: (d["ctx"].st_area, d["polys"]),
    # grid
    "grid_boundary": lambda d: (d["cells"],),
    "grid_boundaryaswkb": lambda d: (d["cells"],),
    "grid_cell_intersection": lambda d: (d["left"], d["right"]),
    "grid_cell_union": lambda d: (d["left"], d["right"]),
    "grid_cellarea": lambda d: (d["cells"],),
    "grid_cellid_from_string": lambda d: (
        d["ctx"].grid_cellid_to_string(d["cells"]),),
    "grid_cellid_to_string": lambda d: (d["cells"],),
    "grid_cellkloop": lambda d: (d["cells"], 2),
    "grid_cellkloopexplode": lambda d: (d["cells"], 1),
    "grid_cellkring": lambda d: (d["cells"], 1),
    "grid_cellkringexplode": lambda d: (d["cells"], 2),
    "grid_distance": lambda d: (d["cells"], d["cells"][::-1]),
    "grid_geometrykloop": lambda d: (d["polys"], RES, 1),
    "grid_geometrykloopexplode": lambda d: (d["polys"], RES, 2),
    "grid_geometrykring": lambda d: (d["polys"], RES, 1),
    "grid_geometrykringexplode": lambda d: (d["polys"], RES, 1),
    "grid_intersects_sharded": lambda d: (d["polys"], d["polys2"], RES),
    "grid_longlatascellid": lambda d: (d["xs"], d["ys"], RES),
    "grid_pointascellid": lambda d: (d["pts"], RES),
    "grid_polyfill": lambda d: (d["polys"], RES),
    "grid_polyfill_union": lambda d: (d["polys"], RES),
    "grid_tessellate": lambda d: (d["polys"], RES),
    "grid_tessellateaslong": lambda d: (d["lines"], RES),
    "grid_tessellateexplode": lambda d: (d["polys2"], 8),
    "grid_wrapaschip": lambda d: (d["cells"],),
    # aggregator (the rst_*_agg names: tests/test_torch_functions_raster)
    "grid_cell_intersection_agg": lambda d: (d["chips"],),
    "grid_cell_union_agg": lambda d: (d["chips"],),
    "st_asgeojsontile_agg": lambda d: (d["polys"], d["attrs"], *TILE),
    "st_asmvttile_agg": lambda d: (d["polys"], d["attrs"], *TILE),
    "st_intersection_agg": lambda d: (d["left"], d["right"]),
    "st_intersection_aggregate": lambda d: (d["left"], d["right"]),
    "st_intersects_agg": lambda d: (d["left"], d["right"]),
    "st_intersects_aggregate": lambda d: (d["left"], d["left"]),
    "st_union_agg": lambda d: (d["chips"],),
    # geometry
    "st_area": lambda d: (d["polys"],),
    "st_asbinary": lambda d: (d["polys"],),
    "st_asgeojson": lambda d: (d["lines"],),
    "st_asgeojsontileagg": lambda d: (d["lines"], None, *TILE),
    "st_asmvttileagg": lambda d: (d["lines"], d["attrs"], *TILE),
    "st_astext": lambda d: (d["polys"],),
    "st_aswkb": lambda d: (d["lines"],),
    "st_aswkt": lambda d: (d["lines"],),
    "st_buffer": lambda d: (d["polys"], 0.002),
    "st_buffer_cap_style": lambda d: (d["lines"], 0.002, "flat"),
    "st_bufferloop": lambda d: (d["polys"], 0.001, 0.002),
    "st_centroid": lambda d: (d["polys"],),
    "st_centroid2d": lambda d: (d["lines"],),
    "st_concavehull": lambda d: (d["cloud"], 0.5),
    "st_contains": lambda d: (d["polys"], d["pts"]),
    "st_convexhull": lambda d: (d["polys"],),
    "st_difference": lambda d: (d["polys"], d["polys2"]),
    "st_dimension": lambda d: (d["lines"],),
    "st_distance": lambda d: (d["pts"], d["polys2"]),
    "st_dump": lambda d: (d["polys"],),
    "st_envelope": lambda d: (d["lines"],),
    "st_geometrytype": lambda d: (d["polys"],),
    "st_geomfrombinary": lambda d: (d["ctx"].st_aswkb(d["polys"]),),
    "st_geomfromgeojson": lambda d: (d["ctx"].st_asgeojson(d["polys"]),),
    "st_geomfromtext": lambda d: (LINES,),
    "st_geomfromwkb": lambda d: (d["ctx"].st_aswkb(d["lines"]),),
    "st_geomfromwkt": lambda d: (d["wkts"],),
    "st_hasvalidcoordinates": lambda d: (d["polys"], "EPSG:4326",
                                         "bounds"),
    "st_haversine": lambda d: (d["ys"], d["xs"], d["ys"][::-1],
                               d["xs"][::-1]),
    "st_interpolateelevation": lambda d: (d["zpts"], d["query"]),
    "st_intersection": lambda d: (d["polys"], d["polys2"]),
    "st_intersects": lambda d: (d["polys"], d["polys2"]),
    "st_isvalid": lambda d: (d["polys"],),
    "st_length": lambda d: (d["lines"],),
    "st_makeline": lambda d: (d["segs"],),
    "st_makepolygon": lambda d: (d["rings"], d["holes"]),
    "st_numpoints": lambda d: (d["polys"],),
    "st_perimeter": lambda d: (d["polys"],),
    "st_point": lambda d: (d["xs"], d["ys"]),
    "st_polygon": lambda d: (d["rings"],),
    "st_rotate": lambda d: (d["polys"], 0.3),
    "st_scale": lambda d: (d["polys"], 2.0, 0.5),
    "st_setsrid": lambda d: (d["polys"], 3857),
    "st_simplify": lambda d: (d["lines"], 0.005),
    "st_srid": lambda d: (d["polys"],),
    "st_symdifference": lambda d: (d["polys"], d["polys2"]),
    "st_transform": lambda d: (d["polys"], 3857),
    "st_translate": lambda d: (d["polys"], 1.0, -2.0),
    "st_triangulate": lambda d: (d["polys"],),
    "st_unaryunion": lambda d: (d["polys"],),
    "st_union": lambda d: (d["polys"], d["polys2"]),
    "st_updatesrid": lambda d: (d["polys"], 4326, 27700),
    "st_within": lambda d: (d["pts"], d["polys"]),
    "st_x": lambda d: (d["pts"],),
    "st_xmax": lambda d: (d["polys"],),
    "st_xmin": lambda d: (d["lines"],),
    "st_y": lambda d: (d["pts"],),
    "st_ymax": lambda d: (d["polys"],),
    "st_ymin": lambda d: (d["lines"],),
    "st_z": lambda d: (d["zpts"],),
    "st_zmax": lambda d: (d["zpts"],),
    "st_zmin": lambda d: (d["polys"],),
}

#: names whose JAX body sums floats on the device in its own order
MEASURED = {"st_area", "st_length", "st_perimeter", "st_centroid",
            "st_centroid2d", "st_distance", "st_haversine", "try_sql"}


@pytest.fixture(scope="module")
def inputs(h3ctxs):
    return _inputs(J, h3ctxs[0]), _inputs(T, h3ctxs[1])


def test_cases_cover_every_name_outside_the_raster_surface():
    from test_torch_functions_raster import RASTER_CASES
    assert set(CASES) | set(RASTER_CASES) == set(JREGISTRY)
    assert not set(CASES) & set(RASTER_CASES)


def test_fixture_sets_equal(inputs):
    jd, td = inputs
    for k in jd:
        if k != "ctx":
            same(jd[k], td[k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_registered_name(name, inputs, h3ctxs):
    jd, td = inputs
    want = h3ctxs[0].call(name, *CASES[name](jd))
    got = h3ctxs[1].call(name, *CASES[name](td))
    if name in MEASURED:
        tol = area_terms(td["polys"]) + area_terms(td["lines"])
        if name == "st_haversine":
            tol = 1e-12 * np.abs(want).max()
        same(want, got, tol)
        return
    same(want, got)


def test_st_haversine_scalars(h3ctxs):
    """Scalar arguments give a 0-d result in both packages."""
    args = (51.5074, -0.1278, 48.8566, 2.3522)
    want = np.asarray(h3ctxs[0].call("st_haversine", *args))
    got = h3ctxs[1].call("st_haversine", *args)
    assert np.shape(got) == want.shape == ()
    assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


# ------------------------------------------------- host-plane cases

@pytest.fixture
def traced():
    for tr in (jtracer, ttracer):
        tr.reset()
        tr.enable()
    yield
    for tr in (jtracer, ttracer):
        tr.disable()
        tr.reset()


def test_span_timing_via_call(traced):
    """tests/test_trace.py::test_span_timing_via_call on the port."""
    jc = JContext.build("CUSTOM(-180,180,-90,90,2,360,180)")
    tc = TContext("CUSTOM(-180,180,-90,90,2,360,180)", device=CPU)
    wkt = ["POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"]
    for ctx, P in ((jc, J), (tc, T)):
        g = P.read_wkt(wkt)
        ctx.call("st_area", g)
        ctx.call("st_area", g)
    s = ttracer.report()["spans"]["call/st_area"]
    assert s["calls"] == 2 == jtracer.report()["spans"]["call/st_area"][
        "calls"]
    assert s["total_s"] >= 0.0
    assert "call/st_area" in ttracer.format_report()


def test_disabled_tracer_records_nothing():
    """The ``MosaicContext.call`` form of tests/test_trace.py's case."""
    ttracer.reset()
    ttracer.disable()
    tc = TContext("CUSTOM(-180,180,-90,90,2,360,180)", device=CPU)
    tc.call("st_area", T.read_wkt(["POINT (0 0)"]))
    assert ttracer.report()["spans"] == {}


def test_call_observes_the_planner():
    """``call`` feeds the planner one ``fn/<name>`` cost per dispatch,
    as the JAX package's does."""
    from mosaic_tpu.sql.planner import planner as jplanner
    from mosaic_tpu_torch.sql.planner import planner
    jc, tc = JContext.build("H3"), TContext("H3", device=CPU)
    for pl in (jplanner, planner):
        pl.reset()
    try:
        jc.call("st_area", J.read_wkt(POLYS))
        tc.call("st_area", T.read_wkt(POLYS))
        assert planner.observations == jplanner.observations == 1
        assert planner.ms_per_row("fn/st_area", len(POLYS)) > 0
        assert jplanner.ms_per_row("fn/st_area", len(POLYS)) > 0
    finally:
        for pl in (jplanner, planner):
            pl.reset()


@pytest.mark.parametrize("grid", ["H3", "BNG", CUSTOM])
def test_enable_mosaic_reads_grid_confs(grid):
    """``mosaic.index.system`` and ``mosaic.geometry.api`` choose what
    ``enable_mosaic()`` binds when its caller names nothing; a named
    grid wins over the conf."""
    prev = tconfig.default_config()
    try:
        cfg = tconfig.apply_conf(tconfig.MosaicConfig(),
                                 "mosaic.index.system", grid)
        tconfig.set_default_config(
            tconfig.apply_conf(cfg, "mosaic.geometry.api", "JAX"))
        ctx = T.enable_mosaic(device=CPU)
        assert ctx.index_system.name == J.get_index_system(grid).name
        assert ctx.geometry_api == "JAX"
        assert tconfig.default_config().index_system == \
            ctx.index_system.name
        tconfig.set_default_config(cfg)
        assert T.enable_mosaic("H3", device=CPU).index_system.name == "H3"
    finally:
        tconfig.set_default_config(prev)


def test_build_installs_no_listener():
    """C14: the port has no jit, so ``build`` installs no compile
    listener: the port's ``obs.jaxmon`` is the device-memory half alone
    (no ``install_jax_listeners``, no ``record_cost_analysis``), and
    building a context records no compile."""
    import mosaic_tpu_torch.obs as tobs
    from mosaic_tpu_torch.obs import jaxmon
    was = tobs.metrics.enabled
    tobs.metrics.enable()
    try:
        before = tobs.metrics.counter_value("jax/recompiles")
        T.enable_mosaic("H3", device=CPU)
        assert tobs.metrics.counter_value("jax/recompiles") == before == 0
    finally:
        if not was:
            tobs.metrics.disable()
    for name in ("install_jax_listeners", "record_cost_analysis",
                 "STORM_THRESHOLD"):
        assert not hasattr(tobs, name) and not hasattr(jaxmon, name)
