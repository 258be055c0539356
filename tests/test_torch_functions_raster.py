"""The port's ``rst_*`` surface (``mosaic_tpu_torch/functions/raster.py``)
against the JAX package's.

* tests/test_raster.py's ``TestRstSurface`` cases through both contexts
  on the same seeded DEM tiles, every result compared.
* tests/test_trace.py::test_map_algebra_records_last_command: the
  caller's function runs on torch tensors in the port and records the
  same ``last_command``.
* One case per ``rst_*`` name (the 69 of the raster group and the three
  ``rst_*_agg`` aggregators): the function called once through
  ``ctx.call`` in both packages on one small fixture, the results
  compared.
* ``rst_fromfile`` of the real CAMS GRIB file, then
  ``rst_rastertogridavg`` at H3 res 2, equal to the JAX context's.

Tolerances: bit-equal, except ``rst_combineavg`` (and its ``_agg``
alias), which reduces on the device: within 4 ulp of ``jnp.nanmean``
(tests/test_torch_raster_kernels.py), and ``rst_convolve``: within 1e-12
of sum |w||x| of XLA's convolution.  The port runs on the CPU
(``device="cpu"``), where every kernel wrapper runs its plain version.
"""

import os

import numpy as np
import pytest

import mosaic_tpu as J
import mosaic_tpu_torch as T
from mosaic_tpu import config as jconfig
from mosaic_tpu.core.raster.gtiff import write_gtiff as jwrite
from mosaic_tpu.functions.context import MosaicContext as JContext
from mosaic_tpu_torch import config as tconfig
from mosaic_tpu_torch.core.raster.gtiff import write_gtiff as twrite
from mosaic_tpu_torch.functions.context import MosaicContext as TContext
from test_torch_functions import same
import mosaic_tpu.core.raster as jraster
import mosaic_tpu_torch.core.raster as traster

CPU = "cpu"
RAS = {J: jraster, T: traster}
CUSTOM = "CUSTOM(0,16,0,16,2,1,1)"
GRIB_FIX = os.path.join(os.path.dirname(__file__), "data",
                        "cams_sample.grb")


@pytest.fixture(autouse=True)
def restore_configs():
    jprev, tprev = jconfig.default_config(), tconfig.default_config()
    yield
    jconfig.set_default_config(jprev)
    tconfig.set_default_config(tprev)


@pytest.fixture(scope="module")
def ctxs():
    return JContext.build(CUSTOM), TContext(CUSTOM, device=CPU)


def dem_tile(P, seed, h=64, w=64, bands=1, nodata=-9999.0):
    """tests/test_raster.py's DEM tile in package ``P``."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 1000, (bands, h, w)).astype(np.float32)
    gt = RAS[P].GeoTransform(0.0, 16.0 / w, 0.0, 16.0, 0.0, -16.0 / h)
    return RAS[P].RasterTile(data, gt, nodata=nodata, srid=4326)


def run_both(body, ctxs):
    j, t = body(ctxs[0], J), body(ctxs[1], T)
    same(j, t)
    return t


# ---------------------------------------------- tests/test_raster.py

def test_accessors(ctxs):
    def body(ctx, P):
        t = dem_tile(P, 1, 32, 48, bands=2)
        return [ctx.rst_height([t]), ctx.rst_width([t]),
                ctx.rst_numbands([t]), ctx.rst_scalex([t]),
                ctx.rst_srid([t]), ctx.rst_pixelcount([t]),
                ctx.rst_isempty([t])]
    h, w, nb, sx, srid, pc, empty = run_both(body, ctxs)
    assert h[0] == 32 and w[0] == 48 and nb[0] == 2
    assert sx[0] == pytest.approx(16.0 / 48) and srid[0] == 4326
    assert pc[0] == 2 * 32 * 48 and not empty[0]


def test_write_read_surface(ctxs):
    def body(ctx, P):
        t = dem_tile(P, 2, 16, 16)
        blobs = ctx.rst_write([t])
        return [blobs, ctx.rst_tryopen(blobs), ctx.rst_tryopen([b"junk"]),
                ctx.rst_fromcontent(blobs)[0], t]
    _, ok, bad, back, t = run_both(body, ctxs)
    assert ok == [True] and bad == [False]
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(t.data))


def test_frombands_separatebands(ctxs):
    def body(ctx, P):
        t = dem_tile(P, 3, 8, 8, bands=3)
        bands = ctx.rst_separatebands([t])
        return [bands, ctx.rst_frombands(bands), t]
    bands, back, t = run_both(body, ctxs)
    assert len(bands) == 3
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(t.data))


def test_rastertogrid_oracle(ctxs):
    def body(ctx, P):
        return ctx.rst_rastertogridavg([dem_tile(P, 4)], 2)[0]
    got = run_both(body, ctxs)
    t = dem_tile(T, 4)
    xs, ys = t.pixel_centers()
    cells = ctxs[1].index_system.point_to_cell(
        np.stack([xs.ravel(), ys.ravel()], -1), 2)
    vals = np.asarray(t.data[0], np.float64).ravel()
    for c in np.unique(cells):
        assert got[int(c)] == pytest.approx(vals[cells == c].mean(),
                                            rel=1e-12)


def test_world_coord_surface(ctxs):
    def body(ctx, P):
        t = dem_tile(P, 5)
        return [ctx.rst_rastertoworldcoord([t], [0], [0]),
                ctx.rst_worldtorastercoord([t], [8.0], [8.0])]
    xy, cr = run_both(body, ctxs)
    assert xy[0, 0] == pytest.approx(0.0) and xy[0, 1] == pytest.approx(16.0)
    assert cr[0, 0] == 32 and cr[0, 1] == 32


def test_map_algebra_records_last_command():
    """tests/test_trace.py's case: ``fn`` gets torch tensors in the port
    and the tile records the same command."""
    jc = JContext.build("CUSTOM(-180,180,-90,90,2,360,180)")
    tc = TContext("CUSTOM(-180,180,-90,90,2,360,180)", device=CPU)
    outs = []
    for ctx, P in ((jc, J), (tc, T)):
        gt = RAS[P].GeoTransform(0.0, 0.1, 0.0, 10.0, 0.0, -0.1)
        t = RAS[P].RasterTile(np.arange(100.0).reshape(10, 10)[None], gt)
        outs.append(ctx.rst_mapalgebra([t, t], lambda a, b: a + b))
    same(*outs)
    assert "map_algebra" in outs[1].meta["last_command"]


def test_grib_rastertogrid_h3():
    """The real CAMS file through ``rst_fromfile`` and
    ``rst_rastertogridavg`` at H3 res 2 (phase 20c on the card)."""
    jc, tc = JContext.build("H3"), TContext("H3", device=CPU)
    jt, tt = jc.rst_fromfile([GRIB_FIX]), tc.rst_fromfile([GRIB_FIX])
    same(jt, tt)
    got = tc.rst_rastertogridavg(tt, 2)
    same(jc.rst_rastertogridavg(jt, 2), got)
    assert len(got[0]) > 10


# --------------------------------------------- one case per name

def _inputs(P, ctx, tmp):
    tile = dem_tile(P, 7, 24, 32)
    two = dem_tile(P, 8, 24, 32, bands=2, nodata=None)
    quarters = [tile.window(0, 0, 20, 16), tile.window(12, 0, 20, 16),
                tile.window(0, 10, 20, 14), tile.window(12, 10, 20, 14)]
    blob = (jwrite if P is J else twrite)(tile)
    tif = os.path.join(tmp, "dem.tif")
    if os.path.exists(tif):          # the other package's: equal bytes
        with open(tif, "rb") as f:
            assert f.read() == blob
    with open(tif, "wb") as f:
        f.write(blob)
    grib = ctx.rst_fromfile([GRIB_FIX])
    small = RAS[P].RasterTile(np.arange(64.0).reshape(1, 8, 8),
                         RAS[P].GeoTransform(-74.0, 0.01, 0.0, 40.8, 0.0,
                                        -0.01), srid=4326)
    geoms = P.read_wkt(["POLYGON ((2 2, 10 3, 9 11, 3 9, 2 2))"])
    rng = np.random.default_rng(9)
    xyz = np.column_stack([rng.uniform(0, 16, 40), rng.uniform(0, 16, 40),
                           rng.uniform(0, 100, 40)])
    return {"t": [tile], "two": [two], "q": quarters, "blob": [blob],
            "paths": [tif, GRIB_FIX], "grib": grib, "small": [small],
            "geoms": geoms, "xyz": xyz, "gt": tile.gt.to_tuple()}


RASTER_CASES = {
    "rst_asformat": lambda d: (d["t"], "GTiff"),
    "rst_avg": lambda d: (d["two"],),
    "rst_bandmetadata": lambda d: (d["two"], 1),
    "rst_boundingbox": lambda d: (d["q"],),
    "rst_clip": lambda d: (d["t"], d["geoms"]),
    "rst_combineavg": lambda d: (d["q"],),
    "rst_combineavg_agg": lambda d: (d["q"][:2],),
    "rst_convolve": lambda d: (d["t"], [[0.0, 1, 0], [1, -4, 1],
                                        [0, 1, 0.5]]),
    "rst_derivedband": lambda d: (d["q"][:1], lambda a: a * 2.0 + 1.0),
    "rst_derivedband_agg": lambda d: (d["t"] * 2, lambda a, b: a - b),
    "rst_dtmfromgeoms": lambda d: (d["xyz"], d["gt"], 32, 24),
    "rst_filter": lambda d: (d["t"], 3, "median"),
    "rst_format": lambda d: (d["grib"] + d["t"],),
    "rst_frombands": lambda d: ([d["two"][0].band(0),
                                 d["two"][0].band(1)],),
    "rst_fromcontent": lambda d: (d["blob"],),
    "rst_fromfile": lambda d: (d["paths"],),
    "rst_georeference": lambda d: (d["q"],),
    "rst_getnodata": lambda d: (d["t"] + d["two"],),
    "rst_getsubdataset": lambda d: (d["grib"],
                                    sorted(d["grib"][0].meta[
                                        "subdatasets"].split(","))[3]),
    "rst_height": lambda d: (d["q"],),
    "rst_initnodata": lambda d: (d["t"],),
    "rst_isempty": lambda d: (d["t"],),
    "rst_maketiles": lambda d: (d["blob"], 0.001),
    "rst_mapalgebra": lambda d: (d["q"][:1] + d["q"][:1],
                                 lambda a, b: a * b),
    "rst_max": lambda d: (d["two"],),
    "rst_median": lambda d: (d["two"],),
    "rst_memsize": lambda d: (d["t"],),
    "rst_merge": lambda d: (d["q"],),
    "rst_merge_agg": lambda d: (d["q"][1:],),
    "rst_metadata": lambda d: (d["t"],),
    "rst_min": lambda d: (d["t"],),
    "rst_ndvi": lambda d: (d["two"], 0, 1),
    "rst_numbands": lambda d: (d["two"],),
    "rst_pixelcount": lambda d: (d["t"],),
    "rst_pixelheight": lambda d: (d["q"],),
    "rst_pixelwidth": lambda d: (d["q"],),
    "rst_rasterize": lambda d: (d["geoms"], np.array([5.0]), d["gt"], 32,
                                24),
    "rst_rastertogrid": lambda d: (d["t"], 2, "max"),
    "rst_rastertogridavg": lambda d: (d["q"], 2),
    "rst_rastertogridcount": lambda d: (d["t"], 2),
    "rst_rastertogridmax": lambda d: (d["t"], 1),
    "rst_rastertogridmedian": lambda d: (d["t"], 2),
    "rst_rastertogridmin": lambda d: (d["two"], 2),
    "rst_rastertoworldcoord": lambda d: (d["q"], [0, 3, 5, 7],
                                         [1, 2, 4, 6]),
    "rst_rastertoworldcoordx": lambda d: (d["t"], [3], [2]),
    "rst_rastertoworldcoordy": lambda d: (d["t"], [3], [2]),
    "rst_retile": lambda d: (d["t"], 10, 9),
    "rst_rotation": lambda d: (d["t"],),
    "rst_scalex": lambda d: (d["q"],),
    "rst_scaley": lambda d: (d["q"],),
    "rst_separatebands": lambda d: (d["two"],),
    "rst_setnodata": lambda d: (d["t"], -1.0),
    "rst_setsrid": lambda d: (d["t"], 3857),
    "rst_skewx": lambda d: (d["t"],),
    "rst_skewy": lambda d: (d["t"],),
    "rst_srid": lambda d: (d["grib"],),
    "rst_subdatasets": lambda d: (d["grib"] + d["t"],),
    "rst_subdivide": lambda d: (d["t"], 0.001),
    "rst_summary": lambda d: (d["two"],),
    "rst_tessellate": lambda d: (d["t"], 1),
    "rst_to_overlapping_tiles": lambda d: (d["t"], 16, 12, 50),
    "rst_transform": lambda d: (d["small"], 3857),
    "rst_tryopen": lambda d: (d["blob"] + [b"junk"],),
    "rst_type": lambda d: (d["t"] + d["grib"],),
    "rst_updatetype": lambda d: (d["t"], np.float64),
    "rst_upperleftx": lambda d: (d["q"],),
    "rst_upperlefty": lambda d: (d["q"],),
    "rst_width": lambda d: (d["q"],),
    "rst_worldtorastercoord": lambda d: (d["q"], [1.0, 5.0, 9.0, 15.5],
                                         [15.0, 12.0, 3.0, 0.5]),
    "rst_worldtorastercoordx": lambda d: (d["t"], [4.2], [7.9]),
    "rst_worldtorastercoordy": lambda d: (d["t"], [4.2], [7.9]),
    "rst_write": lambda d: (d["q"][:2], True),
}


@pytest.fixture(scope="module")
def inputs(ctxs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("rst"))
    return _inputs(J, ctxs[0], tmp), _inputs(T, ctxs[1], tmp)


def test_cases_cover_the_raster_names():
    from mosaic_tpu.functions.registry import REGISTRY
    names = {n for n in REGISTRY if n.startswith("rst_")}
    assert set(RASTER_CASES) == names and len(names) == 72


def _ulps(x):
    return np.spacing(np.abs(np.nan_to_num(np.asarray(x, np.float64))))


@pytest.mark.parametrize("name", sorted(RASTER_CASES))
def test_registered_name(name, inputs, ctxs):
    jd, td = inputs
    want = ctxs[0].call(name, *RASTER_CASES[name](jd))
    got = ctxs[1].call(name, *RASTER_CASES[name](td))
    if name.startswith("rst_combineavg"):
        same(want.with_data(np.zeros((1, 1, 1))), got.with_data(np.zeros((1, 1, 1))))
        w, g = np.asarray(want.data), np.asarray(got.data)
        assert np.array_equal(np.isnan(w), np.isnan(g))
        assert np.all(np.abs(np.nan_to_num(w - g)) <= 4 * _ulps(w))
        return
    if name == "rst_convolve":
        x = np.abs(np.where(td["t"][0].valid_mask(),
                            np.asarray(td["t"][0].data, np.float64), 0.0))
        tol = 1e-12 * 8.5 * x.max()
        for w, g in zip(want, got):
            same(w.with_data(np.zeros((1, 1, 1))), g.with_data(np.zeros((1, 1, 1))))
            assert np.all(np.abs(np.asarray(w.data) - np.asarray(g.data))
                          <= tol)
        return
    same(want, got)
