"""The port's raster reprojection and DTM against the JAX package.

``rops.warp`` (inverse mapping through ``crs.transform_xy`` in f64 on
the host, nearest and bilinear, nodata-aware) and ``rops.dtm_from_geoms``
(Delaunay or conforming Delaunay, then barycentric z) are host numpy in
both packages, so the port's tiles are held bit for bit (data, geo
transform, srid, nodata) to the JAX package's on tests/test_warp.py's
cases: the gradient tile to 3857 and back, a tile with NaN and numeric
nodata, an unknown EPSG, and the plane TIN with and without a constraint
line.  ``raster_to_grid`` on a 200 x 160 tile of bench.py's DEM values in
EPSG:32618 (UTM 18N, 50 m pixels from the UTM projection of (-74.25,
40.92)) warps the tile into the H3 grid's 4326 first: its cells are
bit-equal to the JAX package's, for every combiner, at H3 res 8 (the
warped tile has 32,000 pixels, below torch's CPU grain; ROADMAP C10).
"""

import numpy as np
import pytest

import mosaic_tpu as J
import mosaic_tpu_torch as T
from mosaic_tpu.core.raster import rops as jrops
from mosaic_tpu.core.raster.tile import GeoTransform as JGT
from mosaic_tpu.core.raster.tile import RasterTile as JRT
from mosaic_tpu.io.raster_grid import raster_to_grid as jraster_to_grid
from mosaic_tpu_torch.core.geometry.crs import transform_xy
from mosaic_tpu_torch.core.raster import rops as trops
from mosaic_tpu_torch.core.raster.tile import GeoTransform, RasterTile


def pair(data, gt, **kw):
    return (JRT(np.array(data), JGT(*gt), **kw),
            RasterTile(np.array(data), GeoTransform(*gt), **kw))


def _same_tile(j, t):
    assert np.array_equal(np.asarray(j.data), np.asarray(t.data),
                          equal_nan=True)
    assert j.gt.to_tuple() == t.gt.to_tuple()
    assert j.srid == t.srid
    assert np.array_equal(np.atleast_1d(j.nodata), np.atleast_1d(t.nodata),
                          equal_nan=True)
    assert j.meta == t.meta


def gradient(w=64, h=48, srid=4326, nodata=None, holes=False):
    yy, xx = np.mgrid[0:h, 0:w]
    data = (xx * 2.0 + yy * 3.0)[None].astype(np.float64)
    if holes:
        data[0, 10:14, 20:30] = np.nan if nodata is None or \
            np.isnan(nodata) else nodata
    return pair(data, (-74.1, 0.002, 0.0, 40.9, 0.0, -0.002), nodata=nodata,
                srid=srid)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("nodata,holes", [(None, False), (np.nan, True),
                                          (-9999.0, True)])
def test_warp_equal(method, nodata, holes):
    jt, tt = gradient(nodata=nodata, holes=holes)
    jw = jrops.warp(jt, 3857, method)
    tw = trops.warp(tt, 3857, method)
    _same_tile(jw, tw)
    _same_tile(jrops.warp(jw, 4326, method), trops.warp(tw, 4326, method))
    assert trops.warp(tt, 4326) is tt


def test_warp_preserves_world_values():
    _, t = gradient()
    w = trops.warp(t, 3857)
    assert w.srid == 3857
    rng = np.random.default_rng(3)
    lon = rng.uniform(-74.08, -74.0, 50)
    lat = rng.uniform(40.82, 40.88, 50)
    m = transform_xy(np.stack([lon, lat], -1), 4326, 3857)
    cw, rw = w.gt.to_raster(m[:, 0], m[:, 1])
    cs, rs = t.gt.to_raster(lon, lat)
    vw = np.asarray(w.data[0])[rw.astype(int), cw.astype(int)]
    vs = np.asarray(t.data[0])[rs.astype(int), cs.astype(int)]
    assert np.max(np.abs(vw - vs)) < 6.0


def test_warp_rejects_unknown():
    _, t = gradient()
    with pytest.raises(ValueError):
        trops.warp(t, 9999)
    with pytest.raises(ValueError):
        trops.warp(t, 3857, "cubic")


@pytest.mark.parametrize("constrained", [False, True])
def test_dtm_from_geoms_equal(constrained):
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 10, (60, 2))
    xy = np.vstack([xy, [[0, 0], [10, 0], [0, 10], [10, 10.0]]])
    z = 2.0 * xy[:, 0] - 0.5 * xy[:, 1] + 3.0
    pts = np.column_stack([xy, z])
    gt = (0.0, 0.25, 0.0, 10.0, 0.0, -0.25)
    cons = np.array([[[1.0, 1.0], [9.0, 8.0]]]) if constrained else None
    j = jrops.dtm_from_geoms(pts, JGT(*gt), 40, 40, constraints=cons)
    t = trops.dtm_from_geoms(pts, GeoTransform(*gt), 40, 40,
                             constraints=cons)
    _same_tile(j, t)
    if constrained:
        return          # Steiner points take the nearest input's z
    d = np.asarray(t.data[0])
    gx, gy = np.meshgrid(np.arange(40) + 0.5, np.arange(40) + 0.5)
    wx, wy = t.gt.to_world(gx, gy)
    want = 2.0 * wx - 0.5 * wy + 3.0
    finite = np.isfinite(d)
    assert finite.mean() > 0.95
    assert np.nanmax(np.abs(d[finite] - want[finite])) < 1e-9


def utm_dem(h=160, w=200):
    """bench.py's DEM values on a UTM 18N grid of 50 m pixels whose
    origin is the UTM projection of (-74.25, 40.92)."""
    yy, xx = np.mgrid[0:h, 0:w]
    data = (np.sin(xx / 60.0) * 50 + yy * 0.1)[None]
    x0, y0 = transform_xy(np.array([[-74.25, 40.92]]), 4326, 32618)[0]
    return pair(data, (float(x0), 50.0, 0.0, float(y0), 0.0, -50.0),
                srid=32618)


@pytest.mark.parametrize("combiner", ["avg", "min", "max", "median",
                                      "count"])
def test_raster_to_grid_utm_tile(combiner):
    jt, tt = utm_dem()
    jg, tg = J.get_index_system("H3"), T.get_index_system("H3")
    want = jraster_to_grid([jt], 8, jg, combiner)
    got = T.raster_to_grid([tt], 8, tg, combiner, device="cpu")
    assert got == want
    assert len(got) > 20
