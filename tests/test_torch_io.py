"""The port's datasources (``mosaic_tpu_torch/io/``) against the JAX
package's.

Every codec of ``io/`` is a copy of the JAX package's pure-Python one.
The cases of tests/test_shapefile.py, test_geopackage.py, test_grib.py,
test_vectortile.py, the Arrow half of test_viz_arrow.py and the NetCDF
and Zarr cases of test_codecs.py run here through both packages on the
same seeded inputs:

* every writer (``write_shapefile``, ``write_gpkg``, ``write_netcdf``,
  ``write_zarr``, ``st_asmvttileagg``, ``st_asgeojsontileagg``,
  ``chips_to_arrow``/``table_to_ipc``) gives the JAX package's bytes;
* every reader reads the JAX package's files, and the JAX reader reads
  the port's, to equal geometry buffers (coords, offsets, types, srid),
  equal attribute columns, and bit-equal rasters with equal
  geotransforms;
* the real 2263 shapefile and the real CAMS GRIB file read equal;
* the IO cases of tests/test_chaos.py, each package armed through its
  own ``faults.arm`` with one spec string: the rows that survive, the
  error records, ``plan.injected`` and ``io/records_dropped`` equal.

The port runs on the CPU here (``device="cpu"``): the MVT polygon clip's
kernel runs its plain version.
"""

import dataclasses
import json
import math
import os
import shutil
import sqlite3
import struct

import numpy as np
import pytest

import mosaic_tpu as J
import mosaic_tpu_torch as T
from mosaic_tpu.bench.workloads import nyc_zones as jzones
from mosaic_tpu.core.index.factory import get_index_system as jgrid
from mosaic_tpu.functions.context import MosaicContext as JContext
from mosaic_tpu.io import arrow as jarrow
from mosaic_tpu.io import geopackage as jgpkg
from mosaic_tpu.io import grib as jgrib
from mosaic_tpu.io import netcdf as jnc
from mosaic_tpu.io import shapefile as jshp
from mosaic_tpu.io import vectortile as jmvt
from mosaic_tpu.io import zarr as jzarr
from mosaic_tpu.obs import metrics as jmetrics
from mosaic_tpu.resilience import faults as jfaults
from mosaic_tpu_torch.bench.workloads import nyc_zones as tzones
from mosaic_tpu_torch.core.index.factory import get_index_system as tgrid
from mosaic_tpu_torch.functions.context import MosaicContext as TContext
from mosaic_tpu_torch.io import arrow as tarrow
from mosaic_tpu_torch.io import geopackage as tgpkg
from mosaic_tpu_torch.io import grib as tgrib
from mosaic_tpu_torch.io import netcdf as tnc
from mosaic_tpu_torch.io import shapefile as tshp
from mosaic_tpu_torch.io import vectortile as tmvt
from mosaic_tpu_torch.io import zarr as tzarr
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.resilience import faults

DATA = os.path.join(os.path.dirname(__file__), "data")
GRIB_FIX = os.path.join(DATA, "cams_sample.grb")
SHP_FIX = os.path.join(DATA, "nyc_taxi_zones_2263.shp")
CPU = "cpu"


@pytest.fixture(autouse=True)
def disarmed():
    """Both packages disarmed after each test."""
    yield
    jfaults.disarm()
    faults.disarm()


def arm_both(spec):
    """The same spec armed in both packages: (jax plan, port plan)."""
    return jfaults.arm(spec), faults.arm(spec)


def same_array(j, t):
    """Equal geometry buffers: coords, offsets, types, srid."""
    for f in ("coords", "types", "geom_offsets", "part_offsets",
              "ring_offsets"):
        assert np.array_equal(np.asarray(getattr(j, f)),
                              np.asarray(getattr(t, f))), f
    pj, pt = j.part_types, t.part_types
    assert (pj is None) == (pt is None)
    if pj is not None:
        assert np.array_equal(np.asarray(pj), np.asarray(pt))
    assert j.ndim == t.ndim and j.srid == t.srid


def same_tile(j, t):
    """Bit-equal rasters with equal geotransforms, nodata, srid, meta."""
    assert np.asarray(j.data).dtype == np.asarray(t.data).dtype
    assert np.array_equal(np.asarray(j.data), np.asarray(t.data),
                          equal_nan=True)
    assert j.gt.to_tuple() == t.gt.to_tuple()
    assert np.array_equal(np.asarray(j.nodata, float),
                          np.asarray(t.nodata, float), equal_nan=True)
    assert (j.nodata is None) == (t.nodata is None) and j.srid == t.srid
    assert j.meta == t.meta


def same_tiles(js, ts):
    assert list(js) == list(ts)
    for k in js:
        same_tile(js[k], ts[k])


def same_records(je, te):
    assert [dataclasses.asdict(e) for e in je] == \
        [dataclasses.asdict(e) for e in te]


def both_wkt(wkts):
    return J.read_wkt(wkts), T.read_wkt(wkts)


def files_equal(a, b, exts):
    for ext in exts:
        with open(a + ext, "rb") as f, open(b + ext, "rb") as g:
            assert f.read() == g.read(), ext


@pytest.fixture
def zones():
    j, t = jzones(n_side=3, seed=8), tzones(n_side=3, seed=8)
    same_array(j, t)
    return j, t


# --------------------------------------------------------- shapefile

SHP_EXTS = (".shp", ".shx", ".dbf", ".prj")


def write_both_shp(tmp_path, name, jg, tg, cols=None):
    jp, tp = str(tmp_path / f"j_{name}.shp"), str(tmp_path / f"t_{name}.shp")
    jshp.write_shapefile(jp, jg, cols)
    tshp.write_shapefile(tp, tg, cols)
    files_equal(jp[:-4], tp[:-4], SHP_EXTS)
    return jp, tp


def read_cross(jread, tread, jp, tp, **kw):
    """Each reader on both files: all four results equal."""
    jj, jt = jread(jp, **kw), jread(tp, **kw)
    tj, tt = tread(jp, **kw), tread(tp, **kw)
    for j, t in ((jj, tj), (jt, tt), (jj, tt)):
        same_array(j[0], t[0])
        assert j[1] == t[1]
    return jj, tt


def test_shapefile_round_trip_polygons(tmp_path, zones):
    jz, tz = zones
    cols = {"zone_id": list(range(len(jz))),
            "name": [f"z{i}" for i in range(len(jz))],
            "score": [i * 1.5 for i in range(len(jz))]}
    jp, tp = write_both_shp(tmp_path, "zones", jz, tz, cols)
    _, (geoms, attrs) = read_cross(jshp.read_shapefile, tshp.read_shapefile,
                                   jp, tp)
    assert len(geoms) == len(tz) and attrs["zone_id"] == cols["zone_id"]
    assert attrs["name"] == cols["name"]
    assert np.allclose(attrs["score"], cols["score"])


def test_shapefile_polygon_with_hole(tmp_path):
    jg, tg = both_wkt(["POLYGON((0 0, 10 0, 10 10, 0 10, 0 0), "
                       "(3 3, 7 3, 7 7, 3 7, 3 3))"])
    jp, tp = write_both_shp(tmp_path, "hole", jg, tg)
    _, (geoms, _) = read_cross(jshp.read_shapefile, tshp.read_shapefile,
                               jp, tp)
    from mosaic_tpu_torch.core.geometry.clip import (geometry_rings,
                                                     ring_signed_area)
    rings = geometry_rings(geoms, 0)
    assert len(rings) == 2
    assert sum(ring_signed_area(r) for r in rings) == pytest.approx(84.0)


@pytest.mark.parametrize("wkts", [["POINT(1 2)", "POINT(-3 4.5)"],
                                  ["LINESTRING(0 0, 1 1, 2 0)"]])
def test_shapefile_points_and_lines(tmp_path, wkts):
    jg, tg = both_wkt(wkts)
    jp, tp = write_both_shp(tmp_path, "g", jg, tg)
    _, (geoms, _) = read_cross(jshp.read_shapefile, tshp.read_shapefile,
                               jp, tp)
    assert np.allclose(geoms.coords[:, :2], tg.coords[:, :2])


def test_shapefile_join_parity_vs_wkt(tmp_path, zones):
    """tests/test_shapefile.py's criterion on the port: shapefile ->
    tessellate -> PIP join equals the WKT-loaded path and the f64
    oracle exactly."""
    from mosaic_tpu_torch.parallel.pip_join import (build_pip_index,
                                                    make_streamed_pip_join,
                                                    pip_host_truth)
    jz, tz = zones
    jp, tp = write_both_shp(tmp_path, "zones", jz, tz)
    from_shp, _ = tshp.read_shapefile(tp)
    from_wkt = T.read_wkt(T.write_wkt(tz))
    grid = tgrid("H3")
    rng = np.random.default_rng(12)
    pts = np.stack([rng.uniform(-74.25, -73.70, 20_000),
                    rng.uniform(40.50, 40.90, 20_000)], -1)
    outs = []
    for polys in (from_shp, from_wkt):
        idx = build_pip_index(polys, 9, grid, device=CPU)
        zone, _ = make_streamed_pip_join(idx, grid, polys, device=CPU)(pts)
        outs.append(np.asarray(zone))
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], pip_host_truth(pts, from_wkt))


def test_read_vector_driver_dispatch(tmp_path, zones):
    jz, tz = zones
    jp, tp = write_both_shp(tmp_path, "zones", jz, tz)
    read_cross(jshp.read_vector, tshp.read_vector, jp, tp)
    wp = tmp_path / "zones.wkt"
    wp.write_text("\n".join(T.write_wkt(tz)))
    g_j, g_t = jshp.read_vector(str(wp)), tshp.read_vector(str(wp))
    same_array(g_j[0], g_t[0])
    assert len(g_t[0]) == len(tz) and g_t[1] == {}
    feats = [{"type": "Feature", "geometry": json.loads(s),
              "properties": {"i": i}}
             for i, s in enumerate(T.write_geojson(tz))]
    jpath = tmp_path / "zones.geojson"
    jpath.write_text(json.dumps({"type": "FeatureCollection",
                                 "features": feats}))
    g_j, g_t = jshp.read_vector(str(jpath)), tshp.read_vector(str(jpath))
    same_array(g_j[0], g_t[0])
    assert g_t[1] == g_j[1] and g_t[1]["i"] == list(range(len(tz)))
    for read in (jshp.read_vector, tshp.read_vector):
        with pytest.raises(ValueError):
            read("nope.xyz")


def test_shapefile_rejects_garbage(tmp_path):
    p = tmp_path / "bad.shp"
    p.write_bytes(b"not a shapefile at all")
    for read in (jshp.read_shapefile, tshp.read_shapefile):
        with pytest.raises(ValueError):
            read(str(p))


def test_real_2263_shapefile():
    """The reference Quickstart's zones in EPSG:2263: equal geometries,
    srid and .dbf columns."""
    j, t = jshp.read_shapefile(SHP_FIX), tshp.read_shapefile(SHP_FIX)
    same_array(j[0], t[0])
    assert j[1] == t[1]
    assert t[0].srid == 2263 and len(t[0]) == 35


@pytest.mark.parametrize("prj,want", [
    ('GEOGCS["GCS_North_American_1983",AUTHORITY["EPSG","4269"]]', 4326),
    ('PROJCS["Custom_Lambert",UNIT["Meter",1.0,AUTHORITY["EPSG","9001"]]]',
     4326),
    ('PROJCS["NAD_1983_StatePlane_New_York_Long_Island_FIPS_3104_Feet",'
     'GEOGCS["GCS_North_American_1983"]]', 2263),
    ('PROJCS["British_National_Grid",AUTHORITY["EPSG","27700"]]', 27700),
    ('PROJCS["WGS_1984_UTM_Zone_18N"]', 32618),
])
def test_prj_to_epsg(prj, want):
    assert tshp._prj_to_epsg(prj) == jshp._prj_to_epsg(prj) == want


def test_esri_prj_spelling_detected(tmp_path):
    for ext in (".shp", ".shx", ".dbf"):
        shutil.copy(os.path.join(DATA, "nyc_taxi_zones_2263" + ext),
                    tmp_path / ("z" + ext))
    (tmp_path / "z.prj").write_text(
        'PROJCS["NAD_1983_StatePlane_New_York_Long_Island_'
        'FIPS_3104_Feet",GEOGCS["GCS_North_American_1983"]]')
    j = jshp.read_shapefile(str(tmp_path / "z.shp"))
    t = tshp.read_shapefile(str(tmp_path / "z.shp"))
    same_array(j[0], t[0])
    assert t[0].srid == 2263


# -------------------------------------------------------- geopackage

GPKG_WKTS = ["POINT (1 2)",
             "POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0), "
             "(0.5 0.5, 1.5 0.5, 1.5 1.5, 0.5 1.5, 0.5 0.5))",
             "MULTIPOLYGON (((5 5, 6 5, 6 6, 5 5)))",
             "LINESTRING (0 0, 3 4)"]
GPKG_ATTRS = {"name": ["a", "b", "c", "d"], "score": [1.5, 2.5, -3.0, 0.0]}


@pytest.fixture
def gpkg_pair(tmp_path):
    jg, tg = both_wkt(GPKG_WKTS)
    jp, tp = str(tmp_path / "j.gpkg"), str(tmp_path / "t.gpkg")
    jgpkg.write_gpkg(jp, jg, GPKG_ATTRS, layer="stuff", srs_id=4326)
    tgpkg.write_gpkg(tp, tg, GPKG_ATTRS, layer="stuff", srs_id=4326)
    return jp, tp, tg


def gpkg_dump(path):
    """Every table's rows (the catalog and the layer) of a GeoPackage."""
    con = sqlite3.connect(path)
    try:
        names = [r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "ORDER BY name")]
        return {n: con.execute(f'SELECT * FROM "{n}"').fetchall()
                for n in names}, con.execute(
            "PRAGMA application_id").fetchone(), con.execute(
            "PRAGMA user_version").fetchone()
    finally:
        con.close()


def test_gpkg_round_trip(gpkg_pair):
    jp, tp, tg = gpkg_pair
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    assert gpkg_dump(jp) == gpkg_dump(tp)
    assert tgpkg.gpkg_layers(tp) == jgpkg.gpkg_layers(tp) == ["stuff"]
    _, (got, cols) = read_cross(jgpkg.read_gpkg, tgpkg.read_gpkg, jp, tp)
    assert T.write_wkt(got) == T.write_wkt(tg)
    assert {k: cols[k] for k in GPKG_ATTRS} == GPKG_ATTRS
    assert got.srid == 4326


def test_gpkg_read_vector_dispatch(gpkg_pair):
    jp, tp, tg = gpkg_pair
    read_cross(jshp.read_vector, tshp.read_vector, jp, tp)
    read_cross(jshp.read_vector, tshp.read_vector, jp, tp, driver="GPKG")
    assert T.write_wkt(tshp.read_vector(tp)[0]) == T.write_wkt(tg)


def test_gpkg_layer_selection_and_errors(gpkg_pair, tmp_path):
    _, tp, _ = gpkg_pair
    for read in (jgpkg.read_gpkg, tgpkg.read_gpkg):
        with pytest.raises(ValueError, match="no layer"):
            read(tp, layer="nope")
    bad = str(tmp_path / "bad.gpkg")
    sqlite3.connect(bad).execute("CREATE TABLE t (x)")
    for read in (jgpkg.read_gpkg, tgpkg.read_gpkg):
        with pytest.raises((ValueError, sqlite3.OperationalError)):
            read(bad)


def test_gpkg_gpb_envelope_variants(tmp_path):
    _, tg = both_wkt(["POINT (7 8)"])
    path = str(tmp_path / "env.gpkg")
    tgpkg.write_gpkg(path, tg, layer="pts")
    con = sqlite3.connect(path)
    wkb = T.write_wkb(tg)[0]
    hdr = b"GP" + bytes([0, 0x03]) + struct.pack("<i", 4326) + \
        struct.pack("<4d", 7, 7, 8, 8)        # envelope code 1
    con.execute('UPDATE "pts" SET geom = ?', (hdr + wkb,))
    con.commit()
    con.close()
    j, t = jgpkg.read_gpkg(path), tgpkg.read_gpkg(path)
    same_array(j[0], t[0])
    assert T.write_wkt(t[0]) == ["POINT (7 8)"]


# ------------------------------------------------------------- grib

@pytest.fixture(scope="module")
def grib_bytes():
    with open(GRIB_FIX, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def grib_tiles(grib_bytes):
    j, t = jgrib.read_grib(grib_bytes), tgrib.read_grib(grib_bytes)
    same_tiles(j, t)
    return t


def test_grib_message_count_and_shapes(grib_tiles, grib_bytes):
    assert len(grib_tiles) == 14
    for t in grib_tiles.values():
        assert t.data.shape == (1, 14, 14) and np.isfinite(t.data).all()
    assert tgrib.grib_subdatasets(grib_bytes) == \
        jgrib.grib_subdatasets(grib_bytes)


def test_grib_values_plausible(grib_tiles):
    first = grib_tiles[sorted(grib_tiles)[0]].data
    assert 1e-7 < np.nanmean(first) < 1e-5


def test_grib_georeferencing(grib_tiles):
    t = grib_tiles[sorted(grib_tiles)[0]]
    assert t.gt.px_w == pytest.approx(0.75)
    assert t.gt.px_h == pytest.approx(-0.75)
    assert t.gt.y0 > t.gt.y0 + 14 * t.gt.px_h


def test_grib_editions_mixed(grib_tiles):
    assert {t.meta.get("edition") for t in grib_tiles.values()} == \
        {"1", "2"}


def test_grib_raster_api_dispatch():
    jmc, tmc = JContext.build("H3"), TContext("H3", device=CPU)
    jt, tt = jmc.rst_fromfile([GRIB_FIX])[0], tmc.rst_fromfile([GRIB_FIX])[0]
    same_tile(jt, tt)
    assert tt.meta["driver"] == "GRIB"
    subs = tmc.rst_subdatasets([tt])[0]
    assert subs == jmc.rst_subdatasets([jt])[0] and len(subs) == 14
    other = sorted(subs)[1]
    same_tile(jmc.rst_getsubdataset([jt], other)[0],
              tmc.rst_getsubdataset([tt], other)[0])


def test_grib_raster_to_grid(grib_tiles, grib_bytes):
    """Real CAMS data through both raster->H3 pipelines: equal cells."""
    from mosaic_tpu.io.raster_grid import raster_to_grid as jr2g
    from mosaic_tpu_torch.io.raster_grid import raster_to_grid as tr2g
    jt = jgrib.read_grib(grib_bytes)
    name = sorted(grib_tiles)[0]
    want = jr2g([jt[name]], 2, jgrid("H3"), combiner="avg")
    got = tr2g([grib_tiles[name]], 2, tgrid("H3"), combiner="avg",
               device=CPU)
    assert got == want and len(got) > 10


# ------------------------------------------------------- vector tiles

@pytest.fixture(scope="module")
def tile_zones():
    j, t = jzones(n_side=4, seed=2), tzones(n_side=4, seed=2)
    same_array(j, t)
    return j, t


def _nyc_tile():
    z = 12
    lon, lat = -74.0, 40.72
    n = 2 ** z
    x = int((lon + 180) / 360 * n)
    y = int((1 - math.asinh(math.tan(math.radians(lat))) / math.pi)
            / 2 * n)
    return z, x, y


def same_mvt(a, b):
    assert list(a) == list(b)
    for name in a:
        la, lb = a[name], b[name]
        for k in ("keys", "values", "extent", "name", "version"):
            assert la[k] == lb[k], k
        assert len(la["features"]) == len(lb["features"])
        for fa, fb in zip(la["features"], lb["features"]):
            assert {k: fa[k] for k in ("id", "type", "tags")} == \
                {k: fb[k] for k in ("id", "type", "tags")}
            assert len(fa["rings"]) == len(fb["rings"])
            for ra, rb in zip(fa["rings"], fb["rings"]):
                assert np.array_equal(ra, rb)


def test_mvt_round_trip(tile_zones):
    jz, tz = tile_zones
    z, x, y = _nyc_tile()
    attrs = {"zone": [f"z{i}" for i in range(len(tz))],
             "score": list(range(len(tz)))}
    blob = tmvt.st_asmvttileagg(tz, attrs, z, x, y, layer="zones",
                                device=CPU)
    assert blob == jmvt.st_asmvttileagg(jz, attrs, z, x, y, layer="zones")
    dec = tmvt.decode_mvt(blob)
    same_mvt(dec, jmvt.decode_mvt(blob))
    lay = dec["zones"]
    assert lay["version"] == 2 and lay["extent"] == 4096
    assert len(lay["features"]) > 0 and lay["keys"] == ["zone", "score"]
    for f in lay["features"]:
        assert f["type"] == 3
        for ring in f["rings"]:
            assert len(ring) >= 3
            assert (ring >= -2).all() and (ring <= 4098).all()


def test_mvt_empty_tile(tile_zones):
    jz, tz = tile_zones
    blob = tmvt.st_asmvttileagg(tz, None, 12, 0, 0, device=CPU)
    assert blob == jmvt.st_asmvttileagg(jz, None, 12, 0, 0)
    assert len(tmvt.decode_mvt(blob)["layer"]["features"]) == 0


def test_mvt_lines_and_points():
    wkts = ["LINESTRING (-74.2 40.6, -73.9 40.8, -73.5 40.9)",
            "MULTIPOINT ((-73.99 40.72), (-80 10))",
            "POINT (-73.98 40.73)"]
    jg, tg = both_wkt(wkts)
    z, x, y = 8, *(_nyc_tile()[1:])
    x, y = x >> 4, y >> 4
    blob = tmvt.st_asmvttileagg(tg, {"k": [1.5, True, "s"]}, z, x, y,
                                device=CPU)
    assert blob == jmvt.st_asmvttileagg(jg, {"k": [1.5, True, "s"]}, z, x,
                                        y)
    same_mvt(tmvt.decode_mvt(blob), jmvt.decode_mvt(blob))
    assert tmvt.st_asgeojsontileagg(tg, None, z, x, y, device=CPU) == \
        jmvt.st_asgeojsontileagg(jg, None, z, x, y)


def test_geojson_tile_agg(tile_zones):
    jz, tz = tile_zones
    z, x, y = _nyc_tile()
    out = tmvt.st_asgeojsontileagg(tz, {"i": list(range(len(tz)))}, z, x,
                                   y, device=CPU)
    assert out == jmvt.st_asgeojsontileagg(jz, {"i": list(range(len(jz)))},
                                           z, x, y)
    fc = json.loads(out)
    assert fc["type"] == "FeatureCollection" and len(fc["features"]) > 0
    box = tmvt.tile_envelope_4326(z, x, y)
    assert box == jmvt.tile_envelope_4326(z, x, y)
    for f in fc["features"]:
        coords = np.array(f["geometry"]["coordinates"][0][0])
        assert (coords[:, 0] >= box[0] - 1e-9).all()
        assert (coords[:, 0] <= box[2] + 1e-9).all()


def test_geojson_tile_agg_keeps_holes():
    wkts = ["POLYGON ((-74.1 40.6, -73.9 40.6, -73.9 40.8, -74.1 40.8, "
            "-74.1 40.6), (-74.0 40.7, -73.98 40.7, -73.98 40.72, "
            "-74.0 40.72, -74.0 40.7))"]
    jg, tg = both_wkt(wkts)
    z, x, y = _nyc_tile()
    for zz, xx, yy in ((z - 4, x >> 4, y >> 4), (z, x, y)):
        assert tmvt.st_asgeojsontileagg(tg, None, zz, xx, yy,
                                        device=CPU) == \
            jmvt.st_asgeojsontileagg(jg, None, zz, xx, yy)


def test_tile_agg_mixed_rows_one_clip(monkeypatch):
    """Polygon rows between point and line rows, a donut and a
    multipolygon whose first part misses the tile: both aggregators
    equal the JAX package's, and each clips every polygon ring of the
    batch in one call."""
    wkts = ["POINT (-73.98 40.73)",
            "POLYGON ((-74.1 40.6, -73.9 40.6, -73.9 40.8, -74.1 40.8, "
            "-74.1 40.6), (-74.0 40.7, -73.98 40.7, -73.98 40.72, "
            "-74.0 40.72, -74.0 40.7))",
            "LINESTRING (-74.2 40.6, -73.9 40.8, -73.5 40.9)",
            "MULTIPOLYGON (((10 10, 11 10, 11 11, 10 10)), "
            "((-74.05 40.65, -73.95 40.65, -73.95 40.75, -74.05 40.65)))",
            "POLYGON ((-73.99 40.71, -73.97 40.71, -73.97 40.73, "
            "-73.99 40.71))"]
    jg, tg = both_wkt(wkts)
    z, x, y = _nyc_tile()
    calls = []
    real = tmvt._clip_rings_to_box_aligned
    monkeypatch.setattr(tmvt, "_clip_rings_to_box_aligned",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    attrs = {"i": list(range(len(wkts)))}
    for zz, xx, yy in ((z - 4, x >> 4, y >> 4), (z - 2, x >> 2, y >> 2)):
        assert tmvt.st_asmvttileagg(tg, attrs, zz, xx, yy, device=CPU) == \
            jmvt.st_asmvttileagg(jg, attrs, zz, xx, yy)
        assert tmvt.st_asgeojsontileagg(tg, attrs, zz, xx, yy,
                                        device=CPU) == \
            jmvt.st_asgeojsontileagg(jg, attrs, zz, xx, yy)
    assert len(calls) == 4


def test_analyzer_optimal_resolution(tile_zones):
    jz, tz = tile_zones
    res = TContext("H3", device=CPU).get_optimal_resolution(tz)
    assert res == JContext.build("H3").get_optimal_resolution(jz)
    assert 6 <= res <= 10


def test_try_sql():
    mc = TContext("H3", device=CPU)
    assert mc.try_sql(mc.st_geomfromwkt, ["POINT(1 2)"]) is not None
    assert mc.try_sql(mc.st_geomfromwkt, ["POINT(1"]) is None


def test_read_strategies(tmp_path):
    from mosaic_tpu_torch.core.raster.checkpoint import deserialize_tile
    from mosaic_tpu_torch.core.raster.gtiff import write_gtiff
    from mosaic_tpu_torch.io.raster_grid import read_gtiff_files
    from mosaic_tpu.io.raster_grid import read_gtiff_files as jread
    gt = T.GeoTransform(-74.1, 0.01, 0.0, 40.9, 0.0, -0.01)
    t = T.RasterTile(np.arange(600.0).reshape(1, 20, 30), gt)
    p = str(tmp_path / "t.tif")
    open(p, "wb").write(write_gtiff(t))
    mem = read_gtiff_files([p])
    same_tile(jread([p])[0], mem[0])
    recs = read_gtiff_files([p], strategy="as_path")
    assert recs == jread([p], strategy="as_path") and recs[0]["raster"] == p
    assert np.array_equal(np.asarray(deserialize_tile(recs[0]).data),
                          np.asarray(t.data))
    with pytest.raises(ValueError):
        read_gtiff_files([p], strategy="bogus")


def test_call_by_name(tile_zones):
    jz, tz = tile_zones
    mc = TContext("H3", device=CPU)
    area = mc.call("st_area", tz)
    assert np.array_equal(area, JContext.build("H3").call("st_area", jz))
    with pytest.raises(ValueError):
        mc.call("st_nonexistent", tz)


# ------------------------------------------------------------ arrow

@pytest.fixture(scope="module")
def chips():
    from mosaic_tpu.core.tessellate import tessellate as jtess
    from mosaic_tpu_torch.core.tessellate import tessellate as ttess
    jz, tz = jzones(3, seed=4), tzones(3, seed=4)
    jc = jtess(jz, 8, jgrid("H3"))
    tc = ttess(tz, 8, tgrid("H3"), device=CPU)
    return jc, tc


def test_arrow_round_trip(chips):
    pytest.importorskip("pyarrow")
    jc, tc = chips
    jt, tt = jarrow.chips_to_arrow(jc), tarrow.chips_to_arrow(tc)
    assert tt.equals(jt)
    blob = tarrow.table_to_ipc(tt)
    assert blob == jarrow.table_to_ipc(jt)
    back = tarrow.chips_from_arrow(tarrow.table_from_ipc(blob))
    jback = jarrow.chips_from_arrow(jarrow.table_from_ipc(blob))
    for f in ("geom_id", "cell_id", "is_core"):
        assert np.array_equal(getattr(back, f), getattr(tc, f))
        assert np.array_equal(getattr(jback, f), getattr(back, f))
    same_array(jback.geoms, back.geoms)
    assert np.allclose(back.geoms.coords[:, :2], tc.geoms.coords[:, :2])


# ----------------------------------------------------- netcdf, zarr

@pytest.fixture
def nc_blob():
    h, w = 12, 17
    yy, xx = np.mgrid[0:h, 0:w]
    sst = (xx * 1.5 + yy).astype(np.float64)
    chl = (xx - yy).astype(np.float64)
    xs = -74.0 + 0.25 * np.arange(w)
    ys = 40.0 + 0.25 * np.arange(h)          # south-up: reader flips
    blob = tnc.write_netcdf({"sst": sst, "chl": chl}, xs=xs, ys=ys,
                            fill_value=-999.0)
    assert blob == jnc.write_netcdf({"sst": sst, "chl": chl}, xs=xs,
                                    ys=ys, fill_value=-999.0)
    return blob, sst, xs, ys


def test_netcdf_round_trip(nc_blob):
    blob, sst, xs, ys = nc_blob
    subs = tnc.read_netcdf(blob)
    same_tiles(jnc.read_netcdf(blob), subs)
    assert sorted(subs) == ["chl", "sst"]
    t = subs["sst"]
    np.testing.assert_array_equal(np.asarray(t.data)[0], sst[::-1])
    assert t.gt.px_h < 0 and t.nodata == -999.0
    x0, y0 = t.gt.to_world(0.5, 0.5)
    assert x0 == pytest.approx(xs[0]) and y0 == pytest.approx(ys[-1])
    assert tnc.netcdf_subdatasets(blob) == ["chl", "sst"]


def test_netcdf_default_coords_round_trip():
    a = np.random.default_rng(9).normal(size=(5, 7))
    blob = tnc.write_netcdf({"v": a})
    assert blob == jnc.write_netcdf({"v": a})
    same_tiles(jnc.read_netcdf(blob), tnc.read_netcdf(blob))


@pytest.mark.parametrize("blob", [b"\x89HDF\r\n\x1a\nrest", b"garbage"])
def test_netcdf_rejects_hdf5(blob):
    for read in (jnc.read_netcdf, tnc.read_netcdf):
        with pytest.raises(ValueError):
            read(blob)


def test_netcdf_through_function_surface(nc_blob, tmp_path):
    blob = nc_blob[0]
    p = tmp_path / "coral.nc"
    p.write_bytes(blob)
    jmc, tmc = JContext.build("H3"), TContext("H3", device=CPU)
    tiles = tmc.rst_fromfile([str(p)])
    jtiles = jmc.rst_fromfile([str(p)])
    same_tile(jtiles[0], tiles[0])
    assert tiles[0].meta["driver"] == "netcdf"
    assert tmc.rst_subdatasets(tiles)[0] == {"chl": "chl", "sst": "sst"}
    same_tile(jmc.rst_getsubdataset(jtiles, "sst")[0],
              tmc.rst_getsubdataset(tiles, "sst")[0])
    with pytest.raises(ValueError):
        tmc.rst_getsubdataset(tiles, "nope")


def tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            full = os.path.join(d, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, root)] = fh.read()
    return out


@pytest.mark.parametrize("compress", [False, True])
def test_zarr_round_trip(tmp_path, compress):
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 10, (9, 14))
    b = rng.uniform(0, 1, (2, 9, 14))
    kw = dict(chunks=None, geotransform=(-74.0, 0.1, 0.0, 41.0, 0.0, -0.1),
              compress=compress)
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jzarr.write_zarr(jp, {"elev": a, "rgbish": b}, **kw)
    tzarr.write_zarr(tp, {"elev": a, "rgbish": b}, **kw)
    assert tree_bytes(jp) == tree_bytes(tp)
    subs = tzarr.read_zarr(tp)
    same_tiles(jzarr.read_zarr(tp), subs)
    same_tiles(jzarr.read_zarr(jp), tzarr.read_zarr(jp))
    assert sorted(subs) == ["elev", "rgbish"]
    np.testing.assert_array_equal(np.asarray(subs["elev"].data)[0], a)
    np.testing.assert_array_equal(np.asarray(subs["rgbish"].data), b)
    assert tzarr.zarr_subdatasets(tp) == ["elev", "rgbish"]


def test_zarr_chunked(tmp_path):
    a = np.arange(130.0).reshape(10, 13)
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jzarr.write_zarr(jp, {"v": a}, chunks=(4, 5))
    tzarr.write_zarr(tp, {"v": a}, chunks=(4, 5))
    assert tree_bytes(jp) == tree_bytes(tp)
    back = tzarr.read_zarr(tp)["v"]
    same_tile(jzarr.read_zarr(tp)["v"], back)
    np.testing.assert_array_equal(np.asarray(back.data)[0], a)


def test_zarr_zip_store(tmp_path):
    import zipfile
    a = np.arange(24.0).reshape(4, 6)
    d = str(tmp_path / "z")
    tzarr.write_zarr(d, {"v": a}, chunks=(3, 4))
    zp = str(tmp_path / "z.zip")
    with zipfile.ZipFile(zp, "w") as z:
        for rel, raw in sorted(tree_bytes(d).items()):
            z.writestr(rel, raw)
    same_tiles(jzarr.read_zarr(zp), tzarr.read_zarr(zp))
    for read in (jzarr.read_zarr, tzarr.read_zarr):
        with pytest.raises(ValueError):
            read(str(tmp_path / "nope.bin"))


def test_zarr_through_function_surface(tmp_path):
    a = np.ones((6, 6))
    path = str(tmp_path / "z")
    tzarr.write_zarr(path, {"only": a})
    jmc, tmc = JContext.build("H3"), TContext("H3", device=CPU)
    tiles, jtiles = tmc.rst_fromfile([path]), jmc.rst_fromfile([path])
    same_tile(jtiles[0], tiles[0])
    assert tiles[0].meta["driver"] == "zarr"
    got = tmc.rst_getsubdataset(tiles, "only")[0]
    same_tile(jmc.rst_getsubdataset(jtiles, "only")[0], got)
    np.testing.assert_array_equal(np.asarray(got.data)[0], a)


# ------------------------------------------------- chaos (IO sites)

@pytest.fixture
def counters():
    """Both metrics registries on and empty; their io/records_dropped
    counters read as (jax, port)."""
    was_j, was_t = jmetrics.enabled, metrics.enabled
    jmetrics.reset()
    metrics.reset()
    jmetrics.enable()
    metrics.enable()

    def read():
        return (jmetrics.counter_value("io/records_dropped"),
                metrics.counter_value("io/records_dropped"))
    yield read
    jmetrics.reset()
    metrics.reset()
    if not was_j:
        jmetrics.disable()
    if not was_t:
        metrics.disable()


def test_chaos_grib_message_failure_skip(grib_bytes, counters):
    clean = tgrib.read_grib(grib_bytes)
    jplan, plan = arm_both(
        "seed=22;site=grib.read_message,fails=1,error=ValueError")
    je, te = [], []
    want = jgrib.read_grib(grib_bytes, on_error="skip", path="cams.grb",
                           errors=je)
    out = tgrib.read_grib(grib_bytes, on_error="skip", path="cams.grb",
                          errors=te)
    same_tiles(want, out)
    same_records(je, te)
    assert plan.injected == jplan.injected and len(plan.injected) == 1
    assert te[0].feature == "message 0" and te[0].path == "cams.grb"
    assert set(out) < set(clean)
    assert counters() == (1, 1)


def test_chaos_grib_message_failure_raise(grib_bytes):
    arm_both("seed=22;site=grib.read_message,fails=1,error=ValueError")
    for read in (jgrib.read_grib, tgrib.read_grib):
        with pytest.raises(ValueError, match="message 0"):
            read(grib_bytes)


@pytest.mark.parametrize("mode", ["skip", "null"])
def test_chaos_shapefile_record_corruption(mode, counters):
    clean_g, clean_c = tshp.read_shapefile(SHP_FIX)
    n = len(clean_g)
    jplan, plan = arm_both(
        "seed=23;site=shapefile.read_record,fails=1,mode=truncate")
    je, te = [], []
    want = jshp.read_shapefile(SHP_FIX, on_error=mode, errors=je)
    geoms, cols = tshp.read_shapefile(SHP_FIX, on_error=mode, errors=te)
    same_array(want[0], geoms)
    assert cols == want[1]
    same_records(je, te)
    assert plan.injected == jplan.injected and len(plan.injected) == 1
    assert len(te) == 1 and te[0].feature == "record 0"
    if mode == "skip":
        assert len(geoms) == n - 1
        assert all(v == clean_c[k][1:] for k, v in cols.items())
    else:
        assert len(geoms) == n and cols == clean_c
        assert geoms.geom_type(0) == T.GeometryType.GEOMETRYCOLLECTION
    assert counters() == (1, 1)


def test_chaos_dbf_bad_numeric_degrades_to_null(tmp_path, counters):
    jb, tb = J.GeometryBuilder(), T.GeometryBuilder()
    for x in (0.0, 2.0, 4.0):
        jb.add_point(np.array([x, 0.0]))
        tb.add_point(np.array([x, 0.0]))
    jp, tp = write_both_shp(tmp_path, "pts", jb.finish(), tb.finish(),
                            {"val": [1, 2, 3]})
    for p in (jp, tp):
        with open(p[:-4] + ".dbf", "rb") as f:
            buf = f.read()
        patched = buf.replace(b" " * 17 + b"2", b" " * 17 + b"x")
        assert patched != buf
        with open(p[:-4] + ".dbf", "wb") as f:
            f.write(patched)
    for read in (jshp.read_shapefile, tshp.read_shapefile):
        with pytest.raises(ValueError, match="field val"):
            read(tp)
    je, te = [], []
    want = jshp.read_shapefile(jp, on_error="skip", errors=je)
    geoms, cols = tshp.read_shapefile(tp, on_error="skip", errors=te)
    assert len(geoms) == 3 and cols == want[1] == {"val": [1, None, 3]}
    assert len(te) == 1 and "field val" in te[0].feature
    assert te[0].feature == je[0].feature
    assert counters() == (1, 1)


def test_chaos_netcdf_truncated_variable_skip(counters):
    a = np.arange(12.0).reshape(3, 4)
    blob = tnc.write_netcdf({"aa": a, "zz": a * 2})
    damaged = blob[:-16]
    for read in (jnc.read_netcdf, tnc.read_netcdf):
        with pytest.raises(ValueError, match="variable zz"):
            read(damaged, path="t.nc")
    je, te = [], []
    want = jnc.read_netcdf(damaged, on_error="skip", errors=je)
    out = tnc.read_netcdf(damaged, on_error="skip", errors=te)
    same_tiles(want, out)
    same_records(je, te)
    assert set(out) == {"aa"} and te[0].feature == "variable zz"
    assert counters() == (1, 1)


def test_chaos_gpkg_malformed_blob_skip(tmp_path, counters):
    jb, tb = J.GeometryBuilder(), T.GeometryBuilder()
    for x in (0.0, 1.0, 2.0):
        ring = np.array([[x, 0.0], [x + 0.5, 0.0], [x + 0.5, 0.5],
                         [x, 0.5], [x, 0.0]])
        jb.add_polygon(ring)
        tb.add_polygon(ring)
    jp, tp = str(tmp_path / "j.gpkg"), str(tmp_path / "t.gpkg")
    jgpkg.write_gpkg(jp, jb.finish(), {"fid_val": [10, 20, 30]})
    tgpkg.write_gpkg(tp, tb.finish(), {"fid_val": [10, 20, 30]})
    for p in (jp, tp):
        con = sqlite3.connect(p)
        con.execute("UPDATE layer SET geom = X'DEADBEEF' WHERE rowid = 2")
        con.commit()
        con.close()
    for read in (jgpkg.read_gpkg, tgpkg.read_gpkg):
        with pytest.raises(ValueError, match="row 1"):
            read(tp)
    je, te = [], []
    want = jgpkg.read_gpkg(jp, on_error="skip", errors=je)
    geoms, cols = tgpkg.read_gpkg(tp, on_error="skip", errors=te)
    same_array(want[0], geoms)
    assert cols == want[1] and cols["fid_val"] == [10, 30]
    assert len(te) == 1 and te[0].feature == je[0].feature == "row 1"
    assert counters() == (1, 1)


def test_chaos_mvt_feature_failures_skip(counters):
    jb, tb = J.GeometryBuilder(), T.GeometryBuilder()
    for x in (-0.4, 0.2, 0.4):
        ring = np.array([[x, 0.1], [x + 0.1, 0.1], [x + 0.1, 0.2],
                         [x, 0.2], [x, 0.1]])
        jb.add_polygon(ring)
        tb.add_polygon(ring)
    blob = tmvt.st_asmvttileagg(tb.finish(), {"v": [1, 2, 3]}, 0, 0, 0,
                                device=CPU)
    assert blob == jmvt.st_asmvttileagg(jb.finish(), {"v": [1, 2, 3]}, 0,
                                        0, 0)
    assert len(tmvt.decode_mvt(blob)["layer"]["features"]) == 3
    jplan, plan = arm_both(
        "seed=27;site=mvt.decode_feature,rate=0.5,error=ValueError")
    je, te = [], []
    want = jmvt.decode_mvt(blob, on_error="skip", errors=je)
    out = tmvt.decode_mvt(blob, on_error="skip", errors=te)
    same_mvt(want, out)
    same_records(je, te)
    assert plan.injected == jplan.injected
    assert len(out["layer"]["features"]) + len(te) == 3
    assert 1 <= len(te) == len([1 for s, _, _ in plan.injected
                                if s == "mvt.decode_feature"])
    assert counters() == (len(te), len(te))


def test_chaos_gpkg_row_corruption_skip_drops_only_that_row(tmp_path,
                                                           counters):
    wkts = ["POINT (1 2)", "POINT (3 4)", "LINESTRING (0 0, 3 4)"]
    jg, tg = both_wkt(wkts)
    path = str(tmp_path / "chaos.gpkg")
    tgpkg.write_gpkg(path, tg, {"name": ["a", "b", "c"]}, layer="t",
                     srs_id=4326)
    jplan, plan = arm_both(
        "seed=43;site=gpkg.read_row,fails=1,error=ValueError")
    je, te = [], []
    want = jgpkg.read_gpkg(path, on_error="skip", errors=je)
    got, cols = tgpkg.read_gpkg(path, on_error="skip", errors=te)
    same_array(want[0], got)
    assert T.write_wkt(got) == wkts[1:] and cols == want[1]
    assert cols["name"] == ["b", "c"]
    same_records(je, te)
    assert plan.injected == jplan.injected
    assert ("gpkg.read_row", 0, "ValueError") in plan.injected
    assert counters() == (1, 1)
    faults.disarm()
    got2, cols2 = tgpkg.read_gpkg(path)
    assert T.write_wkt(got2) == wkts and cols2["name"] == ["a", "b", "c"]


def test_chaos_shapefile_open_fault_then_clean_read():
    jplan, plan = arm_both(
        "seed=61;site=shapefile.read,fails=1,error=OSError")
    for read in (jshp.read_shapefile, tshp.read_shapefile):
        with pytest.raises(OSError):
            read(SHP_FIX)
    assert plan.injected == jplan.injected == \
        [("shapefile.read", 0, "OSError")]
    faults.disarm()
    jfaults.disarm()
    j, t = jshp.read_shapefile(SHP_FIX), tshp.read_shapefile(SHP_FIX)
    same_array(j[0], t[0])
    assert j[1] == t[1]


def test_chaos_netcdf_open_fault_then_clean_read():
    h, w = 6, 9
    yy, xx = np.mgrid[0:h, 0:w]
    blob = tnc.write_netcdf({"sst": (xx + yy).astype(np.float64)},
                            xs=0.5 + np.arange(w), ys=0.5 + np.arange(h))
    jplan, plan = arm_both(
        "seed=62;site=netcdf.read,fails=1,error=OSError")
    for read in (jnc.read_netcdf, tnc.read_netcdf):
        with pytest.raises(OSError):
            read(blob)
    assert plan.injected == jplan.injected == \
        [("netcdf.read", 0, "OSError")]
    faults.disarm()
    jfaults.disarm()
    subs = tnc.read_netcdf(blob)
    same_tiles(jnc.read_netcdf(blob), subs)
    np.testing.assert_array_equal(np.asarray(subs["sst"].data)[0],
                                  (xx + yy).astype(np.float64)[::-1])
