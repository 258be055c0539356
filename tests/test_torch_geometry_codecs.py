"""The port's WKB and GeoJSON codecs against the JAX package.

``mosaic_tpu_torch.core.geometry.wkb`` and ``geojson`` are copies of the
JAX package's pure-numpy codecs.  On tests/test_geometry_core.py's
geometries (every type, a hole, multi-parts, a collection), Z
coordinates, tests/test_hard_ops.py's collection whose closed linestring
must stay a linestring, and a seeded POINT batch (the vectorized fast
path): the WKB bytes and the GeoJSON texts equal the JAX package's
exactly, each package reads the other's output into equal buffers, and
round trips give the input back.  The codecs are exported from the
port's top level, as ``mosaic_tpu/__init__.py`` exports them.
(tests/test_codecs.py's NetCDF and Zarr codecs are held in
tests/test_torch_io.py.)
"""

import struct

import numpy as np

import mosaic_tpu as J
import mosaic_tpu_torch as T

WKTS = [
    "POINT (1 2)",
    "LINESTRING (0 0, 1 1, 2 0)",
    "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (2 2, 4 2, 4 4, 2 4, 2 2))",
    "MULTIPOINT ((1 1), (2 2))",
    "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3))",
    "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)), ((5 5, 6 5, 6 6, 5 6, 5 5)))",
    "GEOMETRYCOLLECTION (POINT (1 1), LINESTRING (0 0, 1 1))",
    "GEOMETRYCOLLECTION (LINESTRING (0 0, 10 0, 10 10, 0 10, 0 0), "
    "POINT (1 1), POLYGON ((2 2, 3 2, 3 3, 2 3, 2 2)))",
    "POLYGON ((-74.02 40.70, -73.95 40.70, -73.95 40.76, -74.02 40.76, "
    "-74.02 40.70))",
]
Z_WKTS = ["POINT Z (1 2 3)", "LINESTRING Z (0 0 1, 1 1 2)"]


def _same_array(j, t):
    for f in ("coords", "types", "geom_offsets", "part_offsets",
              "ring_offsets"):
        assert np.array_equal(np.asarray(getattr(j, f)),
                              np.asarray(getattr(t, f))), f
    pj, pt = j.part_types, t.part_types
    assert (pj is None) == (pt is None)
    if pj is not None:
        assert np.array_equal(np.asarray(pj), np.asarray(pt))
    assert j.ndim == t.ndim and j.srid == t.srid


def test_exports():
    for name in ("read_wkb", "write_wkb", "read_geojson", "write_geojson"):
        assert name in T.__all__
        assert getattr(T, name).__module__.startswith("mosaic_tpu_torch.")


def test_wkb_bytes_equal_and_cross_read():
    for wkts in (WKTS, Z_WKTS):
        ja, ta = J.read_wkt(wkts), T.read_wkt(wkts)
        jb, tb = J.write_wkb(ja), T.write_wkb(ta)
        assert jb == tb
        _same_array(J.read_wkb(tb), T.read_wkb(jb))
        back = T.read_wkb(tb)
        assert np.allclose(back.coords, ta.coords)
        assert np.array_equal(back.types, ta.types)
        assert np.array_equal(back.ring_offsets, ta.ring_offsets)
    assert T.read_wkb(T.write_wkb(T.read_wkt(Z_WKTS))).ndim == 3


def test_wkb_point_fast_path():
    pts = np.random.default_rng(3).uniform(-180, 180, (500, 2))
    ja = J.GeometryArray.from_points(pts)
    ta = T.GeometryArray.from_points(pts)
    jb, tb = J.write_wkb(ja), T.write_wkb(ta)
    assert jb == tb
    back = T.read_wkb(tb)
    assert np.array_equal(back.coords, pts)
    assert all(t == T.GeometryType.POINT for t in back.types)
    _same_array(J.read_wkb(jb), back)


def test_wkb_big_endian_and_ewkb_srid():
    """Big-endian WKB and SRID-carrying EWKB read alike."""
    be = b"\x00" + struct.pack(">I", 1) + struct.pack(">dd", 3.5, -1.25)
    ewkb = b"\x01" + struct.pack("<I", 0x20000001) + \
        struct.pack("<I", 27700) + struct.pack("<dd", 530042.0, 180358.0)
    for blobs in ([be], [ewkb], [be, ewkb]):
        _same_array(J.read_wkb(blobs), T.read_wkb(blobs))
    assert np.array_equal(T.read_wkb([be]).coords, [[3.5, -1.25]])


def test_geojson_texts_equal_and_round_trip():
    ja, ta = J.read_wkt(WKTS), T.read_wkt(WKTS)
    jt, tt = J.write_geojson(ja), T.write_geojson(ta)
    assert jt == tt
    _same_array(J.read_geojson(tt), T.read_geojson(jt))
    back = T.read_geojson(tt)
    assert np.allclose(back.coords, ta.coords)
    assert np.array_equal(back.types, ta.types)


def test_collection_member_types_round_trip():
    src = WKTS[8]
    g = T.read_wkt([src])
    assert "LINESTRING" in T.write_wkt(T.read_wkb(T.write_wkb(g)))[0]
    assert "LINESTRING" in T.write_wkt(T.read_geojson(T.write_geojson(g)))[0]
    assert T.write_wkt(g) == J.write_wkt(J.read_wkt([src]))
