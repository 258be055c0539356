"""Shapefile datasource: pure-Python .shp/.dbf/.prj reader and writer.

Port copy of ``mosaic_tpu.io.shapefile`` (pure Python and numpy),
with the port's fault sites ``shapefile.read`` and
``shapefile.read_record`` and its ``ingest:shapefile`` trace.

Reference counterparts: datasource/ShapefileFileFormat.scala:47 (OGR
with a preset ESRI-Shapefile driver) and OGRFileFormat.scala:27 (schema
inference, per-feature geometry as WKB + attribute columns).  The
reference reaches libgdal's OGR through JNI; here the format is decoded
directly from its published layout (ESRI Shapefile Technical
Description, 1998): .shp geometry records, .dbf attribute table
(dBase III), .prj WKT for the CRS.

Ring semantics: shapefiles wind OUTER rings clockwise and holes
counter-clockwise (the opposite of OGC); multiple outer rings in one
record form a multipolygon, and each hole is assigned to the smallest
outer ring containing it — the same disambiguation OGR applies.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.geometry.array import (GeometryArray, GeometryBuilder,
                                   GeometryType)
from ..resilience import faults
from ..obs.context import traced
from ..resilience.ingest import ErrorSink, decode_guard

__all__ = ["read_shapefile", "write_shapefile", "read_vector"]

_SHP_NULL = 0
_SHP_POINT = {1, 11, 21}
_SHP_LINE = {3, 13, 23}
_SHP_POLY = {5, 15, 25}
_SHP_MPOINT = {8, 18, 28}


def _ring_area(r: np.ndarray) -> float:
    x, y = r[:, 0], r[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _point_in_ring(p: np.ndarray, ring: np.ndarray) -> bool:
    px, py = p
    a = ring
    b = np.roll(ring, -1, axis=0)
    straddle = (a[:, 1] <= py) != (b[:, 1] <= py)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (py - a[:, 1]) / np.where(b[:, 1] == a[:, 1], 1.0,
                                      b[:, 1] - a[:, 1])
    xi = a[:, 0] + t * (b[:, 0] - a[:, 0])
    return bool(np.sum(straddle & (px < xi)) & 1)


def _prj_to_epsg(wkt: str) -> int:
    """Best-effort WKT -> EPSG.

    Resolution order mirrors what OGR does with a .prj (reference:
    datasource/OGRFileFormat.scala reads the layer SRS via OGR):
    1. an explicit ``AUTHORITY["EPSG", "<code>"]`` (the LAST one in the
       WKT is the PROJCS-level authority);
    2. the PROJCS name matched against the 4,940-code parameter table
       (covers ESRI-style .prj files, which carry no AUTHORITY);
    3. legacy heuristics for BNG / web-mercator / UTM names;
    4. 4326."""
    import re
    from ..core.geometry.crs import _proj_entry
    w = wkt.upper()

    def routes(code: int) -> bool:
        return (code in (4326, 3857, 27700) or
                (code // 100 in (326, 327) and 1 <= code % 100 <= 60)
                or _proj_entry(code) is not None)

    # AUTHORITY nodes, last (outermost CRS-level) first — but only
    # accept a code the transform engine can actually route: nested
    # UNIT/DATUM authorities (e.g. 9001 = metre) and geographic-CRS
    # codes the engine doesn't know must not become the srid
    auth = re.findall(r'AUTHORITY\s*\[\s*"EPSG"\s*,\s*"?(\d+)"?', w)
    for code in map(int, reversed(auth)):
        if routes(code):
            return code
    if auth and not w.lstrip().startswith("PROJCS"):
        # a geographic CRS we can't shift exactly (e.g. 4269 NAD83):
        # degrees on a WGS84-adjacent datum — treat as 4326 like the
        # pre-round-5 reader did (metres-level approximation)
        return 4326
    m = re.match(r'\s*PROJCS\s*\[\s*"([^"]+)"', wkt,
                 re.IGNORECASE)
    if m:
        from ..core.geometry.crs import epsg_from_name
        code = epsg_from_name(m.group(1))
        if code is not None:
            return code
    if "BRITISH_NATIONAL_GRID" in w or "27700" in w:
        return 27700
    if "PSEUDO-MERCATOR" in w or "3857" in w:
        return 3857
    if "UTM_ZONE_" in w or "UTM ZONE " in w:
        m = re.search(r"UTM[_ ]ZONE[_ ](\d+)(N|S)?", w)
        if m:
            zone = int(m.group(1))
            south = (m.group(2) == "S") or "SOUTH" in w
            return (32700 if south else 32600) + zone
    return 4326


@traced("ingest:shapefile", "ingest/shapefile")
def read_shapefile(path: str, on_error: Optional[str] = None,
                   errors: Optional[list] = None
                   ) -> Tuple[GeometryArray, Dict[str, list]]:
    """path (.shp, or basename) -> (geometries, attribute columns).

    Null-shape records become empty geometries so row alignment with
    the .dbf attributes is preserved.

    ``on_error`` (default: ``MosaicConfig.io_on_error``) governs
    malformed records: ``"raise"`` fails fast with a located
    ``CodecError``; ``"null"`` turns a damaged record into an empty
    GEOMETRYCOLLECTION (keeping its attribute row); ``"skip"`` drops
    the record AND its attribute row.  Unparseable .dbf numeric fields
    degrade to None under skip/null.  ErrorRecords are appended to
    ``errors`` when a list is supplied."""
    faults.maybe_fail("shapefile.read")
    base = path[:-4] if path.lower().endswith(".shp") else path
    sink = ErrorSink(on_error, driver="shapefile", path=base + ".shp")
    with open(base + ".shp", "rb") as f:
        buf = f.read()
    if len(buf) < 100 or struct.unpack(">i", buf[:4])[0] != 9994:
        raise ValueError(f"{base}.shp: not a shapefile (bad magic)")
    srid = 4326
    if os.path.exists(base + ".prj"):
        with open(base + ".prj") as f:
            srid = _prj_to_epsg(f.read())

    b = GeometryBuilder(srid=srid)
    off = 100
    n = 0
    dropped: set = set()                # record indices skip removed
    while off + 8 <= len(buf):
        rec_off = off
        _, clen = struct.unpack(">ii", buf[off:off + 8])
        rec = buf[off + 8: off + 8 + 2 * clen]
        off += 8 + 2 * clen
        if len(rec) < 4:
            break
        rec = faults.corrupt("shapefile.read_record", rec)
        n += 1
        try:
            with decode_guard(path=base + ".shp",
                              feature=f"record {n - 1}",
                              offset=rec_off):
                st = struct.unpack("<i", rec[:4])[0]
                if st == _SHP_NULL:
                    b.add(GeometryType.GEOMETRYCOLLECTION, [])
                elif st in _SHP_POINT:
                    x, y = struct.unpack("<2d", rec[4:20])
                    b.add_point(np.array([x, y]))
                elif st in _SHP_MPOINT:
                    npts = struct.unpack("<i", rec[36:40])[0]
                    pts = np.frombuffer(rec, "<f8", npts * 2,
                                        40).reshape(-1, 2)
                    b.add(GeometryType.MULTIPOINT,
                          [[p[None]] for p in pts])
                elif st in _SHP_LINE or st in _SHP_POLY:
                    nparts, npts = struct.unpack("<2i", rec[36:44])
                    parts = np.frombuffer(rec, "<i4", nparts, 44)
                    pts = np.frombuffer(rec, "<f8", npts * 2,
                                        44 + 4 * nparts).reshape(-1, 2)
                    ends = np.append(parts[1:], npts)
                    rings = [pts[s:e].copy()
                             for s, e in zip(parts, ends)]
                    if st in _SHP_LINE:
                        if len(rings) == 1:
                            b.add_linestring(rings[0])
                        else:
                            b.add(GeometryType.MULTILINESTRING,
                                  [[r] for r in rings])
                    else:
                        _add_shp_polygon(b, rings)
                else:
                    raise ValueError(f"unsupported shape type {st}")
        except ValueError as e:
            sink.handle(e)
            if sink.on_error == "null":
                # keep the attribute row aligned with a placeholder
                b.add(GeometryType.GEOMETRYCOLLECTION, [])
            else:
                dropped.add(n - 1)
    geoms = b.finish()

    cols: Dict[str, list] = {}
    if os.path.exists(base + ".dbf"):
        cols = _read_dbf(base + ".dbf", sink=sink)
        counts = {k: len(v) for k, v in cols.items()}
        if counts and any(c != n for c in counts.values()):
            raise ValueError(
                f"{base}.dbf row count {counts} != {n} shapes")
        if dropped:
            cols = {k: [v for i, v in enumerate(vals)
                        if i not in dropped]
                    for k, vals in cols.items()}
    sink.export(errors)
    return geoms, cols


def _add_shp_polygon(b: GeometryBuilder, rings: List[np.ndarray]):
    """Group shapefile rings (outer CW / holes CCW) into polygon parts."""
    outers = []
    holes = []
    for r in rings:
        if len(r) < 4:
            continue
        (outers if _ring_area(r[:-1]) < 0 else holes).append(r)
    if not outers:                      # degenerate: treat all as outer
        outers, holes = holes, []
    # normalize to OGC winding (shells CCW, holes CW) so downstream
    # signed-area/edge kernels see the same convention as WKT input
    outers = [o if _ring_area(o[:-1]) > 0 else o[::-1] for o in outers]
    holes = [h if _ring_area(h[:-1]) < 0 else h[::-1] for h in holes]
    assigned: List[List[np.ndarray]] = [[] for _ in outers]
    for h in holes:
        inside = [i for i, o in enumerate(outers)
                  if _point_in_ring(h[0], o[:-1])]
        if inside:
            # smallest containing outer ring
            i = min(inside, key=lambda i: abs(_ring_area(outers[i][:-1])))
            assigned[i].append(h)
    if len(outers) == 1:
        b.add_polygon(outers[0], assigned[0])
    else:
        b.add(GeometryType.MULTIPOLYGON,
              [[o, *hs] for o, hs in zip(outers, assigned)])


def _read_dbf(path: str,
              sink: Optional[ErrorSink] = None) -> Dict[str, list]:
    with open(path, "rb") as f:
        buf = f.read()
    nrec, hsize, rsize = struct.unpack("<IHH", buf[4:12])
    fields = []
    off = 32
    while off < hsize - 1 and buf[off] != 0x0D:
        name = buf[off:off + 11].split(b"\0")[0].decode("ascii")
        ftype = chr(buf[off + 11])
        flen = buf[off + 16]
        fdec = buf[off + 17]
        fields.append((name, ftype, flen, fdec))
        off += 32
    cols: Dict[str, list] = {f[0]: [] for f in fields}
    deleted = []
    off = hsize
    for ri in range(nrec):
        if off + rsize > len(buf):
            break
        rec = buf[off:off + rsize]
        rec_off = off
        off += rsize
        # soft-deleted rows are kept (row i must stay aligned with .shp
        # record i) but surfaced so callers can filter
        deleted.append(rec[:1] == b"*")
        p = 1
        for name, ftype, flen, fdec in fields:
            raw = rec[p:p + flen]
            p += flen
            s = raw.decode("latin-1").strip()
            try:
                with decode_guard(path=path,
                                  feature=f"record {ri} field {name}",
                                  offset=rec_off):
                    if ftype in ("N", "F"):
                        if not s:
                            cols[name].append(None)
                        elif fdec or ftype == "F" or "." in s:
                            cols[name].append(float(s))
                        else:
                            cols[name].append(int(s))
                    elif ftype == "L":
                        cols[name].append(s.upper() in ("T", "Y"))
                    else:
                        cols[name].append(s)
            except ValueError as e:
                if sink is None:
                    raise
                # an unparseable field degrades to a null cell; the
                # row (and its geometry) survives
                sink.handle(e)
                cols[name].append(None)
    if any(deleted):
        cols["_deleted"] = deleted
    return cols


# ---------------------------------------------------------------- writer

def write_shapefile(path: str, geoms: GeometryArray,
                    columns: Optional[Dict[str, list]] = None) -> None:
    """Write polygons/lines/points to .shp/.shx/.dbf (+.prj).

    Mixed-type batches are not valid shapefiles; the shape type comes
    from the first geometry."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    recs = []
    shape_type = None
    for gi in range(len(geoms)):
        t = geoms.geom_type(gi)
        _, parts = geoms.geom_slices(gi)
        if t in (GeometryType.POINT,):
            shape_type = shape_type or 1
            p = parts[0][0][0]
            recs.append(struct.pack("<i2d", 1, p[0], p[1]))
        elif t in (GeometryType.LINESTRING, GeometryType.MULTILINESTRING,
                   GeometryType.POLYGON, GeometryType.MULTIPOLYGON):
            is_poly = t in (GeometryType.POLYGON,
                            GeometryType.MULTIPOLYGON)
            st = 5 if is_poly else 3
            shape_type = shape_type or st
            rings = []
            for pi, part in enumerate(parts):
                for ri, ring in enumerate(part):
                    r = np.asarray(ring, np.float64)[:, :2]
                    if is_poly:
                        if not np.array_equal(r[0], r[-1]):
                            r = np.vstack([r, r[:1]])
                        # shapefile winding: outer CW, holes CCW
                        outer = ri == 0
                        cw = _ring_area(r[:-1]) < 0
                        if outer != cw:
                            r = r[::-1]
                    rings.append(r)
            pts = np.vstack(rings) if rings else np.zeros((0, 2))
            starts = np.cumsum([0] + [len(r) for r in rings[:-1]]) \
                if rings else np.zeros(0, int)
            bb = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(),
                  pts[:, 1].max()) if len(pts) else (0, 0, 0, 0)
            body = struct.pack("<i4d2i", st, *bb, len(rings), len(pts))
            body += struct.pack(f"<{len(rings)}i", *starts)
            body += pts.astype("<f8").tobytes()
            recs.append(body)
        else:
            raise ValueError(f"cannot write geometry type {t}")

    shp = bytearray()
    shx = bytearray()
    off_words = 50
    for i, body in enumerate(recs):
        clen = len(body) // 2
        shx += struct.pack(">2i", off_words, clen)
        shp += struct.pack(">2i", i + 1, clen) + body
        off_words += 4 + clen
    xs, ys = [], []
    bb_all = geoms.bboxes()
    for gi in range(len(geoms)):
        bbx = bb_all[gi]
        if not np.any(np.isnan(bbx)):
            xs += [bbx[0], bbx[2]]
            ys += [bbx[1], bbx[3]]
    bb = (min(xs), min(ys), max(xs), max(ys)) if xs else (0, 0, 0, 0)

    def header(length_words):
        return struct.pack(">7i", 9994, 0, 0, 0, 0, 0, length_words) + \
            struct.pack("<2i4d4d", 1000, shape_type or 1,
                        bb[0], bb[1], bb[2], bb[3], 0, 0, 0, 0)

    with open(base + ".shp", "wb") as f:
        f.write(header(50 + len(shp) // 2) + bytes(shp))
    with open(base + ".shx", "wb") as f:
        f.write(header(50 + len(shx) // 2) + bytes(shx))
    _write_dbf(base + ".dbf", len(geoms), columns or {})
    if geoms.srid == 27700:
        wkt = ('PROJCS["British_National_Grid",'
               'AUTHORITY["EPSG","27700"]]')
    elif geoms.srid == 3857:
        wkt = ('PROJCS["WGS_84_Pseudo-Mercator",'
               'AUTHORITY["EPSG","3857"]]')
    elif geoms.srid not in (4326, 0):
        # minimal WKT: the AUTHORITY node is the interchange contract
        # (our reader and OGR both resolve it); the name is advisory
        wkt = (f'PROJCS["EPSG_{geoms.srid}",'
               f'AUTHORITY["EPSG","{geoms.srid}"]]')
    else:
        wkt = 'GEOGCS["GCS_WGS_1984"]'
    with open(base + ".prj", "w") as f:
        f.write(wkt)


def _write_dbf(path: str, nrows: int, columns: Dict[str, list]) -> None:
    fields = []
    for name, vals in columns.items():
        assert len(vals) == nrows, (name, len(vals), nrows)
        if all(isinstance(v, (int, np.integer)) or v is None
               for v in vals):
            fields.append((name[:10], "N", 18, 0))
        elif all(isinstance(v, (int, float, np.floating, np.integer))
                 or v is None for v in vals):
            fields.append((name[:10], "N", 24, 8))
        else:
            w = max([len(str(v)) for v in vals] + [1])
            fields.append((name[:10], "C", min(w, 254), 0))
    rsize = 1 + sum(f[2] for f in fields)
    hsize = 32 + 32 * len(fields) + 1
    out = bytearray(struct.pack("<B3xIHH20x", 0x03, nrows, hsize, rsize))
    for name, ftype, flen, fdec in fields:
        out += struct.pack("<11sc4xBB14x", name.encode("ascii"),
                           ftype.encode("ascii"), flen, fdec)
    out += b"\x0d"
    names = list(columns)
    for i in range(nrows):
        out += b" "
        for (name, ftype, flen, fdec), cname in zip(fields, names):
            v = columns[cname][i]
            if ftype == "N":
                s = "" if v is None else (
                    f"{v:.{fdec}f}" if fdec else str(int(v)))
                out += s.rjust(flen)[:flen].encode("ascii")
            else:
                out += str("" if v is None else v).ljust(
                    flen)[:flen].encode("latin-1")
    out += b"\x1a"
    with open(path, "wb") as f:
        f.write(bytes(out))


# ------------------------------------------------------- driver dispatch

def read_vector(path: str, driver: Optional[str] = None,
                on_error: Optional[str] = None,
                errors: Optional[list] = None
                ) -> Tuple[GeometryArray, Dict[str, list]]:
    """OGR-style entry point: driver by name or file extension
    (reference: OGRFileFormat.scala driver dispatch + the preset
    wrappers ShapefileFileFormat/GeoDBFileFormat).  ``on_error`` /
    ``errors`` thread the degrade-not-die policy through the drivers
    that support it (shapefile, gpkg)."""
    drv = (driver or "").lower()
    if not drv:
        ext = os.path.splitext(path)[1].lower()
        drv = {".shp": "esri shapefile", ".json": "geojson",
               ".geojson": "geojson", ".wkt": "wkt",
               ".gpkg": "gpkg"}.get(ext, "")
    if drv in ("esri shapefile", "shapefile", "shp"):
        return read_shapefile(path, on_error=on_error, errors=errors)
    if drv in ("gpkg", "geopackage"):
        from .geopackage import read_gpkg
        return read_gpkg(path, on_error=on_error, errors=errors)
    if drv == "geojson":
        import json
        from ..core.geometry.geojson import read_geojson
        obj = json.load(open(path))
        if obj.get("type") == "FeatureCollection":
            feats = obj["features"]
            geoms = read_geojson([json.dumps(f["geometry"])
                                  for f in feats])
            keys = sorted({k for f in feats
                           for k in (f.get("properties") or {})})
            cols = {k: [(f.get("properties") or {}).get(k)
                        for f in feats] for k in keys}
            return geoms, cols
        return read_geojson([json.dumps(obj)]), {}
    if drv == "wkt":
        from ..core.geometry.wkt import read_wkt
        lines = [ln.strip() for ln in open(path) if ln.strip()]
        return read_wkt(lines), {}
    raise ValueError(f"no driver for {path!r} (driver={driver!r})")
