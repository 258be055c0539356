"""GeoPackage (OGC GPKG) vector reader + writer.

Port copy of ``mosaic_tpu.io.geopackage`` (pure Python), with the
port's fault sites ``gpkg.read`` and ``gpkg.read_row``.

Reference counterpart: the GDAL/OGR "GPKG" driver reachable through the
reference's OGRFileFormat driver dispatch
(datasource/OGRFileFormat.scala:27).  A GeoPackage is a SQLite database
with the OGC-specified catalog tables; CPython's bundled sqlite3 module
supplies the container, and this module implements the GPKG-specific
layers on top:

* catalog discovery via gpkg_contents / gpkg_geometry_columns,
* the GeoPackageBinary geometry blob (magic "GP", version, flags with
  envelope class + endianness, srs_id, optional envelope, then
  standard WKB),
* attribute columns passed through as python lists.

The ESRI FileGDB sibling (GeoDBFileFormat.scala) stays out of scope:
that format is proprietary and the reference itself only binds GDAL's
OpenFileGDB driver rather than carrying a decoder (see PARITY.md).
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Dict, List, Optional, Tuple

from ..core.geometry.array import GeometryArray
from ..core.geometry.wkb import read_wkb, write_wkb
from ..resilience import faults
from ..obs.context import traced
from ..resilience.ingest import CodecError, ErrorSink, decode_guard

__all__ = ["read_gpkg", "write_gpkg", "gpkg_layers"]


def _strip_gpb(blob: bytes) -> Optional[bytes]:
    """GeoPackageBinary -> the embedded standard WKB (None for NULL /
    empty-geometry blobs)."""
    if blob is None:
        return None
    if blob[:2] != b"GP":
        raise ValueError("not a GeoPackageBinary blob (missing GP magic)")
    flags = blob[3]
    env_code = (flags >> 1) & 0x7
    if env_code > 4:
        raise ValueError(f"invalid GPKG envelope contents code "
                         f"{env_code}")
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}[env_code]
    if flags & 0x20:                  # empty-geometry flag
        return None
    return blob[8 + env_len:]


def gpkg_layers(path: str) -> List[str]:
    """Feature-table names registered in gpkg_contents."""
    con = sqlite3.connect(path)
    try:
        rows = con.execute(
            "SELECT table_name FROM gpkg_contents "
            "WHERE data_type = 'features' ORDER BY table_name"
        ).fetchall()
        return [r[0] for r in rows]
    finally:
        con.close()


@traced("ingest:gpkg", "ingest/gpkg")
def read_gpkg(path: str, layer: Optional[str] = None,
              on_error: Optional[str] = None,
              errors: Optional[list] = None
              ) -> Tuple[GeometryArray, Dict[str, list]]:
    """One layer (default: the first) -> (geometries, attribute columns).

    NULL/empty geometry rows are dropped (the reference's OGR path
    yields null rows Spark then filters; the columnar batch has no null
    geometry slot).

    ``on_error`` (default: ``MosaicConfig.io_on_error``) governs rows
    with a malformed geometry blob: ``"raise"`` fails fast with a
    located ``CodecError``; ``"skip"``/``"null"`` drop the row (same
    fate as a NULL geometry — there is no null geometry slot) and
    append ErrorRecords to ``errors`` when a list is supplied."""
    faults.maybe_fail("gpkg.read")
    sink = ErrorSink(on_error, driver="gpkg", path=path)
    con = sqlite3.connect(path)
    try:
        layers = con.execute(
            "SELECT c.table_name, g.column_name, c.srs_id "
            "FROM gpkg_contents c JOIN gpkg_geometry_columns g "
            "ON c.table_name = g.table_name "
            "WHERE c.data_type = 'features' ORDER BY c.table_name"
        ).fetchall()
        if not layers:
            raise ValueError(f"{path}: no feature layers in "
                             "gpkg_contents")
        if layer is not None:
            match = [l for l in layers if l[0] == layer]
            if not match:
                raise ValueError(
                    f"no layer {layer!r} (have: "
                    f"{[l[0] for l in layers]})")
            table, gcol, srs = match[0]
        else:
            table, gcol, srs = layers[0]
        cols = [r[1] for r in
                con.execute(f'PRAGMA table_info("{table}")')]
        attrs = [c for c in cols if c != gcol]
        sel = ", ".join([f'"{gcol}"'] + [f'"{c}"' for c in attrs])
        rows = con.execute(f'SELECT {sel} FROM "{table}"').fetchall()
        srid = int(srs) if srs and int(srs) > 0 else 4326
        wkbs, keep = [], []
        for i, r in enumerate(rows):
            try:
                with decode_guard(path=path, feature=f"row {i}"):
                    faults.maybe_fail("gpkg.read_row")
                    blob = r[0]
                    if blob is not None:
                        blob = faults.corrupt("gpkg.read_row", blob)
                    w = _strip_gpb(blob)
            except ValueError as e:
                sink.handle(e)
                continue
            if w is not None:
                wkbs.append(w)
                keep.append(i)
        try:
            with decode_guard(path=path, feature=table):
                geoms = read_wkb(wkbs, srid=srid)
        except ValueError as e:
            if sink.raising:
                raise
            # one bad WKB poisoned the batch: salvage row by row
            good_wkbs, good_keep = [], []
            for w, i in zip(wkbs, keep):
                try:
                    with decode_guard(path=path, feature=f"row {i}"):
                        read_wkb([w], srid=srid)
                except ValueError as row_e:
                    sink.handle(row_e)
                    continue
                good_wkbs.append(w)
                good_keep.append(i)
            geoms = read_wkb(good_wkbs, srid=srid)
            keep = good_keep
        out = {c: [rows[i][j + 1] for i in keep]
               for j, c in enumerate(attrs)}
        sink.export(errors)
        return geoms, out
    finally:
        con.close()


def write_gpkg(path: str, geoms: GeometryArray,
               attrs: Optional[Dict[str, list]] = None,
               layer: str = "layer", srs_id: int = 4326) -> None:
    """Write one feature layer as a spec-conforming GeoPackage."""
    attrs = attrs or {}
    if os.path.exists(path):
        os.unlink(path)
    con = sqlite3.connect(path)
    try:
        con.execute("PRAGMA application_id = 1196444487")  # 'GPKG'
        con.execute("PRAGMA user_version = 10300")
        con.execute(
            "CREATE TABLE gpkg_spatial_ref_sys (srs_name TEXT NOT NULL,"
            " srs_id INTEGER PRIMARY KEY, organization TEXT NOT NULL,"
            " organization_coordsys_id INTEGER NOT NULL,"
            " definition TEXT NOT NULL, description TEXT)")
        con.executemany(
            "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            [("Undefined cartesian", -1, "NONE", -1, "undefined", None),
             ("Undefined geographic", 0, "NONE", 0, "undefined", None),
             (f"EPSG:{srs_id}", srs_id, "EPSG", srs_id, "undefined",
              None)])
        con.execute(
            "CREATE TABLE gpkg_contents (table_name TEXT NOT NULL "
            "PRIMARY KEY, data_type TEXT NOT NULL, identifier TEXT "
            "UNIQUE, description TEXT DEFAULT '', last_change DATETIME,"
            " min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE,"
            " srs_id INTEGER)")
        con.execute(
            "CREATE TABLE gpkg_geometry_columns (table_name TEXT NOT "
            "NULL, column_name TEXT NOT NULL, geometry_type_name TEXT "
            "NOT NULL, srs_id INTEGER NOT NULL, z TINYINT NOT NULL,"
            " m TINYINT NOT NULL, CONSTRAINT pk_geom_cols PRIMARY KEY "
            "(table_name, column_name))")
        acols = "".join(f', "{c}"' for c in attrs)
        adefs = "".join(f', "{c}"' for c in attrs)
        con.execute(
            f'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY '
            f'AUTOINCREMENT, geom BLOB{adefs})')
        bb = geoms.bboxes()
        import numpy as np
        fin = np.isfinite(bb).all(axis=1)
        con.execute(
            "INSERT INTO gpkg_contents (table_name, data_type, "
            "identifier, min_x, min_y, max_x, max_y, srs_id) VALUES "
            "(?,?,?,?,?,?,?,?)",
            (layer, "features", layer,
             float(bb[fin, 0].min()) if fin.any() else 0.0,
             float(bb[fin, 1].min()) if fin.any() else 0.0,
             float(bb[fin, 2].max()) if fin.any() else 0.0,
             float(bb[fin, 3].max()) if fin.any() else 0.0, srs_id))
        con.execute(
            "INSERT INTO gpkg_geometry_columns VALUES (?,?,?,?,0,0)",
            (layer, "geom", "GEOMETRY", srs_id))
        wkbs = write_wkb(geoms)
        rows = []
        for i, w in enumerate(wkbs):
            header = b"GP" + bytes([0, 0x01]) + \
                struct.pack("<i", srs_id)      # v0, no envelope, LE
            rows.append((header + w,
                         *[attrs[c][i] for c in attrs]))
        ph = ", ".join("?" * (1 + len(attrs)))
        con.executemany(
            f'INSERT INTO "{layer}" (geom{acols}) VALUES ({ph})', rows)
        con.commit()
    finally:
        con.close()
