"""GeoJSON reader / writer (RFC 7946 geometry objects).

Port copy of ``mosaic_tpu.core.geometry.geojson`` (pure numpy).

Reference counterpart: JTS GeoJsonReader/Writer via
core/geometry/api/GeometryAPI.scala (the JSONType encoding).
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np

from .array import GeometryArray, GeometryBuilder, GeometryType


def _add_geojson(obj: dict, builder: GeometryBuilder) -> None:
    t = obj["type"]
    c = obj.get("coordinates")
    if t == "Point":
        builder.add(GeometryType.POINT, [[np.asarray([c], dtype=np.float64)]])
    elif t == "LineString":
        builder.add(GeometryType.LINESTRING,
                    [[np.asarray(c, dtype=np.float64)]])
    elif t == "Polygon":
        builder.add(GeometryType.POLYGON,
                    [[np.asarray(r, dtype=np.float64) for r in c]])
    elif t == "MultiPoint":
        builder.add(GeometryType.MULTIPOINT,
                    [[np.asarray([p], dtype=np.float64)] for p in c])
    elif t == "MultiLineString":
        builder.add(GeometryType.MULTILINESTRING,
                    [[np.asarray(l, dtype=np.float64)] for l in c])
    elif t == "MultiPolygon":
        builder.add(GeometryType.MULTIPOLYGON,
                    [[np.asarray(r, dtype=np.float64) for r in poly]
                     for poly in c])
    elif t == "GeometryCollection":
        sub = GeometryBuilder()
        for g in obj["geometries"]:
            _add_geojson(g, sub)
        arr = sub.finish()
        eff = arr.part_types_effective()
        parts, ptypes = [], []
        for i in range(len(arr)):
            _, sp = arr.geom_slices(i)
            parts.extend(sp)
            ptypes.extend(eff[arr.geom_offsets[i]:
                              arr.geom_offsets[i + 1]].tolist())
        builder.add(GeometryType.GEOMETRYCOLLECTION, parts,
                    part_types=ptypes)
    elif t == "Feature":
        _add_geojson(obj["geometry"], builder)
    elif t == "FeatureCollection":
        for f in obj["features"]:
            _add_geojson(f["geometry"], builder)
    else:
        raise ValueError(f"unsupported GeoJSON type {t}")


def read_geojson(texts: Sequence[str], srid: int = 4326) -> GeometryArray:
    builder = GeometryBuilder(srid=srid)
    for t in texts:
        _add_geojson(json.loads(t) if isinstance(t, str) else t, builder)
    return builder.finish()


def _geom_to_obj(gtype: GeometryType, parts, part_types=None) -> dict:
    def rings(p):
        return [np.asarray(r).tolist() for r in p]

    if gtype == GeometryType.POINT:
        pts = parts[0][0]
        return {"type": "Point",
                "coordinates": np.asarray(pts[0]).tolist() if len(pts) else []}
    if gtype == GeometryType.LINESTRING:
        return {"type": "LineString",
                "coordinates": np.asarray(parts[0][0]).tolist()}
    if gtype == GeometryType.POLYGON:
        return {"type": "Polygon", "coordinates": rings(parts[0])}
    if gtype == GeometryType.MULTIPOINT:
        return {"type": "MultiPoint",
                "coordinates": [np.asarray(p[0][0]).tolist() for p in parts]}
    if gtype == GeometryType.MULTILINESTRING:
        return {"type": "MultiLineString",
                "coordinates": [np.asarray(p[0]).tolist() for p in parts]}
    if gtype == GeometryType.MULTIPOLYGON:
        return {"type": "MultiPolygon", "coordinates": [rings(p) for p in parts]}
    if gtype == GeometryType.GEOMETRYCOLLECTION:
        from .wkb import _member_type
        return {"type": "GeometryCollection",
                "geometries": [_geom_to_obj(_member_type(p, part_types, j),
                                            [p])
                               for j, p in enumerate(parts)]}
    raise ValueError(gtype)


def write_geojson(arr: GeometryArray) -> List[str]:
    out = []
    for i in range(len(arr)):
        t, parts = arr.geom_slices(i)
        pt = (arr.part_types[arr.geom_offsets[i]:arr.geom_offsets[i + 1]]
              if arr.part_types is not None else None)
        out.append(json.dumps(_geom_to_obj(t, parts, pt)))
    return out
