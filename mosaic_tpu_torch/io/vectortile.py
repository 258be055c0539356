"""Vector-tile aggregators: Mapbox Vector Tile + GeoJSON tile emit.

Port of ``mosaic_tpu.io.vectortile``: the encoders, the decoder and
the fault sites ``mvt.decode`` and ``mvt.decode_feature`` are copies;
the polygon clip to the tile box is the port's ``convex_clip_rings``,
whose (ring, box) tasks run on the clip kernel on ``device`` (CUDA
unless the caller passes ``device="cpu"``).

Reference counterparts: expressions/geometry/ST_AsMVTTileAgg.scala
(aggregates a group's geometries into one MVT blob via OGR's MVT
driver) and ST_AsGeojsonTileAgg.scala.  No OGR here: the MVT 2.1 wire
format (protobuf: layers > features > zigzag-delta geometry command
stream) is emitted directly — it is a small, fully published encoding —
and a decoder rides along so tests can round-trip without external
tooling.

Tiling scheme: standard slippy z/x/y over EPSG:3857 (what every MVT
consumer expects); geometries arrive in lon/lat and are clipped to the
tile envelope before quantization to the integer extent grid.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike
from ..core.geometry.array import GeometryArray, GeometryType
from ..resilience import faults
from ..obs.context import traced
from ..resilience.ingest import ErrorSink, decode_guard

__all__ = ["tile_envelope_4326", "st_asmvttileagg",
           "st_asgeojsontileagg", "decode_mvt"]

_EXTENT = 4096
#: types whose rows are not clipped as rings
_POINT_LINE_TYPES = (GeometryType.POINT, GeometryType.MULTIPOINT,
                     GeometryType.LINESTRING, GeometryType.MULTILINESTRING)
_WEB_LIMIT = 20037508.342789244


def tile_envelope_4326(z: int, x: int, y: int
                       ) -> Tuple[float, float, float, float]:
    """(lon_min, lat_min, lon_max, lat_max) of slippy tile z/x/y."""
    n = 2 ** z

    def lon(i):
        return i / n * 360.0 - 180.0

    def lat(j):
        t = math.pi * (1 - 2 * j / n)
        return math.degrees(math.atan(math.sinh(t)))

    return lon(x), lat(y + 1), lon(x + 1), lat(y)


# ------------------------------------------------------------- protobuf

def _varint(v: int) -> bytes:
    out = bytearray()
    v &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _packed(num: int, values: Sequence[int]) -> bytes:
    body = b"".join(_varint(v) for v in values)
    return _len_field(num, body)


def _mvt_value(v) -> bytes:
    if isinstance(v, bool):
        return _field(7, 0) + _varint(1 if v else 0)
    if isinstance(v, (int, np.integer)):
        return _field(6, 0) + _varint(_zigzag(int(v)))
    if isinstance(v, (float, np.floating)):
        return _field(3, 1) + struct.pack("<d", float(v))
    s = str(v).encode("utf-8")
    return _len_field(1, s)


def _clip_rings_to_box_aligned(rings: List[np.ndarray], box,
                               device: DeviceLike = None):
    """Clip rings to the box KEEPING positional alignment (None where a
    ring clips away) so shell/hole roles survive.  The clip runs on
    ``device`` (CUDA unless ``device="cpu"``)."""
    from ..core.tessellate import convex_clip_rings
    x0, y0, x1, y1 = box
    cell = np.array([[[x0, y0], [x1, y0], [x1, y1], [x0, y1]]])
    counts = np.array([4])
    return convex_clip_rings(rings, cell, counts, device=device)[0]


def _geom_commands(rings: List[np.ndarray], box, gtype: GeometryType,
                   extent: int) -> Tuple[List[int], int]:
    """Quantize rings to tile coords and emit the MVT command stream.

    Points emit MoveTo-only (a 1-vertex "ring" is a valid type-1
    feature); lines and polygon rings emit MoveTo + LineTo (+ClosePath
    for polygons)."""
    x0, y0, x1, y1 = box
    sx = extent / (x1 - x0)
    sy = extent / (y1 - y0)
    cmds: List[int] = []
    cx = cy = 0
    is_poly = gtype in (GeometryType.POLYGON, GeometryType.MULTIPOLYGON)
    is_line = gtype in (GeometryType.LINESTRING,
                        GeometryType.MULTILINESTRING)
    mvt_type = 3 if is_poly else (2 if is_line else 1)
    for ring in rings:
        q = np.stack([(ring[:, 0] - x0) * sx,
                      (y1 - ring[:, 1]) * sy], -1)     # y flips down
        q = np.clip(np.round(q), -1, extent + 1).astype(np.int64)
        # drop consecutive duplicates after quantization
        keep = np.ones(len(q), bool)
        keep[1:] = np.any(q[1:] != q[:-1], axis=1)
        q = q[keep]
        if len(q) < (3 if is_poly else (2 if is_line else 1)):
            continue
        cmds.append((1 & 0x7) | (1 << 3))              # MoveTo x1
        cmds.append(_zigzag(int(q[0, 0] - cx)))
        cmds.append(_zigzag(int(q[0, 1] - cy)))
        cx, cy = int(q[0, 0]), int(q[0, 1])
        if len(q) > 1:
            n = len(q) - 1
            cmds.append((2 & 0x7) | (n << 3))          # LineTo xN
            for px, py in q[1:]:
                cmds.append(_zigzag(int(px - cx)))
                cmds.append(_zigzag(int(py - cy)))
                cx, cy = int(px), int(py)
        if is_poly:
            cmds.append((7 & 0x7) | (1 << 3))          # ClosePath
    return cmds, mvt_type


def _clip_lines_to_box(rings: List[np.ndarray], box) -> List[np.ndarray]:
    """Clip polylines to the tile box (Liang-Barsky per segment via the
    tessellation engine's convex-cell line clipper — a polyline is NOT a
    ring; the polygon clipper would add a phantom closing segment)."""
    from ..core.tessellate import _clip_line_to_cell
    x0, y0, x1, y1 = box
    cell = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    out = []
    for r in rings:
        if len(r) < 2:
            continue
        edges = np.stack([r[:-1], r[1:]], axis=1)
        out.extend(_clip_line_to_cell(edges, cell, 4))
    return out


def st_asmvttileagg(geoms: GeometryArray,
                    attributes: Optional[Dict[str, list]],
                    z: int, x: int, y: int,
                    layer: str = "layer",
                    extent: int = _EXTENT,
                    device: DeviceLike = None) -> bytes:
    """Aggregate a geometry batch into one MVT tile blob (reference:
    ST_AsMVTTileAgg).  Geometries are clipped to the z/x/y envelope (the
    polygon clip on ``device``: CUDA unless ``device="cpu"``); rows
    whose geometry misses the tile are dropped."""
    box = tile_envelope_4326(z, x, y)
    attributes = attributes or {}
    keys = list(attributes)
    values: List[bytes] = []
    value_ix: Dict[bytes, int] = {}
    feats: List[bytes] = []

    rows, pool = [], []
    for gi in range(len(geoms)):
        _, parts = geoms.geom_slices(gi)
        rows.append([np.asarray(r, np.float64)[:, :2]
                     for part in parts for r in part if len(r)])
        if geoms.geom_type(gi) not in _POINT_LINE_TYPES:
            pool.extend(rows[-1])
    # every polygon row's rings against the tile box in one clip call
    clipped_rings = iter(_clip_rings_to_box_aligned(pool, box, device)
                         if pool else [])

    for gi, rings in enumerate(rows):
        gtype = geoms.geom_type(gi)
        if gtype in (GeometryType.POINT, GeometryType.MULTIPOINT):
            rings = [r for r in rings
                     if box[0] <= r[0, 0] <= box[2]
                     and box[1] <= r[0, 1] <= box[3]]
        elif gtype in (GeometryType.LINESTRING,
                       GeometryType.MULTILINESTRING):
            rings = _clip_lines_to_box(rings, box)
        else:
            rings = [c for c in (next(clipped_rings) for _ in rings)
                     if c is not None]
        if not rings:
            continue
        cmds, mvt_type = _geom_commands(rings, box, gtype, extent)
        if not cmds:
            continue
        tags: List[int] = []
        for ki, key in enumerate(keys):
            v = attributes[key][gi]
            if v is None:
                continue
            enc = _mvt_value(v)
            if enc not in value_ix:
                value_ix[enc] = len(values)
                values.append(enc)
            tags += [ki, value_ix[enc]]
        body = _field(1, 0) + _varint(gi)
        if tags:
            body += _packed(2, tags)
        body += _field(3, 0) + _varint(mvt_type)
        body += _packed(4, cmds)
        feats.append(body)

    lay = _field(15, 0) + _varint(2)                  # version 2
    lay += _len_field(1, layer.encode("utf-8"))
    for f in feats:
        lay += _len_field(2, f)
    for k in keys:
        lay += _len_field(3, k.encode("utf-8"))
    for v in values:
        lay += _len_field(4, v)
    lay += _field(5, 0) + _varint(extent)
    return _len_field(3, lay)


def st_asgeojsontileagg(geoms: GeometryArray,
                        attributes: Optional[Dict[str, list]],
                        z: int, x: int, y: int,
                        device: DeviceLike = None) -> str:
    """Aggregate into a GeoJSON FeatureCollection clipped to the tile
    (reference: ST_AsGeojsonTileAgg; the polygon clip on ``device``:
    CUDA unless ``device="cpu"``)."""
    from ..core.geometry.geojson import write_geojson
    from ..core.geometry.array import GeometryBuilder
    box = tile_envelope_4326(z, x, y)
    attributes = attributes or {}
    feats = []
    # every polygon row's rings, part by part, against the tile box in
    # one clip call
    pool = [np.asarray(r, np.float64)[:, :2]
            for gi in range(len(geoms))
            if geoms.geom_type(gi) not in _POINT_LINE_TYPES
            for part in geoms.geom_slices(gi)[1] for r in part if len(r)]
    clipped_rings = iter(_clip_rings_to_box_aligned(pool, box, device)
                         if pool else [])
    for gi in range(len(geoms)):
        _, parts = geoms.geom_slices(gi)
        rings = [np.asarray(r, np.float64)[:, :2]
                 for part in parts for r in part if len(r)]
        gtype = geoms.geom_type(gi)
        if gtype in (GeometryType.POINT, GeometryType.MULTIPOINT):
            rings = [r for r in rings
                     if box[0] <= r[0, 0] <= box[2]
                     and box[1] <= r[0, 1] <= box[3]]
            if not rings:
                continue
            b = GeometryBuilder(srid=geoms.srid)
            b.add(gtype, [[r] for r in rings])
        elif gtype in (GeometryType.LINESTRING,
                       GeometryType.MULTILINESTRING):
            clipped = _clip_lines_to_box(rings, box)
            if not clipped:
                continue
            b = GeometryBuilder(srid=geoms.srid)
            b.add(GeometryType.MULTILINESTRING,
                  [[r] for r in clipped])
        else:
            # clip per ring but KEEP shell/hole roles per part, so a
            # donut stays a donut (every clipped ring as its own polygon
            # would turn holes into filled islands)
            parts_out = []
            for part in parts:
                cl = [next(clipped_rings) for r in part if len(r)]
                shells_holes = []
                for ri, r in enumerate(cl):
                    if r is None:
                        # a clipped-away SHELL drops its holes too
                        if ri == 0:
                            break
                        continue
                    closed_r = np.vstack([r, r[:1]])
                    shells_holes.append(closed_r)
                if shells_holes:
                    parts_out.append(shells_holes)
            if not parts_out:
                continue
            b = GeometryBuilder(srid=geoms.srid)
            b.add(GeometryType.MULTIPOLYGON, parts_out)
        gj = json.loads(write_geojson(b.finish())[0])
        props = {k: attributes[k][gi] for k in attributes
                 if attributes[k][gi] is not None}
        feats.append({"type": "Feature", "id": gi, "geometry": gj,
                      "properties": props})
    return json.dumps({"type": "FeatureCollection", "features": feats})


# ----------------------------------------------------- decoder (tests)

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


@traced("ingest:mvt", "ingest/mvt")
def decode_mvt(blob: bytes, on_error: Optional[str] = None,
               path: Optional[str] = None,
               errors: Optional[list] = None) -> dict:
    """Minimal MVT decoder: {layer: {extent, features: [{id, type,
    geometry(commands decoded to rings), tags}] , keys, values}}.

    ``on_error`` (default: ``MosaicConfig.io_on_error``) governs
    malformed features: ``"raise"`` fails fast with a located
    ``CodecError``; ``"skip"``/``"null"`` drop the damaged feature,
    keep the rest of the layer, and append ErrorRecords to ``errors``
    when a list is supplied.  Damage outside a feature body (layer
    framing) always raises."""
    faults.maybe_fail("mvt.decode")
    sink = ErrorSink(on_error, driver="mvt", path=path)

    def parse_msg(buf):
        i = 0
        fields = []
        while i < len(buf):
            tag, i = _read_varint(buf, i)
            num, wire = tag >> 3, tag & 0x7
            if wire == 0:
                v, i = _read_varint(buf, i)
            elif wire == 2:
                ln, i = _read_varint(buf, i)
                v = buf[i:i + ln]
                i += ln
            elif wire == 1:
                v = buf[i:i + 8]
                i += 8
            elif wire == 5:
                v = buf[i:i + 4]
                i += 4
            else:
                raise ValueError(f"wire {wire}")
            fields.append((num, v))
        return fields

    def unzig(v):
        return (v >> 1) ^ -(v & 1)

    out = {}
    with decode_guard(path=path, feature="tile"):
        top = parse_msg(blob)
    for num, payload in top:
        if num != 3:
            continue
        layer = {"features": [], "keys": [], "values": [],
                 "extent": _EXTENT, "name": None, "version": None}
        with decode_guard(path=path, feature="layer"):
            layer_fields = parse_msg(payload)
        for fn, fv in layer_fields:
            if fn == 1:
                layer["name"] = fv.decode()
            elif fn == 15:
                layer["version"] = fv
            elif fn == 5:
                layer["extent"] = fv
            elif fn == 3:
                layer["keys"].append(fv.decode())
            elif fn == 4:
                vf = parse_msg(fv)[0]
                if vf[0] == 1:
                    layer["values"].append(vf[1].decode())
                elif vf[0] == 3:
                    layer["values"].append(
                        struct.unpack("<d", vf[1])[0])
                elif vf[0] == 6:
                    layer["values"].append(unzig(vf[1]))
                elif vf[0] == 7:
                    layer["values"].append(bool(vf[1]))
                else:
                    layer["values"].append(vf[1])
            elif fn == 2:
                fv = faults.corrupt("mvt.decode_feature", fv)
                feat = {"id": None, "type": None, "tags": [],
                        "rings": []}
                fi = len(layer["features"])
                try:
                    with decode_guard(path=path,
                                      feature=f"feature {fi}"):
                        faults.maybe_fail("mvt.decode_feature")
                        for gn, gv in parse_msg(fv):
                            if gn == 1:
                                feat["id"] = gv
                            elif gn == 3:
                                feat["type"] = gv
                            elif gn == 2:
                                i = 0
                                while i < len(gv):
                                    v, i = _read_varint(gv, i)
                                    feat["tags"].append(v)
                            elif gn == 4:
                                cmds = []
                                i = 0
                                while i < len(gv):
                                    v, i = _read_varint(gv, i)
                                    cmds.append(v)
                                # decode command stream to rings
                                rings = []
                                cur = []
                                cx = cy = 0
                                j = 0
                                while j < len(cmds):
                                    cid = cmds[j] & 0x7
                                    cnt = cmds[j] >> 3
                                    j += 1
                                    if cid == 1:
                                        if cur:
                                            rings.append(np.array(cur))
                                            cur = []
                                        for _ in range(cnt):
                                            cx += unzig(cmds[j])
                                            cy += unzig(cmds[j + 1])
                                            j += 2
                                            cur.append((cx, cy))
                                    elif cid == 2:
                                        for _ in range(cnt):
                                            cx += unzig(cmds[j])
                                            cy += unzig(cmds[j + 1])
                                            j += 2
                                            cur.append((cx, cy))
                                    elif cid == 7:
                                        rings.append(np.array(cur))
                                        cur = []
                                if cur:
                                    rings.append(np.array(cur))
                                feat["rings"] = rings
                except ValueError as e:
                    sink.handle(e)
                    continue
                layer["features"].append(feat)
        out[layer["name"]] = layer
    sink.export(errors)
    return out
