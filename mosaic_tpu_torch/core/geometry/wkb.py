"""WKB (Well-Known Binary) reader / writer.

Reference counterpart: core/geometry/api/GeometryAPI.scala:37-105 (JTS
WKBReader/WKBWriter) and codegen/format/ConvertToCodeGen.scala:42-60.  Here
the codec targets the columnar GeometryArray instead of per-row objects;
a vectorized fast path handles homogeneous POINT batches (the dominant
ingest shape for the PIP-join workloads).

Port copy of ``mosaic_tpu.core.geometry.wkb`` (pure numpy).

Supports 2D and Z (2.5D) coordinates, both byte orders on read, ISO and
EWKB Z flags, and SRID-carrying EWKB on read.  Writes little-endian ISO WKB.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .array import GeometryArray, GeometryBuilder, GeometryType

_EWKB_Z = 0x80000000
_EWKB_M = 0x40000000
_EWKB_SRID = 0x20000000
_ISO_Z = 1000
_ISO_M = 2000


def _parse_type(raw: int) -> Tuple[GeometryType, bool, bool, bool]:
    """Return (base type, has_z, has_m, has_srid) handling ISO + EWKB flags."""
    has_srid = bool(raw & _EWKB_SRID)
    has_z = bool(raw & _EWKB_Z)
    has_m = bool(raw & _EWKB_M)
    base = raw & 0x0FFFFFFF
    if base >= _ISO_M:
        has_m, base = True, base - _ISO_M
    if base >= _ISO_Z:
        has_z, base = True, base - _ISO_Z
    return GeometryType(base), has_z, has_m, has_srid


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self, little: bool) -> int:
        v = struct.unpack_from("<I" if little else ">I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def f64s(self, n: int, little: bool) -> np.ndarray:
        out = np.frombuffer(
            self.buf, dtype="<f8" if little else ">f8",
            count=n, offset=self.pos).astype(np.float64)
        self.pos += 8 * n
        return out


def _read_geometry(cur: _Cursor, builder: GeometryBuilder,
                   srid_out: List[int]) -> None:
    little = cur.u8() == 1
    gtype, has_z, has_m, has_srid = _parse_type(cur.u32(little))
    if has_srid:
        srid_out.append(cur.u32(little))
    dim = 2 + int(has_z) + int(has_m)
    keep = 3 if has_z else 2

    def read_coords(n):
        arr = cur.f64s(n * dim, little).reshape(n, dim)
        return arr[:, :keep]

    if gtype == GeometryType.POINT:
        builder.add(GeometryType.POINT, [[read_coords(1)]])
    elif gtype == GeometryType.LINESTRING:
        builder.add(GeometryType.LINESTRING, [[read_coords(cur.u32(little))]])
    elif gtype == GeometryType.POLYGON:
        nrings = cur.u32(little)
        rings = [read_coords(cur.u32(little)) for _ in range(nrings)]
        builder.add(GeometryType.POLYGON, [rings])
    elif gtype in (GeometryType.MULTIPOINT, GeometryType.MULTILINESTRING,
                   GeometryType.MULTIPOLYGON):
        n = cur.u32(little)
        parts = []
        for _ in range(n):
            sub_little = cur.u8() == 1
            sub_type, sz, sm, ssrid = _parse_type(cur.u32(sub_little))
            if ssrid:
                cur.u32(sub_little)
            sdim = 2 + int(sz) + int(sm)
            skeep = 3 if sz else 2

            def sub_coords(k):
                a = cur.f64s(k * sdim, sub_little).reshape(k, sdim)
                return a[:, :skeep]

            if sub_type == GeometryType.POINT:
                parts.append([sub_coords(1)])
            elif sub_type == GeometryType.LINESTRING:
                parts.append([sub_coords(cur.u32(sub_little))])
            elif sub_type == GeometryType.POLYGON:
                nr = cur.u32(sub_little)
                parts.append([sub_coords(cur.u32(sub_little))
                              for _ in range(nr)])
            else:
                raise ValueError(f"bad member type {sub_type} in multi")
        builder.add(gtype, parts)
    elif gtype == GeometryType.GEOMETRYCOLLECTION:
        # Flatten: represented as one geometry whose parts are the members'
        # parts; member types are not preserved individually, so we store the
        # collection via a sub-builder then merge parts.  Collections of
        # collections are handled recursively.
        n = cur.u32(little)
        sub = GeometryBuilder(ndim=builder.ndim)
        for _ in range(n):
            _read_geometry(cur, sub, srid_out)
        sub_arr = sub.finish()
        eff = sub_arr.part_types_effective()
        parts, ptypes = [], []
        for i in range(len(sub_arr)):
            _, sub_parts = sub_arr.geom_slices(i)
            parts.extend(sub_parts)
            ptypes.extend(eff[sub_arr.geom_offsets[i]:
                              sub_arr.geom_offsets[i + 1]].tolist())
        builder.add(GeometryType.GEOMETRYCOLLECTION, parts,
                    part_types=ptypes)
    else:
        raise ValueError(f"unsupported WKB type {gtype}")


def read_wkb(blobs: Sequence[bytes], srid: int = 4326) -> GeometryArray:
    """Parse a batch of WKB blobs into one GeometryArray.

    Fast path: if every blob is a little-endian 2D POINT (21 bytes), decode
    the whole batch with one vectorized ``np.frombuffer``.
    """
    blobs = list(blobs)
    if not blobs:
        return GeometryArray.empty(srid=srid)
    if all(len(b) == 21 and b[0] == 1 and b[1:5] == b"\x01\x00\x00\x00"
           for b in blobs):
        raw = np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(-1, 21)
        xy = raw[:, 5:].copy().view("<f8").reshape(-1, 2)
        return GeometryArray.from_points(xy, srid=srid)
    builder = GeometryBuilder()
    srid_seen: List[int] = []
    for b in blobs:
        _read_geometry(_Cursor(bytes(b)), builder, srid_seen)
    out = builder.finish()
    out.srid = srid_seen[0] if srid_seen else srid
    return out


# ---------------------------------------------------------------- writing

def _wkb_coords(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype="<f8").tobytes()


def _write_one(gtype: GeometryType, parts, ndim: int, part_types=None) -> bytes:
    z_flag = _ISO_Z if ndim == 3 else 0
    head = struct.pack("<BI", 1, int(gtype) + z_flag)
    body = b""
    if gtype == GeometryType.POINT:
        pt = parts[0][0]
        if len(pt) == 0:  # empty point → NaN coords per ISO
            body = struct.pack("<%dd" % ndim, *([float("nan")] * ndim))
        else:
            body = _wkb_coords(pt[:1])
    elif gtype == GeometryType.LINESTRING:
        ring = parts[0][0] if parts and parts[0] else np.zeros((0, ndim))
        body = struct.pack("<I", len(ring)) + _wkb_coords(ring)
    elif gtype == GeometryType.POLYGON:
        rings = parts[0] if parts else []
        body = struct.pack("<I", len(rings))
        for r in rings:
            body += struct.pack("<I", len(r)) + _wkb_coords(r)
    elif gtype in (GeometryType.MULTIPOINT, GeometryType.MULTILINESTRING,
                   GeometryType.MULTIPOLYGON):
        single = {4: GeometryType.POINT, 5: GeometryType.LINESTRING,
                  6: GeometryType.POLYGON}[int(gtype)]
        body = struct.pack("<I", len(parts))
        for p in parts:
            body += _write_one(single, [p], ndim)
    elif gtype == GeometryType.GEOMETRYCOLLECTION:
        # Members are re-emitted with inferred types: parts with 1-vertex
        # single ring → point; 1 ring open → linestring; else polygon.
        body = struct.pack("<I", len(parts))
        for j, p in enumerate(parts):
            body += _write_one(_member_type(p, part_types, j), [p], ndim)
    else:
        raise ValueError(gtype)
    return head + body


def _member_type(rings, part_types, j) -> GeometryType:
    """Member type for a collection part: the recorded type when the
    array carries one (and it isn't the unknown-member sentinel), else
    shape inference (legacy arrays built without part types)."""
    if part_types is not None:
        t = GeometryType(int(part_types[j]))
        if t != GeometryType.GEOMETRYCOLLECTION:
            return t
    return _infer_part_type(rings)


def _infer_part_type(rings) -> GeometryType:
    if len(rings) == 1:
        r = rings[0]
        if len(r) == 1:
            return GeometryType.POINT
        if len(r) >= 2 and not np.array_equal(r[0], r[-1]):
            return GeometryType.LINESTRING
    return GeometryType.POLYGON


def write_wkb(arr: GeometryArray) -> List[bytes]:
    """Serialize each geometry to little-endian ISO WKB."""
    out = []
    for i in range(len(arr)):
        t, parts = arr.geom_slices(i)
        pt = (arr.part_types[arr.geom_offsets[i]:arr.geom_offsets[i + 1]]
              if arr.part_types is not None else None)
        out.append(_write_one(t, parts, arr.ndim, pt))
    return out
