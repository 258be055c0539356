"""WKT (Well-Known Text) reader / writer.

Reference counterpart: JTS WKTReader/WKTWriter used via
core/geometry/api/GeometryAPI.scala:37-105.  Host-side boundary codec; not a
hot path (bulk data arrives as WKB / arrays).
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

from .array import GeometryArray, GeometryBuilder, GeometryType

_TYPE_RE = re.compile(
    r"\s*(POINT|LINESTRING|POLYGON|MULTIPOINT|MULTILINESTRING|MULTIPOLYGON|"
    r"GEOMETRYCOLLECTION)\s*(ZM|Z|M)?\s*", re.IGNORECASE)
_NUM_RE = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?")


class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def skip_ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        self.skip_ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect(self, ch: str):
        self.skip_ws()
        if self.i >= len(self.s) or self.s[self.i] != ch:
            raise ValueError(f"WKT parse error at {self.i} in {self.s[:80]!r}:"
                             f" expected {ch!r}")
        self.i += 1

    def try_word(self, word: str) -> bool:
        self.skip_ws()
        if self.s[self.i:self.i + len(word)].upper() == word:
            self.i += len(word)
            return True
        return False

    def coords_seq(self, dim_hint: int) -> np.ndarray:
        """Parse 'x y [z[ m]], x y ...' up to the closing paren."""
        self.expect("(")
        rows: List[List[float]] = []
        while True:
            nums = []
            while True:
                self.skip_ws()
                m = _NUM_RE.match(self.s, self.i)
                if not m:
                    break
                nums.append(float(m.group()))
                self.i = m.end()
            rows.append(nums)
            ch = self.peek()
            if ch == ",":
                self.i += 1
                continue
            self.expect(")")
            break
        width = max(len(r) for r in rows)
        arr = np.full((len(rows), width), np.nan)
        for k, r in enumerate(rows):
            arr[k, :len(r)] = r
        return arr[:, :max(2, min(width, 3 if dim_hint >= 3 else 2))]


def _parse_geometry(p: _P, builder: GeometryBuilder):
    m = _TYPE_RE.match(p.s, p.i)
    if not m:
        raise ValueError(f"WKT parse error: no geometry tag at {p.s[p.i:p.i+40]!r}")
    p.i = m.end()
    tag = m.group(1).upper()
    zm = (m.group(2) or "").upper()
    dim = 3 if "Z" in zm else 2
    gtype = GeometryType[tag]

    if p.try_word("EMPTY"):
        builder.add(gtype, [] if gtype.value >= 4 else [[np.zeros((0, dim))]])
        return

    if gtype == GeometryType.POINT:
        builder.add(gtype, [[p.coords_seq(dim)]])
    elif gtype == GeometryType.LINESTRING:
        builder.add(gtype, [[p.coords_seq(dim)]])
    elif gtype == GeometryType.POLYGON:
        builder.add(gtype, [_rings(p, dim)])
    elif gtype == GeometryType.MULTIPOINT:
        p.expect("(")
        parts = []
        while True:
            if p.peek() == "(":
                parts.append([p.coords_seq(dim)])
            else:  # bare 'x y' form
                sub = _P("(" + _take_until_comma_or_close(p) + ")")
                parts.append([sub.coords_seq(dim)])
            if p.peek() == ",":
                p.i += 1
                continue
            p.expect(")")
            break
        builder.add(gtype, parts)
    elif gtype == GeometryType.MULTILINESTRING:
        p.expect("(")
        parts = []
        while True:
            parts.append([p.coords_seq(dim)])
            if p.peek() == ",":
                p.i += 1
                continue
            p.expect(")")
            break
        builder.add(gtype, parts)
    elif gtype == GeometryType.MULTIPOLYGON:
        p.expect("(")
        parts = []
        while True:
            parts.append(_rings(p, dim))
            if p.peek() == ",":
                p.i += 1
                continue
            p.expect(")")
            break
        builder.add(gtype, parts)
    elif gtype == GeometryType.GEOMETRYCOLLECTION:
        p.expect("(")
        sub = GeometryBuilder(ndim=dim)
        while True:
            _parse_geometry(p, sub)
            if p.peek() == ",":
                p.i += 1
                continue
            p.expect(")")
            break
        arr = sub.finish()
        eff = arr.part_types_effective()
        parts, ptypes = [], []
        for i in range(len(arr)):
            _, sp = arr.geom_slices(i)
            parts.extend(sp)
            ptypes.extend(eff[arr.geom_offsets[i]:
                              arr.geom_offsets[i + 1]].tolist())
        builder.add(gtype, parts, part_types=ptypes)


def _take_until_comma_or_close(p: _P) -> str:
    j = p.i
    depth = 0
    while j < len(p.s):
        c = p.s[j]
        if c == "(":
            depth += 1
        elif c == ")" and depth == 0:
            break
        elif c == ")":
            depth -= 1
        elif c == "," and depth == 0:
            break
        j += 1
    out = p.s[p.i:j]
    p.i = j
    return out


def _rings(p: _P, dim: int) -> List[np.ndarray]:
    p.expect("(")
    rings = []
    while True:
        rings.append(p.coords_seq(dim))
        if p.peek() == ",":
            p.i += 1
            continue
        p.expect(")")
        break
    return rings


def read_wkt(texts: Sequence[str], srid: int = 4326) -> GeometryArray:
    builder = GeometryBuilder(srid=srid)
    for t in texts:
        _parse_geometry(_P(t), builder)
    return builder.finish()


# ---------------------------------------------------------------- writing

def _fmt(v: float) -> str:
    if not np.isfinite(v):
        return repr(float(v))
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _coords_txt(arr: np.ndarray) -> str:
    return ", ".join(" ".join(_fmt(c) for c in row) for row in arr)


def _write_one(gtype: GeometryType, parts, ndim: int,
               part_types=None) -> str:
    tag = gtype.wkt_name + (" Z" if ndim == 3 else "")

    def ring_set(rings):
        return "(" + ", ".join(f"({_coords_txt(r)})" for r in rings) + ")"

    if not parts or all(len(r) == 0 for rings in parts for r in rings):
        return f"{gtype.wkt_name} EMPTY"
    if gtype == GeometryType.POINT:
        pt = parts[0][0][:1]
        if not np.all(np.isfinite(pt)):  # ISO empty point (NaN coords)
            return f"{gtype.wkt_name} EMPTY"
        return f"{tag} ({_coords_txt(pt)})"
    if gtype == GeometryType.LINESTRING:
        return f"{tag} ({_coords_txt(parts[0][0])})"
    if gtype == GeometryType.POLYGON:
        return f"{tag} {ring_set(parts[0])}"
    if gtype == GeometryType.MULTIPOINT:
        inner = ", ".join(f"({_coords_txt(p[0][:1])})" for p in parts)
        return f"{tag} ({inner})"
    if gtype == GeometryType.MULTILINESTRING:
        inner = ", ".join(f"({_coords_txt(p[0])})" for p in parts)
        return f"{tag} ({inner})"
    if gtype == GeometryType.MULTIPOLYGON:
        inner = ", ".join(ring_set(p) for p in parts)
        return f"{tag} ({inner})"
    if gtype == GeometryType.GEOMETRYCOLLECTION:
        from .wkb import _member_type
        inner = ", ".join(
            _write_one(_member_type(p, part_types, j), [p], ndim)
            for j, p in enumerate(parts))
        return f"{tag} ({inner})"
    raise ValueError(gtype)


def write_wkt(arr: GeometryArray) -> List[str]:
    out = []
    for i in range(len(arr)):
        t, parts = arr.geom_slices(i)
        pt = (arr.part_types[arr.geom_offsets[i]:arr.geom_offsets[i + 1]]
              if arr.part_types is not None else None)
        out.append(_write_one(t, parts, arr.ndim, pt))
    return out
