"""Columnar geometry batches — the primary representation.

The reference keeps geometries as row objects wrapping JTS
(core/geometry/MosaicGeometry.scala:14) and only flattens to arrays at the
Spark wire boundary (core/types/model/InternalGeometry.scala:23-27:
``boundaries: Array[Array[InternalCoord]]``).  TPU-first we invert that: the
flattened, offset-indexed coordinate array IS the geometry, living in host
RAM (float64) and shipped to device HBM (float32 blocks) for kernels.

Layout (GeoArrow-style triple nesting, covers all 7 OGC types):

    coords        [V, D]  float64   all vertices, D in {2, 3}
    ring_offsets  [R+1]   int64     vertex span of each ring / linestring / point
    part_offsets  [P+1]   int64     ring span of each part (polygon = shell+holes)
    geom_offsets  [G+1]   int64     part span of each geometry
    types         [G]     uint8     GeometryType code per geometry
    srid          int               spatial reference id (0 = unset, 4326 default)

A Point is one part with one ring of one vertex; a LineString one part/one
ring; a Polygon one part with shell ring + hole rings; Multi* and
GeometryCollection span several parts.  ``types`` disambiguates.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, List, Sequence, Tuple

import numpy as np


class GeometryType(enum.IntEnum):
    """OGC geometry type codes (match WKB integer codes).

    Reference enum: core/types/GeometryTypeEnum.scala.
    """

    POINT = 1
    LINESTRING = 2
    POLYGON = 3
    MULTIPOINT = 4
    MULTILINESTRING = 5
    MULTIPOLYGON = 6
    GEOMETRYCOLLECTION = 7

    @property
    def wkt_name(self) -> str:
        return {
            1: "POINT", 2: "LINESTRING", 3: "POLYGON", 4: "MULTIPOINT",
            5: "MULTILINESTRING", 6: "MULTIPOLYGON", 7: "GEOMETRYCOLLECTION",
        }[int(self)]


_SINGLE_OF = {
    GeometryType.MULTIPOINT: GeometryType.POINT,
    GeometryType.MULTILINESTRING: GeometryType.LINESTRING,
    GeometryType.MULTIPOLYGON: GeometryType.POLYGON,
}
_MULTI_OF = {v: k for k, v in _SINGLE_OF.items()}


@dataclasses.dataclass
class GeometryArray:
    """A batch of geometries in flattened columnar form."""

    coords: np.ndarray        # [V, D] float64
    ring_offsets: np.ndarray  # [R+1] int64
    part_offsets: np.ndarray  # [P+1] int64
    geom_offsets: np.ndarray  # [G+1] int64
    types: np.ndarray         # [G] uint8
    srid: int = 4326
    # [P] uint8 member types — only meaningful for GEOMETRYCOLLECTION
    # rows, whose parts would otherwise lose their sub-geometry type in
    # the flattened layout (a closed LINESTRING member must not read as
    # a filled POLYGON).  None = derive from the row type.
    part_types: "np.ndarray | None" = None

    # ---------------------------------------------------------- invariants
    def __post_init__(self):
        self.coords = np.asarray(self.coords, dtype=np.float64)
        if self.coords.ndim != 2:
            self.coords = self.coords.reshape(-1, 2)
        self.ring_offsets = np.asarray(self.ring_offsets, dtype=np.int64)
        self.part_offsets = np.asarray(self.part_offsets, dtype=np.int64)
        self.geom_offsets = np.asarray(self.geom_offsets, dtype=np.int64)
        self.types = np.asarray(self.types, dtype=np.uint8)
        if self.part_types is not None:
            self.part_types = np.asarray(self.part_types, dtype=np.uint8)

    def validate(self) -> None:
        assert self.ring_offsets[0] == 0
        assert self.part_offsets[0] == 0
        assert self.geom_offsets[0] == 0
        assert self.ring_offsets[-1] == len(self.coords)
        assert self.part_offsets[-1] == len(self.ring_offsets) - 1
        assert self.geom_offsets[-1] == len(self.part_offsets) - 1
        assert len(self.types) == len(self)
        if self.part_types is not None:
            # a mismatched array would silently misindex every
            # part_types_effective consumer (wkb/wkt/geojson writers,
            # padded edge builder) — fail at construction instead
            assert len(self.part_types) == len(self.part_offsets) - 1, \
                (len(self.part_types), len(self.part_offsets) - 1)
        assert np.all(np.diff(self.ring_offsets) >= 0)
        assert np.all(np.diff(self.part_offsets) >= 0)
        assert np.all(np.diff(self.geom_offsets) >= 0)

    # ------------------------------------------------------------- basics
    def __len__(self) -> int:
        return len(self.geom_offsets) - 1

    @property
    def ndim(self) -> int:
        return self.coords.shape[1]

    @property
    def num_rings(self) -> int:
        return len(self.ring_offsets) - 1

    @property
    def num_parts(self) -> int:
        return len(self.part_offsets) - 1

    def geom_type(self, i: int) -> GeometryType:
        return GeometryType(int(self.types[i]))

    # ------------------------------------------------------ constructors
    @staticmethod
    def empty(ndim: int = 2, srid: int = 4326) -> "GeometryArray":
        return GeometryArray(
            coords=np.zeros((0, ndim)), ring_offsets=np.zeros(1, np.int64),
            part_offsets=np.zeros(1, np.int64),
            geom_offsets=np.zeros(1, np.int64),
            types=np.zeros(0, np.uint8), srid=srid)

    @staticmethod
    def from_points(xy: np.ndarray, srid: int = 4326) -> "GeometryArray":
        """Vectorized constructor for a batch of POINTs from an [N, D] array."""
        xy = np.atleast_2d(np.asarray(xy, dtype=np.float64))
        n = len(xy)
        ar = np.arange(n + 1, dtype=np.int64)
        return GeometryArray(
            coords=xy, ring_offsets=ar, part_offsets=ar, geom_offsets=ar,
            types=np.full(n, GeometryType.POINT, np.uint8), srid=srid)

    @staticmethod
    def from_padded_polygons(verts: np.ndarray, counts: np.ndarray,
                             srid: int = 4326) -> "GeometryArray":
        """Vectorized batch of simple polygons from padded rings.

        verts [M, K, 2] (CCW, padded), counts [M] valid vertex counts.
        Rings are closed (first vertex appended).  This is the fast path
        for turning grid-cell boundaries into polygon batches."""
        verts = np.asarray(verts, np.float64)
        counts = np.asarray(counts, np.int64)
        m, k = verts.shape[:2]
        if m == 0:
            return GeometryArray.empty(2, srid)
        flat = verts.reshape(-1, 2)
        lens = counts
        firsts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        main_idx = np.arange(int(lens.sum()), dtype=np.int64) + \
            np.repeat(np.arange(m, dtype=np.int64) * k - firsts, lens)
        ring_id = np.repeat(np.arange(m), lens)
        out_off = np.concatenate([[0], np.cumsum(counts + 1)]).astype(
            np.int64)
        out = np.empty(out_off[-1], np.int64)
        out[np.arange(len(main_idx)) + ring_id] = main_idx
        out[out_off[1:] - 1] = np.arange(m, dtype=np.int64) * k
        ar = np.arange(m + 1, dtype=np.int64)
        return GeometryArray(
            coords=flat[out], ring_offsets=out_off, part_offsets=ar,
            geom_offsets=ar,
            types=np.full(m, GeometryType.POLYGON, np.uint8), srid=srid)

    @staticmethod
    def concat(arrays: Sequence["GeometryArray"]) -> "GeometryArray":
        arrays = [a for a in arrays if len(a) > 0] or [GeometryArray.empty()]
        ndim = max(a.ndim for a in arrays)
        coords, rings, parts, geoms, types = [], [0], [0], [0], []
        for a in arrays:
            c = a.coords
            if c.shape[1] < ndim:
                c = np.pad(c, ((0, 0), (0, ndim - c.shape[1])))
            coords.append(c)
            rings.extend((a.ring_offsets[1:] + rings[-1]).tolist())
            parts.extend((a.part_offsets[1:] + parts[-1]).tolist())
            geoms.extend((a.geom_offsets[1:] + geoms[-1]).tolist())
            types.append(a.types)
        any_pt = any(a.part_types is not None for a in arrays)
        return GeometryArray(
            coords=np.concatenate(coords) if coords else np.zeros((0, ndim)),
            ring_offsets=np.asarray(rings, np.int64),
            part_offsets=np.asarray(parts, np.int64),
            geom_offsets=np.asarray(geoms, np.int64),
            types=np.concatenate(types), srid=arrays[0].srid,
            part_types=(np.concatenate([a.part_types_effective()
                                        for a in arrays])
                        if any_pt else None))

    def part_types_effective(self) -> np.ndarray:
        """[P] uint8 member type per part: the stored ``part_types`` when
        present, else the row type broadcast to its parts (multis map to
        their member type; collections without stored types stay
        GEOMETRYCOLLECTION = "unknown member").

        Cached on the (immutable) array: per-row callers — e.g. the
        pairwise distance loop — otherwise rebuild the full [P] array
        per row, turning an O(V) pass into O(G·P) (measured 219 s for
        a 23.7k-pair batch)."""
        if self.part_types is not None:
            return self.part_types
        cached = getattr(self, "_ptype_eff_cache", None)
        if cached is not None:
            return cached
        multi_to_single = {int(GeometryType.MULTIPOINT):
                           int(GeometryType.POINT),
                           int(GeometryType.MULTILINESTRING):
                           int(GeometryType.LINESTRING),
                           int(GeometryType.MULTIPOLYGON):
                           int(GeometryType.POLYGON)}
        per_geom = np.asarray([multi_to_single.get(int(t), int(t))
                               for t in self.types], np.uint8)
        out = np.repeat(per_geom, np.diff(self.geom_offsets))
        try:
            object.__setattr__(self, "_ptype_eff_cache", out)
        except AttributeError:
            pass
        return out

    # -------------------------------------------------------- python view
    def geom_slices(self, i: int) -> Tuple[GeometryType, List[List[np.ndarray]]]:
        """Return (type, parts) where parts is a list of lists of [n,D] rings."""
        t = self.geom_type(i)
        p0, p1 = self.geom_offsets[i], self.geom_offsets[i + 1]
        parts = []
        for p in range(p0, p1):
            r0, r1 = self.part_offsets[p], self.part_offsets[p + 1]
            rings = [self.coords[self.ring_offsets[r]:self.ring_offsets[r + 1]]
                     for r in range(r0, r1)]
            parts.append(rings)
        return t, parts

    def take(self, idx) -> "GeometryArray":
        """Gather/permute a subset of geometries — vectorized offset
        arithmetic, no per-geometry Python work."""
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        if len(idx) == 0:
            return GeometryArray.empty(self.ndim, self.srid)

        def expand(starts, stops):
            """Concatenate aranges [starts[i], stops[i]) without a loop."""
            lens = (stops - starts).astype(np.int64)
            total = int(lens.sum())
            if total == 0:
                return np.zeros(0, np.int64), lens
            firsts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            out = np.arange(total, dtype=np.int64) + \
                np.repeat(starts - firsts, lens)
            return out, lens

        p_idx, parts_per_geom = expand(self.geom_offsets[idx],
                                       self.geom_offsets[idx + 1])
        r_idx, rings_per_part = expand(self.part_offsets[p_idx],
                                       self.part_offsets[p_idx + 1])
        v_idx, verts_per_ring = expand(self.ring_offsets[r_idx],
                                       self.ring_offsets[r_idx + 1])
        ring_offsets = np.concatenate(
            [[0], np.cumsum(verts_per_ring)]).astype(np.int64)
        part_offsets = np.concatenate(
            [[0], np.cumsum(rings_per_part)]).astype(np.int64)
        geom_offsets = np.concatenate(
            [[0], np.cumsum(parts_per_geom)]).astype(np.int64)
        return GeometryArray(
            coords=self.coords[v_idx], ring_offsets=ring_offsets,
            part_offsets=part_offsets, geom_offsets=geom_offsets,
            types=self.types[idx], srid=self.srid,
            part_types=(self.part_types[p_idx]
                        if self.part_types is not None else None))

    def __getitem__(self, i) -> "GeometryArray":
        if isinstance(i, (int, np.integer)):
            return self.take([i])
        return self.take(np.arange(len(self))[i])

    # -------------------------------------------------------- aggregates
    def vertex_starts(self) -> np.ndarray:
        """First-vertex index of each geometry (monotone). [G+1] int64."""
        return self.ring_offsets[self.part_offsets[self.geom_offsets]]

    def vertex_counts(self) -> np.ndarray:
        """Vertices per geometry. [G] int64."""
        return np.diff(self.vertex_starts())

    def bboxes(self) -> np.ndarray:
        """Per-geometry [G, 4] (xmin, ymin, xmax, ymax); NaN for empties."""
        g = len(self)
        out = np.full((g, 4), np.nan)
        vc = self.vertex_counts()
        # geometry id for each vertex
        vgeom = self.vertex_geom_ids()
        if len(self.coords):
            x, y = self.coords[:, 0], self.coords[:, 1]
            for c, (col, fn) in enumerate(
                    [(x, np.minimum), (y, np.minimum),
                     (x, np.maximum), (y, np.maximum)]):
                acc = np.full(g, np.inf if fn is np.minimum else -np.inf)
                fn.at(acc, vgeom, col)
                out[:, c] = acc
        out[vc == 0] = np.nan
        return out

    def vertex_geom_ids(self) -> np.ndarray:
        """Geometry id for every vertex. [V] int64."""
        return np.repeat(np.arange(len(self)),
                         self.vertex_counts()).astype(np.int64)

    def ring_part_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.num_parts),
                         np.diff(self.part_offsets)).astype(np.int64)

    def part_geom_ids(self) -> np.ndarray:
        return np.repeat(np.arange(len(self)),
                         np.diff(self.geom_offsets)).astype(np.int64)

    def ring_geom_ids(self) -> np.ndarray:
        return self.part_geom_ids()[self.ring_part_ids()]


class GeometryBuilder:
    """Incremental host-side builder for GeometryArray."""

    def __init__(self, ndim: int = 2, srid: int = 4326):
        self.ndim = ndim
        self.srid = srid
        self._coords: List[np.ndarray] = []
        self._rings = [0]
        self._parts = [0]
        self._geoms = [0]
        self._types: List[int] = []
        self._part_types: List[int] = []
        self._have_part_types = False
        self._nv = 0

    def add(self, gtype: GeometryType,
            parts: Iterable[Iterable[np.ndarray]],
            part_types: "Iterable[int] | None" = None) -> None:
        parts = list(parts)
        if part_types is not None:
            part_types = [int(t) for t in part_types]
            if len(part_types) != len(parts):
                raise ValueError(f"{len(part_types)} part types for "
                                 f"{len(parts)} parts")
            self._part_types.extend(part_types)
            self._have_part_types = True
        else:
            # default: member type derived from the row type (multis map
            # to their member; collections stay "unknown")
            m2s = {int(GeometryType.MULTIPOINT): int(GeometryType.POINT),
                   int(GeometryType.MULTILINESTRING):
                   int(GeometryType.LINESTRING),
                   int(GeometryType.MULTIPOLYGON):
                   int(GeometryType.POLYGON)}
            self._part_types.extend(
                [m2s.get(int(gtype), int(gtype))] * len(parts))
        for rings in parts:
            for ring in rings:
                ring = np.atleast_2d(np.asarray(ring, dtype=np.float64))
                if ring.size and ring.shape[1] > self.ndim:
                    self.ndim = ring.shape[1]
                self._coords.append(ring.reshape(-1, ring.shape[1]
                                                 if ring.size else self.ndim))
                self._nv += len(self._coords[-1])
                self._rings.append(self._nv)
            self._parts.append(len(self._rings) - 1)
        self._geoms.append(len(self._parts) - 1)
        self._types.append(int(gtype))

    def add_empty_polygons(self, n: int) -> None:
        """Append n empty POLYGON rows in one pass (each: one part, one
        zero-vertex ring) — the bulk form of the core-chip placeholder
        (keep_core_geom=False emits tens of thousands; per-row add()
        was ~15% of county-scale tessellation)."""
        if n <= 0:
            return
        self._rings.extend([self._nv] * n)
        base_p = len(self._rings) - n
        self._parts.extend(range(base_p, base_p + n))
        base_g = len(self._parts) - n
        self._geoms.extend(range(base_g, base_g + n))
        self._types.extend([int(GeometryType.POLYGON)] * n)
        self._part_types.extend([int(GeometryType.POLYGON)] * n)

    def add_shell_polygons(self, shells) -> None:
        """Append one single-ring POLYGON per entry of ``shells`` (each
        a prepared closed [V, >=2] float64 ring) — the bulk form for
        hole-free chip streams; skips add()'s per-ring normalization."""
        for s in shells:
            self._coords.append(s)
            self._nv += len(s)
            self._rings.append(self._nv)
        n = len(shells)
        if n == 0:
            return
        base_p = len(self._rings) - n
        self._parts.extend(range(base_p, base_p + n))
        base_g = len(self._parts) - n
        self._geoms.extend(range(base_g, base_g + n))
        self._types.extend([int(GeometryType.POLYGON)] * n)
        self._part_types.extend([int(GeometryType.POLYGON)] * n)

    def add_point(self, xy) -> None:
        self.add(GeometryType.POINT, [[np.atleast_2d(xy)]])

    def add_linestring(self, xy) -> None:
        self.add(GeometryType.LINESTRING, [[xy]])

    def add_polygon(self, shell, holes=()) -> None:
        self.add(GeometryType.POLYGON, [[shell, *holes]])

    def add_multipolygon(self, polys) -> None:
        self.add(GeometryType.MULTIPOLYGON, [list(p) for p in polys])

    def finish(self) -> GeometryArray:
        coords = [np.zeros((0, self.ndim))]
        for c in self._coords:
            if c.shape[1] < self.ndim:
                c = np.pad(c, ((0, 0), (0, self.ndim - c.shape[1])))
            coords.append(c)
        return GeometryArray(
            coords=np.concatenate(coords),
            ring_offsets=np.asarray(self._rings, np.int64),
            part_offsets=np.asarray(self._parts, np.int64),
            geom_offsets=np.asarray(self._geoms, np.int64),
            types=np.asarray(self._types, np.uint8), srid=self.srid,
            part_types=(np.asarray(self._part_types, np.uint8)
                        if self._have_part_types else None))
