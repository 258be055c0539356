"""Synthetic benchmark workloads.

The headline workload mirrors the reference Quickstart
(notebooks/examples/python/Quickstart/QuickstartNotebook.ipynb): a
point×polygon PIP join over a city-scale zone partition — NYC taxi pickups
× ~300 taxi zones (BASELINE.md config 1).  With zero egress the real
parquet/GeoJSON inputs aren't available, so we generate a statistically
similar stand-in: a jittered-lattice planar partition of the NYC bbox
(convex quad "zones", same count/size regime as taxi zones) and uniform
pickup points.  Exactness is still checked against the float64 host path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.geometry.array import GeometryArray, GeometryBuilder
from ..core.index.base import IndexSystem
from ..core.index.custom import CustomIndexSystem, GridConf

# NYC-ish bbox (lon/lat)
NYC = (-74.30, 40.45, -73.65, 40.95)
# CONUS bbox (lon/lat) for the US-county-scale workload
CONUS = (-124.7, 24.5, -66.9, 49.4)


def conus_counties(n_side: int = 56, seed: int = 23) -> "GeometryArray":
    """~3.1k-polygon partition of the CONUS bbox with fractal boundaries —
    the US-county stand-in for BASELINE.md config 2 (grid_tessellate on
    county polygons).  Reuses the taxi-zone generator at continental
    scale; hole/merge features off (counties are simple polygons)."""
    return taxi_zones(n_side=n_side, seed=seed, bbox=CONUS,
                      hole_every=0, merge_every=0)


def nyc_zones(n_side: int = 16, seed: int = 7,
              bbox: Tuple[float, float, float, float] = NYC
              ) -> GeometryArray:
    """A planar partition of ``bbox`` into n_side² convex quads (jittered
    lattice) — the taxi-zone stand-in."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(bbox[0], bbox[2], n_side + 1)
    ys = np.linspace(bbox[1], bbox[3], n_side + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    jx = (xs[1] - xs[0]) * 0.30
    jy = (ys[1] - ys[0]) * 0.30
    nodes = np.stack([gx, gy], axis=-1)
    jitter = rng.uniform(-1, 1, nodes.shape) * np.array([jx, jy])
    jitter[0, :, 0] = jitter[-1, :, 0] = 0.0
    jitter[:, 0, 1] = jitter[:, -1, 1] = 0.0
    nodes = nodes + jitter
    b = GeometryBuilder()
    for i in range(n_side):
        for j in range(n_side):
            ring = np.array([nodes[i, j], nodes[i + 1, j],
                             nodes[i + 1, j + 1], nodes[i, j + 1],
                             nodes[i, j]])
            b.add_polygon(ring)
    return b.finish()


def _wiggle(p0: np.ndarray, p1: np.ndarray, rng,
            levels: int = 2, amp: float = 0.22) -> np.ndarray:
    """Midpoint-displacement polyline from p0 to p1 (endpoints fixed).

    Each level halves segments and displaces midpoints perpendicular to
    the local segment by up to ``amp``×len — the fractal boundary that
    makes zones concave the way real administrative borders are."""
    pts = np.array([p0, p1], dtype=np.float64)
    for _ in range(levels):
        seg = pts[1:] - pts[:-1]
        mid = (pts[:-1] + pts[1:]) / 2
        perp = np.stack([-seg[:, 1], seg[:, 0]], axis=-1)
        mid = mid + perp * rng.uniform(-amp, amp, (len(mid), 1))
        out = np.empty((len(pts) + len(mid), 2))
        out[0::2] = pts
        out[1::2] = mid
        pts = out
    return pts


def _fit_hole(ring: np.ndarray, corner_nodes: np.ndarray,
              pitch_x: float, pitch_y: float):
    """Largest of a few candidate hole squares strictly inside ``ring``.

    The fractal boundary can intrude deep into the cell, so candidate
    holes are validated (all corners inside, clear of the boundary by a
    margin) and shrunk until one fits; None if none does — a hole that
    crossed its cell's boundary would break the partition property."""
    from ..core.geometry.clip import (_pip_rings, _seg_point_dist,
                                      proper_crossings)
    c = corner_nodes.mean(axis=0)
    closed = np.vstack([ring, ring[:1]])
    edges = np.stack([closed[:-1], closed[1:]], axis=1)

    margin = 0.02 * min(pitch_x, pitch_y)
    for scale in (0.16, 0.12, 0.08, 0.05):
        hw, hh = pitch_x * scale, pitch_y * scale
        sq = np.array([[c[0] - hw, c[1] - hh], [c[0] + hw, c[1] - hh],
                       [c[0] + hw, c[1] + hh], [c[0] - hw, c[1] + hh],
                       [c[0] - hw, c[1] - hh]])
        hole_edges = np.stack([sq[:-1], sq[1:]], axis=1)
        if np.all(_pip_rings(sq[:4], [ring])) and \
                _seg_point_dist(sq[:4], edges).min() > margin and \
                not np.any(proper_crossings(hole_edges, edges)):
            return sq
    return None


def taxi_zones(n_side: int = 16, seed: int = 7,
               bbox: Tuple[float, float, float, float] = NYC,
               hole_every: int = 7, merge_every: int = 11
               ) -> GeometryArray:
    """The honest taxi-zone stand-in: a planar partition of ``bbox`` into
    concave multipolygon zones with holes.

    Construction keeps the partition property (every interior point in
    exactly one zone — required for zone-assignment semantics):

    - lattice nodes are jittered, then every interior lattice edge is
      replaced by a shared fractal polyline (midpoint displacement), so
      both zones flanking it stay watertight while their rings become
      concave (many more border chips per zone, like real taxi zones);
    - every ``hole_every``-th cell gets a hole whose region is emitted as
      a separate island zone (donut + island — exercises hole handling
      end-to-end, still a partition);
    - every ``merge_every``-th pair of far-apart cells is merged into one
      MULTIPOLYGON zone (two disjoint parts under one zone id).
    """
    rng = np.random.default_rng(seed)
    xs = np.linspace(bbox[0], bbox[2], n_side + 1)
    ys = np.linspace(bbox[1], bbox[3], n_side + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    jx = (xs[1] - xs[0]) * 0.25
    jy = (ys[1] - ys[0]) * 0.25
    nodes = np.stack([gx, gy], axis=-1)
    jitter = rng.uniform(-1, 1, nodes.shape) * np.array([jx, jy])
    jitter[0, :, 0] = jitter[-1, :, 0] = 0.0
    jitter[:, 0, 1] = jitter[:, -1, 1] = 0.0
    nodes = nodes + jitter

    # Shared fractal polylines per lattice edge, seeded per edge so any
    # edge can be regenerated with a smaller amplitude independently.
    # Boundary edges stay straight.
    amp0 = 0.22
    level = {}                      # edge key -> amplitude halvings

    def edge_poly(kind, i, j):
        if kind == "h":
            a, b = nodes[i, j], nodes[i + 1, j]
            straight = j == 0 or j == n_side
        else:
            a, b = nodes[i, j], nodes[i, j + 1]
            straight = i == 0 or i == n_side
        if straight:
            return np.array([a, b])
        k = level.get((kind, i, j), 0)
        erng = np.random.default_rng(
            np.random.SeedSequence([seed, 1 + (kind == "v"), i, j, k]))
        return _wiggle(a, b, erng, amp=amp0 * 0.5 ** k)

    # hedge[i][j]: nodes[i,j] -> nodes[i+1,j]; vedge[i][j]: -> nodes[i,j+1]
    def build_edges():
        h = [[edge_poly("h", i, j) for j in range(n_side + 1)]
             for i in range(n_side)]
        v = [[edge_poly("v", i, j) for j in range(n_side)]
             for i in range(n_side + 1)]
        return h, v

    def cell_ring(i, j):
        bottom = hedge[i][j]
        right = vedge[i + 1][j]
        top = hedge[i][j + 1][::-1]
        left = vedge[i][j][::-1]
        return np.concatenate([bottom[:-1], right[:-1], top[:-1], left])

    def cell_edge_keys(i, j):
        return [("h", i, j), ("h", i, j + 1), ("v", i, j), ("v", i + 1, j)]

    from ..core.geometry.clip import proper_crossings

    def ring_edges(r):
        return np.stack([r, np.roll(r, -1, axis=0)], axis=1)

    def ring_self_crosses(r):
        return bool(np.any(np.triu(proper_crossings(ring_edges(r),
                                                    ring_edges(r)), 2)))

    def rings_cross(r1, r2):
        # proper crossings only: shared (identical) polyline segments are
        # collinear and never register as proper
        return bool(np.any(proper_crossings(ring_edges(r1),
                                            ring_edges(r2))))

    # validation loop: any self-crossing ring or crossing nearby pair
    # gets its cells' edges regenerated at half amplitude; converges to
    # straight edges, which always form a simple partition.  Fractal
    # excursion + node jitter can reach ~0.75 of the pitch, so pairs up
    # to Chebyshev distance 2 are checked (reach 2×0.75 < 2 pitches).
    near = [(di, dj) for di in range(0, 3) for dj in range(-2, 3)
            if (di, dj) > (0, 0)]
    for _ in range(8):
        hedge, vedge = build_edges()
        rings = {(i, j): cell_ring(i, j) for i in range(n_side)
                 for j in range(n_side)}
        offenders = set()
        for (i, j), r in rings.items():
            if ring_self_crosses(r):
                offenders.add((i, j))
        for i in range(n_side):
            for j in range(n_side):
                for di, dj in near:
                    ni, nj = i + di, j + dj
                    if not (0 <= ni < n_side and 0 <= nj < n_side):
                        continue
                    if rings_cross(rings[(i, j)], rings[(ni, nj)]):
                        offenders.add((i, j))
                        offenders.add((ni, nj))
        if not offenders:
            break
        for cell in offenders:
            for key in cell_edge_keys(*cell):
                level[key] = level.get(key, 0) + 1
    else:
        raise RuntimeError("taxi_zones failed to converge to a simple "
                           "partition")

    cells = {}
    for i in range(n_side):
        for j in range(n_side):
            ring = rings[(i, j)]
            k = i * n_side + j
            holes, islands = [], []
            if hole_every and k % hole_every == 3:
                sq = _fit_hole(ring, nodes[i:i + 2, j:j + 2].reshape(4, 2),
                               xs[1] - xs[0], ys[1] - ys[0])
                if sq is not None:
                    holes.append(sq[::-1])      # CW hole
                    islands.append(sq)          # CCW island zone
            ring = np.vstack([ring, ring[:1]])
            cells[(i, j)] = (ring, holes, islands)

    b = GeometryBuilder()
    merged = set()
    keys = sorted(cells)
    pending_islands = []
    for idx, key in enumerate(keys):
        if key in merged:
            continue
        ring, holes, islands = cells[key]
        parts = [(ring, holes)]
        if merge_every and idx % merge_every == 5:
            # merge with the diagonally opposite cell if still free
            mate = (n_side - 1 - key[0], n_side - 1 - key[1])
            if mate != key and mate not in merged and mate in cells \
                    and mate > key:
                r2, h2, is2 = cells[mate]
                parts.append((r2, h2))
                pending_islands.extend(is2)
                merged.add(mate)
        pending_islands.extend(islands)
        if len(parts) == 1:
            b.add_polygon(parts[0][0], parts[0][1])
        else:
            b.add_multipolygon([[s, *hs] for s, hs in parts])
    for isl in pending_islands:
        b.add_polygon(isl)
    return b.finish()


def nyc_points(n: int, seed: int = 11,
               bbox: Tuple[float, float, float, float] = NYC) -> np.ndarray:
    """[n, 2] float64 uniform points over the bbox (pickups stand-in)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(bbox[0], bbox[2], n),
                     rng.uniform(bbox[1], bbox[3], n)], axis=-1)


#: the overlay footprints' box (bench.py's building-footprint stage)
FOOTPRINT_BOX = (-74.2, 40.55, -73.75, 40.85)


def footprints(n: int, seed: int = 41,
               bbox: Tuple[float, float, float, float] = FOOTPRINT_BOX
               ) -> GeometryArray:
    """``n`` axis-aligned building-footprint boxes scattered over the bbox,
    half-sizes 2e-4..2e-3 degrees — the overlay's A side (BASELINE.md
    config 3: footprints x flood zones), drawn in bench.py's order (center
    x, center y, then both half-sizes) so its first boxes are bench.py's."""
    rng = np.random.default_rng(seed)
    b = GeometryBuilder()
    rings = []
    for _ in range(n):
        cx = rng.uniform(bbox[0], bbox[2])
        cy = rng.uniform(bbox[1], bbox[3])
        w, h = rng.uniform(2e-4, 2e-3, 2)
        rings.append(np.array([[cx - w, cy - h], [cx + w, cy - h],
                               [cx + w, cy + h], [cx - w, cy + h],
                               [cx - w, cy - h]]))
    b.add_shell_polygons(rings)
    return b.finish()


def ais_pings_ports(n_pings: int = 1 << 20, n_ports: int = 3000,
                    seed: int = 31) -> Tuple[np.ndarray, np.ndarray]:
    """(pings [n_pings, 2], ports [n_ports, 2]) f64 lon/lat degrees — AIS
    ship pings x world ports at global extent (BASELINE.md config 4), in
    bench.py's draw order: ports uniform on the sphere within |lat| <=
    78.5, each ping a port plus N(0, 1.5 degrees) per axis, latitude
    clipped to +-88."""
    rng = np.random.default_rng(seed)
    ports = np.stack([
        rng.uniform(-180, 180, n_ports),
        np.degrees(np.arcsin(rng.uniform(-0.98, 0.98, n_ports)))], -1)
    ctr = ports[rng.integers(0, len(ports), n_pings)]
    pings = ctr + rng.normal(0, 1.5, (n_pings, 2))
    pings[:, 1] = np.clip(pings[:, 1], -88, 88)
    return pings, ports


def nyc_grid(res_cells: int = 512,
             bbox: Tuple[float, float, float, float] = NYC
             ) -> Tuple[IndexSystem, int]:
    """A rectangular grid over the bbox whose finest listed resolution has
    ``res_cells`` cells per axis — cell size comparable to H3 res 9 over a
    city (~175 m)."""
    splits = 2
    res = int(np.round(np.log2(res_cells)))
    return CustomIndexSystem(GridConf(
        bbox[0], bbox[2], bbox[1], bbox[3], splits,
        (bbox[2] - bbox[0]), (bbox[3] - bbox[1]), 4326)), res


def build_workload(n_side: int = 16, res_cells: int = 512,
                   grid_name: str = "CUSTOM", h3_res: int = 9,
                   zones: str = "quad"):
    """(polys, grid, res) for the PIP-join benchmark.

    grid_name "H3" is the headline config (BASELINE.md config 1: taxi
    zones at H3 res 9); "CUSTOM" keeps the rectangular grid for
    grid-agnostic engine benchmarks.  zones="taxi" selects the honest
    concave-multipolygon-with-holes partition; "quad" the convex lattice
    (kept for fast unit tests)."""
    polys = taxi_zones(n_side) if zones == "taxi" else nyc_zones(n_side)
    if grid_name.upper() == "H3":
        from ..core.index.factory import get_index_system
        return polys, get_index_system("H3"), h3_res
    grid, res = nyc_grid(res_cells)
    return polys, grid, res


#: offsets (degrees) of the points placed either side of an edge: inside
#: the f32 rounding of city-scale local coordinates, inside the join's
#: 1e-6 degree hazard band, and just outside it
HAIRS_DEG = (1e-9, 1e-7, 2e-6, 1e-5)


def _on_and_beside(a: np.ndarray, b: np.ndarray):
    """Segment ends and midpoints, and the midpoints moved HAIRS_DEG
    either way along the segment normals (degenerate segments skipped);
    with each point's offset from its segment (0 on it)."""
    mid = 0.5 * (a + b)
    d = b - a
    norm = np.hypot(d[:, 0], d[:, 1])
    keep = norm > 0
    normal = np.stack([-d[keep, 1], d[keep, 0]], -1) / norm[keep, None]
    pts = [a, mid]
    for h in HAIRS_DEG:
        pts += [mid[keep] + h * normal, mid[keep] - h * normal]
    off = [np.zeros(len(a)), np.zeros(len(a))]
    off += [np.full(int(keep.sum()), h) for h in HAIRS_DEG for _ in "+-"]
    return pts, off


def adversarial_points(flat_a: np.ndarray, flat_b: np.ndarray,
                       grid: IndexSystem, res: int, n_edges: int,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 points where the f32 join's tests flip, for a dense index
    whose chip edges run from ``flat_a`` to ``flat_b`` (absolute degrees,
    the index's ``aux``): on ``n_edges`` seeded chip edges, the start
    vertex (its latitude equals the edge's), the midpoint, and the
    midpoint a hair either side; then the same on the edges of the H3
    cells those midpoints fall in (cell vertices, edge midpoints, and a
    hair either side of the cell boundary).  Returns ([M, 2] points,
    [M] offset of each from its edge in degrees, 0 on the edge)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(flat_a), min(n_edges, len(flat_a)), replace=False)
    a, b = flat_a[pick], flat_b[pick]
    pts, off = _on_and_beside(a, b)
    cells = np.unique(grid.point_to_cell(0.5 * (a + b), res))
    verts, counts = grid.cell_boundary(cells)             # [C, K, 2]
    k = np.arange(verts.shape[1])[None, :]
    valid = k < counts[:, None]
    nxt = np.where(k + 1 < counts[:, None], k + 1, 0)
    v1 = np.take_along_axis(verts, nxt[..., None].repeat(2, -1), axis=1)
    hex_pts, hex_off = _on_and_beside(verts[valid], v1[valid])
    return np.concatenate(pts + hex_pts), np.concatenate(off + hex_off)


def widen_zone_slots(tables: dict, step: int = 15) -> dict:
    """A dense index (the dict ``dense_index_from_arrays`` takes) whose
    zone slots reach past 32: group g's slots move up by ``step * (g %
    3)`` in the pool and in a wider gzones, so every group keeps its
    zones in the same order and the join's answer does not change.  With
    step 15 and Z=4 the slots span 0-33, across the join kernel's 32-slot
    words.  The recheck tables (``aux``) are left out."""
    pool = np.array(tables["pool"], np.float32)
    gzones = np.asarray(tables["gzones"], np.int32)
    G, Z = gzones.shape
    shift = step * (np.arange(G) % 3)
    zs = pool[..., 4]
    pool[..., 4] = np.where(zs >= 0, zs + shift[:, None], zs)
    wide = np.full((G, Z + 2 * step), -1, np.int32)
    wide[np.arange(G)[:, None], np.arange(Z)[None, :] + shift[:, None]] = \
        gzones
    out = {k: v for k, v in tables.items() if k != "aux"}
    out.update(pool=pool, gzones=wide)
    return out


#: a res-5 H3 pentagon's centre (lon, lat), and a CONUS point
PENTAGON_RES5 = (58.1577, 10.4473)
CONUS_POINT = (-98.0, 39.0)


def _regular(center, radius: float, k: int, phase: float) -> np.ndarray:
    """A convex CCW k-gon, its vertices rounded to 2^-20 degrees."""
    th = phase + 2 * np.pi * np.arange(k) / k
    v = np.asarray(center)[None] + radius * np.stack(
        [np.cos(th), np.sin(th)], -1)
    return np.round(v * 2.0 ** 20) / 2.0 ** 20


def _zigzag(p0: np.ndarray, p1: np.ndarray, teeth: int,
            depth: float) -> np.ndarray:
    """A concave ring whose 2 * teeth vertices zigzag across the line
    p0 -> p1, closed by two points well on one side: a convex clip's
    plane along that line meets it some 2 * teeth times."""
    d = p1 - p0
    nrm = np.array([-d[1], d[0]]) / np.hypot(*d)
    s = np.linspace(0.05, 0.95, 2 * teeth)
    side = np.tile([depth, -depth], teeth)
    pts = p0 + s[:, None] * d + side[:, None] * nrm
    back = [p0 + 0.95 * d - 4 * depth * nrm, p0 + 0.05 * d - 4 * depth * nrm]
    return np.vstack([pts, back])


def tess_adversarial(grid: IndexSystem, res: int = 5, n_random: int = 24,
                     seed: int = 0) -> dict:
    """Inputs of the tessellation kernels (``ops/tess_classify.py``,
    ``ops/tess_clip.py``) where their tests tie or overflow, as numpy
    flat CSR.  Cells: the H3 cells at ``res`` around a CONUS point and
    around a pentagon (rings 0-1), and convex cells of 7-10 vertices.
    Geometries: each H3 cell's own boundary (edges along cell sides);
    triangles through a cell's vertices and its centre; rectangles with
    horizontal edges at a cell vertex's latitude and a centre's; a ring
    around the pentagon and one with the pentagon as its hole; stars
    through the large cells' vertices; concave zigzags across cell sides
    (beyond the clip's convex capacity, in shared and in global memory);
    and ``n_random`` seeded random star polygons.  Pairs: every geometry
    with every cell whose bbox its own bbox meets (grown by 0.05
    degrees); clip tasks: each pair's rings.

    Returns edges [E, 4], edge_off, pair_geo, pair_cell (pairs grouped by
    geometry), cell_verts [U, 10, 2] (rows past a cell's count repeat its
    last vertex), cell_counts (int32), centers [U, 2], ring_xy [V, 2],
    ring_off, task_ring, task_cell and rings (per geometry, its open
    rings, shell first)."""
    rng = np.random.default_rng(seed)
    kmax = 10
    ids = []
    for lon, lat in (CONUS_POINT, PENTAGON_RES5):
        c = grid.point_to_cell(np.array([[lon, lat]]), res)
        ring = grid.k_ring(c, 1)[0]
        ids.append(ring[ring >= 0])
    ids = np.unique(np.concatenate(ids))
    hv, hc = grid.cell_boundary(ids)
    hcen = grid.cell_center(ids)
    cells = [(hv[i, :hc[i]], hcen[i]) for i in range(len(ids))]
    base = np.asarray(CONUS_POINT) + np.array([1.5, 0.5])
    for j, k in enumerate(range(7, kmax + 1)):
        ctr = base + np.array([0.25 * j, 0.0])
        cells.append((_regular(ctr, 0.1, k, 0.3 * j), ctr))
    geoms = []                       # per geometry: list of open rings
    for v, ctr in cells:
        n = len(v)
        geoms.append([v])
        geoms.append([np.array([v[0], v[n // 3], v[2 * n // 3]])])
        geoms.append([np.array([ctr, v[1], v[min(3, n - 1)]])])
        lo, hi = ctr[0] - 0.3, ctr[0] + 0.3
        for ya, yb in ((v[0, 1], ctr[1]), (v[n // 2, 1], v[1, 1])):
            y0, y1 = min(ya, yb), max(ya, yb)
            if y1 > y0:
                geoms.append([np.array([[lo, y0], [hi, y0], [hi, y1],
                                        [lo, y1]])])
        if n >= 7:
            star = np.array([v[i] if i % 2 == 0 else
                             ctr + 0.4 * (v[i] - ctr) for i in range(n)])
            geoms.append([star])
        for teeth, k in ((24, 0), (40, n // 2)):
            p0, p1 = v[k], v[(k + 1) % n]
            geoms.append([_zigzag(p0, p1, teeth,
                                  0.02 * np.hypot(*(p1 - p0)))])
    pi = int(np.argmin(np.hypot(*(hcen - np.asarray(PENTAGON_RES5)).T)))
    pv, pc = hv[pi, :hc[pi]], hcen[pi]
    geoms.append([pc + 1.5 * (pv - pc)])
    geoms.append([pc + 2.0 * (pv - pc), pv[::-1]])
    for _ in range(n_random):
        v, ctr = cells[rng.integers(len(cells))]
        k = int(rng.integers(5, 30))
        th = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(0.02, 0.15, k)
        geoms.append([np.round((ctr + rng.uniform(-0.1, 0.1, 2) + rad[:, None]
                                * np.stack([np.cos(th), np.sin(th)], -1))
                               * 2.0 ** 16) / 2.0 ** 16])
    # cell table
    U = len(cells)
    cell_verts = np.zeros((U, kmax, 2))
    cell_counts = np.zeros(U, np.int32)
    centers = np.zeros((U, 2))
    for u, (v, ctr) in enumerate(cells):
        cell_verts[u, :len(v)] = v
        cell_verts[u, len(v):] = v[-1]
        cell_counts[u] = len(v)
        centers[u] = ctr
    # edges and rings, CSR
    edges_by, pool, ring_of = [], [], []
    for rings in geoms:
        edges_by.append(np.concatenate([
            np.concatenate([r, np.roll(r, -1, 0)], 1) for r in rings]))
        ring_of.append(list(range(len(pool), len(pool) + len(rings))))
        pool.extend(rings)
    edge_off = np.concatenate([[0], np.cumsum([len(e) for e in edges_by])])
    ring_off = np.concatenate([[0], np.cumsum([len(r) for r in pool])])
    # pairs by bbox
    gb = np.array([[e[:, [0, 2]].min(), e[:, [1, 3]].min(),
                    e[:, [0, 2]].max(), e[:, [1, 3]].max()]
                   for e in edges_by])
    valid = np.arange(kmax)[None] < cell_counts[:, None]
    cb = np.stack([np.where(valid, cell_verts[..., 0], np.inf).min(1),
                   np.where(valid, cell_verts[..., 1], np.inf).min(1),
                   np.where(valid, cell_verts[..., 0], -np.inf).max(1),
                   np.where(valid, cell_verts[..., 1], -np.inf).max(1)], -1)
    near = (gb[:, None, 0] - 0.05 <= cb[None, :, 2]) & \
        (cb[None, :, 0] <= gb[:, None, 2] + 0.05) & \
        (gb[:, None, 1] - 0.05 <= cb[None, :, 3]) & \
        (cb[None, :, 1] <= gb[:, None, 3] + 0.05)
    pair_geo, pair_cell = np.nonzero(near)
    task_ring = np.concatenate([ring_of[g] for g in pair_geo])
    task_cell = np.repeat(pair_cell, [len(ring_of[g]) for g in pair_geo])
    return {"edges": np.concatenate(edges_by),
            "edge_off": edge_off.astype(np.int64),
            "pair_geo": pair_geo.astype(np.int64),
            "pair_cell": pair_cell.astype(np.int64),
            "cell_verts": cell_verts, "cell_counts": cell_counts,
            "centers": centers, "ring_xy": np.concatenate(pool),
            "ring_off": ring_off.astype(np.int64),
            "task_ring": task_ring.astype(np.int64),
            "task_cell": task_cell.astype(np.int64), "rings": geoms}


#: (G, E) shapes of :func:`measures_adversarial`: G a multiple of no tile,
#: E one slot, odd, the main path's 8 and 32, one past a warp's 32, and
#: thousands; the two with G >= 32768 reach the edge-measures kernel's
#: staged tiles by its own plan, the rest a warp a geometry
MEASURES_ADV_SHAPES = ((257, 1), (131, 3), (1031, 8), (32771, 8),
                       (333, 33), (32797, 32), (17, 1024), (5, 4096))
#: the views :func:`measures_view` takes of each block: as built, ``x[1:]``
#: of one more row, ``x[:, 1:]`` of one more slot (not contiguous: the
#: wrapper copies it), and contiguous views whose data pointer is offset
#: by one slot or by one coordinate (the mask by one byte in both)
MEASURES_ADV_VIEWS = ("whole", "rows", "cols", "slot", "coord")


def measures_adversarial(dtype: str = "float64", seed: int = 1729):
    """Edge blocks where the edge-measures kernel (``ops/edge_measures.py``)
    and its plain version meet their corner cases, as numpy arrays of
    ``dtype`` ("float64" or "float32"): a list of (label, A, B [G, E, 2],
    M [G, E] bool), one a :data:`MEASURES_ADV_SHAPES` shape.  Row r is of
    kind r % 12: seeded reals under a mask of density 0.05, 0.4 or 0.9
    (non-prefix); small integers (exact zeros, shared and collinear
    edges); every slot masked; a NaN in a valid slot; a NaN in a masked
    slot; +inf in a valid slot and -inf in a masked one; zero-length
    edges; collinear edges on one line; coordinates near 1e300 (1e38 in
    float32); near 1e-300 (1e-38); x near 1e300 and y near 1e-300; and a
    closed regular polygon in its first slots with -0.0 among its
    coordinates and the rest masked."""
    dt = np.dtype(dtype)
    big, tiny = (1e300, 1e-300) if dt == np.float64 else (1e38, 1e-38)
    rng = np.random.default_rng(seed)
    cases = []
    for G, E in MEASURES_ADV_SHAPES:
        A = rng.uniform(-5, 5, (G, E, 2))
        B = rng.uniform(-5, 5, (G, E, 2))
        M = rng.random((G, E)) < rng.choice([0.05, 0.4, 0.9], G)[:, None]
        slot = rng.integers(0, E, G)
        for r in range(G):
            kind, e = r % 12, slot[r]
            if kind == 1:
                A[r] = rng.integers(-6, 7, (E, 2))
                B[r] = np.where(rng.random((E, 1)) < 0.3, A[r],
                                rng.integers(-6, 7, (E, 2)))
                if E > 1:
                    B[r, 0], A[r, 1] = A[r, 1], B[r, 0]
            elif kind == 2:
                M[r] = False
            elif kind == 3:
                A[r, e, 0], M[r, e] = np.nan, True
            elif kind == 4:
                B[r, e, 1], M[r, e] = np.nan, False
            elif kind == 5:
                A[r, e, 1], M[r, e] = np.inf, True
                f = (e + 1) % E
                if f != e:
                    B[r, f, 0], M[r, f] = -np.inf, False
            elif kind == 6:
                B[r], M[r] = A[r], True
            elif kind == 7:
                t = rng.uniform(-5, 5, (E, 2))
                A[r] = np.stack([t[:, 0], 2 * t[:, 0] + 1], -1)
                B[r] = np.stack([t[:, 1], 2 * t[:, 1] + 1], -1)
                M[r] = True
            elif kind == 8:
                A[r] *= big / 5
                B[r] *= big / 5
            elif kind == 9:
                A[r] *= tiny * 4
                B[r] *= tiny * 4
            elif kind == 10:
                A[r, :, 0] *= big / 5
                B[r, :, 0] *= big / 5
                A[r, :, 1] *= tiny
                B[r, :, 1] *= tiny
            elif kind == 11:
                k = min(E, int(rng.integers(3, 9)))
                th = 2 * np.pi * np.arange(k) / k
                ring = np.stack([np.cos(th), np.sin(th)], -1) * 3
                ring[np.abs(ring) < 1e-12] = -0.0
                A[r, :k], B[r, :k] = ring, np.roll(ring, -1, 0)
                M[r] = np.arange(E) < k
        cases.append((f"{G}x{E}", A.astype(dt), B.astype(dt), M))
    return cases


def measures_view(x: np.ndarray, view: str, dtype, device):
    """``x`` (an A or B block [G, E, 2], or a mask [G, E]) as a torch
    tensor of ``dtype`` (the mask stays bool) on ``device``, through the
    view ``view`` of :data:`MEASURES_ADV_VIEWS`."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(x))
    if t.dtype != torch.bool:
        t = t.to(dtype)
    if view == "whole":
        return t.to(device)
    if view == "rows":
        return torch.cat([t[:1], t]).to(device)[1:]
    if view == "cols":
        return torch.cat([t[:, :1], t], 1).to(device)[:, 1:]
    if view not in ("slot", "coord"):
        raise ValueError(f"unknown view {view!r}")
    shift = 2 if view == "slot" and t.dtype != torch.bool else 1
    flat = torch.zeros(t.numel() + shift, dtype=t.dtype, device=device)
    flat[shift:] = t.reshape(-1).to(device)
    return flat[shift:].view(t.shape)
