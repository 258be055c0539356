"""Cell index codec and grid topology for the aperture-7 icosahedral DGGS.

Bit layout follows the published H3 spec (64-bit: mode 1, resolution,
7-bit base cell, fifteen 3-bit digits); reference reaches the same surface
through JNI (core/index/H3IndexSystem.scala:24).  All functions are
vectorized numpy over int64 cell arrays — no scalar cell loops anywhere.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import hexmath as hm
from .constants import MAX_H3_RES, NUM_BASE_CELLS
from .fold import fold_geometry
from .tables import _down_rot, tables

MODE_CELL = 1
_RES_SHIFT = 52
_BASE_SHIFT = 45
_MODE_SHIFT = 59

# ---------------------------------------------- pentagon label interop
# The internal wedge machinery (tables.py) deletes the pentagon subtree
# geometrically opposite the home face interior — the I axis (digit 4)
# for the canonical (2,0,0) anchors.  The published H3 spec instead
# deletes the K axis (digit 1) and re-expresses the IK subtree via a
# leading-digit-5 60° rotation.  Both label the SAME tiling; the exact
# map between them (derived from the wedge layout, see
# tests/test_h3_canonical.py) is a whole-string ±60° digit rotation
# applied when the leading digit falls in the affected wedges:
#   internal -> published: leading in {1, 5} -> rotate ccw
#   published -> internal: leading in {5, 4} -> rotate cw
_CCW8 = np.append(hm.ROT60_CCW_DIGIT, 7)   # 7 (pad) stays 7
_CW8 = np.append(hm.ROT60_CW_DIGIT, 7)


def _leading_digit(digits: np.ndarray) -> np.ndarray:
    """First nonzero real digit per row (0 if none; 7-pads ignored)."""
    lead = np.zeros(len(digits), np.int64)
    for c in range(digits.shape[1]):
        col = digits[:, c]
        lead = np.where((lead == 0) & (col != 0) & (col < 7), col, lead)
    return lead


def _pent_to_external(base: np.ndarray, digits: np.ndarray) -> np.ndarray:
    """Internal wedge labels -> published H3 digit labels."""
    t = tables()
    lead = _leading_digit(digits)
    sel = t.is_pentagon[base] & ((lead == 1) | (lead == 5))
    if np.any(sel):
        digits = digits.copy()
        digits[sel] = _CCW8[digits[sel]]
    return digits


def _pent_to_internal(base: np.ndarray, digits: np.ndarray) -> np.ndarray:
    """Published H3 digit labels -> internal wedge labels."""
    t = tables()
    lead = _leading_digit(digits)
    sel = t.is_pentagon[base] & ((lead == 5) | (lead == 4))
    if np.any(sel):
        digits = digits.copy()
        digits[sel] = _CW8[digits[sel]]
    return digits


def _digit_shift(r: int) -> int:
    """Bit offset of the resolution-r digit (r in 1..15)."""
    return 3 * (MAX_H3_RES - r)


def pack(base: np.ndarray, digits: np.ndarray, res: int) -> np.ndarray:
    """(base [N], digits [N, res]) -> cell ids [N] int64."""
    h = (np.int64(MODE_CELL) << _MODE_SHIFT) | \
        (np.int64(res) << _RES_SHIFT) | \
        (base.astype(np.int64) << _BASE_SHIFT)
    # unused digits are 7 (per spec)
    fill = np.int64(0)
    for r in range(res + 1, MAX_H3_RES + 1):
        fill |= np.int64(7) << _digit_shift(r)
    h = h | fill
    for r in range(1, res + 1):
        h = h | (digits[:, r - 1].astype(np.int64) << _digit_shift(r))
    return h


def unpack(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cells [N] -> (base [N], digits [N, 15] (7 = unused), res [N])."""
    cells = np.asarray(cells, dtype=np.int64)
    res = (cells >> _RES_SHIFT) & 0xF
    base = (cells >> _BASE_SHIFT) & 0x7F
    digits = np.stack([(cells >> _digit_shift(r)) & 0x7
                       for r in range(1, MAX_H3_RES + 1)], axis=-1)
    return base, digits, res


def get_resolution(cells: np.ndarray) -> np.ndarray:
    return (np.asarray(cells, np.int64) >> _RES_SHIFT) & 0xF


def is_pentagon_cell(cells: np.ndarray) -> np.ndarray:
    """Pentagon = pentagon base cell with all-zero digits."""
    t = tables()
    base, digits, res = unpack(cells)
    allzero = np.ones(len(base), bool)
    for r in range(MAX_H3_RES):
        allzero &= (digits[:, r] == 0) | (digits[:, r] == 7)
    return t.is_pentagon[base] & allzero


def is_valid_cell(cells: np.ndarray) -> np.ndarray:
    t = tables()
    cells = np.asarray(cells, np.int64)
    base, digits, res = unpack(cells)
    mode = (cells >> _MODE_SHIFT) & 0xF
    ok = (mode == MODE_CELL) & (cells >= 0) & (base < NUM_BASE_CELLS) & \
        (res <= MAX_H3_RES)
    lead = np.zeros(len(base), np.int64)
    for r in range(1, MAX_H3_RES + 1):
        d = digits[:, r - 1]
        in_range = r <= res
        ok &= np.where(in_range, d < 7, d == 7)
        lead = np.where(in_range & (lead == 0) & (d != 0) & (d < 7), d,
                        lead)
    # pentagon deleted subsequence: the K axis in published labels
    ok &= ~(t.is_pentagon[base] & (lead == 1))
    return ok


# ------------------------------------------------------------------ encode

def latlng_to_cell(latlng: np.ndarray, res: int) -> np.ndarray:
    """[N, 2] (lat, lng) radians -> [N] cell ids (reference:
    H3IndexSystem.pointToIndex:168 via h3.geoToH3)."""
    t = tables()
    latlng = np.atleast_2d(np.asarray(latlng, np.float64))
    n = len(latlng)
    # vector-form projection: same frame/values as geo_to_hex2d (polar)
    # to 1e-13, without the arccos/atan2 cost (tests/test_projection.py)
    f, hex2d = hm.project_lattice(latlng, res)
    cur = hm.hex2d_to_ijk(hex2d)
    digits = np.zeros((n, max(res, 1)), np.int64)
    for r in range(res, 0, -1):
        up = hm.up_ap7(cur, rot=_down_rot(r))
        center = hm.down_ap7(up, rot=_down_rot(r))
        digits[:, r - 1] = hm.unit_ijk_to_digit(hm.ijk_sub(cur, center))
        cur = up
    assert np.all((cur >= 0) & (cur <= 2)), "res-0 aggregation off-face"
    base = t.fijk_base[f, cur[:, 0], cur[:, 1], cur[:, 2]]
    rot = t.fijk_rot[f, cur[:, 0], cur[:, 1], cur[:, 2]]
    if np.any(rot < 0):
        bad = np.nonzero(rot < 0)[0][:5]
        raise AssertionError(
            f"uncalibrated face entries hit: f={f[bad]}, ijk={cur[bad]}")
    digits = t.rot_digit[rot[:, None], digits] if res else digits
    # pentagon seam re-expression (deleted subsequence)
    lead = _leading_digit(digits) if res else np.zeros(n, np.int64)
    seam_hit = t.is_pentagon[base] & (lead == t.pent_seam[base]) & \
        (lead != 0)
    if np.any(seam_hit):
        extra = t.fijk_pent_extra[f, cur[:, 0], cur[:, 1], cur[:, 2]]
        digits[seam_hit] = t.rot_digit[extra[seam_hit][:, None],
                                       digits[seam_hit]]
        # extra is a whole-string rotation, so it also rotates the lead
        lead[seam_hit] = t.rot_digit[extra[seam_hit], lead[seam_hit]]
    # internal -> published pentagon labels (lead already in hand)
    sel = t.is_pentagon[base] & ((lead == 1) | (lead == 5))
    if np.any(sel):
        digits[sel] = _CCW8[digits[sel]]
    return pack(base, digits[:, :res] if res else digits[:, :0], res)


# ------------------------------------------------------------------ decode

def _walk(base: np.ndarray, digits: np.ndarray, res: int) -> np.ndarray:
    """Home-frame lattice position of each cell at its resolution."""
    t = tables()
    ijk = t.home_ijk[base]
    for r in range(1, res + 1):
        ijk = hm.down_ap7(ijk, rot=_down_rot(r))
        ijk = hm.neighbor(ijk, digits[:, r - 1])
    return ijk


def cell_to_latlng(cells: np.ndarray) -> np.ndarray:
    """[N] -> [N, 2] (lat, lng) radians cell centers (reference:
    h3.h3ToGeo)."""
    t = tables()
    cells = np.asarray(cells, np.int64).reshape(-1)
    base, digits, res = unpack(cells)
    digits = _pent_to_internal(base, digits)
    out = np.zeros((len(cells), 2))
    for rv in np.unique(res):
        sel = res == rv
        d = digits[sel][:, :rv]
        ijk = _walk(base[sel], d, int(rv))
        _, geo = t.develop(base[sel], d, ijk, int(rv))
        out[sel] = geo
    return out


def _cell_lattice_context(cells: np.ndarray):
    """(tables, base, digits[,res], res, ijk) for a same-res batch."""
    t = tables()
    base, digits, res = unpack(cells)
    digits = _pent_to_internal(base, digits)
    rv = int(res[0])
    assert np.all(res == rv), "mixed resolutions"
    digits = digits[:, :rv]
    ijk = _walk(base, digits, rv)
    return t, base, digits, rv, ijk


def neighbor_positions(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Geo centers of the 6 lattice neighbors of each cell.

    Returns (geo [N, 6, 2], valid [N, 6]); the pentagon seam direction is
    invalid (pentagons have 5 neighbors)."""
    t, base, digits, rv, ijk = _cell_lattice_context(cells)
    n = len(cells)
    is_pent_cell = is_pentagon_cell(cells)
    geos = np.zeros((n, 6, 2))
    valid = np.ones((n, 6), bool)
    for d in range(1, 7):
        nijk = hm.neighbor(ijk, d)
        # the neighbor position shares the cell's wedge program: pass the
        # cell's own digits for program selection
        _, geo = t.develop(base, digits, nijk, rv)
        geos[:, d - 1] = geo
        valid[:, d - 1] = ~(is_pent_cell & (d == t.pent_seam[base]))
    return geos, valid


def neighbors(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N] -> ([N, 6] neighbor ids (-1 pad), [N, 6] valid)."""
    geos, valid = neighbor_positions(cells)
    rv = int(get_resolution(cells[:1])[0])
    flat = latlng_to_cell(geos.reshape(-1, 2), rv).reshape(-1, 6)
    return np.where(valid, flat, -1), valid


def k_ring(cells: np.ndarray, k: int) -> np.ndarray:
    """[N] -> [N, 3k²+3k+1] filled disk ids (-1 pad).  BFS over exact
    lattice neighbors, so pentagon distortion is handled by construction
    (reference: H3IndexSystem.kRing:182)."""
    cells = np.asarray(cells, np.int64).reshape(-1)
    n = len(cells)
    m = 3 * k * k + 3 * k + 1
    disk = np.full((n, m), -1, np.int64)
    disk[:, 0] = cells
    count = np.ones(n, np.int64)
    frontier = cells[:, None]
    for _ in range(k):
        fvalid = frontier >= 0
        nb, nbvalid = neighbors(
            np.where(fvalid, frontier, cells[:, None]).reshape(-1))
        nb = np.where(nbvalid, nb, -1).reshape(n, -1)
        nb[~np.repeat(fvalid, 6, axis=1)] = -1
        # per-row dedupe against disk
        merged = np.concatenate([disk, nb], axis=1)
        order = np.argsort(merged, axis=1, kind="stable")
        srt = np.take_along_axis(merged, order, axis=1)
        dup = np.concatenate(
            [np.zeros((n, 1), bool), srt[:, 1:] == srt[:, :-1]], axis=1)
        keep = (srt >= 0) & ~dup
        # new frontier = kept cells not already in disk
        was_new = order >= disk.shape[1]
        newmask = keep & was_new
        maxnew = int(newmask.sum(axis=1).max(initial=0))
        frontier = np.full((n, max(maxnew, 1)), -1, np.int64)
        for i in range(n):                       # ragged pack (small)
            vals = srt[i][newmask[i]]
            frontier[i, :len(vals)] = vals
            disk[i, count[i]:count[i] + len(vals)] = vals
            count[i] += len(vals)
    return disk


def k_loop(cells: np.ndarray, k: int) -> np.ndarray:
    """Hollow ring at exactly grid distance k (reference: kLoop:196)."""
    if k == 0:
        return np.asarray(cells, np.int64).reshape(-1, 1)
    disk_k = k_ring(cells, k)
    disk_i = k_ring(cells, k - 1)
    n = len(disk_k)
    m = 6 * k
    out = np.full((n, m), -1, np.int64)
    for i in range(n):
        inner = set(disk_i[i][disk_i[i] >= 0].tolist())
        vals = [c for c in disk_k[i] if c >= 0 and c not in inner]
        out[i, :len(vals)] = vals
    return out


def cell_boundary(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N] -> ([N, 6, 2] boundary vertices (lat, lng) CCW, [N] counts).

    Hexagon vertices are the planar hex corners developed through the
    same projection as quantization (the reference H3 definition,
    H3IndexSystem.indexToGeometry:103) — so for on-face cells the
    boundary polygon agrees with point_to_cell to float64 precision,
    which the PIP join's exactness contract relies on.  Pentagons use
    spherical circumcenters of adjacent neighbor-center triples."""
    cells = np.asarray(cells, np.int64).reshape(-1)
    n = len(cells)
    t, base, digits, rv, ijk = _cell_lattice_context(cells)
    center_hex = hm.ijk_to_hex2d(ijk).astype(np.float64)
    # unit-hexagon corners: neighbors sit at k*60°, corners between them
    ang = np.radians(30.0 + 60.0 * np.arange(6))
    corner_off = np.stack([np.cos(ang), np.sin(ang)], -1) / np.sqrt(3.0)
    verts = np.zeros((n, 6, 2))
    for i in range(6):
        _, geo = t.develop_hex2d(base, digits,
                                 center_hex + corner_off[i], rv)
        verts[:, i] = geo
    counts = np.full(n, 6, np.int64)

    pent = np.nonzero(is_pentagon_cell(cells))[0]
    if len(pent):
        pcells = cells[pent]
        center = cell_to_latlng(pcells)
        geos, valid = neighbor_positions(pcells)
        cxyz = hm.geo_to_xyz(center)
        nxyz = hm.geo_to_xyz(geos)
        az = hm.geo_azimuth(center[:, None, :], geos)
        az = np.where(valid, -az, np.inf)
        order = np.argsort(az, axis=1)
        cnts = valid.sum(axis=1)
        nxyz_o = np.take_along_axis(nxyz, order[:, :, None], axis=1)
        m = len(pent)
        for i in range(6):
            a = nxyz_o[:, i]
            j = np.where(i + 1 < cnts, i + 1, 0)
            b = nxyz_o[np.arange(m), j]
            v = np.cross(a - cxyz, b - cxyz)
            nrm = np.linalg.norm(v, axis=-1, keepdims=True)
            v = v / np.where(nrm == 0, 1.0, nrm)
            flip = np.sum(v * cxyz, axis=-1) < 0
            v = np.where(flip[:, None], -v, v)
            verts[pent, i] = hm.xyz_to_geo(v)
        counts[pent] = cnts
    return verts, counts


# ---------------------------------------------------------------- family

def cell_to_parent(cells: np.ndarray, parent_res: int) -> np.ndarray:
    cells = np.asarray(cells, np.int64)
    res = get_resolution(cells)
    assert np.all(res >= parent_res)
    h = cells & ~(np.int64(0xF) << _RES_SHIFT)
    h = h | (np.int64(parent_res) << _RES_SHIFT)
    for r in range(parent_res + 1, MAX_H3_RES + 1):
        h = h | (np.int64(7) << _digit_shift(r))
    return h


def cell_to_children(cells: np.ndarray, child_res: int) -> list:
    """[N] -> list of arrays (ragged: pentagons have 6 children/level)."""
    out = []
    for c in np.atleast_1d(np.asarray(cells, np.int64)):
        res = int(get_resolution(np.array([c]))[0])
        assert child_res >= res
        cur = np.array([c], np.int64)
        for r in range(res + 1, child_res + 1):
            pent = is_pentagon_cell(cur)
            cur = np.repeat(cur, 7)
            digit = np.tile(np.arange(7, dtype=np.int64), len(pent))
            h = cur & ~(np.int64(0xF) << _RES_SHIFT)
            h |= np.int64(r) << _RES_SHIFT
            h &= ~(np.int64(7) << _digit_shift(r))
            h |= digit << _digit_shift(r)
            # pentagon centers skip the K-axis child (published labels)
            drop = np.repeat(pent, 7) & (digit == 1)
            cur = h[~drop]
        out.append(cur)
    return out
