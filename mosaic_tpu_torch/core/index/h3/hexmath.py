"""Planar hex-lattice math for the aperture-7 icosahedral DGGS.

This implements the published H3 grid *specification* (reference dependency:
com.uber:h3 3.7.0 reached via JNI, databrickslabs/mosaic pom.xml:92-96) from its
mathematical definition — IJK cube coordinates on a triangular lattice,
aperture-7 resolution steps with alternating Class II/III orientation, and
gnomonic face projection.  Everything here is vectorized numpy over the
last axis holding (i, j, k) or (x, y); no scalar cell loops.

Conventions (H3 spec):
  * CoordIJK: non-negative cube coords with at least one zero component.
  * Digits 0-6: CENTER, K, J, JK, I, IK, IJ.
  * Class II resolutions are even (i-axis aligned with the face axes);
    Class III odd (rotated asin(sqrt(3/28)) ccw).
"""

from __future__ import annotations

import numpy as np

from .constants import (FACE_AXES_AZ_I, FACE_CENTER_GEO, M_AP7_ROT_RADS,
                        M_SIN60, M_SQRT7, RES0_U_GNOMONIC, face_center_xyz)

# digit -> unit ijk vector ([7, 3]); order: CENTER K J JK I IK IJ
UNIT_VECS = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0]], dtype=np.int64)

# digit rotation tables (CENTER fixed; axes permute under 60° rotations)
# ccw: K->IK, IK->I, I->IJ, IJ->J, J->JK, JK->K
ROT60_CCW_DIGIT = np.array([0, 5, 3, 1, 6, 4, 2], dtype=np.int64)
# cw: K->JK, JK->J, J->IJ, IJ->I, I->IK, IK->K
ROT60_CW_DIGIT = np.array([0, 3, 6, 2, 5, 1, 4], dtype=np.int64)


# ------------------------------------------------------------- ijk basics

def ijk_normalize(ijk: np.ndarray) -> np.ndarray:
    """Subtract min component so coords are >= 0 with a zero present."""
    return ijk - ijk.min(axis=-1, keepdims=True)


def ijk_to_axial(ijk: np.ndarray):
    """(i - k, j - k) axial coords."""
    return ijk[..., 0] - ijk[..., 2], ijk[..., 1] - ijk[..., 2]


def axial_to_ijk(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ijk = np.stack([a, b, np.zeros_like(a)], axis=-1)
    return ijk_normalize(ijk)


def ijk_to_hex2d(ijk: np.ndarray) -> np.ndarray:
    """Lattice coords -> planar (x, y); i-axis along +x, axes 120° apart."""
    a, b = ijk_to_axial(ijk)
    x = a - 0.5 * b
    y = b * M_SIN60
    return np.stack([x, y], axis=-1)


def hex2d_to_ijk(xy: np.ndarray) -> np.ndarray:
    """Nearest lattice point (hexagon containment) via cube rounding.

    Cube rounding requires the 60°-basis axial frame (q, r) =
    (a - b, b); rounding the 120°-basis (a, b, -a-b) triple directly is
    only correct at lattice points (a bug this replaced)."""
    x = np.asarray(xy[..., 0], np.float64)
    y = np.asarray(xy[..., 1], np.float64)
    r = y / M_SIN60
    q = x - 0.5 * r
    s = -q - r
    rq, rr, rs = np.round(q), np.round(r), np.round(s)
    dq, dr, ds = np.abs(rq - q), np.abs(rr - r), np.abs(rs - s)
    fix_q = (dq > dr) & (dq > ds)
    fix_r = ~fix_q & (dr > ds)
    rq = np.where(fix_q, -rr - rs, rq)
    rr = np.where(fix_r, -rq - rs, rr)
    a = (rq + rr).astype(np.int64)
    b = rr.astype(np.int64)
    return axial_to_ijk(a, b)


def ijk_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ijk_normalize(a - b)


def ijk_rotate60(ijk: np.ndarray, ccw: bool) -> np.ndarray:
    """Rotate lattice vector by 60° about the origin."""
    i, j, k = ijk[..., 0], ijk[..., 1], ijk[..., 2]
    if ccw:
        # i->(1,1,0) j->(0,1,1) k->(1,0,1)
        out = np.stack([i + k, i + j, j + k], axis=-1)
    else:
        # i->(1,0,1) j->(1,1,0) k->(0,1,1)
        out = np.stack([i + j, j + k, i + k], axis=-1)
    return ijk_normalize(out)


def unit_ijk_to_digit(ijk: np.ndarray) -> np.ndarray:
    """Inverse of UNIT_VECS ([..., 3] -> [...] digit; 7 = invalid)."""
    n = ijk_normalize(ijk)
    digit = np.full(n.shape[:-1], 7, dtype=np.int64)
    for d in range(7):
        digit = np.where(np.all(n == UNIT_VECS[d], axis=-1), d, digit)
    return digit


# ---------------------------------------------------- aperture-7 up / down

def up_ap7(ijk: np.ndarray, rot: bool) -> np.ndarray:
    """Parent cell one (coarser) aperture-7 step up.

    The two variants differ by the ccw/cw 19°-ish rotation between
    successive resolutions: ``rot=False`` is the plain variant (used when
    stepping up FROM a Class III resolution), ``rot=True`` the rotated one
    (stepping up from Class II)."""
    a, b = ijk_to_axial(ijk)
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if rot:
        ni = np.round((2 * a + b) / 7.0)
        nj = np.round((3 * b - a) / 7.0)
    else:
        ni = np.round((3 * a - b) / 7.0)
        nj = np.round((a + 2 * b) / 7.0)
    return axial_to_ijk(ni.astype(np.int64), nj.astype(np.int64))


_DOWN_PLAIN = np.array([[3, 0, 1], [1, 3, 0], [0, 1, 3]], dtype=np.int64)
_DOWN_ROT = np.array([[3, 1, 0], [0, 3, 1], [1, 0, 3]], dtype=np.int64)


def down_ap7(ijk: np.ndarray, rot: bool) -> np.ndarray:
    """Center child one (finer) aperture-7 step down; inverse pairing of
    up_ap7 (``rot=False`` when stepping down INTO a Class III res)."""
    m = _DOWN_ROT if rot else _DOWN_PLAIN
    out = (ijk[..., 0:1] * m[0] + ijk[..., 1:2] * m[1] +
           ijk[..., 2:3] * m[2])
    return ijk_normalize(out)


def neighbor(ijk: np.ndarray, digit) -> np.ndarray:
    return ijk_normalize(ijk + UNIT_VECS[digit])


# ------------------------------------------------------- sphere <-> face

def geo_to_xyz(latlng: np.ndarray) -> np.ndarray:
    """[..., 2] (lat, lng) radians -> [..., 3] unit vectors."""
    lat, lng = latlng[..., 0], latlng[..., 1]
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lng), cl * np.sin(lng), np.sin(lat)],
                    axis=-1)


def xyz_to_geo(xyz: np.ndarray) -> np.ndarray:
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return np.stack([np.arctan2(z, np.hypot(x, y)), np.arctan2(y, x)],
                    axis=-1)


def _pos_angle(a: np.ndarray) -> np.ndarray:
    return np.mod(a, 2 * np.pi)


def geo_azimuth(from_geo: np.ndarray, to_geo: np.ndarray) -> np.ndarray:
    """Initial great-circle azimuth (radians, ccw-positive from north...
    H3 convention: measured clockwise from north as standard bearing)."""
    lat1, lng1 = from_geo[..., 0], from_geo[..., 1]
    lat2, lng2 = to_geo[..., 0], to_geo[..., 1]
    dl = lng2 - lng1
    y = np.cos(lat2) * np.sin(dl)
    x = np.cos(lat1) * np.sin(lat2) - np.sin(lat1) * np.cos(lat2) * \
        np.cos(dl)
    return np.arctan2(y, x)


def azimuth_distance_to_geo(from_geo: np.ndarray, az: np.ndarray,
                            dist: np.ndarray) -> np.ndarray:
    """Point at angular distance ``dist`` along bearing ``az``."""
    lat1, lng1 = from_geo[..., 0], from_geo[..., 1]
    sd, cd = np.sin(dist), np.cos(dist)
    sl, cl = np.sin(lat1), np.cos(lat1)
    lat2 = np.arcsin(np.clip(sl * cd + cl * sd * np.cos(az), -1, 1))
    lng2 = lng1 + np.arctan2(np.sin(az) * sd * cl, cd - sl * np.sin(lat2))
    return np.stack([lat2, np.mod(lng2 + np.pi, 2 * np.pi) - np.pi],
                    axis=-1)


def nearest_face(xyz: np.ndarray) -> np.ndarray:
    """[..., 3] -> [...] face index with max dot product."""
    return np.argmax(xyz @ face_center_xyz().T, axis=-1)


def geo_to_hex2d(latlng: np.ndarray, res: int,
                 face: np.ndarray = None):
    """Project geo points onto icosahedron faces at a resolution's scale.

    Returns (face [...], hex2d [..., 2]).  The planar frame has the
    face center at the origin and the Class II i-axis along +x; Class III
    resolutions counter-rotate by asin(sqrt(3/28))."""
    latlng = np.asarray(latlng, np.float64)
    xyz = geo_to_xyz(latlng)
    if face is None:
        face = nearest_face(xyz)
    fcenter = FACE_CENTER_GEO[face]
    cosdot = np.clip(np.sum(xyz * face_center_xyz()[face], axis=-1), -1, 1)
    r = np.arccos(cosdot)
    az = _pos_angle(FACE_AXES_AZ_I[face] -
                    _pos_angle(geo_azimuth(fcenter, latlng)))
    if res % 2 == 1:
        az = _pos_angle(az - M_AP7_ROT_RADS)
    rr = np.tan(r) / RES0_U_GNOMONIC
    rr = rr * M_SQRT7 ** res
    hex2d = np.stack([rr * np.cos(az), rr * np.sin(az)], axis=-1)
    # exactly-at-center points: azimuth undefined, radius 0 handles it
    hex2d = np.where(np.isclose(r, 0.0)[..., None], 0.0, hex2d)
    return face, hex2d


def hex2d_to_geo(hex2d: np.ndarray, face: np.ndarray,
                 res: int) -> np.ndarray:
    """Inverse gnomonic: planar face coords -> (lat, lng) radians."""
    x, y = hex2d[..., 0], hex2d[..., 1]
    rr = np.hypot(x, y)
    az = np.arctan2(y, x)
    if res % 2 == 1:
        az = az + M_AP7_ROT_RADS
    az = _pos_angle(FACE_AXES_AZ_I[face] - _pos_angle(az))
    r = np.arctan(rr * RES0_U_GNOMONIC / M_SQRT7 ** res)
    out = azimuth_distance_to_geo(FACE_CENTER_GEO[face], az, r)
    return np.where(np.isclose(rr, 0.0)[..., None], FACE_CENTER_GEO[face],
                    out)


def is_class_iii(res: int) -> bool:
    return res % 2 == 1


# ------------------------------------------- stable vector-form projection

def face_tangent_bases() -> tuple:
    """Per-face orthonormal tangent bases (E1, E2), each [20, 3] f64.

    E1 points along the Class II i-axis (bearing FACE_AXES_AZ_I from the
    face center), E2 completes the frame so that the planar coords of a
    point P are exactly

        x = (P · E1) / (P · F),   y = (P · E2) / (P · F)

    in gnomonic units (times the resolution scale) — algebraically equal
    to the polar form in geo_to_hex2d but WELL-CONDITIONED: the polar
    route loses ~1e-7 relative near face centers through arccos (the
    arccos derivative blows up at 1), which is why the f32 device kernel
    needed a 3-meter uncertainty band before this form existed."""
    f = face_center_xyz()                              # [20, 3]
    lat = FACE_CENTER_GEO[:, 0]
    north = np.array([0.0, 0.0, 1.0])
    n_t = north[None, :] - np.sin(lat)[:, None] * f    # north tangent
    n_t /= np.linalg.norm(n_t, axis=-1, keepdims=True)
    e_t = np.cross(np.broadcast_to(north, f.shape), f)  # east tangent
    e_t /= np.linalg.norm(e_t, axis=-1, keepdims=True)
    az = FACE_AXES_AZ_I[:, None]
    e1 = np.cos(az) * n_t + np.sin(az) * e_t
    e2 = np.sin(az) * n_t - np.cos(az) * e_t
    return e1, e2


def scaled_bases(res: int) -> tuple:
    """(E1s, E2s) with the resolution scale and Class III rotation folded
    in, so hex2d = ((P·E1s)/(P·F), (P·E2s)/(P·F)) directly."""
    e1, e2 = face_tangent_bases()
    if is_class_iii(res):
        c, s = np.cos(M_AP7_ROT_RADS), np.sin(M_AP7_ROT_RADS)
        e1, e2 = c * e1 + s * e2, -s * e1 + c * e2
    scale = M_SQRT7 ** res / RES0_U_GNOMONIC
    return e1 * scale, e2 * scale


def project_lattice(latlng: np.ndarray, res: int, face: np.ndarray = None):
    """Stable equivalent of geo_to_hex2d: (face, hex2d) via tangent-basis
    dot products instead of the arccos/atan2 polar chain.  Same frame,
    same values (validated to ~1e-12 relative in tests)."""
    latlng = np.asarray(latlng, np.float64)
    xyz = geo_to_xyz(latlng)
    if face is None:
        face = nearest_face(xyz)
    e1, e2 = scaled_bases(res)
    f = face_center_xyz()[face]
    u = np.sum(xyz * f, axis=-1)
    x = np.sum(xyz * e1[face], axis=-1) / u
    y = np.sum(xyz * e2[face], axis=-1) / u
    return face, np.stack([x, y], axis=-1)
