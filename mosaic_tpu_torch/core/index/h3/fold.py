"""Icosahedron face-plane geometry: beyond-face detection and folding.

The reference's H3 core handles cells that spill over an icosahedron face
edge with hand-maintained lattice overage tables (the JNI'd C library's
``_adjustOverageClassII``).  Here the same thing is done geometrically: a
planar lattice position beyond the face triangle is *folded* about the 3D
line where the two tangent planes meet, landing exactly on the neighbor
face's plane.  One rotation matrix per (face, edge), generated numerically
from the icosahedron constants — no overage tables, and it vectorizes over
whole batches of cells.
"""

from __future__ import annotations

import numpy as np

from . import hexmath as hm
from .constants import FACE_CENTER_GEO, NUM_ICOSA_FACES, face_center_xyz


def _icosa_vertices():
    """[12, 3] unit vertices + [20, 3] per-face vertex ids (CCW order,
    vertex 0 at the face's i-axis azimuth)."""
    fc = face_center_xyz()
    # each face center, stepped toward its 3 corners: corner = point at
    # planar radius 2 (res-0 hex2d units) at angles 0, 120, 240 in the
    # face frame
    corners = []
    for face in range(NUM_ICOSA_FACES):
        ang = np.array([0.0, 2 * np.pi / 3, 4 * np.pi / 3])
        hex2d = 2.0 * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
        geo = hm.hex2d_to_geo(hex2d, np.full(3, face), 0)
        corners.append(hm.geo_to_xyz(geo))
    corners = np.stack(corners)                       # [20, 3, 3]
    flat = corners.reshape(-1, 3)
    # cluster identical vertices
    verts = []
    ids = np.full(len(flat), -1)
    for n in range(len(flat)):
        if ids[n] >= 0:
            continue
        d = np.linalg.norm(flat - flat[n], axis=-1)
        members = d < 1e-9
        ids[members] = len(verts)
        verts.append(flat[members].mean(axis=0))
    verts = np.stack(verts)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    assert len(verts) == 12, len(verts)
    return verts, ids.reshape(NUM_ICOSA_FACES, 3)


class FoldGeometry:
    """Precomputed per-face fold transforms and edge tests."""

    def __init__(self):
        self.vertices, self.face_verts = _icosa_vertices()
        self._corner_cache = {}
        fc = face_center_xyz()
        # face adjacency: faces sharing 2 vertices
        self.edge_neighbor = np.full((NUM_ICOSA_FACES, 3), -1, np.int64)
        # fold rotation (3x3) + fixed point for each (face, edge)
        self.fold_rot = np.zeros((NUM_ICOSA_FACES, 3, 3, 3))
        self.fold_p1 = np.zeros((NUM_ICOSA_FACES, 3, 3))
        for f in range(NUM_ICOSA_FACES):
            for e in range(3):
                v1 = self.face_verts[f, e]
                v2 = self.face_verts[f, (e + 1) % 3]
                for g in range(NUM_ICOSA_FACES):
                    if g != f and v1 in self.face_verts[g] and \
                            v2 in self.face_verts[g]:
                        self.edge_neighbor[f, e] = g
                        break
                g = self.edge_neighbor[f, e]
                assert g >= 0
                # tangent-plane points of the shared vertices (same from
                # both faces by icosahedral symmetry)
                a = self.vertices[v1]
                b = self.vertices[v2]
                p1 = a / (a @ fc[f])
                p2 = b / (b @ fc[f])
                assert abs(a @ fc[f] - a @ fc[g]) < 1e-12
                axis = p2 - p1
                axis = axis / np.linalg.norm(axis)
                # rotation about axis taking f's plane normal to g's
                nf, ng = fc[f], fc[g]
                # component of normals perpendicular to axis
                nf_p = nf - (nf @ axis) * axis
                ng_p = ng - (ng @ axis) * axis
                cosang = (nf_p @ ng_p) / (np.linalg.norm(nf_p) *
                                          np.linalg.norm(ng_p))
                ang = np.arccos(np.clip(cosang, -1, 1))
                sign = np.sign(np.cross(nf_p, ng_p) @ axis)
                self.fold_rot[f, e] = _axis_rotation(axis, sign * ang)
                self.fold_p1[f, e] = p1
                got = self.fold_rot[f, e] @ nf
                assert np.allclose(got, ng, atol=1e-12), (f, e)

    def _corner_table(self, res: int) -> np.ndarray:
        """[20, 3, 2] per-face corner hex2d positions at ``res``
        (cached: beyond_edge/corner_hex2d used to re-project the 3
        corners of every ROW's face per call — for 100k+ cells that
        recomputation was ~15% of county-scale tessellation)."""
        tbl = self._corner_cache.get(res)
        if tbl is None:
            faces = np.arange(NUM_ICOSA_FACES)
            corner_geo = hm.xyz_to_geo(
                self.vertices[self.face_verts[faces]])
            _, tbl = hm.geo_to_hex2d(
                corner_geo, res, np.repeat(faces[:, None], 3, axis=1))
            self._corner_cache[res] = tbl
        return tbl

    def corner_hex2d(self, face: np.ndarray, res: int) -> np.ndarray:
        """[N, 3, 2] face corner positions in the res's hex2d frame."""
        return self._corner_table(res)[face]

    def corner_edge(self, face: int, corner: int, ccw: bool) -> int:
        """Edge index crossed when orbiting ``corner`` ccw (or cw) out of
        the face's interior wedge."""
        c_hex = self.corner_hex2d(np.array([face]), 0)[0]
        cpos = c_hex[corner]
        theta_int = np.arctan2(-cpos[1], -cpos[0])
        # edges at this corner: (corner-1)%3 (to prev vertex) and corner
        best = None
        for e, other in ((corner, (corner + 1) % 3),
                         ((corner + 2) % 3, (corner + 2) % 3)):
            d = c_hex[other] - cpos
            ang = np.arctan2(d[1], d[0])
            delta = np.mod(ang - theta_int, 2 * np.pi)
            is_ccw = delta < np.pi
            if is_ccw == ccw:
                best = e
        assert best is not None
        return best

    def fold_across(self, face: np.ndarray, edge: np.ndarray,
                    hex2d: np.ndarray, res: int):
        """One prescribed fold of planar points across a given face edge.

        face [N], edge [N], hex2d [N, 2] -> (new_face [N], new_hex2d)."""
        fc = face_center_xyz()
        geo = hm.hex2d_to_geo(hex2d, face, res)
        xyz = hm.geo_to_xyz(geo)
        denom = np.sum(xyz * fc[face], axis=-1, keepdims=True)
        p3 = xyz / denom
        rot = self.fold_rot[face, edge]
        p1 = self.fold_p1[face, edge]
        p3f = np.einsum("nij,nj->ni", rot, p3 - p1) + p1
        g = self.edge_neighbor[face, edge]
        geo_f = hm.xyz_to_geo(
            p3f / np.linalg.norm(p3f, axis=-1, keepdims=True))
        _, hex_g = hm.geo_to_hex2d(geo_f, res, g)
        return g, hex_g

    def beyond_edge(self, face: np.ndarray, hex2d: np.ndarray,
                    res: int) -> np.ndarray:
        """[N] edge index (0-2) each planar point lies beyond, or -1.

        Points beyond a corner report one of the two edges; iterate."""
        scale = hm.M_SQRT7 ** res
        # face corner positions in this res's hex2d frame (cached table)
        c_hex = self._corner_table(res)[face]
        out = np.full(len(face), -1, np.int64)
        best = np.zeros(len(face))
        for e in range(3):
            c0 = c_hex[:, e]
            c1 = c_hex[:, (e + 1) % 3]
            ev = c1 - c0
            pv = hex2d - c0
            cross = ev[:, 0] * pv[:, 1] - ev[:, 1] * pv[:, 0]
            # interior is on the ccw side (cross > 0); normalize by edge
            # length so "most beyond" picks the right edge at corners
            depth = -cross / np.linalg.norm(ev, axis=-1)
            take = depth > np.maximum(best, 1e-9 * scale)
            out = np.where(take, e, out)
            best = np.maximum(best, depth)
        return out

    def fold_to_sphere(self, face: np.ndarray, hex2d: np.ndarray,
                       res: int, max_folds: int = 3):
        """Planar lattice positions -> (lat, lng), folding across face
        edges as needed.  face [N], hex2d [N, 2] -> ([N], [N, 2] geo);
        also returns the final face of each point."""
        face = np.asarray(face, np.int64).copy()
        hex2d = np.asarray(hex2d, np.float64).copy()
        fc = face_center_xyz()
        for _ in range(max_folds):
            e = self.beyond_edge(face, hex2d, res)
            sel = e >= 0
            if not np.any(sel):
                break
            fs, es = face[sel], e[sel]
            # planar point -> 3D point on f's tangent plane
            geo = hm.hex2d_to_geo(hex2d[sel], fs, res)
            xyz = hm.geo_to_xyz(geo)
            denom = np.sum(xyz * fc[fs], axis=-1, keepdims=True)
            p3 = xyz / denom
            # fold onto the neighbor face's plane
            rot = self.fold_rot[fs, es]
            p1 = self.fold_p1[fs, es]
            p3f = np.einsum("nij,nj->ni", rot, p3 - p1) + p1
            g = self.edge_neighbor[fs, es]
            geo_f = hm.xyz_to_geo(
                p3f / np.linalg.norm(p3f, axis=-1, keepdims=True))
            _, hex_g = hm.geo_to_hex2d(geo_f, res, g)
            face[sel] = g
            hex2d[sel] = hex_g
        geo = hm.hex2d_to_geo(hex2d, face, res)
        return face, geo


def _axis_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix about a unit axis."""
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C]])


_GEOM = None


def fold_geometry() -> FoldGeometry:
    global _GEOM
    if _GEOM is None:
        _GEOM = FoldGeometry()
    return _GEOM
