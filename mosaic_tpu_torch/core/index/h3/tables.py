"""Base-cell tables, generated numerically at import.

The reference reaches H3 through JNI (com.uber:h3 3.7.0,
databrickslabs/mosaic pom.xml:92-96); the C core carries hand-maintained tables
(base cell data, per-face lookup, neighbor rotations).  Here the only
hand-carried data is the published spec's base-cell assignment
(canonical.py: number -> home face/ijk + pentagon flag); everything else
is *derived* from the icosahedron constants:

  * the 122 resolution-0 cells are found by clustering the folded lattice
    positions of every face's res-0 combos, then matched 1:1 against the
    canonical anchors (bijection asserted);
  * pentagons are the 12 cells centered on icosahedron vertices — must
    agree with the canonical pentagon flags;
  * the face->base-cell lookup and its digit-rotation calibration are fit
    empirically from probe descendants whose canonical digits are known by
    construction, with consistency asserted.

Cell ids therefore interoperate bit-for-bit with ids produced by the Uber
H3 library (pinned by tests/test_h3_canonical.py's known vectors).
"""

from __future__ import annotations

import itertools

import numpy as np

from . import hexmath as hm
from .canonical import base_cell_table
from .constants import NUM_BASE_CELLS, NUM_ICOSA_FACES
from .fold import fold_geometry

PROBE_RES = 3          # calibration depth (343 descendants per base cell)
PENT_PROBE_RES = 5     # deeper pentagon probes (seam fringe coverage)


def _down_rot(r: int) -> bool:
    """Aperture-7 variant when stepping down INTO resolution r (H3 pairs
    the plain variant with Class III targets)."""
    return r % 2 == 0


class H3Tables:
    def __init__(self):
        geom = fold_geometry()
        combos = np.array(list(itertools.product(range(3), repeat=3)),
                          dtype=np.int64)                    # [27, 3]
        n_f = NUM_ICOSA_FACES
        all_faces = np.repeat(np.arange(n_f), len(combos))
        all_ijk = np.tile(combos, (n_f, 1))
        hex2d = hm.ijk_to_hex2d(all_ijk)
        faces_out, geo = geom.fold_to_sphere(all_faces, hex2d, 0)
        xyz = hm.geo_to_xyz(geo)

        # cluster into base cells
        cluster = np.full(len(xyz), -1, np.int64)
        centers = []
        for n in range(len(xyz)):
            if cluster[n] >= 0:
                continue
            d = np.linalg.norm(xyz - xyz[n], axis=-1)
            members = d < 1e-6
            cluster[members] = len(centers)
            centers.append(xyz[members].mean(axis=0))
        centers = np.stack(centers)
        centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
        assert len(centers) == NUM_BASE_CELLS, len(centers)

        # raw face -> cluster lookup over all combos (pre-renumber)
        fijk_raw = np.full((n_f, 3, 3, 3), -1, np.int64)
        fijk_raw[all_faces, all_ijk[:, 0], all_ijk[:, 1],
                 all_ijk[:, 2]] = cluster

        # canonical numbering: match each published home anchor
        # (face, ijk) to its derived cluster; must be a bijection onto
        # the 122 clusters or the spec table/geometry disagree
        canon = base_cell_table()
        renum = np.full(NUM_BASE_CELLS, -1, np.int64)
        for b in range(NUM_BASE_CELLS):
            f, i, j, k, _ = canon[b]
            cl = fijk_raw[f, i, j, k]
            assert cl >= 0, f"canonical anchor {b} off-lattice: {canon[b]}"
            assert renum[cl] < 0, \
                f"anchors {renum[cl]} and {b} collide on one cell"
            renum[cl] = b
        assert np.all(renum >= 0)
        cluster = renum[cluster]
        inv = np.empty(NUM_BASE_CELLS, np.int64)
        inv[renum] = np.arange(NUM_BASE_CELLS)
        self.center_xyz = centers[inv]
        self.center_geo = hm.xyz_to_geo(self.center_xyz)

        # pentagons: centered on icosahedron vertices; must agree with
        # the published pentagon flags under the canonical numbering
        d = np.linalg.norm(self.center_xyz[:, None] -
                           geom.vertices[None], axis=-1)
        self.is_pentagon = np.any(d < 1e-9, axis=1)
        assert int(self.is_pentagon.sum()) == 12
        assert np.array_equal(self.is_pentagon, canon[:, 4] == 1), \
            np.nonzero(self.is_pentagon != (canon[:, 4] == 1))

        # face -> base cell lookup over all combos
        self.fijk_base = np.full((n_f, 3, 3, 3), -1, np.int64)
        self.fijk_base[all_faces, all_ijk[:, 0], all_ijk[:, 1],
                       all_ijk[:, 2]] = cluster

        # home face/ijk: the published anchors (digit orientation below
        # res 0 is defined in the home-face frame, so the canonical home
        # choice is what makes descendant ids interoperate)
        self.home_face = canon[:, 0].copy()
        self.home_ijk = canon[:, 1:4].copy()

        self._find_pentagon_seams(geom)
        self._calibrate_rotations(geom)

    # ------------------------------------------------------- calibration
    def _leading(self, digits: np.ndarray) -> np.ndarray:
        """First nonzero digit per row (0 if all zero)."""
        lead = np.zeros(len(digits), np.int64)
        for c in range(digits.shape[1]):
            col = digits[:, c]
            lead = np.where((lead == 0) & (col != 0), col, lead)
        return lead

    def _descend(self, res: int, prune: bool = True):
        """All canonical descendants of every base cell down to ``res``.

        Returns (base [M], digits [M, res], ijk [M, 3]) where ijk is the
        home-frame lattice position at ``res``.  With ``prune``, pentagon
        subtrees whose leading digit is the pentagon's seam digit are
        dropped (the deleted subsequence: the planar walk covers 360°
        around the icosahedron vertex but the sphere only has 300° there,
        so one 60° wedge duplicates another)."""
        base = np.arange(NUM_BASE_CELLS)
        ijk = self.home_ijk.copy()
        digits = np.zeros((NUM_BASE_CELLS, 0), np.int64)
        for r in range(1, res + 1):
            ijk = hm.down_ap7(ijk, rot=_down_rot(r))
            n = len(base)
            base = np.repeat(base, 7)
            digits = np.repeat(digits, 7, axis=0)
            child = np.tile(np.arange(7), n)
            ijk = hm.neighbor(np.repeat(ijk, 7, axis=0), child)
            digits = np.concatenate([digits, child[:, None]], axis=1)
            if prune:
                lead = self._leading(digits)
                drop = self.is_pentagon[base] & \
                    (lead == self.pent_seam[base])
                base, digits, ijk = base[~drop], digits[~drop], ijk[~drop]
        return base, digits, ijk

    def _find_pentagon_seams(self, geom) -> None:
        """Pentagon wedge development programs.

        A pentagon sits on an icosahedron vertex: the planar walk covers
        360° around the corner but the sphere only has 300° there.  Each
        leading-digit subtree (wedge) gets a prescribed development: w0
        (the wedge inside the home face) stays; the next wedges ccw fold
        1-2 times across the ccw corner edge; the wedges cw fold 1-2 times
        the other way; the wedge opposite the face interior (w3) is the
        deleted subsequence — its cells are re-expressed in the adjacent
        wedges by the ±60° deficit rotation at encode time.

        The aperture-7 rotation alternates sign between resolutions, so
        the cumulative frame wobble stays within ±asin(sqrt(3/28)) < 30°
        and the digit→wedge assignment is resolution-independent
        (asserted below)."""
        self.pent_seam = np.zeros(NUM_BASE_CELLS, np.int64)
        self.pent_dir = np.zeros((NUM_BASE_CELLS, 7), np.int64)
        self.pent_cnt = np.zeros((NUM_BASE_CELLS, 7), np.int64)
        self.pent_vertex = np.full(NUM_BASE_CELLS, -1, np.int64)
        for b in np.nonzero(self.is_pentagon)[0]:
            d = np.linalg.norm(geom.vertices - self.center_xyz[b], axis=-1)
            self.pent_vertex[b] = int(np.argmin(d))
            seq = None
            for lev in (1, 2):          # assert parity-independence
                ijk = self.home_ijk[b]
                for r in range(1, lev + 1):
                    ijk = hm.down_ap7(ijk, rot=_down_rot(r))
                corner = hm.ijk_to_hex2d(ijk)
                childs = hm.neighbor(np.repeat(ijk[None], 6, axis=0),
                                     np.arange(1, 7))
                rel = hm.ijk_to_hex2d(childs) - corner
                ang = np.arctan2(rel[:, 1], rel[:, 0])
                th_int = np.arctan2(-corner[1], -corner[0])
                delta = np.mod(ang - th_int, 2 * np.pi)
                wrapped = np.mod(delta + np.pi, 2 * np.pi) - np.pi
                w0 = int(np.argmin(np.abs(wrapped)))
                order = np.argsort(np.mod(delta - delta[w0], 2 * np.pi))
                s = (order + 1).tolist()        # digits 1..6 in ccw order
                if seq is None:
                    seq = s
                else:
                    assert seq == s, (b, seq, s)
            self.pent_seam[b] = seq[3]
            # with the canonical anchors (all of the form (2,0,0): the
            # vertex at the end of the home face's i-axis) the wedge
            # opposite the interior is always the I axis; the published
            # spec instead labels the deleted subsequence as the K axis
            # via a leading-5 rotation — index._pent_to_external carries
            # the exact relabeling, which relies on this being 4
            assert seq[3] == 4, (b, seq)
            for pos, digit in enumerate(seq):
                if pos == 0 or pos == 3:
                    continue
                ccw = pos in (1, 2)
                self.pent_dir[b, digit] = 1 if ccw else -1
                self.pent_cnt[b, digit] = pos if ccw else 6 - pos

        # per (face, corner, direction) edge lookup for prescribed folds
        self.corner_edge_lut = np.full((NUM_ICOSA_FACES, 3, 2), -1,
                                       np.int64)
        for f in range(NUM_ICOSA_FACES):
            for c in range(3):
                self.corner_edge_lut[f, c, 0] = geom.corner_edge(
                    f, c, ccw=False)
                self.corner_edge_lut[f, c, 1] = geom.corner_edge(
                    f, c, ccw=True)
        # vertex id -> corner index per face
        self.face_corner_of_vertex = np.full((NUM_ICOSA_FACES, 12), -1,
                                             np.int64)
        for f in range(NUM_ICOSA_FACES):
            for c in range(3):
                self.face_corner_of_vertex[f, geom.face_verts[f, c]] = c

    def develop(self, base: np.ndarray, digits: np.ndarray,
                ijk: np.ndarray, res: int, geom=None):
        """Home-frame lattice positions -> (face, geo) on the sphere,
        honoring pentagon wedge programs, then free folding."""
        return self.develop_hex2d(base, digits,
                                  hm.ijk_to_hex2d(ijk).astype(np.float64),
                                  res, geom)

    def develop_hex2d(self, base: np.ndarray, digits: np.ndarray,
                      hex2d: np.ndarray, res: int, geom=None):
        """develop() for arbitrary (float) home-frame planar positions —
        used for cell corner vertices, not just lattice points."""
        if geom is None:
            geom = fold_geometry()
        hex2d = np.asarray(hex2d, np.float64)
        face = self.home_face[base].copy()
        if digits.shape[1]:
            lead = self._leading(digits)
        else:
            lead = np.zeros(len(base), np.int64)
        isp = self.is_pentagon[base]
        dirs = np.where(isp, self.pent_dir[base, lead], 0)
        cnts = np.where(isp, self.pent_cnt[base, lead], 0)
        for step in (1, 2):
            sel = cnts >= step
            if not np.any(sel):
                break
            v = self.pent_vertex[base[sel]]
            c = self.face_corner_of_vertex[face[sel], v]
            assert np.all(c >= 0)
            e = self.corner_edge_lut[face[sel], c,
                                     (dirs[sel] > 0).astype(np.int64)]
            nf, nh = geom.fold_across(face[sel], e, hex2d[sel], res)
            face[sel] = nf
            hex2d[sel] = nh
        return geom.fold_to_sphere(face, hex2d, res)

    def _observe(self, base, digits, ijk, res, geom):
        """Natural-quantization view of canonical probes: develop each
        probe to its sphere position, re-quantize on the nearest face, and
        aggregate back to res 0.  Returns (f_obs, ijk0, digits_obs)."""
        faces, geo = self.develop(base, digits, ijk, res, geom)
        f_obs, hex_obs = hm.geo_to_hex2d(geo, res)
        cur = hm.hex2d_to_ijk(hex_obs)
        digits_obs = np.zeros_like(digits)
        for r in range(res, 0, -1):
            up = hm.up_ap7(cur, rot=_down_rot(r))
            center = hm.down_ap7(up, rot=_down_rot(r))
            digits_obs[:, r - 1] = hm.unit_ijk_to_digit(
                hm.ijk_sub(cur, center))
            cur = up
        assert np.all((cur >= 0) & (cur <= 2)), "res-0 ijk out of range"
        b_obs = self.fijk_base[f_obs, cur[:, 0], cur[:, 1], cur[:, 2]]
        assert np.array_equal(b_obs, base), "face lookup disagrees"
        return f_obs, cur, digits_obs

    def _calibrate_rotations(self, geom) -> None:
        """Fit, per (face, res-0 ijk) entry: the ccw digit rotation r0
        taking observed digits to canonical, plus (pentagon entries) the
        ±60° whole-string rewrite applied when the post-r0 leading digit
        is the pentagon seam — the same shape as the published H3 design
        (base-cell rotation + cwOffsetPent adjustment)."""
        # rotation-application table: rot_digit[r] = ccw^r digit map
        rot_digit = np.empty((6, 7), np.int64)
        rot_digit[0] = np.arange(7)
        for r in range(1, 6):
            rot_digit[r] = hm.ROT60_CCW_DIGIT[rot_digit[r - 1]]
        self.rot_digit = rot_digit

        # probe set 1: every base cell to PROBE_RES; probe set 2: pentagon
        # subtrees deeper (seam fringes only appear at depth).  Digit
        # arrays are zero-padded to a common width — rotations fix 0, and
        # leading-digit logic ignores padding, so mixing widths is safe.
        base, digits, ijk = self._descend(PROBE_RES)
        f1, ijk01, obs1 = self._observe(base, digits, ijk, PROBE_RES, geom)
        pb, pd, pijk = self._descend(PENT_PROBE_RES)
        psel = self.is_pentagon[pb]
        pb, pd, pijk = pb[psel], pd[psel], pijk[psel]
        f2, ijk02, obs2 = self._observe(pb, pd, pijk, PENT_PROBE_RES, geom)
        w = max(PROBE_RES, PENT_PROBE_RES)

        def pad(a):
            return np.pad(a, ((0, 0), (0, w - a.shape[1])))

        base = np.concatenate([base, pb])
        digits = np.concatenate([pad(digits), pad(pd)])
        digits_obs = np.concatenate([pad(obs1), pad(obs2)])
        f_obs = np.concatenate([f1, f2])
        ijk0 = np.concatenate([ijk01, ijk02])

        self.fijk_rot = np.full((NUM_ICOSA_FACES, 3, 3, 3), -1, np.int64)
        self.fijk_pent_extra = np.zeros((NUM_ICOSA_FACES, 3, 3, 3),
                                        np.int64)
        key = f_obs * 27 + ijk0[:, 0] * 9 + ijk0[:, 1] * 3 + ijk0[:, 2]
        rot_flat = self.fijk_rot.reshape(-1)
        extra_flat = self.fijk_pent_extra.reshape(-1)
        failures = []
        for k in np.unique(key):
            sel = key == k
            b = base[sel][0]
            obs = digits_obs[sel]
            want = digits[sel]
            seam = self.pent_seam[b] if self.is_pentagon[b] else -1
            fit = None
            for r0 in range(6):
                cand = rot_digit[r0][obs]
                lead = self._leading(cand)
                at_seam = lead == seam
                plain_ok = np.all(cand[~at_seam] == want[~at_seam])
                if not plain_ok:
                    continue
                if not np.any(at_seam):
                    fit = (r0, 0)
                    break
                for e in (1, 5):            # ccw or cw extra rotation
                    cand2 = rot_digit[e][cand[at_seam]]
                    if np.all(cand2 == want[at_seam]):
                        fit = (r0, e)
                        break
                if fit:
                    break
            if fit is None:
                failures.append((k // 27, (k % 27) // 9, (k % 9) // 3,
                                 k % 3, int(b)))
            else:
                rot_flat[k] = fit[0]
                extra_flat[k] = fit[1]
        assert not failures, f"rotation fit failed for {failures[:10]}"
        self.fijk_rot = rot_flat.reshape(self.fijk_rot.shape)
        self.fijk_pent_extra = extra_flat.reshape(
            self.fijk_pent_extra.shape)


_TABLES = None


def tables() -> H3Tables:
    global _TABLES
    if _TABLES is None:
        _TABLES = H3Tables()
    return _TABLES
