"""BNGIndexSystem — the British National Grid, vectorized.

Port copy of ``mosaic_tpu.core.index.bng``; its device hooks
``point_to_cell_jax(_margin)`` and ``point_in_bounds_jax`` are the torch
``point_to_cell_torch(_margin)`` and ``point_in_bounds_torch``.

Reference counterpart: core/index/BNGIndexSystem.scala:31-555.  A
square/quadtree grid over EPSG:27700 (OSGB eastings/northings, domain
[0, 700km] × [0, 1300km]).  Resolutions −6..6 excluding 0: positive r =
base-10 cells of edge 10^(6−r) m ("100km".."1m"); negative r = quadrant
("500m"-style) cells of edge 5·10^(6−|r|) m, each a SW/NW/NE/SE quarter
of the enclosing base-10 cell (quadrant order chosen for space-filling
similarity, BNGIndexSystem.scala:316-334).

Cell ids are the reference's decimal-packed int64s —
``1(eL)(nL)(eBin…)(nBin…)(q)`` (encode, :540-553) — so ids and the
"SW123987NW"-style strings round-trip bit-for-bit with the reference.
All math here is closed-form integer/decimal arithmetic over whole
arrays; nothing is scalar per cell.

Proof obligation for the plugin boundary (VERDICT item 7): a string-id,
projected-CRS, mixed-quadtree grid runs through the same tessellation
engine and PIP join as H3/CUSTOM with no engine changes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .base import IndexSystem, device_scalar

__all__ = ["BNGIndexSystem"]

# 500km-letter grid: letterMap[nLetter][eLetter] (row 0 = southernmost)
_LETTERS = [
    ["SV", "SW", "SX", "SY", "SZ", "TV", "TW", "TX"],
    ["SQ", "SR", "SS", "ST", "SU", "TQ", "TR", "TS"],
    ["SL", "SM", "SN", "SO", "SP", "TL", "TM", "TN"],
    ["SF", "SG", "SH", "SJ", "SK", "TF", "TG", "TH"],
    ["SA", "SB", "SC", "SD", "SE", "TA", "TB", "TC"],
    ["NV", "NW", "NX", "NY", "NZ", "OV", "OW", "OX"],
    ["NQ", "NR", "NS", "NT", "NU", "OQ", "OR", "OS"],
    ["NL", "NM", "NN", "NO", "NP", "OL", "OM", "ON"],
    ["NF", "NG", "NH", "NJ", "NK", "OF", "OG", "OH"],
    ["NA", "NB", "NC", "ND", "NE", "OA", "OB", "OC"],
    ["HV", "HW", "HX", "HY", "HZ", "JV", "JW", "JX"],
    ["HQ", "HR", "HS", "HT", "HU", "JQ", "JR", "JS"],
    ["HL", "HM", "HN", "HO", "HP", "JL", "JM", "JN"],
    ["HF", "HG", "HH", "HJ", "HK", "JF", "JG", "JH"],
]
_PREFIX_TO_EN = {p: (e, n) for n, row in enumerate(_LETTERS)
                 for e, p in enumerate(row)}
_QUAD_NAMES = ["", "SW", "NW", "NE", "SE"]
# quadrant index -> (x, y) offsets in units of the quadrant edge
_QUAD_OFF = np.array([[0, 0], [0, 0], [0, 1], [1, 1], [1, 0]])

_XMAX = 700_000
_YMAX = 1_300_000


class BNGIndexSystem(IndexSystem):
    name = "BNG"
    crs_id = 27700
    string_ids = True

    # --------------------------------------------------------- metadata
    def resolutions(self) -> range:
        """−6..6; 0 is not a BNG resolution (reference: resolutions set
        {±1..±6}) — ``is_valid_res`` enforces the exclusion."""
        return range(-6, 7)

    @staticmethod
    def is_valid_res(res: int) -> bool:
        return res != 0 and -6 <= res <= 6

    def _check_res(self, res: int) -> None:
        if not self.is_valid_res(res):
            raise ValueError(f"resolution {res} outside supported "
                             "BNG range -6..6 (excluding 0)")

    @staticmethod
    def edge_size(res) -> np.ndarray:
        """Cell edge in metres (reference sizeMap)."""
        res = np.asarray(res)
        return np.where(res > 0, 10 ** (6 - res),
                        5 * 10 ** (6 - np.abs(res))).astype(np.int64)

    def resolution_of(self, cells: np.ndarray) -> np.ndarray:
        cells = np.atleast_1d(np.asarray(cells, np.int64))
        n = self._ndigits(cells)
        q = cells % 10
        k = (n - 6) // 2
        return np.where(n < 6, -1, np.where(q > 0, -(k + 2), k + 1))

    # -------------------------------------------------------- id coding
    @staticmethod
    def _ndigits(ids: np.ndarray) -> np.ndarray:
        n = np.ones_like(ids)
        v = np.abs(ids)
        for p in range(1, 19):
            n = np.where(v >= 10 ** p, p + 1, n)
        return n

    @staticmethod
    def _encode(e_letter, n_letter, e_bin, n_bin, quadrant, n_positions,
                res) -> np.ndarray:
        """Vectorized encode (reference: encode, :540-553).

        Divergence at res −1: the reference drops the northing letter
        there (encode :548 keeps only eLetter, and S/N/H all have
        eLetter 0), making 500km ids lossy.  Here res −1 ids are
        ``1000 + block*10`` with block = (N//500km)*2 + (E//500km)
        (0..5 ⇔ letters S,T,N,O,H,J), which round-trips; ≥6-digit ids
        (every other resolution) stay bit-compatible with the
        reference."""
        e_letter = np.asarray(e_letter, np.int64)
        n_positions = np.asarray(n_positions, np.int64)
        placeholder = 10 ** (5 + 2 * n_positions - 2)
        e_shift_l = 10 ** (3 + 2 * n_positions - 2)
        n_shift_l = 10 ** (1 + 2 * n_positions - 2)
        e_shift = 10 ** n_positions
        full = (placeholder + e_letter * e_shift_l +
                np.asarray(n_letter, np.int64) * n_shift_l +
                np.asarray(e_bin, np.int64) * e_shift +
                np.asarray(n_bin, np.int64) * 10 +
                np.asarray(quadrant, np.int64))
        block = (np.asarray(n_letter, np.int64) // 5) * 2 + \
            (e_letter // 5)
        r1 = 1000 + block * 10
        return np.where(np.asarray(res) == -1, r1, full)

    def _decode(self, cells: np.ndarray):
        """ids -> (res, edge, x, y) with x/y the cell's SW corner in
        metres (reference: getX/getY, :478-508)."""
        cells = np.atleast_1d(np.asarray(cells, np.int64))
        n = self._ndigits(cells)
        res = self.resolution_of(cells)
        edge = self.edge_size(res)
        q = cells % 10
        k = np.maximum((n - 6) // 2, 0)
        pow_k = 10 ** k
        # digit slices (decimal): 1(eL:2)(nL:2)(eBin:k)(nBin:k)(q:1)
        n_bin = (cells // 10) % pow_k
        e_bin = (cells // (10 * pow_k)) % pow_k
        n_letter = (cells // (10 * pow_k * pow_k)) % 100
        e_letter = (cells // (1000 * pow_k * pow_k)) % 100
        edge_adj = np.where(q > 0, 2 * edge, edge)
        x = (e_letter * pow_k + e_bin) * edge_adj + \
            np.where((q == 3) | (q == 4), edge, 0)
        y = (n_letter * pow_k + n_bin) * edge_adj + \
            np.where((q == 2) | (q == 3), edge, 0)
        # res -1 short ids: 1000 + block*10, block = ny*2 + ex
        block = (cells // 10) % 100
        x = np.where(n < 6, (block % 2) * 500_000, x)
        y = np.where(n < 6, (block // 2) * 500_000, y)
        return res, edge, x, y

    # ----------------------------------------------------------- kernels
    def point_to_cell(self, xy: np.ndarray, res: int) -> np.ndarray:
        self._check_res(res)
        xy = np.atleast_2d(np.asarray(xy, np.float64))
        e = np.floor(xy[:, 0]).astype(np.int64)
        nn = np.floor(xy[:, 1]).astype(np.int64)
        e_letter = e // 100_000
        n_letter = nn // 100_000
        if res < 0:
            divisor = 10 ** (6 - abs(res) + 1)
        else:
            divisor = 10 ** (6 - res)
        if res < -1:
            eq = xy[:, 0] / divisor
            nq = xy[:, 1] / divisor
            ed = eq - np.floor(eq)
            nd = nq - np.floor(nq)
            quadrant = np.where(
                (ed < 0.5) & (nd < 0.5), 1,
                np.where(ed < 0.5, 2, np.where(nd < 0.5, 4, 3)))
        else:
            quadrant = np.zeros(len(e), np.int64)
        n_positions = abs(res) if res >= -1 else abs(res) - 1
        e_bin = (e % 100_000) // divisor
        n_bin = (nn % 100_000) // divisor
        return self._encode(e_letter, n_letter, e_bin, n_bin, quadrant,
                            n_positions, res)

    def point_to_cell_torch(self, xy: torch.Tensor, res: int
                            ) -> torch.Tensor:
        self._check_res(res)
        e = torch.floor(xy[..., 0]).to(torch.int64)
        nn = torch.floor(xy[..., 1]).to(torch.int64)
        # int64 // and % floor toward -inf, as jnp's do
        e_letter = e // 100_000
        n_letter = nn // 100_000
        divisor = 10 ** (6 - abs(res) + 1) if res < 0 else 10 ** (6 - res)
        if res < -1:
            d = device_scalar(divisor, xy)
            eq = xy[..., 0] / d
            nq = xy[..., 1] / d
            ed = eq - torch.floor(eq)
            nd = nq - torch.floor(nq)
            quadrant = torch.where(
                (ed < 0.5) & (nd < 0.5), 1,
                torch.where(ed < 0.5, 2, torch.where(nd < 0.5, 4, 3)))
        else:
            quadrant = torch.zeros_like(e)
        n_positions = abs(res) if res >= -1 else abs(res) - 1
        e_bin = (e % 100_000) // divisor
        n_bin = (nn % 100_000) // divisor
        placeholder = 10 ** (5 + 2 * n_positions - 2)
        e_shift_l = 10 ** (3 + 2 * n_positions - 2)
        n_shift_l = 10 ** (1 + 2 * n_positions - 2)
        e_shift = 10 ** n_positions
        if res == -1:
            block = (n_letter // 5) * 2 + e_letter // 5
            return 1000 + block * 10
        return (placeholder + e_letter * e_shift_l +
                n_letter * n_shift_l + e_bin * e_shift +
                n_bin * 10 + quadrant)

    def point_to_cell_torch_margin(self, xy: torch.Tensor, res: int):
        cells = self.point_to_cell_torch(xy, res)
        edge = float(self.edge_size(res))
        d = device_scalar(edge, xy)
        fx = torch.remainder(xy[..., 0] / d, 1.0)
        fy = torch.remainder(xy[..., 1] / d, 1.0)
        mx = torch.minimum(fx, 1.0 - fx) * edge
        my = torch.minimum(fy, 1.0 - fy) * edge
        return cells, torch.minimum(mx, my)

    def point_in_bounds_torch(self, xy: torch.Tensor) -> torch.Tensor:
        return ((xy[..., 0] >= 0) & (xy[..., 0] <= _XMAX) &
                (xy[..., 1] >= 0) & (xy[..., 1] <= _YMAX))

    def cell_center(self, cells: np.ndarray) -> np.ndarray:
        _, edge, x, y = self._decode(cells)
        return np.stack([x + edge / 2.0, y + edge / 2.0], axis=-1)

    def cell_boundary(self, cells: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        _, edge, x, y = self._decode(cells)
        n = len(x)
        verts = np.empty((n, 4, 2))
        verts[:, 0] = np.stack([x, y], -1)
        verts[:, 1] = np.stack([x + edge, y], -1)
        verts[:, 2] = np.stack([x + edge, y + edge], -1)
        verts[:, 3] = np.stack([x, y + edge], -1)
        return verts, np.full(n, 4, np.int64)

    def k_ring(self, cells: np.ndarray, k: int) -> np.ndarray:
        cells = np.atleast_1d(np.asarray(cells, np.int64))
        size = (2 * k + 1) ** 2
        out = np.full((len(cells), size), -1, np.int64)
        res, edge, x, y = self._decode(cells)
        dx, dy = np.meshgrid(np.arange(-k, k + 1), np.arange(-k, k + 1),
                             indexing="ij")
        offs = np.stack([dx.ravel(), dy.ravel()], -1)      # [size, 2]
        cx = (x + edge / 2.0)[:, None] + offs[None, :, 0] * edge[:, None]
        cy = (y + edge / 2.0)[:, None] + offs[None, :, 1] * edge[:, None]
        valid = (cx >= 0) & (cx <= _XMAX) & (cy >= 0) & (cy <= _YMAX)
        for r in np.unique(res):
            m = res == r
            ids = self.point_to_cell(
                np.stack([cx[m].ravel(), cy[m].ravel()], -1), int(r))
            out[m] = np.where(valid[m], ids.reshape(-1, size), -1)
        return out

    def k_loop(self, cells: np.ndarray, k: int) -> np.ndarray:
        ring = self.k_ring(cells, k)
        inner = self.k_ring(cells, k - 1) if k > 1 else \
            np.asarray(np.atleast_1d(cells))[:, None]
        out = np.full((len(ring), 8 * k), -1, np.int64)
        for i in range(len(ring)):
            loop = np.setdiff1d(ring[i][ring[i] >= 0],
                                inner[i][inner[i] >= 0])
            out[i, :len(loop)] = loop
        return out

    def candidate_cells(self, bbox: np.ndarray, res: int,
                        max_cells: int = 4_000_000) -> np.ndarray:
        self._check_res(res)
        edge = float(self.edge_size(res))
        xmin = max(float(bbox[0]), 0.0)
        ymin = max(float(bbox[1]), 0.0)
        xmax = min(float(bbox[2]), float(_XMAX))
        ymax = min(float(bbox[3]), float(_YMAX))
        if xmin > xmax or ymin > ymax:
            return np.empty(0, np.int64)
        ix0 = int(np.floor(xmin / edge))
        ix1 = int(np.floor(xmax / edge))
        iy0 = int(np.floor(ymin / edge))
        iy1 = int(np.floor(ymax / edge))
        count = (ix1 - ix0 + 1) * (iy1 - iy0 + 1)
        if count > max_cells:
            raise ValueError(f"bbox covers {count} BNG cells at res "
                             f"{res} (> {max_cells})")
        xs = (np.arange(ix0, ix1 + 1) + 0.5) * edge
        ys = (np.arange(iy0, iy1 + 1) + 0.5) * edge
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        return self.point_to_cell(
            np.stack([gx.ravel(), gy.ravel()], -1), res)

    def grid_distance(self, cells_a: np.ndarray,
                      cells_b: np.ndarray) -> np.ndarray:
        """Chebyshev steps between equal-resolution cells."""
        ra, ea, xa, ya = self._decode(cells_a)
        rb, eb, xb, yb = self._decode(cells_b)
        if not np.array_equal(ra, rb):
            raise ValueError("grid_distance requires equal resolutions")
        return np.maximum(np.abs(xa - xb) // ea, np.abs(ya - yb) // ea)

    def cell_area(self, cells: np.ndarray) -> np.ndarray:
        _, edge, _, _ = self._decode(cells)
        return (edge * edge).astype(np.float64)

    # ------------------------------------------------------ formatting
    def format_cell_id(self, cells: np.ndarray) -> list:
        """ids -> "SW123987NW"-style strings (reference: format)."""
        cells = np.atleast_1d(np.asarray(cells, np.int64))
        n = self._ndigits(cells)
        res = self.resolution_of(cells)
        k = np.maximum((n - 6) // 2, 0)
        out = []
        for i, c in enumerate(cells):
            ci = int(c)
            ki = int(k[i])
            if int(n[i]) < 6:
                block = (ci // 10) % 100
                out.append("STNOHJ"[block])     # 500km block letter
                continue
            pow_k = 10 ** ki
            q = ci % 10
            n_bin = (ci // 10) % pow_k
            e_bin = (ci // (10 * pow_k)) % pow_k
            n_letter = (ci // (10 * pow_k * pow_k)) % 100
            e_letter = (ci // (1000 * pow_k * pow_k)) % 100
            prefix = _LETTERS[n_letter][e_letter]
            digits = (format(e_bin, f"0{ki}d") + format(n_bin, f"0{ki}d")
                      if ki else "")
            out.append(prefix + digits + _QUAD_NAMES[int(q)])
        return out

    def parse_cell_id(self, strings) -> np.ndarray:
        """"SW123987NW" -> id (reference: parse, :380-409)."""
        out = np.empty(len(strings), np.int64)
        for i, s in enumerate(strings):
            s = s.strip().upper()
            prefix = s[:2] if len(s) >= 2 else s + "V"
            if prefix not in _PREFIX_TO_EN:
                raise ValueError(f"unknown BNG letter pair {prefix!r} "
                                 f"in {s!r}")
            e_letter, n_letter = _PREFIX_TO_EN[prefix]
            if len(s) == 1:
                if s not in "STNOHJ":
                    raise ValueError(f"unknown 500km block letter {s!r}")
                out[i] = 1000 + "STNOHJ".index(s) * 10
                continue
            suffix = s[-2:]
            quad = _QUAD_NAMES.index(suffix) \
                if suffix in _QUAD_NAMES[1:] and len(s) > 2 else 0
            bin_digits = s[2:-2] if quad else s[2:]
            if not bin_digits:
                out[i] = self._encode(e_letter, n_letter, 0, 0, quad,
                                      1, -2)
                continue
            if len(bin_digits) % 2:
                raise ValueError(f"odd digit count in BNG id {s!r}")
            half = len(bin_digits) // 2
            e_bin = int(bin_digits[:half])
            n_bin = int(bin_digits[half:])
            n_positions = half + 1
            res = -n_positions if quad else n_positions + 1
            out[i] = self._encode(e_letter, n_letter, e_bin, n_bin,
                                  quad, n_positions, res)
        return out

    def is_valid_cell(self, cells: np.ndarray) -> np.ndarray:
        res, edge, x, y = self._decode(cells)
        return ((x >= 0) & (x <= _XMAX) & (y >= 0) & (y <= _YMAX) &
                (res != 0) & (np.abs(res) <= 6))
