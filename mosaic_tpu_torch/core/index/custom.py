"""CustomIndexSystem — parametric rectangular multi-resolution grid.

Reference counterpart: core/index/CustomIndexSystem.scala:14 +
core/index/GridConf.scala:3.  An arbitrary rectangular grid over any
CRS/bounds; resolution r splits the root grid cellSplits^r times per axis.
All kernels are closed-form integer math — trivially vectorized, and the
grid used (as in the reference test matrix,
test/MosaicSpatialQueryTest.scala:21-26) to exercise the engine without H3.

Cell id layout (int64):  [4 bits res | 28 bits y | 28 bits x], avoiding the
sign bit so ids stay non-negative.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import IndexSystem, device_scalar

_RES_SHIFT = 56
_Y_SHIFT = 28
_MASK28 = (1 << 28) - 1


@dataclasses.dataclass(frozen=True)
class GridConf:
    """Reference: core/index/GridConf.scala — conf string
    CUSTOM(xMin,xMax,yMin,yMax,splits,rootSizeX,rootSizeY[,crs])."""

    bound_x_min: float
    bound_x_max: float
    bound_y_min: float
    bound_y_max: float
    cell_splits: int
    root_cell_size_x: float
    root_cell_size_y: float
    crs_id: int = 4326

    @property
    def root_cells_x(self) -> int:
        return max(1, int(round(
            (self.bound_x_max - self.bound_x_min) / self.root_cell_size_x)))

    @property
    def root_cells_y(self) -> int:
        return max(1, int(round(
            (self.bound_y_max - self.bound_y_min) / self.root_cell_size_y)))


class CustomIndexSystem(IndexSystem):
    name = "CUSTOM"

    def __init__(self, conf: GridConf):
        self.conf = conf
        self.crs_id = conf.crs_id
        # max resolution limited by 28-bit per-axis indices
        max_res = 0
        while (self.cells_per_axis_x(max_res + 1) <= _MASK28 and
               self.cells_per_axis_y(max_res + 1) <= _MASK28 and
               max_res < 15):
            max_res += 1
        self._max_res = max_res

    # ----------------------------------------------------------- helpers
    def cells_per_axis_x(self, res: int) -> int:
        return self.conf.root_cells_x * self.conf.cell_splits ** res

    def cells_per_axis_y(self, res: int) -> int:
        return self.conf.root_cells_y * self.conf.cell_splits ** res

    def cell_size(self, res: int) -> Tuple[float, float]:
        c = self.conf
        return ((c.bound_x_max - c.bound_x_min) / self.cells_per_axis_x(res),
                (c.bound_y_max - c.bound_y_min) / self.cells_per_axis_y(res))

    def _pack(self, res, ix, iy):
        return (np.int64(res) << _RES_SHIFT) | \
               (iy.astype(np.int64) << _Y_SHIFT) | ix.astype(np.int64)

    def _unpack(self, cells):
        cells = np.asarray(cells, dtype=np.int64)
        res = (cells >> _RES_SHIFT).astype(np.int32)
        iy = ((cells >> _Y_SHIFT) & _MASK28).astype(np.int64)
        ix = (cells & _MASK28).astype(np.int64)
        return res, ix, iy

    # ---------------------------------------------------------- contract
    def resolutions(self) -> range:
        return range(0, self._max_res + 1)

    def resolution_of(self, cells: np.ndarray) -> np.ndarray:
        return self._unpack(cells)[0]

    def _check_res(self, res: int) -> None:
        if res not in self.resolutions():
            raise ValueError(f"resolution {res} outside supported range "
                             f"{self.resolutions()} for {self.name}")

    def point_to_cell(self, xy: np.ndarray, res: int) -> np.ndarray:
        self._check_res(res)
        xy = np.asarray(xy, dtype=np.float64)
        c = self.conf
        sx, sy = self.cell_size(res)
        ix = np.floor((xy[..., 0] - c.bound_x_min) / sx).astype(np.int64)
        iy = np.floor((xy[..., 1] - c.bound_y_min) / sy).astype(np.int64)
        ix = np.clip(ix, 0, self.cells_per_axis_x(res) - 1)
        iy = np.clip(iy, 0, self.cells_per_axis_y(res) - 1)
        return self._pack(res, ix, iy)

    def point_in_bounds_torch(self, xy: torch.Tensor) -> torch.Tensor:
        c = self.conf
        return ((xy[..., 0] >= c.bound_x_min) & (xy[..., 0] <= c.bound_x_max)
                & (xy[..., 1] >= c.bound_y_min)
                & (xy[..., 1] <= c.bound_y_max))

    def _fractional_cells(self, xy: torch.Tensor, res: int):
        """(x - xmin) / sx and (y - ymin) / sy in the input's dtype."""
        c = self.conf
        sx, sy = self.cell_size(res)
        return ((xy[..., 0] - c.bound_x_min) / device_scalar(sx, xy),
                (xy[..., 1] - c.bound_y_min) / device_scalar(sy, xy))

    def point_to_cell_torch(self, xy: torch.Tensor, res: int
                            ) -> torch.Tensor:
        self._check_res(res)
        fx, fy = self._fractional_cells(xy, res)
        ix = torch.floor(fx).to(torch.int64).clamp_(
            0, self.cells_per_axis_x(res) - 1)
        iy = torch.floor(fy).to(torch.int64).clamp_(
            0, self.cells_per_axis_y(res) - 1)
        return (res << _RES_SHIFT) | (iy << _Y_SHIFT) | ix

    def point_to_cell_torch_margin(self, xy: torch.Tensor, res: int):
        cells = self.point_to_cell_torch(xy, res)
        sx, sy = self.cell_size(res)
        fx, fy = (torch.remainder(f, 1.0)
                  for f in self._fractional_cells(xy, res))
        mx = torch.minimum(fx, 1.0 - fx) * sx
        my = torch.minimum(fy, 1.0 - fy) * sy
        return cells, torch.minimum(mx, my)

    def cell_center(self, cells: np.ndarray) -> np.ndarray:
        res, ix, iy = self._unpack(cells)
        c = self.conf
        out = np.empty((len(np.atleast_1d(ix)), 2))
        # vectorized over mixed resolutions
        res = np.atleast_1d(res)
        for r in np.unique(res):
            m = res == r
            sx, sy = self.cell_size(int(r))
            out[m, 0] = c.bound_x_min + (np.atleast_1d(ix)[m] + 0.5) * sx
            out[m, 1] = c.bound_y_min + (np.atleast_1d(iy)[m] + 0.5) * sy
        return out

    def cell_boundary(self, cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        res, ix, iy = self._unpack(cells)
        n = len(np.atleast_1d(ix))
        verts = np.empty((n, 4, 2))
        c = self.conf
        res = np.atleast_1d(res)
        ix = np.atleast_1d(ix)
        iy = np.atleast_1d(iy)
        for r in np.unique(res):
            m = res == r
            sx, sy = self.cell_size(int(r))
            x0 = c.bound_x_min + ix[m] * sx
            y0 = c.bound_y_min + iy[m] * sy
            # CCW: (x0,y0) (x1,y0) (x1,y1) (x0,y1)
            verts[m, 0] = np.stack([x0, y0], -1)
            verts[m, 1] = np.stack([x0 + sx, y0], -1)
            verts[m, 2] = np.stack([x0 + sx, y0 + sy], -1)
            verts[m, 3] = np.stack([x0, y0 + sy], -1)
        return verts, np.full(n, 4, dtype=np.int32)

    def k_ring(self, cells: np.ndarray, k: int) -> np.ndarray:
        """Square (2k+1)² neighborhood (reference: CustomIndexSystem.kRing
        :40-62 uses chebyshev rings)."""
        res, ix, iy = self._unpack(cells)
        offs = np.arange(-k, k + 1)
        ox, oy = np.meshgrid(offs, offs, indexing="xy")
        ox, oy = ox.ravel(), oy.ravel()
        nx = ix[:, None] + ox[None, :]
        ny = iy[:, None] + oy[None, :]
        out = self._pack(res[:, None], nx, ny)
        valid = np.ones_like(nx, dtype=bool)
        for r in np.unique(res):
            m = res == r
            valid[m] &= (nx[m] >= 0) & (nx[m] < self.cells_per_axis_x(int(r)))
            valid[m] &= (ny[m] >= 0) & (ny[m] < self.cells_per_axis_y(int(r)))
        return np.where(valid, out, -1)

    def k_loop(self, cells: np.ndarray, k: int) -> np.ndarray:
        disk = self.k_ring(cells, k)
        if k == 0:
            return disk
        inner = self.k_ring(cells, k - 1)
        loop_mask = ~np.isin(disk, inner) & (disk >= 0)
        m = 8 * k
        out = np.full((len(disk), m), -1, dtype=np.int64)
        for i in range(len(disk)):
            sel = disk[i][loop_mask[i]]
            out[i, :len(sel)] = sel
        return out

    def candidate_cells(self, bbox: np.ndarray, res: int,
                        max_cells: int = 4_000_000) -> np.ndarray:
        self._check_res(res)
        c = self.conf
        sx, sy = self.cell_size(res)
        x0 = int(np.floor((bbox[0] - c.bound_x_min) / sx))
        y0 = int(np.floor((bbox[1] - c.bound_y_min) / sy))
        x1 = int(np.floor((bbox[2] - c.bound_x_min) / sx))
        y1 = int(np.floor((bbox[3] - c.bound_y_min) / sy))
        x0 = max(x0, 0)
        y0 = max(y0, 0)
        x1 = min(x1, self.cells_per_axis_x(res) - 1)
        y1 = min(y1, self.cells_per_axis_y(res) - 1)
        nx, ny = x1 - x0 + 1, y1 - y0 + 1
        if nx <= 0 or ny <= 0:
            return np.empty(0, dtype=np.int64)
        if nx * ny > max_cells:
            raise ValueError(
                f"bbox covers {nx * ny} cells at res {res} > {max_cells}")
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                             indexing="xy")
        return self._pack(np.int64(res), gx.ravel(), gy.ravel())

    def grid_distance(self, cells_a: np.ndarray,
                      cells_b: np.ndarray) -> np.ndarray:
        _, ax, ay = self._unpack(cells_a)
        _, bx, by = self._unpack(cells_b)
        return np.maximum(np.abs(ax - bx), np.abs(ay - by))

    def format_cell_id(self, cells: np.ndarray) -> list:
        return [str(int(c)) for c in np.atleast_1d(cells)]

    def parse_cell_id(self, strings) -> np.ndarray:
        return np.asarray([int(s) for s in strings], dtype=np.int64)
