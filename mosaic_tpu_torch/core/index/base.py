"""IndexSystem — the grid plugin boundary, vectorized.

Port copy of ``mosaic_tpu.core.index.base``.  The JAX package's device
hooks ``point_to_cell_jax``, ``point_to_cell_jax_margin`` and
``point_in_bounds_jax`` are ``point_to_cell_torch``,
``point_to_cell_torch_margin`` and ``point_in_bounds_torch`` here: they
take and return tensors on the caller's device.  ``prepare_torch`` is
the port's own: a grid whose hooks launch a kernel builds it there.

Reference counterpart: core/index/IndexSystem.scala:15-318 (pointToIndex,
polyfill, kRing/kLoop, indexToGeometry, getBufferRadius, getBorderChips,
getCoreChips, alignToGrid, area, cell-id formatting).  The reference's
contract is scalar (one cell at a time); TPU-first every method takes and
returns arrays so grid math runs as one vectorized computation for a whole
batch of points/cells.

Chipping (getCoreChips/getBorderChips) lives in core/tessellate.py — the
engine only needs the primitives below, which is the whole point of the
plugin boundary (SURVEY.md §2.1 "This is the boundary the TPU build
re-implements").
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

import numpy as np
import torch

#: CRS units: a point whose device margin is below this band takes its
#: cell from the exact f64 host path in ``point_to_cell_device`` (it
#: covers the f32 rounding of absolute lon/lat degrees in H3's cell
#: kernel)
DEVICE_MARGIN_BAND = 3e-5


def device_scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``like``'s dtype on its device, made by a
    fill kernel (no host copy, no synchronize).  The device hooks divide
    by these: CUDA turns division by a python scalar into a multiply by
    its reciprocal, which is not the rounded quotient the JAX package's
    f32 division gives."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


class IndexSystem(abc.ABC):
    """Vectorized hierarchical grid contract.

    Coordinates are (x, y) in the grid's CRS — lon/lat degrees for
    geographic grids (H3), projected meters for BNG/CUSTOM.  Cell ids are
    int64 (uint64 bit patterns stored in int64, as H3 does in Java).
    """

    #: short name used by IndexSystemFactory / conf strings
    name: str = "ABSTRACT"
    #: EPSG code of the grid CRS (4326 for H3, 27700 for BNG)
    crs_id: int = 4326
    #: True when cell ids have a canonical string form (BNG)
    string_ids: bool = False

    # ----------------------------------------------------------- metadata
    @abc.abstractmethod
    def resolutions(self) -> range:
        """Supported resolution range (reference: IndexSystem.resolutions)."""

    @abc.abstractmethod
    def resolution_of(self, cells: np.ndarray) -> np.ndarray:
        """[N] resolution of each cell id."""

    # ------------------------------------------------------------ kernels
    @abc.abstractmethod
    def point_to_cell(self, xy: np.ndarray, res: int) -> np.ndarray:
        """[N, 2] (x, y) -> [N] int64 cell ids (reference: pointToIndex)."""

    def prepare_torch(self, device: torch.device, res: int) -> None:
        """Build and upload, once, whatever the device hooks need on
        ``device`` at ``res`` — blocking work a join does before its
        stream-ordered loop.  Grids whose hooks are plain torch ops need
        nothing."""

    def point_to_cell_torch(self, xy: torch.Tensor, res: int
                            ) -> torch.Tensor:
        """Device point_to_cell: [N, 2] tensor -> [N] int64 cell ids on
        the same device.  Device-side cell assignment is the first stage
        of every indexed join; grids implement it as closed-form
        bit/float math (no tables beyond small constant gathers)."""
        raise NotImplementedError(f"{self.name} has no device kernel")

    def point_to_cell_torch_margin(self, xy: torch.Tensor, res: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cells, margin): margin [N] is a lower-ish bound on each
        point's distance (in CRS units) to its cell's boundary, computed
        from the quantization residual.  The join pipeline flags points
        with small margin for float64 host recheck — this is what makes
        float32 device cell assignment exact-by-construction: any point
        close enough to a cell edge for f32 rounding to matter is, by
        definition, low-margin."""
        cells = self.point_to_cell_torch(xy, res)
        return cells, torch.full(xy.shape[:-1], float("inf"),
                                 dtype=xy.dtype, device=xy.device)

    #: dtype ``point_to_cell_device`` hands the device hooks: f64 where
    #: they are torch ops (the host's arithmetic, op for op); a grid
    #: whose hook is an f32 kernel overrides it
    route_dtype = np.float64

    def point_to_cell_device(self, xy: np.ndarray, res: int, device
                             ) -> Tuple[np.ndarray, int]:
        """Cell ids of [N, 2] f64 points on ``device``, equal to
        ``point_to_cell``'s: ``point_to_cell_torch_margin`` on the points
        in ``route_dtype`` (on H3 one launch of the cell kernel), and
        every point whose margin is below DEVICE_MARGIN_BAND assigned
        again by the exact host path.  Returns (cells [N] int64, the
        number of points the host assigned)."""
        xy = np.asarray(xy, np.float64)[:, :2]
        cells, margin = self.point_to_cell_torch_margin(
            torch.from_numpy(np.ascontiguousarray(xy, self.route_dtype)
                             ).to(device), res)
        cells = cells.cpu().numpy()
        low = np.nonzero(margin.cpu().numpy() < DEVICE_MARGIN_BAND)[0]
        if len(low):
            cells[low] = self.point_to_cell(xy[low], res)
        return cells, len(low)

    def point_in_bounds_torch(self, xy: torch.Tensor) -> torch.Tensor:
        """[N, 2] -> [N] bool on the same device: point lies inside the
        grid's valid domain.  Global grids (H3) cover the sphere and
        return all True; bounded grids (CUSTOM/BNG) must override so
        out-of-domain points are rejected rather than clipped into a
        boundary cell."""
        return torch.ones(xy.shape[:-1], dtype=torch.bool, device=xy.device)

    @abc.abstractmethod
    def cell_center(self, cells: np.ndarray) -> np.ndarray:
        """[N] -> [N, 2] cell center (x, y)."""

    @abc.abstractmethod
    def cell_boundary(self, cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[N] -> ([N, K, 2] vertices CCW, [N] vertex counts).

        K is the grid's max boundary vertex count (4 rect, up to 10 for H3
        cells crossing icosahedron edges).  Padded rows repeat the last
        valid vertex.  (reference: indexToGeometry)"""

    @abc.abstractmethod
    def k_ring(self, cells: np.ndarray, k: int) -> np.ndarray:
        """[N] -> [N, m] filled disk of radius k (id = -1 padding);
        m = max disk size (3k²+3k+1 for hex).  (reference: kRing)"""

    @abc.abstractmethod
    def k_loop(self, cells: np.ndarray, k: int) -> np.ndarray:
        """[N] -> [N, m] hollow ring at exactly distance k (-1 padding);
        m = max ring size (6k for hex).  (reference: kLoop)"""

    @abc.abstractmethod
    def candidate_cells(self, bbox: np.ndarray, res: int,
                        max_cells: int = 4_000_000) -> np.ndarray:
        """All cells whose geometry may intersect bbox [xmin, ymin, xmax,
        ymax]; a superset is allowed, the tessellation engine filters
        exactly.  Replaces the reference's buffer-radius + polyfill
        candidate generation (core/Mosaic.scala:61-99)."""

    def candidate_cells_batch(self, bboxes: np.ndarray, res: int,
                              max_cells: int = 4_000_000,
                              device=None) -> list:
        """candidate_cells for G bboxes at once: [G, 4] -> list of G int64
        arrays.  Default loops; grids whose candidate generation has
        per-call fixed costs (H3's dense sample lattice re-encodes the
        same cells for every overlapping bbox) override with a shared
        pass — profiling showed per-geometry candidate generation was
        67% of tessellation time on the 281-zone bench workload.
        ``device`` is where a grid that samples point lattices (H3) finds
        their cells; this loop does not sample and ignores it."""
        out = []
        for g in range(len(bboxes)):
            bb = bboxes[g]
            if np.any(np.isnan(bb)):
                out.append(np.empty(0, np.int64))
            else:
                out.append(self.candidate_cells(bb, res, max_cells))
        return out

    # ------------------------------------------------------- derived ops
    def cell_area(self, cells: np.ndarray) -> np.ndarray:
        """[N] planar area in CRS units² (reference: IndexSystem.area uses
        spherical excess for geographic grids — H3 overrides with km²)."""
        verts, counts = self.cell_boundary(cells)
        x, y = verts[..., 0], verts[..., 1]
        k = np.arange(verts.shape[1])[None, :]
        valid = k < counts[:, None]
        nxt = np.where(k + 1 >= counts[:, None], 0, k + 1)
        x2 = np.take_along_axis(x, nxt, axis=1)
        y2 = np.take_along_axis(y, nxt, axis=1)
        tri = (x * y2 - x2 * y) * valid
        return np.abs(0.5 * tri.sum(axis=-1))

    def grid_distance(self, cells_a: np.ndarray,
                      cells_b: np.ndarray) -> np.ndarray:
        """[N] grid-step distance between paired cells (reference:
        GridDistance expression).  Default: BFS-free approximation via
        k_ring is grid-specific; subclasses override."""
        raise NotImplementedError

    def polyfill_centers(self, cells: np.ndarray) -> np.ndarray:
        return self.cell_center(cells)

    # ------------------------------------------------------ id formatting
    def format_cell_id(self, cells: np.ndarray) -> list:
        """int64 ids -> canonical string form (reference:
        IndexSystem.format/formatCellId, :48-74)."""
        return [format(int(c) & 0xFFFFFFFFFFFFFFFF, "x") for c in cells]

    def parse_cell_id(self, strings) -> np.ndarray:
        out = np.array([int(s, 16) for s in strings], dtype=np.uint64)
        return out.view(np.int64)

    # ---------------------------------------------------------- validity
    def is_valid_cell(self, cells: np.ndarray) -> np.ndarray:
        res = self.resolution_of(cells)
        return (res >= self.resolutions().start) & \
               (res < self.resolutions().stop)
