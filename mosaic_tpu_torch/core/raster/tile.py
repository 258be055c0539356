"""The raster object model: host-described, device-computed tiles.

Port copy of ``mosaic_tpu.core.raster.tile``: the tile holds a numpy
array; the device ops of ``rops`` upload what they compute on.

Reference counterpart: core/raster/gdal/MosaicRasterGDAL.scala:34-860
(wraps org.gdal.gdal.Dataset; geotransform/bbox accessors, per-cell clip,
write/destroy lifecycle) and core/types/model/MosaicRasterTile.scala:22
(cell_id + raster + metadata wire format).

Redesign: a tile is a plain immutable dataclass over a dense
[bands, H, W] array.  No native handle lifecycle — numpy owns host
memory, the device ops own their tensors; "dispose" disappears.  The
GDAL affine geotransform convention is kept verbatim so world↔raster
math matches the reference (core/raster/api/GDAL.scala:267-295):

    x_world = gt[0] + col * gt[1] + row * gt[2]
    y_world = gt[3] + col * gt[4] + row * gt[5]

(gt[2] == gt[4] == 0 for north-up rasters; rotation supported in the
math, not in the codecs.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["RasterTile", "GeoTransform"]


@dataclasses.dataclass(frozen=True)
class GeoTransform:
    """GDAL-style affine pixel→world mapping."""

    x0: float
    px_w: float
    rot_x: float
    y0: float
    rot_y: float
    px_h: float          # negative for north-up rasters

    @staticmethod
    def from_tuple(gt) -> "GeoTransform":
        return GeoTransform(*[float(v) for v in gt])

    def to_tuple(self) -> Tuple[float, ...]:
        return (self.x0, self.px_w, self.rot_x, self.y0, self.rot_y,
                self.px_h)

    # reference: GDAL.scala:267-281 (toWorldCoord)
    def to_world(self, cols, rows):
        cols = np.asarray(cols, np.float64)
        rows = np.asarray(rows, np.float64)
        x = self.x0 + cols * self.px_w + rows * self.rot_x
        y = self.y0 + cols * self.rot_y + rows * self.px_h
        return x, y

    # reference: GDAL.scala:283-295 (fromWorldCoord, inverse affine)
    def to_raster(self, xs, ys):
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        det = self.px_w * self.px_h - self.rot_x * self.rot_y
        if det == 0:
            raise ValueError("degenerate geotransform")
        dx = xs - self.x0
        dy = ys - self.y0
        col = (dx * self.px_h - dy * self.rot_x) / det
        row = (dy * self.px_w - dx * self.rot_y) / det
        return col, row

    def shift(self, col_off: int, row_off: int) -> "GeoTransform":
        """Geotransform of a sub-window starting at (col_off, row_off)."""
        x0, y0 = self.to_world(col_off, row_off)
        return GeoTransform(float(x0), self.px_w, self.rot_x,
                            float(y0), self.rot_y, self.px_h)

    def scaled(self, fx: float, fy: float) -> "GeoTransform":
        """Geotransform after resampling by (fx, fy) pixels per pixel."""
        return GeoTransform(self.x0, self.px_w * fx, self.rot_x * fy,
                            self.y0, self.rot_y * fx, self.px_h * fy)


@dataclasses.dataclass
class RasterTile:
    """A raster (or raster chip) resident as a dense array.

    data        [bands, H, W] numpy array
    gt          GeoTransform
    nodata      scalar or per-band sequence; None = no nodata
    srid        spatial reference (EPSG int; 4326 default)
    cell_id     grid cell this tile is bound to (rst_tessellate output),
                or None for a free raster
    meta        driver/path/parent provenance (reference createInfo map,
                MosaicRasterGDAL.scala:47-66)
    """

    data: "np.ndarray"
    gt: GeoTransform
    nodata: Optional[object] = None
    srid: int = 4326
    cell_id: Optional[int] = None
    meta: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.data.ndim == 2:
            self.data = self.data[None]
        if self.data.ndim != 3:
            raise ValueError(f"raster data must be [bands, H, W], got "
                             f"shape {self.data.shape}")
        if not isinstance(self.gt, GeoTransform):
            self.gt = GeoTransform.from_tuple(self.gt)

    # ------------------------------------------------------- accessors
    @property
    def num_bands(self) -> int:
        return int(self.data.shape[0])

    @property
    def height(self) -> int:
        return int(self.data.shape[1])

    @property
    def width(self) -> int:
        return int(self.data.shape[2])

    @property
    def dtype(self):
        return self.data.dtype

    def memsize(self) -> int:
        """reference: RST_MemSize"""
        return int(np.asarray(self.data).nbytes)

    def nodata_of(self, band: int):
        if self.nodata is None:
            return None
        if np.ndim(self.nodata) == 0:
            return self.nodata
        return self.nodata[band]

    # reference: MosaicRasterGDAL.bbox/extent (:79-123)
    def bbox(self) -> Tuple[float, float, float, float]:
        cs = np.array([0, self.width, 0, self.width], np.float64)
        rs = np.array([0, 0, self.height, self.height], np.float64)
        xs, ys = self.gt.to_world(cs, rs)
        return (float(xs.min()), float(ys.min()),
                float(xs.max()), float(ys.max()))

    def pixel_centers(self) -> Tuple[np.ndarray, np.ndarray]:
        """World coordinates of every pixel center ([H, W] each)."""
        cols, rows = np.meshgrid(np.arange(self.width) + 0.5,
                                 np.arange(self.height) + 0.5)
        return self.gt.to_world(cols, rows)

    def is_empty(self) -> bool:
        """All pixels nodata/NaN (reference: RST_IsEmpty)."""
        d = np.asarray(self.data, np.float64)
        mask = np.isnan(d)
        if self.nodata is not None:
            for b in range(self.num_bands):
                nd = self.nodata_of(b)
                if nd is not None:
                    mask[b] |= d[b] == float(nd)
        return bool(mask.all())

    def valid_mask(self) -> np.ndarray:
        """[bands, H, W] bool — pixels that carry data."""
        d = np.asarray(self.data, np.float64)
        mask = ~np.isnan(d)
        if self.nodata is not None:
            for b in range(self.num_bands):
                nd = self.nodata_of(b)
                if nd is not None:
                    mask[b] &= d[b] != float(nd)
        return mask

    # -------------------------------------------------------- windowing
    def window(self, col0: int, row0: int, w: int, h: int) -> "RasterTile":
        """Sub-window view with adjusted geotransform."""
        col0 = max(0, col0)
        row0 = max(0, row0)
        sub = self.data[:, row0:row0 + h, col0:col0 + w]
        return dataclasses.replace(
            self, data=sub, gt=self.gt.shift(col0, row0))

    def with_data(self, data) -> "RasterTile":
        return dataclasses.replace(self, data=data)

    def band(self, b: int) -> "RasterTile":
        """Single-band view (reference: MosaicRasterBandGDAL access)."""
        if not 0 <= b < self.num_bands:
            raise IndexError(f"band {b} out of range "
                             f"[0, {self.num_bands})")
        nd = self.nodata_of(b)
        return dataclasses.replace(self, data=self.data[b:b + 1],
                                   nodata=nd)

    # ------------------------------------------------------------ stats
    def band_stats(self, b: int) -> Dict[str, float]:
        """min/max/mean/std/count over valid pixels (reference:
        MosaicRasterGDAL.getBandStats:493)."""
        d = np.asarray(self.data[b], np.float64)
        m = ~np.isnan(d)
        nd = self.nodata_of(b)
        if nd is not None:
            m &= d != float(nd)
        v = d[m]
        if v.size == 0:
            return {"min": np.nan, "max": np.nan, "mean": np.nan,
                    "std": np.nan, "count": 0}
        return {"min": float(v.min()), "max": float(v.max()),
                "mean": float(v.mean()), "std": float(v.std()),
                "count": int(v.size)}

    def summary(self) -> Dict[str, object]:
        """reference: RST_Summary / RST_MetaData"""
        return {
            "bands": self.num_bands, "height": self.height,
            "width": self.width, "dtype": str(self.dtype),
            "srid": self.srid, "bbox": self.bbox(),
            "geotransform": self.gt.to_tuple(), "nodata": self.nodata,
            "cell_id": self.cell_id, **self.meta,
        }
