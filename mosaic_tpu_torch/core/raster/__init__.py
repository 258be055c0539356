"""Raster subsystem: tile model, GeoTIFF codec, operators.

Port of ``mosaic_tpu.core.raster``.  Reference counterpart: core/raster/
(gdal wrappers + operator tree, SURVEY.md §2.2).  See tile.py (object
model), gtiff.py (codec), rops.py (operators).
"""

from .gtiff import read_gtiff, write_gtiff
from .tile import GeoTransform, RasterTile

__all__ = ["RasterTile", "GeoTransform", "read_gtiff", "write_gtiff"]
