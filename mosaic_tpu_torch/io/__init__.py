"""Datasource boundary: vector and raster format codecs, and the
raster_to_grid pipeline (``raster_grid``).

Port of ``mosaic_tpu.io``: the same exports, every codec a pure-Python
copy of the JAX package's (no GDAL/OGR process dependency).

Reference counterpart: the datasource/ package (OGRFileFormat driver
dispatch, raster FileFormats, multi-read raster_to_grid).
"""

from .shapefile import read_shapefile, read_vector, write_shapefile
from .geopackage import gpkg_layers, read_gpkg, write_gpkg
from .grib import grib_subdatasets, read_grib
from .netcdf import netcdf_subdatasets, read_netcdf, write_netcdf

__all__ = [
    "read_vector", "read_shapefile", "write_shapefile",
    "read_gpkg", "write_gpkg", "gpkg_layers",
    "read_grib", "grib_subdatasets",
    "read_netcdf", "write_netcdf", "netcdf_subdatasets",
]
