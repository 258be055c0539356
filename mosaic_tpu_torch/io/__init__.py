"""IO pipelines: raster files to grid-cell measures (``raster_grid``)."""
