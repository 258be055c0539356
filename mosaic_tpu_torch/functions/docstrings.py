"""Docstrings for the thin delegating members of the function surface.

Port copy of ``mosaic_tpu.functions.docstrings``.

Many registered functions are one-line delegations (accessors, format
wrappers, aliases) whose behavior is fully described by one sentence;
keeping those sentences here and applying them at registration keeps
the API reference (docs/api/*.md, generated by tools/generate_docs.py)
complete without padding context.py with 100 boilerplate blocks.
Substantial functions document themselves in place.

Reference spellings cite the expression class that defines the
semantics (src/main/scala/com/databricks/labs/mosaic/expressions/...).
"""

DOCSTRINGS = {
    # format family
    "convert_to_wkt": "Any geometry representation -> WKT strings "
                      "(reference: format/ConvertTo.scala, 'wkt').",
    "convert_to_wkb": "Any geometry representation -> WKB bytes "
                      "(reference: ConvertTo 'wkb').",
    "convert_to_geojson": "Any geometry representation -> GeoJSON "
                          "strings (reference: ConvertTo 'geojson').",
    "st_aswkt": "Geometry -> WKT strings (reference: ST_AsText).",
    "st_astext": "Alias of st_aswkt (reference registration).",
    "st_aswkb": "Geometry -> WKB bytes (reference: ST_AsBinary).",
    "st_asbinary": "Alias of st_aswkb (reference registration).",
    "st_asgeojson": "Geometry -> GeoJSON strings (reference: "
                    "ST_AsGeoJSON).",
    "st_geomfromwkt": "WKT strings -> geometry batch (reference: "
                      "ST_GeomFromWKT).",
    "st_geomfromtext": "Alias of st_geomfromwkt.",
    "st_geomfromwkb": "WKB bytes -> geometry batch (reference: "
                      "ST_GeomFromWKB).",
    "st_geomfrombinary": "Alias of st_geomfromwkb.",
    "st_geomfromgeojson": "GeoJSON strings -> geometry batch "
                          "(reference: ST_GeomFromGeoJSON).",
    # geometry accessors / measures
    "st_area": "Planar (CRS-unit) area per row, holes subtracted "
               "(reference: geometry/ST_Area.scala).",
    "st_length": "Planar length of each geometry's boundary/path "
                 "(reference: ST_Length).",
    "st_perimeter": "Alias semantics of st_length for polygons "
                    "(reference: ST_Perimeter).",
    "st_centroid": "Area-weighted centroid point per row (reference: "
                   "ST_Centroid).",
    "st_centroid2d": "Alias of st_centroid (reference legacy "
                     "registration).",
    "st_envelope": "Axis-aligned bounding-box polygon per row "
                   "(reference: ST_Envelope).",
    "st_dimension": "Topological dimension 0/1/2 per row (reference: "
                    "ST_Dimension).",
    "st_geometrytype": "WKT-style type name per row (reference: "
                       "ST_GeometryType).",
    "st_numpoints": "Vertex count per row (reference: ST_NumPoints).",
    "st_x": "X (lon) of each POINT row (reference: ST_X).",
    "st_y": "Y (lat) of each POINT row (reference: ST_Y).",
    "st_z": "Z of each POINT row, NaN when absent (reference: ST_Z).",
    "st_xmin": "Minimum X over each row's vertices (reference: "
               "ST_XMin).",
    "st_xmax": "Maximum X over each row's vertices (reference: "
               "ST_XMax).",
    "st_ymin": "Minimum Y over each row's vertices (reference: "
               "ST_YMin).",
    "st_ymax": "Maximum Y over each row's vertices (reference: "
               "ST_YMax).",
    "st_zmin": "Minimum Z over each row's vertices (reference: "
               "ST_ZMin).",
    "st_zmax": "Maximum Z over each row's vertices (reference: "
               "ST_ZMax).",
    "st_srid": "Spatial reference id of the batch (reference: "
               "ST_SRID).",
    "st_setsrid": "Return the batch with a new SRID tag (reference: "
                  "ST_SetSRID).",
    "st_haversine": "Great-circle distance in km between two lat/lng "
                    "column pairs (reference: ST_Haversine).",
    "st_intersects": "Row-wise boolean intersection test (reference: "
                     "ST_Intersects; exact edge/containment tests).",
    "st_within": "Row-wise a-within-b containment (reference: "
                 "ST_Within).",
    "st_rotate": "Rotate each geometry by radians about the origin "
                 "(reference: ST_Rotate).",
    "st_scale": "Scale each geometry's coordinates by (sx, sy) "
                "(reference: ST_Scale).",
    "st_translate": "Shift each geometry by (dx, dy) (reference: "
                    "ST_Translate).",
    "st_buffer_cap_style": "st_buffer with an explicit cap style "
                           "round/square/flat (reference: ST_Buffer "
                           "capStyle option).",
    "st_polygon": "Alias of st_makepolygon (reference legacy "
                  "registration).",
    "st_intersection_aggregate": "Alias of st_intersection_agg "
                                 "(reference legacy registration).",
    "st_intersects_aggregate": "Alias of st_intersects_agg "
                               "(reference legacy registration).",
    # grid functions
    "grid_boundary": "Cell boundary polygons for cell ids (reference: "
                     "index/GridBoundary.scala).",
    "grid_boundaryaswkb": "grid_boundary serialized as WKB (reference "
                          "registration).",
    "grid_cellarea": "Spherical cell area in km^2 per id (reference: "
                     "index/CellArea.scala).",
    "grid_cellkring": "Filled k-disk of cell ids per row (reference: "
                      "index/CellKRing.scala).",
    "grid_cellkloop": "Hollow ring at exactly distance k (reference: "
                      "index/CellKLoop.scala).",
    "grid_cellkringexplode": "grid_cellkring as (row id, cell) pairs "
                             "(reference: CellKRingExplode).",
    "grid_cellkloopexplode": "grid_cellkloop as (row id, cell) pairs "
                             "(reference: CellKLoopExplode).",
    "grid_distance": "Exact grid-step distance between cell id pairs "
                     "(reference: index/GridDistance.scala).",
    "grid_pointascellid": "Containing cell id per POINT row "
                          "(reference: index/PointIndexGeom.scala).",
    "grid_longlatascellid": "Cell id from lon/lat columns (reference: "
                            "index/PointIndexLonLat.scala).",
    "grid_polyfill": "Cell ids whose centers fall inside each polygon "
                     "(reference: index/Polyfill.scala).",
    "grid_polyfill_union": "Union of polyfill sets over the batch "
                           "(reference usage pattern).",
    "grid_tessellate": "Core + border chip rows per geometry "
                       "(reference: index/MosaicFill.scala).",
    "grid_tessellateexplode": "grid_tessellate exploded to one row "
                              "per chip (reference: MosaicExplode).",
    "grid_tessellateaslong": "grid_tessellate with int64 cell ids "
                             "(reference registration; ids here are "
                             "int64 natively).",
    "grid_cellid_to_string": "Cell ids -> canonical string form "
                             "(reference: IndexSystem.formatCellId).",
    "grid_cellid_from_string": "Canonical strings -> int64 cell ids "
                               "(reference: IndexSystem.parse).",
    "mosaic_explode": "Legacy alias of grid_tessellateexplode "
                      "(reference: MosaicContext.scala:549-557).",
    "mosaicfill": "Legacy alias of grid_tessellate (reference "
                  "registration).",
    # raster accessors / ops
    "rst_bandmetadata": "Per-band metadata dict (reference: "
                        "raster/RST_BandMetaData.scala).",
    "rst_combineavg": "Pixelwise average of aligned tiles (reference: "
                      "RST_CombineAvg).",
    "rst_combineavg_agg": "Grouped pixelwise average aggregator "
                          "(reference: RST_CombineAvgAgg).",
    "rst_convolve": "2D kernel convolution per band, SAME padding "
                    "(reference: RST_Convolve).",
    "rst_filter": "NxN statistical filter mean/median/min/max/mode "
                  "(reference: RST_Filter).",
    "rst_getnodata": "Nodata value per tile (reference: "
                     "RST_GetNoData).",
    "rst_setnodata": "Return tiles with a new nodata value "
                     "(reference: RST_SetNoData).",
    "rst_height": "Pixel height of each tile (reference: "
                  "RST_Height).",
    "rst_width": "Pixel width of each tile (reference: RST_Width).",
    "rst_isempty": "True when a tile has no valid pixels (reference: "
                   "RST_IsEmpty).",
    "rst_max": "Maximum valid pixel per tile (reference: RST_Max).",
    "rst_min": "Minimum valid pixel per tile (reference: RST_Min).",
    "rst_median": "Median valid pixel per tile (reference: "
                  "RST_Median).",
    "rst_memsize": "In-memory byte size per tile (reference: "
                   "RST_MemSize).",
    "rst_merge": "Mosaic tiles into one raster on a shared grid "
                 "(reference: RST_Merge).",
    "rst_merge_agg": "Grouped merge aggregator (reference: "
                     "RST_MergeAgg).",
    "rst_metadata": "Tile metadata dict (reference: RST_MetaData).",
    "rst_ndvi": "(nir - red) / (nir + red) from two band indexes "
                "(reference: RST_NDVI).",
    "rst_numbands": "Band count per tile (reference: RST_NumBands).",
    "rst_pixelheight": "World-unit pixel height (reference: "
                       "RST_PixelHeight).",
    "rst_rastertogridavg": "Mean pixel value per H3 cell covering the "
                           "tile (reference: RST_RasterToGridAvg).",
    "rst_rastertogridcount": "Valid-pixel count per covering cell "
                             "(reference: RST_RasterToGridCount).",
    "rst_rastertogridmax": "Max pixel per covering cell (reference: "
                           "RST_RasterToGridMax).",
    "rst_rastertogridmin": "Min pixel per covering cell (reference: "
                           "RST_RasterToGridMin).",
    "rst_rastertogridmedian": "Median pixel per covering cell "
                              "(reference: RST_RasterToGridMedian).",
    "rst_rastertoworldcoordx": "World X of a (row, col) pixel "
                               "(reference: RST_RasterToWorldCoordX).",
    "rst_rastertoworldcoordy": "World Y of a (row, col) pixel "
                               "(reference: RST_RasterToWorldCoordY).",
    "rst_worldtorastercoord": "(row, col) of world coordinates "
                              "(reference: RST_WorldToRasterCoord).",
    "rst_worldtorastercoordx": "Pixel column of world coordinates "
                               "(reference: RST_WorldToRasterCoordX).",
    "rst_worldtorastercoordy": "Pixel row of world coordinates "
                               "(reference: RST_WorldToRasterCoordY).",
    "rst_retile": "Split tiles into fixed-size sub-tiles (reference: "
                  "RST_ReTile).",
    "rst_scalex": "Geotransform X pixel scale (reference: "
                  "RST_ScaleX).",
    "rst_scaley": "Geotransform Y pixel scale (reference: "
                  "RST_ScaleY).",
    "rst_skewx": "Geotransform X skew/rotation term (reference: "
                 "RST_SkewX).",
    "rst_skewy": "Geotransform Y skew/rotation term (reference: "
                 "RST_SkewY).",
    "rst_separatebands": "One single-band tile per input band "
                         "(reference: RST_SeparateBands).",
    "rst_setsrid": "Return tiles tagged with a new SRID (reference: "
                   "RST_SetSRID).",
    "rst_srid": "SRID per tile (reference: RST_SRID).",
    "rst_subdivide": "Split tiles until each is under a memory budget "
                     "(reference: RST_Subdivide).",
    "rst_summary": "Per-tile summary stats dict (reference: "
                   "RST_Summary).",
    "rst_upperleftx": "Geotransform upper-left X (reference: "
                      "RST_UpperLeftX).",
    "rst_upperlefty": "Geotransform upper-left Y (reference: "
                      "RST_UpperLeftY).",
}


def apply(cls) -> None:
    """Attach the one-liners to undocumented members of ``cls``."""
    for name, doc in DOCSTRINGS.items():
        fn = getattr(cls, name, None)
        if fn is None:
            continue
        target = getattr(fn, "__func__", fn)
        if not (getattr(target, "__doc__", None) or "").strip():
            try:
                target.__doc__ = doc
            except (AttributeError, TypeError):
                pass
