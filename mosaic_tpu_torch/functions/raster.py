"""The rst_* function surface over RasterTile batches.

Reference counterpart: expressions/raster/*.scala (~70 RST_* Catalyst
expressions, registrations functions/MosaicContext.scala:279-345) and
python/mosaic/api/raster.py.  A "raster column" here is a plain
Sequence[RasterTile]; row-wise results come back as lists / numpy
arrays, matching the row model of the st_/grid_ surface.

Mixed into MosaicContext (functions/context.py) so every method
auto-registers into the parity registry.

Port of ``mosaic_tpu.functions.raster``.  The methods whose JAX body
computes on the device run on the context's device (``self.device``):
``rst_convolve`` on the stencil kernel, ``rst_combineavg`` on the tile
combine kernel, ``rst_mapalgebra``/``rst_derivedband`` (the caller's
function applied to torch tensors) and ``rst_ndvi`` as torch ops,
``rst_tessellate`` and ``rst_rastertogrid*`` through the grid's
``point_to_cell_device`` (on H3 one launch of the cell kernel, low
margins re-assigned on the host, so the cells are the host's).  The
rest is host code, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

from ..core.raster import rops
from ..core.raster.gtiff import read_gtiff, write_gtiff
from ..core.raster.tile import GeoTransform, RasterTile

Tiles = Sequence[RasterTile]


class RasterFunctions:
    """rst_* methods; ``self.index_system`` and ``self.device`` come
    from MosaicContext."""

    # ------------------------------------------------------------ ingest
    def rst_fromfile(self, paths: Sequence[str]) -> List[RasterTile]:
        """reference: RST_FromFile — driver by extension/magic: GeoTIFF,
        NetCDF classic (first subdataset; use rst_getsubdataset for
        others), Zarr directory/zip."""
        import os as _os
        out = []
        for p in paths:
            low = p.lower()
            is_zarr = _os.path.isdir(p) or (
                low.endswith(".zip") and not low.endswith(".tif.zip"))
            if is_zarr:
                from ..io.zarr import read_zarr
                subs = read_zarr(p)
                if not subs:
                    raise ValueError(
                        f"{p}: no zarr arrays found (is this actually "
                        "a zarr store?)")
                t = subs[sorted(subs)[0]]
            else:
                with open(p, "rb") as f:
                    blob = f.read()
                t = self.rst_fromcontent([blob])[0]
            t.meta["path"] = p
            out.append(t)
        return out

    def rst_fromcontent(self, blobs: Sequence[bytes]) -> List[RasterTile]:
        """reference: RST_FromContent — GeoTIFF or NetCDF classic bytes
        (magic-sniffed; NetCDF yields its first subdataset)."""
        out = []
        for b in blobs:
            if b[:3] == b"CDF":
                from ..io.netcdf import read_netcdf
                subs = read_netcdf(b)
                if not subs:
                    raise ValueError(
                        "NetCDF file has no 2D variables to expose "
                        "as a raster")
                out.append(self._first_sub(subs))
            elif b[:4] == b"GRIB":
                from ..io.grib import read_grib
                out.append(self._first_sub(read_grib(b)))
            else:
                out.append(read_gtiff(b))
        return out

    @staticmethod
    def _first_sub(subs):
        """First subdataset of a container, siblings recorded in meta
        for rst_subdatasets/rst_getsubdataset."""
        t = subs[sorted(subs)[0]]
        t.meta["subdatasets"] = ",".join(sorted(subs))
        return t

    def rst_frombands(self, bands: Sequence[RasterTile]) -> RasterTile:
        """Stack single-band tiles into one raster (reference:
        RST_FromBands)."""
        if not bands:
            raise ValueError("rst_frombands of zero bands")
        g0 = bands[0]
        for b in bands[1:]:
            if b.data.shape[1:] != g0.data.shape[1:]:
                raise ValueError("rst_frombands requires equal shapes")
        data = np.concatenate([np.asarray(b.data) for b in bands])
        nodata = [b.nodata_of(0) for b in bands]
        if all(n is None for n in nodata):
            nodata = None
        return RasterTile(data, g0.gt, nodata=nodata, srid=g0.srid)

    def rst_write(self, tiles: Tiles, compress: bool = False
                  ) -> List[bytes]:
        """reference: RST_Write / GDAL.writeRasters"""
        return [write_gtiff(t, compress=compress) for t in tiles]

    def rst_tryopen(self, blobs: Sequence[bytes]) -> List[bool]:
        """reference: RST_TryOpen — readability probe, no raise."""
        out = []
        for b in blobs:
            try:
                read_gtiff(b)
                out.append(True)
            except Exception:
                out.append(False)
        return out

    def rst_asformat(self, tiles: Tiles, driver: str) -> Tiles:
        """reference: RST_AsFormat — only GTiff exists here; asserts the
        driver rather than silently accepting anything."""
        if driver.lower() not in ("gtiff", "tif", "tiff"):
            raise ValueError(f"unsupported raster driver {driver!r} "
                             "(GTiff only)")
        return list(tiles)

    def rst_format(self, tiles: Tiles) -> List[str]:
        """reference: RST_Format"""
        return [t.meta.get("driver", "GTiff") for t in tiles]

    def rst_maketiles(self, blobs: Sequence[bytes],
                      size_mb: float = 8.0) -> List[List[RasterTile]]:
        """Decode + subdivide to a memory bound (reference:
        RST_MakeTiles / ReTileOnRead.localSubdivide)."""
        return [rops.subdivide(read_gtiff(b), size_mb) for b in blobs]

    # -------------------------------------------------------- accessors
    def rst_height(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.height for t in tiles])

    def rst_width(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.width for t in tiles])

    def rst_numbands(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.num_bands for t in tiles])

    def rst_memsize(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.memsize() for t in tiles])

    def rst_srid(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.srid for t in tiles])

    def rst_setsrid(self, tiles: Tiles, srid: int) -> List[RasterTile]:
        import dataclasses
        return [dataclasses.replace(t, srid=srid) for t in tiles]

    def rst_type(self, tiles: Tiles) -> List[str]:
        """reference: RST_Type"""
        return [str(t.dtype) for t in tiles]

    def rst_updatetype(self, tiles: Tiles, dtype) -> List[RasterTile]:
        """reference: RST_UpdateType"""
        return [t.with_data(np.asarray(t.data).astype(dtype))
                for t in tiles]

    def rst_scalex(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.gt.px_w for t in tiles])

    def rst_scaley(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.gt.px_h for t in tiles])

    def rst_skewx(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.gt.rot_x for t in tiles])

    def rst_skewy(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.gt.rot_y for t in tiles])

    def rst_upperleftx(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.gt.x0 for t in tiles])

    def rst_upperlefty(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.gt.y0 for t in tiles])

    def rst_pixelwidth(self, tiles: Tiles) -> np.ndarray:
        """reference: RST_PixelWidth (abs ground size of a pixel)"""
        return np.asarray([abs(t.gt.px_w) for t in tiles])

    def rst_pixelheight(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([abs(t.gt.px_h) for t in tiles])

    def rst_rotation(self, tiles: Tiles) -> np.ndarray:
        """reference: RST_Rotation — rotation angle of the grid."""
        return np.asarray([np.arctan2(t.gt.rot_y, t.gt.px_w)
                           for t in tiles])

    def rst_georeference(self, tiles: Tiles) -> List[dict]:
        """reference: RST_GeoReference"""
        return [{"upperLeftX": t.gt.x0, "upperLeftY": t.gt.y0,
                 "scaleX": t.gt.px_w, "scaleY": t.gt.px_h,
                 "skewX": t.gt.rot_x, "skewY": t.gt.rot_y}
                for t in tiles]

    def rst_boundingbox(self, tiles: Tiles):
        """reference: RST_BoundingBox — bbox polygons."""
        from ..core.geometry.array import GeometryBuilder
        b = GeometryBuilder()
        for t in tiles:
            xmin, ymin, xmax, ymax = t.bbox()
            b.add_polygon(np.array([[xmin, ymin], [xmax, ymin],
                                    [xmax, ymax], [xmin, ymax],
                                    [xmin, ymin]]))
        return b.finish()

    def rst_metadata(self, tiles: Tiles) -> List[dict]:
        return [t.summary() for t in tiles]

    rst_summary = rst_metadata

    def rst_bandmetadata(self, tiles: Tiles, band: int) -> List[dict]:
        return [t.band(band).summary() for t in tiles]

    def rst_getnodata(self, tiles: Tiles) -> List[object]:
        return [t.nodata for t in tiles]

    def rst_setnodata(self, tiles: Tiles, nodata) -> List[RasterTile]:
        import dataclasses
        return [dataclasses.replace(t, nodata=nodata) for t in tiles]

    def rst_initnodata(self, tiles: Tiles) -> List[RasterTile]:
        """Default nodata per dtype (reference: RST_InitNoData)."""
        import dataclasses
        out = []
        for t in tiles:
            nd = 0.0 if np.asarray(t.data).dtype.kind in "ui" else np.nan
            out.append(dataclasses.replace(t, nodata=nd))
        return out

    def rst_isempty(self, tiles: Tiles) -> np.ndarray:
        return np.asarray([t.is_empty() for t in tiles])

    def rst_pixelcount(self, tiles: Tiles) -> np.ndarray:
        """Valid (data) pixels per tile (reference: RST_PixelCount)."""
        return np.asarray([int(t.valid_mask().sum()) for t in tiles])

    def rst_subdatasets(self, tiles: Tiles) -> List[dict]:
        """Subdataset names per tile (reference: RST_Subdatasets over
        NetCDF/Zarr; GTiff has none).  Multi-variable containers record
        their sibling variables in tile.meta["subdatasets"]."""
        out = []
        for t in tiles:
            names = t.meta.get("subdatasets", "")
            out.append({n: n for n in names.split(",") if n})
        return out

    def rst_getsubdataset(self, tiles: Tiles, name: str
                          ) -> List[RasterTile]:
        """reference: RST_GetSubdataset — reload the named variable from
        the tile's source container."""
        out = []
        for t in tiles:
            subs = t.meta.get("subdatasets", "")
            if name not in subs.split(","):
                raise ValueError(
                    f"no subdataset {name!r} (have: {subs or 'none'})")
            path = t.meta.get("path")
            if path is None:
                raise ValueError("tile has no source path to reload "
                                 "a subdataset from")
            if t.meta.get("driver") == "zarr":
                from ..io.zarr import read_zarr
                out.append(read_zarr(path)[name])
            elif t.meta.get("driver") == "GRIB":
                from ..io.grib import read_grib
                with open(path, "rb") as fh:
                    out.append(read_grib(fh.read())[name])
            else:
                from ..io.netcdf import read_netcdf
                with open(path, "rb") as fh:
                    out.append(read_netcdf(fh.read())[name])
        return out

    # ------------------------------------------------- coordinate math
    def rst_rastertoworldcoord(self, tiles: Tiles, cols, rows
                               ) -> np.ndarray:
        """[N, 2] world coords of pixel (col,row) per tile (reference:
        RST_RasterToWorldCoord)."""
        out = []
        for t, c, r in zip(tiles, np.atleast_1d(cols),
                           np.atleast_1d(rows)):
            x, y = t.gt.to_world(c, r)
            out.append((float(x), float(y)))
        return np.asarray(out)

    def rst_rastertoworldcoordx(self, tiles: Tiles, cols, rows):
        return self.rst_rastertoworldcoord(tiles, cols, rows)[:, 0]

    def rst_rastertoworldcoordy(self, tiles: Tiles, cols, rows):
        return self.rst_rastertoworldcoord(tiles, cols, rows)[:, 1]

    def rst_worldtorastercoord(self, tiles: Tiles, xs, ys) -> np.ndarray:
        out = []
        for t, x, y in zip(tiles, np.atleast_1d(xs), np.atleast_1d(ys)):
            c, r = t.gt.to_raster(x, y)
            out.append((int(c), int(r)))
        return np.asarray(out)

    def rst_worldtorastercoordx(self, tiles: Tiles, xs, ys):
        return self.rst_worldtorastercoord(tiles, xs, ys)[:, 0]

    def rst_worldtorastercoordy(self, tiles: Tiles, xs, ys):
        return self.rst_worldtorastercoord(tiles, xs, ys)[:, 1]

    # ---------------------------------------------------------- stats
    def rst_avg(self, tiles: Tiles) -> List[List[float]]:
        """reference: RST_Avg (per-band means)"""
        return [[t.band_stats(b)["mean"] for b in range(t.num_bands)]
                for t in tiles]

    def rst_min(self, tiles: Tiles) -> List[List[float]]:
        return [[t.band_stats(b)["min"] for b in range(t.num_bands)]
                for t in tiles]

    def rst_max(self, tiles: Tiles) -> List[List[float]]:
        return [[t.band_stats(b)["max"] for b in range(t.num_bands)]
                for t in tiles]

    def rst_median(self, tiles: Tiles) -> List[List[float]]:
        out = []
        for t in tiles:
            m = t.valid_mask()
            d = np.asarray(t.data, np.float64)
            out.append([float(np.median(d[b][m[b]])) if m[b].any()
                        else float("nan") for b in range(t.num_bands)])
        return out

    # ------------------------------------------------------- operators
    def rst_clip(self, tiles: Tiles, geoms) -> List[RasterTile]:
        """reference: RST_Clip"""
        return [rops.clip_to_geometry(t, geoms, i)
                for i, t in enumerate(tiles)]

    def rst_merge(self, tiles: Tiles) -> RasterTile:
        return rops.merge(tiles)

    rst_merge_agg = rst_merge

    def rst_combineavg(self, tiles: Tiles) -> RasterTile:
        return rops.combine_avg(tiles, device=self.device)

    rst_combineavg_agg = rst_combineavg

    def rst_derivedband(self, tiles: Tiles, fn: Callable) -> RasterTile:
        """Elementwise function over the tiles' arrays (reference:
        RST_DerivedBand — python_func pixel function): ``fn`` receives
        each tile's f64 data as a torch tensor on the context's device."""
        return rops.map_algebra(tiles, fn, device=self.device)

    rst_derivedband_agg = rst_derivedband

    def rst_mapalgebra(self, tiles: Tiles, fn: Callable) -> RasterTile:
        """reference: RST_MapAlgebra (gdal_calc expression ≙ a function
        of torch tensors on the context's device)"""
        return rops.map_algebra(tiles, fn, device=self.device)

    def rst_ndvi(self, tiles: Tiles, red: int, nir: int
                 ) -> List[RasterTile]:
        return [rops.ndvi(t, red, nir, device=self.device) for t in tiles]

    def rst_convolve(self, tiles: Tiles, kernel) -> List[RasterTile]:
        return [rops.convolve(t, np.asarray(kernel, np.float64),
                              device=self.device)
                for t in tiles]

    def rst_filter(self, tiles: Tiles, size: int, op: str
                   ) -> List[RasterTile]:
        return [rops.filter_tile(t, size, op) for t in tiles]

    def rst_transform(self, tiles: Tiles, srid: int,
                      method: str = "bilinear") -> List[RasterTile]:
        """reference: RST_Transform
        (core/raster/operator/proj/RasterProject.scala:45) — CRS warp by
        inverse-mapped resampling for the pure-math CRS pairs supported
        by st_transform (4326, 3857, 27700, UTM)."""
        return [rops.warp(t, srid, method=method) for t in tiles]

    def rst_dtmfromgeoms(self, points_xyz, gt, width: int, height: int,
                         constraints=None) -> RasterTile:
        """reference: RST_DTMFromGeoms
        (expressions/raster/RST_DTMFromGeoms.scala) — Delaunay TIN of
        elevation points rasterized to a grid by barycentric z."""
        from ..core.raster.tile import GeoTransform
        if not isinstance(gt, GeoTransform):
            gt = GeoTransform.from_tuple(gt)
        return rops.dtm_from_geoms(points_xyz, gt, width, height,
                                   constraints=constraints)

    def rst_rasterize(self, geoms, values, gt, width: int, height: int,
                      fill: float = float("nan"),
                      all_touched: bool = False) -> RasterTile:
        """Burn geometries into a raster (reference:
        rasterize/GDALRasterize.scala:155; the engine under
        RST_DTMFromGeoms and vector->raster conversions)."""
        from ..core.raster.tile import GeoTransform
        if not isinstance(gt, GeoTransform):
            gt = GeoTransform.from_tuple(gt)
        return rops.rasterize(geoms, values, gt, width, height,
                              fill=fill, all_touched=all_touched)

    def rst_separatebands(self, tiles: Tiles) -> List[RasterTile]:
        out = []
        for t in tiles:
            out.extend(rops.separate_bands(t))
        return out

    def rst_retile(self, tiles: Tiles, tile_w: int, tile_h: int
                   ) -> List[RasterTile]:
        out = []
        for t in tiles:
            out.extend(rops.retile(t, tile_w, tile_h))
        return out

    def rst_to_overlapping_tiles(self, tiles: Tiles, tile_w: int,
                                 tile_h: int, overlap_pct: int
                                 ) -> List[RasterTile]:
        """reference: RST_ToOverlappingTiles — stride < size."""
        out = []
        sx = max(1, int(tile_w * (100 - overlap_pct) / 100))
        sy = max(1, int(tile_h * (100 - overlap_pct) / 100))
        for t in tiles:
            for r0 in range(0, max(t.height - tile_h, 0) + sy, sy):
                for c0 in range(0, max(t.width - tile_w, 0) + sx, sx):
                    w = t.window(c0, r0, tile_w, tile_h)
                    if w.width and w.height:
                        out.append(w)
        return out

    def rst_subdivide(self, tiles: Tiles, size_mb: float
                      ) -> List[RasterTile]:
        out = []
        for t in tiles:
            out.extend(rops.subdivide(t, size_mb))
        return out

    def rst_tessellate(self, tiles: Tiles, res: int) -> List[RasterTile]:
        """Raster → per-grid-cell clipped tiles (reference:
        RST_Tessellate → RasterTessellate.tessellate:30-57)."""
        out = []
        for t in tiles:
            out.extend(rops.tessellate_raster(t, res, self.index_system,
                                              device=self.device))
        return out

    def rst_rastertogrid(self, tiles: Tiles, res: int,
                         reducer: str = "avg") -> List[dict]:
        """Per input raster: {cell_id: reduced band-0 value} at grid
        ``res`` (reference: RST_RasterToGrid{Avg,...} —
        RasterGridExpression pixel→cell grouping).  The pixel centres go
        through the grid's ``point_to_cell_device`` on the context's
        device, unnudged, so the cells equal ``point_to_cell``'s."""
        grid = self.index_system
        out = []
        for t in tiles:
            xs, ys = t.pixel_centers()
            pts = np.stack([xs.ravel(), ys.ravel()], axis=-1)
            cells, _ = grid.point_to_cell_device(pts, res, self.device)
            vals = np.asarray(t.data[0], np.float64).ravel()
            valid = t.valid_mask()[0].ravel()
            cells, vals = cells[valid], vals[valid]
            # one segment reduce per tile (same pattern as the join's
            # zone_histogram), not an O(cells × pixels) rescan
            uniq, inv = np.unique(cells, return_inverse=True)
            n = len(uniq)
            if n == 0:
                out.append({})
                continue
            if reducer == "avg":
                r = np.bincount(inv, vals, n) / np.bincount(inv, None, n)
            elif reducer == "min":
                r = np.full(n, np.inf)
                np.minimum.at(r, inv, vals)
            elif reducer == "max":
                r = np.full(n, -np.inf)
                np.maximum.at(r, inv, vals)
            elif reducer == "median":
                order = np.argsort(inv, kind="stable")
                starts = np.searchsorted(inv[order], np.arange(n))
                bounds = np.append(starts, len(inv))
                r = np.asarray([np.median(vals[order[bounds[i]:
                                                     bounds[i + 1]]])
                                for i in range(n)])
            elif reducer == "count":
                r = np.bincount(inv, None, n)
            else:
                raise ValueError(f"unknown reducer {reducer!r}")
            out.append({int(c): (int(v) if reducer == "count"
                                 else float(v))
                        for c, v in zip(uniq, r)})
        return out

    def rst_rastertogridavg(self, tiles: Tiles, res: int) -> List[dict]:
        return self.rst_rastertogrid(tiles, res, "avg")

    def rst_rastertogridmin(self, tiles: Tiles, res: int) -> List[dict]:
        return self.rst_rastertogrid(tiles, res, "min")

    def rst_rastertogridmax(self, tiles: Tiles, res: int) -> List[dict]:
        return self.rst_rastertogrid(tiles, res, "max")

    def rst_rastertogridmedian(self, tiles: Tiles, res: int
                               ) -> List[dict]:
        return self.rst_rastertogrid(tiles, res, "median")

    def rst_rastertogridcount(self, tiles: Tiles, res: int) -> List[dict]:
        return self.rst_rastertogrid(tiles, res, "count")
