"""Raster operators — the compute layer over RasterTile.

Port of ``mosaic_tpu.core.raster.rops``.  The host numpy ops stay numpy,
as in the JAX package: ``clip_to_geometry``, ``merge``, ``retile``,
``subdivide``, ``separate_bands``, ``filter_tile``, ``resample`` and
``rasterize``.  The ops the JAX package runs in jnp run on a device
(CUDA unless the caller passes ``device="cpu"``):

* ``combine`` (and ``combine_avg``) on the NaN-aware tile combine kernel
  (``ops/raster_combine.py``);
* ``convolve`` on the f64 instance of the stencil kernel
  (``ops/raster_convolve.py``);
* ``ndvi`` as f64 torch ops, elementwise;
* ``map_algebra`` runs the caller's function on device tensors and
  brings the result back as f64 numpy.

``tessellate_raster`` and ``clip_to_cell`` assign pixel centres to cells
through the grid's ``point_to_cell_device`` (on H3 one launch of the cell
kernel, low-margin points re-assigned by the exact host path, so the
ids equal ``point_to_cell``'s); the grouping and the per-cell window loop
stay on the host, as in the JAX package.  ``warp`` (an inverse mapping
through ``crs.transform_xy`` in f64, nearest or bilinear) and
``dtm_from_geoms`` (Delaunay, then barycentric z) are host numpy, as in
the JAX package.

Reference counterpart: core/raster/operator/* (clip/RasterClipByVector,
merge/MergeRasters, pixel/PixelCombineRasters, retile/RasterTessellate,
retile/BalancedSubdivision, retile/ReTile, separate/SeparateBands,
CombineAVG, gdal/GDALWarp.scala) — each of which shells into GDAL C++.

Alignment model: ops that combine tiles require compatible grids (same
pixel size & phase); merge/combine resample nothing — like the
reference's MergeRasters, which assumes pre-projected tiles (the
RasterAsGridReader pipeline projects first, :34).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ...ops.raster_combine import raster_combine
from ...ops.raster_convolve import raster_convolve
from ..geometry.array import GeometryArray
from ..index.base import IndexSystem
from ..tessellate import _pip, _poly_edges
from .tile import GeoTransform, RasterTile

__all__ = ["clip_to_geometry", "clip_to_cell", "merge", "combine",
           "combine_avg", "tessellate_raster", "retile", "subdivide",
           "separate_bands", "ndvi", "convolve", "filter_tile",
           "map_algebra", "resample", "warp", "rasterize",
           "dtm_from_geoms"]


_F = np.float64


def _nodata_fill(tile: RasterTile) -> float:
    nd = tile.nodata
    if nd is None:
        return float("nan")
    return float(nd if np.ndim(nd) == 0 else nd[0])


def _mask_fill(win: RasterTile, inside: np.ndarray) -> RasterTile:
    """Nodata-fill pixels outside ``inside`` ([H, W] bool), handling the
    integer-dtype-without-nodata case (falls back to 0)."""
    fill = _nodata_fill(win)
    data = np.asarray(win.data).copy()
    if data.dtype.kind in "ui" and math.isnan(fill):
        fill = 0.0
        win = dataclasses.replace(win, nodata=0.0)
    data[:, ~inside] = np.asarray(fill, dtype=data.dtype) \
        if not math.isnan(fill) else np.nan
    return win.with_data(data)


def _pixel_points(tile: RasterTile) -> np.ndarray:
    """[H * W, 2] f64 pixel centres, nudged by +1e-6 pixel.

    Ownership must not depend on which sub-window frame recomputed the
    center: windowing shifts centers by ~1e-15 relative, which flips
    floor() for pixels exactly on a cell boundary.  A +1e-6-pixel nudge
    dominates that ulp noise, so every frame agrees (boundary pixels go
    to the upper cell, matching point_to_cell's half-open convention)."""
    xs, ys = tile.pixel_centers()
    nx = abs(tile.gt.px_w) * 1e-6
    ny = abs(tile.gt.px_h) * 1e-6
    return np.stack([xs.ravel() + nx, ys.ravel() + ny], axis=-1)


def _ownership(tile: RasterTile, res: int, grid: IndexSystem,
               device: torch.device) -> Tuple[np.ndarray, int]:
    """([H, W] int64, n): the cell of every (nudged) pixel centre at
    ``res``, equal to ``grid.point_to_cell``'s, through the grid's device
    route, and the number of centres the route sent to the exact host
    path for a low margin."""
    own, host = grid.point_to_cell_device(_pixel_points(tile), res, device)
    return own.reshape(tile.height, tile.width), host


def _group_by_cell(own: np.ndarray):
    """(cells, lo, hi, rows, cols): the distinct cells of ``own`` [H, W]
    ascending, and each one's pixels as rows[lo:hi], cols[lo:hi]."""
    allowed = np.unique(own)
    flat = own.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_cells = flat[order]
    rows = order // own.shape[1]
    cols = order % own.shape[1]
    lo = np.searchsorted(sorted_cells, allowed, side="left")
    hi = np.searchsorted(sorted_cells, allowed, side="right")
    return allowed, lo, hi, rows, cols


def clip_to_geometry(tile: RasterTile, geom: GeometryArray,
                     gi: int = 0) -> RasterTile:
    """Crop to the geometry bbox and nodata-mask pixels whose center
    falls outside the geometry (reference:
    operator/clip/RasterClipByVector.scala:73 — GDALWarp cutline with
    CENTER pixel test)."""
    edges = _poly_edges(geom, gi)
    if len(edges) == 0:
        return tile.window(0, 0, 0, 0)
    xmin, ymin = edges[:, :, 0].min(), edges[:, :, 1].min()
    xmax, ymax = edges[:, :, 0].max(), edges[:, :, 1].max()
    c0, r0 = tile.gt.to_raster(xmin, ymax)   # north-up: ymax is top
    c1, r1 = tile.gt.to_raster(xmax, ymin)
    col0 = int(np.floor(min(c0, c1)))
    col1 = int(np.ceil(max(c0, c1)))
    row0 = int(np.floor(min(r0, r1)))
    row1 = int(np.ceil(max(r0, r1)))
    col0 = max(col0, 0)
    row0 = max(row0, 0)
    col1 = min(col1, tile.width)
    row1 = min(row1, tile.height)
    if col1 <= col0 or row1 <= row0:
        return tile.window(0, 0, 0, 0)
    win = tile.window(col0, row0, col1 - col0, row1 - row0)
    xs, ys = win.pixel_centers()
    pts = np.stack([xs.ravel(), ys.ravel()], axis=-1)
    inside = _pip(pts, edges).reshape(win.height, win.width)
    return _mask_fill(win, inside)


def clip_to_cell(tile: RasterTile, cell_id: int, grid: IndexSystem,
                 device: DeviceLike = None) -> RasterTile:
    """Clip to one grid cell (reference:
    MosaicRasterGDAL.getRasterForCell:393).

    Pixel ownership is ``point_to_cell(center) == cell_id`` — NOT a ring
    PIP test — so a pixel whose center sits exactly on a cell boundary
    goes to the same cell the vector/point path assigns it to, and
    tessellated tiles partition the raster with no double-counted or
    dropped boundary pixels.  The ownership pass runs on ``device``
    (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    cell = np.asarray([cell_id], np.int64)
    res = int(grid.resolution_of(cell)[0])
    verts, counts = grid.cell_boundary(cell)
    ring = verts[0, :counts[0]]
    xmin, ymin = ring[:, 0].min(), ring[:, 1].min()
    xmax, ymax = ring[:, 0].max(), ring[:, 1].max()
    c0, r0 = tile.gt.to_raster(xmin, ymax)
    c1, r1 = tile.gt.to_raster(xmax, ymin)
    col0 = max(int(np.floor(min(c0, c1))) - 1, 0)
    row0 = max(int(np.floor(min(r0, r1))) - 1, 0)
    col1 = min(int(np.ceil(max(c0, c1))) + 1, tile.width)
    row1 = min(int(np.ceil(max(r0, r1))) + 1, tile.height)
    if col1 <= col0 or row1 <= row0:
        out = tile.window(0, 0, 0, 0)
        return dataclasses.replace(out, cell_id=int(cell_id))
    win = tile.window(col0, row0, col1 - col0, row1 - row0)
    inside = _ownership(win, res, grid, dev)[0] == cell_id
    out = _mask_fill(win, inside)
    return dataclasses.replace(out, cell_id=int(cell_id))


def _common_grid(tiles: Sequence[RasterTile]
                 ) -> Tuple[GeoTransform, int, int]:
    g0 = tiles[0].gt
    if g0.rot_x or g0.rot_y:
        raise ValueError("merge/combine requires north-up tiles "
                         "(project/resample first)")
    for t in tiles[1:]:
        if not (np.isclose(t.gt.px_w, g0.px_w) and
                np.isclose(t.gt.px_h, g0.px_h) and
                t.gt.rot_x == 0 and t.gt.rot_y == 0):
            raise ValueError("merge/combine requires equal pixel grids "
                             "(project/resample first)")
        # same phase too: origin offsets must be whole pixels, else
        # _paste_coords' rounding silently misregisters the tile
        ox = (t.gt.x0 - g0.x0) / g0.px_w
        oy = (t.gt.y0 - g0.y0) / g0.px_h
        if abs(ox - round(ox)) > 1e-6 or abs(oy - round(oy)) > 1e-6:
            raise ValueError("merge/combine requires grid-phase-aligned "
                             "tiles (origins offset by whole pixels); "
                             "project/resample first")
    xmin = min(t.bbox()[0] for t in tiles)
    ymin = min(t.bbox()[1] for t in tiles)
    xmax = max(t.bbox()[2] for t in tiles)
    ymax = max(t.bbox()[3] for t in tiles)
    gt = GeoTransform(xmin, g0.px_w, 0.0, ymax, 0.0, g0.px_h)
    w = int(round((xmax - xmin) / g0.px_w))
    h = int(round((ymax - ymin) / -g0.px_h))
    return gt, h, w


def _paste_coords(t: RasterTile, gt: GeoTransform) -> Tuple[int, int]:
    c, r = gt.to_raster(t.gt.x0, t.gt.y0)
    return int(round(c)), int(round(r))


def merge(tiles: Sequence[RasterTile]) -> RasterTile:
    """Mosaic aligned tiles; later tiles win where valid (reference:
    operator/merge/MergeRasters via gdalwarp)."""
    tiles = list(tiles)
    if not tiles:
        raise ValueError("merge of zero tiles")
    gt, h, w = _common_grid(tiles)
    bands = max(t.num_bands for t in tiles)
    out = np.full((bands, h, w), np.nan, _F)
    for t in tiles:
        c0, r0 = _paste_coords(t, gt)
        d = np.asarray(t.data, _F)
        m = t.valid_mask()
        sub = out[:t.num_bands, r0:r0 + t.height, c0:c0 + t.width]
        sub[m] = d[m]
    nd = _nodata_fill(tiles[0])
    if not math.isnan(nd):
        out = np.where(np.isnan(out), nd, out)
    return RasterTile(out, gt, nodata=tiles[0].nodata,
                      srid=tiles[0].srid, meta={"op": "merge"})


def combine_stack(tiles: Sequence[RasterTile]
                  ) -> Tuple[np.ndarray, GeoTransform]:
    """([T, bands, h, w] f64, its geotransform): the tiles pasted on their
    common grid, NaN where a tile has no valid pixel."""
    gt, h, w = _common_grid(tiles)
    bands = max(t.num_bands for t in tiles)
    stack = np.full((len(tiles), bands, h, w), np.nan, _F)
    for i, t in enumerate(tiles):
        c0, r0 = _paste_coords(t, gt)
        d = np.where(t.valid_mask(), np.asarray(t.data, _F), np.nan)
        stack[i, :t.num_bands, r0:r0 + t.height, c0:c0 + t.width] = d
    return stack, gt


def combine(tiles: Sequence[RasterTile], reducer: str = "avg",
            device: DeviceLike = None) -> RasterTile:
    """Per-pixel reduction across aligned overlapping tiles (reference:
    pixel/PixelCombineRasters.scala / CombineAVG.scala).  reducer in
    {avg, min, max, median, count, sum}; the reduction runs on ``device``
    (CUDA unless ``device="cpu"``) through ``ops.raster_combine``."""
    tiles = list(tiles)
    if not tiles:
        raise ValueError("combine of zero tiles")
    dev = resolve_device(device)
    stack, gt = combine_stack(tiles)
    out = raster_combine(torch.from_numpy(stack).to(dev), reducer)
    return RasterTile(out.cpu().numpy(), gt, nodata=None,
                      srid=tiles[0].srid, meta={"op": f"combine_{reducer}"})


def combine_avg(tiles: Sequence[RasterTile],
                device: DeviceLike = None) -> RasterTile:
    return combine(tiles, "avg", device)


def tessellate_raster(tile: RasterTile, res: int, grid: IndexSystem,
                      device: DeviceLike = None) -> List[RasterTile]:
    """Raster → one clipped tile per covering grid cell (reference:
    operator/retile/RasterTessellate.scala:30-57 — mosaicFill over the
    raster bbox, then getRasterForCell per chip).

    ONE ownership pass over every pixel center on ``device`` (CUDA unless
    ``device="cpu"``; the same +1e-6-px nudge and point_to_cell
    convention as clip_to_cell, so the partition is identical), then the
    pixels grouped by cell and one window per cell on the host.  The
    covering cell set IS unique(ownership): every pixel center lies in
    the raster bbox, so its cell intersects the bbox — no separate vector
    tessellation of the bbox is needed."""
    dev = resolve_device(device)
    own, _ = _ownership(tile, res, grid, dev)
    allowed, lo, hi, rows, cols = _group_by_cell(own)
    out = []
    for cell, a, z in zip(allowed, lo, hi):
        r0, r1 = int(rows[a:z].min()), int(rows[a:z].max()) + 1
        c0, c1 = int(cols[a:z].min()), int(cols[a:z].max()) + 1
        win = tile.window(c0, r0, c1 - c0, r1 - r0)
        inside = own[r0:r1, c0:c1] == cell
        t = dataclasses.replace(_mask_fill(win, inside),
                                cell_id=int(cell))
        if t.width and t.height and not t.is_empty():
            out.append(t)
    return out


def retile(tile: RasterTile, tile_w: int, tile_h: int) -> List[RasterTile]:
    """Fixed-size grid retiling (reference: operator/retile/ReTile.scala)."""
    out = []
    for r0 in range(0, tile.height, tile_h):
        for c0 in range(0, tile.width, tile_w):
            t = tile.window(c0, r0, tile_w, tile_h)
            if t.width and t.height:
                out.append(t)
    return out


def subdivide(tile: RasterTile, size_mb: float) -> List[RasterTile]:
    """Split recursively until every piece is under ``size_mb``
    (reference: operator/retile/BalancedSubdivision.scala:92 — the
    ingest-time memory bound, SURVEY P6)."""
    limit = int(size_mb * (1 << 20))
    if tile.memsize() <= limit or (tile.width <= 1 and tile.height <= 1):
        return [tile]
    halves = []
    if tile.width >= tile.height:
        m = tile.width // 2
        halves = [tile.window(0, 0, m, tile.height),
                  tile.window(m, 0, tile.width - m, tile.height)]
    else:
        m = tile.height // 2
        halves = [tile.window(0, 0, tile.width, m),
                  tile.window(0, m, tile.width, tile.height - m)]
    out = []
    for h in halves:
        out.extend(subdivide(h, size_mb))
    return out


def separate_bands(tile: RasterTile) -> List[RasterTile]:
    """reference: operator/separate/SeparateBands.scala"""
    return [tile.band(b) for b in range(tile.num_bands)]


def ndvi(tile: RasterTile, red_band: int, nir_band: int,
         device: DeviceLike = None) -> RasterTile:
    """(NIR - RED) / (NIR + RED) (reference: RST_NDVI via gdal_calc), as
    f64 torch ops on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    d = torch.tensor(np.asarray(tile.data, _F)[[red_band, nir_band]],
                     device=dev)
    m = tile.valid_mask()
    valid = torch.from_numpy(m[red_band] & m[nir_band]).to(dev)
    out = ndvi_body(d[0], d[1], valid)
    return RasterTile(out.cpu().numpy()[None], tile.gt, nodata=None,
                      srid=tile.srid, meta={"op": "ndvi"})


def ndvi_body(red: torch.Tensor, nir: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """:func:`ndvi`'s device work: (NIR - RED) / (NIR + RED) of two f64
    bands, NaN where the sum is 0 or ``valid`` (bool) is False."""
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=red.device)
    denom = nir + red
    out = torch.where(denom == 0, nan, (nir - red) / denom)
    return torch.where(valid, out, nan)


def convolve(tile: RasterTile, kernel: np.ndarray,
             device: DeviceLike = None) -> RasterTile:
    """2D convolution per band, zero-padded edges (reference:
    MosaicRasterGDAL.convolve:312 / GDALBlock+Padding halo logic), in f64
    on ``device`` (CUDA unless ``device="cpu"``) through
    ``ops.raster_convolve``: a SAME-padded cross-correlation, invalid
    pixels read as 0."""
    dev = resolve_device(device)
    k = torch.tensor(np.asarray(kernel, _F), device=dev)
    d = np.where(tile.valid_mask(), np.asarray(tile.data, _F), 0.0)
    out = raster_convolve(torch.from_numpy(d).to(dev), k)
    return RasterTile(out.cpu().numpy(), tile.gt, nodata=None,
                      srid=tile.srid, meta={"op": "convolve"})


def filter_tile(tile: RasterTile, size: int, op: str) -> RasterTile:
    """Sliding-window filter: avg/min/max/median/mode (reference:
    MosaicRasterGDAL.filter:347)."""
    if size % 2 != 1:
        raise ValueError("filter size must be odd")
    d = np.where(tile.valid_mask(), np.asarray(tile.data, _F), np.nan)
    pad = size // 2
    padded = np.pad(d, ((0, 0), (pad, pad), (pad, pad)),
                    constant_values=np.nan)
    windows = np.lib.stride_tricks.sliding_window_view(
        padded, (size, size), axis=(1, 2))    # [B, H, W, s, s]
    flat = windows.reshape(*windows.shape[:3], -1)
    with np.errstate(all="ignore"):
        if op == "avg":
            out = np.nanmean(flat, axis=-1)
        elif op == "min":
            out = np.nanmin(flat, axis=-1)
        elif op == "max":
            out = np.nanmax(flat, axis=-1)
        elif op == "median":
            out = np.nanmedian(flat, axis=-1)
        elif op == "mode":
            def mode1(v):
                v = v[~np.isnan(v)]
                if v.size == 0:
                    return np.nan
                vals, cnt = np.unique(v, return_counts=True)
                return vals[np.argmax(cnt)]
            out = np.apply_along_axis(mode1, -1, flat)
        else:
            raise ValueError(f"unknown filter op {op!r}")
    return RasterTile(out, tile.gt, nodata=None, srid=tile.srid,
                      meta={"op": f"filter_{op}"})


def map_algebra(tiles: Sequence[RasterTile], fn: Callable,
                device: DeviceLike = None) -> RasterTile:
    """Elementwise band math over aligned tiles (reference:
    gdal/GDALCalc.scala:32-58 — the python-subprocess gdal_calc; here a
    function of torch tensors): ``fn`` receives each tile's [bands, H, W]
    f64 data on ``device`` (CUDA unless ``device="cpu"``), NaN where it
    is not valid, and its result comes back as f64 numpy."""
    dev = resolve_device(device)
    arrs = [torch.from_numpy(np.where(t.valid_mask(),
                                      np.asarray(t.data, _F), np.nan)
                             ).to(dev)
            for t in tiles]
    out = torch.as_tensor(fn(*arrs)).cpu().numpy().astype(_F)
    if out.ndim == 2:
        out = out[None]
    # provenance stamp (reference: GDALCalc records last_command)
    cmd = f"map_algebra({getattr(fn, '__name__', repr(fn))}, " \
          f"{len(tiles)} tiles)"
    return RasterTile(out, tiles[0].gt, nodata=None, srid=tiles[0].srid,
                      meta={"op": "map_algebra", "last_command": cmd})


def resample(tile: RasterTile, factor_x: float,
             factor_y: float) -> RasterTile:
    """Nearest-neighbour resample by scale factors (reference:
    gdal/GDALTranslate-driven RST_UpdateType/size changes)."""
    nh = max(1, int(round(tile.height * factor_y)))
    nw = max(1, int(round(tile.width * factor_x)))
    rr = np.clip((np.arange(nh) / factor_y).astype(int), 0,
                 tile.height - 1)
    cc = np.clip((np.arange(nw) / factor_x).astype(int), 0,
                 tile.width - 1)
    data = np.asarray(tile.data)[:, rr][:, :, cc]
    return RasterTile(data, tile.gt.scaled(1.0 / factor_x, 1.0 / factor_y),
                      nodata=tile.nodata, srid=tile.srid, meta=tile.meta)


def warp(tile: RasterTile, to_epsg: int,
         method: str = "bilinear") -> RasterTile:
    """Reproject a tile to another CRS by inverse mapping.

    Reference: core/raster/operator/proj/RasterProject.scala:45
    (GDALWarp with target SRS).  Target grid: the source extent's
    projected bbox at a pixel size that preserves the source pixel
    count along each axis; every target pixel center inverse-maps
    through crs.transform_xy (exact f64 host math) and samples the
    source with bilinear (nodata-aware) or nearest interpolation — the
    gather/lerp runs as one vectorized pass.
    """
    from ..geometry.crs import transform_xy

    if to_epsg == tile.srid:
        return tile
    h, w = tile.height, tile.width
    # project a boundary sampling of the source extent for the bbox
    cs = np.linspace(0, w, 17)
    rs = np.linspace(0, h, 17)
    edge = np.concatenate([
        np.stack([cs, np.zeros_like(cs)], -1),
        np.stack([cs, np.full_like(cs, h)], -1),
        np.stack([np.zeros_like(rs), rs], -1),
        np.stack([np.full_like(rs, w), rs], -1)])
    ex, ey = tile.gt.to_world(edge[:, 0], edge[:, 1])
    proj = transform_xy(np.stack([ex, ey], -1), tile.srid, to_epsg)
    x0, x1 = proj[:, 0].min(), proj[:, 0].max()
    y0, y1 = proj[:, 1].min(), proj[:, 1].max()
    px = (x1 - x0) / w
    py = (y1 - y0) / h
    gt = GeoTransform(float(x0), float(px), 0.0, float(y1), 0.0,
                      float(-py))

    cols = np.arange(w) + 0.5
    rows = np.arange(h) + 0.5
    gx, gy = np.meshgrid(cols, rows)              # [h, w] target pixels
    tx, ty = gt.to_world(gx.ravel(), gy.ravel())
    src = transform_xy(np.stack([tx, ty], -1), to_epsg, tile.srid)
    sc, sr = tile.gt.to_raster(src[:, 0], src[:, 1])
    sc = sc.reshape(h, w) - 0.5                   # to pixel-center frame
    sr = sr.reshape(h, w) - 0.5

    data = np.asarray(tile.data, np.float64)
    fill = np.nan if tile.nodata is None else float(
        np.atleast_1d(tile.nodata)[0])
    inb = (sc > -0.5) & (sc < w - 0.5) & (sr > -0.5) & (sr < h - 0.5)

    if method == "nearest":
        ci = np.clip(np.round(sc).astype(int), 0, w - 1)
        ri = np.clip(np.round(sr).astype(int), 0, h - 1)
        out = data[:, ri, ci]
        out = np.where(inb[None], out, fill)
    elif method == "bilinear":
        c0 = np.clip(np.floor(sc).astype(int), 0, w - 1)
        r0 = np.clip(np.floor(sr).astype(int), 0, h - 1)
        c1 = np.clip(c0 + 1, 0, w - 1)
        r1 = np.clip(r0 + 1, 0, h - 1)
        fc = np.clip(sc - c0, 0.0, 1.0)
        fr = np.clip(sr - r0, 0.0, 1.0)
        v00 = data[:, r0, c0]
        v01 = data[:, r0, c1]
        v10 = data[:, r1, c0]
        v11 = data[:, r1, c1]
        if tile.nodata is not None:
            nd = float(np.atleast_1d(tile.nodata)[0])
            if np.isnan(nd):
                bad = (np.isnan(v00) | np.isnan(v01) | np.isnan(v10) |
                       np.isnan(v11))
            else:
                bad = ((v00 == nd) | (v01 == nd) | (v10 == nd) |
                       (v11 == nd))
        else:
            bad = np.zeros_like(v00, bool)
        out = (v00 * (1 - fc) * (1 - fr) + v01 * fc * (1 - fr) +
               v10 * (1 - fc) * fr + v11 * fc * fr)
        # any-nodata corner: fall back to nearest so nodata never bleeds
        ci = np.clip(np.round(sc).astype(int), 0, w - 1)
        ri = np.clip(np.round(sr).astype(int), 0, h - 1)
        out = np.where(bad, data[:, ri, ci], out)
        out = np.where(inb[None], out, fill)
    else:
        raise ValueError(f"unknown resample method {method!r}")
    meta = dict(tile.meta, warped_from=str(tile.srid),
                last_command=f"warp(to_epsg={to_epsg}, method={method})")
    return RasterTile(out, gt, nodata=tile.nodata if tile.nodata is not
                      None else np.nan, srid=to_epsg, meta=meta)


# ------------------------------------------------------------ rasterize

def rasterize(geoms: GeometryArray, values: np.ndarray,
              gt: GeoTransform, width: int, height: int,
              fill: float = np.nan, all_touched: bool = False
              ) -> RasterTile:
    """Burn geometries into a raster (reference:
    core/raster/operator/rasterize/GDALRasterize.scala:155).

    Pixel centers inside geometry i take values[i]; later geometries
    overwrite earlier ones (GDAL burn order).  all_touched additionally
    burns pixels whose center is within half a pixel diagonal of a
    geometry edge."""
    values = np.asarray(values, np.float64)
    cols = np.arange(width) + 0.5
    rows = np.arange(height) + 0.5
    gx, gy = np.meshgrid(cols, rows)
    wx, wy = gt.to_world(gx.ravel(), gy.ravel())
    pts = np.stack([wx, wy], -1)
    out = np.full(height * width, fill, np.float64)
    half_diag = 0.5 * math.hypot(gt.px_w, gt.px_h)
    for gi in range(len(geoms)):
        edges = _poly_edges(geoms, gi)
        if not len(edges):
            continue
        block = max(1, 8_000_000 // len(edges))
        for s0 in range(0, len(pts), block):
            pb = pts[s0:s0 + block]
            inside = _pip(pb, edges)
            if all_touched:
                # distance point->segment below half the pixel diagonal
                a = edges[None, :, 0]
                b = edges[None, :, 1]
                ap = pb[:, None, :] - a
                ab = b - a
                denom = np.maximum(np.sum(ab * ab, -1), 1e-300)
                t = np.clip(np.sum(ap * ab, -1) / denom, 0, 1)
                dd = np.linalg.norm(ap - t[..., None] * ab, axis=-1)
                inside |= dd.min(axis=1) <= half_diag
            out[s0:s0 + block][inside] = values[gi]
    return RasterTile(out.reshape(1, height, width), gt,
                      nodata=fill, srid=geoms.srid or 4326,
                      meta={"op": "rasterize"})


# ------------------------------------------------------- DTM from geoms

def _interpolate_z_grid(verts_xy: np.ndarray, verts_z: np.ndarray,
                        tri: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Vectorized barycentric z for many query points (NaN outside)."""
    out = np.full(len(pts), np.nan)
    if len(tri) == 0:
        return out
    a = verts_xy[tri[:, 0]]
    b = verts_xy[tri[:, 1]]
    c = verts_xy[tri[:, 2]]
    det = ((b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) +
           (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1]))
    det = np.where(det == 0, 1e-300, det)
    eps = 1e-12
    block = max(1, 8_000_000 // max(len(tri), 1))
    for s in range(0, len(pts), block):
        p = pts[s:s + block]
        w1 = ((b[:, 1] - c[:, 1])[None] * (p[:, 0:1] - c[:, 0][None]) +
              (c[:, 0] - b[:, 0])[None] * (p[:, 1:2] - c[:, 1][None])) \
            / det[None]
        w2 = ((c[:, 1] - a[:, 1])[None] * (p[:, 0:1] - c[:, 0][None]) +
              (a[:, 0] - c[:, 0])[None] * (p[:, 1:2] - c[:, 1][None])) \
            / det[None]
        w3 = 1.0 - w1 - w2
        hit = (w1 >= -eps) & (w2 >= -eps) & (w3 >= -eps)
        first = hit.argmax(axis=1)
        any_hit = hit.any(axis=1)
        idx = np.arange(len(p))
        t = first
        z = (w1[idx, t] * verts_z[tri[t, 0]] +
             w2[idx, t] * verts_z[tri[t, 1]] +
             w3[idx, t] * verts_z[tri[t, 2]])
        out[s:s + block] = np.where(any_hit, z, np.nan)
    return out


def dtm_from_geoms(points_xyz: np.ndarray, gt: GeoTransform,
                   width: int, height: int,
                   constraints: Optional[np.ndarray] = None
                   ) -> RasterTile:
    """Digital terrain model: Delaunay-triangulate elevation points and
    rasterize barycentric-interpolated z (reference:
    expressions/raster/RST_DTMFromGeoms.scala — triangulate + GDAL
    rasterize of the TIN).  NaN outside the convex hull."""
    from ..geometry.triangulate import conforming_delaunay, delaunay

    pts = np.asarray(points_xyz, np.float64)
    if constraints is not None and len(constraints):
        verts, tri = conforming_delaunay(pts[:, :2], constraints)
    else:
        verts, tri = delaunay(pts[:, :2])
    # triangulation dedupes/reorders vertices (and conforming adds
    # Steiner points): z of each output vertex = z of the nearest input
    # point (exact for true vertices)
    d2 = np.sum((verts[:, None, :] - pts[None, :, :2]) ** 2, axis=-1)
    z = pts[np.argmin(d2, axis=1), 2]
    cols = np.arange(width) + 0.5
    rows = np.arange(height) + 0.5
    gx, gy = np.meshgrid(cols, rows)
    wx, wy = gt.to_world(gx.ravel(), gy.ravel())
    q = np.stack([wx, wy], -1)
    zz = _interpolate_z_grid(verts, z, tri, q)
    return RasterTile(zz.reshape(1, height, width), gt, nodata=np.nan,
                      meta={"op": "dtm_from_geoms"})
