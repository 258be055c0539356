"""Raster stencils in row slabs with halo rows: the single-device form.

Port of ``mosaic_tpu.parallel.raster_halo``.  The JAX package shards a
tile's rows over a mesh axis and widens each slab by two ``ppermute``
halo shifts before an f32 stencil.  The port runs a world of one: the
``mesh, axis`` arguments become an optional ``torch.distributed``
process group, ``None`` meaning one device, and a group of more than one
rank raises ``NotImplementedError`` until the multi-chip slice (ROADMAP
§A4).  On one device the slab is the whole tile and both halos are zero
rows, so the body is the f32 instance of the stencil kernel
(``ops/raster_convolve.py``) on the tile, SAME-padded with zeros.

Reference counterpart: the GDALBlock + Padding machinery
(core/raster/gdal/GDALBlock.scala) that the reference uses to run
stencil operators over tiled rasters — each block reads a halo of
neighbouring pixels so window operators are exact at block seams.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.raster.tile import RasterTile
from ..ops.raster_convolve import raster_convolve
from ..perf.pipeline import stream

__all__ = ["sharded_convolve", "sharded_convolve_stream"]


def _group_size(group) -> int:
    """Ranks of ``group`` (None: one device); more than one raises."""
    if group is None:
        return 1
    import torch.distributed as dist
    size = dist.get_world_size(group)
    if size > 1:
        raise NotImplementedError(
            f"raster_halo over {size} ranks: the multi-slab halo exchange "
            "comes with the multi-chip slice (ROADMAP §A4); pass "
            "group=None (one device)")
    return size


def _convolve_fn(kernel: np.ndarray, group, shape, device: torch.device):
    """Validate and return the f32 stencil for tiles of ``shape`` =
    (bands, H, W): a function of a [bands, H, W] f32 tensor on
    ``device``."""
    k = np.asarray(kernel, np.float64)
    kh, kw = k.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("sharded_convolve requires odd kernel dims "
                         "(same-shape output)")
    halo = kh // 2
    D = _group_size(group)
    bands, H, W = shape
    if H % D != 0:
        raise ValueError(f"the group size {D} must divide the "
                         f"tile height {H} (retile or pad first)")
    if H // D < halo:
        raise ValueError(f"slab height {H // D} smaller than the "
                         f"kernel halo {halo}")
    w = torch.from_numpy(k.astype(np.float32)).to(device)
    return lambda x: raster_convolve(x, w)


def _masked_f32(tile: RasterTile) -> np.ndarray:
    """The tile's data in f32, invalid pixels 0."""
    return np.where(tile.valid_mask(), np.asarray(tile.data, np.float32),
                    np.float32(0.0))


def sharded_convolve(tile: RasterTile, kernel: np.ndarray, group=None,
                     device: DeviceLike = None) -> RasterTile:
    """``rops.convolve`` in f32 over row slabs with halo rows; on one
    device (``group`` None or of one rank) the whole tile with zero
    halos, on ``device`` (CUDA unless ``device="cpu"``).

    The group size must divide the tile's height (callers can retile or
    pad; keeping the constraint explicit avoids silently uneven slabs)."""
    dev = resolve_device(device)
    fn = _convolve_fn(kernel, group, tile.data.shape, dev)
    out = fn(torch.from_numpy(_masked_f32(tile)).to(dev))
    return RasterTile(out.cpu().numpy(), tile.gt, nodata=None,
                      srid=tile.srid, meta={"op": "convolve",
                                            "sharded": "halo"})


def sharded_convolve_stream(tiles, kernel: np.ndarray, group=None,
                            device: DeviceLike = None) -> list:
    """Convolve MANY same-shaped tiles with upload/compute overlap.

    One stencil serves the whole batch; ``perf.pipeline.stream`` stages
    and uploads tile N+1 on a side stream while the kernel runs on tile
    N, and hands back tile N-1's result.  Returns the output
    :class:`RasterTile` list in input order."""
    dev = resolve_device(device)
    tiles = list(tiles)
    if not tiles:
        return []
    shape = tiles[0].data.shape
    for t in tiles[1:]:
        if t.data.shape != shape:
            raise ValueError(
                f"sharded_convolve_stream needs same-shaped tiles "
                f"(got {t.data.shape} after {shape}); group by shape "
                "first")
    fn = _convolve_fn(kernel, group, shape, dev)
    width = int(np.prod(shape))
    out = [None] * len(tiles)

    def stage(sl, buf):
        # one tile a chunk, flattened into one row
        buf[0] = _masked_f32(tiles[sl.start]).ravel()

    def compute(i, x):
        return (fn(x.view(shape)).view(1, width),)

    def consume(i, sl, host):
        t = tiles[i]
        out[i] = RasterTile(host[0].reshape(shape).copy(), t.gt,
                            nodata=None, srid=t.srid,
                            meta={"op": "convolve", "sharded": "halo"})

    stream([slice(i, i + 1) for i in range(len(tiles))], stage, width,
           compute, consume, dev)
    return out
