"""Raster stencils in row slabs with halo rows.

Port of ``mosaic_tpu.parallel.raster_halo``.  The JAX package shards a
tile's rows over a mesh axis and widens each slab by two ``ppermute``
halo shifts before an f32 stencil.  Here the ``mesh, axis`` arguments
become an optional ``torch.distributed`` process group, ``None`` meaning
one device.  Over a group of D ranks, every rank holding the same tile,
rank r uploads rows [r H / D, (r + 1) H / D), receives the ``halo``
rows above and below its slab from its neighbours in one
``batch_isend_irecv`` (zero rows past the first and last rank, the
single-device operator's zero padding), runs the f32 instance of the
stencil kernel (``ops/raster_convolve.py``) on the widened slab, SAME in
columns, crops the halo rows and gathers every rank's slab.  An interior
pixel's taps read the same values in the same order as on the whole
tile, so the result equals the one-device call bit for bit.  On one
device the slab is the whole tile and both halos are zero rows.  Both
entry points run under ``root_trace("raster_halo")`` and the JAX
package's ``halo/convolve`` and ``halo/convolve_stream`` spans.

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
from ..obs import metrics, tracer
from ..obs.context import root_trace
from ..ops.raster_convolve import raster_convolve
from ..perf.pipeline import stream
from . import collectives as coll

__all__ = ["sharded_convolve", "sharded_convolve_stream"]


def _convolve_fn(kernel: np.ndarray, group, shape, device: torch.device):
    """Validate and return (the f32 stencil, this rank's rows) for tiles
    of ``shape`` = (bands, H, W): the stencil takes this rank's [bands,
    H / D, W] f32 slab on ``device`` and returns the whole [bands, H, W]
    output."""
    k = np.asarray(kernel, np.float64)
    kh, kw = k.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("sharded_convolve requires odd kernel dims "
                         "(same-shape output)")
    halo = kh // 2
    D, r = coll.group_size(group), coll.group_rank(group)
    bands, H, W = shape
    if H % D != 0:
        raise ValueError(f"the group size {D} must divide the "
                         f"tile height {H} (retile or pad first)")
    S = H // D
    if S < halo:
        raise ValueError(f"slab height {S} smaller than the "
                         f"kernel halo {halo}")
    w = torch.from_numpy(k.astype(np.float32)).to(device)
    if D == 1:
        return (lambda x: raster_convolve(x, w)), slice(0, H)

    def fn(slab: torch.Tensor) -> torch.Tensor:
        sent = coll.COUNTS["p2p"][1]
        above, below = coll.exchange_halo(slab, halo, group)
        _count_halo_bytes(coll.COUNTS["p2p"][1] - sent)
        out = raster_convolve(torch.cat([above, slab, below], dim=1), w)
        mine = out[:, halo:halo + S].transpose(0, 1).contiguous()
        return coll.all_gather(mine, group).transpose(0, 1)

    return fn, slice(r * S, (r + 1) * S)


def _count_halo_bytes(nbytes: int) -> None:
    """The halo exchange's collective accounting under the JAX package's
    names: ``collective/ppermute_bytes`` and its ``/raster_halo`` counter
    take the bytes this rank sent (``collectives.COUNTS["p2p"]``), and
    ``collective/ppermute_calls`` the exchange's two shifts, as the JAX
    package counts its two ``ppermute`` calls a tile on every rank.
    Summed over the D ranks the bytes are ``2 (D - 1) bands halo W 4``
    where the JAX package counts ``2 D bands halo W 4``: its ``ppermute``
    shifts a zero halo past the first and last slab too, the port sends
    nothing there (and on a group of one never exchanges).  One attribute
    check when metrics are disabled."""
    if metrics.enabled:
        metrics.count("collective/ppermute_bytes", float(nbytes))
        metrics.count("collective/ppermute_bytes/raster_halo",
                      float(nbytes))
        metrics.count("collective/ppermute_calls", 2.0)


def _masked_f32(tile: RasterTile) -> np.ndarray:
    """The tile's data in f32, invalid pixels 0."""
    return np.where(tile.valid_mask(), np.asarray(tile.data, np.float32),
                    np.float32(0.0))


def sharded_convolve(tile: RasterTile, kernel: np.ndarray, group=None,
                     device: DeviceLike = None) -> RasterTile:
    """``rops.convolve`` in f32 over row slabs with halo rows, on
    ``device`` (CUDA unless ``device="cpu"``): over a ``group`` each rank
    convolves its slab, on one device (``group`` None or of one rank) the
    whole tile with zero halos.  Every rank returns the whole tile.

    The group size must divide the tile's height (callers can retile or
    pad; keeping the constraint explicit avoids silently uneven slabs)."""
    dev = resolve_device(device)
    fn, rows = _convolve_fn(kernel, group, tile.data.shape, dev)
    x = torch.from_numpy(_masked_f32(tile)[:, rows]).to(dev)
    with root_trace("raster_halo"), tracer.span("halo/convolve"):
        out = fn(x).cpu().numpy()
    return RasterTile(out, tile.gt, nodata=None,
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
    fn, rows = _convolve_fn(kernel, group, shape, dev)
    slab = (shape[0], rows.stop - rows.start, shape[2])
    width = int(np.prod(shape))
    out = [None] * len(tiles)

    def stage(sl, buf):
        # one tile a chunk: this rank's slab, flattened into one row
        buf[0] = _masked_f32(tiles[sl.start])[:, rows].ravel()

    def compute(i, x):
        return (fn(x.view(slab)).reshape(1, width),)

    def consume(i, sl, host):
        t = tiles[i]
        out[i] = RasterTile(host[0].reshape(shape).copy(), t.gt,
                            nodata=None, srid=t.srid,
                            meta={"op": "convolve", "sharded": "halo"})

    with root_trace("raster_halo"), tracer.span("halo/convolve_stream"):
        stream([slice(i, i + 1) for i in range(len(tiles))], stage,
               int(np.prod(slab)), compute, consume, dev,
               site="raster_halo/stream", split=False)
    return out
