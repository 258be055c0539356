"""Raster tile serialization: bytes through the wire, or checkpoint paths.

Port copy of ``mosaic_tpu.core.raster.checkpoint``, with its host
planes: the checkpoint file's write and read are the ``checkpoint.write``
and ``checkpoint.read`` fault sites and run under ``CHECKPOINT_RETRY``,
so a transient volume hiccup retries with backoff instead of failing
the batch.

Reference counterparts: core/types/RasterTileType.scala:31-37 (the tile
struct's raster field switches BinaryType <-> StringType path depending
on checkpointing) and gdal/MosaicGDAL.scala:135-234 (driver-side
checkpoint dir management: enable/disable, set path, update).  The conf
keys in config.py carried this switch since round 1; this module makes
them real: with ``raster_use_checkpoint`` on, serialized tiles spill
GeoTIFF files into ``raster_checkpoint`` (content-hashed names, atomic
rename) and the wire record carries only the path.

The wire record is a plain dict — the columnar analogue of the
reference's InternalRow(index_id, raster, metadata).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Optional

from ... import config as _config
from ...resilience import faults
from ...resilience.retry import CHECKPOINT_RETRY
from .gtiff import read_gtiff, write_gtiff
from .tile import RasterTile

__all__ = ["serialize_tile", "deserialize_tile", "enable_checkpoint",
           "disable_checkpoint", "set_checkpoint_dir", "checkpoint_dir",
           "is_checkpoint_enabled"]


# ------------------------------------------------- management (driver side)

def enable_checkpoint(path: Optional[str] = None) -> None:
    """Turn path-mode serialization on (reference:
    MosaicGDAL.enableGDALWithCheckpoint)."""
    cfg = _config.default_config()
    _config.set_default_config(dataclasses.replace(
        cfg, raster_use_checkpoint=True,
        raster_checkpoint=path or cfg.raster_checkpoint))


def disable_checkpoint() -> None:
    _config.set_default_config(dataclasses.replace(
        _config.default_config(), raster_use_checkpoint=False))


def set_checkpoint_dir(path: str) -> None:
    _config.set_default_config(dataclasses.replace(
        _config.default_config(), raster_checkpoint=path))


def checkpoint_dir() -> str:
    return _config.default_config().raster_checkpoint


def is_checkpoint_enabled() -> bool:
    return _config.default_config().raster_use_checkpoint


# ------------------------------------------------------------ wire format

def serialize_tile(tile: RasterTile,
                   cfg: Optional[_config.MosaicConfig] = None) -> dict:
    """RasterTile -> wire record {cell_id, raster, metadata}.

    raster is GeoTIFF bytes, or (checkpoint mode) a path to a GeoTIFF
    written under the checkpoint dir — content-hashed name, atomic
    rename, so concurrent writers of the same tile are idempotent and a
    crash never leaves a partial file behind a valid name."""
    cfg = cfg or _config.default_config()
    payload = write_gtiff(tile)
    # a stale path from an earlier round trip must never survive: the
    # tile content may have changed since that file was written
    meta = {k: v for k, v in tile.meta.items() if k != "checkpoint_path"}
    if not cfg.raster_use_checkpoint:
        return {"cell_id": tile.cell_id, "raster": payload,
                "metadata": meta}
    os.makedirs(cfg.raster_checkpoint, exist_ok=True)
    name = hashlib.sha256(payload).hexdigest()[:24] + ".tif"
    path = os.path.join(cfg.raster_checkpoint, name)
    if not os.path.exists(path):
        def _write():
            faults.maybe_fail("checkpoint.write")
            fd, tmp = tempfile.mkstemp(dir=cfg.raster_checkpoint,
                                       suffix=".tmp")
            os.close(fd)
            try:
                with open(tmp, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        CHECKPOINT_RETRY.call(_write)
    meta["checkpoint_path"] = path
    return {"cell_id": tile.cell_id, "raster": path, "metadata": meta}


def deserialize_tile(rec: dict) -> RasterTile:
    """Wire record -> RasterTile (reads back through the codec either
    way, so both modes exercise the same decode path)."""
    raster = rec["raster"]
    if isinstance(raster, (bytes, bytearray)):
        tile = read_gtiff(bytes(raster))
    else:
        def _read():
            faults.maybe_fail("checkpoint.read")
            with open(raster, "rb") as f:
                return f.read()
        tile = read_gtiff(CHECKPOINT_RETRY.call(_read), path=raster)
    return dataclasses.replace(
        tile, cell_id=rec.get("cell_id"),
        meta=dict(tile.meta, **rec.get("metadata", {})))
