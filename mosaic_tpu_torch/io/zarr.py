"""Zarr v2 codec: chunked-array store reader/writer, pure Python.

Port copy of ``mosaic_tpu.io.zarr`` (pure Python and numpy).

Reference counterpart: the GDAL Zarr driver (zarr-example is a
first-class reference test fixture, src/test/resources/binary/
zarr-example).  A Zarr v2 array is a directory (or zip) of chunk files
plus a ``.zarray`` JSON descriptor; supported compressors here: none
and zlib (the stdlib one — blosc is not in this image and raises a
clear error).

Each array in a group maps to a RasterTile; ``.zattrs`` keys
``geotransform`` (6 numbers) and ``srid`` are honoured when present.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional

import numpy as np

from ..core.raster.tile import GeoTransform, RasterTile

__all__ = ["read_zarr", "write_zarr", "zarr_subdatasets"]


def _store_from_path(path: str) -> Dict[str, bytes]:
    store = {}
    if os.path.isdir(path):
        for root, _, files in os.walk(path):
            for f in files:
                full = os.path.join(root, f)
                key = os.path.relpath(full, path).replace(os.sep, "/")
                with open(full, "rb") as fh:
                    store[key] = fh.read()
    elif path.endswith(".zip"):
        import zipfile
        with zipfile.ZipFile(path) as z:
            for n in z.namelist():
                if not n.endswith("/"):
                    store[n] = z.read(n)
    else:
        raise ValueError(f"{path}: not a zarr directory or zip")
    return store


def _decode_chunk(raw: bytes, meta: dict) -> np.ndarray:
    comp = meta.get("compressor")
    if comp is None:
        data = raw
    elif comp.get("id") == "zlib":
        data = zlib.decompress(raw)
    else:
        raise ValueError(f"unsupported zarr compressor {comp.get('id')}"
                         " (none/zlib only; blosc unavailable)")
    arr = np.frombuffer(data, meta["dtype"])
    return arr.reshape(meta["chunks"], order=meta.get("order", "C"))


def _read_array(store: Dict[str, bytes], prefix: str) -> np.ndarray:
    meta = json.loads(store[prefix + ".zarray"])
    if meta.get("zarr_format") != 2:
        raise ValueError("only zarr v2 supported")
    shape = meta["shape"]
    chunks = meta["chunks"]
    fill = meta.get("fill_value", 0)
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, fill if fill is not None else 0,
                  np.dtype(meta["dtype"]))
    grid = [(s + c - 1) // c for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = prefix + sep.join(str(i) for i in idx)
        if key not in store:
            continue
        chunk = _decode_chunk(store[key], meta)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        chunk_sl = tuple(slice(0, s.stop - s.start) for s in sl)
        out[sl] = chunk[chunk_sl]
    return out


def read_zarr(path: str) -> Dict[str, RasterTile]:
    """Zarr store (directory or zip) -> {array_name: RasterTile}."""
    store = _store_from_path(path)
    names = sorted({k[:-len(".zarray")].rstrip("/")
                    for k in store if k.endswith(".zarray")})
    out = {}
    for name in names:
        prefix = name + "/" if name else ""
        arr = _read_array(store, prefix).astype(np.float64)
        if arr.ndim < 2:
            continue
        arr = arr.reshape(-1, arr.shape[-2], arr.shape[-1])
        attrs = {}
        if prefix + ".zattrs" in store:
            attrs = json.loads(store[prefix + ".zattrs"])
        gt = GeoTransform.from_tuple(attrs.get(
            "geotransform", (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)))
        out[name or "array"] = RasterTile(
            arr, gt, nodata=attrs.get("nodata"),
            srid=int(attrs.get("srid", 4326)),
            meta={"driver": "zarr", "variable": name or "array"})
    for t in out.values():
        t.meta["subdatasets"] = ",".join(sorted(out))
    return out


def zarr_subdatasets(path: str):
    return sorted(read_zarr(path))


def write_zarr(path: str, arrays: Dict[str, np.ndarray],
               chunks: Optional[tuple] = None,
               geotransform: Optional[tuple] = None,
               compress: bool = True) -> None:
    """Write arrays as a Zarr v2 group directory (zlib compressor)."""
    os.makedirs(path, exist_ok=True)
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        adir = os.path.join(path, name)
        os.makedirs(adir, exist_ok=True)
        ch = list(chunks or arr.shape)
        meta = {
            "zarr_format": 2, "shape": list(arr.shape), "chunks": ch,
            "dtype": arr.dtype.str, "order": "C", "fill_value": 0,
            "filters": None,
            "compressor": {"id": "zlib", "level": 6} if compress
            else None,
        }
        with open(os.path.join(adir, ".zarray"), "w") as f:
            json.dump(meta, f)
        if geotransform is not None:
            with open(os.path.join(adir, ".zattrs"), "w") as f:
                json.dump({"geotransform": list(geotransform)}, f)
        grid = [(s + c - 1) // c for s, c in zip(arr.shape, ch)]
        for idx in np.ndindex(*grid):
            sl = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, ch, arr.shape))
            chunk = np.zeros(ch, arr.dtype)
            sub = arr[sl]
            chunk[tuple(slice(0, x.stop - x.start) for x in sl)] = sub
            raw = chunk.tobytes(order="C")
            if compress:
                raw = zlib.compress(raw, 6)
            with open(os.path.join(
                    adir, ".".join(str(i) for i in idx)), "wb") as f:
                f.write(raw)
