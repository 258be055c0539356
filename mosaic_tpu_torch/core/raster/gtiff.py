"""Pure-numpy GeoTIFF codec — the raster ingest/egress path.

Port copy of ``mosaic_tpu.core.raster.gtiff``: the same bytes out and
the same tiles in, with the same ``on_error`` contract.  Left out: the
JAX package's ``@traced`` span and its ``faults`` probes (``gtiff.read``,
``gtiff.read_strip``), which come with the port's host planes.

Reference counterpart: the GDAL GTiff driver reached through
core/raster/api/GDAL.scala:117 (readRaster) / :172 (writeRasters) and
MosaicRasterGDAL's companion RasterReader (:706-828).  The reference
shells into libgdal; here the format is decoded directly into numpy —
no native dependency.

Scope (SURVEY.md §7 "Raster codecs: scope to GTiff first"): baseline
TIFF, little/big endian, striped or tiled, uncompressed / Deflate /
PackBits, the numeric sample types, band-sequential or interleaved, plus
the GeoTIFF tags (pixel scale, tiepoint, EPSG code) and GDAL's nodata
tag.  Unsupported features raise a clear error naming the feature.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...resilience.ingest import ErrorSink, decode_guard
from .tile import GeoTransform, RasterTile

__all__ = ["read_gtiff", "write_gtiff"]

# TIFF tag ids
_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_PLANAR = 284
_TAG_PREDICTOR = 317
_TAG_TILE_WIDTH = 322
_TAG_TILE_HEIGHT = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_COUNTS = 325
_TAG_SAMPLE_FORMAT = 339
_TAG_MODEL_PIXEL_SCALE = 33550
_TAG_MODEL_TIEPOINT = 33922
_TAG_MODEL_TRANSFORM = 34264
_TAG_GEO_KEYS = 34735
_TAG_GDAL_NODATA = 42113

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q", 2: "s", 7: "s"}


def _dtype_of(bits: int, fmt: int, byteorder: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(fmt, "u")
    if kind == "f" and bits not in (32, 64):
        raise ValueError(f"unsupported float{bits} GeoTIFF sample")
    if bits not in (8, 16, 32, 64):
        raise ValueError(f"unsupported {bits}-bit GeoTIFF sample")
    return np.dtype(f"{byteorder}{kind}{bits // 8}")


def _read_ifd_entries(buf: bytes, off: int, bo: str,
                      ) -> Tuple[Dict[int, tuple], int]:
    (n,) = struct.unpack_from(bo + "H", buf, off)
    entries = {}
    p = off + 2
    for _ in range(n):
        tag, typ, cnt = struct.unpack_from(bo + "HHI", buf, p)
        size = _TYPE_SIZES.get(typ, 1) * cnt
        if size <= 4:
            raw = buf[p + 8:p + 8 + size]
        else:
            (voff,) = struct.unpack_from(bo + "I", buf, p + 8)
            raw = buf[voff:voff + size]
        entries[tag] = (typ, cnt, raw)
        p += 12
    (nxt,) = struct.unpack_from(bo + "I", buf, p)
    return entries, nxt


def _values(entry, bo: str):
    typ, cnt, raw = entry
    fmt = _TYPE_FMT.get(typ)
    if fmt == "s":
        return raw
    if fmt is None:
        raise ValueError(f"unsupported TIFF field type {typ}")
    if typ == 5:        # RATIONAL
        vals = struct.unpack_from(bo + "II" * cnt, raw)
        return [vals[2 * i] / max(vals[2 * i + 1], 1)
                for i in range(cnt)]
    return list(struct.unpack_from(bo + fmt * cnt, raw))


def _unpackbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _undo_predictor(arr: np.ndarray, predictor: int) -> np.ndarray:
    if predictor == 2:          # horizontal differencing
        return np.cumsum(arr, axis=-1, dtype=arr.dtype)
    if predictor == 3:
        raise ValueError("floating-point predictor not supported")
    return arr


def _epsg_from_geokeys(entry, bo: str) -> Optional[int]:
    vals = _values(entry, bo)
    # GeoKeyDirectory: header of 4 shorts then (key, loc, cnt, value)*.
    # A projected raster commonly carries BOTH ProjectedCSTypeGeoKey
    # (3072) and the underlying GeographicTypeGeoKey (2048); the
    # projected code governs the pixel coordinates, so it wins.
    geographic = projected = None
    for i in range(4, len(vals) - 3, 4):
        key, loc, cnt, val = vals[i:i + 4]
        if loc != 0:
            continue
        if key == 3072:
            projected = int(val)
        elif key == 2048:
            geographic = int(val)
    return projected if projected is not None else geographic


def read_gtiff(data: bytes, on_error: Optional[str] = None,
               path: Optional[str] = None) -> RasterTile:
    """Decode GeoTIFF bytes into a RasterTile (reference entry:
    GDAL.readRaster, core/raster/api/GDAL.scala:117).

    ``on_error`` (default: ``MosaicConfig.io_on_error``) governs
    malformed strips/tiles: ``"raise"`` fails fast with a located
    ``CodecError``; ``"skip"`` leaves the damaged region zeroed;
    ``"null"`` fills it with the nodata value (NaN for float samples
    without one).  Dropped regions are stamped into
    ``tile.meta["decode_errors"]``.  ``path`` is advisory error
    context only (the payload always arrives as bytes)."""
    sink = ErrorSink(on_error, driver="gtiff", path=path)
    if len(data) < 8:
        raise ValueError("not a TIFF: truncated header")
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("not a TIFF: bad byte-order mark")
    (magic,) = struct.unpack_from(bo + "H", data, 2)
    if magic == 43:
        raise ValueError("BigTIFF not supported (use tiled windows "
                         "< 4GB per file)")
    if magic != 42:
        raise ValueError(f"not a TIFF: magic {magic}")
    # the IFD is load-bearing for the whole file — header damage is
    # never skippable, but it must surface located, not as struct.error
    with decode_guard(path=path, feature="IFD"):
        (ifd_off,) = struct.unpack_from(bo + "I", data, 4)
        tags, _ = _read_ifd_entries(data, ifd_off, bo)

        def val(tag, default=None):
            if tag not in tags:
                return default
            v = _values(tags[tag], bo)
            return v

        width = int(val(_TAG_WIDTH)[0])
        height = int(val(_TAG_HEIGHT)[0])
        spp = int(val(_TAG_SAMPLES_PER_PIXEL, [1])[0])
        bits = val(_TAG_BITS, [8])
        fmtv = val(_TAG_SAMPLE_FORMAT, [1] * spp)
        comp = int(val(_TAG_COMPRESSION, [1])[0])
        planar = int(val(_TAG_PLANAR, [1])[0])
        predictor = int(val(_TAG_PREDICTOR, [1])[0])
    if comp not in (1, 8, 32773, 32946):
        raise ValueError(f"unsupported TIFF compression {comp} "
                         "(supported: none, deflate, packbits)")
    if len(set(bits)) != 1 or len(set(fmtv)) != 1:
        raise ValueError("mixed per-band sample types not supported")
    dt = _dtype_of(int(bits[0]), int(fmtv[0]), bo)

    def decode(chunk: bytes, nbytes: int) -> bytes:
        if comp in (8, 32946):
            return zlib.decompress(chunk)
        if comp == 32773:
            return _unpackbits(chunk, nbytes)
        return chunk

    nodata = None
    if _TAG_GDAL_NODATA in tags:
        txt = val(_TAG_GDAL_NODATA).split(b"\x00")[0]
        try:
            nodata = float(txt)
        except ValueError:
            nodata = None
    # null-mode fill for a dropped strip/tile region
    if nodata is not None:
        fill = dt.type(nodata)
    else:
        fill = np.nan if dt.kind == "f" else 0

    out = np.zeros((spp, height, width), dt.newbyteorder("="))

    if _TAG_TILE_OFFSETS in tags:
        tw = int(val(_TAG_TILE_WIDTH)[0])
        th = int(val(_TAG_TILE_HEIGHT)[0])
        offs = val(_TAG_TILE_OFFSETS)
        cnts = val(_TAG_TILE_COUNTS)
        tiles_x = (width + tw - 1) // tw
        tiles_y = (height + th - 1) // th
        per_plane = tiles_x * tiles_y
        for ti, (o, c) in enumerate(zip(offs, cnts)):
            plane = ti // per_plane if planar == 2 else 0
            idx = ti % per_plane if planar == 2 else ti
            ty, tx = divmod(idx, tiles_x)
            y0, x0 = ty * th, tx * tw
            hh = min(th, height - y0)
            ww = min(tw, width - x0)
            nb = tw * th * dt.itemsize * (spp if planar == 1 else 1)
            chunk = data[o:o + c]
            try:
                with decode_guard(path=path, feature=f"tile {ti}",
                                  offset=o):
                    raw = decode(chunk, nb)
                    if planar == 1:
                        arr = np.frombuffer(raw, dt,
                                            count=tw * th * spp)
                        arr = arr.reshape(th, tw, spp)
                        if predictor == 2:
                            # differencing is per component along the
                            # pixel axis
                            arr = np.cumsum(arr, axis=1,
                                            dtype=arr.dtype)
                        arr = np.moveaxis(arr, -1, 0)
                    else:
                        arr = np.frombuffer(raw, dt, count=tw * th)
                        arr = arr.reshape(1, th, tw)
                        if predictor == 2:
                            arr = _undo_predictor(arr, predictor)
            except ValueError as e:
                sink.handle(e)
                if sink.on_error == "null":
                    if planar == 1:
                        out[:, y0:y0 + hh, x0:x0 + ww] = fill
                    else:
                        out[plane, y0:y0 + hh, x0:x0 + ww] = fill
                continue
            if planar == 1:
                out[:, y0:y0 + hh, x0:x0 + ww] = arr[:, :hh, :ww]
            else:
                out[plane, y0:y0 + hh, x0:x0 + ww] = arr[0, :hh, :ww]
    else:
        offs = val(_TAG_STRIP_OFFSETS)
        cnts = val(_TAG_STRIP_COUNTS)
        rps = int(val(_TAG_ROWS_PER_STRIP, [height])[0])
        strips_per_plane = (height + rps - 1) // rps
        for si, (o, c) in enumerate(zip(offs, cnts)):
            plane = si // strips_per_plane if planar == 2 else 0
            idx = si % strips_per_plane if planar == 2 else si
            y0 = idx * rps
            nrows = min(rps, height - y0)
            nb = nrows * width * dt.itemsize * (spp if planar == 1 else 1)
            chunk = data[o:o + c]
            try:
                with decode_guard(path=path, feature=f"strip {si}",
                                  offset=o):
                    raw = decode(chunk, nb)
                    if planar == 1:
                        arr = np.frombuffer(raw, dt,
                                            count=nrows * width * spp)
                        arr = arr.reshape(nrows, width, spp)
                        if predictor == 2:
                            # differencing is per component along the
                            # pixel axis
                            arr = np.cumsum(arr, axis=1,
                                            dtype=arr.dtype)
                        arr = np.moveaxis(arr, -1, 0)
                    else:
                        arr = np.frombuffer(raw, dt,
                                            count=nrows * width)
                        arr = arr.reshape(1, nrows, width)
                        if predictor == 2:
                            arr = _undo_predictor(arr, 2)
            except ValueError as e:
                sink.handle(e)
                if sink.on_error == "null":
                    if planar == 1:
                        out[:, y0:y0 + nrows] = fill
                    else:
                        out[plane, y0:y0 + nrows] = fill
                continue
            if planar == 1:
                out[:, y0:y0 + nrows] = arr
            else:
                out[plane, y0:y0 + nrows] = arr[0]

    # geo referencing
    if _TAG_MODEL_TRANSFORM in tags:
        m = val(_TAG_MODEL_TRANSFORM)
        gt = GeoTransform(m[3], m[0], m[1], m[7], m[4], m[5])
    elif _TAG_MODEL_PIXEL_SCALE in tags and _TAG_MODEL_TIEPOINT in tags:
        sx, sy = val(_TAG_MODEL_PIXEL_SCALE)[:2]
        tp = val(_TAG_MODEL_TIEPOINT)
        # tiepoint: raster (i, j, k) -> world (x, y, z)
        i, j, _, x, y, _ = tp[:6]
        gt = GeoTransform(x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)
    else:
        gt = GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, -1.0)

    srid = _epsg_from_geokeys(tags[_TAG_GEO_KEYS], bo) \
        if _TAG_GEO_KEYS in tags else 4326
    meta = {"driver": "GTiff"}
    if sink.records:
        meta["decode_errors"] = sink.meta_records()
    return RasterTile(out, gt, nodata=nodata, srid=srid or 4326,
                      meta=meta)


# ------------------------------------------------------------------ write

def _pack_entries(entries: List[Tuple[int, int, int, bytes]],
                  data_start: int) -> Tuple[bytes, bytes]:
    """entries: (tag, type, count, payload) sorted by tag."""
    ifd = struct.pack("<H", len(entries))
    heap = b""
    for tag, typ, cnt, payload in entries:
        if len(payload) <= 4:
            inline = payload + b"\x00" * (4 - len(payload))
            ifd += struct.pack("<HHI", tag, typ, cnt) + inline
        else:
            ifd += struct.pack("<HHII", tag, typ, cnt,
                               data_start + len(heap))
            heap += payload + (b"\x00" if len(payload) % 2 else b"")
    ifd += struct.pack("<I", 0)
    return ifd, heap


def write_gtiff(tile: RasterTile, compress: bool = False) -> bytes:
    """Encode a RasterTile as striped little-endian GeoTIFF bytes
    (reference exit: GDAL.writeRasters, core/raster/api/GDAL.scala:172)."""
    data = np.asarray(tile.data)
    if data.ndim != 3:
        raise ValueError("tile data must be [bands, H, W]")
    bands, h, w = data.shape
    dt = data.dtype.newbyteorder("<")
    data = np.ascontiguousarray(data.astype(dt))
    fmt = {"u": 1, "i": 2, "f": 3}[dt.kind]

    # band-interleaved-by-pixel strips (planar=1), one strip per row block
    pix = np.moveaxis(data, 0, -1)          # [H, W, bands]
    rows_per_strip = max(1, 8192 // max(w * bands * dt.itemsize, 1))
    strips = []
    for y0 in range(0, h, rows_per_strip):
        chunk = pix[y0:y0 + rows_per_strip].tobytes()
        strips.append(zlib.compress(chunk) if compress else chunk)

    gt = tile.gt
    if gt.rot_x or gt.rot_y:
        raise ValueError("rotated geotransforms not supported by the "
                         "GTiff writer")
    n_strips = len(strips)
    header = 8
    # assemble IFD after computing layout: header | ifd+heap | strips
    entries_proto: List[Tuple[int, int, int, bytes]] = []

    def e(tag, typ, vals, fmt_char):
        if isinstance(vals, bytes):
            payload = vals
            cnt = len(vals)
        else:
            payload = struct.pack("<" + fmt_char * len(vals), *vals)
            cnt = len(vals)
        entries_proto.append((tag, typ, cnt, payload))

    e(_TAG_WIDTH, 4, [w], "I")
    e(_TAG_HEIGHT, 4, [h], "I")
    e(_TAG_BITS, 3, [dt.itemsize * 8] * bands, "H")
    e(_TAG_COMPRESSION, 3, [8 if compress else 1], "H")
    e(_TAG_PHOTOMETRIC, 3, [1], "H")
    e(_TAG_SAMPLES_PER_PIXEL, 3, [bands], "H")
    e(_TAG_ROWS_PER_STRIP, 4, [rows_per_strip], "I")
    e(_TAG_PLANAR, 3, [1], "H")
    e(_TAG_SAMPLE_FORMAT, 3, [fmt] * bands, "H")
    e(_TAG_MODEL_PIXEL_SCALE, 12, [gt.px_w, -gt.px_h, 0.0], "d")
    e(_TAG_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, gt.x0, gt.y0, 0.0], "d")
    # minimal GeoKeyDirectory: model type + EPSG code
    if not 0 <= tile.srid <= 65535:
        raise ValueError(f"SRID {tile.srid} does not fit the GeoTIFF "
                         "SHORT GeoKey range [0, 65535]")
    geographic = tile.srid in (4326, 4269, 4267)
    keys = [1, 1, 0, 3,
            1024, 0, 1, 2 if geographic else 1,
            1025, 0, 1, 1,
            2048 if geographic else 3072, 0, 1, tile.srid]
    e(_TAG_GEO_KEYS, 3, keys, "H")
    if tile.nodata is not None:
        nd = tile.nodata
        if np.ndim(nd) != 0:
            uniq = set(float(v) for v in nd if v is not None)
            if len(uniq) != 1 or any(v is None for v in nd):
                raise ValueError(
                    "GeoTIFF carries one GDAL_NODATA value per file; "
                    f"per-band nodata {nd!r} differs — unify with "
                    "rst_setnodata first")
            nd = uniq.pop()
        e(_TAG_GDAL_NODATA, 2, str(float(nd)).encode() + b"\x00", "s")

    # placeholder offsets; two passes to fix layout
    e(_TAG_STRIP_OFFSETS, 4, [0] * n_strips, "I")
    e(_TAG_STRIP_COUNTS, 4, [len(s) for s in strips], "I")
    entries_proto.sort(key=lambda t: t[0])

    ifd_size = 2 + 12 * len(entries_proto) + 4
    heap_start = header + ifd_size
    ifd, heap = _pack_entries(entries_proto, heap_start)
    data_start = heap_start + len(heap)
    offs = []
    p = data_start
    for s in strips:
        offs.append(p)
        p += len(s)
    # rebuild with real strip offsets
    entries = [(t, ty, c, pl) for (t, ty, c, pl) in entries_proto
               if t != _TAG_STRIP_OFFSETS]
    entries.append((_TAG_STRIP_OFFSETS, 4, n_strips,
                    struct.pack("<" + "I" * n_strips, *offs)))
    entries.sort(key=lambda t: t[0])
    ifd, heap = _pack_entries(entries, heap_start)
    out = struct.pack("<2sHI", b"II", 42, header) + ifd + heap
    assert len(out) == data_start, (len(out), data_start)
    return out + b"".join(strips)
