"""GRIB codec (reader), pure Python.

Port copy of ``mosaic_tpu.io.grib`` (pure Python and numpy), with
the port's fault site ``grib.read_message``.

Reference counterpart: the GDAL GRIB driver the reference reaches via
JNI — GRIB files are first-class test fixtures there
(src/test/resources/binary/grib-cams, the CAMS atmosphere products;
those files MIX editions 1 and 2 message by message, which this reader
handles).  GRIB is a published WMO standard (FM 92); the subset
implemented here is what those products (and most reanalysis exports)
use:

* editions 1 and 2, any number of messages per file;
* edition 2: grid definition template 3.0 (regular lat/lon), data
  representation template 5.0 (simple packing), optional bitmap;
* edition 1: grid type 0 (regular lat/lon), simple packing, optional
  bitmap section, IBM-float reference values.

Anything else raises with the template number so the gap is explicit
(same policy as the NetCDF-4 guard in io/netcdf.py).

Mapping to tiles: each message is a subdataset named
``d{discipline}c{category}n{number}_{i}`` (reference:
RST_Subdatasets / RST_GetSubdataset over GRIB exposes per-message
bands), georeferenced from the lat/lon grid section.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from ..core.raster.tile import GeoTransform, RasterTile
from ..resilience import faults
from ..obs.context import traced
from ..resilience.ingest import CodecError, ErrorSink, decode_guard

__all__ = ["read_grib", "grib_subdatasets"]


def _i(b: bytes) -> int:
    return int.from_bytes(b, "big")


def _sgn(v: int, bits: int) -> int:
    """GRIB sign-and-magnitude integer (high bit = negative)."""
    top = 1 << (bits - 1)
    return -(v - top) if v & top else v


def _unpack_bits(raw: bytes, nbits: int, n: int) -> np.ndarray:
    """First n big-endian nbits-wide unsigned ints from a byte string."""
    if nbits == 0:
        return np.zeros(n, np.int64)
    if nbits in (8, 16, 32):
        dt = {8: ">u1", 16: ">u2", 32: ">u4"}[nbits]
        return np.frombuffer(raw, dt, n).astype(np.int64)
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    need = n * nbits
    bits = bits[:need].reshape(n, nbits).astype(np.int64)
    weights = (1 << np.arange(nbits - 1, -1, -1, dtype=np.int64))
    return bits @ weights


def _ibm_float(b: bytes) -> float:
    """4-byte IBM System/360 hexadecimal float (GRIB1 reference R)."""
    sign = -1.0 if b[0] & 0x80 else 1.0
    exp = (b[0] & 0x7F) - 64
    mant = _i(b[1:4]) / float(1 << 24)
    return sign * mant * 16.0 ** exp


def _grid_to_tile(arr, la1, lo1, la2, lo2, di, dj, scan, name, meta,
                  out):
    """Normalize scan order to north-up and wrap in a RasterTile."""
    if scan & 0x80:                     # -i: columns east->west
        arr = arr[:, ::-1]
        lo1, lo2 = lo2, lo1
    north_up_lat0 = la1
    if scan & 0x40:                     # +j: rows south->north
        arr = arr[::-1]
        north_up_lat0 = la2
    gt = GeoTransform(lo1 - di / 2.0, di, 0.0,
                      north_up_lat0 + dj / 2.0, 0.0, -dj)
    out[name] = RasterTile(arr[None].astype(np.float64), gt,
                           nodata=float("nan"), srid=4326, meta=meta)


def _read_grib1(data: bytes, off: int, total: int, mi: int,
                out: Dict[str, RasterTile]) -> None:
    """One GRIB1 message starting at ``off`` (after length parsing)."""
    pos = off + 8
    pds = data[pos:pos + _i(data[pos:pos + 3])]
    param = pds[8]
    D = _sgn(_i(pds[26:28]), 16)
    has_gds = bool(pds[7] & 0x80)
    has_bms = bool(pds[7] & 0x40)
    pos += len(pds)
    if not has_gds:
        raise ValueError("GRIB1 message without GDS unsupported "
                         "(catalogued grids not carried)")
    gds = data[pos:pos + _i(data[pos:pos + 3])]
    if gds[5] != 0:
        raise ValueError(f"GRIB1 grid type {gds[5]} unsupported "
                         "(regular lat/lon 0 only)")
    ni = _i(gds[6:8])
    nj = _i(gds[8:10])
    la1 = _sgn(_i(gds[10:13]), 24) / 1e3
    lo1 = _sgn(_i(gds[13:16]), 24) / 1e3
    la2 = _sgn(_i(gds[17:20]), 24) / 1e3
    lo2 = _sgn(_i(gds[20:23]), 24) / 1e3
    di = abs(_sgn(_i(gds[23:25]), 16)) / 1e3
    dj = abs(_sgn(_i(gds[25:27]), 16)) / 1e3
    scan = gds[27]
    pos += len(gds)
    bitmap = None
    if has_bms:
        bms = data[pos:pos + _i(data[pos:pos + 3])]
        if _i(bms[4:6]) != 0:
            raise ValueError("GRIB1 catalogued bitmap unsupported")
        bitmap = np.unpackbits(
            np.frombuffer(bms[6:], np.uint8)).astype(bool)
        pos += len(bms)
    bds = data[pos:pos + _i(data[pos:pos + 3])]
    flags = bds[3] >> 4
    if flags & 0xC:
        raise ValueError("GRIB1 spherical-harmonic/complex packing "
                         "unsupported (simple grid packing only)")
    E = _sgn(_i(bds[4:6]), 16)
    R = _ibm_float(bds[6:10])
    nbits = bds[10]
    npts = int(bitmap.sum()) if bitmap is not None else ni * nj
    if nbits:
        packed = _unpack_bits(bds[11:], nbits, npts)
        vals = (R + packed.astype(np.float64) * 2.0 ** E) / 10.0 ** D
    else:
        vals = np.full(npts, R / 10.0 ** D)
    full = np.full(ni * nj, np.nan)
    if bitmap is not None:
        full[np.nonzero(bitmap[:ni * nj])[0]] = vals
    else:
        full[:] = vals
    name = f"p{param}_{mi}"
    _grid_to_tile(full.reshape(nj, ni), la1, lo1, la2, lo2, di, dj,
                  scan, name, {"driver": "GRIB", "edition": "1",
                               "param": str(param)}, out)


def _read_grib2(data: bytes, off: int, end: int, mi: int,
                out: Dict[str, RasterTile]) -> None:
    """One GRIB2 message: section loop from ``off`` to ``end``."""
    discipline = data[off + 6]
    pos = off + 16
    grid = None
    repr_ = None
    bitmap = None
    cat = num = None
    fi = 0
    while pos < end - 4:
        slen = _i(data[pos:pos + 4])
        if slen == 0 or data[pos:pos + 4] == b"7777":
            break
        snum = data[pos + 4]
        sec = data[pos:pos + slen]
        if snum == 3:
            tmpl = _i(sec[12:14])
            if tmpl != 0:
                raise ValueError(
                    f"GRIB2 grid template 3.{tmpl} unsupported "
                    "(regular lat/lon 3.0 only)")
            ni = _i(sec[30:34])
            nj = _i(sec[34:38])
            la1 = _sgn(_i(sec[46:50]), 32) / 1e6
            lo1 = _sgn(_i(sec[50:54]), 32) / 1e6
            la2 = _sgn(_i(sec[55:59]), 32) / 1e6
            lo2 = _sgn(_i(sec[59:63]), 32) / 1e6
            di = _sgn(_i(sec[63:67]), 32) / 1e6
            dj = _sgn(_i(sec[67:71]), 32) / 1e6
            scan = sec[71]
            grid = (ni, nj, la1, lo1, la2, lo2, di, dj, scan)
        elif snum == 4:
            cat, num = sec[9], sec[10]
        elif snum == 5:
            tmpl = _i(sec[9:11])
            if tmpl != 0:
                raise ValueError(
                    f"GRIB2 data representation 5.{tmpl} "
                    "unsupported (simple packing 5.0 only)")
            ndata = _i(sec[5:9])
            R = struct.unpack(">f", sec[11:15])[0]
            E = _sgn(_i(sec[15:17]), 16)
            D = _sgn(_i(sec[17:19]), 16)
            nbits = sec[19]
            repr_ = (ndata, R, E, D, nbits)
        elif snum == 6:
            ind = sec[5]
            if ind == 0:
                bitmap = np.unpackbits(
                    np.frombuffer(sec[6:], np.uint8)).astype(bool)
            elif ind == 255:
                # no bitmap applies to THIS field — clear any
                # bitmap a previous field in the message set
                bitmap = None
            else:
                raise ValueError(
                    f"GRIB2 bitmap indicator {ind} unsupported")
        elif snum == 7:
            if grid is None or repr_ is None:
                raise ValueError(
                    "data section before grid/representation sections")
            ni, nj, la1, lo1, la2, lo2, di, dj, scan = grid
            ndata, R, E, D, nbits = repr_
            packed = _unpack_bits(sec[5:], nbits, ndata)
            vals = (R + packed.astype(np.float64) * 2.0 ** E) / \
                (10.0 ** D)
            full = np.full(ni * nj, np.nan)
            if bitmap is not None:
                full[np.nonzero(bitmap[:ni * nj])[0][:ndata]] = vals
            else:
                full[:ndata] = vals
            # fi disambiguates repeated 4-7 groups in one message
            # sharing (discipline, category, number), e.g. the same
            # parameter at several levels
            name = f"d{discipline}c{cat}n{num}_{mi}_{fi}"
            fi += 1
            _grid_to_tile(full.reshape(nj, ni), la1, lo1, la2,
                          lo2, di, dj, scan, name,
                          {"driver": "GRIB", "edition": "2",
                           "discipline": str(discipline),
                           "category": str(cat),
                           "number": str(num)}, out)
        pos += slen


@traced("ingest:grib", "ingest/grib")
def read_grib(data: bytes, on_error: Optional[str] = None,
              path: Optional[str] = None,
              errors: Optional[list] = None) -> Dict[str, RasterTile]:
    """GRIB bytes -> {subdataset_name: RasterTile} per message.

    ``on_error`` (default: ``MosaicConfig.io_on_error``) governs
    malformed/unsupported messages: ``"raise"`` fails fast with a
    located ``CodecError``; ``"skip"``/``"null"`` drop the damaged
    message (there is no null raster slot), keep decoding the intact
    remainder, and append ErrorRecords to ``errors`` when a list is
    supplied."""
    sink = ErrorSink(on_error, driver="grib", path=path)
    out: Dict[str, RasterTile] = {}
    off = 0
    mi = 0
    n = len(data)
    while True:
        # messages may be separated by padding: scan for the magic
        off = data.find(b"GRIB", off)
        if off < 0 or off + 16 > n:
            break
        edition = data[off + 7]
        feature = f"message {mi}"
        if edition == 1:
            total = _i(data[off + 4:off + 7])
        elif edition == 2:
            total = _i(data[off + 8:off + 16])
        else:
            sink.handle(CodecError(
                f"GRIB edition {edition} unsupported", path=path,
                feature=feature, offset=off))
            off += 4
            mi += 1
            continue
        # a corrupt length field must not swallow the rest of the file:
        # advance by the declared total only when it stays in bounds,
        # else resync on the next magic
        sane = 16 < total <= n - off if edition == 2 else \
            8 < total <= n - off
        try:
            with decode_guard(path=path, feature=feature, offset=off):
                faults.maybe_fail("grib.read_message")
                if edition == 1:
                    _read_grib1(data, off, total, mi, out)
                else:
                    _read_grib2(data, off, min(off + total, n), mi,
                                out)
        except ValueError as e:
            sink.handle(e)
        off = off + total if sane else off + 4
        mi += 1
    if not out and not sink.records:
        raise ValueError("no GRIB2 messages found")
    sink.export(errors)
    return out


def grib_subdatasets(data: bytes) -> List[str]:
    return list(read_grib(data))
