"""NetCDF-3 (classic) codec: reader + writer, pure Python.

Port copy of ``mosaic_tpu.io.netcdf`` (pure Python and numpy), with
the port's fault sites ``netcdf.read`` and ``netcdf.read_var``.

Reference counterpart: the GDAL NetCDF driver the reference reaches via
JNI — NetCDF files are first-class test fixtures there
(src/test/resources/binary/netcdf-coral).  The classic format (CDF-1/2)
is a small, fully published big-endian layout: dimension list,
attribute list, variable list with file offsets, then data.  Enough for
the coral/CAMS-style gridded products the reference exercises; NetCDF-4
(= HDF5) is out of scope and raises clearly.

Mapping to tiles: each 2D+ variable is a subdataset (reference:
RST_Subdatasets / RST_GetSubdataset); 1D coordinate variables matching
dimension names supply the geotransform (regular spacing required).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.raster.tile import GeoTransform, RasterTile
from ..resilience import faults
from ..obs.context import traced
from ..resilience.ingest import ErrorSink, decode_guard

__all__ = ["read_netcdf", "write_netcdf", "netcdf_subdatasets"]

_NC_TYPES = {1: ("b", 1), 2: ("c", 1), 3: (">i2", 2), 4: (">i4", 4),
             5: (">f4", 4), 6: (">f8", 8)}
_NP_TO_NC = {"int8": 1, "int16": 3, "int32": 4, "float32": 5,
             "float64": 6}


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def _read_name(buf: bytes, i: int) -> Tuple[str, int]:
    ln = struct.unpack(">i", buf[i:i + 4])[0]
    name = buf[i + 4:i + 4 + ln].decode("utf-8")
    return name, i + 4 + _pad4(ln)


def _read_att_values(buf: bytes, i: int):
    tp, cnt = struct.unpack(">ii", buf[i:i + 8])
    i += 8
    dt, sz = _NC_TYPES[tp]
    raw = buf[i:i + cnt * sz]
    i += _pad4(cnt * sz)
    if tp == 2:
        return raw.decode("utf-8", "replace"), i
    return np.frombuffer(raw, dt, cnt), i


@traced("ingest:netcdf", "ingest/netcdf")
def read_netcdf(data: bytes, on_error: Optional[str] = None,
                path: Optional[str] = None,
                errors: Optional[list] = None) -> Dict[str, RasterTile]:
    """NetCDF-3 bytes -> {variable_name: RasterTile} for every 2D+
    variable (leading dims beyond the last two become bands).

    ``on_error`` (default: ``MosaicConfig.io_on_error``) governs
    malformed variables: ``"raise"`` fails fast with a located
    ``CodecError``; ``"skip"``/``"null"`` drop the damaged variable
    (there is no null raster slot), keep the intact ones, and append
    ErrorRecords to ``errors`` when a list is supplied.  Header damage
    always raises — without the dimension/variable lists nothing can
    be salvaged."""
    faults.maybe_fail("netcdf.read")
    sink = ErrorSink(on_error, driver="netcdf", path=path)
    if data[:3] != b"CDF":
        if data[:8] == b"\x89HDF\r\n\x1a\n" or data[:4] == b"\x89HDF":
            raise ValueError("NetCDF-4/HDF5 container not supported "
                             "(classic CDF-1/2 only)")
        raise ValueError("not a NetCDF classic file")
    version = data[3]
    if version not in (1, 2):
        raise ValueError(f"unsupported CDF version {version}")
    off_fmt = ">i" if version == 1 else ">q"
    off_sz = 4 if version == 1 else 8
    i = 4

    def read_tag_count(i):
        tag, cnt = struct.unpack(">ii", data[i:i + 8])
        return tag, cnt, i + 8

    with decode_guard(path=path, feature="header"):
        numrecs = struct.unpack(">i", data[i:i + 4])[0]
        i += 4
        # dimensions
        tag, ndims, i = read_tag_count(i)
        dims: List[Tuple[str, int]] = []
        if tag == 0x0A:
            for _ in range(ndims):
                name, i = _read_name(data, i)
                size = struct.unpack(">i", data[i:i + 4])[0]
                i += 4
                dims.append((name, size))
        # global attributes
        tag, natt, i = read_tag_count(i)
        gatts = {}
        if tag == 0x0C:
            for _ in range(natt):
                name, i = _read_name(data, i)
                val, i = _read_att_values(data, i)
                gatts[name] = val
        # variables
        tag, nvars, i = read_tag_count(i)
        variables = []
        if tag == 0x0B:
            for _ in range(nvars):
                name, i = _read_name(data, i)
                nd = struct.unpack(">i", data[i:i + 4])[0]
                i += 4
                dimids = struct.unpack(f">{nd}i", data[i:i + 4 * nd]) \
                    if nd else ()
                i += 4 * nd
                t2, na2, i = read_tag_count(i)
                vatts = {}
                if t2 == 0x0C:
                    for _ in range(na2):
                        aname, i = _read_name(data, i)
                        aval, i = _read_att_values(data, i)
                        vatts[aname] = aval
                tp, vsize = struct.unpack(">ii", data[i:i + 8])
                i += 8
                begin = struct.unpack(off_fmt, data[i:i + off_sz])[0]
                i += off_sz
                variables.append((name, dimids, vatts, tp, begin))

    n_record_vars = sum(1 for _, dimids, _, _, _ in variables
                        if dimids and dims[dimids[0]][1] == 0)

    def var_array(name, dimids, tp, begin):
        shape = [dims[d][1] for d in dimids]
        is_record = bool(shape) and shape[0] == 0
        if is_record:
            shape[0] = numrecs
            # multiple record variables interleave per record on disk;
            # reading one as contiguous would silently mix variables
            if n_record_vars > 1 and numrecs > 1:
                raise ValueError(
                    "NetCDF files with multiple record (unlimited-"
                    "dimension) variables are not supported — the "
                    "interleaved record layout would be misread")
        dt, sz = _NC_TYPES[tp]
        cnt = int(np.prod(shape)) if shape else 1
        raw = np.frombuffer(data, dt, cnt, begin)
        return raw.reshape(shape) if shape else raw

    coord_vars = {}
    for name, dimids, vatts, tp, begin in variables:
        if len(dimids) == 1 and dims[dimids[0]][0] == name:
            try:
                with decode_guard(path=path,
                                  feature=f"coordinate {name}",
                                  offset=begin):
                    coord_vars[name] = var_array(name, dimids, tp,
                                                 begin)
            except ValueError as e:
                # a broken coordinate variable degrades to the default
                # pixel-space geotransform, not a dead file
                sink.handle(e)

    out: Dict[str, RasterTile] = {}
    for name, dimids, vatts, tp, begin in variables:
        if len(dimids) < 2:
            continue
        try:
            with decode_guard(path=path, feature=f"variable {name}",
                              offset=begin):
                faults.maybe_fail("netcdf.read_var")
                arr = var_array(name, dimids, tp,
                                begin).astype(np.float64)
                ydim = dims[dimids[-2]][0]
                xdim = dims[dimids[-1]][0]
                h, w = arr.shape[-2], arr.shape[-1]
                arr = arr.reshape(-1, h, w)
                gt = GeoTransform(0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
                flip = False
                if xdim in coord_vars and ydim in coord_vars \
                        and w > 1 and h > 1:
                    xs = coord_vars[xdim].astype(np.float64)
                    ys = coord_vars[ydim].astype(np.float64)
                    dx = float(xs[1] - xs[0])
                    dy = float(ys[1] - ys[0])
                    if dy > 0:         # south-up storage: flip north-up
                        flip = True
                        ys = ys[::-1]
                        dy = -dy
                    gt = GeoTransform(float(xs[0]) - dx / 2, dx, 0.0,
                                      float(ys[0]) - dy / 2, 0.0, dy)
                if flip:
                    arr = arr[:, ::-1, :]
                nodata = None
                for key in ("_FillValue", "missing_value"):
                    if key in vatts:
                        nodata = float(np.atleast_1d(vatts[key])[0])
                        break
                out[name] = RasterTile(
                    arr, gt, nodata=nodata, srid=4326,
                    meta={"driver": "netcdf", "variable": name,
                          **{f"attr_{k}": str(v)
                             for k, v in vatts.items()}})
        except ValueError as e:
            sink.handle(e)
    for t in out.values():
        t.meta["subdatasets"] = ",".join(sorted(out))
    sink.export(errors)
    return out


def netcdf_subdatasets(data: bytes) -> List[str]:
    """Variable names exposable as subdatasets (reference:
    RST_Subdatasets)."""
    return sorted(read_netcdf(data))


def write_netcdf(variables: Dict[str, "np.ndarray"],
                 xs: Optional[np.ndarray] = None,
                 ys: Optional[np.ndarray] = None,
                 fill_value: Optional[float] = None) -> bytes:
    """Minimal CDF-1 writer: 2D float64 variables on a shared (y, x)
    grid with coordinate variables — enough to produce hermetic test
    fixtures the reader round-trips (the reference keeps small real
    NetCDF files in test resources; zero egress here)."""
    arrs = {k: np.asarray(v, np.float64) for k, v in variables.items()}
    shapes = {v.shape for v in arrs.values()}
    assert len(shapes) == 1, "all variables must share one 2D shape"
    h, w = shapes.pop()
    xs = np.arange(w, dtype=np.float64) if xs is None else \
        np.asarray(xs, np.float64)
    ys = np.arange(h, dtype=np.float64) if ys is None else \
        np.asarray(ys, np.float64)

    def name_b(s):
        b = s.encode()
        return struct.pack(">i", len(b)) + b + b"\0" * (_pad4(len(b))
                                                        - len(b))

    header = b"CDF\x01" + struct.pack(">i", 0)
    header += struct.pack(">ii", 0x0A, 2)
    header += name_b("y") + struct.pack(">i", h)
    header += name_b("x") + struct.pack(">i", w)
    header += struct.pack(">ii", 0, 0)          # no global atts
    nvars = 2 + len(arrs)
    header += struct.pack(">ii", 0x0B, nvars)

    # layout: compute header size first with a placeholder pass
    def var_entry(name, dimids, begin, with_fill):
        e = name_b(name)
        e += struct.pack(">i", len(dimids))
        e += struct.pack(f">{len(dimids)}i", *dimids)
        if with_fill and fill_value is not None:
            e += struct.pack(">ii", 0x0C, 1)
            e += name_b("_FillValue")
            e += struct.pack(">ii", 6, 1) + struct.pack(">d", fill_value)
        else:
            e += struct.pack(">ii", 0, 0)
        size = 8 * (h * w if len(dimids) == 2 else
                    (h if dimids == (0,) else w))
        e += struct.pack(">ii", 6, size)
        e += struct.pack(">i", begin)
        return e, size

    # two passes: sizes don't depend on begin values' content
    begins = [0] * nvars
    for _ in range(2):
        body = b""
        entries = []
        specs = [("y", (0,), False), ("x", (1,), False)] + \
            [(k, (0, 1), True) for k in sorted(arrs)]
        for vi, (nm, dd, wf) in enumerate(specs):
            e, size = var_entry(nm, dd, begins[vi], wf)
            entries.append((e, size))
            body += e
        total_header = len(header) + len(body)
        off = total_header
        for vi, (_, size) in enumerate(entries):
            begins[vi] = off
            off += size
    blob = header + body
    blob += ys.astype(">f8").tobytes()
    blob += xs.astype(">f8").tobytes()
    for k in sorted(arrs):
        blob += arrs[k].astype(">f8").tobytes()
    return blob
