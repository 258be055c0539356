"""H3 lattice projection, the PIP join's front end: a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

Port of ``mosaic_tpu.ops.pallas_projection.project_lattice_pallas``.  For
each point, given origin-local f32 lon/lat degrees, it computes the df
small-angle sin/cos around the origin, the unit-sphere xyz, a 20-face
argmax with the runner-up gap, the df gnomonic projection on that face,
cube rounding to axial (a, b) carrying the df residual, and the distance
to the hex Voronoi boundary.  Outputs: face, a, b as i32 [N] and margin,
facegap as f32 [N].

:func:`project_lattice` is the entry point.  On a CUDA tensor it launches
``csrc/h3_projection.cu`` (built at first use) or raises; on a CPU tensor
it runs :func:`project_lattice_ref`, the plain version, which keeps the
kernel's order of operations so the two agree bit for bit.  The join's
main path runs the same projection inside ``ops/dense_join.py``'s kernel;
the launch helpers below serve both kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..core.index.h3.torchkernel import (basis_tables, face_centers_f32,
                                         projection_constants)
from .twofloat import (DF, df_add, df_mul, df_sub, fast_two_sum)

Projection = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor]


# ------------------------------------------------------- plain version
#
# Two df steps differ from ops/twofloat.py, as they do in the Pallas
# kernel: the Taylor coefficients scale both parts of a df value by an
# f32 constant (no error term), and the division's correction product
# runs through the full df product with a zero low part.

def _scale(x: DF, c: float) -> DF:
    return DF(x.hi * c, x.lo * c)


def _const(v_hi: float, v_lo: float, like: torch.Tensor) -> DF:
    return DF(torch.full_like(like, v_hi), torch.full_like(like, v_lo))


def _div(x: DF, y: DF) -> DF:
    # as the kernel: y * (q1, 0) through the full df product
    q1 = x.hi / y.hi
    r = df_sub(x, df_mul(y, DF(q1, torch.zeros_like(q1))))
    q2 = (r.hi + r.lo) / y.hi
    return DF(*fast_two_sum(q1, q2))


def _poly_sin(d: DF) -> DF:
    one = _const(1.0, 0.0, d.hi)
    d2 = df_mul(d, d)
    t = df_sub(one, _scale(d2, 1.0 / 20.0))
    t = df_sub(one, df_mul(_scale(d2, 1.0 / 6.0), t))
    return df_mul(d, t)


def _poly_cos(d: DF) -> DF:
    one = _const(1.0, 0.0, d.hi)
    d2 = df_mul(d, d)
    t = df_sub(one, _scale(d2, 1.0 / 30.0))
    t = df_sub(one, df_mul(_scale(d2, 1.0 / 12.0), t))
    return df_sub(one, df_mul(_scale(d2, 0.5), t))


def _trig_local(d: torch.Tensor, pi180: DF, s0: DF, c0: DF):
    rad = df_mul(DF(d, torch.zeros_like(d)), pi180)
    s_d, c_d = _poly_sin(rad), _poly_cos(rad)
    sin = df_add(df_mul(s0, c_d), df_mul(c0, s_d))
    cos = df_sub(df_mul(c0, c_d), df_mul(s0, s_d))
    return sin, cos


def _round(v: DF):
    r = torch.round(v.hi)
    frac = (v.hi - r) + v.lo
    adj = (frac > 0.5).to(v.hi.dtype) - (frac < -0.5).to(v.hi.dtype)
    return r + adj, frac - adj


#: f32 degrees -> radians and back, as ``jnp.radians``/``jnp.degrees``
#: scale an f32 array: one multiply by the constant rounded to f32
RAD_PER_DEG = float(np.float32(np.pi / 180.0))
DEG_PER_RAD = float(np.float32(180.0 / np.pi))


def _trig_absolute(d: torch.Tensor):
    """(sin, cos) of f32 degrees: f32 radians, f32 sin and cos, lifted to
    df with a zero low part (the JAX package's absolute ``_project_df``)."""
    rad = d * RAD_PER_DEG
    zero = torch.zeros_like(rad)
    return DF(torch.sin(rad), zero), DF(torch.cos(rad), zero)


def project_lattice_ref(xy: torch.Tensor, res: int,
                        origin: Optional[Tuple[float, float]]
                        ) -> Projection:
    """Plain PyTorch version of the kernel: [N, 2] f32 degrees ->
    (face, a, b, margin, facegap), on the input's device.  ``xy`` is
    origin-local around ``origin`` (lon0, lat0), or absolute when
    ``origin`` is None: then sin and cos are f32 (the front end of the
    cell kernel, ``ops/cell.py``) where the local path runs df Taylor
    series around df constants of the origin.

    Scalars are python floats holding f32 values, so every step is one
    rounded f32 elementwise op; the face selection is the kernel's plain
    f32 three-term dot with a strict ``>`` running argmax."""
    x = xy[:, 0].to(torch.float32)
    y = xy[:, 1].to(torch.float32)
    k = [float(v) for v in projection_constants(
        (0.0, 0.0) if origin is None else origin)]
    if origin is None:
        sin_lat, cos_lat = _trig_absolute(y)
        sin_lng, cos_lng = _trig_absolute(x)
    else:
        pi180 = _const(k[0], k[1], x)
        sin_lat, cos_lat = _trig_local(y, pi180, _const(k[2], k[3], x),
                                       _const(k[4], k[5], x))
        sin_lng, cos_lng = _trig_local(x, pi180, _const(k[6], k[7], x),
                                       _const(k[8], k[9], x))
    X = df_mul(cos_lat, cos_lng)
    Y = df_mul(cos_lat, sin_lng)
    Z = sin_lat

    fc = face_centers_f32().tolist()
    best = torch.full_like(x, -2.0)
    second = torch.full_like(x, -2.0)
    face = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for f in range(20):
        d = X.hi * fc[f][0] + Y.hi * fc[f][1] + Z.hi * fc[f][2]
        better = d > best
        second = torch.where(better, best, torch.maximum(second, d))
        face = torch.where(better, torch.full_like(face, f), face)
        best = torch.where(better, d, best)
    gap = best - second

    tbl = torch.as_tensor(basis_tables(res), device=x.device)
    fl = face.long()
    sel_hi, sel_lo = tbl[0][fl], tbl[1][fl]                  # [N, 9]

    def dot3(j):
        acc = df_mul(X, DF(sel_hi[:, j], sel_lo[:, j]))
        acc = df_add(acc, df_mul(Y, DF(sel_hi[:, j + 1], sel_lo[:, j + 1])))
        return df_add(acc, df_mul(Z, DF(sel_hi[:, j + 2], sel_lo[:, j + 2])))

    u = dot3(0)
    px = _div(dot3(3), u)
    py = _div(dot3(6), u)

    rf = df_mul(py, _const(k[10], k[11], x))
    qf = df_sub(px, _scale(rf, 0.5))
    sf = df_sub(qf.neg(), rf)
    rq, fq = _round(qf)
    rr, fr = _round(rf)
    rs, fs = _round(sf)
    dq, dr, ds = fq.abs(), fr.abs(), fs.abs()
    fix_q = (dq > dr) & (dq > ds)
    fix_r = ~fix_q & (dr > ds)
    rq2 = torch.where(fix_q, -rr - rs, rq)
    rr2 = torch.where(fix_r, -rq2 - rs, rr)
    fq = fq + (rq - rq2)
    fr = fr + (rr - rr2)

    sin60 = k[12]
    vx = fq + 0.5 * fr
    vy = sin60 * fr
    h = 0.5 * vx
    sv = sin60 * vy
    proj = torch.maximum(vx.abs(), torch.maximum((h + sv).abs(),
                                                 (h - sv).abs()))
    margin = torch.clamp_min(0.5 - proj, 0.0)
    return (face, (rq2 + rr2).to(torch.int32), rr2.to(torch.int32), margin,
            gap)


# ------------------------------------------------------------- kernel

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("h3_projection")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.h3_projection_set_faces.argtypes = [vp]
    lib.h3_projection_set_faces.restype = i
    lib.h3_project_lattice.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.h3_project_lattice.restype = i
    lib.h3_projection_error_string.argtypes = [i]
    lib.h3_projection_error_string.restype = ctypes.c_char_p
    return lib


def check_rc(lib: ctypes.CDLL, prefix: str, rc: int, what: str) -> None:
    """Raise on a CUDA error code returned by a kernel library's entry
    point; ``prefix`` names its ``<prefix>_error_string``."""
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{prefix} {what}: CUDA error {rc} ({msg})")


_faces_set = set()              # (library, device) pairs whose faces are set


def set_faces(lib: ctypes.CDLL, prefix: str, device: torch.device) -> None:
    """Upload the face centers to ``device``'s constant memory of a
    kernel library, once per (library, device); a blocking copy, so the
    first launch's caller pays it, not a stream-ordered loop."""
    key = (prefix, device)
    if key not in _faces_set:
        fc = face_centers_f32()
        with torch.cuda.device(device):
            check_rc(lib, prefix, getattr(lib, f"{prefix}_set_faces")(
                fc.ctypes.data), "set_faces")
        _faces_set.add(key)


@functools.cache
def device_table(res: int, device: torch.device) -> torch.Tensor:
    """The [2, 20, 9] basis table at ``res`` on ``device``, uploaded once."""
    return torch.as_tensor(basis_tables(res), device=device).contiguous()


def host_constants(origin: Tuple[float, float]) -> np.ndarray:
    """The [13] f32 projection constants of ``origin``, computed once per
    origin; a kernel copies them into its arguments, so no device copy."""
    return _host_constants(float(origin[0]), float(origin[1]))


@functools.cache
def _host_constants(lon0: float, lat0: float) -> np.ndarray:
    return projection_constants((lon0, lat0))


def check_points(xy: torch.Tensor, what: str) -> None:
    """Raise unless ``xy`` is what the kernels read: [N, 2] f32,
    contiguous, 8-byte aligned (read as float2), N < 2^31."""
    if xy.dtype != torch.float32:
        raise ValueError(f"{what}: need float32, got {xy.dtype}")
    if xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError(f"{what}: need [N, 2], got {tuple(xy.shape)}")
    if not xy.is_contiguous() or xy.data_ptr() % 8:
        raise ValueError(f"{what}: input must be contiguous and 8-byte "
                         "aligned (read as float2)")
    if xy.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: {xy.shape[0]} rows exceed int32 "
                         "indexing")


def project_lattice(xy_local: torch.Tensor, res: int,
                    origin: Tuple[float, float]) -> Projection:
    """[N, 2] f32 origin-local degrees -> (face, a, b, margin, facegap).

    A CPU tensor runs the plain version.  A CUDA tensor launches the
    kernel on the current stream and raises on anything it does not take
    (dtype, shape, contiguity, alignment) or on a CUDA error; there is no
    fallback.  The basis table and the constants are made once per
    (res, device) and origin, so a launch copies nothing to the device.
    ``project_lattice.launches`` counts kernel launches."""
    dev = xy_local.device
    if dev.type == "cpu":
        return project_lattice_ref(xy_local, res, origin)
    if dev.type != "cuda":
        raise ValueError(f"project_lattice: unsupported device {dev}")
    if origin is None:
        raise ValueError("project_lattice: the kernel takes origin-local "
                         "points; absolute points go through the cell "
                         "kernel (ops/cell.py)")
    check_points(xy_local, "project_lattice")
    n = int(xy_local.shape[0])
    face = torch.empty(n, dtype=torch.int32, device=dev)
    a = torch.empty_like(face)
    b = torch.empty_like(face)
    margin = torch.empty(n, dtype=torch.float32, device=dev)
    gap = torch.empty_like(margin)
    if n == 0:
        return face, a, b, margin, gap
    lib = _lib()
    set_faces(lib, "h3_projection", dev)
    table = device_table(res, dev)
    consts = host_constants(origin)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h3_project_lattice(
            xy_local.data_ptr(), n, table.data_ptr(), consts.ctypes.data,
            face.data_ptr(), a.data_ptr(), b.data_ptr(), margin.data_ptr(),
            gap.data_ptr(), stream)
    check_rc(lib, "h3_projection", rc, "launch")
    project_lattice.launches += 1
    return face, a, b, margin, gap


project_lattice.launches = 0
