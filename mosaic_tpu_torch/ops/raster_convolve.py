"""The raster stencil: a hand-written CUDA kernel for Hopper and its plain
PyTorch version.

Counterpart of the XLA bodies of ``mosaic_tpu.core.raster.rops.convolve``
(f64) and ``mosaic_tpu.parallel.raster_halo._convolve_fn`` (f32): per band,
a SAME-padded 2-D cross-correlation (not flipped, as XLA's
``conv_general_dilated``) of a [B, H, W] raster with a [kh, kw] weight
array, terms outside the tile 0:

    out[b, r, c] = sum_{i, j} w[i, j] * x[b, r + i - ph, c + j - pw]

with ph = (kh - 1) // 2 and pw = (kw - 1) // 2, so an even side pads one
less before than after, as XLA's SAME does.

:func:`raster_convolve` is the entry point.  On CUDA tensors it launches
``csrc/raster_convolve.cu`` (built at first use; an f64 and an f32
instance) or raises; on CPU tensors it runs :func:`convolve_ref`.  Both
sum the taps in row-major order from 0 with every product and sum rounded
once, so they agree bit for bit.  No library convolution stands in:
cuDNN's f32 convolution runs in TF32 by default, and is not a port.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _kernels
from .projection import check_rc

#: the kernel's grid: bands in z, rows in y (8 a block)
MAX_BANDS = 65535
MAX_ROWS = 65535 * 8


def same_pads(kh: int, kw: int):
    """(top, bottom, left, right) zero padding of SAME for a kh x kw
    stencil: the smaller half before."""
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    return ph, kh - 1 - ph, pw, kw - 1 - pw


def convolve_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the zero-padded raster's shifted slices, each times
    its weight, added in row-major tap order from 0."""
    kh, kw = w.shape
    top, bottom, left, right = same_pads(kh, kw)
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (left, right, top, bottom))
    out = torch.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            out = out + w[i, j] * xp[:, i:i + H, j:j + W]
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("raster_convolve")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("raster_convolve_f64_launch", "raster_convolve_f32_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i, i, i, vp, i, i, vp, vp]
        fn.restype = i
    lib.raster_convolve_error_string.argtypes = [i]
    lib.raster_convolve_error_string.restype = ctypes.c_char_p
    return lib


def raster_convolve(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, H, W] SAME cross-correlation of ``x`` with the [kh, kw]
    weights ``w``, both f64 or both f32, on one device.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream and raise on anything it does not take or on a
    CUDA error; there is no fallback.  ``raster_convolve.launches``
    counts kernel launches."""
    if x.dim() != 3 or w.dim() != 2 or min(w.shape) < 1:
        raise ValueError(f"raster_convolve: x must be [B, H, W] and w "
                         f"[kh, kw], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype not in (torch.float64, torch.float32) or w.dtype != x.dtype:
        raise ValueError(f"raster_convolve: x and w must both be float64 "
                         f"or both float32, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"raster_convolve: x on {x.device}, w on "
                         f"{w.device}")
    dev = x.device
    if dev.type == "cpu":
        return convolve_ref(x, w)
    if dev.type != "cuda":
        raise ValueError(f"raster_convolve: unsupported device {dev}")
    B, H, W = (int(v) for v in x.shape)
    if B > MAX_BANDS or H > MAX_ROWS:
        raise ValueError(f"raster_convolve: {B} bands x {H} rows exceed "
                         f"the kernel's grid ({MAX_BANDS} x {MAX_ROWS})")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    launch = (lib.raster_convolve_f64_launch if x.dtype == torch.float64
              else lib.raster_convolve_f32_launch)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(x.data_ptr(), B, H, W, w.data_ptr(), int(w.shape[0]),
                    int(w.shape[1]), out.data_ptr(), stream)
    check_rc(lib, "raster_convolve", rc, "launch")
    raster_convolve.launches += 1
    return out


raster_convolve.launches = 0
