"""The NaN-aware tile combine: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Counterpart of the XLA body of ``mosaic_tpu.core.raster.rops.combine``: a
per-pixel reduction over a [T, B, H, W] f64 stack of aligned tiles in
which NaN marks no data, into [B, H, W] f64.  The reducers follow
``jnp.nanmean``, ``nanmin``, ``nanmax``, ``nanmedian`` (``nanquantile``
at 0.5, "linear": ``s_lo * lw + s_hi * hw``), ``nansum`` and the count of
non-NaN values: an all-NaN pixel gives NaN for avg, min, max and median,
and 0 for sum and count.  ``torch.nanmedian`` takes the lower middle
value, not the mean of the two, so it is not the same function.

:func:`raster_combine` is the entry point.  On CUDA tensors it launches
``csrc/raster_combine.cu`` (built at first use) or raises; on CPU tensors
it runs :func:`combine_ref`.  Both sum over t in order and round every
step once, and both take the median's order statistics by counting, so
they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from .projection import check_rc

#: reducer name -> the kernel's code
REDUCERS = {"avg": 0, "min": 1, "max": 2, "median": 3, "sum": 4,
            "count": 5}


def combine_ref(stack: torch.Tensor, reducer: str) -> torch.Tensor:
    """Plain version: a loop over the stack's tiles in order."""
    nan = torch.tensor(float("nan"), dtype=stack.dtype, device=stack.device)
    valid = ~torch.isnan(stack)
    n = valid.sum(dim=0, dtype=torch.int64)
    if reducer in ("avg", "sum", "count"):
        s = torch.zeros_like(stack[0])
        for t in range(stack.shape[0]):
            s = s + torch.where(valid[t], stack[t], 0.0)
        if reducer == "sum":
            return s
        n = n.to(stack.dtype)
        return n if reducer == "count" else s / n
    if reducer in ("min", "max"):
        m = torch.full_like(stack[0], float("inf") if reducer == "min"
                            else float("-inf"))
        for t in range(stack.shape[0]):
            v = stack[t]
            m = torch.where(v < m if reducer == "min" else v > m, v, m)
        return torch.where(n > 0, m, nan)
    if reducer != "median":
        raise ValueError(f"unknown reducer {reducer!r}")
    q = 0.5 * (n - 1).to(stack.dtype)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    klo, khi = lo.to(torch.int64), hi.to(torch.int64)
    s_lo = torch.full_like(stack[0], float("nan"))
    s_hi = s_lo.clone()
    have_lo = torch.zeros_like(valid[0])
    have_hi = torch.zeros_like(valid[0])
    for i in range(stack.shape[0]):
        vi = stack[i]
        lt = (stack < vi).sum(dim=0, dtype=torch.int64)
        eq = (stack == vi).sum(dim=0, dtype=torch.int64)
        hit_lo = valid[i] & ~have_lo & (lt <= klo) & (klo < lt + eq)
        hit_hi = valid[i] & ~have_hi & (lt <= khi) & (khi < lt + eq)
        s_lo = torch.where(hit_lo, vi, s_lo)
        s_hi = torch.where(hit_hi, vi, s_hi)
        have_lo |= hit_lo
        have_hi |= hit_hi
    return torch.where(n > 0, s_lo * lw + s_hi * hw, nan)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = _kernels.load("raster_combine")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.raster_combine_launch.argtypes = [vp, i, ctypes.c_int64, i, vp, vp]
    lib.raster_combine_launch.restype = i
    lib.raster_combine_error_string.argtypes = [i]
    lib.raster_combine_error_string.restype = ctypes.c_char_p
    return lib


def raster_combine(stack: torch.Tensor, reducer: str = "avg"
                   ) -> torch.Tensor:
    """[B, H, W] f64: ``reducer`` (avg, min, max, median, sum or count)
    over the non-NaN values of each pixel of the [T, B, H, W] f64
    ``stack``.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream and raise on anything it does not take or on a
    CUDA error; there is no fallback.  ``raster_combine.launches`` counts
    kernel launches."""
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}")
    if stack.dim() != 4 or stack.dtype != torch.float64 or \
            stack.shape[0] < 1:
        raise ValueError(f"raster_combine: stack must be [T, B, H, W] "
                         f"float64 with T >= 1, got {tuple(stack.shape)} "
                         f"{stack.dtype}")
    dev = stack.device
    if dev.type == "cpu":
        return combine_ref(stack, reducer)
    if dev.type != "cuda":
        raise ValueError(f"raster_combine: unsupported device {dev}")
    stack = stack.contiguous()
    out = torch.empty(stack.shape[1:], dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.raster_combine_launch(
            stack.data_ptr(), int(stack.shape[0]), out.numel(),
            REDUCERS[reducer], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "raster_combine", rc, "launch")
    raster_combine.launches += 1
    return out


raster_combine.launches = 0
