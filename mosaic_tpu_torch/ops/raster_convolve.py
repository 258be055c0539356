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
``csrc/raster_convolve.cu`` (built at first use) or raises; on CPU
tensors it runs :func:`convolve_ref`.  Both sum the taps in row-major
order from 0 with every product and sum rounded once, so they agree bit
for bit.  No library convolution stands in:
cuDNN's f32 convolution runs in TF32 by default, and is not a port.

The kernel has instances of a fixed stencil (3 x 3, 4 x 4, 5 x 5, 7 x 7)
and two of any stencil (a 128 x 16 tile, and a 32 x 8 tile for stencils
too large for the first one's shared memory), in f64 and f32.
:func:`launch_plan` picks one and checks the sizes; it is plain Python
and launches nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import _kernels
from .projection import check_rc

#: output rows a thread, and the instance table: (kh, kw) of a fixed-size
#: instance or (0, 0) for any stencil, output columns a block, row groups
#: a block.  A step of a block covers tile_w x (row groups *
#: ROWS_PER_THREAD) outputs.  The same table is csrc/raster_convolve.cu's
#: kR and kInstances; :func:`_lib` checks the two agree.
ROWS_PER_THREAD = 8
INSTANCES = ((3, 3, 256, 1), (4, 4, 256, 1), (5, 5, 128, 2), (7, 7, 64, 2),
             (0, 0, 128, 2), (0, 0, 32, 1))
#: shared memory one block may take on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: the kernel's int arguments.  Its grid is persistent (one block per
#: resident slot, each walking a range of (band, strip, step) units
#: counted in 64 bits), so no grid dimension limits the bands or rows;
#: its int row and column indices reach a side plus two steps and a
#: stencil side (a side that fits SMEM_LIMIT is below SMEM_LIMIT / 4)
MAX_BANDS = 2 ** 31 - 1
MAX_ROWS = MAX_COLS = 2 ** 30


def tile_rows(instance: int) -> int:
    """Output rows a step of ``instance`` covers."""
    return INSTANCES[instance][3] * ROWS_PER_THREAD


def smem_bytes(instance: int, kh: int, kw: int, itemsize: int) -> int:
    """Shared memory of ``instance`` for a kh x kw stencil: a ring of the
    rows of a step and its halo and of the next step, tile_w + kw - 1
    wide, and the weights of a runtime-size instance."""
    fixed_kh, _, tile_w, _ = INSTANCES[instance]
    ring = (2 * tile_rows(instance) + kh - 1) * (tile_w + kw - 1)
    return (ring + (0 if fixed_kh else kh * kw)) * itemsize


def pick_instance(kh: int, kw: int, itemsize: int) -> int:
    """The instance for a kh x kw stencil of ``itemsize``-byte values:
    the fixed-size one of that stencil, else the first runtime-size one
    whose shared memory fits.  ValueError when none does."""
    for i, (fkh, fkw, *_) in enumerate(INSTANCES):
        if (fkh, fkw) == (kh, kw):
            return i
    for i, (fkh, *_) in enumerate(INSTANCES):
        if fkh == 0 and smem_bytes(i, kh, kw, itemsize) <= SMEM_LIMIT:
            return i
    raise ValueError(f"raster_convolve: a {kh} x {kw} stencil of "
                     f"{itemsize}-byte values needs more shared memory "
                     f"than a block has ({SMEM_LIMIT} bytes)")


def launch_plan(shape: Sequence[int], kshape: Sequence[int],
                itemsize: int) -> int:
    """The instance that launches for a [B, H, W] raster and a [kh, kw]
    stencil, or ValueError when the kernel does not take them."""
    B, H, W = (int(v) for v in shape)
    kh, kw = (int(v) for v in kshape)
    if B > MAX_BANDS or H > MAX_ROWS or W > MAX_COLS:
        raise ValueError(f"raster_convolve: [{B}, {H}, {W}] exceeds the "
                         f"kernel's limits ([{MAX_BANDS}, {MAX_ROWS}, "
                         f"{MAX_COLS}])")
    return pick_instance(kh, kw, itemsize)


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
    """The kernel's library, built at first use, with its C signatures;
    raises if its instance table is not :data:`INSTANCES`."""
    lib = _kernels.load("raster_convolve")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in ("raster_convolve_f64_launch", "raster_convolve_f32_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i, i, i, vp, i, i, i, vp, vp]
        fn.restype = i
    lib.raster_convolve_error_string.argtypes = [i]
    lib.raster_convolve_error_string.restype = ctypes.c_char_p
    lib.raster_convolve_instances.argtypes = [vp, i]
    lib.raster_convolve_instances.restype = i
    table = (ctypes.c_int * (5 * len(INSTANCES)))()
    n = lib.raster_convolve_instances(ctypes.addressof(table),
                                      len(INSTANCES))
    got = [tuple(table[5 * k:5 * k + 5]) for k in range(len(INSTANCES))]
    if n != len(INSTANCES) or \
            got != [(*inst, ROWS_PER_THREAD) for inst in INSTANCES]:
        raise RuntimeError(f"raster_convolve: the library's {n} instances "
                           f"{got} are not INSTANCES {INSTANCES} with "
                           f"{ROWS_PER_THREAD} rows a thread")
    return lib


def raster_convolve(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, H, W] SAME cross-correlation of ``x`` with the [kh, kw]
    weights ``w``, both f64 or both f32, on one device.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream, the instance :func:`launch_plan` picks, and raise
    on anything it does not take (before any launch) or on a CUDA error;
    there is no fallback.  ``raster_convolve.launches`` counts kernel
    launches."""
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
    instance = launch_plan(x.shape, w.shape, x.element_size())
    B, H, W = (int(v) for v in x.shape)
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    launch = (lib.raster_convolve_f64_launch if x.dtype == torch.float64
              else lib.raster_convolve_f32_launch)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(x.data_ptr(), B, H, W, w.data_ptr(), int(w.shape[0]),
                    int(w.shape[1]), instance, out.data_ptr(), stream)
    check_rc(lib, "raster_convolve", rc, "launch")
    raster_convolve.launches += 1
    return out


raster_convolve.launches = 0
