"""SpatialKNN's all-pairs top-k: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Counterpart of the XLA body of ``mosaic_tpu.models.knn``'s brute pass
(``_brute_device_topk``'s ``kern``): for each left row of a block, the kc
right points of smallest f32 squared distance on block-centered
coordinates, ascending, ties to the lower right index (``lax.top_k``'s
rule on the negated distances).

:func:`brute_topk` is the entry point.  It takes the block's centered
f32 left rows, the whole f64 right side and the block's f64 center; the
centered f32 right side is ``(right - center)`` rounded to f32, the bits
of numpy's ``(right_xy - center).astype(np.float32)``.  On CUDA tensors
it launches ``csrc/knn_brute_topk.cu`` (built at first use), which forms
that copy itself, or raises; on CPU tensors it runs
:func:`brute_topk_ref` on :func:`center_right`'s copy.  The two agree bit
for bit at every ``1 <= kc <= m``: the kernel keeps up to ``KC_PASS``
keys a row in one launch, and a wider kc takes one launch per
``KC_PASS`` columns, each the next keys after the last one stored.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _kernels
from .projection import check_rc

#: the widest list one launch keeps (32 lanes x 32 register slots)
KC_PASS = 1024


def center_right(right: torch.Tensor, center) -> torch.Tensor:
    """[m, 2] f32: the f64 right side minus the f64 center, rounded."""
    c = torch.tensor([float(center[0]), float(center[1])],
                     dtype=torch.float64, device=right.device)
    return (right - c).to(torch.float32)


def brute_topk_ref(lc: torch.Tensor, rc: torch.Tensor, kc: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (d2 [B, kc] f32 ascending, idx [B, kc] i32) of
    ``dx * dx + dy * dy`` over every (left, right) pair, ordered by a
    stable sort, so equal distances keep the lower right index first."""
    dx = lc[:, None, 0] - rc[None, :, 0]
    dy = lc[:, None, 1] - rc[None, :, 1]
    d2, idx = torch.sort(dx * dx + dy * dy, dim=1, stable=True)
    return d2[:, :kc].contiguous(), idx[:, :kc].to(torch.int32).contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = _kernels.load("knn_brute_topk")
    vp, i, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_double)
    lib.knn_brute_topk_launch.argtypes = [vp, i64, vp, i, f64, f64, i, i, i,
                                          vp, vp, vp]
    lib.knn_brute_topk_launch.restype = i
    lib.knn_brute_topk_error_string.argtypes = [i]
    lib.knn_brute_topk_error_string.restype = ctypes.c_char_p
    return lib


def brute_topk(lc: torch.Tensor, right: torch.Tensor, center, kc: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2 [B, kc] f32, idx [B, kc] i32) of the block's left rows ``lc``
    ([B, 2] f32, centered on ``center``) against ``right`` ([m, 2] f64,
    uncentered) centered on ``center`` (two f64 numbers) and rounded to
    f32.

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream, one per ``KC_PASS`` columns of kc, and raise on
    anything it does not take or on a CUDA error; there is no fallback.
    ``brute_topk.launches`` counts kernel launches."""
    m = int(right.shape[0]) if right.dim() == 2 else -1
    if kc < 1:
        raise ValueError(f"brute_topk: kc {kc} < 1")
    if lc.dtype != torch.float32 or lc.dim() != 2 or lc.shape[1] != 2:
        raise ValueError(f"brute_topk: lc must be [B, 2] float32, got "
                         f"{tuple(lc.shape)} {lc.dtype}")
    if right.dtype != torch.float64 or m < 0 or right.shape[1] != 2:
        raise ValueError(f"brute_topk: right must be [m, 2] float64, got "
                         f"{tuple(right.shape)} {right.dtype}")
    if kc > m:
        raise ValueError(f"brute_topk: kc {kc} > {m} right rows")
    if lc.device != right.device:
        raise ValueError(f"brute_topk: lc on {lc.device}, right on "
                         f"{right.device}")
    dev = lc.device
    if dev.type == "cpu":
        return brute_topk_ref(lc, center_right(right, center), kc)
    if dev.type != "cuda":
        raise ValueError(f"brute_topk: unsupported device {dev}")
    lc, right = lc.contiguous(), right.contiguous()
    if lc.data_ptr() % 8 or right.data_ptr() % 16:
        raise ValueError("brute_topk: lc must be 8-byte and right 16-byte "
                         "aligned (read as float2 and double2)")
    n = int(lc.shape[0])
    d2 = torch.empty((n, kc), dtype=torch.float32, device=dev)
    idx = torch.empty((n, kc), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for col0 in range(0, kc, KC_PASS):
            rc = lib.knn_brute_topk_launch(
                lc.data_ptr(), n, right.data_ptr(), m, float(center[0]),
                float(center[1]), kc, col0, min(KC_PASS, kc - col0),
                d2.data_ptr(), idx.data_ptr(), stream)
            check_rc(lib, "knn_brute_topk", rc, "launch")
            brute_topk.launches += 1
    return d2, idx


brute_topk.launches = 0
