"""Per-geometry measures of padded edge blocks: a hand-written CUDA kernel
for Hopper and its plain PyTorch version.

Counterpart of the XLA bodies of ``mosaic_tpu.core.geometry.measures``
``area``, ``length``, ``centroid`` and ``bounds``: a masked reduction
over each geometry's padded edges (a, b [G, E, 2] and mask [G, E] of an
``EdgeBlocks``), in float32 or float64.  The formulas, the 1e-300 guards
(0 in float32, where the JAX body's 1e-300 rounds to 0) and the NaN
rules are in ``csrc/edge_measures.cu``.

:func:`edge_measures` is the entry point.  On CUDA tensors it launches
``csrc/edge_measures.cu`` (built at first use), one launch a call, by
the mapping :func:`launch_plan` picks (staged tiles of whole rows, or a
warp a geometry), or raises; on CPU tensors it runs
:func:`edge_measures_ref`.  Both add each quantity over the edge slots
left to right and round every step once, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _kernels
from .projection import check_rc

#: measure name -> the kernel's code
MEASURES = {"area": 0, "length": 1, "centroid": 2, "bounds": 3}
#: output columns of each measure (0: a [G] vector)
WIDTH = {"area": 0, "length": 0, "centroid": 2, "bounds": 4}
#: the kernel's mappings: staged tiles of 128 whole rows (a thread a row,
#: 8 slots a copy stage), or a warp a geometry over 32 slots at a time
PATHS = {"staged": 0, "warp": 1}
#: the staged tiles take E <= STAGED_SLOTS slots and G >= STAGED_ROWS rows
#: (``kStagedSlots``, ``kStagedRows`` in the source)
STAGED_SLOTS = 32
STAGED_ROWS = 32768


def launch_plan(G: int, E: int) -> str:
    """The mapping a launch takes for G rows of E slots: "staged" where
    the slots are few and the rows fill the card's tiles, else "warp"
    (few rows, or many slots a row: a warp a geometry keeps every lane
    busy)."""
    return "staged" if E <= STAGED_SLOTS and G >= STAGED_ROWS else "warp"


def guards(dtype: torch.dtype):
    """(eps, tiny) of the JAX body in ``dtype``: its ``+ 1e-300`` guard,
    which rounds to 0 in float32, and its ``> 1e-30`` thresholds."""
    if dtype == torch.float64:
        return 1e-300, 1e-30
    return 0.0, float(torch.tensor(1e-30, dtype=torch.float32))


def check_blocks(name: str, a: torch.Tensor, b: torch.Tensor,
                 mask: torch.Tensor) -> None:
    """Raise ValueError unless a and b are [G, E, 2] float32 or float64
    of one type and device and mask is [G, E] bool beside them."""
    if a.dim() != 3 or a.shape[-1] != 2 or b.shape != a.shape or \
            mask.shape != a.shape[:2]:
        raise ValueError(f"{name}: edges must be a, b [G, E, 2] and mask "
                         f"[G, E], got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(mask.shape)}")
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype \
            or mask.dtype != torch.bool:
        raise ValueError(f"{name}: a and b must be float32 or float64 of "
                         f"one type and mask bool, got {a.dtype}, "
                         f"{b.dtype}, {mask.dtype}")
    if b.device != a.device or mask.device != a.device:
        raise ValueError(f"{name}: a, b and mask lie on different devices")


def keep_min(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's running minimum: v where v < m or v is NaN."""
    return torch.where((v < m) | torch.isnan(v), v, m)


def keep_max(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where((v > m) | torch.isnan(v), v, m)


def edge_measures_ref(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                      what: str) -> torch.Tensor:
    """Plain version: a loop over the edge slots in order."""
    G, E = mask.shape
    dt = a.dtype
    ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    if what == "bounds":
        inf = torch.full((G,), float("inf"), dtype=dt, device=a.device)
        lo = [inf, inf]
        hi = [-inf, -inf]
        for e in range(E):
            m = mask[:, e]
            for k, (p, q) in enumerate(((ax, bx), (ay, by))):
                lo[k] = torch.where(m, keep_min(keep_min(lo[k], p[:, e]),
                                                q[:, e]), lo[k])
                hi[k] = torch.where(m, keep_max(keep_max(hi[k], p[:, e]),
                                                q[:, e]), hi[k])
        return torch.stack([lo[0], lo[1], hi[0], hi[1]], -1)
    zero = torch.zeros(G, dtype=dt, device=a.device)
    A = L = sx = sy = lx = ly = vx = vy = zero
    for e in range(E):
        m = mask[:, e]
        if what != "length":
            w = torch.where(m, ax[:, e] * by[:, e] - ay[:, e] * bx[:, e],
                            zero)
            A = A + w
        if what != "area":
            dx = bx[:, e] - ax[:, e]
            dy = by[:, e] - ay[:, e]
            ln = torch.where(m, torch.sqrt(dx * dx + dy * dy), zero)
            L = L + ln
        if what == "centroid":
            sx = sx + (ax[:, e] + bx[:, e]) * w
            sy = sy + (ay[:, e] + by[:, e]) * w
            lx = lx + 0.5 * (ax[:, e] + bx[:, e]) * ln
            ly = ly + 0.5 * (ay[:, e] + by[:, e]) * ln
            vx = vx + torch.where(m, ax[:, e], zero)
            vy = vy + torch.where(m, ay[:, e], zero)
    if what == "area":
        v = 0.5 * A
        return torch.where((v > 0) | torch.isnan(v), v, zero)
    if what == "length":
        return L
    if what != "centroid":
        raise ValueError(f"unknown measure {what!r}")
    eps, tiny = guards(dt)
    n = mask.sum(-1).to(dt)
    poly = torch.stack([sx, sy], -1) / (3.0 * A + eps)[:, None]
    line = torch.stack([lx, ly], -1) / (L + eps)[:, None]
    vert = torch.stack([vx, vy], -1) / (n + eps)[:, None]
    return torch.where((A.abs() > tiny)[:, None], poly,
                       torch.where((L > tiny)[:, None], line, vert))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures;
    raises if its mapping rule is not :func:`launch_plan`'s."""
    lib = _kernels.load("edge_measures")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for t in ("f32", "f64"):
        fn = getattr(lib, f"edge_measures_{t}_launch")
        fn.argtypes = [vp, vp, vp, ctypes.c_int64, i, i, vp, vp]
        fn.restype = i
        fn = getattr(lib, f"edge_measures_{t}_launch_path")
        fn.argtypes = [vp, vp, vp, ctypes.c_int64, i, i, i, vp, vp]
        fn.restype = i
    lib.edge_measures_plan.argtypes = [ctypes.c_int64, i]
    lib.edge_measures_plan.restype = i
    lib.edge_measures_error_string.argtypes = [i]
    lib.edge_measures_error_string.restype = ctypes.c_char_p
    for G in (1, STAGED_ROWS - 1, STAGED_ROWS, 1 << 20):
        for E in (0, 1, 8, STAGED_SLOTS, STAGED_SLOTS + 1, 4096):
            if lib.edge_measures_plan(G, E) != PATHS[launch_plan(G, E)]:
                raise _kernels.KernelError(
                    f"edge_measures: the library maps {G} rows of {E} "
                    f"slots to path {lib.edge_measures_plan(G, E)}, "
                    f"launch_plan to {launch_plan(G, E)!r}")
    return lib


def edge_measures(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                  what: str, path=None) -> torch.Tensor:
    """``what`` (area [G], length [G], centroid [G, 2] or bounds [G, 4])
    of each geometry of the edge blocks a, b [G, E, 2] and mask [G, E],
    in the blocks' type.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    on the current stream, by the mapping ``path`` ("staged" or "warp";
    None: :func:`launch_plan`'s), and raise on anything it does not take
    or on a CUDA error; there is no fallback.  Any contiguous view is
    taken, whatever the alignment of its data.
    ``edge_measures.launches`` counts kernel launches."""
    if what not in MEASURES:
        raise ValueError(f"unknown measure {what!r}")
    if path is not None and path not in PATHS:
        raise ValueError(f"edge_measures: unknown path {path!r}")
    check_blocks("edge_measures", a, b, mask)
    dev = a.device
    if dev.type == "cpu":
        return edge_measures_ref(a, b, mask, what)
    if dev.type != "cuda":
        raise ValueError(f"edge_measures: unsupported device {dev}")
    if a.shape[1] >= 1 << 31:
        raise ValueError("edge_measures: too many edge slots a geometry")
    a, b, mask = a.contiguous(), b.contiguous(), mask.contiguous()
    G, E = mask.shape
    out = torch.empty((G, WIDTH[what]) if WIDTH[what] else (G,),
                      dtype=a.dtype, device=dev)
    lib = _lib()
    fn = lib.edge_measures_f64_launch_path if a.dtype == torch.float64 \
        else lib.edge_measures_f32_launch_path
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), mask.data_ptr(), G, E,
                MEASURES[what], PATHS[path or launch_plan(G, E)],
                out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check_rc(lib, "edge_measures", rc, "launch")
    edge_measures.launches += 1
    return out


edge_measures.launches = 0
