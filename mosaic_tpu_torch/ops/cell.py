"""H3 cell assignment of absolute points: a hand-written CUDA kernel for
Hopper and its plain PyTorch version.

Counterpart of ``mosaic_tpu.core.index.h3.jaxkernel.latlng_to_cell_jax_margin``
as the H3 grid's device hook ``point_to_cell_jax_margin``
(``core/index/h3/system.py``) calls it: [N, 2] f32 absolute (lon, lat)
degrees -> (int64 cell ids [N], margin [N] f32 in planar degrees).  Per
point it repeats the hook's f32 radians -> degrees round trip, takes f32
sin and cos lifted to df, runs the df gnomonic projection of the
projection kernels (``csrc/h3_df.cuh``), aggregates the axial lattice
point from ``res`` down to res 0 (aperture 7), looks up the base cell and
rotates the digits (pentagon seam and relabel included), and scales the
hex margin to degrees, zero where the nearest face is ambiguous.

:func:`latlng_to_cell_margin` is the entry point.  On a CUDA tensor it
launches ``csrc/h3_cell.cu`` (built at first use) or raises; on a CPU
tensor it runs :func:`latlng_to_cell_margin_ref`, which keeps the
kernel's order of operations.  The kernel reads the cell tables packed
(:func:`cell_words`): the three digit rotations composed into one word
per (rotation, extra rotation, relabel).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .. import _kernels
from ..core.index.h3.constants import M_SQRT7, RES0_U_GNOMONIC
from ..core.index.h3.torchkernel import (DIGIT_OF_DIFF, FACEGAP_EPS,
                                         cell_from_lattice_ref, cell_tables,
                                         digit_fill)
from .projection import (DEG_PER_RAD, RAD_PER_DEG, check_points, check_rc,
                         device_table, host_constants, project_lattice_ref,
                         set_faces)

MAX_RES = 15
#: rotations of the digit rotation table (rot_digit is [ROTATIONS, 7])
ROTATIONS = 6
#: res-0 ijk entries of the base-cell tables (fijk_*, [20, 3, 3, 3])
N_ENTRIES = 540


def margin_scale(res: int) -> float:
    """Lattice units -> radians at ``res``, rounded to f32 (the gnomonic
    scale; distortion only enlarges planar distances)."""
    return float(np.float32(RES0_U_GNOMONIC / M_SQRT7 ** res))


def _check_res(res: int) -> None:
    if not 0 <= int(res) <= MAX_RES:
        raise ValueError(f"resolution {res} outside supported range 0..15")


def latlng_to_cell_margin_ref(xy: torch.Tensor, res: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: [N, 2] f32 absolute (lon, lat)
    degrees -> (cells [N] int64, margin [N] f32 planar degrees), on the
    input's device."""
    _check_res(res)
    xy = xy.to(torch.float32)
    # the hook's degrees -> radians, then the kernel's radians -> degrees
    # (system.py point_to_cell_jax_margin into latlng_to_cell_jax_margin)
    lng = xy[:, 0] * RAD_PER_DEG
    lat = xy[:, 1] * RAD_PER_DEG
    deg = torch.stack([lng * DEG_PER_RAD, lat * DEG_PER_RAD], dim=1)
    face, a, b, margin, gap = project_lattice_ref(deg, res, None)
    cells = cell_from_lattice_ref(face, a, b, res)
    margin = margin * margin_scale(res)
    margin = torch.where(gap < float(np.float32(FACEGAP_EPS)),
                         torch.zeros_like(margin), margin)
    return cells, margin * DEG_PER_RAD


# ------------------------------------------- the kernel's packed tables

def rotate_digit(r: int, d: int) -> int:
    """The digit rotation table's entry for rotation ``r`` of digit ``d``,
    its index clamped into the table as the plain version clamps it."""
    rot = cell_tables()["rot_digit"]
    return int(rot[min(max(r * 7 + d, 0), rot.size - 1)])


def rotation_word(r0: int, extra: int, relabel: int) -> int:
    """The three digit rotations of the cell step composed, for digits 0-7
    (7 never comes from a lattice point, but the clamped tables give it a
    value): bits 3d..3d+2 hold relabel(extra(r0(d)))."""
    word = 0
    for d in range(8):
        out = rotate_digit(relabel, rotate_digit(extra, rotate_digit(r0, d)))
        word |= out << (3 * d)
    return word


def entry_word(entry: int) -> int:
    """One res-0 ijk entry's base cell (bits 0-6), its rotation (7-9), its
    pentagon extra rotation (10-12), the base cell's pentagon flag (13)
    and seam digit (14-16)."""
    t = cell_tables()
    base = int(t["fijk_base"][entry])
    return (base | int(t["fijk_rot"][entry]) << 7 |
            int(t["fijk_extra"][entry]) << 10 |
            int(t["is_pent"][base]) << 13 | int(t["pent_seam"][base]) << 14)


@functools.cache
def cell_words() -> np.ndarray:
    """The kernel's int32 cell tables: N_ENTRIES entry words
    (:func:`entry_word`), then the rotation words (:func:`rotation_word`)
    at ((r0 * 6) + extra) * 2 + relabel."""
    t = cell_tables()
    for name, hi in (("fijk_base", 127), ("fijk_rot", ROTATIONS - 1),
                     ("fijk_extra", ROTATIONS - 1), ("pent_seam", 7)):
        assert 0 <= t[name].min() and t[name].max() <= hi, name
    assert t["fijk_base"].size == N_ENTRIES
    words = [entry_word(e) for e in range(N_ENTRIES)]
    words += [rotation_word(r0, extra, relabel)
              for r0 in range(ROTATIONS) for extra in range(ROTATIONS)
              for relabel in range(2)]
    return np.array(words, np.int64).astype(np.int32)


def digit_of_diff_word() -> int:
    """DIGIT_OF_DIFF as one word, 3 bits an entry."""
    return sum(int(d) << (3 * i) for i, d in enumerate(DIGIT_OF_DIFF))


# ------------------------------------------------------------- kernel

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _kernels.load("h3_cell")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.h3_cell_set_faces.argtypes = [vp]
    lib.h3_cell_set_faces.restype = i
    lib.h3_latlng_to_cell.argtypes = [vp, i, vp, vp, vp, i, ctypes.c_uint,
                                      ctypes.c_int64, ctypes.c_float,
                                      ctypes.c_float, vp, vp, vp]
    lib.h3_latlng_to_cell.restype = i
    lib.h3_cell_sincos_mismatches.argtypes = [vp, vp]
    lib.h3_cell_sincos_mismatches.restype = i
    lib.h3_cell_error_string.argtypes = [i]
    lib.h3_cell_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def device_cell_tables(device: torch.device) -> torch.Tensor:
    """The kernel's packed cell tables (:func:`cell_words`) on ``device``;
    uploaded once."""
    return torch.from_numpy(cell_words()).to(device).contiguous()


def prepare(device: torch.device, res: int) -> None:
    """Build the kernel and put its tables on ``device`` (face centers,
    basis table at ``res``, cell tables) — blocking work a caller does
    before a stream-ordered loop, so no launch copies a table."""
    set_faces(_lib(), "h3_cell", device)
    device_table(res, device)
    device_cell_tables(device)


def latlng_to_cell_margin(xy: torch.Tensor, res: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 2] f32 absolute (lon, lat) degrees -> (cells [N] int64, margin
    [N] f32 planar degrees).

    A CPU tensor runs the plain version.  A CUDA tensor launches the
    kernel on the current stream and raises on anything it does not take
    (dtype, shape, contiguity, alignment, resolution) or on a CUDA error;
    there is no fallback.  ``latlng_to_cell_margin.launches`` counts
    kernel launches."""
    dev = xy.device
    if dev.type == "cpu":
        return latlng_to_cell_margin_ref(xy, res)
    if dev.type != "cuda":
        raise ValueError(f"latlng_to_cell_margin: unsupported device {dev}")
    _check_res(res)
    check_points(xy, "latlng_to_cell_margin")
    n = int(xy.shape[0])
    cells = torch.empty(n, dtype=torch.int64, device=dev)
    margin = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return cells, margin
    lib = _lib()
    prepare(dev, res)
    table = device_table(res, dev)
    ctab = device_cell_tables(dev)
    consts = host_constants((0.0, 0.0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.h3_latlng_to_cell(
            xy.data_ptr(), n, table.data_ptr(), ctab.data_ptr(),
            consts.ctypes.data, res, digit_of_diff_word(), digit_fill(res),
            margin_scale(res), float(np.float32(FACEGAP_EPS)),
            cells.data_ptr(), margin.data_ptr(), stream)
    check_rc(lib, "h3_cell", rc, "launch")
    latlng_to_cell_margin.launches += 1
    return cells, margin


latlng_to_cell_margin.launches = 0


def sincos_mismatches(device: torch.device) -> int:
    """The f32 inputs, of all 2^32 bit patterns, where the card's sincosf
    (which the kernel calls) gives other bits than its sinf or cosf; the
    kernel's bits equal the plain version's only where this is 0.
    Synchronizes."""
    lib = _lib()
    count = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        rc = lib.h3_cell_sincos_mismatches(
            count.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    check_rc(lib, "h3_cell", rc, "sincos check launch")
    return int(count.item())
