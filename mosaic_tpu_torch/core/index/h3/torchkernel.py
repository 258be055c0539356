"""Host constants of the device H3 lattice projection, and cell ids from
lattice coordinates.

Counterpart of ``mosaic_tpu.core.index.h3.jaxkernel``.  The projection
itself — points -> (face, axial a/b, margin, facegap) — is
``ops/projection.py``: a hand-written CUDA kernel on the card and its
plain torch version beside it.  This module keeps what the join and the
kernels share: the localized-window limit, the face-gap threshold, the
validated error bound of the df arithmetic, the f64-derived tables the
kernels take as arguments, and :func:`cell_from_lattice_ref`, the plain
torch version of (face, a, b) -> canonical int64 cell id that the cell
kernel of ``ops/cell.py`` runs on the card.

Axial-coordinate forms (a, b) = (i - k, j - k) of the aperture-7 steps,
derived from the ijk matrices in hexmath.py:

    plain:  up  a'=round((3a-b)/7), b'=round((a+2b)/7)
            down A=2a+b,  B=-a+3b
    rot:    up  a'=round((2a+b)/7), b'=round((3b-a)/7)
            down A=3a-b,  B=a+2b

The port has no ``precision`` knob: the projection always runs df
(double-single f32), the arithmetic of the JAX package's Pallas kernel.
The JAX package's native-f64 path is its CPU test path and its plain f32
path a TPU fallback; neither is on the port's main path.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .constants import (MAX_H3_RES, M_SIN60, M_SQRT7, RES0_U_GNOMONIC,
                        face_center_xyz)
from .hexmath import scaled_bases
from .index import MODE_CELL, _BASE_SHIFT, _MODE_SHIFT, _RES_SHIFT, \
    _digit_shift
from .tables import _down_rot, tables

#: localized inputs must stay within this window for the df Taylor
#: series' error bound (0.04 rad); checked by the PIP index builder.
MAX_LOCAL_DEG = 2.2

#: face-dot gap below which nearest-face selection is ambiguous in f32
#: (flag for host recheck; band is ~1e-7 of the sphere)
FACEGAP_EPS = 1e-6


def err_lattice_bound(res: int, precision: str,
                      max_abs_deg: float = 180.0,
                      localized: bool = True) -> float:
    """Upper bound (lattice units, 1 = cell pitch) on the device
    projection's planar error at ``res`` — the margin threshold below
    which cell assignment must be treated as uncertain.

    Derivation (validated by tools/validate_projection.py; 8x safety):
    * input representation: points arrive f32; an ulp at the coordinate
      magnitude, through radians and the gnomonic scale;
    * arithmetic: ~1e-7 relative (f32 paths), ~1e-13 (df), ~1e-15 (f64)
      of the planar magnitude (~scale * face radius).
    """
    scale = M_SQRT7 ** res / RES0_U_GNOMONIC
    ulp_deg = np.spacing(np.float32(max_abs_deg)) if not localized else \
        np.spacing(np.float32(min(max_abs_deg, MAX_LOCAL_DEG)))
    input_err = float(ulp_deg) * np.pi / 180.0 * scale * 1.3
    planar_mag = scale * RES0_U_GNOMONIC  # ~tan(face radius) * scale
    arith_rel = {"f32": 4e-7, "df": 1e-12, "f64": 1e-15}[precision]
    return 8.0 * (input_err + arith_rel * planar_mag)


def _split(v: float) -> Tuple[float, float]:
    """f64 -> exact (hi, lo) f32 pair, as python floats."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return float(hi), float(lo)


def face_centers_f32() -> np.ndarray:
    """[20, 3] f32 face-center unit vectors (the face-argmax operands)."""
    return face_center_xyz().astype(np.float32)


def basis_tables(res: int) -> np.ndarray:
    """[2, 20, 9] f32: hi then lo parts of each face's (F, E1s, E2s)
    rows — the gnomonic basis at ``res``, split from f64 on the host."""
    e1, e2 = scaled_bases(res)
    tbl = np.concatenate([face_center_xyz(), e1, e2], axis=1)   # [20, 9]
    hi = tbl.astype(np.float32)
    lo = (tbl - hi.astype(np.float64)).astype(np.float32)
    return np.stack([hi, lo])


def projection_constants(origin: Tuple[float, float]) -> np.ndarray:
    """[13] f32 constants of the projection for an origin (lon0, lat0)
    in degrees: df (hi, lo) pairs of pi/180, sin/cos of lat0, sin/cos
    of lon0 and 1/sin(60°), then sin(60°) rounded to f32.  Computed in
    f64 on the host exactly as the Pallas kernel bakes them in
    (``math`` functions, not numpy's)."""
    lon0, lat0 = float(origin[0]), float(origin[1])
    vals = [math.pi / 180.0,
            math.sin(math.radians(lat0)), math.cos(math.radians(lat0)),
            math.sin(math.radians(lon0)), math.cos(math.radians(lon0)),
            1.0 / M_SIN60]
    pairs = [p for v in vals for p in _split(v)]
    return np.array(pairs + [float(np.float32(M_SIN60))], np.float32)


# ------------------------------------------------- cell ids from lattice

#: axial diff (da+1)*3 + (db+1) -> digit (7 = impossible)
DIGIT_OF_DIFF = np.array([1, 3, 7, 5, 0, 2, 7, 4, 6], dtype=np.int32)

#: the int32 tables of the cell-id step, with their sizes (the cell
#: kernel reads them packed: ops/cell.py cell_words)
CELL_TABLES = (("fijk_base", 540), ("fijk_rot", 540), ("fijk_extra", 540),
               ("rot_digit", 42), ("is_pent", 122), ("pent_seam", 122),
               ("digit_of_diff", 9))


@functools.cache
def cell_tables() -> Dict[str, np.ndarray]:
    """Numpy int32 tables of the cell-id step (the JAX package's
    ``jaxkernel._consts``): per (face, i, j, k) of a res-0 normalized ijk
    the base cell, its rotation and its pentagon extra rotation; the
    digit rotation table; per base cell the pentagon flag and seam digit;
    and the axial-difference -> digit map."""
    t = tables()
    out = {
        "fijk_base": t.fijk_base.reshape(-1).astype(np.int32),
        "fijk_rot": np.maximum(t.fijk_rot, 0).reshape(-1).astype(np.int32),
        "fijk_extra": t.fijk_pent_extra.reshape(-1).astype(np.int32),
        "rot_digit": t.rot_digit.reshape(-1).astype(np.int32),
        "is_pent": t.is_pentagon.astype(np.int32),
        "pent_seam": t.pent_seam.astype(np.int32),
        "digit_of_diff": DIGIT_OF_DIFF,
    }
    for name, size in CELL_TABLES:
        assert out[name].shape == (size,), (name, out[name].shape)
    return out


def round_div7(p: torch.Tensor) -> torch.Tensor:
    """Nearest-integer p/7 for integer p (ties impossible): a FLOOR
    division, floor((2p + 7) / 14), which C's ``/`` and torch's
    ``rounding_mode="trunc"`` are not on negatives."""
    return torch.div(2 * p + 7, 14, rounding_mode="floor")


def digit_fill(res: int) -> int:
    """The id bits of the unused digits res+1..15, each 7 (per spec)."""
    fill = 0
    for rv in range(res + 1, MAX_H3_RES + 1):
        fill |= 7 << _digit_shift(rv)
    return fill


def cell_from_lattice_ref(face: torch.Tensor, ai: torch.Tensor,
                          bi: torch.Tensor, res: int) -> torch.Tensor:
    """(face, axial a, axial b) at ``res`` -> canonical int64 cell ids
    (aperture-7 aggregation, base-cell lookup, digit rotation with the
    pentagon seam and relabel), on the inputs' device.

    Plain version of the cell step of ``csrc/h3_cell.cu``, in its order.
    Table indices are clamped into their tables, as the kernel clamps
    them, so no input reads outside a table; the lattice point of a
    finite point never needs it."""
    dev = face.device
    c = {k: torch.from_numpy(v).to(dev) for k, v in cell_tables().items()}

    def at(name: str, i: torch.Tensor) -> torch.Tensor:
        return c[name][i.clamp(0, c[name].numel() - 1).long()]

    face, ai, bi = (t.to(torch.int32) for t in (face, ai, bi))
    digits = [None] * (res + 1)
    for rv in range(res, 0, -1):
        if _down_rot(rv):
            ua = round_div7(2 * ai + bi)
            ub = round_div7(3 * bi - ai)
            ca = 3 * ua - ub
            cb = ua + 2 * ub
        else:
            ua = round_div7(3 * ai - bi)
            ub = round_div7(ai + 2 * bi)
            ca = 2 * ua + ub
            cb = -ua + 3 * ub
        digits[rv] = at("digit_of_diff", (ai - ca + 1) * 3 + (bi - cb + 1))
        ai, bi = ua, ub

    # res-0 normalized ijk and base-cell entry
    mn = torch.clamp_max(torch.minimum(ai, bi), 0)
    entry = ((face * 3 + (ai - mn)) * 3 + (bi - mn)) * 3 - mn
    base = at("fijk_base", entry)
    r0 = at("fijk_rot", entry)

    # rotate digits to canonical orientation
    lead = torch.zeros_like(base)
    for rv in range(1, res + 1):
        digits[rv] = at("rot_digit", r0 * 7 + digits[rv])
        lead = torch.where((lead == 0) & (digits[rv] != 0), digits[rv],
                           lead)
    # pentagon seam re-expression, then internal -> published pentagon
    # labels: after the extra rotation, subtrees with leading digit 1 or
    # 5 rotate ccw once (index.py _pent_to_external has the derivation)
    is_pent = at("is_pent", base) == 1
    seam_hit = is_pent & (lead == at("pent_seam", base)) & (lead != 0)
    extra = torch.where(seam_hit, at("fijk_extra", entry), 0)
    lead_f = at("rot_digit", extra * 7 + lead)
    relabel = (is_pent & ((lead_f == 1) | (lead_f == 5))).to(torch.int32)
    h = (MODE_CELL << _MODE_SHIFT) | (res << _RES_SHIFT) | digit_fill(res)
    h = (base.to(torch.int64) << _BASE_SHIFT) | h
    for rv in range(1, res + 1):
        d = at("rot_digit", extra * 7 + digits[rv])
        d = at("rot_digit", relabel * 7 + d)
        h = h | (d.to(torch.int64) << _digit_shift(rv))
    return h
