"""Host constants of the device H3 lattice projection.

Counterpart of ``mosaic_tpu.core.index.h3.jaxkernel``.  The projection
itself — points -> (face, axial a/b, margin, facegap) — is
``ops/projection.py``: a hand-written CUDA kernel on the card and its
plain torch version beside it.  This module keeps what the join and the
kernel share: the localized-window limit, the face-gap threshold, the
validated error bound of the df arithmetic, and the f64-derived tables
the kernel takes as arguments.

The port has no ``precision`` knob: the projection always runs df
(double-single f32), the arithmetic of the JAX package's Pallas kernel.
The JAX package's native-f64 path is its CPU test path and its plain f32
path a TPU fallback; neither is on the port's main path.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .constants import M_SIN60, M_SQRT7, RES0_U_GNOMONIC, face_center_xyz
from .hexmath import scaled_bases

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
