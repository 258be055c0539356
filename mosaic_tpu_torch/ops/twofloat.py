"""Double-single ("df") arithmetic on torch tensors: ~46-bit precision
from f32 pairs.

Port of ``mosaic_tpu.ops.twofloat``.  A df value is a pair (hi, lo) with
hi = fl(hi + lo) and |lo| <= ulp(hi)/2, representing hi + lo exactly.
The Dekker/Knuth error-free transformations below need every
intermediate rounded to f32 and nothing reassociated or contracted.
Each step is written as a plain ``+ - * /`` on tensors, so in eager
PyTorch it is one rounded elementwise kernel: nothing fuses a multiply
into an add (composite ops such as ``addcmul`` or ``lerp`` could, and
are not used).  The CUDA projection kernel (``csrc/h3_projection.cu``)
keeps the same order of operations with ``-fmad=false``.

References: Dekker (1971), "A floating-point technique for extending the
available precision"; Hida/Li/Bailey's ddfun patterns.  The constants use
the f32 Veltkamp split factor 2^12 + 1.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

_SPLIT = float(np.float32(4097.0))   # 2^12 + 1 (f32 has 24-bit mantissa)


class DF(NamedTuple):
    """A double-single value hi + lo (both f32 tensors)."""

    hi: torch.Tensor
    lo: torch.Tensor

    def to_f32(self) -> torch.Tensor:
        return self.hi

    def neg(self) -> "DF":
        return DF(-self.hi, -self.lo)


def df_const(x: Union[float, np.ndarray], device=None) -> DF:
    """Split host f64 value(s) into an exact df pair of f32 tensors."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(torch.as_tensor(hi, device=device),
              torch.as_tensor(lo, device=device))


def df_from_f32(x: torch.Tensor) -> DF:
    return DF(x, torch.zeros_like(x))


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """s + err == a + b exactly (Knuth; no magnitude assumption)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """s + err == a + b exactly, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    err = b - (s - a)
    return s, err


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """p + err == a * b exactly (Veltkamp split; no fma dependence)."""
    p = a * b
    ca = _SPLIT * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = _SPLIT * b
    bhi = cb - (cb - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def df_add(x: DF, y: DF) -> DF:
    """df + df (~11 flops, error <= 4 ulp²)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, y.neg())


def df_mul(x: DF, y: DF) -> DF:
    """df * df (~20 flops)."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_mul_f32(x: DF, c: torch.Tensor) -> DF:
    p, e = two_prod(x.hi, c)
    e = e + x.lo * c
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_div(x: DF, y: DF) -> DF:
    """df / df via one Newton-corrected quotient."""
    q1 = x.hi / y.hi
    r = df_sub(x, df_mul_f32(y, q1))
    q2 = (r.hi + r.lo) / y.hi
    hi, lo = fast_two_sum(q1, q2)
    return DF(hi, lo)


def df_round(x: DF) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nearest integer as f32, signed residual x - round(x) as f32).

    ``torch.round`` rounds half to even, as ``jnp.round`` does.  hi -
    round(hi) is exact (same-binade subtraction), so the residual
    carries the full df precision collapsed to f32."""
    r = torch.round(x.hi)
    frac = (x.hi - r) + x.lo
    # df rounding can land on the far side of a half-integer boundary
    adj = (frac > 0.5).to(x.hi.dtype) - (frac < -0.5).to(x.hi.dtype)
    return r + adj, frac - adj


def _one(like: torch.Tensor) -> DF:
    return DF(torch.ones_like(like), torch.zeros_like(like))


def df_poly_sin(d: DF) -> DF:
    """sin(d) for |d| <= 0.04 rad by Taylor series in df.

    Error < d^7/5040 ~ 3e-14 at the bound — below df resolution.  The
    projection guarantees the bound by limiting the localized window
    (torchkernel.MAX_LOCAL_DEG)."""
    d2 = df_mul(d, d)
    one = _one(d.hi)
    # d * (1 - d2/6 * (1 - d2/20))
    t = df_sub(one, df_mul_f32(d2, torch.full_like(d.hi, 1.0 / 20.0)))
    t = df_sub(one, df_mul(df_mul_f32(d2, torch.full_like(d.hi,
                                                          1.0 / 6.0)), t))
    return df_mul(d, t)


def df_poly_cos(d: DF) -> DF:
    """cos(d) for |d| <= 0.04 rad by Taylor series in df (err < 1e-15)."""
    d2 = df_mul(d, d)
    one = _one(d.hi)
    # 1 - d2/2 * (1 - d2/12 * (1 - d2/30))
    t = df_sub(one, df_mul_f32(d2, torch.full_like(d.hi, 1.0 / 30.0)))
    t = df_sub(one, df_mul(df_mul_f32(d2, torch.full_like(d.hi,
                                                          1.0 / 12.0)), t))
    return df_sub(one, df_mul(df_mul_f32(d2, torch.full_like(d.hi, 0.5)),
                              t))
