"""Shared power-of-2 shape-bucketing policy for ragged batches.

Port copy of ``mosaic_tpu.perf.bucketing``.  Ragged dimensions (polygon
edge counts, ring vertex counts, sparse pair blocks) are padded up to a
power of two so a whole workload collapses onto O(log(max size)) shapes:
in the JAX package that bounds recompiles; in the port the tessellation
engine uses the same buckets to run each size class as one vectorized
numpy pass.  Pure numpy.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["pow2_bucket", "iter_size_buckets", "pad_rows",
           "pad_to_block"]


def pow2_bucket(n: int, floor: int = 4,
                cap: Optional[int] = None) -> int:
    """Smallest power of two >= max(n, floor), clamped to ``cap``.

    The floor stops tiny batches from fragmenting into 1/2/4-wide
    compiles; the cap bounds the padding waste for huge outliers
    (callers then block-loop over the capped width)."""
    n = max(int(n), 1)
    b = max(int(floor), 1 << int(np.ceil(np.log2(n))))
    if cap is not None:
        b = min(b, int(cap))
    return b


def iter_size_buckets(sizes, floor: int = 4
                      ) -> Iterator[Tuple[int, np.ndarray]]:
    """Group items into pow2 size buckets: yields ``(width, indices)``.

    ``sizes[i]`` is item i's ragged dimension; each yielded bucket
    satisfies ``sizes[indices] <= width`` with ``width`` the pow2
    bucket of its smallest member — identical semantics to the inline
    ``while start < T`` loops this replaces in ``tessellate``.  Items
    come out sorted by size (stable), so bucket membership is
    deterministic for a given input order."""
    sizes = np.asarray(sizes)
    order = np.argsort(sizes, kind="stable")
    s = 0
    while s < len(order):
        width = pow2_bucket(sizes[order[s]], floor)
        e = s
        while e < len(order) and sizes[order[e]] <= width:
            e += 1
        yield width, order[s:e]
        s = e


def pad_rows(arr: np.ndarray, rows: int, fill=0.0) -> np.ndarray:
    """Pad axis 0 of ``arr`` up to ``rows`` with ``fill`` (no copy when
    already that size)."""
    n = arr.shape[0]
    if n == rows:
        return arr
    if n > rows:
        raise ValueError(f"cannot pad {n} rows down to {rows}")
    out = np.full((rows, *arr.shape[1:]), fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def pad_to_block(block: int, *arrays, fills=None):
    """Pad several same-length arrays to ``block`` rows at once.

    ``fills`` is an optional per-array fill sequence (default 0).
    Returns the padded tuple plus the original row count."""
    n = arrays[0].shape[0]
    if fills is None:
        fills = [0.0] * len(arrays)
    return tuple(pad_rows(a, block, f)
                 for a, f in zip(arrays, fills)) + (n,)
