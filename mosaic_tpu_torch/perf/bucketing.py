"""Power-of-2 shape bucketing for ragged batches.

Port copy of ``mosaic_tpu.perf.bucketing.pow2_bucket``.  The sharded
streamed join pads each chunk's per-rank block to a power of two, so a
ragged tail lands in one of few block sizes and every rank's buffers
keep their shapes from chunk to chunk.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["pow2_bucket"]


def pow2_bucket(n: int, floor: int = 4,
                cap: Optional[int] = None) -> int:
    """Smallest power of two >= max(n, floor), clamped to ``cap``.

    The floor stops tiny batches from fragmenting into 1/2/4-wide
    blocks; the cap bounds the padding waste for huge outliers
    (callers then block-loop over the capped width)."""
    n = max(int(n), 1)
    b = max(int(floor), 1 << int(np.ceil(np.log2(n))))
    if cap is not None:
        b = min(b, int(cap))
    return b
