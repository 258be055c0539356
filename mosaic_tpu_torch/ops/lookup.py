"""Sorted-table lookups on the device.

Port of ``mosaic_tpu.ops.lookup``.  The polygon side of the sorted PIP
join is a sorted int64 cell-id table on the device, and the "join" is a
vectorized binary search per point.  The JAX package unrolls its own
branchless search; here ``torch.searchsorted`` gives the same indices
(the first ``i`` with ``table[i] >= key``), compared in int64 with no
cast through float, so H3 ids, which use the high bits, stay exact.
"""

from __future__ import annotations

from typing import Tuple

import torch


def searchsorted(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """First index where ``table[i] >= key``: table [T] sorted int64, keys
    [...] int64 -> [...] int32 in [0, T]."""
    if table.shape[0] == 0:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    return torch.searchsorted(table, keys.contiguous(), out_int32=True)


def lookup(table: torch.Tensor, keys: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index, found) of each key in a sorted table (exact match); the
    index is clamped into the table, and 0 for an empty table."""
    if table.shape[0] == 0:
        return (torch.zeros(keys.shape, dtype=torch.int32,
                            device=keys.device),
                torch.zeros(keys.shape, dtype=torch.bool,
                            device=keys.device))
    safe = searchsorted(table, keys).clamp_(max=table.shape[0] - 1)
    return safe, table[safe] == keys
