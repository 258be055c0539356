"""Pretty table rendering.

Port of ``mosaic_tpu.sql.prettifier`` (reference: sql/Prettifier.scala:13,
``prettified(df)``): result rows render with binary geometry columns
truncated to a readable prefix instead of a wall of bytes.  Geometry
columns show truncated WKT, byte columns a hex prefix, floats are
shortened.
"""

from __future__ import annotations

import numpy as np

from ..core.geometry.array import GeometryArray
from .engine import Table

_MAXW = 40


def _cell(v) -> str:
    if isinstance(v, (bytes, bytearray)):
        h = v[:8].hex()
        return f"0x{h}{'…' if len(v) > 8 else ''}"
    if isinstance(v, float) or isinstance(v, np.floating):
        s = f"{v:.6g}"
    else:
        s = str(v)
    return s if len(s) <= _MAXW else s[:_MAXW - 1] + "…"


def _column_cells(col, n: int):
    if isinstance(col, GeometryArray):
        from ..core.geometry.wkt import write_wkt
        out = []
        for i in range(n):
            w = write_wkt(col.take(np.asarray([i])))[0]
            out.append(w if len(w) <= _MAXW else w[:_MAXW - 1] + "…")
        return out
    if isinstance(col, np.ndarray):
        return [_cell(v) for v in col[:n].tolist()]
    return [_cell(v) for v in col[:n]]


def prettified(table: Table, num_rows: int = 20) -> str:
    """Render ``table`` as an aligned text grid (reference:
    Prettifier.prettified)."""
    n = min(num_rows, len(table))
    names = list(table.columns)
    grid = [_column_cells(table.columns[c], n) for c in names]
    widths = [max(len(names[j]), *(len(r) for r in grid[j])) if n else
              len(names[j]) for j in range(len(names))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep,
             "|" + "|".join(f" {names[j]:<{widths[j]}} "
                            for j in range(len(names))) + "|",
             sep]
    for i in range(n):
        lines.append("|" + "|".join(
            f" {grid[j][i]:<{widths[j]}} " for j in range(len(names)))
            + "|")
    lines.append(sep)
    if len(table) > n:
        lines.append(f"({len(table) - n} more rows)")
    return "\n".join(lines)
