"""Bbox extraction from a SQL WHERE clause — the pruning pushdown.

The planner never needs the user to annotate a spatial range: any
top-level AND-conjunct of the WHERE clause that compares one of the
store's point columns against a numeric literal tightens the scan
bbox (``x >= a AND x < b AND y > c ...``).  Everything else — OR
branches, function calls, comparisons between columns — is ignored,
which is always SAFE: an ignored predicate only means a looser bbox,
and pruning with a looser bbox scans more partitions, never fewer.
The WHERE clause itself still runs over the scanned rows, so results
are exact regardless of how much the pushdown understood.

Port copy of ``mosaic_tpu.store.pushdown`` over the port's
``sql/parser.py`` tree.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

__all__ = ["bbox_from_where"]

#: comparison spellings the extractor understands, normalized to
#: (tightens_min, tightens_max) for ``col OP literal``
_OPS = {">": (True, False), ">=": (True, False),
        "<": (False, True), "<=": (False, True),
        "=": (True, True), "==": (True, True)}

#: mirror for ``literal OP col``
_FLIP = {">": "<", ">=": "<=", "<": ">", "<=": ">=",
         "=": "=", "==": "=="}


def _conjuncts(expr, out: List) -> None:
    from ..sql.parser import Binary
    if isinstance(expr, Binary) and expr.op == "and":
        _conjuncts(expr.left, out)
        _conjuncts(expr.right, out)
    else:
        out.append(expr)


def _as_number(expr) -> Optional[float]:
    from ..sql.parser import Literal, Unary
    if isinstance(expr, Literal) and \
            isinstance(expr.value, (int, float)) and \
            not isinstance(expr.value, bool):
        return float(expr.value)
    if isinstance(expr, Unary) and expr.op == "-":
        v = _as_number(expr.operand)
        return -v if v is not None else None
    return None


def bbox_from_where(where, xcol: str, ycol: str,
                    qualifier: Optional[str] = None
                    ) -> Optional[Tuple[float, float, float, float]]:
    """``(xmin, ymin, xmax, ymax)`` the WHERE clause confines the
    point columns to, or None when it confines neither axis.

    ``qualifier`` restricts which column references count: None
    accepts only unqualified references; a table alias accepts
    unqualified ones plus those qualified by that alias.  Unbounded
    sides come back infinite — partition-bbox intersection handles
    half-bounded boxes for free."""
    if where is None:
        return None
    from ..sql.parser import Binary, Column
    lo = {xcol: -math.inf, ycol: -math.inf}
    hi = {xcol: math.inf, ycol: math.inf}
    found = False
    conj: List = []
    _conjuncts(where, conj)
    for c in conj:
        if not isinstance(c, Binary):
            continue
        op, left, right = c.op, c.left, c.right
        if not isinstance(left, Column):
            # literal OP column -> column flipped-OP literal
            left, right = right, left
            op = _FLIP.get(op)
        if op not in _OPS or not isinstance(left, Column):
            continue
        name = left.name.lower()
        if name not in lo:
            continue
        if left.table is not None and left.table.lower() != \
                (qualifier or "").lower():
            continue
        v = _as_number(right)
        if v is None:
            continue
        tmin, tmax = _OPS[op]
        if tmin:
            lo[name] = max(lo[name], v)
        if tmax:
            hi[name] = min(hi[name], v)
        found = True
    if not found:
        return None
    return (lo[xcol], lo[ycol], hi[xcol], hi[ycol])
