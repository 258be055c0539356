"""IndexSystemFactory — conf-string → IndexSystem.

Reference counterpart: core/index/IndexSystemFactory.scala:5-66, including
the CUSTOM(xMin,xMax,yMin,yMax,splits,rootSizeX,rootSizeY[,crs]) parser
(:32-63).
"""

from __future__ import annotations

import re

from .base import IndexSystem
from .custom import CustomIndexSystem, GridConf

_CUSTOM_RE = re.compile(
    r"CUSTOM\(\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*,\s*(-?[\d.]+)\s*,"
    r"\s*(-?[\d.]+)\s*,\s*(\d+)\s*,\s*([\d.]+)\s*,\s*([\d.]+)\s*"
    r"(?:,\s*(\d+)\s*)?\)", re.IGNORECASE)


def get_index_system(name: str) -> IndexSystem:
    up = name.strip().upper()
    if up == "H3":
        from .h3.system import H3IndexSystem
        return H3IndexSystem()
    if up == "BNG":
        from .bng import BNGIndexSystem
        return BNGIndexSystem()
    m = _CUSTOM_RE.match(name.strip())
    if m:
        xmin, xmax, ymin, ymax = (float(m.group(i)) for i in range(1, 5))
        splits = int(m.group(5))
        szx, szy = float(m.group(6)), float(m.group(7))
        crs = int(m.group(8)) if m.group(8) else 4326
        return CustomIndexSystem(GridConf(xmin, xmax, ymin, ymax, splits,
                                          szx, szy, crs))
    raise ValueError(f"unknown index system: {name!r} "
                     "(expected H3, BNG, or CUSTOM(...))")
