"""Function registry.

Port copy of ``mosaic_tpu.functions.registry``.

Reference counterpart: functions/MosaicRegistry.scala:14-69 +
expressions/base/WithExpressionInfo.scala — reflective registration of
every expression with name/usage docs.  Here registration is a decorator;
the registry powers introspection (``ctx.function_names()``) and the parity
checklist against the reference's ~150-function surface.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class FunctionInfo:
    name: str
    fn: Callable
    group: str          # "geometry" | "grid" | "raster" | "aggregator" | ...
    usage: str = ""


REGISTRY: Dict[str, FunctionInfo] = {}


def register(name: str, group: str, usage: str = "",
             aliases: tuple = ()) -> Callable:
    def deco(fn: Callable) -> Callable:
        REGISTRY[name] = FunctionInfo(name, fn, group, usage or
                                      (fn.__doc__ or "").strip())
        for a in aliases:
            REGISTRY[a] = FunctionInfo(a, fn, group, f"alias of {name}")
        return fn
    return deco


def function_names(group: Optional[str] = None):
    return sorted(n for n, i in REGISTRY.items()
                  if group is None or i.group == group)
