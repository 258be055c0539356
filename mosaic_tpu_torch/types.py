"""Wire types: chips and raster tiles.

Reference counterparts: core/types/ChipType.scala:9-30 (struct(is_core,
index_id, wkb)), core/types/model/MosaicChip.scala:21, and
core/types/RasterTileType.scala / model/MosaicRasterTile.scala:22.  Columnar
instead of row structs: a ChipSet is the whole exploded
``grid_tessellateexplode`` output for a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .core.geometry.array import GeometryArray


@dataclasses.dataclass
class ChipSet:
    """Columnar chip batch = rows of ChipType plus source-geometry ids.

    geom_id[i]  — index of the source geometry in the input batch
    cell_id[i]  — grid cell id (int64 bit pattern)
    is_core[i]  — cell fully inside the source geometry
    geoms       — chip geometries; core chips carry the cell geometry when
                  keep_core_geom was set, else an empty polygon (the
                  reference's null wkb)
    """

    geom_id: np.ndarray
    cell_id: np.ndarray
    is_core: np.ndarray
    geoms: GeometryArray

    def __len__(self) -> int:
        return len(self.cell_id)

    def __post_init__(self):
        self.geom_id = np.asarray(self.geom_id, dtype=np.int64)
        self.cell_id = np.asarray(self.cell_id, dtype=np.int64)
        self.is_core = np.asarray(self.is_core, dtype=bool)

    @staticmethod
    def concat(parts) -> "ChipSet":
        parts = list(parts)
        if not parts:
            return ChipSet(np.empty(0, np.int64), np.empty(0, np.int64),
                           np.empty(0, bool), GeometryArray.empty())
        return ChipSet(
            np.concatenate([p.geom_id for p in parts]),
            np.concatenate([p.cell_id for p in parts]),
            np.concatenate([p.is_core for p in parts]),
            GeometryArray.concat([p.geoms for p in parts]))
