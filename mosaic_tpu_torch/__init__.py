"""mosaic_tpu_torch — the PyTorch/CUDA port of mosaic_tpu.

Ported so far: the point-in-polygon join on H3, BNG and CUSTOM grids —
workload, tessellation, the dense lattice-window index (its device join
one hand-written CUDA kernel for Hopper that projects each point to the
H3 lattice and joins it, ``ops/dense_join.py``), the grid-agnostic
sorted-table index (torch ops, with H3 cell ids from a second CUDA
kernel, ``ops/cell.py``), the f64 host recheck through the native C++
kernels of ``native/`` and the zone histogram; and the polygon x polygon
overlay (ST_Intersects and the intersection area), its chip-pair probe
another hand-written CUDA kernel (``ops/overlay_pairs.py``); and
SpatialKNN (``models/``), its brute-force top-k and its ring step two
more (``ops/knn_brute.py``, ``ops/knn_ring.py``); and the join
strategies over them: the cost planner (``sql/planner.py``, read from
``config.py``'s conf keys), the planned join and the adaptive refined
join (``parallel/pip_join.py``); and the sharded paths over a
``torch.distributed`` process group (``parallel/collectives.py``): the
sharded and sharded-streamed join, the overlay's cell-hash exchange,
SpatialKNN's sharded ring and the raster halo in row slabs.  The
package imports torch and numpy, never jax and nothing of
``mosaic_tpu``; its module layout and names follow ``mosaic_tpu`` so
each module's counterpart is easy to find.

Entry points that create device state (``build_pip_index``,
``build_dense_pip_index``, ``make_streamed_pip_join``,
``make_refined_pip_join``, ``tessellate``, ``tessellate_subset``, the
``overlay_*`` entry points, ``SpatialKNN``, ``raster_to_grid`` and the
raster operators that compute on a device) run on CUDA unless the caller
passes ``device="cpu"``, and
raise RuntimeError when no CUDA device exists and none was asked for.

    import mosaic_tpu_torch as mt
    polys, grid, res = mt.build_workload(n_side=16, grid_name="H3",
                                         zones="taxi")
    idx = mt.build_pip_index(polys, res, grid)
    run = mt.make_streamed_pip_join(idx, grid, polys)
    zone, rechecked = run(mt.nyc_points(1 << 22))
"""

from __future__ import annotations

from ._device import resolve_device
from .bench.workloads import (ais_pings_ports, build_workload, nyc_points,
                              taxi_zones)
from .core.geometry.array import GeometryArray, GeometryBuilder, GeometryType
from .core.geometry.wkt import read_wkt, write_wkt
from .core.index.factory import get_index_system
from .core.raster import GeoTransform, RasterTile, read_gtiff, write_gtiff
from .core.tessellate import (point_chips, polyfill, tessellate,
                              tessellate_subset)
from .io.raster_grid import raster_to_grid
from .models import (CheckpointManager, SpatialKNN, build_knn_indexes,
                     knn_host_truth, knn_index_from_arrays)
from .ops.projection import project_lattice, project_lattice_ref
from .parallel.overlay import (overlay_host_truth, overlay_intersection_area,
                               overlay_intersects, overlay_row_pairs,
                               overlay_rows_from_arrays, pack_chip_rows)
from .parallel.pip_join import (DensePIPIndex, PIPIndex,
                                build_dense_pip_index, build_pip_index,
                                dense_index_from_arrays, host_recheck_fn,
                                localize, make_pip_join_fn,
                                make_planned_pip_join,
                                make_refined_pip_join,
                                make_streamed_pip_join, pip_host_truth,
                                sorted_index_from_arrays, zone_histogram)
from .types import ChipSet

__all__ = [
    "resolve_device", "build_workload", "nyc_points", "taxi_zones",
    "GeometryArray", "GeometryBuilder", "GeometryType", "read_wkt",
    "write_wkt", "get_index_system", "point_chips", "polyfill", "tessellate",
    "tessellate_subset",
    "project_lattice", "project_lattice_ref", "DensePIPIndex", "PIPIndex",
    "build_dense_pip_index", "build_pip_index", "dense_index_from_arrays",
    "sorted_index_from_arrays", "host_recheck_fn", "localize",
    "make_pip_join_fn", "make_planned_pip_join", "make_refined_pip_join",
    "make_streamed_pip_join", "pip_host_truth",
    "zone_histogram", "ChipSet", "overlay_host_truth",
    "overlay_intersection_area", "overlay_intersects", "overlay_row_pairs",
    "overlay_rows_from_arrays", "pack_chip_rows", "ais_pings_ports",
    "CheckpointManager", "SpatialKNN", "build_knn_indexes", "knn_host_truth",
    "knn_index_from_arrays", "RasterTile", "GeoTransform", "raster_to_grid",
    "read_gtiff", "write_gtiff",
]
