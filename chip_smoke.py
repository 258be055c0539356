#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device — name and power limit (nvidia-smi); exits if CUDA is absent;
2. build — compiles the thirteen kernels from ``csrc/`` with ``nvcc``, one
   process per source, and the native host library from
   ``native/geokernels.cpp`` with ``g++``, all started together:
   ``h3_projection`` (K1, the projection alone), ``h3_dense_join`` (K2,
   the projection fused with the dense join body), ``h3_cell`` (K3,
   H3 cell ids of absolute points, the sorted join's cell step),
   ``overlay_pairs`` (K4, the overlay's chip-pair probe),
   ``knn_brute_topk`` (K5, SpatialKNN's all-pairs top-k),
   ``knn_ring_step`` (K6, SpatialKNN's ring step), ``tess_classify`` (K7,
   tessellation's cell classification), ``tess_clip`` (K8, its
   border-chip clip), ``raster_convolve`` (K9, the raster stencil, f64
   and f32), ``raster_combine`` (K10, the NaN-aware tile combine),
   ``edge_measures`` (K11, area, length, centroid and bounds of edge
   blocks), ``edge_point_query`` (K12, crossing counts and boundary
   distances of points against edge blocks) and ``edges_cross`` (K13, the
   edge-crossing matrix of two edge blocks), each f32 and f64;
3. K1 vs plain — the projection kernel against its plain PyTorch
   version on the card, 2^22 localized NYC points (seed 100) at res 9
   around the flagship index's origin: all five outputs bit-equal; timed
   in turns (plain, kernel, kernel, plain) at the main path's chunk
   shape and at 2^22 rows, with the host's time per launch;
4. df contract — K1 against the f64 host lattice (hexmath) on 500,000
   points in ±0.4° × ±0.3° around (-74.0, 40.7): no disagreement with
   margin >= err_lattice_bound(9, "df", 0.4);
5. flagship join (dense) — 281 taxi zones at H3 res 9 (their
   tessellation on the card counted, its K7 and K8 inputs kept for phase
   13), the streamed join
   over 4 batches of 2^22 points (seeds 100-103) in 2^18-row chunks,
   through the public entry points; final zones equal ``pip_host_truth``
   on a seeded 65,536-point sample, uncertain share below 5e-3, one K2
   launch per chunk and no K1 or K3 launch, the f64 recheck through the
   native ``recheck_zones``, and the zone histogram sums to the matched
   rows; then a profiled batch;
6. K2 vs plain — the fused join kernel against ``dense_join_ref`` on the
   card, zone and uncertain bit-equal, on a flagship batch of 2^22
   points, on points placed on chip and hex edges and a hair beside
   them, and on the flagship index with its zone slots spread past 32
   (``widen_zone_slots``); the edge points' final zones after the f64
   recheck (``host_recheck_fn``, its full-polygon fallback counted)
   against ``pip_host_truth``: 0 mismatches among the flagged points and
   beyond the 1e-6 degree band, and 0 points the device join left
   unflagged and wrong (ROADMAP C6: the port also flags points within
   1e-6 degrees of a straddling edge's line, which the JAX body misses
   beside nearly horizontal edges); timed in turns against the plain
   version and against the torch-ops join it replaced (K1 then torch
   ops), with its bound from this run's data;
7. K3 vs plain — the cell kernel against ``latlng_to_cell_margin_ref``
   on 2^22 uniform global points and the 2^22 flagship points at res 9,
   and 2^16 global points at each res 0..15: ids and margins bit-equal
   (or, where the card's sin differs from torch's, ids equal wherever
   the plain version's margin is at least 1e-6 degrees and margins
   within 1e-6 degrees); no disagreement with the f64 host
   ``point_to_cell`` on a seeded 2^20-point sample of each set at plain
   margin >= 3e-5 degrees; the card's sincosf, which the kernel calls,
   equal to its sinf and cosf on all 2^32 f32 inputs; the persistent
   launch timed in turns at 2^18 and 2^22 rows, beside a bound that
   counts the f32 operations and the integer operations (from the plain
   version, at the card's integer rate);
8. sorted join, CUSTOM — ``build_workload(n_side=16, res_cells=512,
   grid_name="CUSTOM", zones="taxi")``: 281 zones, 4 batches of 2^22
   points in 2^18-row chunks through ``make_streamed_pip_join``; final
   zones equal ``pip_host_truth`` on a seeded 65,536-point sample; the
   uncertain share, points per second, a profiled batch, the sorted
   body's device ms and host enqueue per chunk, and the native recheck's
   host ms per chunk;
9. sorted join, H3 — the flagship workload with ``dense="never"`` on one
   2^22 batch: final zones equal phase 5's dense answer and the oracle
   sample, one K3 launch per chunk, and on the same chunks the sorted
   body with K3's plain version gives bit-equal device zones and flags
   and flags as many points as the main path rechecked; then the
   continental res-2 boxes of tests/test_pip_join.py (20,000 points
   each) and a polygon spanning icosahedron faces, each at 0 mismatches
   against the oracle on every point and held against the plain cell
   step the same way;
10. sorted join, BNG — the BNG row of tests/test_bng.py's grid matrix
    (res 3, 100-200 km east and north) on 2^20 points, 0 mismatches;
11. overlay — 2^17 footprint boxes from bench.py's generator (seed 41)
    x the 281 taxi zones at H3 res 9, each side tessellated once on the
    card (``keep_core_geom=True``; both counted, the footprints timed by
    stage and their K7 and K8 inputs kept for phase 13, and the ChipSet
    of the first 2^14 held bit-equal to the plain path) and
    reused: ``overlay_intersects`` (one K4
    launch) and ``overlay_intersection_area`` (one or two K4 launches
    and the native ``intersect_area_pairs``), counted; the entry point's
    steps timed apart (pack, upload, device join, copy back, f64
    resolution of the hazard pairs, row pairs, pair areas); K4 against
    its plain version on the full workload (dense hits and hazards
    bit-equal, pair-key sets equal, also after a relaunch); 0 mismatches
    against ``overlay_host_truth`` on 4,096 sampled footprints; the area
    pair set equal to the intersecting pairs but for pairs of exact area
    below 1e-15, and the area of every pair of those footprints within
    1e-12 + 1e-9 area of its exact area (each footprint is a box, so
    the exact area is the zone clipped to the box in rational
    arithmetic); the rows' edge caps, histograms of real edges per row
    on each side and of the range lengths; K4's B-row pre-pass against
    its plain version; K4 timed beside its bound (the bytes of the rows
    it probes, the operations of the real edge pairs it tests), its
    plain version, the wrapper with its match list and zeroing, and the
    host's enqueue;
12. SpatialKNN — BASELINE config 4 as bench.py:1510-1538 runs it:
    ``ais_pings_ports`` (2^20 AIS pings x 3,000 world ports, seed 31),
    k = 5, H3 res 4, at most 32 rings; the default path (brute: one K5
    launch per 8,192-row block, 128, and no K6) and the ring path
    (``brute_right_max=0``: one K6 launch per ring, no K5), each through
    ``transform`` with the cost planner's engine decision printed: the
    brute path with a warm run and 3 counted steady
    runs, the ring path with one counted run (K6's library loaded first),
    profiled for the device's busy time and recording K6's states; rows/s,
    iterations, rechecked and the steps' host seconds; ``right_id`` equal to
    ``knn_host_truth`` on the first 20,000 pings, brute equal to ring on
    all rows; K5 against ``brute_topk_ref`` on full-width blocks of the
    run and a block with duplicated right points (d2 bits and indices
    equal) at kc 13, 108 (k = 100) and 1,100 (two launches), timed in
    turns with its plain version and against the torch distance matrix +
    ``torch.topk`` yardstick, beside its bound (5 flops a pair; the bytes
    of lc, rc and the outputs); K6 against ``ring_step_ref`` on the ring
    run's own states ring by ring (lists bit-equal), and with lists of
    101 (shared memory) and 256 (global memory, 2^16 rows) on two of
    its rings, timed over the march beside its byte bound (the entries
    and pool rows each ring reads); k = 100 on 2^14 pings through both
    engines, 0 mismatches against ``knn_host_truth``;
13. chip generation (BASELINE config 2) — ``conus_counties()`` (3,136
    polygons) at H3 res 5, ``keep_core_geom=False``, as bench.py:1384-1397
    runs it: warmed on the first 256 counties, then one call timed on the
    card, by stage (candidates with the sampling's cell kernel, the cell
    tables, classify, clip, and the host assembly), counted (K7 and K8
    launches, K8 relaunches, K3 launches, sampling points and those sent
    to the host path) with no plain version running; 93,595 chips,
    bit-equal to ``tessellate(..., device="cpu")`` (the plain versions);
    the candidate sets equal to the host's exact sets; every tessellation
    on the card (this one, phase 5's index build and phase 11's two
    sides) with exactly one K7 launch and one K8 launch for each class
    of ring length plus its relaunches; K7 and K8, at the lanes their
    wrappers pick, bit-equal to their plain versions on four input sets:
    the county run's, ``tess_adversarial``'s degenerate set (edges along
    cell sides and through vertices, horizontal edges, a pentagon, cells
    of up to 10 vertices, concave rings past K8's convex capacity,
    relaunched), phase 5's index build over the 281 taxi zones and phase
    11's 2^17 footprints; K7 also on prefixes of the county run's pairs,
    for which its wrapper picks each of its other widths, and K8 on the
    county run's tasks with 1% of their rings made 16 times longer,
    which its wrapper launches apart at a warp a task; the picks
    together cover every width of both kernels; each timed on each set
    (K8 but on the degenerate set, whose relaunches sit inside the call)
    beside its bound (f64 instructions counted from the set's data at
    the FP64 rate, and bytes), its plain version and its wrapper's host
    enqueue;
14. join strategies, at the bench's sizes with 2^18-row chunks
    (``mosaic.stream.chunk.rows``): the planner sweep of bench.py:760-800
    over phase 5's dense index — ``nyc_points`` at 2^14, 2^17 and 2^20
    (seed 500 + n % 97), ``calibrate`` (every candidate warm, zones
    equal) and then 3 planned runs against 3 of the streamed join, zones
    bit-equal and held to ``pip_host_truth`` on up to 65,536 points, K2
    launches by strategy counted; phase 5's four 2^22 batches through the
    planned join, zones equal to phase 5's; the refined A/B of
    bench.py:922-993 (48 seven-vertex rings of radius 0.004 in +-0.1,
    2^19 points, three quarters in +-0.12, ``default_rng(1292)``, H3 res
    5): pinned ``refined`` (a cold run, then 5 timed), pinned ``flat`` (a
    warm run, then 5 timed), one ``auto`` run; zones equal to
    ``pip_host_truth`` on all points, ``levels == [5, 6]`` and refined
    points under the pin, every routed id equal to the host
    ``point_to_cell``, K3 launches by part (route, base body, refined
    body) counted; the decisions printed;
15. raster to grid (BASELINE config 5) — a. bench.py:1444-1456's
    1000x800 DEM (srid 4326) through ``raster_to_grid([dem], 8, grid,
    combiner="avg")`` on the card after the 64x64 warm-up: 2,645 cells,
    the dict bit-equal to the same call with ``device="cpu"``, one K3
    launch per ``tessellate_raster`` call, the pixels the host
    re-assigned, the host's stage times (ownership: centres and nudge,
    the route's copies, K3, the host re-assignment; the grouping; the
    per-cell window loop; the combine; the per-cell reduce); b. an
    SRTM-sized tile (3601 x 3601 pixels of 1 arc-second, pixel centres
    on whole degrees from (-75, 41), bench.py's formula scaled to it, a
    seeded 360 x 360 NaN block) cut into 4 phase-aligned quarter tiles
    that overlap by 64 pixels, through ``raster_to_grid`` on the card:
    K3 and K10 launches counted, every pixel's cell equal to the host
    ``point_to_cell`` on a seeded 2^20-pixel sample and on every pixel
    whose K3 margin sent it to the host, the ``count`` combiner's cells
    summing to the tile's valid pixels, and a 1024 x 1024 corner in 4
    tiles bit-equal to ``device="cpu"``; c. K9 bit-equal to
    ``convolve_ref`` on the SRTM tile in f64 with 3x3, 5x5, 4x4 and 7x7
    weights (through ``rops.convolve``) and on the DEM and the SRTM tile
    in f32 with 3x3 weights (through ``sharded_convolve`` with
    ``group=None``), one launch a call, each timed beside its plain
    version, its bound (the raster's bytes; a rounded multiply and a
    rounded add a tap, at the FP64 or FP32 rate) and ``F.conv2d`` (TF32
    off); then, untimed, K9's edge set in f64 and f32 (rasters smaller
    than the stencil, a [3, 517, 1029] raster under 5x5, 3x3, 1x9, 9x1
    and 11x11, a -0.0 tap, an infinite tap, the stencil that takes the
    small tile), each bit-equal; d. K10 bit-equal to ``combine_ref`` for
    all six reducers on the quarters' stack (4 x 3601 x 3601 f64) and on
    the largest stack the SRTM run gave it, each timed beside its plain
    version, its byte bound and ``torch.nanmean`` (avg) or
    ``torch.nansum`` (sum); e. ``rops.ndvi`` on a two-band SRTM-sized
    stack bit-equal to ``device="cpu"``, its torch ops' device time
    beside its byte bound;
16. the sharded paths in a NCCL world of one rank (a ``FileStore`` in a
    temporary directory), each through its public entry point with the
    group, counted under its own ``sharded ...`` path and held to its
    single-device counterpart on the same inputs: ``make_sharded_pip_join``
    and ``zone_histogram`` on phase 5's first 2^20 points (zones, flags
    and counts bit-equal to the one-device K2 call, final zones to phase
    5's, one K2 launch); ``make_sharded_streamed_pip_join`` and the
    planned join pinned to ``sharded`` (a group of one runs the streamed
    join) each on a whole 2^22 batch of phase 5 (zones bit-equal to phase
    5's, one K2 launch per chunk); phase 9's sorted H3 index sharded on
    2^18 points (one K3 launch, zones equal to phase 9's);
    ``overlay_intersects`` and ``overlay_intersection_area`` on phase 11's
    first 4,096 footprints (the cell-hash exchange, K4; equal to the
    single-device calls); ``SpatialKNN(group=...)`` on phase 12's first
    2^15 pings (one K6 launch per ring; ids and distances equal to phase
    12's ring); ``sharded_convolve`` on the SRTM tile in f32 3x3 (bit-equal
    to phase 15's ``group=None``), and K9 on four widened row slabs of the
    tile's first 3,600 rows bit-equal to K9 on those rows whole (the seams
    a multi-rank halo cuts); each path's collectives' calls, bytes and
    host seconds (each ended at a synchronize), the phase's seconds;
17. the store-fed flagship (bench.py:634-760 in full mode): 1e8 rows of
    ``nyc_points`` in blocks of 2^22 (seeds 500 on) ingested through
    ``StoreWriter`` at grid_res 1024 and 2^22 rows a shard into a
    temporary directory (the writer timed, the generation not); the whole
    store queried out of core through ``make_store_sharded_pip_join``
    with ``group=None`` over phase 5's dense index in 2^18-row chunks (one
    K2 launch per chunk, 382), its zones and ``rechecked`` equal to the
    streamed join over ``read_columns()`` in store order, the device's
    peak allocated bytes over the query below the store's ``nbytes()``,
    the staging ledger summing to the staged ``pipeline/h2d_bytes``; one
    partition's chunks profiled by stage (``stream/pull``: shard reads
    and chunk assembly; ``stream/stage``; K2; ``store_join/recheck``,
    ``/gather``, ``/observe``) and the device's idle share; a side store
    (2^17 points, seed 901, grid_res 8192, 2^14 rows a shard) queried
    over the lower-left 45% of its bbox with ``group=None``, over a NCCL
    world of one and heat-primed (``mosaic.heat.prior``): partitions
    pruned, none of them staged or heated, each answer bit-equal to the
    streamed join over ``read_columns(bbox)``; ingest rows/s, query
    points/s and each query's host seconds;
18. the geometry surface: a. K11's area, length, centroid and bounds
    (``core/geometry/measures.py``) in f64 and f32 on 2^20 footprint
    boxes (``footprints``, seed 41, 8 edge slots) and on
    ``conus_counties()`` (3,136 polygons, 32 slots), one launch a call,
    bit-equal to the plain version on every row through the mapping the
    wrapper picks and through each of its two mappings forced (staged
    tiles, a warp a geometry), within 1e-12 (f64) or 1e-5 (f32) of the
    row's sum of |terms| of a numpy f64 shoelace on the block's
    coordinates, the bounds equal to numpy's; K11 also bit-equal to its
    plain version, by either mapping and the wrapper's pick, on every row
    of ``bench.workloads.measures_adversarial``'s seeded set in f64 and
    f32 (empty rows, NaN and infinity in valid and masked slots,
    zero-length and collinear edges, coordinates near 1e+-300 and
    1e+-38, -0.0, 1 to 4,096 slots) through every view of
    ``MEASURES_ADV_VIEWS`` (a row offset, a slot offset, an unaligned
    coordinate offset, a non-contiguous slice); b. K12 through
    ``points_in_polygons(..., with_boundary_dist=True)`` and
    ``distance_points_to_geoms`` on 2^20 ``nyc_points`` (seed 100) x the
    281 taxi zones (64 slots) in f64 and f32: bit-equal to the plain
    version on all 2^20 rows in 2^14-row chunks (the count and distance
    launch, the distance launch and the count instance), each row's
    first zone equal to ``pip_host_truth`` wherever the point's f64
    boundary distance is above 1e-9 degrees (f64) or 1e-5 (f32), the
    points within each band printed; c. K13 with K12:
    ``polygons_intersect`` and ``polygon_contains_polygon`` on the
    counties' 3,136^2 pairs (symmetric, every county adjacent to one,
    none containing another) and ``polygons_intersect`` on 2^14 footprints
    x the zones against ``overlay_host_truth`` (every differing pair
    printed, each a boundary touch within 1e-9 degrees); K13 bit-equal to
    its plain version on every row of each G1 (one whole-matrix launch,
    512-row chunks) and on 512 sampled rows launched alone, in f64 and
    f32, and ``polygons_intersect`` to its plain composition; K12 (its
    three instances) and K13 bit-equal to their plain versions in f64
    and f32 on a seeded adversarial set (non-prefix and empty masks, NaN
    ends, zero-length and horizontal edges, points on vertices and
    edges, shared, reversed and collinear edges, nearly collinear
    disjoint segments, capacities 1 to 1,500, sizes 1 and one past a
    tile); d. ``raster_to_grid``
    on config 5's DEM values in EPSG:32618 (50 m pixels from the UTM
    projection of (-74.25, 40.92)): ``warp`` on the host, then K3, the
    cells bit-equal to ``device="cpu"``'s, one K3 launch; e. K11 (centroid,
    f64 footprints, against its plain version; every measure in f64 and
    f32 on the footprints and the counties by the profiler, with its
    byte bound and host enqueue), K12 (count and
    distance on the 2^16-row sample, f64; the full 2^20 points in f64 and
    f32) and K13 (512 sampled counties x 3,136, f64; all pairs) timed in
    turns against their plain versions beside their bounds, counted from
    the run's own data;
19. the ``sorted``, ``overlay``, ``knn``, ``chips``, ``strategies``,
    ``raster``, ``sharded``, ``store``, ``geometry`` and ``tess_kernels``
    (K7 and K8 by input set) summary lines, the card, the ``kernels`` JSON
    line (K1-K13 with launches per path, the tessellations of phases 5
    and 11, the strategies', the raster, the sharded, the ``store fed``
    and the ``geometry`` paths among them), then the last line
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of ``mosaic_tpu``.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

# the port must never reach JAX or the JAX package
sys.modules["jax"] = None
sys.modules["mosaic_tpu"] = None

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
RES = 9
BATCH = 1 << 22
CHUNK = 1 << 18
SEEDS = (100, 101, 102, 103)
ORACLE_SAMPLE = 65_536
#: chip edges the adversarial set is placed on (1e6 points or so)
ADV_EDGES = 1 << 15
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, an FMA
# counted as two flops, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: f32 arithmetic the count sees (compares, selects, casts and the
#: integer work come on top and are not counted)
F32_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "round",
             "maximum", "clamp_min"}
#: f32 operations of one exact product: in the plain version's Dekker
#: split (the product, two 4-op Veltkamp splits, an 8-op error term), as
#: the kernels issue it (the product and one FMA), and in flops (the FMA
#: counted as two)
DEKKER_OPS = 17
KERNEL_PRODUCT_OPS = 2
EXACT_PRODUCT_FLOPS = 3
#: K2's flops per edge of a border point's group (|py - ay|, max(ax, bx)
#: + eps: sub, abs, max, add) and per straddling edge on top (by - ay,
#: the divide, bx - ax, the mul, the add, |px - xi|: 7 with the abs;
#: then the line band: px - ax, two muls and a sub for cr, cr * cr, dx *
#: dx, dy * dy, their add and the mul by eps^2: 9)
EDGE_FLOPS = 4
STRADDLE_FLOPS = 16
KERNELS = ("h3_projection", "h3_dense_join", "h3_cell", "overlay_pairs",
           "knn_brute_topk", "knn_ring_step", "tess_classify", "tess_clip",
           "raster_convolve", "raster_combine", "edge_measures",
           "edge_point_query", "edges_cross")
#: points of each K3 set held against the f64 host ids (numpy, ~9 s per
#: 2^20 points on one core)
HOST_SAMPLE = 1 << 20
#: the sorted join's margin band (planar degrees): the host check holds
#: K3 to the host ids outside it
CELL_BAND_DEG = 3e-5
#: if the card's sin and torch's differ in the last bit, K3's ids must
#: still equal its plain version's at this margin and above (degrees)
CELL_ID_MARGIN_DEG = 1e-6
#: ... and its margins may then differ from the plain version's by at
#: most this (degrees)
CELL_MARGIN_TOL_DEG = 1e-6
#: bytes K3 moves per point: 8 in, an 8-byte id and a 4-byte margin out
CELL_BYTES = 20
#: a sin or cos is counted as one operation of the bound (CUDA's sinf
#: issues some twenty), so its bound is a lower bound
SINCOS_OPS = 1
#: 32-bit integer operations K3 needs per point, from the kernel's own
#: steps (csrc/h3_cell.cu cell_of); an operation on a 64-bit word counts
#: as two.  Per resolution level of the aggregation: the two axial
#: combinations (2), two floor divisions (2p + 7) / 14 as a multiply-add,
#: a multiply-high, a shift and a sign fix each (8), the child's axial
#: point (2), the axial difference's index (3), its digit from the
#: register word by a multiply, shift and mask (3), and the digit put in
#: the raw word (2)
CELL_INT_PER_LEVEL = 20
#: per digit of the id: the raw digit taken out (2), its rotation by the
#: packed word (multiply, shift, mask: 3) and put in the id (2)
CELL_INT_PER_DIGIT = 7
#: once per point: the res-0 ijk entry index (two mins, two subtracts,
#: three multiply-adds: 7), the entry word's base, rotation and pentagon
#: fields (5), the lead digit (the rotation word's index 1, the
#: live-digit mask over the 64-bit raw word 8, its __clzll and bit
#: position 4, the digit taken out 3 and rotated 3, the select when no
#: digit is live 1: 20), the pentagon seam digit and its test (5), the
#: extra rotation (3), the relabel test on the rotated lead digit (8),
#: the rotation word's index (2), and the id's base and fill (3); the
#: defensive clamps of table indexes are not counted
CELL_INT_ONCE = 53
#: the H100's integer issue rate: one warp instruction a clock on each
#: of an SM's four schedulers, 128 lanes an SM, the rate at which FP32
#: adds and multiplies issue (IMAD goes to the FMA pipe beside the
#: 64-lane ALU pipe, so their sum reaches it), at the clock that gives
#: PEAK_F32_FLOPS with an FMA as two flops: half of PEAK_F32_FLOPS in
#: operations a second
PEAK_INT32_OPS = PEAK_F32_FLOPS / 2
#: the overlay: bench.py's footprint boxes (seed 41) x the flagship's
#: taxi zones at H3 res 9; footprints sampled for the f64 oracle and the
#: exact areas
OVERLAY_FOOTPRINTS = 1 << 17
OVERLAY_SAMPLE = 4096
#: K4 on rows re-padded to these edge caps (one staged, one too wide for
#: shared memory), the first B rows with a range against every A row
OVERLAY_WIDE = (200, 300)
OVERLAY_WIDE_B = 512
#: f32 arithmetic of K4's plain version: F32_ARITH with the band's
#: minimum and the edge length's sqrt
K4_ARITH = F32_ARITH | {"minimum", "sqrt"}
#: SpatialKNN at BASELINE config 4 as bench.py runs it on an accelerator:
#: 2^20 AIS pings x 3,000 world ports (seed 31), k = 5, H3 res 4, at most
#: 32 rings; the brute path's warm run and the median of its steady runs,
#: the ring path's one run (~80 s of host f64 passes each); the f64
#: oracle on the first pings
KNN_PINGS = 1 << 20
KNN_PORTS = 3000
KNN_K = 5
KNN_RES = 4
KNN_MAX_IT = 32
KNN_STEADY = 3
KNN_ORACLE = 20_000
#: the wide-k checks: k = 100 transforms on the first 2^14 pings; K5 at
#: kc 108 (one launch) and 1,100 (two); K6 lists of 101 (shared memory)
#: and 256 (global memory) on those pings against the ports repeated 40
#: times, rings 0-5, and a ring of lists of 101 on every ping timed
KNN_WIDE_K = 100
KNN_WIDE_PINGS = 1 << 14
KNN_WIDE_KC = (108, 1100)
KNN_WIDE_RING = 8
KNN_GLOBAL_K1 = 256
KNN_CROWD = 40
KNN_CROWD_RINGS = 6
#: BASELINE config 2 as bench.py:1384-1397 runs it: conus_counties()
#: (3,136 polygons) at H3 res 5, keep_core_geom=False, warmed on the first
#: COUNTY_WARM counties; its ChipSet has COUNTY_CHIPS chips
COUNTY_RES = 5
COUNTY_WARM = 256
COUNTY_CHIPS = 93_595
#: K8's mixed set: every LONG_EVERY-th county task's ring made
#: LONG_FACTOR times longer (17 vertices to 272, past shared memory at 4
#: lanes a task)
LONG_EVERY = 100
LONG_FACTOR = 16
#: the join strategies (phase 14): the planner sweep's batch sizes and
#: timed runs a side (bench.py:760-800); the refined A/B's points, base
#: resolution and timed runs a pin (bench.py:922-993)
STRAT_SIZES = (1 << 14, 1 << 17, 1 << 20)
STRAT_REPS = 3
REFINE_N = 1 << 19
REFINE_RES = 5
REFINE_REPS = 5
#: the overlay's first footprints whose ChipSet is held against the plain
#: path (tessellate on the CPU)
OVERLAY_TESS_CHECK = 1 << 14
#: phase 16, the sharded paths in a NCCL world of one: phase 5's first
#: points through the sharded join and the zone histogram, the sorted H3
#: index on fewer, phase 11's first footprints through the overlay,
#: phase 12's first pings through the ring; the halo's seams emulated
#: over this many slabs of the SRTM tile's first SHARD_HALO_ROWS rows
SHARD_JOIN_N = 1 << 20
SHARD_H3_N = 1 << 18
SHARD_FOOTPRINTS = 4096
SHARD_PINGS = 1 << 15
SHARD_SLABS = 4
SHARD_HALO_ROWS = 3600
#: phase 17, the store-fed flagship as bench.py:634-760 runs it in full
#: mode: the big store's rows, ingested in blocks of nyc_points(2^22,
#: seed=500+i) at grid_res 1024 and 2^22 rows a shard; the side store's
#: rows (nyc_points seed 901) at grid_res 8192 and 2^14 rows a shard,
#: queried over the lower-left STORE_SIDE_FRAC of its bbox
STORE_ROWS = 100_000_000
STORE_BLOCK = 1 << 22
STORE_RES = 1024
STORE_SHARD = 1 << 22
STORE_SIDE_ROWS = 1 << 17
STORE_SIDE_RES = 8192
STORE_SIDE_SHARD = 1 << 14
STORE_SIDE_FRAC = 0.45
#: phase 18, the geometry surface: K11's four measures on 2^20 footprint
#: boxes (seed 41, 8 edge slots) and on conus_counties() (3,136, 32
#: slots); K12 on GEOM_POINTS flagship points (seed 100) x the 281 taxi
#: zones (64 slots), held to the plain version on every row in
#: GEOM_CHUNK-row chunks and to pip_host_truth outside GEOM_BAND degrees
#: of a boundary, timed on a seeded GEOM_SAMPLE-row sample; K13 on the
#: counties' 3,136^2 pairs and on GEOM_PRED_FOOTPRINTS footprints x the
#: zones, held to the plain version on every row in GEOM_PLAIN_ROWS-row
#: chunks and on GEOM_PLAIN_ROWS sampled rows launched alone, and to
#: overlay_host_truth, a differing pair allowed where the boundaries lie
#: within GEOM_TOUCH_DEG
GEOM_MEASURES = ("area", "length", "centroid", "bounds")
GEOM_FOOTPRINTS = 1 << 20
GEOM_POINTS = 1 << 20
GEOM_POINT_SEED = 100
GEOM_SAMPLE = 1 << 16
GEOM_CHUNK = 1 << 14
GEOM_PRED_FOOTPRINTS = 1 << 14
GEOM_PLAIN_ROWS = 512
GEOM_SEED = 18
#: conus_counties()' side: 56 gives its 3,136 polygons
GEOM_COUNTY_SIDE = 56
#: pairwise_point_distance's timed call: this many points x as many
GEOM_PAIRWISE = 4096
#: K11 against the numpy f64 shoelace: this many times the row's sum of
#: |terms|, by the blocks' type
GEOM_REL = {"float64": 1e-12, "float32": 1e-5}
#: K12's first zone must equal pip_host_truth for every point whose f64
#: boundary distance (degrees) is above this, by the blocks' type
GEOM_BAND = {"float64": 1e-9, "float32": 1e-5}
GEOM_TOUCH_DEG = 1e-9
#: K11's operations a slot, the least each measure needs (an add,
#: subtract, multiply, compare, min or max, and the sqrt, one each):
#: area's cross product and sum over the valid slots; length's
#: difference, squares, sum, sqrt and sum; the centroid's 25 over every
#: slot (a masked slot's products still enter it); the bounds' pair and
#: running min and max of x and y
K11_OPS = {"area": 4, "length": 7, "centroid": 25, "bounds": 8}
#: phase 18's adversarial set for K12 and K13, seeded (adv_blocks,
#: adv_points): K12 on (N points, G geometries, E slots), K13 on (G1, E1,
#: G2, E2): sizes of 1 and one past a tile (64 points x 32 geometries;
#: cross_tile's 64, 16 and 8 geometries at 8, 32 and 64 slots), E1 != E2,
#: capacities from 1 to past one staging pass (K13's 512 slots); and
#: GEOM_ADV_COLLINEAR nearly collinear disjoint segment pairs
GEOM_ADV_SEED = 1618
GEOM_ADV_K12 = ((1, 1, 1), (65, 33, 8), (64, 32, 8), (129, 3, 512),
                (65, 2, 1100), (200, 9, 64))
GEOM_ADV_K13 = ((1, 1, 1, 1), (65, 8, 17, 32), (33, 32, 9, 64),
                (3, 512, 2, 512), (2, 1100, 3, 1500), (40, 8, 40, 8))
GEOM_ADV_COLLINEAR = 2048
#: config 5's DEM values on a UTM 18N grid (NYC's zone) of 50 m pixels
#: from the UTM projection of (-74.25, 40.92)
UTM_EPSG = 32618
UTM_PIXEL = 50.0
#: NVIDIA H100 SXM data sheet: 34 TFLOP/s in f64 outside the tensor cores,
#: an FMA as two flops, so 17e12 f64 instructions a second (an add,
#: multiply, compare or min/max each one)
PEAK_F64_OPS = 34e12 / 2
#: f64 instructions of one IEEE divide as nvcc compiles the kernels'
#: __ddiv_rn for sm_90a (cuobjdump -sass of the built libraries): seven
#: DFMA and one DMUL refine a MUFU.RCP64H seed; the seed and three f32
#: range tests in front of the slow-path call issue on other pipes and
#: are not counted
F64_DIV_OPS = 8
#: K7's f64 instructions, the least that csrc/tess_classify.cu's
#: function needs.  Per edge of a geometry that a pair names, once: dx =
#: bx - ax, its rounded end xe = ax + dx and its four min/max; and dy =
#: by - ay where a crossing or an overlapping pair needs it.  Per (pair,
#: edge) the bbox test's four compares; per (pair, query, edge) two
#: compares; per straddling one px < ax and px < xe, and where that does
#: not settle it px >= ax and px >= xe (the crossing's x lies between ax
#: and xe); where neither does, py - ay, the divide by dy, a multiply, an
#: add and a compare.  Per overlapping (pair, edge) and cell vertex v_k:
#: v_k - a (2), d_k = orient(a, b, v_k) on those and the edge's vector
#: (3) and its sign and zero tests (2), which side k's d1 and side k-1's
#: d2 share; per such pair and cell side (u, w): d3 = orient(u, w, a)
#: from the side's vector and -(u - a) (3, negation exact), d4 =
#: orient(u, w, b) (5) and their sign and zero tests (4), d3 >= 0 being
#: their OR.  An orientation that is exactly 0 adds its on-segment range
#: test: four compares against the edge's min/max for d_k, against the
#: side's for d3 and d4, and the side's four min/max once per cell side
#: that needs them.  Per cell of the table and vertex: its bbox's four
#: min/max and its side vector's two subtracts
K7_PER_EDGE = 2 + 4
K7_PER_DY_EDGE = 1
K7_PER_PAIR_EDGE = 4
K7_PER_QUERY_EDGE = 2
K7_PER_STRADDLE = 2
K7_PER_STRADDLE_RIGHT = 2
K7_PER_EXACT = 4 + F64_DIV_OPS
K7_PER_VERTEX = 2 + 3 + 2
K7_PER_SIDE = 3 + 5 + 4
K7_PER_ZERO_VERTEX = 4
K7_PER_ZERO_SIDE = 4
K7_PER_ZERO_CELL_SIDE = 4
K7_PER_CELL_VERTEX = 4 + 2
#: K8's f64 instructions, the least that csrc/tess_clip.cu's function
#: needs: per side of each cell of the tasks its vector (2 subtracts);
#: per (task, plane, subject vertex) one side d = ev.x*(c.y-p0.y) -
#: ev.y*(c.x-p0.x) (5) and d >= 0 (1), the next vertex's d being its
#: d_nxt; per crossing the denominator, its test, the divide and the
#: intersection (a subtract, multiply and add per coordinate)
K8_PER_CELL_SIDE = 2
K8_PER_VERTEX = 5 + 1
K8_PER_CROSSING = 2 + F64_DIV_OPS + 6
#: f32 instructions a second at PEAK_F32_FLOPS with an FMA as two flops
#: (an add, multiply, compare or min/max each one)
PEAK_F32_OPS = PEAK_F32_FLOPS / 2
#: an f32 IEEE divide counted as one operation (it issues more), so the
#: f32 bounds are lower bounds
F32_DIV_OPS = 1
#: K12's operations (csrc/edge_point_query.cu): per valid (point, edge)
#: pair the straddle's two compares; per straddling pair py - ay, by -
#: ay, bx - ax, a multiply, an add and px < xi beside the divide; per
#: valid pair of the distance ap (2), the dot product (3), the guard's
#: add (1), the clip (2), the projection (4), d (2), d2 (3) and the min
#: (1), 18, beside the divide (ab and its squared length are once an
#: edge and not counted); a sqrt a (point, geometry)
K12_PER_EDGE = 2
K12_PER_STRADDLE = 6
K12_PER_DIST_EDGE = 18
#: K13's operations a tested edge pair (csrc/edges_cross.cu): three
#: coordinate differences (6), four orientations of two multiplies and a
#: subtract (12), eight sign and zero tests (8)
K13_PER_EDGE_PAIR = 26


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int):
    """Mean device time (ms) per call of ``fn`` over ``reps`` calls run
    back to back: the host enqueues the burst between two CUDA events
    while a spin kernel holds the card, so the events time the calls
    without the host's launch gaps.  The spin doubles until the card
    reaches the start event only after the whole burst is queued; None
    when it never does (``fn`` waits on the card)."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 25                  # ~17 ms at the H100's 1.98 GHz
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2
    return None


def kernel_device_ms(fn, reps: int, kernel_name: str, launches: int = 1):
    """(ms, source): the mean device time of the CUDA kernel named
    ``kernel_name`` per call of ``fn``, which launches it ``launches``
    times.  The profiler's reading, the kernel alone, when its trace of a
    burst of ``reps`` calls (after a warm-up burst that starts the
    tracing) holds every launch; else
    :func:`queued_ms` over the whole call, with the profiler's count in
    the source; else the events of a launch loop, host gaps included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    count, total = 0, 0.0
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and \
                    kernel_name in evt.key:
                total += evt.self_device_time_total
                count += evt.count
    except RuntimeError as e:         # no CUPTI tracing available
        log(f"[kernel] torch.profiler unavailable: {e}")
    if count == reps * launches and total > 0:
        return total / 1e3 / reps, "profiler"
    log(f"[kernel] the profiler recorded {count} {kernel_name} launches "
        f"of {reps * launches}: the queued burst's events stand in")
    ms = queued_ms(fn, reps)
    if ms is not None:
        return ms, f"events, queued burst (profiler kept {count} of {reps})"
    return time_ms(fn, reps), (f"events over a launch loop (profiler kept "
                               f"{count} of {reps}; the burst could not be "
                               "queued)")


def in_turns(plain, kernel, reps_plain: int, reps_kernel: int,
             kernel_timer=time_ms):
    """(plain ms, kernel ms): plain, kernel, kernel, plain; each the
    mean of its two turns, the kernel's by ``kernel_timer``."""
    p1 = time_ms(plain, reps_plain)
    k1 = kernel_timer(kernel, reps_kernel)
    k2 = kernel_timer(kernel, reps_kernel)
    p2 = time_ms(plain, reps_plain)
    check(k1 is not None and k2 is not None,
          "the kernel's burst could not be queued")
    return (p1 + p2) / 2, (k1 + k2) / 2


def count_ops(fn, x, arith=F32_ARITH):
    """(f32 arithmetic ops, exact products, negations, sin/cos calls) per
    row of ``fn(x)``, x [n, ...], from the plain versions on the CPU,
    which keep the kernels' operations one for one; ``arith`` names the
    ops counted.  Integer arithmetic is not counted."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from mosaic_tpu_torch.ops import twofloat

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if isinstance(out, torch.Tensor) and \
                    out.dtype == torch.float32 and \
                    name in arith | {"sin", "cos"}:
                self.ops[name] += out.numel()
            return out

    two_prod = twofloat.two_prod
    products = collections.Counter()

    def counted_two_prod(a, b):
        p, err = two_prod(a, b)
        products["n"] += p.numel()
        return p, err

    n = int(x.shape[0])
    twofloat.two_prod = counted_two_prod
    try:
        with Count() as c:
            fn(x)
    finally:
        twofloat.two_prod = two_prod
    sincos = c.ops["sin"] + c.ops["cos"]
    plain = sum(c.ops.values()) - sincos
    for v in (plain, products["n"], c.ops["neg"], sincos):
        check(v % n == 0, f"op count {v} not a multiple of {n}")
    return plain // n, products["n"] // n, c.ops["neg"] // n, sincos // n


def flops_per_point(res: int, origin):
    """(flops the function needs, f32 instructions the kernels issue) per
    point of the projection, counted on a small CPU input from the plain
    version.

    The needed flops are in the unit of PEAK_F32_FLOPS: each exact
    product counts EXACT_PRODUCT_FLOPS instead of its DEKKER_OPS, and a
    negation is not counted, since it folds into the add or subtract
    that reads it.  The kernels issue KERNEL_PRODUCT_OPS instructions
    per exact product, and fold negations the same way."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.ops.projection import project_lattice_ref
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.3, 0.3, (1024, 2)).astype(np.float32))
    plain, products, neg, _ = count_ops(
        lambda v: project_lattice_ref(v, res, origin), x)
    plain -= neg
    needed = plain - products * (DEKKER_OPS - EXACT_PRODUCT_FLOPS)
    issued = plain - products * (DEKKER_OPS - KERNEL_PRODUCT_OPS)
    log(f"[kernel] per point: {needed} flops needed, {issued} f32 "
        f"instructions issued by the kernels ({products} exact "
        f"products at {KERNEL_PRODUCT_OPS} each, where the plain version's "
        f"Dekker split takes {DEKKER_OPS}; {neg} negations folded)")
    return needed, issued


def cell_ops_per_point(res: int):
    """(f32 operations, integer operations) per point of K3's bound: its
    f32 flops (exact products at EXACT_PRODUCT_FLOPS, negations folded)
    and SINCOS_OPS per sin or cos, counted from the plain version on
    global points, and the integer operations of the kernel's steps."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.ops.cell import latlng_to_cell_margin_ref
    r = np.random.default_rng(0)
    x = torch.from_numpy(np.stack([r.uniform(-180, 180, 1024),
                                   r.uniform(-85, 85, 1024)], -1).astype(
        np.float32))
    plain, products, neg, sincos = count_ops(
        lambda v: latlng_to_cell_margin_ref(v, res), x)
    ops = plain - neg - products * (DEKKER_OPS - EXACT_PRODUCT_FLOPS) + \
        sincos * SINCOS_OPS
    int_ops = (CELL_INT_PER_LEVEL + CELL_INT_PER_DIGIT) * res + \
        CELL_INT_ONCE
    log(f"[cell] per point at res {res}: {ops} f32 operations counted "
        f"({plain - neg} f32 ops with {products} exact products at "
        f"{EXACT_PRODUCT_FLOPS} flops, {sincos} sin/cos at {SINCOS_OPS}) "
        f"and {int_ops} integer operations ({CELL_INT_PER_LEVEL} a level, "
        f"{CELL_INT_PER_DIGIT} a digit, {CELL_INT_ONCE} once)")
    return ops, int_ops


def phase_device():
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {card}")
    return name, card


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from mosaic_tpu_torch import _kernels, native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        gxx = pool.submit(native.build)
        seconds = _kernels.build_all(KERNELS)
        gxx_s = gxx.result()
    log(f"[build] nvcc {seconds} s, g++ {native.SOURCE.name} {gxx_s:.2f} "
        f"s, in parallel (phase {time.perf_counter() - t0:.1f} s)")
    for name in KERNELS:
        report = _kernels.lib_path(name).with_suffix(".log")
        if report.exists():
            entry = ""
            for line in report.read_text(errors="replace").splitlines():
                # each entry's template arguments as they are mangled,
                # e.g. brute_kernelILi1ELi16EE: T = 1, WARPS = 16
                found = re.search(r"Compiling entry function '.*?([a-z]"
                                  r"[a-z_]*_kernel(?:I\w*?EE)?)", line)
                if found:
                    entry = found.group(1)
                if "registers" in line or "spill" in line:
                    log(f"[build] {name} {entry} ptxas: {line.strip()}")


def host_ms_per_launch(fn, reps: int) -> float:
    """Host time (ms) to enqueue one call of ``fn``: a host clock around
    ``reps`` calls with no synchronize inside the loop."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def timed_kernel(label: str, kernel, plain, kernel_name: str,
                 reps_plain: int, launches: int = 1):
    """(device ms, its source, events ms per launch in a loop, host ms
    per launch, plain ms) of a kernel call, which launches the kernel
    ``launches`` times, against its plain version, timed in turns.  The
    device time is the profiler's when it records the kernel, else the
    event time of a launch loop (which includes the host's launch
    gaps)."""
    plain_ms, events_ms = in_turns(plain, kernel, reps_plain, 50)
    ms, source = kernel_device_ms(kernel, 50, kernel_name, launches)
    host_ms = host_ms_per_launch(kernel, 200)
    log(f"[{label}] kernel {ms:.4f} ms ({source}; events over a launch "
        f"loop {events_ms:.4f} ms), host enqueue "
        f"{host_ms:.4f} ms per launch, plain {plain_ms:.4f} ms")
    return ms, source, events_ms, host_ms, plain_ms


def phase_kernel(origin, flops_per_pt: int, issued_per_pt: int):
    import numpy as np
    import torch
    from mosaic_tpu_torch import nyc_points
    from mosaic_tpu_torch.ops.projection import (project_lattice,
                                                 project_lattice_ref)
    pts = nyc_points(BATCH, seed=SEEDS[0])
    loc = np.asarray(pts - np.asarray(origin)[None], np.float32)
    x = torch.from_numpy(loc).to(DEV)
    ker = [t.cpu().numpy() for t in project_lattice(x, RES, origin)]
    ref = [t.cpu().numpy() for t in project_lattice_ref(x, RES, origin)]
    for name, k, r in zip(("face", "a", "b", "margin", "facegap"), ker,
                          ref):
        nbits = int(np.sum(k.view(np.int32) != r.view(np.int32)))
        log(f"[kernel] {name}: {nbits} of {BATCH} differ bitwise from the "
            "plain version")
        check(nbits == 0, f"K1 {name} differs from plain at {nbits} points")

    def timed(rows: int):
        xs = x[:rows]
        ms, source, events_ms, host_ms, plain_ms = timed_kernel(
            f"kernel {rows} rows", lambda: project_lattice(xs, RES, origin),
            lambda: project_lattice_ref(xs, RES, origin), "project_kernel",
            3)
        ops_ms = flops_per_pt * rows / PEAK_F32_FLOPS * 1e3
        # an FMA is one instruction and two flops: issue at half the peak
        issue_ms = issued_per_pt * rows / (PEAK_F32_FLOPS / 2) * 1e3
        bytes_ms = 28 * rows / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        log(f"[kernel] {rows} rows: bound {bound:.4f} ms (flops "
            f"{ops_ms:.4f}, bytes {bytes_ms:.4f}; {flops_per_pt} flops and "
            f"28 bytes per point), roofline share {bound / ms:.4f}; the "
            f"{issued_per_pt} f32 instructions issued per point take "
            f"{issue_ms:.4f} ms at one per lane per clock")
        return {"plain_ms": plain_ms, "ms": ms, "ms_source": source,
                "events_ms": events_ms, "host_ms": host_ms, "bound_ms": bound,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "max_abs_err": 0.0}

    timed(BATCH)
    return timed(CHUNK)         # the shape the main path gives the kernel


def phase_df_contract():
    import numpy as np
    import torch
    from mosaic_tpu_torch.core.index.h3 import hexmath as hm
    from mosaic_tpu_torch.core.index.h3.torchkernel import err_lattice_bound
    from mosaic_tpu_torch.ops.projection import project_lattice
    r = np.random.default_rng(3)
    origin = np.array([-74.0, 40.7])
    n = 500_000
    loc = np.stack([r.uniform(-0.4, 0.4, n), r.uniform(-0.3, 0.3, n)], -1)
    loc32 = loc.astype(np.float32)
    fd, ad, bd, margin, _ = [t.cpu().numpy() for t in project_lattice(
        torch.from_numpy(loc32).to(DEV), RES, tuple(origin))]
    bound = err_lattice_bound(RES, "df", 0.4)
    # host truth from the f64 points, then from their f32 cast
    for label, pts in (("f64 input", loc), ("f32 input",
                                            loc32.astype(np.float64))):
        latlng = np.radians((pts + origin[None])[:, ::-1])
        fh, hex2d = hm.project_lattice(latlng, RES)
        ijk = hm.hex2d_to_ijk(hex2d)
        ah, bh = ijk[:, 0] - ijk[:, 2], ijk[:, 1] - ijk[:, 2]
        dis = ~((fd == fh) & (ad == ah) & (bd == bh))
        unflagged = int(np.sum(dis & (margin >= bound)))
        worst = float(margin[dis].max()) if dis.any() else 0.0
        log(f"[df] {label}: {int(dis.sum())} of {n} disagree with the f64 "
            f"host lattice, {unflagged} with margin >= {bound:.3e} "
            f"(worst disagreeing margin {worst:.3e})")
        check(unflagged == 0, f"{unflagged} unflagged disagreements "
              f"({label})")


def phase_flagship():
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt

    t0 = time.perf_counter()
    polys, grid, res = mt.build_workload(n_side=16, grid_name="H3",
                                         zones="taxi")
    t_work = time.perf_counter() - t0
    chips, t_tess = tessellate_kept("flagship index build", polys, res,
                                    grid, keep_core_geom=False)
    t0 = time.perf_counter()
    idx = mt.build_pip_index(polys, res, grid, chips=chips, device=DEV)
    t_idx = time.perf_counter() - t0
    log(f"[flagship] {len(polys)} zones (built in {t_work:.2f} s) -> "
        f"{len(chips)} chips ({int(chips.is_core.sum())} core), "
        f"tessellation {t_tess:.2f} s; index build {t_idx:.2f} s: window "
        f"{idx.W}x{idx.H}, pool {tuple(idx.pool.shape)}, gzones "
        f"{tuple(idx.gzones.shape)}, err_lattice {idx.err_lattice:.3e}, "
        f"on {idx.device}")
    check(idx.device.type == DEV, "index is not on the card")
    run = mt.make_streamed_pip_join(idx, grid, polys, chunk=CHUNK,
                                    device=DEV)
    batches = [mt.nyc_points(BATCH, seed=s) for s in SEEDS]

    # ---- the main path, counted: counts to 0, drive, read
    reset_counts()
    zones, hists, rechecked, t_batch = [], [], 0, []
    t0 = time.perf_counter()
    for pts in batches:
        tb = time.perf_counter()
        zone, nre = run(pts)
        t_batch.append(time.perf_counter() - tb)
        hists.append(mt.zone_histogram(
            torch.from_numpy(zone).to(DEV), len(polys)))
        zones.append(zone)
        rechecked += nre
    hists = [h.cpu().numpy() for h in hists]
    t_e2e = time.perf_counter() - t0
    launches = launch_counts()
    native_calls = launches["native_recheck_zones"]
    n_chunks = len(SEEDS) * -(-BATCH // CHUNK)
    total = len(SEEDS) * BATCH
    pps = total / t_e2e
    unc = rechecked / total
    log(f"[flagship] streamed join: {total} points in {t_e2e:.3f} s = "
        f"{pps:.4e} points/s end to end (host clock, first batch "
        f"included); {rechecked} rechecked on host (uncertain_frac "
        f"{unc:.3e}); launches {launches} for {n_chunks} chunks; "
        f"streamed join per batch {[round(t, 4) for t in t_batch]} s")
    check(launches["h3_dense_join"] == n_chunks, f"K2 launched "
          f"{launches['h3_dense_join']} times for {n_chunks} chunks")
    check(launches["h3_project_lattice"] == 0, "K1 launched "
          f"{launches['h3_project_lattice']} times on the main path")
    check(launches["h3_latlng_to_cell"] == 0, "K3 launched "
          f"{launches['h3_latlng_to_cell']} times on the dense path")
    log(f"[flagship] the f64 recheck called the native recheck_zones "
        f"{native_calls} times for {n_chunks} chunks; "
        f"{run.recheck.fallbacks} of the {rechecked} rechecked points "
        f"took the full polygon test ({launches['native_pip_first_match']} "
        "pip_first_match calls)")
    check(native_calls > 0, "the dense recheck never ran the native "
          "recheck_zones")
    check(unc < 5e-3, f"uncertain_frac {unc} >= 5e-3")
    for zone, h in zip(zones, hists):
        matched = int(np.sum(zone >= 0))
        check(int(h.sum()) == matched, f"zone_histogram sums to "
              f"{int(h.sum())}, {matched} rows matched")
        check(np.array_equal(h, np.bincount(zone[zone >= 0],
                                            minlength=len(polys))),
              "zone_histogram differs from np.bincount")
    check(all(np.all((z >= -1) & (z < len(polys))) for z in zones),
          "zone ids out of range")

    # ---- exact oracle on a seeded sample across the batches
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(total, ORACLE_SAMPLE, replace=False))
    all_pts = np.concatenate(batches)
    all_zone = np.concatenate(zones)
    t0 = time.perf_counter()
    truth = mt.pip_host_truth(all_pts[pick], polys)
    bad = int(np.sum(truth != all_zone[pick]))
    log(f"[flagship] oracle: {bad} mismatches of {ORACLE_SAMPLE} sampled "
        f"points ({time.perf_counter() - t0:.1f} s, "
        f"{int(np.sum(truth >= 0))} matched)")
    check(bad == 0, f"{bad} zones differ from pip_host_truth")

    profile_batch(run, batches[0], min(t_batch[1:]) * 1e3)
    return launches, idx, grid, batches, rechecked, zones, polys, chips


def index_tables(idx) -> dict:
    """A dense index as the dict ``dense_index_from_arrays`` takes (no
    recheck tables)."""
    out = {k: getattr(idx, k).cpu().numpy()
           for k in ("entry", "pool", "gzones", "gwide")}
    out.update({k: getattr(idx, k) for k in
                ("origin", "face0", "a0", "b0", "W", "H", "res",
                 "err_lattice", "n_zones", "ext_deg")})
    return out


def join_work(x, tables, consts, flops_pt: int):
    """(flops, bytes, border points) the join needs on the points ``x``,
    from this data: the projection of every point within the window's
    extent, EDGE_FLOPS per edge of a border point's group (pads excluded)
    and STRADDLE_FLOPS more per edge that straddles its latitude; 8 bytes
    in and 5 out per point, and each entry cell and group (its edges, zone
    slots, edge count, gzones row and gwide flag) that the points reach,
    read once."""
    import torch
    from mosaic_tpu_torch.ops.dense_join import CORE_FLAG
    from mosaic_tpu_torch.ops.projection import project_lattice
    c = consts
    face, a, b, _, _ = project_lattice(x, c.res, c.origin)
    near = (x.abs() <= c.far_lim).all(dim=1)
    ia, ib = a - c.a0, b - c.b0
    inw = near & (face == c.face0) & (ia >= 0) & (ia < c.W) & (ib >= 0) & \
        (ib < c.H)
    cell = (ia * c.H + ib)[inw].long()
    e = tables.entry[cell]
    border = (e >= 0) & ((e & CORE_FLAG) == 0)
    g = e[border].long()
    py = x[inw][border, 1][:, None]
    rec = tables.pool[g]
    straddles = int(((rec[..., 1] <= py) != (rec[..., 3] <= py)).sum())
    Z = int(tables.gzones.shape[1])
    rows = torch.unique(g)
    flops = (flops_pt * int(near.sum())
             + EDGE_FLOPS * int(tables.ecount[g].sum())
             + STRADDLE_FLOPS * straddles)
    nbytes = (13 * int(x.shape[0]) + 4 * int(torch.unique(cell).numel())
              + 20 * int(tables.ecount[rows].sum())
              + int(rows.numel()) * (Z * 4 + 1 + 4))
    return flops, nbytes, int(g.numel())


def phase_join_kernel(idx, grid, polys, batches, rechecked: int,
                      flops_pt: int):
    """K2 against dense_join_ref on the card, bit for bit, and its times
    against the plain version and the torch-ops join it replaced; the
    adversarial set's final zones, after the f64 recheck, against the
    oracle."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import (adversarial_points,
                                                  widen_zone_slots)
    from mosaic_tpu_torch.ops.dense_join import (dense_join, dense_join_ref,
                                                 join_body)
    from mosaic_tpu_torch.ops.projection import project_lattice
    from mosaic_tpu_torch.parallel.pip_join import EPS_EDGE_DEG

    def compare(label, x, fn):
        tables, consts = fn.keywords["tables"], fn.keywords["consts"]
        zk, uk = dense_join(x, tables, consts)
        zr, ur = dense_join_ref(x, tables, consts)
        dz, du = int((zk != zr).sum()), int((uk != ur).sum())
        log(f"[join] {label}: {x.shape[0]} points, Z={tables.gzones.shape[1]}"
            f"; zone differs from plain at {dz}, uncertain at {du}; "
            f"{int((zk >= 0).sum())} matched, {int(uk.sum())} uncertain")
        check(dz == 0 and du == 0, f"K2 differs from dense_join_ref on "
              f"{label}: zone at {dz}, uncertain at {du} points")
        return zk, uk

    fn = mt.make_pip_join_fn(idx, grid)
    tables, consts = fn.keywords["tables"], fn.keywords["consts"]
    # every flagship point, in 2^21-row pieces: K2 equals the plain
    # version, and so does the main path's uncertain count
    uncertain = 0
    for i, pts in enumerate(batches):
        x = torch.from_numpy(mt.localize(idx, pts)).to(DEV)
        for k, xs in enumerate(torch.split(x, 1 << 21)):
            uncertain += int(compare(f"flagship batch {i} part {k}", xs,
                                     fn)[1].sum())
    log(f"[join] plain version: {uncertain} uncertain of "
        f"{len(batches) * BATCH}; the main path rechecked {rechecked}")
    check(uncertain == rechecked, "the main path's uncertain count differs "
          "from the plain version's")
    adv, off = adversarial_points(idx.aux["flat_a"], idx.aux["flat_b"], grid,
                                  idx.res, ADV_EDGES, seed=0)
    xa = torch.from_numpy(mt.localize(idx, adv)).to(DEV)
    za, ua = compare(f"adversarial set ({int((off == 0).sum())} on edges, "
                     f"the rest {sorted(set(off[off > 0].tolist()))} deg "
                     "beside them)", xa, fn)
    t0 = time.perf_counter()
    recheck = mt.host_recheck_fn(idx)
    final = recheck(adv, za.cpu().numpy(), ua.cpu().numpy())
    t_re = time.perf_counter() - t0
    truth = mt.pip_host_truth(adv, polys)
    wrong = final != truth
    flagged = ua.cpu().numpy()
    beyond = off > EPS_EDGE_DEG
    bad, unflagged = int(np.sum(wrong & flagged)), int(np.sum(wrong & ~flagged))
    log(f"[join] adversarial set after the f64 recheck: {bad} oracle "
        f"mismatches among its {int(flagged.sum())} flagged points "
        f"({recheck.fallbacks} of them through the full polygon test; "
        f"recheck {t_re:.2f} s), {int(np.sum(wrong & beyond))} beyond the "
        f"{EPS_EDGE_DEG} degree band; the device join left {unflagged} "
        f"of the {len(adv)} unflagged and wrong (ROADMAP C6: 11 before "
        "the band on a straddling edge's line)")
    check(bad == 0 and not np.any(wrong & beyond),
          f"{bad} flagged adversarial points differ from pip_host_truth "
          f"after the recheck, {int(np.sum(wrong & beyond))} beyond the band")
    check(unflagged == 0, f"the device join left {unflagged} adversarial "
          "points unflagged and wrong (ROADMAP C6)")
    wide = mt.dense_index_from_arrays(widen_zone_slots(index_tables(idx)),
                                      device=DEV)
    wfn = mt.make_pip_join_fn(wide, grid)
    x = torch.from_numpy(mt.localize(idx, batches[0])).to(DEV)
    xw = torch.cat([x[:CHUNK * 4], xa])
    zw, uw = compare("index with zone slots widened past 32", xw, wfn)
    z0, u0 = fn(xw)
    check(torch.equal(zw, z0) and torch.equal(uw, u0),
          "widening the zone slots changed the join's answer")

    def timed(rows: int):
        xs = x[:rows]
        kernel = lambda: dense_join(xs, tables, consts)  # noqa: E731
        ms, source, events_ms, host_ms, plain_ms = timed_kernel(
            f"join {rows} rows", kernel,
            lambda: dense_join_ref(xs, tables, consts), "dense_join_kernel",
            3)
        ops_ms, k_ms = in_turns(
            lambda: join_body(xs, project_lattice(xs, consts.res,
                                                  consts.origin),
                              tables, consts), kernel, 10, 50)
        flops, nbytes, n_border = join_work(xs, tables, consts, flops_pt)
        ops_bound = flops / PEAK_F32_FLOPS * 1e3
        bytes_bound = nbytes / PEAK_BYTES * 1e3
        bound = max(ops_bound, bytes_bound)
        log(f"[join] {rows} rows: {n_border} border points; bound "
            f"{bound:.4f} ms (flops {ops_bound:.4f}: {flops}; bytes "
            f"{bytes_bound:.4f}: {nbytes}), roofline share "
            f"{bound / ms:.4f}; the torch-ops join it replaced (K1, then "
            f"torch ops) {ops_ms:.4f} ms against K2 {k_ms:.4f} ms, in turns "
            "(CUDA events)")
        return {"plain_ms": plain_ms, "ms": ms, "ms_source": source,
                "events_ms": events_ms, "host_ms": host_ms,
                "torch_ops_join_ms": ops_ms, "bound_ms": bound,
                "bound_by": "operations" if ops_bound >= bytes_bound
                else "bytes", "max_abs_err": 0.0}

    timed(BATCH)
    return timed(CHUNK)


def profile_batch(run, pts, plain_wall_ms, chunk: int = CHUNK):
    """Where one batch's time goes: :func:`profile_run` over a streamed
    run of ``pts`` in ``chunk``-row chunks."""
    return profile_run(lambda: run(pts), -(-len(pts) // chunk),
                       plain_wall_ms, f"one batch of {len(pts)} points")


def profile_run(call, chunks: int, plain_wall_ms, what: str,
                labels=("stream/",)):
    """torch.profiler over ``call()`` (not counted): host time per phase
    label (those starting with one of ``labels``) per chunk, device time
    by op, and the device's idle share.  Busy time is the union of the
    device intervals over both streams, so a copy that overlaps a kernel
    counts once.  The idle share is given against the profiled wall time
    and against ``plain_wall_ms``, the fastest unprofiled warm run: the
    profiler slows the host, not the device.  ``plain_wall_ms`` None: the
    profiled run is the only one, and the profiled wall stands in."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    labels = tuple(labels)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:         # no CUPTI tracing available
        log(f"[profile] torch.profiler unavailable: {e}")
        return {}
    if plain_wall_ms is None:
        plain_wall_ms = wall_ms
    events = prof.key_averages()
    out = {"host_ms_per_chunk": {}}
    for e in events:
        # the labels appear twice: as host ranges and as device ranges
        # mirroring the kernels they enclose; only the host side is a
        # phase time.  Device busy counts device-side events only
        # (kernels, copies): a host op's device time repeats its kernels
        if e.key.startswith(labels) and e.cpu_time_total > 0:
            out["host_ms_per_chunk"][e.key] = e.cpu_time_total / 1e3 / chunks
            log(f"[profile] host {e.key}: {e.cpu_time_total / 1e3:.3f} ms "
                f"total, {e.cpu_time_total / 1e3 / chunks:.4f} ms per chunk "
                f"({e.count} calls)")
    dev = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                  for e in events if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith(labels)), reverse=True)
    if not dev:
        log("[profile] no device-side events recorded")
        return out
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(labels)
                   and e.time_range.end > e.time_range.start)
    busy_us, lo, hi = 0.0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            busy_us += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy_ms = (busy_us + (0.0 if hi is None else hi - lo)) / 1e3
    log(f"[profile] {what}: wall {wall_ms:.3f} ms "
        f"under the profiler, {plain_wall_ms:.3f} ms unprofiled; device "
        f"busy {busy_ms:.3f} ms (union over both streams; the op times "
        f"sum to {sum(d[0] for d in dev):.3f} ms); idle share "
        f"{1 - busy_ms / wall_ms:.4f} of the profiled wall, "
        f"{1 - busy_ms / plain_wall_ms:.4f} of the unprofiled one")
    for ms, key, count in dev[:8]:
        log(f"[profile] device {ms:.3f} ms ({count}x): {key[:90]}")
    out.update(ops=[(key[:90], ms, count) for ms, key, count in dev[:8]],
               wall_ms=wall_ms, busy_ms=busy_ms,
               idle_profiled=1 - busy_ms / wall_ms,
               idle_unprofiled=1 - busy_ms / plain_wall_ms)
    return out


def body_device_ms(fn, reps: int):
    """Mean device time (ms) per call of ``fn``, all its kernels summed,
    from torch.profiler; None when it records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:         # no CUPTI tracing available
        log(f"[sorted] torch.profiler unavailable: {e}")
        return None
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def global_points(n: int, seed: int):
    """[n, 2] f64 uniform (lon, lat) in ±180 × ±85 degrees."""
    import numpy as np
    r = np.random.default_rng(seed)
    return np.stack([r.uniform(-180, 180, n), r.uniform(-85, 85, n)], -1)


def phase_cell_kernel(ops_pt):
    """K3 against its plain version on the card, and against the f64 host
    ids; the card's sincosf against its sinf and cosf; timed in turns at
    the main path's chunk and at 2^22 rows.  ``ops_pt``: (f32, integer)
    operations per point of the bound."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.ops.cell import (latlng_to_cell_margin,
                                           latlng_to_cell_margin_ref,
                                           sincos_mismatches)
    t0 = time.perf_counter()
    odd = sincos_mismatches(torch.device(DEV))
    log(f"[cell] sincosf differs from sinf or cosf on {odd} of the 2^32 "
        f"f32 inputs ({time.perf_counter() - t0:.2f} s)")
    check(odd == 0, f"the card's sincosf differs from sinf/cosf on {odd} "
          "inputs: K3 would not give its plain version's bits")
    f32_pt, int_pt = ops_pt
    grid = mt.get_index_system("H3")
    sets = [("global", global_points(BATCH, 1), 9),
            ("flagship NYC", mt.nyc_points(BATCH, seed=SEEDS[0]), 9)]
    small = global_points(1 << 16, 2)
    sets += [("global", small, r) for r in range(16)]
    worst = 0.0
    rng = np.random.default_rng(4)
    for label, pts, res in sets:
        x = torch.from_numpy(pts.astype(np.float32)).to(DEV)
        ck, mk = latlng_to_cell_margin(x, res)
        cr, mr = latlng_to_cell_margin_ref(x, res)
        ids = int((ck != cr).sum())
        mdiff = mk.view(torch.int32) != mr.view(torch.int32)
        mbits = int(mdiff.sum())
        dmax = float((mk - mr)[mdiff].abs().max()) if mbits else 0.0
        worst = max(worst, dmax)
        msg = (f"[cell] {label} res {res}, {len(pts)} points: ids differ "
               f"from plain at {ids}, margin bits at {mbits} (largest "
               f"margin difference {dmax:.3e} deg)")
        if ids or mbits:
            # gated on the plain version's margin: the kernel's own could
            # hide a wrong id behind a wrong margin
            high = int(((ck != cr) & (mr >= CELL_ID_MARGIN_DEG)).sum())
            log(msg + f"; {high} id differences at plain margin >= "
                f"{CELL_ID_MARGIN_DEG}")
            check(high == 0, f"K3 ids differ from plain at {high} points "
                  f"with margin >= {CELL_ID_MARGIN_DEG} ({label}, res {res})")
            check(dmax <= CELL_MARGIN_TOL_DEG, f"K3 margins differ from "
                  f"plain by up to {dmax:.3e} deg, more than "
                  f"{CELL_MARGIN_TOL_DEG} ({label}, res {res})")
        else:
            log(msg)
        pick = np.sort(rng.choice(len(pts), min(HOST_SAMPLE, len(pts)),
                                  replace=False))
        host = grid.point_to_cell(pts[pick], res)
        ck_h, mr_h = ck.cpu().numpy()[pick], mr.cpu().numpy()[pick]
        off = ck_h != host
        bad = int(np.sum(off & (mr_h >= CELL_BAND_DEG)))
        log(f"[cell]   f64 host on {len(pick)} points: {int(off.sum())} ids "
            f"differ, {bad} with plain margin >= {CELL_BAND_DEG} deg, "
            f"{int(np.sum(mr_h < CELL_BAND_DEG))} below it")
        check(bad == 0, f"K3 disagrees with the f64 host at {bad} points "
              f"outside the {CELL_BAND_DEG} deg band ({label}, res {res})")
    x = torch.from_numpy(sets[1][1].astype(np.float32)).to(DEV)

    def timed(rows: int):
        xs = x[:rows]
        ms, source, events_ms, host_ms, plain_ms = timed_kernel(
            f"cell {rows} rows", lambda: latlng_to_cell_margin(xs, RES),
            lambda: latlng_to_cell_margin_ref(xs, RES), "cell_kernel", 5)
        f32_ms = f32_pt * rows / PEAK_F32_FLOPS * 1e3
        int_ms = int_pt * rows / PEAK_INT32_OPS * 1e3
        ops_ms = max(f32_ms, int_ms)
        bytes_ms = CELL_BYTES * rows / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        log(f"[cell] {rows} rows: bound {bound:.4f} ms (operations "
            f"{ops_ms:.4f}: f32 {f32_ms:.4f} for {f32_pt} a point at "
            f"{PEAK_F32_FLOPS:.3g}/s, integer {int_ms:.4f} for {int_pt} a "
            f"point at {PEAK_INT32_OPS:.4g}/s; bytes {bytes_ms:.4f} for "
            f"{CELL_BYTES} a point), roofline share {bound / ms:.4f}; "
            f"without the integer part {max(f32_ms, bytes_ms):.4f} ms")
        return {"plain_ms": plain_ms, "ms": ms, "ms_source": source,
                "events_ms": events_ms, "host_ms": host_ms, "bound_ms": bound,
                "bound_f32_ms": f32_ms, "bound_int_ms": int_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "max_abs_err": worst}

    timed(BATCH)
    return timed(CHUNK)


def launch_counts():
    """The kernels' launch counts and the native library's call counts."""
    from mosaic_tpu_torch import native
    from mosaic_tpu_torch.ops.cell import latlng_to_cell_margin
    from mosaic_tpu_torch.ops.dense_join import dense_join
    from mosaic_tpu_torch.ops.edge_measures import edge_measures
    from mosaic_tpu_torch.ops.edge_point import edge_point_query
    from mosaic_tpu_torch.ops.edges_cross import edges_cross
    from mosaic_tpu_torch.ops.knn_brute import brute_topk
    from mosaic_tpu_torch.ops.knn_ring import ring_step
    from mosaic_tpu_torch.ops.overlay_pairs import (overlay_dense,
                                                    overlay_pairs, prep_b)
    from mosaic_tpu_torch.ops.projection import project_lattice
    from mosaic_tpu_torch.ops.raster_combine import raster_combine
    from mosaic_tpu_torch.ops.raster_convolve import raster_convolve
    from mosaic_tpu_torch.ops.tess_classify import tess_classify
    from mosaic_tpu_torch.ops.tess_clip import tess_clip
    from mosaic_tpu_torch.core.index.h3.system import SAMPLE_COUNTS
    return {"h3_project_lattice": project_lattice.launches,
            "h3_dense_join": dense_join.launches,
            "h3_latlng_to_cell": latlng_to_cell_margin.launches,
            "overlay_pairs": overlay_dense.launches + overlay_pairs.launches,
            "overlay_pairs_dense": overlay_dense.launches,
            "overlay_pairs_keys": overlay_pairs.launches,
            "overlay_prep_b": prep_b.launches,
            "knn_brute_topk": brute_topk.launches,
            "knn_ring_step": ring_step.launches,
            "native_pip_first_match": native.pip_first_match.calls,
            "native_recheck_zones": native.recheck_zones.calls,
            "native_intersect_area_pairs":
                native.intersect_area_pairs.calls,
            "tess_classify": tess_classify.launches,
            "tess_clip": tess_clip.launches,
            "tess_clip_relaunches": tess_clip.relaunches,
            "sample_points": SAMPLE_COUNTS["points"],
            "sample_host_points": SAMPLE_COUNTS["host_points"],
            "raster_convolve": raster_convolve.launches,
            "raster_combine": raster_combine.launches,
            "edge_measures": edge_measures.launches,
            "edge_point_query": edge_point_query.launches,
            "edges_cross": edges_cross.launches}


def reset_counts() -> None:
    from mosaic_tpu_torch import native
    from mosaic_tpu_torch.ops.cell import latlng_to_cell_margin
    from mosaic_tpu_torch.ops.dense_join import dense_join
    from mosaic_tpu_torch.ops.edge_measures import edge_measures
    from mosaic_tpu_torch.ops.edge_point import edge_point_query
    from mosaic_tpu_torch.ops.edges_cross import edges_cross
    from mosaic_tpu_torch.ops.knn_brute import brute_topk
    from mosaic_tpu_torch.ops.knn_ring import ring_step
    from mosaic_tpu_torch.ops.overlay_pairs import (overlay_dense,
                                                    overlay_pairs, prep_b)
    from mosaic_tpu_torch.ops.projection import project_lattice
    from mosaic_tpu_torch.ops.raster_combine import raster_combine
    from mosaic_tpu_torch.ops.raster_convolve import raster_convolve
    from mosaic_tpu_torch.ops.tess_classify import tess_classify
    from mosaic_tpu_torch.ops.tess_clip import tess_clip
    from mosaic_tpu_torch.core.index.h3.system import SAMPLE_COUNTS
    project_lattice.launches = 0
    dense_join.launches = 0
    latlng_to_cell_margin.launches = 0
    overlay_dense.launches = 0
    overlay_pairs.launches = 0
    prep_b.launches = 0
    brute_topk.launches = 0
    ring_step.launches = 0
    native.pip_first_match.calls = 0
    native.recheck_zones.calls = 0
    native.intersect_area_pairs.calls = 0
    tess_classify.launches = 0
    tess_clip.launches = 0
    tess_clip.relaunches = 0
    SAMPLE_COUNTS.update(points=0, host_points=0)
    raster_convolve.launches = 0
    raster_combine.launches = 0
    edge_measures.launches = 0
    edge_point_query.launches = 0
    edges_cross.launches = 0


def sorted_join(label: str, polys, grid, res: int, batches, chips=None,
                dense: str = "auto", oracle_sample=None):
    """Build the index on the card (it must be a sorted PIPIndex), drive
    ``make_streamed_pip_join`` over ``batches`` with the counts set to 0
    just before and read just after, and hold the final zones against
    ``pip_host_truth`` on a seeded sample (every point when
    ``oracle_sample`` is None).  Returns a dict of what it saw."""
    import numpy as np
    import mosaic_tpu_torch as mt
    t0 = time.perf_counter()
    idx = mt.build_pip_index(polys, res, grid, chips=chips, dense=dense,
                             device=DEV)
    t_idx = time.perf_counter() - t0
    check(isinstance(idx, mt.PIPIndex), f"{label}: got "
          f"{type(idx).__name__}, not the sorted PIPIndex")
    check(idx.device.type == DEV, f"{label}: index is not on the card")
    log(f"[{label}] index in {t_idx:.2f} s on {idx.device}: "
        f"{idx.core_cells.shape[0]} core cells, {idx.num_chips} border "
        f"chips, E={idx.chip_a.shape[1]}, max_dup={idx.max_dup}, "
        f"sagitta {idx.sagitta_deg:.3e} deg")
    run = mt.make_streamed_pip_join(idx, grid, polys, chunk=CHUNK,
                                    device=DEV)
    reset_counts()
    zones, rechecked, t_batch = [], 0, []
    t0 = time.perf_counter()
    for pts in batches:
        tb = time.perf_counter()
        zone, nre = run(pts)
        t_batch.append(time.perf_counter() - tb)
        zones.append(zone)
        rechecked += nre
    t_e2e = time.perf_counter() - t0
    counts = launch_counts()
    total = sum(len(b) for b in batches)
    n_chunks = sum(-(-len(b) // CHUNK) for b in batches)
    unc = rechecked / total
    log(f"[{label}] streamed join: {total} points in {t_e2e:.3f} s = "
        f"{total / t_e2e:.4e} points/s end to end (host clock, first batch "
        f"included); {rechecked} rechecked on host (uncertain_frac "
        f"{unc:.4e}); counts {counts} for {n_chunks} chunks; per batch "
        f"{[round(t, 4) for t in t_batch]} s")
    all_pts = np.concatenate(batches)
    all_zone = np.concatenate(zones)
    check(np.all((all_zone >= -1) & (all_zone < len(polys))),
          f"{label}: zone ids out of range")
    if oracle_sample is None:
        pick = np.arange(total)
    else:
        pick = np.sort(np.random.default_rng(0).choice(
            total, oracle_sample, replace=False))
    truth = mt.pip_host_truth(all_pts[pick], polys)
    bad = int(np.sum(truth != all_zone[pick]))
    log(f"[{label}] oracle: {bad} mismatches of {len(pick)} points "
        f"({int(np.sum(truth >= 0))} matched)")
    check(bad == 0, f"{label}: {bad} zones differ from pip_host_truth")
    return {"idx": idx, "run": run, "zones": zones, "counts": counts,
            "n_chunks": n_chunks, "uncertain": unc, "rechecked": rechecked,
            "pps": total / t_e2e, "t_batch": t_batch}


def sorted_against_plain(label: str, idx, grid, pts, rechecked: int):
    """The sorted body with K3 and with K3's plain version on the same
    chunks as the main path: device zones and flags bit-equal, and the
    plain version's uncertain count equal to what the main path
    rechecked."""
    import copy
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.ops.cell import latlng_to_cell_margin_ref
    plain_grid = copy.copy(grid)
    plain_grid.point_to_cell_torch_margin = latlng_to_cell_margin_ref
    fn = mt.make_pip_join_fn(idx, grid)
    plain = mt.make_pip_join_fn(idx, plain_grid)
    uncertain = differ = 0
    for s in range(0, len(pts), CHUNK):
        x = torch.from_numpy(mt.localize(idx, pts[s:s + CHUNK])).to(DEV)
        zk, uk = fn(x)
        zr, ur = plain(x)
        differ += int(((zk != zr) | (uk != ur)).sum())
        uncertain += int(ur.sum())
    log(f"[{label}] against the plain cell step: zones or flags differ "
        f"at {differ} points; plain uncertain {uncertain}, main path "
        f"rechecked {rechecked}")
    check(differ == 0, f"{label}: the sorted body with K3 differs from "
          f"its plain version at {differ} points")
    check(uncertain == rechecked, f"{label}: the main path rechecked "
          f"{rechecked} points, the plain version flags {uncertain}")


def sorted_chunk_costs(label: str, idx, grid, polys, pts):
    """The sorted body's device ms and host enqueue per 2^18-row chunk,
    and the native recheck's host ms per chunk (its flagged points)."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountOps.n += 1
            return func(*args, **(kwargs or {}))

    fn = mt.make_pip_join_fn(idx, grid)
    x = torch.from_numpy(mt.localize(idx, pts[:CHUNK])).to(DEV)
    call = lambda: fn(x)          # noqa: E731
    call()
    with CountOps():
        call()
    dev_ms = body_device_ms(call, 10)
    events_ms = time_ms(call, 10)
    host_ms = host_ms_per_launch(call, 20)
    z, u = [t.cpu().numpy() for t in fn(x)]
    recheck = mt.host_recheck_fn(idx, polys)
    t0 = time.perf_counter()
    for _ in range(5):
        recheck(pts[:CHUNK], z, u)
    re_ms = (time.perf_counter() - t0) * 1e3 / 5
    # the body's bound: its gathers' bytes at max_dup per point (each
    # probed chip's a and b edges f32, mask, cell id and zone), 8 bytes in
    # and 5 out, over the card's memory rate
    E = int(idx.chip_a.shape[1])
    per_point = idx.max_dup * (E * 17 + 12) + 13
    bound_ms = per_point * int(x.shape[0]) / PEAK_BYTES * 1e3
    log(f"[{label}] sorted body bound {bound_ms:.4f} ms per chunk (bytes: "
        f"{per_point} per point, {idx.max_dup} chip rows of {E} edges)")
    log(f"[{label}] per 2^18-row chunk: sorted body device {dev_ms} ms "
        f"(profiler, kernels summed), {events_ms:.4f} ms by events over a "
        f"call loop, host enqueue {host_ms:.4f} ms for its {CountOps.n} "
        f"aten ops (views included); native recheck of its "
        f"{int(u.sum())} flagged points {re_ms:.4f} ms on the host")
    return {"body_device_ms": dev_ms, "body_events_ms": events_ms,
            "body_bound_ms": bound_ms,
            "body_host_ms": host_ms, "body_aten_ops": CountOps.n,
            "recheck_host_ms": re_ms, "flagged_per_chunk": int(np.sum(u))}


def phase_sorted_custom():
    """The sorted join at full width on the CUSTOM taxi workload."""
    import mosaic_tpu_torch as mt
    t0 = time.perf_counter()
    polys, grid, res = mt.build_workload(n_side=16, res_cells=512,
                                         grid_name="CUSTOM", zones="taxi")
    log(f"[custom] {len(polys)} zones on {grid.name} res {res} "
        f"({time.perf_counter() - t0:.2f} s)")
    batches = [mt.nyc_points(BATCH, seed=s) for s in SEEDS]
    out = sorted_join("custom", polys, grid, res, batches,
                      oracle_sample=ORACLE_SAMPLE)
    c = out["counts"]
    check(c["h3_latlng_to_cell"] == 0 and c["h3_dense_join"] == 0 and
          c["h3_project_lattice"] == 0, f"a kernel launched on the CUSTOM "
          f"path: {c}")
    check(c["native_pip_first_match"] > 0, "the sorted recheck never ran "
          "the native pip_first_match")
    out["profile"] = profile_batch(out["run"], batches[0],
                                   min(out["t_batch"][1:]) * 1e3)
    out.update(sorted_chunk_costs("custom", out["idx"], grid, polys,
                                  batches[0]))
    return out


def phase_sorted_h3(polys, grid, chips, batch, dense_zone):
    """The H3 sorted join on the flagship with dense="never" (held
    against the dense answer), then the continental and multi-face
    workloads the dense path refuses."""
    import numpy as np
    import mosaic_tpu_torch as mt
    out = sorted_join("h3 sorted", polys, grid, RES, [batch], chips=chips,
                      dense="never", oracle_sample=ORACLE_SAMPLE)
    c = out["counts"]
    check(c["h3_latlng_to_cell"] == out["n_chunks"], f"K3 launched "
          f"{c['h3_latlng_to_cell']} times for {out['n_chunks']} chunks")
    check(c["h3_dense_join"] == 0 and c["h3_project_lattice"] == 0,
          f"K1/K2 launched on the sorted path: {c}")
    diff = int(np.sum(out["zones"][0] != dense_zone))
    log(f"[h3 sorted] final zones differ from the dense join's at {diff} "
        f"of {len(batch)} points")
    check(diff == 0, f"H3 sorted and dense final zones differ at {diff}")
    sorted_against_plain("h3 sorted", out["idx"], grid, batch,
                         out["rechecked"])
    out.update(sorted_chunk_costs("h3 sorted", out["idx"], grid, polys,
                                  batch))
    rng = np.random.default_rng(0)
    cases = [
        ("continental mid", "POLYGON ((-120 30, -70 30, -70 50, -120 50, "
         "-120 30))", (-121, -69), (29, 51)),
        ("continental polar", "POLYGON ((-30 55, 30 55, 30 75, -30 75, "
         "-30 55))", (-31, 31), (54, 76)),
        ("multi-face", "POLYGON((-30 20, 20 20, 20 60, -30 60, -30 20))",
         (-35, 25), (15, 65)),
    ]
    for label, wkt, lon, lat in cases:
        p = mt.read_wkt([wkt])
        pts = np.stack([rng.uniform(*lon, 20_000),
                        rng.uniform(*lat, 20_000)], -1)
        r = sorted_join(label, p, grid, 2, [pts])
        sorted_against_plain(label, r["idx"], grid, pts, r["rechecked"])
        check(r["counts"]["h3_latlng_to_cell"] == r["n_chunks"],
              f"{label}: K3 launched {r['counts']['h3_latlng_to_cell']} "
              f"times for {r['n_chunks']} chunks")
        out[label] = r["uncertain"]
    return out


def phase_sorted_bng():
    """One BNG join at 2^20 points: the BNG row of tests/test_bng.py's grid
    matrix with its test polygon."""
    import numpy as np
    import mosaic_tpu_torch as mt
    x0, y0, x1, y1 = 100_000, 100_000, 200_000, 200_000
    w, h = x1 - x0, y1 - y0
    ring = [(x0 + 0.2 * w, y0 + 0.2 * h), (x0 + 0.8 * w, y0 + 0.25 * h),
            (x0 + 0.7 * w, y0 + 0.8 * h), (x0 + 0.4 * w, y0 + 0.6 * h),
            (x0 + 0.2 * w, y0 + 0.75 * h), (x0 + 0.2 * w, y0 + 0.2 * h)]
    polys = mt.read_wkt(["POLYGON((" + ", ".join(
        f"{x} {y}" for x, y in ring) + "))"])
    rng = np.random.default_rng(42)
    n = 1 << 20
    pts = np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], -1)
    return sorted_join("bng", polys, mt.get_index_system("BNG"), 3, [pts])


class StepClock:
    """Host seconds spent in named module functions while the block runs,
    by wrapping them (restored on exit); a function in ``sync`` ends its
    time at a device synchronize, so a launch is charged where it runs.
    :meth:`take` returns the seconds since the last take."""

    def __init__(self, targets, sync=()):
        self.targets, self.sync = list(targets), set(sync)
        self.seconds = collections.Counter()

    def __enter__(self):
        import torch
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.targets]
        for mod, name, fn in self.saved:
            def timed(*args, _fn=fn, _name=name, **kwargs):
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                if _name in self.sync and DEV == "cuda":
                    torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                return out
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def take(self) -> dict:
        out = {k: round(v, 4) for k, v in self.seconds.items()}
        self.seconds.clear()
        return out


def tess_stage_targets():
    """The stage functions of ``tessellate`` a StepClock times: the
    candidates (with the sampling's cell kernel), the cell tables, the
    classify and clip kernels with their CSR packing and copies back."""
    from mosaic_tpu_torch.core import tessellate as tess
    from mosaic_tpu_torch.core.index.h3.system import H3IndexSystem
    return [(H3IndexSystem, "candidate_cells_batch"),
            (H3IndexSystem, "cell_boundary"), (H3IndexSystem, "cell_center"),
            (tess, "_classify_pairs"), (tess, "_clip_tasks")]


#: tessellations on the card by path: their kernel launch counts and the
#: last K7 and K8 inputs (phase 13 holds K7 and K8 to their plain
#: versions and times them on each)
TESS_PATHS: dict = {}


def tessellate_kept(path: str, arr, res: int, grid, keep_core_geom: bool):
    """(ChipSet, seconds) of ``tessellate`` on the card, its launch
    counts (counts to 0 before, read after) and its last K7 and K8
    arguments kept in TESS_PATHS[path]."""
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.core import tessellate as tess
    with LastArgs([(tess, "tess_classify"), (tess, "tess_clip")]) as kept:
        reset_counts()
        t0 = time.perf_counter()
        chips = mt.tessellate(arr, res, grid, keep_core_geom=keep_core_geom,
                              device=DEV)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
    TESS_PATHS[path] = {"counts": counts, "k7": kept.args["tess_classify"],
                        "k8": kept.args["tess_clip"]}
    return chips, seconds


def tessellate_staged(path: str, arr, res: int, grid, keep_core_geom: bool):
    """(ChipSet, seconds, seconds by stage) of :func:`tessellate_kept`;
    ``assembly`` is the rest: the per-geometry ChipSet assembly and the
    host's CSR and ring-pool packing."""
    with StepClock(tess_stage_targets()) as clock:
        chips, seconds = tessellate_kept(path, arr, res, grid,
                                         keep_core_geom)
        stages = clock.take()
    stages["assembly"] = round(seconds - sum(stages.values()), 4)
    return chips, seconds, stages


def chipset_diff(a, b) -> list:
    """The fields in which two ChipSets differ, bit for bit."""
    import numpy as np
    out = [f for f in ("cell_id", "geom_id", "is_core")
           if not np.array_equal(getattr(a, f), getattr(b, f))]
    for f in ("coords", "ring_offsets", "part_offsets", "geom_offsets",
              "types"):
        x, y = np.asarray(getattr(a.geoms, f)), np.asarray(getattr(b.geoms, f))
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            out.append(f"geoms.{f}")
    return out


def k4_op_costs():
    """(per real edge pair, per A edge, per B edge, per match, per edge
    length) f32 operations (K4_ARITH) of K4's plain version.  The plain
    version's count is bilinear in the two edge caps, so counts at caps 1
    and 2 on each side give its coefficients (checked at caps 3 x 5);
    the edge lengths come out of the per-edge terms, to be charged once
    per row read rather than once per match."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.ops.overlay_pairs import (_lengths,
                                                    chip_pair_test_ref)
    r = np.random.default_rng(0)

    def rows(cap):
        return torch.from_numpy(r.uniform(-0.1, 0.1, (64, cap, 4)).astype(
            np.float32))

    def ops(ea_cap, eb_cap):
        eb = rows(eb_cap)
        return count_ops(lambda x: chip_pair_test_ref(x, eb, 1e-6),
                         rows(ea_cap), K4_ARITH)[0]

    f11, f21, f12, f22 = ops(1, 1), ops(2, 1), ops(1, 2), ops(2, 2)
    pair = f22 - f21 - f12 + f11
    per_a, per_b = f21 - f11 - pair, f12 - f11 - pair
    per_match = f11 - pair - per_a - per_b
    check(ops(3, 5) == 15 * pair + 3 * per_a + 5 * per_b + per_match,
          "K4's plain version's op count is not bilinear in the caps")
    length = count_ops(_lengths, rows(1), K4_ARITH)[0]
    log(f"[overlay] K4's plain version: {pair} f32 operations per edge "
        f"pair, {per_a} and {per_b} per A and B edge of a match ({length} "
        f"of them the edge's length), {per_match} per match")
    return pair, per_a - length, per_b - length, per_match, length


def k4_work(A, B, order, start, upper, hits, hazards, costs):
    """(operations, bytes) the chip-pair probe needs on this run's rows.
    Operations: those of the real edge pairs and edges of every match,
    the edge lengths once per row read.  Bytes: each A row in some B
    row's range and each B row with a range read once (edges, id, sort
    position or range), each 1 of the dense result written once."""
    import torch
    from mosaic_tpu_torch.ops.overlay_pairs import PAD_ABOVE
    pair, per_a, per_b, per_match, length = costs
    real_a = (A.edges[..., 0].abs() <= PAD_ABOVE).sum(1)[order]
    real_b = (B.edges[..., 0].abs() <= PAD_ABOVE).sum(1)
    n = upper - start
    cum = torch.cat([real_a.new_zeros(1), real_a.cumsum(0)])
    edges_a = cum[upper] - cum[start]      # A edges over each B row's range
    cover = torch.zeros(len(order) + 1, dtype=torch.int64,
                        device=order.device)
    live = n > 0
    cover.index_add_(0, start[live], torch.ones_like(start[live]))
    cover.index_add_(0, upper[live], -torch.ones_like(upper[live]))
    probed = cover.cumsum(0)[:-1] > 0
    ops = (pair * int((real_b * edges_a).sum()) +
           per_a * int(edges_a.sum()) + per_b * int((real_b * n).sum()) +
           per_match * int(n.sum()) +
           length * int(real_a[probed].sum() + real_b[live].sum()))
    nbytes = (int(probed.sum()) * (A.edges.shape[1] * 16 + 16) +
              int(live.sum()) * (B.edges.shape[1] * 16 + 24) +
              4 * int(hits.sum() + hazards.sum()))
    return ops, nbytes, int(probed.sum()), int(live.sum())


def exact_box_area(box, rings) -> float:
    """area(box ∩ region) in exact rational arithmetic, rounded once: the
    even-odd region of ``rings`` (region-left oriented, holes clockwise)
    clipped ring by ring to the axis-aligned ``box`` [2, 2] (min corner,
    max corner; Sutherland-Hodgman, exact for a convex window), signed
    areas summed."""
    from fractions import Fraction
    lo = [Fraction(float(v)) for v in box[0]]
    hi = [Fraction(float(v)) for v in box[1]]
    total = Fraction(0)
    for ring in rings:
        pts = [(Fraction(float(x)), Fraction(float(y))) for x, y in ring]
        for axis in (0, 1):
            for bound, keep in ((lo[axis], lambda v, b: v >= b),
                                (hi[axis], lambda v, b: v <= b)):
                clipped = []
                for p, q in zip(pts[-1:] + pts[:-1], pts):
                    if keep(p[axis], bound) != keep(q[axis], bound):
                        t = (bound - p[axis]) / (q[axis] - p[axis])
                        clipped.append(tuple(
                            bound if k == axis else p[k] + t * (q[k] - p[k])
                            for k in (0, 1)))
                    if keep(q[axis], bound):
                        clipped.append(q)
                pts = clipped
        total += sum(p[0] * q[1] - q[0] * p[1]
                     for p, q in zip(pts, pts[1:] + pts[:1])) / 2
    return float(total)


def widen_rows(r, width: int):
    """Chip rows re-padded to ``width`` edge slots: a row's first real
    edge stays in slot 0, the rest move to its last slots, 1e9 between."""
    import torch
    from mosaic_tpu_torch.ops import overlay_pairs as op
    count, moved = op.staged_rows_ref(r.edges)[:2]
    n, cap = r.edges.shape[:2]
    k = torch.arange(cap, device=r.edges.device)[None, :]
    slot = torch.where(k == 0, 0, width - count[:, None] + k)
    wide = torch.full((n, width, 4), 1e9, dtype=torch.float32,
                      device=r.edges.device)
    real = k < count[:, None]
    rows = torch.arange(n, device=r.edges.device)[:, None].expand(-1, cap)
    wide[rows[real], slot[real]] = moved[real]
    return r._replace(edges=wide)


def overlay_wide_rows(A, B, ga: int, gb: int, eps: float):
    """K4 on chip rows wider than the flagship's: the A rows and the first
    OVERLAY_WIDE_B B rows with a range re-padded to each width of
    OVERLAY_WIDE (staged in shared memory below 228 edges, read from
    global memory above), in both modes against the plain version."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.ops import overlay_pairs as op
    order, start, upper = op.probe(A, B)
    pick = torch.nonzero(upper > start).squeeze(1)[:OVERLAY_WIDE_B]
    Bs = type(B)(*(t[pick] for t in B))
    out = {}
    for width in OVERLAY_WIDE:
        Aw, Bw = widen_rows(A, width), widen_rows(Bs, width)
        hk, zk = op.overlay_dense(Aw, Bw, ga, gb, eps)
        hr, zr = op.local_sorted_join_ref(Aw, Bw, ga, gb, eps)
        dh, dz = int((hk != hr).sum()), int((zk != zr).sum())
        Ar = Aw._replace(ids=torch.arange(len(Aw.ids), device=DEV))
        Br = Bw._replace(ids=torch.arange(len(Bw.ids), device=DEV))
        row_mult = len(Br.ids) + 1
        kk = np.sort(op.overlay_pairs(Ar, Br, row_mult, eps, 64).cpu()
                     .numpy())
        kr = np.sort(op.local_pair_join_ref(Ar, Br, row_mult, eps).cpu()
                     .numpy())
        ms = time_ms(lambda: op.overlay_dense(Aw, Bw, ga, gb, eps), 5)
        log(f"[overlay] K4 at {width} edge slots a row ({len(pick)} B rows, "
            f"{int((upper - start)[pick].sum())} matches; A rows "
            f"{'staged' if width < 228 else 'read from global memory'}): "
            f"dense hits differ from plain at {dh}, hazards at {dz} "
            f"({int(hr.sum())} hits, {int(zr.sum())} hazards); pair keys "
            f"{len(kk)} from K4, {len(kr)} plain; the wrapper {ms:.4f} ms "
            "by events")
        check(dh == 0 and dz == 0 and np.array_equal(kk, kr) and
              int(hr.sum()) > 0, f"K4 at {width} edge slots differs from "
              f"its plain version: hits at {dh}, hazards at {dz}, "
              f"{len(kk)} keys against {len(kr)}")
        out[width] = ms
        del Aw, Bw, Ar, Br
    return out


def phase_overlay(zones, grid):
    """The polygon x polygon overlay at borough scale: bench.py's footprint
    boxes x the flagship's 281 taxi zones at H3 res 9, both entry points
    counted, K4 against its plain version on the full workload, the f64
    oracle on a footprint sample and the area contract."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import footprints
    from mosaic_tpu_torch.core.geometry import clip
    from mosaic_tpu_torch.ops import overlay_pairs as op
    from mosaic_tpu_torch.parallel import overlay as ov

    t0 = time.perf_counter()
    foot = footprints(OVERLAY_FOOTPRINTS)
    t_gen = time.perf_counter() - t0
    chips_a, t_tess_a, stages_a = tessellate_staged(
        "overlay footprint tessellation", foot, RES, grid, True)
    chips_b, t_tess_b, _ = tessellate_staged(
        "overlay zone tessellation", zones, RES, grid, True)
    GA, GB = len(foot), len(zones)
    log(f"[overlay] {GA} footprints (made in {t_gen:.2f} s) -> "
        f"{len(chips_a)} chips ({int(chips_a.is_core.sum())} core), "
        f"tessellation on the card {t_tess_a:.2f} s, by stage {stages_a}; "
        f"{GB} zones -> {len(chips_b)} chips "
        f"({int(chips_b.is_core.sum())} core), tessellation {t_tess_b:.2f} s")
    # the first footprints' ChipSet against the plain path
    first = foot.take(list(range(OVERLAY_TESS_CHECK)))
    t0 = time.perf_counter()
    dev_first = mt.tessellate(first, RES, grid, keep_core_geom=True,
                              device=DEV)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain_first = mt.tessellate(first, RES, grid, keep_core_geom=True,
                                device="cpu")
    t_plain = time.perf_counter() - t0
    diff = chipset_diff(dev_first, plain_first)
    log(f"[overlay] the first {OVERLAY_TESS_CHECK} footprints: "
        f"{len(dev_first)} chips on the card ({t_first:.2f} s), "
        f"{len(plain_first)} by the plain path on the CPU ({t_plain:.2f} "
        f"s); differing fields {diff}")
    check(not diff, f"footprint ChipSet differs from the plain path: {diff}")

    # ---- the main path, counted: both entry points, counts to 0 before;
    # the steps inside them timed by wrapping the module functions
    clock = StepClock(
        [(ov, "pack_chip_rows"), (ov, "overlay_rows_from_arrays"),
         (ov, "overlay_dense"), (ov, "overlay_pairs"),
         (ov, "resolve_hazards"), (clip, "pairs_intersection_area")],
        sync={"overlay_dense", "overlay_pairs", "overlay_rows_from_arrays"})
    with clock:
        reset_counts()
        t0 = time.perf_counter()
        hits = mt.overlay_intersects(foot, zones, RES, grid, device=DEV,
                                     chips_a=chips_a, chips_b=chips_b)
        t_inter = time.perf_counter() - t0
        c_inter = launch_counts()
        steps_inter = clock.take()
        reset_counts()
        t0 = time.perf_counter()
        ga, gb, area = mt.overlay_intersection_area(
            foot, zones, RES, grid, device=DEV, chips_a=chips_a,
            chips_b=chips_b)
        t_area = time.perf_counter() - t0
        c_area = launch_counts()
        steps_area = clock.take()
    log(f"[overlay] overlay_intersects: {t_inter:.3f} s = "
        f"{GA / t_inter:.4e} footprints/s end to end (host clock, chips "
        f"given), {int(hits.sum())} intersecting pairs; counts {c_inter}")
    log(f"[overlay] overlay_intersects steps (s): {steps_inter}")
    log(f"[overlay] overlay_intersection_area: {t_area:.3f} s = "
        f"{GA / t_area:.4e} footprints/s end to end, {len(ga)} pairs with "
        f"area > 0; counts {c_area}")
    log(f"[overlay] overlay_intersection_area steps (s): {steps_area}")
    check(c_inter["overlay_pairs_dense"] == 1 and
          c_inter["overlay_pairs_keys"] == 0, f"overlay_intersects "
          f"launched K4 {c_inter['overlay_pairs_dense']} + "
          f"{c_inter['overlay_pairs_keys']} times, not once")
    check(c_area["overlay_pairs_keys"] in (1, 2) and
          c_area["overlay_pairs_dense"] == 0, f"overlay_intersection_area "
          f"launched K4 {c_area['overlay_pairs_keys']} + "
          f"{c_area['overlay_pairs_dense']} times, not one or two")
    check(c_area["native_intersect_area_pairs"] > 0, "the pair areas never "
          "ran the native intersect_area_pairs")
    for c in (c_inter, c_area):
        check(c["overlay_prep_b"] == c["overlay_pairs"], f"the B-row "
              f"pre-pass launched {c['overlay_prep_b']} times for "
              f"{c['overlay_pairs']} K4 launches")
    for c in (c_inter, c_area):
        check(c["h3_dense_join"] == c["h3_project_lattice"] ==
              c["h3_latlng_to_cell"] == 0, f"a PIP kernel launched on the "
              f"overlay path: {c}")
    check(hits.shape == (GA, GB) and hits.dtype == bool, "overlay_intersects "
          f"returned {hits.shape} {hits.dtype}")
    check(np.all(np.isfinite(area)) and np.all(area > 0) and
          np.all((ga >= 0) & (ga < GA) & (gb >= 0) & (gb < GB)),
          "intersection areas not finite and positive, or ids out of range")

    # the rows once more, for K4 against its plain version
    ra = ov.pack_chip_rows(foot, RES, grid, chips=chips_a)
    rb = ov.pack_chip_rows(zones, RES, grid, chips=chips_b, origin=ra[4])
    A = ov.overlay_rows_from_arrays(ra, DEV)
    B = ov.overlay_rows_from_arrays(rb, DEV)
    eps = ov.hazard_eps(ra[2], rb[2])
    order, start, upper = op.probe(A, B)
    matches = int((upper - start).sum())
    dup = int((upper - start).max())
    real_a = op.staged_rows_ref(A.edges)[0]
    real_b = op.staged_rows_ref(B.edges)[0]
    ranges = upper - start
    log(f"[overlay] K4 workload: edge caps {A.edges.shape[1]} (A) and "
        f"{B.edges.shape[1]} (B); real edges per row, count of rows with "
        f"0, 1, ...: A {torch.bincount(real_a).tolist()}, B "
        f"{torch.bincount(real_b).tolist()}; range lengths of the B rows, "
        f"count with 0, 1, ...: {torch.bincount(ranges).tolist()}; "
        f"{int((ranges > 0).sum())} B rows with a range; real B edges per "
        f"match {float((real_b * ranges).sum()) / max(matches, 1):.2f}")
    hk, zk = op.overlay_dense(A, B, GA, GB, eps)
    n_hazard = int(zk.sum())
    log(f"[overlay] rows {tuple(A.edges.shape)} x {tuple(B.edges.shape)}, "
        f"eps {eps:.3e} deg; {matches} chip-pair matches, up to {dup} "
        f"footprint chips in a probed cell; {n_hazard} hazard pairs of "
        f"{int(hk.sum())} raw hits resolved in f64 on the host in "
        f"{steps_inter['resolve_hazards']:.3f} s "
        f"({steps_inter['resolve_hazards'] / max(n_hazard, 1) * 1e3:.4f} "
        "ms per pair)")

    # ---- K4 against its plain version on the card, the full workload
    hr, zr = op.local_sorted_join_ref(A, B, GA, GB, eps)
    dh, dz = int((hk != hr).sum()), int((zk != zr).sum())
    log(f"[overlay] K4 dense vs plain: hits differ at {dh}, hazards at {dz} "
        f"of {GA * GB}")
    check(dh == 0 and dz == 0, f"K4 dense differs from its plain version: "
          f"hits at {dh}, hazards at {dz}")
    Ar = A._replace(ids=torch.arange(len(ra[0]), device=A.ids.device))
    Br = B._replace(ids=torch.arange(len(rb[0]), device=B.ids.device))
    row_mult = len(rb[0]) + 1
    kk = op.overlay_pairs(Ar, Br, row_mult, eps, max(1024, 4 * len(ra[0])))
    kr = op.local_pair_join_ref(Ar, Br, row_mult, eps)
    kk_np, kr_np = kk.cpu().numpy(), kr.cpu().numpy()
    log(f"[overlay] K4 pairs vs plain: {len(kk_np)} keys from K4, "
        f"{len(kr_np)} from the plain version")
    check(len(np.unique(kk_np)) == len(kk_np) and
          np.array_equal(np.sort(kk_np), np.sort(kr_np)), "K4 pair keys "
          "differ from its plain version's")
    rows_a, rows_b = ov.overlay_row_pairs(chips_a, chips_b, foot, zones, RES,
                                          grid, device=DEV)
    check(np.array_equal(np.sort(kk_np), rows_a * row_mult + rows_b),
          "overlay_row_pairs differs from the pair keys")
    small = op.overlay_pairs(Ar, Br, row_mult, eps, 1024)
    check(np.array_equal(np.sort(small.cpu().numpy()), np.sort(kk_np)),
          "a relaunch after a short key buffer changed the pair keys")
    # the B-row pre-pass against its plain version: counts, the real
    # edges, their directions, lengths and reciprocals, bit for bit
    pb = op.prep_b(B)
    count, moved, lengths, rcp = op.staged_rows_ref(B.edges)
    keep = torch.arange(B.edges.shape[1], device=DEV)[None, :] < \
        count[:, None]
    want_w = torch.stack([moved[..., 2] - moved[..., 0],
                          moved[..., 3] - moved[..., 1], lengths, rcp], -1)
    bad_e = int((pb.ew[:, :, 0].view(torch.int32) !=
                 moved.view(torch.int32))[keep].any(-1).sum())
    bad_w = int((pb.ew[:, :, 1].view(torch.int32) !=
                 want_w.view(torch.int32))[keep].any(-1).sum())
    same = torch.equal(pb.count.long(), count)
    check(same and bad_e == 0 and bad_w == 0, f"K4's B-row pre-pass "
          f"differs from staged_rows_ref: counts "
          f"{'equal' if same else 'differ'}, {bad_e} edges and {bad_w} "
          "lengths differ")
    log(f"[overlay] K4 pre-pass on the {len(B.cell)} B rows: counts, "
        f"edges, directions, lengths and reciprocals bit-equal to "
        f"staged_rows_ref ({int(keep.sum())} real edges)")
    wide = overlay_wide_rows(A, B, GA, GB, eps)

    # ---- exact oracle on sampled footprints, and the area contract
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(GA, OVERLAY_SAMPLE, replace=False))
    t0 = time.perf_counter()
    truth = ov.overlay_host_truth(foot.take(pick), zones)
    bad = int(np.sum(truth != hits[pick]))
    log(f"[overlay] oracle: {bad} mismatches on {OVERLAY_SAMPLE} sampled "
        f"footprints x {GB} zones ({int(truth.sum())} intersecting, "
        f"{time.perf_counter() - t0:.1f} s)")
    check(bad == 0, f"{bad} overlay pairs differ from overlay_host_truth")
    check(truth.any() and not truth.all(), "the sample lacks an outcome")
    # every sampled footprint is a box: its exact area with a zone is
    # the zone clipped to the box
    t0 = time.perf_counter()
    boxes = foot.bboxes().reshape(-1, 2, 2)
    zone_rings = [clip._normalize_rings(clip.geometry_rings(zones, j))
                  for j in range(GB)]
    for i in pick:
        ring = clip.geometry_rings(foot, int(i))[0]
        check(len(ring) == 4 and np.all(
            (ring == boxes[i][0]) | (ring == boxes[i][1])),
            f"footprint {i} is not an axis-aligned box")
    sampled = np.nonzero(np.isin(ga, pick))[0]
    got_pairs = set(zip(ga[sampled].tolist(), gb[sampled].tolist()))
    ti, tj = np.nonzero(truth)
    want_pairs = set(zip(pick[ti].tolist(), tj.tolist()))
    extra = got_pairs - want_pairs
    missing = want_pairs - got_pairs
    worst = max([exact_box_area(boxes[i], zone_rings[j])
                 for i, j in missing], default=0.0)
    log(f"[overlay] area pairs on the sample: {len(got_pairs)} with area, "
        f"{len(want_pairs)} intersecting; {len(extra)} extra, "
        f"{len(missing)} missing (largest exact area among them "
        f"{worst:.3e})")
    check(not extra and worst < 1e-15, f"area pair set differs from the "
          f"intersecting pairs: {len(extra)} extra, missing up to {worst}")
    exact = np.array([exact_box_area(boxes[ga[k]], zone_rings[gb[k]])
                      for k in sampled])
    err = np.abs(area[sampled] - exact)
    over = np.nonzero(err >= 1e-12 + 1e-9 * exact)[0]
    log(f"[overlay] the {len(sampled)} pair areas of the sampled "
        f"footprints against their exact areas: largest error "
        f"{err.max():.3e}, largest relative {np.max(err / exact):.3e}; "
        f"{len(over)} beyond 1e-12 + 1e-9 area "
        f"({time.perf_counter() - t0:.1f} s)")
    check(len(over) == 0, "pair areas beyond 1e-12 + 1e-9 area: " + ", ".join(
        f"({ga[sampled[k]]}, {gb[sampled[k]]}) {area[sampled[k]]} for "
        f"{exact[k]}" for k in over[:5]))

    # ---- K4's times beside its bound and the plain version's
    ops, nbytes, rows_a, rows_b = k4_work(A, B, order, start, upper, hk, zk,
                                          k4_op_costs())
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ms, source, events_ms, host_ms, plain_ms = timed_kernel(
        "overlay K4 dense", lambda: op.overlay_dense(A, B, GA, GB, eps),
        lambda: op.local_sorted_join_ref(A, B, GA, GB, eps),
        "overlay_kernel", 2)
    pairs_ms = time_ms(lambda: op.overlay_pairs(
        Ar, Br, row_mult, eps, max(1024, 4 * len(ra[0]))), 20)
    # the match list's A sort waits on the card, so events over a loop
    ml_ms = time_ms(lambda: op.match_list(A, B), 20)
    # the B rows sorted by cell (those with a range first): what such a
    # sort in the wrapper would save in the kernel and cost around it
    key_b = torch.where(upper > start, B.cell, op._INT64_MAX)
    sort_b = lambda: B.ids[torch.sort(key_b, stable=True)[1]]  # noqa: E731
    Bs = type(B)(*(t[torch.sort(key_b, stable=True)[1]] for t in B))
    hs, zs = op.overlay_dense(A, Bs, GA, GB, eps)
    check(torch.equal(hs, hk) and torch.equal(zs, zk), "K4 on the B rows "
          "sorted by cell differs from K4 on them in their own order")
    sorted_ms, sorted_source = kernel_device_ms(
        lambda: op.overlay_dense(A, Bs, GA, GB, eps), 50, "overlay_kernel")
    sort_ms = time_ms(sort_b, 20)
    sort_host_ms = host_ms_per_launch(sort_b, 200)
    log(f"[overlay] K4 on the B rows sorted by cell: {sorted_ms:.4f} ms "
        f"({sorted_source}) against {ms:.4f} in their own order; the sort "
        f"and a gather {sort_ms:.4f} ms by events, {sort_host_ms:.4f} ms "
        "host enqueue")
    prep = timed_kernel("overlay pre-pass", lambda: op.prep_b(B),
                        lambda: op.staged_rows_ref(B.edges),
                        "prep_b_kernel", 5)
    # bytes: each B row read once; its count and each real edge's 32
    # bytes written once
    prep_bytes = B.edges.numel() * 4 + 4 * len(B.cell) + \
        32 * int(op.staged_rows_ref(B.edges)[0].sum())
    prep_bound = prep_bytes / PEAK_BYTES * 1e3
    log(f"[overlay] K4 pre-pass: bound {prep_bound:.4f} ms (bytes: "
        f"{prep_bytes}), roofline share {prep_bound / prep[0]:.4f}")
    bound = max(ops_ms, bytes_ms)
    log(f"[overlay] K4: bound {bound:.4f} ms (operations {ops_ms:.4f}: "
        f"{ops} over the real edges of the {matches} matches; bytes "
        f"{bytes_ms:.4f}: {nbytes}, {rows_a} A rows and {rows_b} B rows "
        f"read once, the 1s written once), roofline share "
        f"{bound / ms:.4f}; the wrapper call {events_ms:.4f} ms by events "
        f"(the match list, {ml_ms:.4f} ms by events, the zeroing, the B-row "
        f"pre-pass, {prep[0]:.4f} ms by {prep[1]}, and the kernel); "
        f"the pairs mode call {pairs_ms:.4f} ms by events (match "
        "list, one launch, the count read back)")
    return {"counts_intersects": c_inter, "counts_area": c_area,
            "shard_inputs": (foot, chips_b),
            "chips": [len(chips_a), len(chips_b)],
            "tessellate_s": [t_tess_a, t_tess_b],
            "tessellate_stages_s": stages_a,
            "tessellate_first_s": [t_first, t_plain],
            "steps_intersects_s": steps_inter, "steps_area_s": steps_area,
            "matches": matches, "max_dup": dup, "hazard_pairs": n_hazard,
            "area_pairs_checked": len(sampled),
            "area_max_err": float(err.max(initial=0.0)),
            "intersects_s": t_inter, "area_s": t_area,
            "footprints_per_s": [GA / t_inter, GA / t_area],
            "kernel": {"plain_ms": plain_ms, "ms": ms, "ms_source": source,
                       "events_ms": events_ms, "host_ms": host_ms,
                       "bound_ms": bound, "pairs_events_ms": pairs_ms,
                       "match_list_ms": ml_ms, "sorted_b_ms": sorted_ms,
                       "sort_b_ms": sort_ms, "sort_b_host_ms": sort_host_ms,
                       "wide_rows_ms": wide,
                       "bound_by": "operations" if ops_ms >= bytes_ms
                       else "bytes", "max_abs_err": 0.0},
            "prep": {"ms": prep[0], "ms_source": prep[1],
                     "events_ms": prep[2], "host_ms": prep[3],
                     "plain_ms": prep[4], "bound_ms": prep_bound,
                     "bound_by": "bytes", "max_abs_err": 0.0}}


def knn_ring_work(idx, rows, offs, omask, k1: int):
    """(bytes, f32 operations) one ring step must move and do on this
    ring's data: each row's point and window scalars (36 bytes) and its
    list read and written (16 bytes an entry), each window entry the
    ring's in-window offsets touch read once (4 bytes), each pool row
    with a point examined read once (cap x 8 bytes) and the offsets (9
    bytes each); 5 flops (2 sub, 2 mul, 1 add) per pool point examined
    (empty cells and offsets outside the window examine none)."""
    import torch
    pts, al, bl, a0r, b0r, wr, hr, eoffr = rows
    n, cap = int(pts.shape[0]), idx.cap
    seen_e = torch.zeros(int(idx.entry.shape[0]), dtype=torch.bool,
                         device=pts.device)
    seen_s = torch.zeros(int(idx.pool_xy.shape[0]), dtype=torch.bool,
                         device=pts.device)
    points = 0
    for o in range(int(offs.shape[0])):
        if not bool(omask[o]):
            continue
        ia = al + offs[o, 0] - a0r
        ib = bl + offs[o, 1] - b0r
        inw = (ia >= 0) & (ia < wr) & (ib >= 0) & (ib < hr)
        lidx = (eoffr + ia * hr + ib)[inw].long()
        seen_e[lidx] = True
        slot = idx.entry[lidx]
        slot = slot[slot >= 0].long()
        seen_s[slot] = True
        points += int(slot.numel()) * cap
    nbytes = n * (36 + 16 * k1) + int(seen_e.sum()) * 4 + \
        int(seen_s.sum()) * cap * 8 + int(offs.shape[0]) * 9
    return nbytes, 5 * points


def phase_knn():
    """SpatialKNN at BASELINE config 4 (bench.py:1510-1538): AIS pings x
    world ports at global extent, k = 5, H3 res 4, 32 rings at most; the
    default (brute) path and the ring path, each counted; K5 and K6 held
    against their plain versions on the run's own inputs and timed."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.models import knn as knn_mod
    from mosaic_tpu_torch.ops import knn_brute, knn_ring

    pings, ports = mt.ais_pings_ports(KNN_PINGS, KNN_PORTS, seed=31)
    grid = mt.get_index_system("H3")
    n, m = len(pings), len(ports)
    log(f"[knn] {n} pings x {m} ports (seed 31), k={KNN_K}, H3 res "
        f"{KNN_RES}, at most {KNN_MAX_IT} rings")
    paths = {}
    # K6's inputs and outputs, ring by ring, recorded in the ring path's
    # counted run for the comparison below
    states = []
    real_step = knn_mod.ring_step

    def record(*args):
        outs = real_step(*args)
        states.append((args, outs))
        return outs

    clock = StepClock([(knn_mod, "build_knn_indexes"),
                       (knn_mod, "_host_lattice"),
                       (knn_mod, "_brute_topk_blocked"),
                       (knn_mod, "stream"), (knn_mod, "ring_step")],
                      sync={"ring_step", "stream"})

    def counted(knn):
        # the main path, counted: counts to 0, drive, read; the steps
        # timed by wrapping the module functions (a synchronize after
        # each ring step, which the ring's one scalar read makes anyway,
        # and after the brute stream, whose consume has read every block)
        with clock:
            reset_counts()
            t0 = time.perf_counter()
            out = knn.transform(pings, ports)
            t = time.perf_counter() - t0
            c = launch_counts()
            return out, t, c, clock.take()

    # the ring path has no warm run: ~80 s of f64 host work that warms
    # nothing its one run needs once K6's library is loaded here
    knn_ring._lib()
    for path, kw in (("brute", {}), ("ring", {"brute_right_max": 0})):
        knn = mt.SpatialKNN(grid, k=KNN_K, index_resolution=KNN_RES,
                            max_iterations=KNN_MAX_IT, device=DEV, **kw)
        if path == "brute":
            t0 = time.perf_counter()
            knn.transform(pings, ports)
            t_warm = time.perf_counter() - t0
            runs = [counted(knn) for _ in range(KNN_STEADY)]
            prof = profile_batch(lambda p: knn.transform(p, ports), pings,
                                 min(r[1] for r in runs) * 1e3,
                                 chunk=knn_mod.BRUTE_BLOCK)
        else:
            # its one counted run is the profiled one (its host work is
            # numpy, which the profiler does not trace) and records K6's
            # states
            t_warm, runs = None, []
            knn_mod.ring_step = record
            try:
                prof = profile_batch(
                    lambda p: runs.append(counted(knn)), pings, None,
                    chunk=len(pings))
                if not runs:              # the profiler could not start
                    runs.append(counted(knn))
            finally:
                knn_mod.ring_step = real_step
        out = runs[-1][0]
        times = [r[1] for r in runs]
        med = float(np.median(times))
        under = "; under the profiler" if path == "ring" else ""
        log(f"[knn {path}] warm run {t_warm} s; counted {times} s, "
            f"median {med:.3f} s = {n / med:.4e} rows/s end to end (host "
            f"clock, f64 in and out{under}); iterations "
            f"{out['iterations']}, rechecked {out['rechecked']}; counts "
            f"{runs[-1][2]}")
        log(f"[knn {path}] steps of each counted run (s): "
            f"{[r[3] for r in runs]}")
        d = knn._last_decision
        decision = {"strategy": d.strategy, "reason": d.reason,
                    "forced": d.forced}
        log(f"[knn {path}] the planner's engine decision: {decision}")
        check(d.strategy == path, f"knn {path}: the planner picked "
              f"{d.strategy}")
        paths[path] = {"out": out, "s": times, "warm_s": t_warm,
                       "decision": decision,
                       "rows_per_s": n / med, "counts": runs[-1][2],
                       "all_counts": [r[2] for r in runs],
                       "steps_s": [r[3] for r in runs],
                       "iterations": out["iterations"],
                       "rechecked": out["rechecked"], "profile": prof}
    brute, ring = paths["brute"], paths["ring"]
    blocks = -(-n // knn_mod.BRUTE_BLOCK)
    for c in brute["all_counts"]:
        check(c["knn_brute_topk"] == blocks and c["knn_ring_step"] == 0,
              f"knn brute launched K5 {c['knn_brute_topk']} times for "
              f"{blocks} blocks and K6 {c['knn_ring_step']} times")
    for c in ring["all_counts"]:
        check(c["knn_ring_step"] == ring["iterations"] and
              c["knn_brute_topk"] == 0, f"knn ring launched K6 "
              f"{c['knn_ring_step']} times for {ring['iterations']} rings "
              f"and K5 {c['knn_brute_topk']} times")
    diff = int(np.sum(brute["out"]["right_id"] != ring["out"]["right_id"]))
    ddiff = int(np.sum(~((brute["out"]["distance"] ==
                          ring["out"]["distance"]) |
                         (np.isnan(brute["out"]["distance"]) &
                          np.isnan(ring["out"]["distance"])))))
    log(f"[knn] brute and ring: right_id differ at {diff}, distances at "
        f"{ddiff} of {n * KNN_K}")
    check(diff == 0 and ddiff == 0, f"brute and ring answers differ at "
          f"{diff} ids and {ddiff} distances")
    t0 = time.perf_counter()
    ids, dist = mt.knn_host_truth(pings[:KNN_ORACLE], ports, KNN_K)
    mism = {p: int(np.sum(r["out"]["right_id"][:KNN_ORACLE] != ids))
            for p, r in paths.items()}
    log(f"[knn] against knn_host_truth on the first {KNN_ORACLE} pings: "
        f"mismatches {mism} ({time.perf_counter() - t0:.1f} s)")
    check(all(v == 0 for v in mism.values()), f"knn oracle mismatches "
          f"{mism}")

    # ---- K5 against its plain version on full-width blocks of the run,
    # at the main path's kc, at k = 100's and past one launch's KC_PASS
    order = np.lexsort((pings[:, 0], np.round(pings[:, 1] / 4.0)))
    lx = pings[order]
    kc = min(KNN_K + 8, m)
    kcs = (kc, *(min(w, m) for w in KNN_WIDE_KC))
    right = torch.from_numpy(ports).to(DEV)
    B = knn_mod.BRUTE_BLOCK

    def k5_bad(label, lc, rd, center):
        # one stable sort; each width is its prefix
        pd2, pidx = knn_brute.brute_topk_ref(
            lc, knn_brute.center_right(rd, center), max(kcs))
        bad = []
        for w in kcs:
            kd2, kidx = knn_brute.brute_topk(lc, rd, center, w)
            bad.append(int((kd2.view(torch.int32) !=
                            pd2[:, :w].view(torch.int32)).sum()) +
                       int((kidx != pidx[:, :w]).sum()))
        log(f"[knn K5] {label}: at kc {kcs} {bad} d2 bits and indices "
            "differ from the plain version")
        return sum(bad), pd2

    nb = 0
    for b in sorted({0, 1, blocks // 2, blocks - 1}):
        rows = lx[b * B:(b + 1) * B]
        center = rows.mean(axis=0)
        lc = torch.from_numpy((rows - center).astype(np.float32)).to(DEV)
        nb += k5_bad(f"block {b} ({len(rows)} rows)", lc, right, center)[0]
    # ties: the right side with a third of it repeated, shuffled
    r = np.random.default_rng(5)
    dup = np.concatenate([ports, ports[r.integers(0, m, m // 3)]])
    r.shuffle(dup)
    rows = lx[:B]
    center = rows.mean(axis=0)
    lc = torch.from_numpy((rows - center).astype(np.float32)).to(DEV)
    bad, pd2 = k5_bad(f"duplicated right side ({len(dup)} points)", lc,
                      torch.from_numpy(dup).to(DEV), center)
    nb += bad
    log(f"[knn K5] the duplicated side's plain lists hold "
        f"{int((pd2[:, 1:kc] == pd2[:, :kc - 1]).sum())} tied neighbours "
        f"at kc {kc}")
    check(nb == 0, f"K5 differs from its plain version at {nb} places")
    # timed in turns on the middle block of the run; the main path's
    # mean per launch over its 128 blocks comes from the brute profile
    mid = blocks // 2
    rows = lx[mid * B:(mid + 1) * B]
    center = rows.mean(axis=0)
    lc = torch.from_numpy((rows - center).astype(np.float32)).to(DEV)
    rc = knn_brute.center_right(right, center)

    def library():
        dx = lc[:, None, 0] - rc[None, :, 0]
        dy = lc[:, None, 1] - rc[None, :, 1]
        return torch.topk(dx * dx + dy * dy, kc, dim=1, largest=False)
    block_ms, source, events_ms, host_ms, plain_ms = timed_kernel(
        f"knn K5 block {mid}",
        lambda: knn_brute.brute_topk(lc, right, center, kc),
        lambda: knn_brute.brute_topk_ref(
            lc, knn_brute.center_right(right, center), kc),
        "brute_kernel", 10)
    lib_ms = time_ms(library, 20)
    # the main path's mean over its blocks when the brute profile holds
    # every launch, else the middle block's reading
    main = [(t, c) for key, t, c in brute["profile"].get("ops", [])
            if "brute_kernel" in key]
    main_ms = main[0][0] / main[0][1] if main else None
    log(f"[knn K5] the brute profile recorded "
        f"{main[0][1] if main else 0} of {blocks} launches")
    ms, ms_source = (main_ms, "profiler, main path") \
        if main and main[0][1] == blocks else (block_ms, source)
    ops_ms = 5 * B * m / PEAK_F32_FLOPS * 1e3
    k5_bytes = B * 8 + m * 8 + B * kc * 8
    bytes_ms = k5_bytes / PEAK_BYTES * 1e3
    bound = max(ops_ms, bytes_ms)
    wide_ms = {w: time_ms(lambda: knn_brute.brute_topk(lc, right, center, w),
                          3) for w in kcs[1:]}
    log(f"[knn K5] block {mid} at kc {list(wide_ms)}: "
        f"{[round(v, 4) for v in wide_ms.values()]} ms (CUDA events over "
        f"{[-(-w // knn_brute.KC_PASS) for w in wide_ms]} launches a call)")
    log(f"[knn K5] {B} x {m}, kc {kc}: {ms:.4f} ms a launch ({ms_source}; "
        f"block {mid} alone {block_ms:.4f}); bound {bound:.5f} ms "
        f"(operations {ops_ms:.5f}: 5 flops a pair; bytes {bytes_ms:.5f}: "
        f"{k5_bytes}), roofline share {bound / ms:.4f}; on block {mid} the "
        f"plain version {plain_ms:.4f} ms, the torch distance matrix + "
        f"torch.topk {lib_ms:.4f} ms")
    k5 = {"plain_ms": plain_ms, "ms": ms, "ms_source": ms_source,
          "block_ms": block_ms, "block_ms_source": source,
          "main_path_profiler_ms": main_ms,
          "events_ms": events_ms, "host_ms": host_ms,
          "bound_ms": bound,
          "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
          "max_abs_err": 0.0, "library_ms": lib_ms,
          "wide_kc_ms": {str(w): v for w, v in wide_ms.items()}}

    # ---- K6 against its plain version on the ring run's own states
    idx = knn._idx
    rows6 = (knn._pts, knn._al, knn._bl, knn._a0r, knn._b0r, knn._wr,
             knn._hr, knn._eoffr)
    bad6, t_k, t_p, t_bound, work = 0, 0.0, 0.0, 0.0, []
    for d, (args, (kd2, kcode)) in enumerate(states):
        pd2, pcode = knn_ring.ring_step_ref(*args)
        bad = int((kd2.view(torch.int32) != pd2.view(torch.int32)).sum()) \
            + int((kcode != pcode).sum())
        bad6 += bad
        offs, omask = args[12], args[13]
        nbytes, ops = knn_ring_work(idx, rows6, offs, omask, KNN_K + 1)
        b_ms = max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS) * 1e3
        p_ms, k_ms = in_turns(lambda: knn_ring.ring_step_ref(*args),
                              lambda: knn_ring.ring_step(*args), 1, 5,
                              kernel_timer=queued_ms)
        t_k += k_ms
        t_p += p_ms
        t_bound += b_ms
        work.append((nbytes, ops))
        if d in (0, 1, len(states) // 2, len(states) - 1):
            log(f"[knn K6] ring {d} ({int(omask.sum())} offsets): {bad} "
                f"differ; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.5f} ms ({nbytes} bytes, {ops} flops)")
    check(bad6 == 0, f"K6 differs from its plain version at {bad6} places "
          f"over {len(states)} rings")
    # wider lists, k + 1 = 101 (shared memory) and 256 (global memory),
    # on a crowded index (each port KNN_CROWD times, so the lists fill,
    # evict and tie) over rings 0 .. KNN_CROWD_RINGS - 1 of the first
    # KNN_WIDE_PINGS pings, from empty lists, ring by ring
    crowd = np.repeat(ports, KNN_CROWD, axis=0)
    cidx, _, _ = knn_mod.build_knn_indexes(crowd, KNN_RES, grid, device=DEV)
    crows = knn_mod.ring_rows(cidx, pings[:KNN_WIDE_PINGS], DEV)[0]
    nw = len(crows[0])
    for k1 in (KNN_WIDE_K + 1, KNN_GLOBAL_K1):
        td = torch.full((nw, k1), float("inf"), device=DEV)
        tc = torch.full((nw, k1), -1, dtype=torch.int32, device=DEV)
        bad = 0
        for d in range(KNN_CROWD_RINGS):
            args = (cidx.entry, cidx.pool_xy, *crows, td, tc,
                    *states[d][0][12:14], cidx.cap, states[d][0][15])
            kd2, kcode = knn_ring.ring_step(*args)
            td, tc = knn_ring.ring_step_ref(*args)
            bad += int((kd2.view(torch.int32) != td.view(torch.int32)
                        ).sum()) + int((kcode != tc).sum())
        full = int((tc[:, -1] >= 0).sum())
        ties = int(((td[:, 1:] == td[:, :-1]) & (tc[:, 1:] >= 0)).sum())
        log(f"[knn K6] crowded index ({KNN_CROWD} x {m} points, cap "
            f"{cidx.cap}), k + 1 = {k1}, {nw} rows, rings 0-"
            f"{KNN_CROWD_RINGS - 1}: {bad} differ; {full} lists full, "
            f"{ties} tied neighbours")
        check(full > 0 and ties > 0, f"the crowded index filled {full} "
              f"lists of {k1} with {ties} ties")
        bad6 += bad
    check(bad6 == 0, f"K6 differs from its plain version at {bad6} places "
          "on the wide lists")
    last = states[-1][0]
    host6 = host_ms_per_launch(lambda: knn_ring.ring_step(*last), 20)
    # the last ring with the rows in a seeded random order, as the pings
    # come (their order is unrelated to their cells), against the march's
    # lattice order; and one ring of lists of 101
    shuffle = torch.randperm(n, generator=torch.Generator().manual_seed(7))
    shuffled = (*last[:2], *(t[shuffle.to(t.device)] for t in last[2:12]),
                *last[12:])
    lat_ms = queued_ms(lambda: knn_ring.ring_step(*last), 5)
    rand_ms = queued_ms(lambda: knn_ring.ring_step(*shuffled), 5)
    a = states[KNN_WIDE_RING + 1][0]
    wide_args = (*a[:10], torch.full((n, KNN_WIDE_K + 1), float("inf"),
                                     device=DEV),
                 torch.full((n, KNN_WIDE_K + 1), -1, dtype=torch.int32,
                            device=DEV), *a[12:])
    wide6_ms = queued_ms(lambda: knn_ring.ring_step(*wide_args), 3)
    log(f"[knn K6] ring {len(states) - 1}: {lat_ms:.4f} ms with the rows in "
        f"lattice order, {rand_ms:.4f} ms in a random order (queued "
        f"bursts); ring {KNN_WIDE_RING + 1} with lists of "
        f"{KNN_WIDE_K + 1}: {wide6_ms:.4f} ms")
    prof6 = [t / c for key, t, c in ring["profile"].get("ops", [])
             if "ring_kernel" in key]
    nbytes = sum(w[0] for w in work)
    ops = sum(w[1] for w in work)
    log(f"[knn K6] {len(states)} rings bit-equal to the plain version; the "
        f"march: kernel {t_k:.4f} ms (events, queued bursts), plain {t_p:.4f} ms, bound "
        f"{t_bound:.5f} ms ({nbytes} bytes, {ops} flops), roofline share "
        f"{t_bound / t_k:.4f}; the main path's mean per ring by the "
        f"profiler {prof6} ms, host enqueue {host6:.4f} ms per launch")
    n_r = len(states)
    k6 = {"plain_ms": t_p / n_r, "ms": t_k / n_r,
          "ms_source": "events, queued bursts",
          "events_ms": t_k / n_r, "host_ms": host6, "bound_ms": t_bound / n_r,
          "bound_by": "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_F32_FLOPS
          else "operations", "max_abs_err": 0.0, "library_ms": None,
          "march_ms": t_k, "march_plain_ms": t_p, "march_bound_ms": t_bound,
          "main_path_profiler_ms": prof6[0] if prof6 else None,
          "last_ring_lattice_ms": lat_ms, "last_ring_random_order_ms": rand_ms,
          "wide_list_ring_ms": wide6_ms}
    # ---- k = 100 on both engines, a cut workload, against the oracle
    sub = pings[:KNN_WIDE_PINGS]
    t0 = time.perf_counter()
    ids, dist = mt.knn_host_truth(sub, ports, KNN_WIDE_K)
    t_truth = time.perf_counter() - t0
    wide = {}
    for path, kw, kernel in (("brute", {}, "knn_brute_topk"),
                             ("ring", {"brute_right_max": 0},
                              "knn_ring_step")):
        knn_w = mt.SpatialKNN(grid, k=KNN_WIDE_K, index_resolution=KNN_RES,
                              max_iterations=KNN_MAX_IT, device=DEV, **kw)
        before = launch_counts()[kernel]
        t0 = time.perf_counter()
        out = knn_w.transform(sub, ports)
        t = time.perf_counter() - t0
        launched = launch_counts()[kernel] - before
        bad = int(np.sum(out["right_id"] != ids))
        derr = float(np.max(np.abs(np.where(ids >= 0, out["distance"] - dist,
                                            0.0))))
        wide[path] = {"s": t, "launches": launched, "mismatches": bad,
                      "max_distance_err": derr,
                      "rechecked": out["rechecked"],
                      "iterations": out["iterations"]}
        log(f"[knn k={KNN_WIDE_K}] {path}: {len(sub)} pings in {t:.2f} s, "
            f"{launched} {kernel} launches, iterations "
            f"{out['iterations']}, rechecked {out['rechecked']}; against "
            f"knn_host_truth ({t_truth:.1f} s): {bad} id mismatches, "
            f"distances within {derr:.3e}")
        check(bad == 0 and derr <= 1e-12 and launched > 0,
              f"k={KNN_WIDE_K} {path}: {bad} mismatches, distance error "
              f"{derr}, {launched} launches")
    summary = {p: {k: v for k, v in r.items() if k not in ("out",
                                                           "all_counts")}
               for p, r in paths.items()}
    summary["oracle_mismatches"] = mism
    summary["wide_k"] = wide
    # phase 16 runs the ring over a process group on the first pings
    sub = slice(0, SHARD_PINGS)
    return {"paths": summary, "k5": k5, "k6": k6,
            "shard_inputs": (pings[sub], ports, ring["out"]["right_id"][sub],
                             ring["out"]["distance"][sub])}


class LastArgs:
    """The arguments of the last call of each named module function while
    the block runs (restored on exit)."""

    def __init__(self, targets):
        self.targets, self.args = list(targets), {}

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.targets]
        for mod, name, fn in self.saved:
            def keep(*args, _fn=fn, _name=name):
                self.args[_name] = args
                return _fn(*args)
            setattr(mod, name, keep)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def k7_work(args):
    """(f64 instructions, bytes) of K7 on its inputs: the per-(pair, edge),
    per-query, per-straddle, per-vertex, per-side and per-zero counts
    above over this run's pairs (the straddles, the bbox overlaps and the
    zero orientations counted on the card in blocks), the per-edge and
    per-cell ones over the table's edges, cells and cell sides that they
    name; each input read once, the two flags written once."""
    import torch
    edges, edge_off, pair_geo, pair_cell, verts, counts, centers = args
    P, K = int(pair_geo.shape[0]), int(verts.shape[1])
    E = int(edges.shape[0])
    ne = (edge_off[1:] - edge_off[:-1])[pair_geo]
    n = counts[pair_cell].to(torch.int64)
    sentinel = torch.full((1, 4), float("inf"), dtype=edges.dtype,
                          device=edges.device)
    edges_p = torch.cat([edges, sentinel])
    kk = torch.arange(K, device=edges.device)
    work = collections.Counter()
    dy_edges, zero_cell_sides = [], []

    def orient(p, q, r):
        return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - \
            (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])

    block = max(1, (1 << 22) // max(int(ne.max()), 1))
    for s in range(0, P, block):
        e = min(s + block, P)
        ar = torch.arange(int(ne[s:e].max()), device=edges.device)
        real = ar[None] < ne[s:e, None]
        eidx = torch.where(real, edge_off[pair_geo[s:e], None] + ar, E)
        eg = edges_p[eidx]
        cv = verts[pair_cell[s:e]]
        vmask = kk[None] < n[s:e, None]
        px = torch.cat([centers[pair_cell[s:e], 0:1], cv[..., 0]], 1)
        py = torch.cat([centers[pair_cell[s:e], 1:2], cv[..., 1]], 1)
        qmask = torch.cat([torch.ones_like(vmask[:, :1]), vmask], 1)
        st = (eg[:, None, :, 1] <= py[..., None]) != \
            (eg[:, None, :, 3] <= py[..., None])
        st &= qmask[..., None]
        ax = eg[:, None, :, 0]
        xe = ax + (eg[:, None, :, 2] - ax)
        left = st & (px[..., None] < ax) & (px[..., None] < xe)
        right = st & ~left & (px[..., None] >= ax) & (px[..., None] >= xe)
        exact = st & ~left & ~right
        work["straddles"] += int(st.sum())
        work["straddles_not_left"] += int((st & ~left).sum())
        work["exact"] += int(exact.sum())
        inf = float("inf")
        cb = [torch.where(vmask, cv[..., i], v).amin(1) if v > 0 else
              torch.where(vmask, cv[..., i], v).amax(1)
              for i, v in ((0, inf), (1, inf), (0, -inf), (1, -inf))]
        ov = (cb[0][:, None] <= torch.maximum(eg[..., 0], eg[..., 2])) & \
            (torch.minimum(eg[..., 0], eg[..., 2]) <= cb[2][:, None]) & \
            (cb[1][:, None] <= torch.maximum(eg[..., 1], eg[..., 3])) & \
            (torch.minimum(eg[..., 1], eg[..., 3]) <= cb[3][:, None])
        dy_edges.append(eidx[real & (ov | exact.any(1))])
        work["overlap_sides"] += int((ov.sum(1) * n[s:e]).sum())
        ci, ei = torch.nonzero(ov, as_tuple=True)
        a = eg[ci, ei, None, 0:2]
        b = eg[ci, ei, None, 2:4]
        u, m = cv[ci], vmask[ci]
        nxt = torch.where(kk[None] + 1 >= n[s:e][ci, None], 0, kk[None] + 1)
        w = torch.gather(u, 1, nxt[..., None].expand(-1, -1, 2))
        z3 = (orient(u, w, a) == 0) & m
        z4 = (orient(u, w, b) == 0) & m
        work["zero_vertices"] += int(((orient(a, b, u) == 0) & m).sum())
        work["zero_sides"] += int(z3.sum() + z4.sum())
        zero_cell_sides.append(
            (pair_cell[s:e][ci, None] * K + kk[None])[z3 | z4])
    work["pair_edges"] = int(ne.sum())
    work["edges"] = int((edge_off[1:] - edge_off[:-1])[
        torch.unique(pair_geo)].sum())
    work["dy_edges"] = int(torch.unique(torch.cat(dy_edges)).numel())
    work["zero_cell_sides"] = int(
        torch.unique(torch.cat(zero_cell_sides)).numel())
    work["query_edges"] = int((ne * (n + 1)).sum())
    work["cell_vertices"] = int(counts[torch.unique(pair_cell)].sum())
    ops = K7_PER_EDGE * work["edges"] + \
        K7_PER_DY_EDGE * work["dy_edges"] + \
        K7_PER_PAIR_EDGE * work["pair_edges"] + \
        K7_PER_QUERY_EDGE * work["query_edges"] + \
        K7_PER_STRADDLE * work["straddles"] + \
        K7_PER_STRADDLE_RIGHT * work["straddles_not_left"] + \
        K7_PER_EXACT * work["exact"] + \
        (K7_PER_VERTEX + K7_PER_SIDE) * work["overlap_sides"] + \
        K7_PER_ZERO_VERTEX * work["zero_vertices"] + \
        K7_PER_ZERO_SIDE * work["zero_sides"] + \
        K7_PER_ZERO_CELL_SIDE * work["zero_cell_sides"] + \
        K7_PER_CELL_VERTEX * work["cell_vertices"]
    U = int(verts.shape[0])
    nbytes = 32 * E + 8 * int(edge_off.shape[0]) + \
        16 * P + (16 * K + 4 + 16) * U + 2 * P
    return ops, nbytes, dict(work)


def k8_work(args):
    """(f64 instructions, bytes, the plain version's output) of K8 on its
    inputs: the planes, subject vertices and crossings of this run's tasks
    (counted by running the plain version, whose half-plane step sees
    each), at the counts above; each input read once, the clipped rings
    and counts written once."""
    import torch
    from mosaic_tpu_torch.ops import tess_clip as tcl
    work = collections.Counter()
    halfplane = tcl._halfplane_ref

    def counted(subj, counts, p0, p1, active):
        out = halfplane(subj, counts, p0, p1, active)
        vidx = torch.arange(subj.shape[1], device=subj.device)
        valid = (vidx[None] < counts[:, None]) & active[:, None]
        work["planes"] += int(active.sum())
        work["vertices"] += int(valid.sum())
        # the new count is the inside vertices plus the crossings
        work["crossings"] += int((out[1] - counts)[active].sum()) + \
            _outside(subj, counts, p0, p1, active)
        return out

    tcl._halfplane_ref = counted
    try:
        xy, off, count = tcl.clip_tasks_ref(*args)
    finally:
        tcl._halfplane_ref = halfplane
    ring_xy, ring_off, task_ring, task_cell, verts, counts = args
    work["cell_sides"] = int(counts[torch.unique(task_cell)].sum())
    ops = K8_PER_CELL_SIDE * work["cell_sides"] + \
        K8_PER_VERTEX * work["vertices"] + \
        K8_PER_CROSSING * work["crossings"]
    T, U, K = int(task_ring.shape[0]), int(verts.shape[0]), \
        int(verts.shape[1])
    nbytes = 16 * int(ring_xy.shape[0]) + 8 * int(ring_off.shape[0]) + \
        16 * T + (16 * K + 4) * U + 16 * int(xy.shape[0]) + 4 * T
    return ops, nbytes, dict(work), (xy, off, count)


def _outside(subj, counts, p0, p1, active) -> int:
    """Subject vertices of the active rows outside the plane (d < 0), in
    the plain version's arithmetic."""
    import torch
    ev = p1 - p0
    d = ev[:, None, 0] * (subj[..., 1] - p0[:, None, 1]) - \
        ev[:, None, 1] * (subj[..., 0] - p0[:, None, 0])
    vidx = torch.arange(subj.shape[1], device=subj.device)
    valid = (vidx[None] < counts[:, None]) & active[:, None]
    return int(((d < 0) & valid).sum())


def same_clip(a, b) -> bool:
    """Two clip outputs (xy, off, count) with equal counts and, packed,
    bit-equal rings."""
    import torch
    from mosaic_tpu_torch.ops.tess_clip import compact
    if not torch.equal(a[2], b[2]):
        return False
    fa, fb = compact(*a)[0], compact(*b)[0]
    return fa.shape == fb.shape and torch.equal(fa.view(torch.int64),
                                                fb.view(torch.int64))


def k7_pick(args) -> int:
    """The lanes a pair that tess_classify picks for ``args``."""
    import torch
    from mosaic_tpu_torch.ops import tess_classify as tc
    edge_off, pair_geo = args[1], args[2]
    ne = (edge_off[1:] - edge_off[:-1])[pair_geo]
    return tc.lanes_for(int(ne.sum()), int(pair_geo.shape[0]),
                        torch.cuda.get_device_properties(
                            pair_geo.device).multi_processor_count)


def k8_picks(args) -> list:
    """The lanes a task of each launch of tess_clip's first round for
    ``args``, one launch for each of its capacity classes."""
    from mosaic_tpu_torch.ops import tess_clip as tcl
    ring_off, task_ring, K = args[1], args[2], int(args[4].shape[1])
    cap = (ring_off[1:] - ring_off[:-1])[task_ring] + K + 1
    return [tcl.lanes_for(int(cap[p].max()), K)
            for p in tcl.classes(cap, K)]


def with_long_rings(args, every: int, factor: int):
    """K8's inputs ``args`` with every ``every``-th task's ring replaced
    by a copy of it ``factor`` times as long (each edge cut into
    ``factor`` pieces): a call of mostly short rings and a few long
    ones."""
    import torch
    ring_xy, ring_off, task_ring, task_cell, verts, counts = args
    rings = task_ring[::every]
    lens = ring_off[rings + 1] - ring_off[rings]
    # vertex i of ring r: each long ring's vertices, then its pieces
    owner = torch.repeat_interleave(
        torch.arange(len(rings), device=ring_xy.device), lens)
    start = torch.repeat_interleave(ring_off[rings], lens)
    first = torch.cumsum(lens, 0) - lens
    i = torch.arange(len(owner), device=ring_xy.device) - \
        torch.repeat_interleave(first, lens)
    a = ring_xy[start + i]
    b = ring_xy[start + torch.where(i + 1 >= lens[owner], 0, i + 1)]
    t = torch.arange(factor, dtype=ring_xy.dtype,
                     device=ring_xy.device) / factor
    dense = (a[:, None] + t[None, :, None] * (b - a)[:, None]).reshape(-1, 2)
    long_off = ring_off[-1] + factor * torch.cat([first, lens.sum()[None]])
    task_ring = task_ring.clone()
    task_ring[::every] = len(ring_off) - 1 + torch.arange(
        len(rings), device=ring_xy.device)
    return [torch.cat([ring_xy, dense]),
            torch.cat([ring_off, long_off[1:]]), task_ring, task_cell,
            verts, counts]


def phase_chips():
    """BASELINE config 2, chip generation: conus_counties() at H3 res 5 on
    the card, counted and timed by stage; its ChipSet against the plain
    path, its candidate sets against the host's; K7 and K8 against their
    plain versions on the run's own inputs and the degenerate set, timed
    beside their bounds."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import (conus_counties,
                                                  tess_adversarial)
    from mosaic_tpu_torch.core import tessellate as tess
    from mosaic_tpu_torch.ops import cell as cell_op
    from mosaic_tpu_torch.ops import tess_classify as tc
    from mosaic_tpu_torch.ops import tess_clip as tcl

    counties = conus_counties()
    grid = mt.get_index_system("H3")
    t0 = time.perf_counter()
    mt.tessellate(counties.take(list(range(COUNTY_WARM))), COUNTY_RES, grid,
                  keep_core_geom=False, device=DEV)
    t_warm = time.perf_counter() - t0

    # ---- the main path, counted: counts to 0, drive, read; the stages
    # timed, the plain versions watched, the kernels' inputs kept
    plain_fns = [(tc, "classify_pairs_ref"), (tcl, "clip_tasks_ref"),
                 (cell_op, "latlng_to_cell_margin_ref")]
    with LastArgs([(tess, "tess_classify"), (tess, "tess_clip")]) as kept, \
            StepClock(tess_stage_targets() + plain_fns) as clock:
        reset_counts()
        t0 = time.perf_counter()
        chips = mt.tessellate(counties, COUNTY_RES, grid,
                              keep_core_geom=False, device=DEV)
        t_run = time.perf_counter() - t0
        counts = launch_counts()
        stages = clock.take()
    plain_ran = sorted(n for _, n in plain_fns if n in stages)
    stages["assembly"] = round(t_run - sum(stages.values()), 4)
    log(f"[chips] {len(counties)} counties at H3 res {COUNTY_RES} -> "
        f"{len(chips)} chips ({int(chips.is_core.sum())} core) in "
        f"{t_run:.3f} s on the card (warm-up on {COUNTY_WARM} counties "
        f"{t_warm:.2f} s); by stage {stages}; counts {counts}")
    check(len(chips) == COUNTY_CHIPS, f"{len(chips)} chips, not "
          f"{COUNTY_CHIPS}")
    check(counts["tess_classify"] >= 1 and counts["tess_clip"] >= 1 and
          counts["h3_latlng_to_cell"] >= 1, "a kernel of the chip path "
          f"never launched: {counts}")
    check(not plain_ran, f"plain versions ran on the card's path: "
          f"{plain_ran}")

    # ---- the ChipSet against the plain path, the candidates against the
    # host's exact sets
    t0 = time.perf_counter()
    plain = mt.tessellate(counties, COUNTY_RES, grid, keep_core_geom=False,
                          device="cpu")
    t_plain = time.perf_counter() - t0
    diff = chipset_diff(chips, plain)
    log(f"[chips] the plain path (the kernels' plain versions on the CPU) "
        f"in {t_plain:.2f} s: {len(plain)} chips; differing fields {diff}")
    check(not diff, f"chip generation differs from the plain path: {diff}")
    bboxes = counties.bboxes()
    t0 = time.perf_counter()
    host = grid.candidate_cells_batch(bboxes, COUNTY_RES)
    t_host = time.perf_counter() - t0
    on_card = grid.candidate_cells_batch(bboxes, COUNTY_RES, device=DEV)
    bad = sum(not np.array_equal(a, b) for a, b in zip(host, on_card))
    log(f"[chips] candidate sets: {bad} of {len(host)} differ from the "
        f"host's exact sets ({t_host:.2f} s on the host); "
        f"{counts['sample_host_points']} of {counts['sample_points']} "
        f"sampling points sent to the host")
    check(bad == 0, f"{bad} candidate sets differ from the host's")

    # ---- K7 and K8 against their plain versions, at the lanes their
    # wrappers pick, on four input sets: the county run's, the degenerate
    # set, the flagship's index build (phase 5) and the overlay's
    # footprints (phase 11); K7 also on prefixes of the county run's
    # pairs and K8 on its tasks with a few long rings, so that the picks
    # cover every width of both kernels
    TESS_PATHS["chip generation"] = {"counts": counts,
                                     "k7": kept.args["tess_classify"],
                                     "k8": kept.args["tess_clip"]}
    adv = tess_adversarial(grid)
    sets = {"county": TESS_PATHS["chip generation"],
            "degenerate": {
                "k7": [torch.from_numpy(np.ascontiguousarray(adv[k])).to(DEV)
                       for k in ("edges", "edge_off", "pair_geo",
                                 "pair_cell", "cell_verts", "cell_counts",
                                 "centers")],
                "k8": [torch.from_numpy(np.ascontiguousarray(adv[k])).to(DEV)
                       for k in ("ring_xy", "ring_off", "task_ring",
                                 "task_cell", "cell_verts", "cell_counts")]},
            "zones": TESS_PATHS["flagship index build"],
            "footprints": TESS_PATHS["overlay footprint tessellation"]}
    for path, kept_path in TESS_PATHS.items():
        c = kept_path["counts"]
        first = len(k8_picks(kept_path["k8"]))
        check(c["tess_classify"] == 1 and
              c["tess_clip"] == first + c["tess_clip_relaunches"],
              f"{path}: K7 launched {c['tess_classify']} "
              f"and K8 {c['tess_clip']} times ({c['tess_clip_relaunches']} "
              f"relaunches), not 1 and {first} plus the relaunches")
    k7_sets = {label: v["k7"] for label, v in sets.items()}
    k8_sets = {label: v["k8"] for label, v in sets.items()}
    county7 = k7_sets["county"]
    P = int(county7[2].shape[0])
    picked = {k7_pick(a) for a in k7_sets.values()}
    for h in range(1, 12):
        a7 = [*county7[:2], county7[2][:P >> h], county7[3][:P >> h],
              *county7[4:]]
        if k7_pick(a7) not in picked:
            picked.add(k7_pick(a7))
            k7_sets[f"county prefix {P >> h}"] = a7
    k8_sets["county, long rings"] = with_long_rings(k8_sets["county"],
                                                    LONG_EVERY, LONG_FACTOR)
    picks = {"k7": {label: k7_pick(a) for label, a in k7_sets.items()},
             "k8": {label: k8_picks(a) for label, a in k8_sets.items()}}
    log(f"[chips] the wrappers' lanes by input set (K8: those of its first "
        f"round's launches) {picks}")
    check(set(picks["k7"].values()) == set(tc.LANES) and
          {w for ws in picks["k8"].values() for w in ws} == set(tcl.LANES),
          f"the input sets do not reach every width of K7 {tc.LANES} and "
          f"K8 {tcl.LANES}: {picks}")
    for label, a7 in k7_sets.items():
        flags = [int((g != w).sum()) for g, w in
                 zip(tc.tess_classify(*a7), tc.classify_pairs_ref(*a7))]
        log(f"[chips] K7 on the {label} set ({int(a7[2].shape[0])} pairs, "
            f"{picks['k7'][label]} lanes a pair): touching and core differ "
            f"from the plain version at {flags}")
        check(flags == [0, 0], f"K7 differs from plain on the {label} set: "
              f"{flags}")
    for label, a8 in k8_sets.items():
        before = tcl.tess_clip.relaunches
        ok = same_clip(tcl.tess_clip(*a8), tcl.clip_tasks_ref(*a8))
        relaunch = tcl.tess_clip.relaunches - before
        log(f"[chips] K8 on the {label} set ({int(a8[2].shape[0])} tasks, "
            f"{picks['k8'][label]} lanes a task, {relaunch} relaunches): "
            f"bit-equal to the plain version {ok}")
        check(ok, f"K8 differs from plain on the {label} set")
        if label == "degenerate":
            check(relaunch >= 1, "the degenerate set's concave rings did "
                  "not overflow K8's convex capacity")

    # ---- K7 and K8 timed beside their bounds and plain versions, by
    # input set
    rows = {"tess_classify": {"shapes": {}}, "tess_clip": {"shapes": {}}}
    timed = [("tess_classify", tc, label, sets[label]["k7"], k7_work,
              tc.classify_pairs_ref, "classify_kernel") for label in sets]
    # K8 but on the degenerate set, whose relaunches sit inside the call
    timed += [("tess_clip", tcl, label, a8, lambda a: k8_work(a)[:3],
               tcl.clip_tasks_ref, "clip_kernel")
              for label, a8 in k8_sets.items() if label != "degenerate"]
    for name, mod, label, args, work_of, ref, kname in timed:
        ops, nbytes, work = work_of(args)
        wrapper = getattr(mod, name)
        lanes = picks["k7" if name == "tess_classify" else "k8"][label]
        k = timed_kernel(f"chips {name} {label}",
                         lambda a=args, f=wrapper: f(*a),
                         lambda a=args, f=ref: f(*a), kname, 2,
                         len(lanes) if isinstance(lanes, list) else 1)
        ops_ms = ops / PEAK_F64_OPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        bound = max(ops_ms, bytes_ms)
        rows[name]["shapes"][label] = {
            "ms": k[0], "ms_source": k[1], "events_ms": k[2],
            "host_ms": k[3], "plain_ms": k[4], "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share": bound / k[0], "lanes": lanes, "work": work}
        log(f"[chips] {name} on the {label} set, {lanes} lanes: "
            f"{k[0]:.4f} ms, bound {bound:.4f} ms (f64 instructions "
            f"{ops_ms:.4f}: {ops}, from {work}; bytes {bytes_ms:.4f}: "
            f"{nbytes}), roofline share {bound / k[0]:.4f}")
    for name in rows:
        # the kernels line reads the county run's
        rows[name].update({**rows[name]["shapes"]["county"],
                           "max_abs_err": 0.0})
    return {"counts": counts, "chips": len(chips),
            "core": int(chips.is_core.sum()), "s": t_run, "warm_s": t_warm,
            "stages_s": stages, "plain_s": t_plain,
            "host_candidates_s": t_host, "k7": rows["tess_classify"],
            "k8": rows["tess_clip"],
            "tess_counts": {p: v["counts"] for p, v in TESS_PATHS.items()}}


class RoutedGrid:
    """A grid whose ``point_to_cell_device`` (the refined join's route)
    keeps what it routed while ``keep`` is set, and times every call."""

    def __init__(self, grid):
        self.grid = grid
        self.keep = False
        self.routed = []
        self.ms = []

    def __getattr__(self, name):
        return getattr(self.grid, name)

    def point_to_cell_device(self, xy, res, device):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cells, host = self.grid.point_to_cell_device(xy, res, device)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if self.keep:
            self.routed.append((xy, res, cells))
        return cells, host


def refine_workload():
    """bench.py:936-950: 48 seven-vertex rings of radius 0.004 around
    centres uniform in +-0.1, and REFINE_N points, three quarters
    uniform in +-0.12 and the rest in +-2.0 (default_rng(1292))."""
    import numpy as np
    import mosaic_tpu_torch as mt
    rng = np.random.default_rng(1292)
    b = mt.GeometryBuilder()
    for cx, cy in rng.uniform(-0.1, 0.1, size=(48, 2)):
        ang = np.linspace(0.0, 2.0 * np.pi, 8)[:-1]
        b.add_polygon(np.stack([cx + 0.004 * np.cos(ang),
                                cy + 0.004 * np.sin(ang)], 1), [])
    hot = REFINE_N * 3 // 4
    pts = np.concatenate([rng.uniform(-0.12, 0.12, size=(hot, 2)),
                          rng.uniform(-2.0, 2.0, size=(REFINE_N - hot, 2))])
    return b.finish(), pts


def phase_strategies(idx, grid, polys, batches, dense_zones):
    """The single-device join strategies at the bench's sizes: the
    planner sweep over the flagship's dense index (calibrate, then
    planned against streamed), the flagship's batches through the
    planned join, and the refined-vs-flat A/B on the skewed cluster."""
    import numpy as np
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch import config
    from mosaic_tpu_torch.parallel.pip_join import _overlap_frac
    from mosaic_tpu_torch.sql.planner import planner

    def set_conf(key, val):
        config.set_default_config(config.apply_conf(
            config.default_config(), key, val))

    def k2_for(d, n):
        chunk = getattr(d, "chunk", planner.chunk_rows())
        return 1 if d.strategy == "monolithic" else -(-n // chunk)

    def label(d):
        return {"strategy": d.strategy, "reason": d.reason,
                "chunk": getattr(d, "chunk", None), "forced": d.forced}

    def parts_ms(parts, walls):
        # median host ms of each part of the planned runs, and of what
        # lies outside them (the call's own entry and exit)
        out = {k: float(np.median([p[k] for p in parts])) * 1e3
               for k in parts[0]}
        out["outside"] = float(np.median(
            [w - sum(p.values()) for p, w in zip(parts, walls)])) * 1e3
        return out

    def sketch_forms(pts):
        # the planned join's bbox sketch alone, four strided column
        # reductions and the JAX package's axis-0 reductions over the
        # same [N, 2] view, median host ms of 3
        bb = polys.bboxes()
        ext = (float(np.nanmin(bb[:, 0])), float(np.nanmin(bb[:, 1])),
               float(np.nanmax(bb[:, 2])), float(np.nanmax(bb[:, 3])))
        view = np.asarray(pts, np.float64)[:, :2]
        out = {}
        for name, f in (("port", lambda: _overlap_frac(view, ext)),
                        ("columns", lambda: (
                            view[:, 0].min(), view[:, 1].min(),
                            view[:, 0].max(), view[:, 1].max())),
                        ("axis0", lambda: (view.min(axis=0),
                                           view.max(axis=0)))):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                f()
                ts.append(time.perf_counter() - t0)
            out[name] = float(np.median(ts)) * 1e3
        return out

    t_phase = time.perf_counter()
    prev = config.default_config()
    planner.reset()
    set_conf("mosaic.stream.chunk.rows", str(CHUNK))
    try:
        # ---- the planner sweep (bench.py:760-800)
        pjoin = mt.make_planned_pip_join(idx, grid, polys=polys)
        off = mt.make_streamed_pip_join(idx, grid, polys, chunk=CHUNK,
                                        device=DEV)
        sweep = []
        for n in STRAT_SIZES:
            pts = mt.nyc_points(n, seed=500 + n % 97)
            cands = planner.pip_join_candidates(n)
            reset_counts()
            try:
                z_cal = pjoin.calibrate(pts)
            except AssertionError as e:
                raise PhaseError(f"planner sweep at {n}: {e}") from None
            cal_k2 = launch_counts()["h3_dense_join"]
            want = 2 * sum(1 if s == "monolithic" else -(-n // c)
                           for s, c in cands)
            check(cal_k2 == want, f"calibrate at {n} launched K2 {cal_k2} "
                  f"times for {want}")
            off(pts)                     # warm the streamed path
            on_s, off_s, k2_on, parts_on = [], [], [], []
            for rep in range(STRAT_REPS):
                # the pair's order alternates: planned first on even reps
                for which in (("on", "off") if rep % 2 == 0 else
                              ("off", "on")):
                    if which == "on":
                        reset_counts()
                        t0 = time.perf_counter()
                        z_on, _ = pjoin(pts)
                        on_s.append(time.perf_counter() - t0)
                        k2_on.append(launch_counts()["h3_dense_join"])
                        parts_on.append(pjoin.last_times)
                    else:
                        t0 = time.perf_counter()
                        z_off, _ = off(pts)
                        off_s.append(time.perf_counter() - t0)
            d = pjoin.last_decision
            bad = int(np.sum(z_on != z_off)) + int(np.sum(z_cal != z_on))
            check(bad == 0, f"planner sweep at {n}: {bad} zones differ "
                  "between planned, calibrated and streamed")
            check(k2_on[-1] == k2_for(d, n), f"the planned run at {n} "
                  f"launched K2 {k2_on[-1]} times for {d.strategy}")
            sample = min(n, ORACLE_SAMPLE)
            truth = mt.pip_host_truth(pts[:sample], polys)
            check(np.array_equal(truth, z_on[:sample]), f"planner sweep at "
                  f"{n}: zones differ from pip_host_truth")
            sketch = sketch_forms(pts)
            row = {"n": n, "candidates": [list(c) for c in cands],
                   "decision": label(d), "k2_calibrate": cal_k2,
                   "k2_planned": k2_on, "planned_s": on_s,
                   "streamed_s": off_s,
                   "planned_ms": float(np.median(on_s)) * 1e3,
                   "streamed_ms": float(np.median(off_s)) * 1e3,
                   "planned_parts_ms": parts_ms(parts_on, on_s),
                   "sketch_ms": sketch, "mismatches": bad}
            sweep.append(row)
            log(f"[strategies] sweep n={n}: candidates {cands}, calibrate "
                f"launched K2 {cal_k2} times; planned {row['planned_ms']:.3f}"
                f" ms (median of {on_s}) vs streamed "
                f"{row['streamed_ms']:.3f} ms ({off_s}), host clock, the "
                f"pair's order alternating (planned first on reps 0, 2); "
                f"planned run's parts, median ms "
                f"{row['planned_parts_ms']}; bbox sketch alone, median ms "
                f"{sketch}; decision {label(d)}, K2 per planned run "
                f"{k2_on}; 0 zone mismatches, {sample} held to the oracle")

        # ---- the flagship's batches through the planned join, each
        # beside the streamed join (uncounted), the pair's order
        # alternating; counts summed over the planned calls alone
        planned_counts = None
        decisions, t_batch, t_off, parts_fl, k2_want = [], [], [], [], 0
        for i, (pts, dense) in enumerate(zip(batches, dense_zones)):
            for which in (("on", "off") if i % 2 == 0 else ("off", "on")):
                if which == "off":
                    t0 = time.perf_counter()
                    off(pts)
                    t_off.append(time.perf_counter() - t0)
                    continue
                reset_counts()
                t0 = time.perf_counter()
                zone, _ = pjoin(pts)
                t_batch.append(time.perf_counter() - t0)
                c = launch_counts()
                planned_counts = c if planned_counts is None else {
                    k: planned_counts[k] + c[k] for k in c}
                parts_fl.append(pjoin.last_times)
            d = pjoin.last_decision
            decisions.append(label(d))
            k2_want += k2_for(d, len(pts))
            diff = int(np.sum(zone != dense))
            check(diff == 0, f"planned flagship: {diff} zones differ from "
                  "the dense streamed join")
        sketch_fl = sketch_forms(batches[0])
        check(planned_counts["h3_dense_join"] == k2_want, f"the planned "
              f"flagship launched K2 {planned_counts['h3_dense_join']} "
              f"times for {k2_want}")
        check(planned_counts["h3_latlng_to_cell"] == 0 and
              planned_counts["h3_project_lattice"] == 0,
              "the planned flagship launched K1 or K3")
        log(f"[strategies] planned flagship: {len(batches)} x {BATCH} "
            f"points equal to phase 5's dense zones; per batch {t_batch} s, "
            f"the streamed join beside it {t_off} s (host clock, planned "
            f"first on batches 0 and 2); planned run's parts, median ms "
            f"{parts_ms(parts_fl, t_batch)}; bbox sketch alone on batch 0, "
            f"median ms {sketch_fl}; decisions {decisions}; counts "
            f"{planned_counts}")

        # ---- the refined A/B (bench.py:922-993)
        rpolys, rpts = refine_workload()
        rgrid = RoutedGrid(mt.get_index_system("H3"))
        set_conf("mosaic.planner.force.refine", "refined")
        reset_counts()
        t0 = time.perf_counter()
        rjoin = mt.make_refined_pip_join(rpolys, rgrid, REFINE_RES,
                                         chunk=CHUNK, device=DEV)
        t_build = time.perf_counter() - t0
        build_counts = launch_counts()
        reset_counts()
        rgrid.keep = True
        t0 = time.perf_counter()
        z_cold, _ = rjoin(rpts)           # probe, deeper level, builds
        t_cold = time.perf_counter() - t0
        rgrid.keep = False
        parts = [dict(rjoin.counts)]
        stats = dict(rjoin.stats)
        ref_s, z_ref = [], None
        for _ in range(REFINE_REPS):
            t0 = time.perf_counter()
            z_ref, _ = rjoin(rpts)
            ref_s.append(time.perf_counter() - t0)
            parts.append(dict(rjoin.counts))
        refined_counts = launch_counts()
        # the first route is the probe's (its sample rows), the rest one
        # a chunk
        route_ms = list(rgrid.ms)
        d_ref = label(rjoin.last_decision)
        k3_parts = {p: sum(c[p] for c in parts)
                    for p in ("route", "base", "refined")}
        check(refined_counts["sample_points"] == 0, "the refined level's "
              "sampling went through K3; its launches are not apart")
        check(refined_counts["h3_latlng_to_cell"] == sum(k3_parts.values()),
              f"the refined runs launched K3 "
              f"{refined_counts['h3_latlng_to_cell']} times for the parts' "
              f"{k3_parts}")
        check(stats["levels"] == [REFINE_RES, REFINE_RES + 1] and
              stats["refined_points"] > 0 and
              rjoin.stats["strategy"] == "refined",
              f"the refined pin ran {stats}")
        routed = sum(len(xy) for xy, _, _ in rgrid.routed)
        route_bad = sum(int(np.sum(c != rgrid.grid.point_to_cell(xy, r)))
                        for xy, r, c in rgrid.routed)
        check(routed >= REFINE_N and route_bad == 0, f"{route_bad} of "
              f"{routed} routed ids differ from the host point_to_cell")

        set_conf("mosaic.planner.force.refine", "flat")
        reset_counts()
        rjoin(rpts)                       # warm the flat path
        flat_s, z_flat = [], None
        for _ in range(REFINE_REPS):
            t0 = time.perf_counter()
            z_flat, _ = rjoin(rpts)
            flat_s.append(time.perf_counter() - t0)
        flat_counts = launch_counts()
        check(rjoin.stats["strategy"] == "flat", "the flat pin ran "
              f"{rjoin.stats}")
        chunks = -(-REFINE_N // CHUNK)
        check(flat_counts["h3_latlng_to_cell"] == chunks * (REFINE_REPS + 1),
              f"the flat runs launched K3 {flat_counts['h3_latlng_to_cell']}"
              f" times for {chunks * (REFINE_REPS + 1)} chunks")
        set_conf("mosaic.planner.force.refine", "auto")
        z_auto, _ = rjoin(rpts)
        d_auto = label(rjoin.last_decision)
        truth = mt.pip_host_truth(rpts, rpolys)
        mism = {k: int(np.sum(z != truth)) for k, z in (
            ("cold", z_cold), ("refined", z_ref), ("flat", z_flat),
            ("auto", z_auto))}
        check(sum(mism.values()) == 0, f"refine A/B zones differ from "
              f"pip_host_truth: {mism}")
        refine = {
            "n": REFINE_N, "base_res": REFINE_RES, "build_s": t_build,
            "cold_s": t_cold, "refined_s": ref_s, "flat_s": flat_s,
            "refined_ms": float(np.median(ref_s)) * 1e3,
            "flat_ms": float(np.median(flat_s)) * 1e3, "stats": stats,
            "decision_refined": d_ref, "decision_auto": d_auto,
            "k3_by_part": k3_parts, "parts_by_run": parts,
            "route_ms": route_ms,
            "route_ms_per_chunk": float(np.median(route_ms[1:])),
            "route_host_points": parts[0]["route_host_points"],
            "route_points": parts[0]["route_points"],
            "mismatches": mism, "build_counts": build_counts}
        log(f"[strategies] refine A/B: build {t_build:.3f} s (counts "
            f"{build_counts}); cold refined run {t_cold:.3f} s; refined "
            f"{refine['refined_ms']:.3f} ms (median of {ref_s}) vs flat "
            f"{refine['flat_ms']:.3f} ms ({flat_s}), host clock; stats "
            f"{stats}; K3 by part over the cold and timed runs {k3_parts}; "
            f"route {parts[0]['route_points']} points in the cold run, "
            f"{parts[0]['route_host_points']} re-assigned on the host, "
            f"route ms per call {[round(t, 3) for t in route_ms]} (the "
            f"probe's first), per chunk {refine['route_ms_per_chunk']:.3f}; "
            f"decisions: pinned {d_ref}, auto {d_auto}; 0 mismatches "
            f"against pip_host_truth on all {REFINE_N} points, {routed} "
            f"routed ids equal to the host's")
    finally:
        config.set_default_config(prev)
        planner.reset()
    t_phase = time.perf_counter() - t_phase
    log(f"[strategies] the phase took {t_phase:.1f} s")
    return {"sweep": sweep, "planned_flagship": {
                "s": t_batch, "streamed_s": t_off, "decisions": decisions,
                "parts_ms": parts_ms(parts_fl, t_batch),
                "parts_by_batch": parts_fl, "sketch_ms": sketch_fl},
            "refine": refine, "phase_s": t_phase,
            "paths": {"planned flagship": planned_counts,
                      "refine A/B refined": {
                          k: build_counts[k] + refined_counts[k]
                          for k in refined_counts},
                      "refine A/B flat": flat_counts}}


#: BASELINE config 5 as bench.py:1444-1456 runs it: a 1000x800 synthetic
#: DEM (srid 4326) to H3 res-8 cells, combiner avg, after a 64x64 warm-up
DEM_GT = (-74.25, 0.0005, 0.0, 40.92, 0.0, -0.0005)
DEM_SHAPE = (800, 1000)
R2G_RES = 8
R2G_CELLS = 2645
#: an SRTM 1-arc-second tile: 3601 x 3601 pixels of 1/3600 degree, pixel
#: centres on whole degrees from (-75, 41); bench.py's DEM formula scaled
#: to it and a seeded NaN block of SRTM_HOLE^2 pixels (1.0%); cut into 4
#: phase-aligned quarter tiles that overlap by SRTM_OVERLAP pixels
SRTM_N = 3601
SRTM_HOLE = 360
SRTM_OVERLAP = 64
SRTM_SEED = 3601
#: pixels of the SRTM run held against the host ids, and the corner held
#: bit-equal to the CPU path
SRTM_SAMPLE = 1 << 20
SRTM_CORNER = 1024
#: K9's weight arrays on the SRTM tile (f64, through rops.convolve) and
#: on the DEM and the SRTM tile (f32, through sharded_convolve: the halo
#: form, odd sides only)
K9_SHAPES = ((3, 3), (5, 5), (4, 4), (7, 7))
K9_HALO_SHAPE = (3, 3)
K9_SEED = 9
#: K9's edge set, untimed: rasters smaller than a 5 x 5 stencil, a
#: multi-band raster whose sides are no multiple of any tile, stencils of
#: one row and one column, one only a runtime-size instance takes, and
#: one too large for the large tile's shared memory
K9_SMALL_RASTERS = ((1, 1, 1), (1, 3, 1), (1, 5, 7))
K9_BANDS = (3, 517, 1029)
K9_EDGE_STENCILS = ((5, 5), (3, 3), (1, 9), (9, 1), (11, 11))
K9_WIDE_RASTER = (1, 300, 400)
#: ndvi on a two-band SRTM-sized stack: the tile as RED, a seeded NIR
NDVI_SEED = 304


def srtm_tile():
    """The SRTM-sized tile: bench.py's sin/ramp DEM scaled from 1000 x
    800 to SRTM_N pixels a side, NaN over a seeded SRTM_HOLE block."""
    import numpy as np
    import mosaic_tpu_torch as mt
    n, px = SRTM_N, 1.0 / 3600
    yy, xx = np.mgrid[0:n, 0:n]
    data = np.sin(xx / (60.0 * n / 1000)) * 50 + yy * (0.1 * 800 / n)
    r0, c0 = np.random.default_rng(SRTM_SEED).integers(0, n - SRTM_HOLE, 2)
    data[r0:r0 + SRTM_HOLE, c0:c0 + SRTM_HOLE] = np.nan
    gt = mt.GeoTransform(-75.0 - px / 2, px, 0.0, 41.0 + px / 2, 0.0, -px)
    return mt.RasterTile(data[None], gt, srid=4326)


def quarter_tiles(tile, overlap: int = SRTM_OVERLAP):
    """4 windows of ``tile``, cut at its middle row and column and
    widened by ``overlap`` / 2 pixels past the cut (phase-aligned, so
    ``combine`` pastes them back on the tile's grid)."""
    half, h2 = tile.height // 2, overlap // 2
    wh, ww = tile.width // 2, overlap // 2
    rows = ((0, half + h2), (half - h2, tile.height - (half - h2)))
    cols = ((0, wh + ww), (wh - ww, tile.width - (wh - ww)))
    return [tile.window(c0, r0, w, h) for r0, h in rows for c0, w in cols]


def raster_stage_targets():
    """The stage functions of ``raster_to_grid`` a StepClock times: the
    pixel centres, the grid's device route, K3 (synchronized) and the
    host re-assignment inside it; the grouping; ``tessellate_raster``
    (whose rest is the per-cell window loop); the combine; the reduce."""
    from mosaic_tpu_torch.core.index.h3.system import H3IndexSystem
    from mosaic_tpu_torch.core.raster import rops
    from mosaic_tpu_torch.io import raster_grid
    return [(rops, "_pixel_points"), (H3IndexSystem, "point_to_cell_device"),
            (H3IndexSystem, "point_to_cell_torch_margin"),
            (H3IndexSystem, "point_to_cell"), (rops, "_ownership"),
            (rops, "_group_by_cell"), (rops, "tessellate_raster"),
            (rops, "combine"), (raster_grid, "_reduce_cell")]


def raster_stages(s: dict, total: float) -> dict:
    """Host seconds by stage from a StepClock's take: the ownership pass
    (centres and nudge; the route's f32 copy, upload and copy back; K3;
    the host re-assignment), the grouping, the per-cell window and mask
    loop, the combine, the per-cell reduce and the rest."""
    g = collections.defaultdict(float, s)
    route = g["point_to_cell_device"] - g["point_to_cell_torch_margin"] - \
        g["point_to_cell"]
    windows = g["tessellate_raster"] - g["_ownership"] - g["_group_by_cell"]
    out = {"ownership": g["_ownership"], "centres": g["_pixel_points"],
           "route_copies": route, "k3": g["point_to_cell_torch_margin"],
           "host_reassign": g["point_to_cell"],
           "grouping": g["_group_by_cell"], "windows": windows,
           "combine": g["combine"], "reduce": g["_reduce_cell"],
           "rest": total - g["tessellate_raster"] - g["combine"] -
           g["_reduce_cell"]}
    return {k: round(v, 4) for k, v in out.items()}


def same_values(a, b) -> bool:
    """Two {cell: value} dicts equal in keys, order and value bits."""
    import numpy as np
    return list(a) == list(b) and np.array_equal(
        np.asarray(list(a.values()), np.float64).view(np.int64),
        np.asarray(list(b.values()), np.float64).view(np.int64))


def same_bits(a, b) -> bool:
    """Two tensors with NaN at the same places and equal bits elsewhere
    (a NaN's payload is not compared)."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ia = a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)
    ib = b.view(ia.dtype)
    return bool(torch.equal(ia[~na], ib[~nb]))


class KeepOwnership:
    """Keeps (tile, ownership, pixels the host re-assigned) of every
    ``rops._ownership`` call while the block runs."""

    def __enter__(self):
        from mosaic_tpu_torch.core.raster import rops
        self.kept, self.fn = [], rops._ownership

        def keep(tile, res, grid, device):
            own, host = self.fn(tile, res, grid, device)
            self.kept.append((tile, own, host))
            return own, host
        rops._ownership = keep
        return self

    @property
    def host_points(self) -> int:
        return sum(host for *_, host in self.kept)

    def __exit__(self, *exc):
        from mosaic_tpu_torch.core.raster import rops
        rops._ownership = self.fn


class KeepLargestStack:
    """Keeps the largest stack ``rops.combine`` hands K10's wrapper while
    the block runs."""

    def __enter__(self):
        from mosaic_tpu_torch.core.raster import rops
        self.stack, self.fn = None, rops.raster_combine

        def keep(stack, reducer="avg"):
            if self.stack is None or stack.numel() > self.stack.numel():
                self.stack = stack
            return self.fn(stack, reducer)
        rops.raster_combine = keep
        return self

    def __exit__(self, *exc):
        from mosaic_tpu_torch.core.raster import rops
        rops.raster_combine = self.fn


def raster_run(label: str, tiles, grid, combiner: str = "avg",
               profiled: bool = False):
    """(cells, seconds, stages, counts, kept ownership) of one
    ``raster_to_grid`` call on the card, counts set to 0 just before and
    read just after; ``profiled`` adds the device's busy seconds (its
    kernels and copies in a ``torch.profiler`` trace) and idle share to
    the stages."""
    import contextlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.core.raster import rops
    trace = profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) if profiled \
        else contextlib.nullcontext()
    with KeepOwnership() as own, \
            StepClock(raster_stage_targets(),
                      sync=("point_to_cell_torch_margin",)) as clock, \
            trace as prof:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cells = mt.raster_to_grid(tiles, R2G_RES, grid, combiner=combiner,
                                  device=DEV)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        stages = raster_stages(clock.take(), seconds)
    if profiled:
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e6
        stages.update(device_busy=round(busy, 4),
                      device_idle=round(1.0 - busy / seconds, 6))
    calls = len(own.kept)
    check(calls == len(tiles) and counts["h3_latlng_to_cell"] == calls,
          f"{label}: {counts['h3_latlng_to_cell']} K3 launches for {calls} "
          f"tessellate_raster calls of {len(tiles)} tiles")
    counts["host_points"] = own.host_points
    log(f"[raster] {label}: {len(cells)} cells in {seconds:.3f} s (host "
        f"clock), {sum(t.height * t.width for t in tiles)} pixels in "
        f"{len(tiles)} tiles; K3 {counts['h3_latlng_to_cell']} (one per "
        f"tessellate_raster call), K10 {counts['raster_combine']}; "
        f"{own.host_points} pixel centres re-assigned on the host; stages "
        f"(s) {stages}")
    return cells, seconds, stages, counts, own.kept


def check_ownership(label: str, kept, grid):
    """Every kept pixel's card-assigned cell against the host
    ``point_to_cell`` on a seeded SRTM_SAMPLE-pixel sample and on every
    pixel whose K3 margin sent it to the host; returns (sampled, low)."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.core.index.base import DEVICE_MARGIN_BAND
    from mosaic_tpu_torch.core.raster import rops
    sizes = [own.size for _, own, _ in kept]
    pick = np.sort(np.random.default_rng(SRTM_SEED).choice(
        sum(sizes), min(SRTM_SAMPLE, sum(sizes)), replace=False))
    starts = np.cumsum([0] + sizes)
    low_total = 0
    for i, (tile, own, _) in enumerate(kept):
        pts = rops._pixel_points(tile)
        flat = own.ravel()
        mine = pick[(pick >= starts[i]) & (pick < starts[i + 1])] - starts[i]
        bad = int(np.sum(grid.point_to_cell(pts[mine], R2G_RES) !=
                         flat[mine]))
        check(bad == 0, f"{label}: {bad} of {len(mine)} sampled pixels of "
              f"tile {i} differ from the host's cells")
        _, margin = grid.point_to_cell_torch_margin(
            torch.from_numpy(pts.astype(np.float32)).to(DEV), R2G_RES)
        low = np.nonzero(margin.cpu().numpy() < DEVICE_MARGIN_BAND)[0]
        bad = int(np.sum(grid.point_to_cell(pts[low], R2G_RES) != flat[low]))
        check(bad == 0, f"{label}: {bad} of {len(low)} re-assigned pixels "
              f"of tile {i} differ from the host's cells")
        low_total += len(low)
    log(f"[raster] {label}: {len(pick)} sampled pixels and all {low_total} "
        "re-assigned pixels equal to the host's point_to_cell")
    return len(pick), low_total


#: instructions of one tap: a rounded multiply and a rounded add (an FMA
#: would change the bits, so K9 and its plain version never fuse them)
K9_TAP_OPS = 2


def conv_bound(x, w):
    """(bound ms, by) of K9 on ``x`` with weights ``w``: the raster read
    and written once and the weights read, at HBM3's rate; a multiply and
    an add a tap and pixel, each an instruction at the FP64 rate
    (PEAK_F64_OPS) or the FP32 rate (PEAK_F32_FLOPS / 2)."""
    taps, pixels, item = w.numel(), x.numel(), x.element_size()
    bytes_ms = (2 * pixels + taps) * item / PEAK_BYTES * 1e3
    rate = PEAK_F64_OPS if item == 8 else PEAK_F32_FLOPS / 2
    ops_ms = K9_TAP_OPS * taps * pixels / rate * 1e3
    return max(bytes_ms, ops_ms), ("operations" if ops_ms > bytes_ms
                                   else "bytes")


def k9_edge_set() -> int:
    """K9's wrapper on the card against ``convolve_ref`` on the edge set,
    untimed, in f64 and f32: rasters smaller than the 5 x 5 stencil, a
    multi-band raster under several stencils (one row, one column, one
    only a runtime-size instance takes), a stencil that takes the small
    tile, and weights with a -0.0 tap, an infinite tap (w * 0 outside the
    tile is NaN, never skipped) and zeros of both signs in the raster.
    Returns the number of cases, each bit-equal, with one launch each."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.ops import raster_convolve as rc
    rng = np.random.default_rng(K9_SEED + 1)

    def raster(shape):
        x = rng.normal(0, 100, shape)
        u = rng.random(shape)
        x[u < 0.1] = 0.0
        x[(u >= 0.1) & (u < 0.2)] = -0.0
        return x

    def small_tile_side(item):
        # the smallest square stencil past the fixed sizes that the large
        # tile cannot hold
        return next(k for k in range(8, 512) if rc.pick_instance(k, k, item)
                    != rc.pick_instance(11, 11, item))

    cases = [(shape, (5, 5), "") for shape in K9_SMALL_RASTERS]
    cases += [(K9_BANDS, k, "") for k in K9_EDGE_STENCILS]
    cases += [(K9_BANDS, (5, 5), "-0.0 tap"), (K9_BANDS, (3, 3), "inf tap")]
    n, sides = 0, []
    for dtype in (torch.float64, torch.float32):
        side = small_tile_side(torch.empty((), dtype=dtype).element_size())
        sides.append(side)
        for shape, kshape, note in cases + [
                (K9_WIDE_RASTER, (side, side), "small tile")]:
            x = torch.from_numpy(raster(shape)).to(DEV, dtype)
            w = rng.normal(0, 1, kshape)
            if note == "-0.0 tap":
                w[0, 0] = w[2, 3] = -0.0
            if note == "inf tap":
                w[1, 2] = np.inf
            w = torch.from_numpy(w).to(DEV, dtype)
            before = rc.raster_convolve.launches
            ker = rc.raster_convolve(x, w)
            torch.cuda.synchronize()
            check(rc.raster_convolve.launches == before + 1,
                  f"K9 edge {shape} {kshape}: not one launch")
            check(same_bits(ker, rc.convolve_ref(x, w)),
                  f"K9 edge {dtype} {shape} under {kshape} {note}: differs "
                  "from convolve_ref")
            n += 1
    log(f"[raster] K9 edge set: {n} cases bit-equal to convolve_ref (f64 "
        f"and f32; rasters {K9_SMALL_RASTERS} under 5x5; {K9_BANDS} under "
        f"{K9_EDGE_STENCILS}, a -0.0 tap, an inf tap; {K9_WIDE_RASTER} "
        f"under the small tile's {sides[0]}^2 (f64) and {sides[1]}^2 "
        "(f32))")
    return n


def ndvi_check(tile) -> dict:
    """``rops.ndvi`` on the card against ``device="cpu"`` on a two-band
    SRTM-sized stack (the tile as RED, a seeded NIR with some pixels of
    NIR + RED == 0): bit-equal; the device time of its torch ops
    (``rops.ndvi_body`` on the bands and mask on the card, CUDA events),
    the whole call's host ms (host copies and uploads included), and the
    ops' byte bound (two f64 bands and the bool mask read, the f64 result
    written)."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.core.raster import rops
    rng = np.random.default_rng(NDVI_SEED)
    red = tile.data[0]
    nir = rng.uniform(0.0, 300.0, red.shape)
    zero = rng.random(red.shape) < 1e-3
    nir[zero] = -red[zero]
    stack = mt.RasterTile(np.stack([red, nir]), tile.gt, srid=4326)
    card = rops.ndvi(stack, 0, 1, device=DEV)
    cpu = rops.ndvi(stack, 0, 1, device="cpu")
    a, b = torch.from_numpy(card.data), torch.from_numpy(cpu.data)
    check(same_bits(a, b), "ndvi: the card's output differs from the "
          "device='cpu' call's")
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        rops.ndvi(stack, 0, 1, device=DEV)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    m = stack.valid_mask()
    bands = torch.from_numpy(stack.data).to(DEV)
    valid = torch.from_numpy(m[0] & m[1]).to(DEV)
    check(same_bits(rops.ndvi_body(bands[0], bands[1], valid).cpu()[None],
                    a), "ndvi: ndvi_body differs from the call")
    ms = time_ms(lambda: rops.ndvi_body(bands[0], bands[1], valid), 20)
    pixels = red.size
    bound = pixels * (2 * 8 + 1 + 8) / PEAK_BYTES * 1e3
    nan = int(np.isnan(card.data).sum())
    log(f"[raster] ndvi on a two-band {list(red.shape)} stack: bit-equal "
        f"to device='cpu' ({nan} NaN pixels); its torch ops {ms:.4f} ms "
        f"(CUDA events over 20 calls on the card's bands), bound "
        f"{bound:.4f} ms (bytes), share {bound / ms:.3f}; the call "
        f"{host_ms:.3f} ms (host clock, copies included)")
    return {"ms": ms, "host_ms": host_ms, "bound_ms": bound,
            "bound_by": "bytes", "nan_pixels": nan,
            "shape": [2] + list(red.shape)}


def phase_raster(grid):
    """BASELINE config 5 on the card, the SRTM-sized tile with overlapping
    quarter tiles, and K9 and K10 against their plain versions."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.core.raster import rops
    from mosaic_tpu_torch.ops.raster_combine import (REDUCERS, combine_ref,
                                                     raster_combine)
    from mosaic_tpu_torch.ops.raster_convolve import (convolve_ref,
                                                      raster_convolve,
                                                      same_pads)
    from mosaic_tpu_torch.parallel.raster_halo import sharded_convolve
    t_phase = time.perf_counter()
    paths = {}

    # a. config 5 exactly as bench.py runs it
    gtr = mt.GeoTransform(*DEM_GT)
    yy, xx = np.mgrid[0:DEM_SHAPE[0], 0:DEM_SHAPE[1]]
    dem = mt.RasterTile((np.sin(xx / 60.0) * 50 + yy * 0.1)[None], gtr,
                        srid=4326)
    small = mt.RasterTile(dem.data[:, :64, :64], gtr, srid=4326)
    mt.raster_to_grid([small], R2G_RES, grid, combiner="avg", device=DEV)
    cfg5, cfg5_s, cfg5_stages, paths["raster config 5"], _ = raster_run(
        "config 5", [dem], grid)
    cfg5_host = paths["raster config 5"]["host_points"]
    check(len(cfg5) == R2G_CELLS,
          f"config 5: {len(cfg5)} cells, expected {R2G_CELLS}")
    t0 = time.perf_counter()
    cpu = mt.raster_to_grid([dem], R2G_RES, grid, combiner="avg",
                            device="cpu")
    cfg5_cpu_s = time.perf_counter() - t0
    check(same_values(cfg5, cpu), "config 5: the card's cells differ from "
          "the device='cpu' call's")
    log(f"[raster] config 5: {len(cfg5)} cells bit-equal to the "
        f"device='cpu' call ({cfg5_cpu_s:.3f} s); {cfg5_host} pixels "
        "re-assigned on the host")

    # b. the SRTM-sized tile in four overlapping quarter tiles
    t0 = time.perf_counter()
    tile = srtm_tile()
    quads = quarter_tiles(tile)
    valid = int(tile.valid_mask().sum())
    setup_s = time.perf_counter() - t0
    with KeepLargestStack() as largest:
        srtm, srtm_s, srtm_stages, paths["raster srtm"], kept = raster_run(
            "srtm", quads, grid)
    srtm_host = paths["raster srtm"]["host_points"]
    check(paths["raster srtm"]["raster_combine"] > 0,
          "srtm: no K10 launch on the overlapping tiles' path")
    sampled, low = check_ownership("srtm", kept, grid)
    check(low == srtm_host, f"srtm: {low} low-margin pixels, {srtm_host} "
          "re-assigned by the route")
    counts, _, count_stages, *_ = raster_run("srtm count", quads, grid,
                                             combiner="count", profiled=True)
    check(sum(counts.values()) == valid and set(counts) == set(srtm),
          f"srtm: counts sum to {sum(counts.values())}, {valid} valid "
          "pixels")
    corner = tile.window(0, 0, SRTM_CORNER, SRTM_CORNER)
    cq = quarter_tiles(corner)
    card_c = mt.raster_to_grid(cq, R2G_RES, grid, combiner="avg", device=DEV)
    cpu_c = mt.raster_to_grid(cq, R2G_RES, grid, combiner="avg",
                              device="cpu")
    check(same_values(card_c, cpu_c), "srtm corner: the card's cells differ "
          "from the device='cpu' call's")
    log(f"[raster] srtm: {len(srtm)} cells; counts conserve all {valid} "
        f"valid pixels; its {SRTM_CORNER}^2 corner in 4 tiles: "
        f"{len(card_c)} cells bit-equal to the device='cpu' call; tile "
        f"built in {setup_s:.2f} s")

    # c. K9 against its plain version
    rng = np.random.default_rng(K9_SEED)
    x64 = torch.from_numpy(np.where(tile.valid_mask(), tile.data, 0.0)
                           ).to(DEV)
    weights = [torch.from_numpy(rng.normal(0, 1, s)).to(DEV)
               for s in K9_SHAPES]
    reset_counts()
    conv_tiles = [rops.convolve(tile, w.cpu().numpy(), device=DEV)
                  for w in weights]
    paths["raster convolve srtm"] = launch_counts()
    dem32 = torch.from_numpy(np.asarray(dem.data, np.float32)).to(DEV)
    w32 = torch.from_numpy(rng.normal(0, 1, K9_HALO_SHAPE).astype(
        np.float32)).to(DEV)
    reset_counts()
    halo = sharded_convolve(dem, w32.cpu().numpy(), None, device=DEV)
    paths["raster halo dem"] = launch_counts()
    x32 = torch.from_numpy(np.where(tile.valid_mask(), tile.data, 0.0)
                           .astype(np.float32)).to(DEV)
    reset_counts()
    halo_srtm = sharded_convolve(tile, w32.cpu().numpy(), None, device=DEV)
    paths["raster halo srtm"] = launch_counts()
    check(paths["raster convolve srtm"]["raster_convolve"] == len(K9_SHAPES)
          and paths["raster halo dem"]["raster_convolve"] == 1
          and paths["raster halo srtm"]["raster_convolve"] == 1,
          "K9 launches: one per convolve and sharded_convolve call")
    k9 = {}
    halo_label = f"f32 {K9_HALO_SHAPE[0]}x{K9_HALO_SHAPE[1]} halo"
    cases = [(f"f64 {s[0]}x{s[1]} srtm", x64, w, ct.data)
             for s, w, ct in zip(K9_SHAPES, weights, conv_tiles)]
    cases += [(f"{halo_label} dem", dem32, w32, halo.data),
              (f"{halo_label} srtm", x32, w32, halo_srtm.data)]
    for label, x, w, entry in cases:
        x3 = x if x.dim() == 3 else x[None]
        ker = raster_convolve(x3, w)
        ref = convolve_ref(x3, w)
        check(same_bits(ker, ref), f"K9 {label}: differs from convolve_ref")
        check(np.array_equal(entry, ker.cpu().numpy()),
              f"K9 {label}: the entry point's output differs from the "
              "wrapper's")
        ms, source, events_ms, host_ms, plain_ms = timed_kernel(
            f"raster K9 {label}", lambda: raster_convolve(x3, w),
            lambda: convolve_ref(x3, w), "convolve_kernel", 3)
        top, bottom, left, right = same_pads(*w.shape)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib_ms = time_ms(lambda: F.conv2d(
                F.pad(x3[:, None], (left, right, top, bottom)),
                w[None, None]), 3)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        bound, by = conv_bound(x3, w)
        k9[label] = {"ms": ms, "ms_source": source, "events_ms": events_ms,
                     "host_ms": host_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": lib_ms, "max_abs_err": 0.0,
                     "shape": list(x3.shape) + list(w.shape)}
        log(f"[raster] K9 {label}: bit-equal to convolve_ref; {ms:.4f} ms "
            f"({source}), bound {bound:.4f} ms ({by}), share "
            f"{bound / ms:.3f}; plain {plain_ms:.3f} ms; F.conv2d "
            f"{lib_ms:.4f} ms (TF32 off)")
    k9_edges = k9_edge_set()

    # d. K10 against its plain version
    stack_np, _ = rops.combine_stack(quads)
    stack = torch.from_numpy(stack_np).to(DEV)
    del stack_np
    main_stack = largest.stack
    k10 = {}
    library = {"avg": lambda s: torch.nanmean(s, dim=0),
               "sum": lambda s: torch.nansum(s, dim=0)}
    for reducer in sorted(REDUCERS):
        for label, s in (("quarters", stack), ("main path", main_stack)):
            ker = raster_combine(s, reducer)
            check(same_bits(ker, combine_ref(s, reducer)),
                  f"K10 {reducer} {label}: differs from combine_ref")
        ms, source, events_ms, host_ms, plain_ms = timed_kernel(
            f"raster K10 {reducer}", lambda: raster_combine(stack, reducer),
            lambda: combine_ref(stack, reducer), "combine_kernel", 2)
        main_ms, main_src = kernel_device_ms(
            lambda: raster_combine(main_stack, reducer), 50,
            "combine_kernel")
        lib = library.get(reducer)
        lib_ms = time_ms(lambda: lib(stack), 10) if lib else None
        bound = (stack.numel() + stack[0].numel()) * 8 / PEAK_BYTES * 1e3
        k10[reducer] = {
            "ms": ms, "ms_source": source, "events_ms": events_ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms, "max_abs_err": 0.0,
            "library": ("torch.nanmean" if reducer == "avg" else
                        "torch.nansum" if reducer == "sum" else
                        "none: torch.nanmedian takes the lower middle value"
                        if reducer == "median" else "none: no one call"),
            "main_path_ms": main_ms, "main_path_ms_source": main_src,
            "main_path_shape": list(main_stack.shape)}
        log(f"[raster] K10 {reducer}: bit-equal to combine_ref on the "
            f"quarters' stack {list(stack.shape)} and the main path's "
            f"largest {list(main_stack.shape)}; {ms:.4f} ms ({source}), "
            f"bound {bound:.4f} ms (bytes), share {bound / ms:.3f}; plain "
            f"{plain_ms:.3f} ms; library {lib_ms}; main path's stack "
            f"{main_ms:.4f} ms ({main_src})")
    del stack

    # e. ndvi (torch ops) on a two-band SRTM-sized stack
    ndvi = ndvi_check(tile)
    t_phase = time.perf_counter() - t_phase
    log(f"[raster] the phase took {t_phase:.1f} s")
    return {"config5": {"cells": len(cfg5), "s": cfg5_s, "cpu_s": cfg5_cpu_s,
                        "stages": cfg5_stages, "host_points": cfg5_host},
            "srtm": {"cells": len(srtm), "s": srtm_s, "stages": srtm_stages,
                     "count_stages": count_stages,
                     "host_points": srtm_host, "valid_pixels": valid,
                     "sampled": sampled, "corner_cells": len(card_c),
                     "k10_launches": paths["raster srtm"]["raster_combine"]},
            "k9": k9, "k9_edge_cases": k9_edges, "k10": k10, "ndvi": ndvi,
            "phase_s": t_phase, "paths": paths,
            "halo_inputs": (tile, w32.cpu().numpy(), halo_srtm.data)}

def phase_sharded(idx, grid, polys, batches, dense_zones, h3s, over, knn,
                  raster):
    """The sharded entry points over a ``torch.distributed`` NCCL group of
    one rank on the card, each held to its single-device counterpart on
    the same inputs (both timed, host clock to a synchronize), its
    launches and collectives counted and the collectives' host seconds
    (each ended at a synchronize) taken."""
    import os
    import tempfile
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch import config
    from mosaic_tpu_torch.parallel import collectives as coll
    from mosaic_tpu_torch.parallel import overlay as ov
    from mosaic_tpu_torch.parallel import pip_join as pj
    from mosaic_tpu_torch.parallel.raster_halo import sharded_convolve

    t_phase = time.perf_counter()
    paths, stats = {}, {}
    names = ("all_gather", "all_reduce", "all_to_all", "broadcast",
             "exchange_halo")
    clock = StepClock([(coll, f) for f in names], sync=set(names))

    def synced(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def pair(path, sharded, single):
        """(sharded output, single-device output): the sharded call
        counted (launch and collective counts to 0, drive, read), then
        its single-device counterpart."""
        with clock:
            reset_counts()
            coll.reset_counts()
            out, t = synced(sharded)
            paths[path] = launch_counts()
            stats[path] = {"s": round(t, 4), "collectives": {
                k: {"calls": v[0], "bytes": v[1]}
                for k, v in coll.COUNTS.items() if v[0]},
                "collective_s": clock.take()}
        one, stats[path]["one_device_s"] = synced(single)
        log(f"[sharded] {path}: {stats[path]}; launches "
            f"{ {k: v for k, v in paths[path].items() if v} }")
        return out, one

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=60))
        try:
            G = dist.group.WORLD
            # NCCL builds its communicator at the first collective
            _, t_start = synced(lambda: coll.all_reduce(
                torch.zeros(1, device=DEV), G))
            log(f"[sharded] NCCL world of {dist.get_world_size()}; its "
                f"first collective took {t_start:.3f} s")
            # a. the sharded join and the zone histogram, against the
            # one-device K2 call and phase 5's final zones
            pts = batches[0][:SHARD_JOIN_N]
            loc = torch.from_numpy(pj.localize(idx, pts))
            run = pj.make_sharded_pip_join(idx, grid, G, device=DEV)
            one = pj.make_pip_join_fn(idx)
            (z, u), (z1, u1) = pair("sharded pip join", lambda: run(loc),
                                    lambda: one(loc.to(DEV)))
            check(torch.equal(z, z1) and torch.equal(u, u1),
                  "sharded join: zones or flags differ from one device")
            hist, hist1 = pair(
                "sharded zone histogram",
                lambda: pj.zone_histogram(z, len(polys), G),
                lambda: pj.zone_histogram(z1, len(polys)))
            check(torch.equal(hist, hist1),
                  "sharded zone histogram differs from one device")
            final = pj.host_recheck_fn(idx)(pts, z.cpu().numpy(),
                                            u.cpu().numpy())
            check(np.array_equal(final, dense_zones[0][:SHARD_JOIN_N]),
                  "sharded join: final zones differ from phase 5's")
            check(paths["sharded pip join"]["h3_dense_join"] == 1,
                  "sharded join: not one K2 launch")
            # b. the sharded streamed join and c. the planned join pinned
            # to sharded (a group of one runs the streamed join), each on
            # a whole 2^22 batch, against the streamed join and phase 5
            n_chunks = -(-BATCH // CHUNK)
            shj = pj.make_sharded_streamed_pip_join(
                idx, grid, G, polys=polys, chunk=CHUNK, device=DEV)
            streamed = pj.make_streamed_pip_join(idx, grid, polys,
                                                 chunk=CHUNK, device=DEV)
            (zs, _), (zs1, _) = pair("sharded streamed",
                                     lambda: shj(batches[1]),
                                     lambda: streamed(batches[1]))
            check(np.array_equal(zs, dense_zones[1]) and
                  np.array_equal(zs1, dense_zones[1]),
                  "sharded streamed zones differ from phase 5's")
            prev = config.default_config()
            config.set_default_config(config.apply_conf(
                prev, "mosaic.planner.force.pip_join", "sharded"))
            try:
                planned = pj.make_planned_pip_join(idx, grid, polys,
                                                   group=G)
                (zp, _), _ = pair("sharded planned",
                                  lambda: planned(batches[2]),
                                  lambda: streamed(batches[2]))
            finally:
                config.set_default_config(prev)
            check(np.array_equal(zp, dense_zones[2]),
                  "planned sharded zones differ from phase 5's")
            for p in ("sharded streamed", "sharded planned"):
                check(paths[p]["h3_dense_join"] == n_chunks,
                      f"{p}: {paths[p]['h3_dense_join']} K2 launches for "
                      f"{n_chunks} chunks")
            # d. the sorted H3 index (K3 under the sorted body), against
            # its streamed join and phase 9's final zones
            p18 = batches[0][:SHARD_H3_N]
            shs = pj.make_sharded_streamed_pip_join(
                h3s["idx"], grid, G, polys=polys, chunk=CHUNK, device=DEV)
            one = pj.make_streamed_pip_join(h3s["idx"], grid, polys,
                                            chunk=CHUNK, device=DEV)
            (zh, _), (zh1, _) = pair("sharded h3 sorted",
                                     lambda: shs(p18), lambda: one(p18))
            check(np.array_equal(zh, h3s["zones"][0][:SHARD_H3_N]) and
                  np.array_equal(zh1, zh),
                  "sharded sorted H3 zones differ from phase 9's")
            check(paths["sharded h3 sorted"]["h3_latlng_to_cell"] ==
                  -(-SHARD_H3_N // CHUNK), "sharded sorted H3: K3 launches")
            # e. the overlay on phase 11's first footprints
            foot, chips_b = over["shard_inputs"]
            sub = foot.take(list(range(SHARD_FOOTPRINTS)))
            chips_a = mt.tessellate(sub, RES, grid, keep_core_geom=True,
                                    device=DEV)
            kw = dict(device=DEV, chips_a=chips_a, chips_b=chips_b)
            hits, hits1 = pair(
                "sharded overlay intersects",
                lambda: ov.overlay_intersects(sub, polys, RES, grid,
                                              group=G, **kw),
                lambda: ov.overlay_intersects(sub, polys, RES, grid, **kw))
            check(np.array_equal(hits, hits1),
                  "sharded overlay hits differ from one device")
            area, area1 = pair(
                "sharded overlay area",
                lambda: ov.overlay_intersection_area(sub, polys, RES, grid,
                                                     group=G, **kw),
                lambda: ov.overlay_intersection_area(sub, polys, RES, grid,
                                                     **kw))
            check(all(np.array_equal(a, b) for a, b in zip(area, area1)),
                  "sharded overlay areas differ from one device")
            check(paths["sharded overlay intersects"]["overlay_pairs"] == 1
                  and paths["sharded overlay area"]["overlay_pairs"] >= 1,
                  "sharded overlay: K4 launches")
            # f. the ring over the group on phase 12's first pings,
            # against the one-device ring and phase 12's ring rows
            pings, ports, ids, dists = knn["shard_inputs"]
            kw = dict(k=KNN_K, index_resolution=KNN_RES,
                      max_iterations=KNN_MAX_IT, device=DEV)
            out, out1 = pair(
                "sharded knn ring",
                lambda: mt.SpatialKNN(grid, group=G, **kw).transform(
                    pings, ports),
                lambda: mt.SpatialKNN(grid, brute_right_max=0,
                                      **kw).transform(pings, ports))
            for o in (out, out1):
                check(np.array_equal(o["right_id"], ids) and
                      np.array_equal(o["distance"], dists, equal_nan=True),
                      "sharded ring ids or distances differ from phase 12")
            check(paths["sharded knn ring"]["knn_ring_step"] ==
                  out["iterations"] and
                  paths["sharded knn ring"]["knn_brute_topk"] == 0,
                  "sharded ring: K6 launches")
            # g. the halo over the group on the SRTM tile, against phase
            # 15's group=None call
            tile, w, want = raster["halo_inputs"]
            got, _ = pair("sharded raster halo",
                          lambda: sharded_convolve(tile, w, G, device=DEV),
                          lambda: sharded_convolve(tile, w, device=DEV))
            check(same_bits(torch.from_numpy(got.data),
                            torch.from_numpy(want)),
                  "sharded halo differs from group=None")
            seams = halo_seams(tile, w)
        finally:
            dist.destroy_process_group()
    t_phase = time.perf_counter() - t_phase
    log(f"[sharded] the phase took {t_phase:.1f} s (host clock)")
    return {"paths": stats, "nccl_first_s": t_start, "halo_seams": seams,
            "phase_s": t_phase, "counts": paths}


def phase_store(idx, grid, polys):
    """The store-fed flagship: a STORE_ROWS-row chip store on the card
    machine's disk queried out of core through
    ``make_store_sharded_pip_join`` over phase 5's dense index (K2), held
    to the streamed join over the same rows; a side store's pruned query
    with ``group=None`` and over a NCCL world of one, and heat-primed."""
    import os
    import shutil
    import tempfile
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch import config
    from mosaic_tpu_torch.obs import metrics
    from mosaic_tpu_torch.obs.heat import heat
    from mosaic_tpu_torch.parallel import pip_join as pj
    from mosaic_tpu_torch.store import ChipStore, StoreWriter, write_store

    t_phase = time.perf_counter()
    metrics.enable()
    out, paths, times = {}, {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")

    def counted(path, fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after, its host seconds (ended at a synchronize) and the
        bytes it staged."""
        reset_counts()
        h0 = metrics.counter_value("pipeline/h2d_bytes")
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[path] = time.perf_counter() - t0
        paths[path] = launch_counts()
        return res, metrics.counter_value("pipeline/h2d_bytes") - h0

    def ledger_ok(label, run, scanned, staged, D=1):
        led = run.staged_bytes_by_partition
        cells = {p.cell for p in scanned}
        check(set(led) == cells, f"{label}: the ledger names "
              f"{len(set(led) - cells)} unscanned and misses "
              f"{len(cells - set(led))} scanned partitions")
        check(sum(led.values()) == D * staged > 0, f"{label}: ledger "
              f"{sum(led.values())} B against {D} x {staged} B staged")

    try:
        # ---- a. ingest: generation outside the clock, the writer inside
        w = StoreWriter(os.path.join(root, "big"), grid_res=STORE_RES,
                        shard_rows=STORE_SHARD)
        t_ingest, done, i = 0.0, 0, 0
        while done < STORE_ROWS:
            blk = mt.nyc_points(min(STORE_BLOCK, STORE_ROWS - done),
                                seed=500 + i)
            t0 = time.perf_counter()
            w.append(blk)
            t_ingest += time.perf_counter() - t0
            done += len(blk)
            i += 1
        del blk
        t0 = time.perf_counter()
        w.finalize()
        t_ingest += time.perf_counter() - t0
        big = ChipStore(os.path.join(root, "big"))
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(os.path.join(root, "big"))
                   for f in fs)
        out["ingest"] = {"rows": STORE_ROWS, "blocks": i,
                         "partitions": len(big.partitions),
                         "disk_bytes": disk, "nbytes": big.nbytes(),
                         "s": t_ingest, "rows_per_s": STORE_ROWS / t_ingest}
        log(f"[store] ingest: {STORE_ROWS} rows in {i} blocks -> "
            f"{len(big.partitions)} partitions, {disk} B on disk "
            f"(nbytes {big.nbytes()}) in {t_ingest:.3f} s = "
            f"{STORE_ROWS / t_ingest:.4e} rows/s (host clock, generation "
            "excluded)")
        check(big.total_rows == STORE_ROWS and
              big.nbytes() == 16 * STORE_ROWS, "big store: rows or nbytes")

        # ---- b. the big store queried out of core, one device
        n_chunks = -(-STORE_ROWS // CHUNK)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = pj.make_store_sharded_pip_join(big, idx, grid, polys=polys,
                                             chunk=CHUNK, device=DEV)
        (zone, rechecked), staged = counted("store fed big", run)
        peak = torch.cuda.max_memory_allocated()
        t = times["store fed big"]
        out["query"] = {"rows": len(zone), "s": t, "pps": len(zone) / t,
                        "rechecked": rechecked, "chunks": n_chunks,
                        "peak_allocated_bytes": peak,
                        "allocated_before_bytes": base,
                        "staged_bytes": staged}
        log(f"[store] query: {len(zone)} rows in {t:.3f} s = "
            f"{len(zone) / t:.4e} points/s (host clock); {rechecked} "
            f"rechecked; device peak allocated {peak} B ({base} B before "
            f"the query) against the store's {big.nbytes()} B; launches "
            f"{ {k: v for k, v in paths['store fed big'].items() if v} }")
        check(len(zone) == STORE_ROWS, "big store: rows returned")
        check(paths["store fed big"]["h3_dense_join"] == n_chunks,
              f"big store: {paths['store fed big']['h3_dense_join']} K2 "
              f"launches for {n_chunks} chunks")
        check(paths["store fed big"]["h3_project_lattice"] == 0 and
              paths["store fed big"]["h3_latlng_to_cell"] == 0,
              "big store: K1 or K3 launched on the dense path")
        check(peak < big.nbytes(), f"big store: device peak {peak} B not "
              f"below the store's {big.nbytes()} B")
        check(run.rebalancer.observations == n_chunks,
              "big store: one rebalancer observation a chunk")
        ledger_ok("big store", run, big.partitions, staged)

        # ---- c. the same rows through the one-device streamed join
        t0 = time.perf_counter()
        cols = big.read_columns(cols=big.point_cols)
        pts = np.column_stack([cols.pop("x"), cols.pop("y")])
        times["big read_columns"] = time.perf_counter() - t0
        streamed = pj.make_streamed_pip_join(idx, grid, polys, chunk=CHUNK,
                                             device=DEV)
        (want, want_re), _ = counted("store big streamed reference",
                                     lambda: streamed(pts))
        del pts
        check(np.array_equal(zone, want) and rechecked == want_re,
              f"big store: {int(np.sum(zone != want))} zones differ from "
              f"the streamed join ({rechecked} against {want_re} "
              "rechecked)")
        log(f"[store] the streamed join over read_columns(): "
            f"{times['store big streamed reference']:.3f} s (read "
            f"{times['big read_columns']:.3f} s); zones bit-equal, "
            "rechecked equal")
        del want, zone

        # ---- d. one partition's chunks profiled by stage
        part = min([p for p in big.partitions if p.rows >= 8 * CHUNK] or
                   big.partitions, key=lambda p: p.rows)
        p_chunks = -(-part.rows // CHUNK)
        run(bbox=part.bbox)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z_part, _ = run(bbox=part.bbox)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(len(z_part) == part.rows, "profiled partition: rows")
        out["profile"] = profile_run(
            lambda: run(bbox=part.bbox), p_chunks, plain_ms,
            f"partition {part.cell} ({part.rows} rows, {p_chunks} chunks)",
            labels=("stream/", "store_join/"))
        out["profile"]["rows"] = part.rows

        # ---- e. the side store, pruned, one device and a NCCL world of
        # one, then heat-primed
        side_pts = mt.nyc_points(STORE_SIDE_ROWS, seed=901)
        write_store(os.path.join(root, "side"), side_pts,
                    grid_res=STORE_SIDE_RES, shard_rows=STORE_SIDE_SHARD)
        side = ChipStore(os.path.join(root, "side"))
        x0, y0, x1, y1 = side.bbox
        qbox = (x0, y0, x0 + (x1 - x0) * STORE_SIDE_FRAC,
                y0 + (y1 - y0) * STORE_SIDE_FRAC)
        scanned = side.prune(qbox, record=False)
        cold = {p.cell for p in side.partitions} - {p.cell for p in scanned}
        sc = side.read_columns(cols=side.point_cols, bbox=qbox)
        (ref, ref_re), _ = counted("store side streamed reference",
                                   lambda: streamed(np.column_stack(
                                       [sc["x"], sc["y"]])))
        rows_before = {c["cell"]: c["rows"] for c in
                       heat.report(top=1 << 20)["cells"]}
        pr0 = metrics.counter_value("store/partitions_pruned")
        srun = pj.make_store_sharded_pip_join(side, idx, grid, polys=polys,
                                              chunk=CHUNK, device=DEV)
        (z_side, re_side), staged = counted("store fed side",
                                            lambda: srun(bbox=qbox))
        pruned = int(metrics.counter_value("store/partitions_pruned") - pr0)
        rows_after = {c["cell"]: c["rows"] for c in
                      heat.report(top=1 << 20)["cells"]}
        check(pruned == len(cold) > 0, f"side store: {pruned} partitions "
              f"pruned, {len(cold)} outside the box")
        check(all(rows_after.get(c, 0.0) <= rows_before.get(c, 0.0)
                  for c in cold), "side store: a pruned partition gained "
              "heat")
        ledger_ok("side store", srun, scanned, staged)
        check(np.array_equal(z_side, ref) and re_side == ref_re,
              "side store: zones differ from the streamed join")
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group(
                "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                rank=0, world_size=1, timeout=timedelta(seconds=60))
            try:
                G = dist.group.WORLD
                grun = pj.make_store_sharded_pip_join(
                    side, idx, grid, G, polys=polys, chunk=CHUNK,
                    device=DEV)
                (z_g, re_g), staged_g = counted("store fed side nccl",
                                                lambda: grun(bbox=qbox))
            finally:
                dist.destroy_process_group()
        ledger_ok("side store over NCCL", grun, scanned, staged_g)
        check(np.array_equal(z_g, ref) and re_g == ref_re,
              "side store over NCCL: zones differ from the streamed join")
        prev = config.default_config()
        config.set_default_config(config.apply_conf(
            prev, "mosaic.heat.prior", "true"))
        try:
            p0 = metrics.counter_value("heat/prior_primes")
            hrun = pj.make_store_sharded_pip_join(
                side, idx, grid, polys=polys, chunk=CHUNK, device=DEV)
            primes = metrics.counter_value("heat/prior_primes") - p0
            (z_hot, re_hot), _ = counted("store fed side primed",
                                         lambda: hrun(bbox=qbox))
        finally:
            config.set_default_config(prev)
        check(primes == 1 and hrun.rebalancer.armed,
              "side store: the heat prior did not prime the rebalancer")
        check(np.array_equal(z_hot, z_side) and re_hot == re_side,
              "side store: the heat-primed query differs")
        out["side"] = {"rows": len(z_side), "partitions": len(side.partitions),
                       "pruned": pruned, "scanned_rows": len(z_side),
                       "rechecked": re_side, "staged_bytes": staged}
        for p in ("store fed side", "store fed side nccl",
                  "store fed side primed"):
            check(paths[p]["h3_dense_join"] == -(-len(z_side) // CHUNK),
                  f"{p}: K2 launches")
        log(f"[store] side store: {len(side.partitions)} partitions, "
            f"{pruned} pruned by the {STORE_SIDE_FRAC} box, "
            f"{len(z_side)} rows scanned; one device, NCCL world of one "
            "and heat-primed bit-equal to the streamed join")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        metrics.disable()
    out["host_s"] = times
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[store] query host seconds {json.dumps(times)}; the phase took "
        f"{out['phase_s']:.1f} s (host clock)")
    out["counts"] = paths
    return out


def geom_host_measures(A, B, M):
    """(area, length, centroid, bounds) and the sums of |terms| of the
    first three, per row, in numpy f64 (pairwise sums) from a block's own
    coordinates: the reference K11 is held to."""
    import numpy as np
    cross = np.where(M, A[..., 0] * B[..., 1] - A[..., 1] * B[..., 0], 0.0)
    # the shoelace's terms are its products: |ax by| + |ay bx| an edge
    prod = np.where(M, np.abs(A[..., 0] * B[..., 1]) +
                    np.abs(A[..., 1] * B[..., 0]), 0.0)
    d = B - A
    ln = np.where(M, np.sqrt(np.sum(d * d, -1)), 0.0)
    Asum, L = cross.sum(-1), ln.sum(-1)
    mid = A + B
    with np.errstate(divide="ignore", invalid="ignore"):
        poly = (mid * cross[..., None]).sum(1) / (3 * Asum[:, None] + 1e-300)
        line = (0.5 * mid * ln[..., None]).sum(1) / (L[:, None] + 1e-300)
        n = M.sum(-1)[:, None]
        vert = np.where(M[..., None], A, 0.0).sum(1) / (n + 1e-300)
        top = np.abs(mid).max(1)
        s_poly = (np.abs(mid * prod[..., None]).sum(1) +
                  top * prod.sum(-1)[:, None]) / np.abs(3 * Asum[:, None])
        s_line = (np.abs(0.5 * mid * ln[..., None]).sum(1) +
                  top * L[:, None]) / L[:, None]
    is_poly = (np.abs(Asum) > 1e-30)[:, None]
    is_line = (L > 1e-30)[:, None]
    cen = np.where(is_poly, poly, np.where(is_line, line, vert))
    s_cen = np.where(is_poly, s_poly, np.where(is_line, s_line,
                                               np.abs(vert)))
    inf = np.inf
    lo = np.minimum(np.where(M[..., None], A, inf).min(1),
                    np.where(M[..., None], B, inf).min(1))
    hi = np.maximum(np.where(M[..., None], A, -inf).max(1),
                    np.where(M[..., None], B, -inf).max(1))
    bounds = np.concatenate([lo, hi], -1)
    return ({"area": np.maximum(0.5 * Asum, 0.0), "length": L,
             "centroid": cen, "bounds": bounds},
            {"area": 0.5 * prod.sum(-1), "length": L,
             "centroid": s_cen})


def geom_measures(label: str, arr, path: str, paths: dict) -> dict:
    """K11 on ``arr``'s edge blocks in f64 and f32 through the four
    measures (one launch each, counted under ``path``): bit-equal to the
    plain version on every row, also through each mapping forced, and
    within GEOM_REL of the type x the row's sum of |terms| of a numpy f64
    shoelace on the block's own coordinates; the bounds equal to numpy's
    min and max exactly."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.core.geometry import measures
    from mosaic_tpu_torch.core.geometry.padded import build_edges
    from mosaic_tpu_torch.ops.edge_measures import (PATHS, edge_measures,
                                                    edge_measures_ref,
                                                    launch_plan)
    out = {"rows": len(arr)}
    blocks = {dt: build_edges(arr, dtype=dt, device=DEV)
              for dt in (torch.float64, torch.float32)}
    reset_counts()
    got = {dt: {w: getattr(measures, w)(e) for w in GEOM_MEASURES}
           for dt, e in blocks.items()}
    torch.cuda.synchronize()
    paths[path] = launch_counts()
    check(paths[path]["edge_measures"] == 2 * len(GEOM_MEASURES),
          f"{label}: {paths[path]['edge_measures']} K11 launches for "
          f"{2 * len(GEOM_MEASURES)} calls")
    for dt, e in blocks.items():
        name = str(dt).split(".")[-1]
        A = e.a.double().cpu().numpy()
        B = e.b.double().cpu().numpy()
        M = e.mask.cpu().numpy()
        host, scale = geom_host_measures(A, B, M)
        row = {"edge_slots": int(e.capacity),
               "path": launch_plan(*e.mask.shape)}
        for w in GEOM_MEASURES:
            k = got[dt][w]
            plain = edge_measures_ref(e.a, e.b, e.mask, w)
            check(same_bits(k, plain), f"{label} {name} {w}: K11 differs "
                  "from its plain version")
            for forced in PATHS:
                check(same_bits(edge_measures(e.a, e.b, e.mask, w,
                                              path=forced), plain),
                      f"{label} {name} {w}: K11 by the {forced} mapping "
                      "differs from its plain version")
            kh = k.double().cpu().numpy()
            if w == "bounds":
                check(np.array_equal(kh, host[w]), f"{label} {name} bounds "
                      "differ from numpy's min and max")
                row[w] = "equal"
                continue
            tol = GEOM_REL[name] * scale[w] + 1e-300
            err = np.abs(kh - host[w])
            rel = float((err / np.maximum(scale[w], 1e-300)).max())
            check(bool((err <= tol).all()), f"{label} {name} {w}: "
                  f"{int((err > tol).sum())} rows beyond {GEOM_REL[name]} x "
                  "the sum of |terms| of the f64 shoelace")
            row[w] = rel
        out[name] = row
        log(f"[geometry] {label} {name}: {len(arr)} rows x "
            f"{e.capacity} edge slots ({row['path']} mapping); area, "
            "length, centroid, bounds bit-equal to the plain version, by "
            "either mapping too; worst error / sum of |terms| against the "
            f"numpy f64 shoelace: {row}")
    out["blocks"] = blocks
    return out


def k11_adversarial() -> dict:
    """K11 bit-equal to its plain version on every row of
    ``measures_adversarial``'s set in f64 and f32, for the four measures,
    through each view of MEASURES_ADV_VIEWS and by the wrapper's mapping
    and each one forced; the plain version once a block and measure, on
    the block as built."""
    import torch
    from mosaic_tpu_torch.bench.workloads import (MEASURES_ADV_VIEWS,
                                                  measures_adversarial,
                                                  measures_view)
    from mosaic_tpu_torch.ops.edge_measures import (PATHS, edge_measures,
                                                    edge_measures_ref)
    t0 = time.perf_counter()
    shapes, calls = [], 0
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        for label, A, B, M in measures_adversarial(name):
            if dt == torch.float64:
                shapes.append(label)
            views = {v: (measures_view(A, v, dt, DEV),
                         measures_view(B, v, dt, DEV),
                         measures_view(M, v, None, DEV))
                     for v in MEASURES_ADV_VIEWS}
            for w in GEOM_MEASURES:
                plain = edge_measures_ref(*views["whole"], w)
                for v, (a, b, m) in views.items():
                    for path in (None, *PATHS):
                        check(same_bits(edge_measures(a, b, m, w, path=path),
                                        plain),
                              f"K11 {w} differs from its plain version on "
                              f"the adversarial {label} {name} ({v} view, "
                              f"{path or 'planned'} mapping)")
                        calls += 1
    torch.cuda.synchronize()
    out = {"shapes": shapes, "views": list(MEASURES_ADV_VIEWS),
           "calls": calls, "seconds": round(time.perf_counter() - t0, 1)}
    log(f"[geometry] K11 adversarial set: {shapes} (G x E) in f64 and f32, "
        f"views {list(MEASURES_ADV_VIEWS)}, the four measures by the "
        f"wrapper's mapping and each forced: {calls} calls bit-equal to "
        f"the plain version ({out['seconds']} s)")
    return out


def k11_bound(e, what: str) -> dict:
    """K11's bound on the blocks ``e`` for one measure.  Bytes: the
    centroid reads every endpoint; area, length and bounds the 32-byte
    sectors of a and b that hold a valid slot's endpoints, counted from
    the mask and the arrays' addresses; each reads the whole mask and
    writes its output once.  Operations: K11_OPS a valid slot (every slot
    for the centroid)."""
    import torch
    from mosaic_tpu_torch.ops.edge_measures import WIDTH
    G, E = e.mask.shape
    item = e.a.element_size()
    f64 = e.a.dtype == torch.float64
    if what == "centroid":
        ends = 2 * e.a.numel() * item
        slots = G * E
    else:
        valid = torch.nonzero(e.mask.reshape(-1)).squeeze(1)
        slots = int(valid.numel())
        ends = sum(32 * int(torch.unique(
            (x.data_ptr() % 32 + valid * 2 * item) // 32).numel())
            for x in (e.a, e.b))
    byts = ends + e.mask.numel() + G * max(1, WIDTH[what]) * item
    ops = slots * K11_OPS[what]
    t_ops = ops / (PEAK_F64_OPS if f64 else PEAK_F32_OPS) * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return {"bytes": byts, "ops": ops, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def straddle_count(py, e) -> int:
    """Valid (point, edge) pairs of the block ``e`` (all its geometries)
    whose edge straddles the point's y by the half-open rule, counted
    from sorted edge y-ranges: lo <= py < hi."""
    import torch
    ay, by = e.a[..., 1][e.mask], e.b[..., 1][e.mask]
    lo = torch.sort(torch.minimum(ay, by)).values
    hi = torch.sort(torch.maximum(ay, by)).values
    n = torch.searchsorted(lo, py.contiguous(), right=True) - \
        torch.searchsorted(hi, py.contiguous(), right=True)
    return int(n.sum())


def k12_bound(pts, e) -> dict:
    """K12's bound for count and distance on ``pts`` against ``e``: the
    operations its data needs (K12_PER_EDGE compares a valid (point,
    edge) pair, K12_PER_STRADDLE and a divide a straddling one,
    K12_PER_DIST_EDGE and a divide a valid pair's distance, a sqrt a
    pair) and its bytes (points, edges and mask read once; counts and
    distances written once)."""
    import torch
    f64 = pts.dtype == torch.float64
    size = 8 if f64 else 4
    div = F64_DIV_OPS if f64 else F32_DIV_OPS
    N, G = int(pts.shape[0]), int(e.a.shape[0])
    valid = int(e.mask.sum())
    strad = straddle_count(pts[:, 1], e)
    ops = N * valid * (K12_PER_EDGE + K12_PER_DIST_EDGE + div) + \
        strad * (K12_PER_STRADDLE + div) + N * G
    byts = pts.numel() * size + 2 * e.a.numel() * size + e.mask.numel() + \
        N * G * (4 + size)
    t_ops = ops / (PEAK_F64_OPS if f64 else PEAK_F32_OPS) * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return {"ops": ops, "bytes": byts, "straddles": strad,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k13_bound(e1, e2, cross) -> dict:
    """K13's bound from its own answer ``cross``: every valid edge pair of
    a pair that does not cross, one of a pair that does, at
    K13_PER_EDGE_PAIR operations each; bytes: both blocks read once and
    the matrix written once."""
    import torch
    f64 = e1.a.dtype == torch.float64
    size = 8 if f64 else 4
    v1 = e1.mask.sum(1).double()
    v2 = e2.mask.sum(1).double()
    false_pairs = float((v1[:, None] * v2[None, :] *
                         (~cross).double()).sum())
    tests = false_pairs + float(cross.sum())
    ops = tests * K13_PER_EDGE_PAIR
    byts = 2 * (e1.a.numel() + e2.a.numel()) * size + e1.mask.numel() + \
        e2.mask.numel() + cross.numel()
    t_ops = ops / (PEAK_F64_OPS if f64 else PEAK_F32_OPS) * 1e3
    t_bytes = byts / PEAK_BYTES * 1e3
    return {"edge_pair_tests": tests, "ops": ops, "bytes": byts,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def adv_blocks(rng, G: int, E: int):
    """Seeded edge blocks (numpy f64 A, B [G, E, 2], M [G, E]) on the
    kernels' corner cases: small integer coordinates (exact zero
    orientations: shared, reversed, collinear overlapping and touching
    edges), horizontal and zero-length edges, a third of the rows
    jittered off the grid, each row shifted by whole units (so that rows
    meet and miss), non-prefix masks of three densities with all-masked
    rows, NaN ends in one slot of every other row (valid or masked)."""
    import numpy as np
    A = rng.integers(-6, 7, (G, E, 2)).astype(np.float64)
    B = A + rng.integers(-3, 4, (G, E, 2))
    kind = rng.random((G, E))
    B[..., 1] = np.where(kind < 0.2, A[..., 1], B[..., 1])
    B = np.where((kind > 0.92)[..., None], A, B)
    if G * E > 1:                      # copies of other edges, some reversed
        dst = rng.integers(0, G * E, G * E // 4)
        src = rng.integers(0, G * E, dst.size)
        flip = rng.random(dst.size) < 0.5
        fa, fb = A.reshape(-1, 2), B.reshape(-1, 2)
        sa, sb = fa[src].copy(), fb[src].copy()
        fa[dst] = np.where(flip[:, None], sb, sa)
        fb[dst] = np.where(flip[:, None], sa, sb)
    jitter = rng.random(G) < 0.3
    A[jitter] += rng.uniform(-0.5, 0.5, A[jitter].shape)
    B[jitter] += rng.uniform(-0.5, 0.5, B[jitter].shape)
    shift = rng.integers(-12, 13, (G, 1, 2))      # rows apart and together
    A += shift
    B += shift
    M = rng.random((G, E)) < rng.choice([0.05, 0.4, 0.9], G)[:, None]
    M[rng.random(G) < 0.15] = False
    rows, slot = np.arange(G), rng.integers(0, E, G)
    A[rows[1::4], slot[1::4], 0] = np.nan
    B[rows[3::4], slot[3::4], 1] = np.nan
    return A, B, M


def adv_points(rng, N: int, A, B):
    """Seeded points [N, 2] against adv_blocks' edges: their vertices, the
    integer grid (on horizontal edges and vertices), half-integers, reals
    and NaN."""
    import numpy as np
    ends = np.concatenate([A.reshape(-1, 2), B.reshape(-1, 2)])
    pick = rng.integers(0, ends.shape[0], N)
    P = np.where((rng.random(N) < 0.3)[:, None], ends[pick],
                 rng.integers(-7, 8, (N, 2)).astype(np.float64))
    half = rng.random(N) < 0.2
    P[half] += 0.5
    real = rng.random(N) < 0.2
    P[real] = rng.uniform(-7, 7, (int(real.sum()), 2))
    P[rng.random(N) < 0.02] = np.nan
    return P


def collinear_pairs(rng, n: int):
    """n pairs of segments on one line through the origin, one on each
    side of it (disjoint, their bboxes too), the inner ends within 1e-9
    to 1e-3 of it: their orientations are rounding noise, and the plain
    version calls some pairs crossing.  (a1, b1, a2, b2) [n, 2] each."""
    import numpy as np
    v = rng.normal(0.0, 1.0, (n, 2))
    s = np.stack([-rng.uniform(1, 10, n), -10 ** rng.uniform(-9, -3, n),
                  10 ** rng.uniform(-9, -3, n), rng.uniform(1, 10, n)], 1)
    p = s[..., None] * v[:, None, :]
    return p[:, 0], p[:, 1], p[:, 2], p[:, 3]


def geom_adversarial() -> dict:
    """K12 (all three instances) and K13 bit-equal to their plain versions
    on the adversarial set, in f64 and f32; the K13 hazards the plain
    version answers true on collinear disjoint pairs, by type."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.ops.edge_point import (edge_point_query,
                                                 edge_point_query_ref)
    from mosaic_tpu_torch.ops.edges_cross import edges_cross, edges_cross_ref
    rng = np.random.default_rng(GEOM_ADV_SEED)
    types = ((torch.float64, np.float64), (torch.float32, np.float32))

    def dev(x, npdt):
        return torch.from_numpy(np.ascontiguousarray(
            x.astype(npdt) if x.dtype != bool else x)).to(DEV)

    for N, G, E in GEOM_ADV_K12:
        A, B, M = adv_blocks(rng, G, E)
        P = adv_points(rng, N, A, B)
        for dt, npdt in types:
            p, a, b, m = (dev(x, npdt) for x in (P, A, B, M))
            pc, pd = edge_point_query_ref(p, a, b, m, True, True)
            for cnt, dst in ((True, True), (True, False), (False, True)):
                kc, kd = edge_point_query(p, a, b, m, cnt, dst)
                check((not cnt or torch.equal(kc, pc)) and
                      (not dst or same_bits(kd, pd)),
                      f"K12 (count {cnt}, dist {dst}) differs from its plain "
                      f"version on the adversarial {N} x {G} x {E} {dt}")
    for G1, E1, G2, E2 in GEOM_ADV_K13:
        blocks = adv_blocks(rng, G1, E1) + adv_blocks(rng, G2, E2)
        for dt, npdt in types:
            t = [dev(x, npdt) for x in blocks]
            check(torch.equal(edges_cross(*t), edges_cross_ref(*t)),
                  f"K13 differs from its plain version on the adversarial "
                  f"{G1} x {E1}, {G2} x {E2} {dt}")
    a1, b1, a2, b2 = collinear_pairs(rng, GEOM_ADV_COLLINEAR)
    one = np.ones((GEOM_ADV_COLLINEAR, 1), bool)
    hazards = {}
    for dt, npdt in types:
        t = [dev(x, npdt) for x in (a1[:, None], b1[:, None], one,
                                    a2[:, None], b2[:, None], one)]
        k = edges_cross(*t)
        check(torch.equal(k, edges_cross_ref(*t)), f"K13 differs from its "
              f"plain version on the collinear disjoint pairs {dt}")
        hazards[str(dt).split(".")[-1]] = int(k.diagonal().sum())
    out = {"k12_shapes": len(GEOM_ADV_K12), "k13_shapes": len(GEOM_ADV_K13),
           "collinear_pairs": GEOM_ADV_COLLINEAR,
           "collinear_true": hazards}
    log(f"[geometry] adversarial set: K12 (three instances) on "
        f"{GEOM_ADV_K12} (N, G, E) and K13 on {GEOM_ADV_K13} (G1, E1, G2, "
        f"E2) and {GEOM_ADV_COLLINEAR} collinear disjoint pairs, f64 and "
        f"f32, bit-equal to the plain versions; the plain version calls "
        f"{hazards} of the disjoint pairs crossing")
    return out


def first_zone(inside):
    """[N] the first set column of each row of ``inside``, -1 where none
    (the oracle's first-match rule)."""
    import torch
    hit = inside.any(1)
    return torch.where(hit, inside.to(torch.int8).argmax(1),
                       torch.full_like(hit, -1, dtype=torch.int64))


def boundary_gap(arr_a, ia: int, arr_b, ib: int) -> float:
    """The f64 distance between the boundaries of two polygons: the least
    vertex-to-edge distance either way."""
    import numpy as np
    from mosaic_tpu_torch.core.geometry.clip import (_edges_of,
                                                     _seg_point_dist,
                                                     geometry_rings)
    ra, rb = geometry_rings(arr_a, ia), geometry_rings(arr_b, ib)
    va, vb = np.concatenate(ra), np.concatenate(rb)
    return float(min(_seg_point_dist(va, _edges_of(rb)).min(),
                     _seg_point_dist(vb, _edges_of(ra)).min()))


def phase_geometry(zones, grid):
    """The geometry surface on the card: K11 on footprints and counties,
    K12 on the flagship's points against its zones, K13 with K12 on the
    counties' adjacency and the footprints against the zones, each held to
    its plain version and to the host's f64 answer; ``raster_to_grid`` on
    a UTM tile through ``warp``; the three kernels timed."""
    import numpy as np
    import torch
    import mosaic_tpu_torch as mt
    from mosaic_tpu_torch.bench.workloads import conus_counties, footprints
    from mosaic_tpu_torch.core.geometry import measures, predicates
    from mosaic_tpu_torch.core.geometry.crs import transform_xy
    from mosaic_tpu_torch.core.geometry.padded import build_edges
    from mosaic_tpu_torch.ops.edge_measures import edge_measures_ref
    from mosaic_tpu_torch.ops.edge_point import (edge_point_query,
                                                 edge_point_query_ref)
    from mosaic_tpu_torch.ops.edges_cross import edges_cross, edges_cross_ref
    from mosaic_tpu_torch.parallel.overlay import overlay_host_truth
    t_phase = time.perf_counter()
    paths = {}
    out = {}
    rng = np.random.default_rng(GEOM_SEED)
    f64, f32 = torch.float64, torch.float32

    # 1. measures (K11)
    foot = footprints(GEOM_FOOTPRINTS, seed=41)
    counties = conus_counties(n_side=GEOM_COUNTY_SIDE)
    meas_f = geom_measures("footprints", foot, "geometry measures "
                           "footprints", paths)
    meas_c = geom_measures("counties", counties, "geometry measures "
                           "counties", paths)
    out["measures"] = {"footprints": {k: v for k, v in meas_f.items()
                                      if k != "blocks"},
                       "counties": {k: v for k, v in meas_c.items()
                                    if k != "blocks"}}

    # 2. point queries (K12): the flagship's points x its zones
    pts64 = mt.nyc_points(GEOM_POINTS, seed=GEOM_POINT_SEED)
    ez = {dt: build_edges(zones, dtype=dt, device=DEV) for dt in (f64, f32)}
    t0 = time.perf_counter()
    oracle = mt.pip_host_truth(pts64, zones)
    oracle_s = time.perf_counter() - t0
    sample = np.sort(rng.choice(GEOM_POINTS, GEOM_SAMPLE, replace=False))
    sample_t = torch.from_numpy(sample).to(DEV)
    gap64 = None
    out["points"] = {"points": GEOM_POINTS, "zones": len(zones),
                     "edge_slots": int(ez[f64].capacity),
                     "oracle_s": round(oracle_s, 3)}
    for dt in (f64, f32):
        name = str(dt).split(".")[-1]
        e = ez[dt]
        p = torch.from_numpy(pts64).to(dt).to(DEV)
        path = f"geometry points {name}"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inside, bdist = predicates.points_in_polygons(
            p, e, with_boundary_dist=True)
        dist = measures.distance_points_to_geoms(p, e)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        paths[path] = launch_counts()
        check(paths[path]["edge_point_query"] == 2,
              f"{path}: {paths[path]['edge_point_query']} K12 launches for "
              "points_in_polygons and distance_points_to_geoms")
        check(same_bits(bdist, dist), f"{path}: the boundary distance of "
              "points_in_polygons differs from distance_points_to_geoms")
        # the plain version on every row, in row chunks: the main path's
        # count and distance launch, its distance launch (same_bits above)
        # and K12's count instance on each chunk
        for s0 in range(0, GEOM_POINTS, GEOM_CHUNK):
            rows = slice(s0, s0 + GEOM_CHUNK)
            pc, pd = edge_point_query_ref(p[rows], e.a, e.b, e.mask, True,
                                          True)
            kc, _ = edge_point_query(p[rows], e.a, e.b, e.mask, True, False)
            check(torch.equal(kc, pc), f"{path}: K12's counts differ from "
                  "the plain version's")
            check(torch.equal(inside[rows], (pc & 1).to(torch.bool)),
                  f"{path}: containment differs from the plain version's")
            check(same_bits(bdist[rows], pd), f"{path}: K12's distances "
                  "differ from the plain version's")
        first = first_zone(inside).cpu().numpy()
        if dt == f64:
            gap64 = bdist.min(1).values.cpu().numpy()
        band = GEOM_BAND[name]
        far = gap64 > band
        wrong = first != oracle
        check(not (wrong & far).any(), f"{path}: {int((wrong & far).sum())} "
              f"points beyond {band} degrees of a zone boundary differ "
              "from pip_host_truth")
        row = {"seconds": round(call_s, 4), "band_deg": band,
               "in_band": int((~far).sum()),
               "in_band_differing": int((wrong & ~far).sum()),
               "matched": int((first >= 0).sum())}
        out["points"][name] = row
        log(f"[geometry] {path}: {GEOM_POINTS} points x {len(zones)} zones "
            f"({e.capacity} edge slots) in {call_s:.3f} s (host clock, "
            f"two K12 launches); all {GEOM_POINTS} rows bit-equal to "
            f"the plain version; first zone equal to pip_host_truth on all "
            f"{int(far.sum())} points beyond {band} degrees of a boundary, "
            f"{row['in_band']} within it ({row['in_band_differing']} of "
            f"them differing); pip_host_truth {oracle_s:.2f} s")
        del inside, bdist, dist

    # 3. polygon predicates (K13 with K12)
    ec = {dt: build_edges(counties, dtype=dt, device=DEV)
          for dt in (f64, f32)}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inter = predicates.polygons_intersect(ec[f64], ec[f64])
    contains = predicates.polygon_contains_polygon(ec[f64], ec[f64])
    torch.cuda.synchronize()
    county_s = time.perf_counter() - t0
    path = "geometry counties"
    paths[path] = launch_counts()
    check(paths[path]["edges_cross"] == 2 and
          paths[path]["edge_point_query"] == 3,
          f"{path}: {paths[path]['edges_cross']} K13 and "
          f"{paths[path]['edge_point_query']} K12 launches, expected 2 "
          "and 3")
    n_c = len(counties)
    degree = inter.sum(1) - 1
    check(torch.equal(inter, inter.T) and bool(inter.diagonal().all()),
          "counties: polygons_intersect is not symmetric with a true "
          "diagonal")
    check(int(degree.min()) >= 1, "counties: a county touches no other")
    check(int(contains.sum()) == 0, f"counties: {int(contains.sum())} "
          "pairs of a partition contain one another")
    out["counties"] = {"polygons": n_c, "edge_slots": int(ec[f64].capacity),
                       "seconds": round(county_s, 4),
                       "adjacent_pairs": int((inter.sum() - n_c) // 2),
                       "degree_mean": float(degree.double().mean()),
                       "degree_max": int(degree.max())}
    log(f"[geometry] counties: polygons_intersect and "
        f"polygon_contains_polygon on {n_c}^2 pairs in {county_s:.3f} s "
        f"(host clock; 2 K13, 3 K12 launches): "
        f"{out['counties']['adjacent_pairs']} adjacent pairs, degree mean "
        f"{out['counties']['degree_mean']:.2f} max "
        f"{out['counties']['degree_max']}; no county contains another")

    foot14 = footprints(GEOM_PRED_FOOTPRINTS, seed=41)
    ef = {dt: build_edges(foot14, dtype=dt, device=DEV) for dt in (f64, f32)}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fz = predicates.polygons_intersect(ef[f64], ez[f64])
    torch.cuda.synchronize()
    fz_s = time.perf_counter() - t0
    path = "geometry footprints x zones"
    paths[path] = launch_counts()
    check(paths[path]["edges_cross"] == 1 and
          paths[path]["edge_point_query"] == 2,
          f"{path}: {paths[path]['edges_cross']} K13 and "
          f"{paths[path]['edge_point_query']} K12 launches, expected 1 "
          "and 2")
    t0 = time.perf_counter()
    truth = overlay_host_truth(foot14, zones)
    truth_s = time.perf_counter() - t0
    diff = np.argwhere(fz.cpu().numpy() != truth)
    for i, j in diff:
        gap = boundary_gap(foot14, int(i), zones, int(j))
        log(f"[geometry] footprints x zones: pair ({i}, {j}) card "
            f"{bool(fz[i, j])} host {bool(truth[i, j])}; boundary gap "
            f"{gap:.3e}")
        check(gap <= GEOM_TOUCH_DEG, f"footprints x zones: pair ({i}, {j}) "
              "differs from overlay_host_truth and is no boundary touch")
    out["footprints_x_zones"] = {
        "pairs": int(fz.numel()), "intersecting": int(fz.sum()),
        "differing": len(diff), "seconds": round(fz_s, 4),
        "host_truth_s": round(truth_s, 3)}
    log(f"[geometry] footprints x zones: {GEOM_PRED_FOOTPRINTS} x "
        f"{len(zones)} in {fz_s:.3f} s (host clock; 1 K13, 2 K12 "
        f"launches), {int(fz.sum())} intersecting; {len(diff)} pairs "
        f"differ from overlay_host_truth ({truth_s:.2f} s), each a "
        "boundary touch")

    # K13 against its plain version on every row of each G1, in
    # GEOM_PLAIN_ROWS-row chunks of one whole-matrix launch; and on a
    # seeded GEOM_PLAIN_ROWS-row sample of G1 launched alone, with the
    # composed predicate, f64 and f32
    for label, e1, e2, main in (("counties", ec, ec, inter),
                                ("footprints x zones", ef, ez, fz)):
        for dt in (f64, f32):
            x1, x2 = e1[dt], e2[dt]
            whole = edges_cross(x1.a, x1.b, x1.mask, x2.a, x2.b, x2.mask)
            for s0 in range(0, x1.a.shape[0], GEOM_PLAIN_ROWS):
                r = slice(s0, s0 + GEOM_PLAIN_ROWS)
                check(torch.equal(whole[r], edges_cross_ref(
                    x1.a[r], x1.b[r], x1.mask[r], x2.a, x2.b, x2.mask)),
                      f"{label} {dt}: K13 differs from its plain version "
                      f"in rows {s0}-")
            del whole
        rows = torch.from_numpy(np.sort(rng.choice(
            e1[f64].a.shape[0], GEOM_PLAIN_ROWS, replace=False))).to(DEV)
        for dt in (f64, f32):
            a1, b1, m1 = e1[dt].a[rows], e1[dt].b[rows], e1[dt].mask[rows]
            a2, b2, m2 = e2[dt].a, e2[dt].b, e2[dt].mask
            k = edges_cross(a1, b1, m1, a2, b2, m2)
            plain = edges_cross_ref(a1, b1, m1, a2, b2, m2)
            check(torch.equal(k, plain), f"{label} {dt}: K13 differs from "
                  "its plain version")
            if dt == f64:
                v1 = predicates.first_vertex(e1[dt])[rows]
                v2 = predicates.first_vertex(e2[dt])
                c12, _ = edge_point_query_ref(v1, a2, b2, m2)
                c21, _ = edge_point_query_ref(v2, a1, b1, m1)
                composed = plain | (c12 & 1).bool() | (c21 & 1).bool().T
                check(torch.equal(composed, main[rows]), f"{label}: "
                      "polygons_intersect differs from its plain "
                      "composition")
    log(f"[geometry] K13 bit-equal to its plain version on every row of "
        f"the counties ({n_c}) and the footprints ({GEOM_PRED_FOOTPRINTS}) "
        f"and on {GEOM_PLAIN_ROWS} sampled rows launched alone, in f64 and "
        "f32, and polygons_intersect to the plain composition in f64")
    out["adversarial"] = geom_adversarial()
    out["k11_adversarial"] = k11_adversarial()

    # 4. an entry point through the new modules: config 5's DEM in UTM
    x0, y0 = transform_xy(np.array([[DEM_GT[0], DEM_GT[3]]]), 4326,
                          UTM_EPSG)[0]
    yy, xx = np.mgrid[0:DEM_SHAPE[0], 0:DEM_SHAPE[1]]
    utm = mt.RasterTile((np.sin(xx / 60.0) * 50 + yy * 0.1)[None],
                        mt.GeoTransform(float(x0), UTM_PIXEL, 0.0, float(y0),
                                        0.0, -UTM_PIXEL), srid=UTM_EPSG)
    cells, utm_s, utm_stages, paths["raster utm"], _ = raster_run(
        "utm", [utm], grid)
    t0 = time.perf_counter()
    cpu = mt.raster_to_grid([utm], R2G_RES, grid, combiner="avg",
                            device="cpu")
    cpu_s = time.perf_counter() - t0
    check(same_values(cells, cpu), "utm: the card's cells differ from the "
          "device='cpu' call's")
    out["raster_utm"] = {"cells": len(cells), "seconds": round(utm_s, 4),
                         "cpu_seconds": round(cpu_s, 3),
                         "k3_launches": paths["raster utm"][
                             "h3_latlng_to_cell"]}
    log(f"[geometry] utm: config 5's DEM in EPSG:{UTM_EPSG} ({UTM_PIXEL} m "
        f"pixels) warped on the host and tessellated on the card: "
        f"{len(cells)} cells in {utm_s:.3f} s, bit-equal to the "
        f"device='cpu' call ({cpu_s:.3f} s)")

    # 5. timing, each kernel in turns against its plain version
    ef64 = meas_f["blocks"][f64]
    ms, source, events_ms, host_ms, plain_ms = timed_kernel(
        "K11 centroid f64 footprints",
        lambda: measures.centroid(ef64),
        lambda: edge_measures_ref(ef64.a, ef64.b, ef64.mask, "centroid"),
        "measures_", 5)
    b_cen = k11_bound(ef64, "centroid")
    out["k11"] = {"max_abs_err": 0.0, "ms": ms, "ms_source": source,
                  "host_ms": host_ms, "plain_ms": plain_ms,
                  "bound_ms": b_cen["bound_ms"],
                  "bound_by": b_cen["bound_by"], "library_ms": None,
                  "shape": f"centroid, {GEOM_FOOTPRINTS} footprints x "
                           f"{ef64.capacity} slots, f64"}
    # every measure, type and set: the profiler's device time, its bound
    # from this run's blocks, the share and the wrapper's host enqueue
    cases = {}
    for set_label, meas in (("footprints", meas_f), ("counties", meas_c)):
        for dt in (f64, f32):
            e = meas["blocks"][dt]
            for w in GEOM_MEASURES:
                fn = lambda e=e, w=w: getattr(measures, w)(e)  # noqa: E731
                k_ms, k_src = kernel_device_ms(fn, 50, "measures_")
                bound = k11_bound(e, w)
                key = f"{w} {str(dt).split('.')[-1]} {set_label}"
                cases[key] = {"ms": k_ms, "ms_source": k_src,
                              "host_ms": host_ms_per_launch(fn, 200),
                              "bound_ms": bound["bound_ms"],
                              "bound_by": bound["bound_by"],
                              "bytes": bound["bytes"],
                              "share": bound["bound_ms"] / k_ms}
                log(f"[geometry] K11 {key}: {k_ms:.4f} ms ({k_src}), bound "
                    f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
                    f"{bound['bytes']} bytes), share "
                    f"{cases[key]['share']:.3f}, host enqueue "
                    f"{cases[key]['host_ms']:.4f} ms a call")
    out["k11"]["cases"] = cases
    log(f"[geometry] K11 {out['k11']['shape']}: {ms:.4f} ms against its "
        f"byte bound {out['k11']['bound_ms']:.4f} ms")

    p64 = torch.from_numpy(pts64).to(DEV)
    ps = p64[sample_t]
    e = ez[f64]
    ms, source, events_ms, host_ms, plain_ms = timed_kernel(
        "K12 count+dist f64 sample",
        lambda: edge_point_query(ps, e.a, e.b, e.mask, True, True),
        lambda: edge_point_query_ref(ps, e.a, e.b, e.mask, True, True),
        "query_tile_kernel", 1)
    b_s = k12_bound(ps, e)
    full_ms = time_ms(lambda: edge_point_query(p64, e.a, e.b, e.mask, True,
                                               True), 3)
    b_full = k12_bound(p64, e)
    p32 = p64.to(f32)
    full32_ms = time_ms(lambda: edge_point_query(
        p32, ez[f32].a, ez[f32].b, ez[f32].mask, True, True), 3)
    b_full32 = k12_bound(p32, ez[f32])
    out["k12"] = {"max_abs_err": 0.0, "ms": ms, "ms_source": source,
                  "host_ms": host_ms, "plain_ms": plain_ms,
                  "bound_ms": b_s["bound_ms"], "bound_by": b_s["bound_by"],
                  "library_ms": None,
                  "shape": f"count and distance, {GEOM_SAMPLE} points x "
                           f"{len(zones)} zones x {e.capacity} slots, f64",
                  "work": {k: b_s[k] for k in ("ops", "bytes",
                                               "straddles")},
                  "full_f64": {"ms": full_ms, "bound_ms": b_full["bound_ms"],
                               "ops": b_full["ops"]},
                  "full_f32": {"ms": full32_ms,
                               "bound_ms": b_full32["bound_ms"],
                               "ops": b_full32["ops"]}}
    log(f"[geometry] K12 {out['k12']['shape']}: {ms:.4f} ms, bound "
        f"{b_s['bound_ms']:.4f} ms ({b_s['bound_by']}; {b_s['straddles']} "
        f"straddling pairs); at all {GEOM_POINTS} points (events, 3 "
        f"launches): f64 {full_ms:.3f} ms (bound "
        f"{b_full['bound_ms']:.3f}), f32 {full32_ms:.3f} ms (bound "
        f"{b_full32['bound_ms']:.3f})")

    rows = torch.from_numpy(np.sort(rng.choice(
        len(counties), GEOM_PLAIN_ROWS, replace=False))).to(DEV)
    e1 = ec[f64]
    a1, b1, m1 = e1.a[rows], e1.b[rows], e1.mask[rows]
    ms, source, events_ms, host_ms, plain_ms = timed_kernel(
        "K13 counties f64 sample",
        lambda: edges_cross(a1, b1, m1, e1.a, e1.b, e1.mask),
        lambda: edges_cross_ref(a1, b1, m1, e1.a, e1.b, e1.mask),
        "cross_tile_kernel", 1)
    cross_s = edges_cross(a1, b1, m1, e1.a, e1.b, e1.mask)
    b_s = k13_bound(type(e1)(a1, b1, m1), e1, cross_s)
    full_ms = time_ms(lambda: predicates.edges_cross_matrix(e1, e1), 5)
    b_full = k13_bound(e1, e1, predicates.edges_cross_matrix(e1, e1))
    out["k13"] = {"max_abs_err": 0.0, "ms": ms, "ms_source": source,
                  "host_ms": host_ms, "plain_ms": plain_ms,
                  "bound_ms": b_s["bound_ms"], "bound_by": b_s["bound_by"],
                  "library_ms": None,
                  "shape": f"{GEOM_PLAIN_ROWS} sampled counties x "
                           f"{len(counties)} x {e1.capacity}^2 slots, f64",
                  "work": {k: b_s[k] for k in ("edge_pair_tests", "ops",
                                               "bytes")},
                  "full_f64": {"ms": full_ms, "bound_ms": b_full["bound_ms"],
                               "edge_pair_tests": b_full["edge_pair_tests"]}}
    log(f"[geometry] K13 {out['k13']['shape']}: {ms:.4f} ms, bound "
        f"{b_s['bound_ms']:.4f} ms ({b_s['bound_by']}); all {n_c}^2 pairs "
        f"(events, 5 launches): {full_ms:.3f} ms, bound "
        f"{b_full['bound_ms']:.3f} ms ({b_full['edge_pair_tests']:.4g} "
        "edge-pair tests)")
    # the torch-op helpers (no kernels): their device time beside the
    # bytes they must move
    ops = {}
    fv_bytes = e1.mask.numel() + e1.a.shape[0] * 2 * 8 * 2
    ops["first_vertex"] = (time_ms(lambda: predicates.first_vertex(e1), 20),
                           fv_bytes, f"{n_c} counties x {e1.capacity} slots")
    pa, pb = p64[:GEOM_PAIRWISE], p64[GEOM_PAIRWISE:2 * GEOM_PAIRWISE]
    ops["pairwise_point_distance"] = (
        time_ms(lambda: measures.pairwise_point_distance(pa, pb), 20),
        2 * GEOM_PAIRWISE * 16 + GEOM_PAIRWISE ** 2 * 8,
        f"{GEOM_PAIRWISE} x {GEOM_PAIRWISE} points")
    lat1, lng1 = p64[:, 1], p64[:, 0]
    lat2, lng2 = p64.flip(0)[:, 1], p64.flip(0)[:, 0]
    ops["haversine"] = (
        time_ms(lambda: measures.haversine(lat1, lng1, lat2, lng2), 20),
        5 * GEOM_POINTS * 8, f"{GEOM_POINTS} point pairs")
    out["torch_ops"] = {k: {"ms": v[0], "bound_ms": v[1] / PEAK_BYTES * 1e3,
                            "bound_by": "bytes", "shape": v[2]}
                        for k, v in ops.items()}
    log(f"[geometry] torch ops, f64 (events, 20 calls): "
        f"{out['torch_ops']}")
    out["phase_s"] = round(time.perf_counter() - t_phase, 1)
    out["paths"] = paths
    log(f"[geometry] phase 18 took {out['phase_s']} s (host clock)")
    return out


def halo_seams(tile, w) -> dict:
    """K9 on SHARD_SLABS row slabs of the tile's first SHARD_HALO_ROWS
    rows, each widened by the halo rows a rank would receive (zero rows
    past the ends), cropped and stacked: bit-equal to K9 on those rows
    whole, as the multi-rank halo needs."""
    import numpy as np
    import torch
    from mosaic_tpu_torch.ops.raster_convolve import raster_convolve
    x = np.where(tile.valid_mask(), np.asarray(tile.data, np.float32),
                 np.float32(0.0))[:, :SHARD_HALO_ROWS]
    x = torch.from_numpy(x).to(DEV)
    wt = torch.from_numpy(np.asarray(w, np.float32)).to(DEV)
    halo = w.shape[0] // 2
    S = SHARD_HALO_ROWS // SHARD_SLABS
    padded = torch.nn.functional.pad(x, (0, 0, halo, halo))
    parts = [raster_convolve(padded[:, r * S:(r + 1) * S + 2 * halo], wt)
             [:, halo:halo + S] for r in range(SHARD_SLABS)]
    whole = raster_convolve(x, wt)
    ok = same_bits(torch.cat(parts, dim=1), whole)
    log(f"[sharded] K9 on {SHARD_SLABS} widened slabs of {S} rows: "
        f"{'bit-equal' if ok else 'DIFFERENT'} to the whole "
        f"{SHARD_HALO_ROWS}-row tile")
    check(ok, "K9 on widened slabs differs from the whole tile")
    return {"slabs": SHARD_SLABS, "rows": SHARD_HALO_ROWS,
            "bit_equal": ok}


def kernel_line(name, source, replaces, launches, k, by_path) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "ms_source": k["ms_source"], "host_ms": k["host_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
            **({"torch_ops_join_ms": k["torch_ops_join_ms"]}
               if "torch_ops_join_ms" in k else {})}


def main() -> int:
    if not (ROOT / "mosaic_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the mosaic_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    try:
        import torch
        name, card = phase_device()
        phase_build()
        import mosaic_tpu_torch as mt
        from mosaic_tpu_torch.parallel.pip_join import _workload_origin
        origin = tuple(float(v) for v in _workload_origin(mt.taxi_zones(16)))
        flops_pt, issued_pt = flops_per_point(RES, origin)
        kern = phase_kernel(origin, flops_pt, issued_pt)
        phase_df_contract()
        launches, idx, grid, batches, rechecked, dense_zones, polys, chips = \
            phase_flagship()
        join = phase_join_kernel(idx, grid, polys, batches, rechecked,
                                 flops_pt)
        cell = phase_cell_kernel(cell_ops_per_point(RES))
        custom = phase_sorted_custom()
        h3s = phase_sorted_h3(polys, grid, chips, batches[0],
                              dense_zones[0])
        bng = phase_sorted_bng()
        over = phase_overlay(polys, grid)
        knn = phase_knn()
        chip = phase_chips()
        strat = phase_strategies(idx, grid, polys, batches, dense_zones)
        raster = phase_raster(grid)
        shard = phase_sharded(idx, grid, polys, batches, dense_zones, h3s,
                              over, knn, raster)
        store = phase_store(idx, grid, polys)
        geom = phase_geometry(polys, grid)
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    paths = {"dense flagship": launches, "custom sorted": custom["counts"],
             "h3 sorted": h3s["counts"], "bng sorted": bng["counts"],
             "overlay intersects": over["counts_intersects"],
             "overlay area": over["counts_area"],
             "knn brute": knn["paths"]["brute"]["counts"],
             "knn ring": knn["paths"]["ring"]["counts"],
             **chip["tess_counts"], **strat["paths"], **raster["paths"],
             **shard["counts"], **{p: c for p, c in store["counts"].items()
                                   if p.startswith("store fed")},
             **geom["paths"]}

    def by_path(kernel):
        return {p: c[kernel] for p, c in paths.items()}

    log(json.dumps({"sorted": {
        p: {k: r[k] for k in ("uncertain", "pps", "body_device_ms",
                              "body_bound_ms", "body_host_ms",
                              "body_aten_ops",
                              "recheck_host_ms", "flagged_per_chunk",
                              "profile") if k in r}
        for p, r in (("custom", custom), ("h3", h3s), ("bng", bng))}}))
    log(json.dumps({"overlay": {k: v for k, v in over.items()
                                if k not in ("kernel", "prep", "counts_intersects",
                                             "counts_area", "shard_inputs")}}))
    log(json.dumps({"knn": knn["paths"]}))
    log(json.dumps({"chips": {k: v for k, v in chip.items()
                              if k not in ("k7", "k8", "tess_counts")}}))
    log(json.dumps({"strategies": {k: v for k, v in strat.items()
                                   if k != "paths"}}))
    log(json.dumps({"raster": {k: v for k, v in raster.items()
                               if k not in ("paths", "halo_inputs")}}))
    log(json.dumps({"sharded": {k: v for k, v in shard.items()
                                if k != "counts"}}))
    log(json.dumps({"store": {k: v for k, v in store.items()
                              if k != "counts"}}))
    log(json.dumps({"geometry": {k: v for k, v in geom.items()
                                 if k not in ("paths", "k11", "k12",
                                              "k13")}}))
    log(f"[chip_smoke] phases 1-18 took {time.perf_counter() - t_start:.1f} "
        "s (host clock)")
    log(json.dumps({"tess_kernels": {
        name: {label: {k: v for k, v in row.items() if k != "work"}
               for label, row in chip[key]["shapes"].items()}
        for name, key in (("tess_classify", "k7"), ("tess_clip", "k8"))}}))
    log(card)
    log(json.dumps({"kernels": [
        kernel_line("h3_project_lattice",
                    "mosaic_tpu_torch/csrc/h3_projection.cu",
                    "mosaic_tpu/ops/pallas_projection.py:228",
                    launches["h3_project_lattice"], kern,
                    by_path("h3_project_lattice")),
        kernel_line("h3_dense_join",
                    "mosaic_tpu_torch/csrc/h3_dense_join.cu",
                    "mosaic_tpu/ops/pallas_projection.py:228 + "
                    "mosaic_tpu/parallel/pip_join.py:1689",
                    launches["h3_dense_join"], join,
                    by_path("h3_dense_join")),
        kernel_line("h3_latlng_to_cell",
                    "mosaic_tpu_torch/csrc/h3_cell.cu",
                    "mosaic_tpu/core/index/h3/jaxkernel.py:383",
                    h3s["counts"]["h3_latlng_to_cell"], cell,
                    by_path("h3_latlng_to_cell")),
        kernel_line("overlay_pairs",
                    "mosaic_tpu_torch/csrc/overlay_pairs.cu",
                    "mosaic_tpu/parallel/overlay.py:182 (under :245 and "
                    ":367)",
                    over["counts_intersects"]["overlay_pairs"] +
                    over["counts_area"]["overlay_pairs"], over["kernel"],
                    by_path("overlay_pairs")),
        kernel_line("overlay_prep_b",
                    "mosaic_tpu_torch/csrc/overlay_pairs.cu",
                    "mosaic_tpu/parallel/overlay.py:182 (the edge lengths "
                    "of _chip_pair_test)",
                    over["counts_intersects"]["overlay_prep_b"] +
                    over["counts_area"]["overlay_prep_b"], over["prep"],
                    by_path("overlay_prep_b")),
        kernel_line("knn_brute_topk",
                    "mosaic_tpu_torch/csrc/knn_brute_topk.cu",
                    "mosaic_tpu/models/knn.py:485",
                    knn["paths"]["brute"]["counts"]["knn_brute_topk"],
                    knn["k5"], by_path("knn_brute_topk")),
        kernel_line("knn_ring_step",
                    "mosaic_tpu_torch/csrc/knn_ring_step.cu",
                    "mosaic_tpu/models/knn.py:285",
                    knn["paths"]["ring"]["counts"]["knn_ring_step"],
                    knn["k6"], by_path("knn_ring_step")),
        kernel_line("tess_classify",
                    "mosaic_tpu_torch/csrc/tess_classify.cu",
                    "mosaic_tpu/core/tessellate.py:330 + :102 (tess/parity "
                    "and tess/pair_check under classify_cells_multi :385)",
                    chip["counts"]["tess_classify"], chip["k7"],
                    by_path("tess_classify")),
        kernel_line("tess_clip", "mosaic_tpu_torch/csrc/tess_clip.cu",
                    "mosaic_tpu/core/tessellate.py:488 (tess/clip)",
                    chip["counts"]["tess_clip"], chip["k8"],
                    by_path("tess_clip")),
        kernel_line("raster_convolve",
                    "mosaic_tpu_torch/csrc/raster_convolve.cu",
                    "mosaic_tpu/core/raster/rops.py:318 (convolve) + "
                    "mosaic_tpu/parallel/raster_halo.py:30 (_convolve_fn)",
                    sum(raster["paths"][p]["raster_convolve"]
                        for p in ("raster convolve srtm", "raster halo dem",
                                  "raster halo srtm")),
                    raster["k9"]["f64 3x3 srtm"], by_path("raster_convolve")),
        kernel_line("raster_combine",
                    "mosaic_tpu_torch/csrc/raster_combine.cu",
                    "mosaic_tpu/core/raster/rops.py:188 (combine)",
                    raster["paths"]["raster srtm"]["raster_combine"],
                    raster["k10"]["avg"], by_path("raster_combine")),
        kernel_line("edge_measures",
                    "mosaic_tpu_torch/csrc/edge_measures.cu",
                    "mosaic_tpu/core/geometry/measures.py:27 (area), :37 "
                    "(length), :43 (centroid), :64 (bounds)",
                    sum(c["edge_measures"] for p, c in geom["paths"].items()),
                    geom["k11"], by_path("edge_measures")),
        kernel_line("edge_point_query",
                    "mosaic_tpu_torch/csrc/edge_point_query.cu",
                    "mosaic_tpu/core/geometry/predicates.py:26 "
                    "(crossing_number), :42 (points_in_polygons) + "
                    "mosaic_tpu/core/geometry/measures.py:94 "
                    "(distance_points_to_geoms)",
                    sum(c["edge_point_query"]
                        for p, c in geom["paths"].items()),
                    geom["k12"], by_path("edge_point_query")),
        kernel_line("edges_cross", "mosaic_tpu_torch/csrc/edges_cross.cu",
                    "mosaic_tpu/core/geometry/predicates.py:84 "
                    "(edges_cross_matrix over :63 segments_intersect)",
                    sum(c["edges_cross"] for p, c in geom["paths"].items()),
                    geom["k13"], by_path("edges_cross"))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
