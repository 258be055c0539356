"""Out-of-core chip store: grid-partitioned columnar shards.

The store persists point datasets as a fixed world-grid partitioning —
each non-empty grid cell owns one partition of row-sharded, raw
little-endian column files — under a versioned JSON manifest carrying
every partition's bbox, row count, and the dtype schema
(:mod:`.manifest`).  A writer ingests from arrays or any codec that
yields point blocks (:mod:`.writer`, atomic tmp+rename); a reader
prunes partitions against a query bbox from the manifest alone —
before a single data byte moves — and yields bounded chunks lazily into
:func:`mosaic_tpu_torch.perf.pipeline.stream` (:mod:`.reader`,
torn-shard degrade per the codec ``on_error`` convention).
:mod:`.pushdown` extracts the bbox from a SQL ``WHERE`` clause so a
store scan prunes without user annotations.

Reference shape: partition-parallel spatial joins over pre-partitioned
on-disk data (arxiv 1908.11740); the per-partition stats persisted
here are the substrate for learned layouts (arxiv 2504.01292,
``sql/layout.py``).

Port of ``mosaic_tpu.store``: stores are interchangeable between the two
packages, file for file.  The fault probes and recorder events of the
JAX package's store are not ported (ROADMAP C11).
"""

from .manifest import Manifest, Partition, grid_cells, cell_bbox
from .reader import ChipStore, StoreChunk
from .writer import StoreWriter, write_store, write_store_from_chunks
from .pushdown import bbox_from_where

__all__ = ["Manifest", "Partition", "grid_cells", "cell_bbox",
           "ChipStore", "StoreChunk", "StoreWriter", "write_store",
           "write_store_from_chunks", "bbox_from_where"]
