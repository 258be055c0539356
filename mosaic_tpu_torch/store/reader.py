"""Read side of the chip store: manifest-driven pruning + lazy chunks.

:class:`ChipStore` opens a store by loading its manifest only — no
data bytes move until a partition is actually read.  :meth:`prune`
intersects the query bbox with every partition's recorded bbox (pure
manifest arithmetic; ``store/partitions_pruned`` counts what it
discarded), and :meth:`iter_chunks` is a GENERATOR that walks the
surviving partitions shard by shard, assembling bounded point chunks
for :func:`mosaic_tpu_torch.perf.pipeline.stream` — at no moment does more
than one shard plus one chunk of carry-over live on the host, so a
store bigger than RAM streams through a fixed-size window.

Torn shards (file shorter than the manifest's row count — a crash,
truncation, or injected ``store.shard`` corruption) degrade per the
codec ``on_error`` convention: ``raise`` surfaces a located
:class:`~mosaic_tpu_torch.resilience.ingest.CodecError`, ``skip`` drops
the incomplete tail rows, ``null`` zero-fills them; either degrade path
counts ``store/shards_torn`` and flight-records ``store_shard_torn``.

Port copy of ``mosaic_tpu.store.reader``: the same rows, chunks, spans
and torn-tail behaviour, the same ``store.read``/``store.shard`` fault
sites, and the same in-flight partition notes (``note_partitions``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics
from ..obs.heat import heat
from ..obs.inflight import note_partitions
from ..obs.recorder import recorder
from ..resilience import faults
from ..resilience.ingest import CodecError, ON_ERROR_MODES
from .manifest import Manifest, Partition, bbox_intersects, shard_path

__all__ = ["ChipStore", "StoreChunk"]


@dataclasses.dataclass(frozen=True)
class StoreChunk:
    """One streamed unit: a bounded block of points plus the
    provenance needed to attribute its bytes per partition."""

    offset: int               # row offset within this scan's output
    points: np.ndarray        # (n, 2) float64 [x, y]
    parts: Tuple[Tuple[int, int], ...]   # (cell, rows) spans, in order

    @property
    def rows(self) -> int:
        return self.points.shape[0]


class ChipStore:
    """A readable chip store rooted at ``root`` (see :mod:`.writer`)."""

    def __init__(self, root: str, *, mmap: Optional[bool] = None,
                 on_error: Optional[str] = None):
        from .. import config as _config
        cfg = _config.default_config()
        self.root = str(root)
        self.mmap = cfg.store_mmap if mmap is None else bool(mmap)
        self.on_error = on_error or cfg.io_on_error
        if self.on_error not in ON_ERROR_MODES:
            raise ValueError(f"on_error={self.on_error!r} invalid "
                             f"(choose from {ON_ERROR_MODES})")
        self.manifest = Manifest.load(self.root)

    # -- manifest views ----------------------------------------------
    @property
    def point_cols(self) -> Tuple[str, str]:
        return self.manifest.point_cols

    @property
    def total_rows(self) -> int:
        return self.manifest.total_rows

    @property
    def bbox(self) -> Tuple[float, float, float, float]:
        return self.manifest.bbox

    @property
    def partitions(self) -> List[Partition]:
        return self.manifest.partitions

    def nbytes(self) -> int:
        """The dataset's in-RAM size per the manifest (rows x row
        width) — the out-of-core bench's comparison denominator."""
        width = sum(np.dtype(d).itemsize
                    for d in self.manifest.columns.values())
        return self.total_rows * width

    # -- pruning -----------------------------------------------------
    def prune(self, bbox=None, record: bool = True) -> List[Partition]:
        """Partitions a query over ``bbox`` must scan — manifest
        arithmetic only, no data reads.  Closed-interval overlap, so
        the survivors are always a superset of the partitions holding
        matching rows (pruning can over-scan, never drop)."""
        parts = self.manifest.partitions
        if bbox is None:
            scanned = list(parts)
        else:
            scanned = [p for p in parts if bbox_intersects(p.bbox, bbox)]
        if record and metrics.enabled:
            metrics.count("store/partitions_scanned", len(scanned))
            metrics.count("store/partitions_pruned",
                          len(parts) - len(scanned))
        return scanned

    # -- shard IO ----------------------------------------------------
    def _shard_bytes(self, path: str) -> bytes:
        """Raw shard payload: a zero-copy view of the mmap'd file, or
        the file's bytes when ``mmap`` is off.  With a fault plan armed
        the bytes route through ``faults.corrupt`` (a memoryview cannot
        be truncated in place), so chaos drills always bite."""
        faults.maybe_fail("store.read")
        try:
            if self.mmap and faults.active() is None:
                if os.path.getsize(path) == 0:
                    return b""
                return memoryview(np.memmap(path, dtype=np.uint8,
                                            mode="r"))
            with open(path, "rb") as f:
                return faults.corrupt("store.shard", f.read())
        except FileNotFoundError:
            raise CodecError("shard file missing", path=path) from None

    def _read_shard(self, cell: int, k: int, col: str,
                    rows: int) -> np.ndarray:
        """One shard column, torn-tail handling per ``on_error``."""
        dtype = np.dtype(self.manifest.columns[col])
        path = shard_path(self.root, cell, k, col)
        raw = self._shard_bytes(path)
        complete = len(raw) // dtype.itemsize
        arr = np.frombuffer(raw, dtype=dtype, count=min(complete, rows))
        if complete < rows:
            # torn: the manifest promised more rows than the file holds
            err = CodecError(
                f"torn shard: {rows} rows promised, "
                f"{complete} complete on disk",
                path=path, feature=f"partition {cell} shard {k}",
                offset=complete * dtype.itemsize)
            if self.on_error == "raise":
                raise err
            if metrics.enabled:
                metrics.count("store/shards_torn")
            recorder.record("store_shard_torn", path=path, cell=cell,
                            shard=k, column=col, rows=rows,
                            complete=complete, mode=self.on_error)
            if self.on_error == "null":
                pad = np.zeros(rows, dtype=dtype)
                pad[:arr.shape[0]] = arr
                return pad
            # "skip": the incomplete tail rows drop
        return arr

    def read_partition(self, part: Partition,
                       cols: Optional[Sequence[str]] = None
                       ) -> Dict[str, np.ndarray]:
        """All of one partition's rows, columns concatenated across
        shards.  Under ``skip`` a torn shard truncates EVERY requested
        column to the shortest column's row count for that shard, so
        the result stays rectangular."""
        names = list(cols) if cols is not None \
            else list(self.manifest.columns)
        out: Dict[str, List[np.ndarray]] = {c: [] for c in names}
        read_rows = 0
        for k, rows in enumerate(part.shards):
            arrs = {c: self._read_shard(part.cell, k, c, rows)
                    for c in names}
            usable = min(a.shape[0] for a in arrs.values())
            read_rows += usable
            for c in names:
                out[c].append(arrs[c][:usable])
        # partition-heat feed: this read touches exactly one cell
        heat.touch(part.cell, rows=read_rows)
        note_partitions(((part.cell, read_rows),))
        return {c: np.concatenate(segs) if segs else
                np.empty(0, np.dtype(self.manifest.columns[c]))
                for c, segs in out.items()}

    def read_columns(self, cols: Optional[Sequence[str]] = None,
                     bbox=None) -> Dict[str, np.ndarray]:
        """Materialize the scanned subset (post-pruning) as one
        column dict — the SQL scan path.  For out-of-core streaming
        use :meth:`iter_chunks` instead."""
        parts = self.prune(bbox)
        names = list(cols) if cols is not None \
            else list(self.manifest.columns)
        segs: Dict[str, List[np.ndarray]] = {c: [] for c in names}
        for p in parts:
            got = self.read_partition(p, names)
            for c in names:
                segs[c].append(got[c])
        return {c: np.concatenate(s) if s else
                np.empty(0, np.dtype(self.manifest.columns[c]))
                for c, s in segs.items()}

    # -- lazy streaming ----------------------------------------------
    def iter_chunks(self, bbox=None,
                    chunk_rows: Optional[int] = None
                    ) -> Iterator[StoreChunk]:
        """Generator over the scanned partitions, yielding
        :class:`StoreChunk` blocks of exactly ``chunk_rows`` points
        (final remainder excepted), each carrying its per-partition
        row spans.  Reads one shard at a time — the host working set
        is one shard plus one chunk of carry-over, independent of
        store size.  Feed this straight into ``perf.pipeline.stream``
        (which pulls it one chunk ahead of the running compute), as
        ``parallel.pip_join.make_store_sharded_pip_join`` does."""
        from .. import config as _config
        from ..perf.bucketing import pow2_bucket
        cfg = _config.default_config()
        target = int(chunk_rows or cfg.stream_chunk_rows)
        # pow2-bucket the chunk size itself so every full chunk lands
        # in one padded block size downstream
        target = pow2_bucket(target, floor=64)
        xcol, ycol = self.manifest.point_cols
        parts = self.prune(bbox)
        # carry: (cell, (n, 2) array) segments not yet emitted
        carry: List[Tuple[int, np.ndarray]] = []
        carry_rows = 0
        offset = 0

        def emit(take: int) -> StoreChunk:
            nonlocal carry, carry_rows, offset
            spans: List[Tuple[int, int]] = []
            pieces: List[np.ndarray] = []
            left = take
            while left > 0:
                cell, seg = carry[0]
                if seg.shape[0] <= left:
                    carry.pop(0)
                    piece = seg
                else:
                    carry[0] = (cell, seg[left:])
                    piece = seg[:left]
                pieces.append(piece)
                left -= piece.shape[0]
                if spans and spans[-1][0] == cell:
                    spans[-1] = (cell, spans[-1][1] + piece.shape[0])
                else:
                    spans.append((cell, piece.shape[0]))
            carry_rows -= take
            chunk = StoreChunk(offset=offset,
                               points=np.concatenate(pieces)
                               if len(pieces) > 1 else pieces[0],
                               parts=tuple(spans))
            offset += take
            # partition-heat feed: rows actually streamed per cell (a
            # pruned partition never reaches a chunk — it stays cold)
            for cell, r in spans:
                heat.touch(cell, rows=r)
            note_partitions(spans)
            if metrics.enabled:
                metrics.count("store/chunks_streamed")
                metrics.count("store/rows_scanned", take)
            return chunk

        for p in parts:
            for k, rows in enumerate(p.shards):
                xs = self._read_shard(p.cell, k, xcol, rows)
                ys = self._read_shard(p.cell, k, ycol, rows)
                usable = min(xs.shape[0], ys.shape[0])
                if usable == 0:
                    continue
                pts = np.empty((usable, 2), np.float64)
                pts[:, 0] = xs[:usable]
                pts[:, 1] = ys[:usable]
                carry.append((p.cell, pts))
                carry_rows += usable
                while carry_rows >= target:
                    yield emit(target)
        if carry_rows:
            yield emit(carry_rows)
