"""Double-buffered host<->device chunk streaming on CUDA streams.

Port of ``mosaic_tpu.perf.pipeline.stream``.  A big host batch is cut
into row chunks, or a lazy source (the chip store's scan) makes them one
at a time; for each chunk the host stages its input in pinned memory, a
side CUDA stream copies it to the device, the compute runs on the
current stream, and its outputs come back to pinned host buffers for a
host pass.  Three things overlap:

* the host staging and host->device copy of chunk k+1 (side stream) with
  the device compute of chunk k;
* the host pass (``consume``) of chunk k-1 with the device compute of
  chunk k;
* the device->host copy of chunk k with nothing the host waits on until
  ``consume`` needs it.

CUDA events order the two streams; two pinned buffers per direction are
reused alternately, and a buffer is refilled only after the copy that read
it finished.  The source is pulled one chunk ahead of the running
compute, never more.  On a CPU device the same calls run in order,
without streams.

The host planes are the JAX version's: the staged and fetched bytes are
counted in ``obs.metrics`` (``pipeline/h2d_bytes``,
``pipeline/d2h_bytes``) and the fetched ones charged to the active
in-flight ticket; each chunk boundary is an
``obs.inflight.checkpoint("pipeline.stream")`` (a cancelled or expired
query raises ``QueryCancelled`` there) and a ``pipeline.chunk`` stall
site, each chunk's fetch a ``pipeline.fetch`` fault site.  The fetch
runs on the calling thread (the JAX version's runs on a worker), so an
exception from any step reaches the caller directly; before it does,
both CUDA streams are drained, so nothing the failed call queued is
still running when the next call starts.  The JAX version's memory
ledger, pressure shrink and profiler ledger (with its per-chunk
observer hook and ``pipeline_observe_error`` event) are ROADMAP §A9b.

Host phases carry ``torch.profiler`` labels (``stream/pull``,
``stream/stage``, ``stream/compute``, ``stream/wait``,
``stream/consume``) for a ``torch.profiler`` breakdown; with no profiler
running each label costs ~14 µs of host time (measured on a CPU host),
under 1% of a 2^18-row chunk.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..obs import metrics
from ..obs.inflight import charge_d2h_bytes, checkpoint, inflight
from ..resilience import faults

__all__ = ["stream", "chunk_rows"]


def chunk_rows(n: int, chunk: int) -> List[slice]:
    """Row slices cutting ``n`` rows into ``chunk``-sized pieces (the
    last may be short)."""
    chunk = max(1, int(chunk))
    return [slice(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def stream(chunks: Iterable[slice], stage: Callable[[slice, np.ndarray],
                                                    None],
           width: int, compute: Callable[[int, torch.Tensor],
                                         Tuple[torch.Tensor, ...]],
           consume: Callable[[int, slice, Tuple[np.ndarray, ...]], None],
           device: torch.device, rows: Optional[int] = None) -> None:
    """Run the row slices of ``chunks`` through stage -> upload -> compute
    -> download -> consume.

    ``chunks`` is any iterable of row slices: a list, or a lazy source
    that makes each slice when it is pulled (the chip store's scan,
    ``parallel.pip_join.make_store_sharded_pip_join``).  Slice k+1 is
    pulled only once slice k has been launched, so at most two slices'
    inputs and outputs are live, however long the source.  ``rows``
    bounds every slice's row count and sizes the pinned buffers; a
    ``Sequence`` may leave it None (its longest slice), a lazy source
    must give it, and a longer slice raises ``ValueError``.

    ``stage(sl, out)`` fills ``out`` ([rows, width] f32 numpy, pinned
    when on CUDA) with the chunk's device input; ``compute(i, x)`` takes
    the chunk's index in ``chunks`` and its [rows, width] f32 device
    tensor (so per-chunk parameters, such as a block's center, can be
    looked up) and returns a tuple of device tensors, enqueued on the
    current stream; ``consume(i, sl, host)`` receives those outputs as
    numpy arrays, in chunk order.  Each chunk's staged bytes are counted
    in ``pipeline/h2d_bytes`` and its fetched bytes in
    ``pipeline/d2h_bytes`` (and charged to the active ticket).

    Before each chunk's compute the in-flight checkpoint runs (a
    cancelled query raises :class:`~..obs.inflight.QueryCancelled` at
    the chunk boundary), then the ``pipeline.chunk`` stall site; each
    fetch starts at the ``pipeline.fetch`` fault site.  An exception
    from any step drains both CUDA streams, then propagates."""
    if rows is None:
        if not isinstance(chunks, Sequence):
            raise ValueError("a lazy chunk source needs its row bound: "
                             "pass rows=")
        if not chunks:
            return
        rows = max(sl.stop - sl.start for sl in chunks)
    rows = int(rows)
    source = iter(chunks)

    def pull() -> Optional[slice]:
        with record_function("stream/pull"):
            sl = next(source, None)
        if sl is not None and sl.stop - sl.start > rows:
            raise ValueError(f"chunk of {sl.stop - sl.start} rows exceeds "
                             f"the stream's bound of {rows}")
        return sl

    def staged(n: int) -> None:
        if metrics.enabled:
            metrics.count("pipeline/h2d_bytes", 4 * n * width)

    def boundary() -> None:
        checkpoint("pipeline.stream")   # chunk-boundary cancel
        faults.stall("pipeline.chunk")  # latency chaos

    def fetched(host: Tuple[np.ndarray, ...]) -> None:
        if metrics.enabled or inflight._by_trace:
            nb = sum(int(h.nbytes) for h in host)
            if metrics.enabled:
                metrics.count("pipeline/d2h_bytes", nb)
            charge_d2h_bytes(nb)

    if device.type != "cuda":
        i, sl = 0, pull()
        while sl is not None:
            buf = np.empty((sl.stop - sl.start, width), np.float32)
            with record_function("stream/stage"):
                stage(sl, buf)
            staged(len(buf))
            boundary()
            with record_function("stream/compute"):
                out = compute(i, torch.from_numpy(buf))
            faults.maybe_fail("pipeline.fetch")
            host = tuple(o.numpy() for o in out)
            fetched(host)
            with record_function("stream/consume"):
                consume(i, sl, host)
            i, sl = i + 1, pull()
        return

    first = pull()
    if first is None:
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    h2d = [torch.empty((rows, width), dtype=torch.float32,
                       pin_memory=True) for _ in range(2)]
    h2d_free = [None, None]            # event: last copy out of h2d[j]
    d2h: list = [None, None]           # pinned output buffers per parity

    def upload(k: int, sl: slice):
        j = k % 2
        n = sl.stop - sl.start
        if h2d_free[j] is not None:
            h2d_free[j].synchronize()
        with record_function("stream/stage"):
            stage(sl, h2d[j].numpy()[:n])
        staged(n)
        with torch.cuda.stream(side):
            x = torch.empty((n, width), dtype=torch.float32, device=device)
            x.copy_(h2d[j][:n], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        h2d_free[j] = ready
        return x, ready

    def download(k: int, out: Tuple[torch.Tensor, ...]):
        j = k % 2
        if d2h[j] is None or any(b.shape[0] < o.shape[0] or b.dtype != o.dtype
                                 for b, o in zip(d2h[j], out)):
            d2h[j] = tuple(torch.empty((rows,) + tuple(o.shape[1:]),
                                       dtype=o.dtype, pin_memory=True)
                           for o in out)
        host = tuple(b[:o.shape[0]] for b, o in zip(d2h[j], out))
        for h, o in zip(host, out):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record(main)
        return host, done

    def finish(i, sl, host, done):
        faults.maybe_fail("pipeline.fetch")
        with record_function("stream/wait"):
            done.synchronize()
        host = tuple(t.numpy() for t in host)
        fetched(host)
        with record_function("stream/consume"):
            consume(i, sl, host)

    pending = None                     # (i, slice, host, done) awaiting consume
    try:
        k, sl = 0, first
        x, ready = upload(0, sl)
        while sl is not None:
            boundary()
            main.wait_event(ready)
            with record_function("stream/compute"):
                out = compute(k, x)
            # x was allocated on the side stream and read on the main one
            x.record_stream(main)
            host, done = download(k, out)
            nxt = pull()
            if nxt is not None:
                x, ready = upload(k + 1, nxt)
            if pending is not None:
                finish(*pending)
            pending = (k, sl, host, done)
            k, sl = k + 1, nxt
        finish(*pending)
    except BaseException:
        # leave nothing of this call running on either stream: the
        # pinned buffers it copies into are freed with the frame
        side.synchronize()
        main.synchronize()
        raise
