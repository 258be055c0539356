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
``pipeline/d2h_bytes``) and charged to the active in-flight ticket; each
chunk boundary is an ``obs.inflight.checkpoint("pipeline.stream")`` (a
cancelled or expired query raises ``QueryCancelled`` there) and a
``pipeline.chunk`` stall site, each chunk's fetch a ``pipeline.fetch``
fault site.  Each chunk's staged input and outputs are registered in the
device-memory ledger (``obs.memwatch``, sites ``<site>/staged`` and
``<site>/out``, logical bytes) and released when its host fetch
completes; under memory pressure the next row slice is halved before it
is staged (``mem/chunk_shrink``, one ``mem_chunk_shrink`` event a
stream).  An ``observe(i, slice, seconds)`` hook receives each chunk's
launch wall time (the kernel ledger's feed, ``obs.profiler``); an
observer that raises is fenced (``pipeline/observe_errors``, one
``pipeline_observe_error`` event a stream).  The fetch runs on the
calling thread (the JAX version's runs on a worker), so an exception
from any step reaches the caller directly; before it does, both CUDA
streams are drained and the chunks' ledger entries released, so nothing
the failed call queued is still running, or held, when the next call
starts.

Host phases carry ``torch.profiler`` labels (``stream/pull``,
``stream/stage``, ``stream/compute``, ``stream/wait``,
``stream/consume``) for a ``torch.profiler`` breakdown; with no profiler
running each label costs ~14 µs of host time (measured on a CPU host),
under 1% of a 2^18-row chunk.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..obs import metrics, recorder
from ..obs.inflight import (charge_d2h_bytes, charge_h2d_bytes, checkpoint,
                            inflight)
from ..obs.jaxmon import device_key
from ..obs.memwatch import device_keys_of, mem_budget, memwatch, \
    tensor_bytes
from ..resilience import faults

__all__ = ["stream", "chunk_rows"]

#: pressure-driven halving floor: a slice this short never splits
#: (guards against a pathological budget dissolving the stream into
#: per-row launches)
_MIN_SHRINK_ROWS = 64


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
           device: torch.device, rows: Optional[int] = None,
           observe: Optional[Callable[[int, slice, float], None]] = None,
           site: str = "pipeline.stream", split: bool = True,
           staged_rows: Optional[Callable[[slice], int]] = None,
           agree: Optional[Callable[[bool], bool]] = None) -> None:
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
    when on CUDA) with the chunk's device input, ``staged_rows(sl)`` rows
    of it (default the slice's own rows: a caller that stages a padded
    block of its own for each row slice, as the sharded join does, says
    how long); ``compute(i, x)`` takes
    the launch's index and its [rows, width] f32 device tensor and
    returns a tuple of device tensors, enqueued on the current stream;
    ``consume(i, sl, host)`` receives those outputs as numpy arrays, in
    chunk order.  Each chunk's staged bytes are counted in
    ``pipeline/h2d_bytes`` and its fetched bytes in ``pipeline/d2h_bytes``
    (both charged to the active ticket).

    Memory: the chunk's staged input registers in ``obs.memwatch`` as
    ``<site>/staged`` and its outputs as ``<site>/out`` (logical bytes,
    on the tensors' device), both released when the chunk's host fetch
    completes; the stream holds both tensors until then, so the ledger
    never counts bytes the allocator has freed.  With ``split`` on, while any device's ledger pressure is
    past ``mosaic.mem.pressure.high`` (``obs.memwatch.mem_budget``), the
    next slice is halved before it is staged (repeatedly, down to
    ``_MIN_SHRINK_ROWS`` rows), counted in ``mem/chunk_shrink`` with one
    ``mem_chunk_shrink`` event a stream.  A split only ever shrinks a
    slice, so nothing is staged past the pinned width; the launch index
    ``i`` then counts the halves, so a caller that splits keys its
    per-chunk state on the slice, as the streamed join does (the same
    rows arrive, in order, across more launches).  Callers whose chunk
    index names per-chunk parameters, or whose chunks are not row slices,
    pass ``split=False``.

    ``agree(flag) -> bool`` makes a group of ranks halve alike when each
    chunk boundary is a collective every rank must reach (the sharded
    streamed join): each halving decision is then the group's, one
    ``all_reduce`` MAX of every rank's own flag, so every rank cuts the
    same slice.  It is asked only while a budget is set
    (``mosaic.mem.budget.bytes`` > 0, which every rank of the group must
    share); without one the stream never halves and takes no collective.

    ``observe(i, sl, seconds)`` receives each chunk's launch wall time:
    compute dispatch to host-fetch completion, clamped to the previous
    chunk's completion so the spans are disjoint and sum to at most the
    pass's wall time (the kernel ledger's feed).  An observer that
    raises cannot kill the stream: the error is counted
    (``pipeline/observe_errors``), recorded once a stream
    (``pipeline_observe_error``), and the chunk completes.

    Before each chunk's compute the in-flight checkpoint runs (a
    cancelled query raises :class:`~..obs.inflight.QueryCancelled` at
    the chunk boundary), then the ``pipeline.chunk`` stall site; each
    fetch starts at the ``pipeline.fetch`` fault site.  An exception
    from any step drains both CUDA streams and releases the ledger
    entries of every chunk in flight, then propagates."""
    def n_staged(sl: slice) -> int:
        return staged_rows(sl) if staged_rows is not None \
            else sl.stop - sl.start

    if rows is None:
        if not isinstance(chunks, Sequence):
            raise ValueError("a lazy chunk source needs its row bound: "
                             "pass rows=")
        if not chunks:
            return
        rows = max(n_staged(sl) for sl in chunks)
    rows = int(rows)
    source = iter(chunks)
    # a split pushes its halves back onto the head of this deque, so it
    # never holds more than one source slice's pieces
    pending_sl: deque = deque()
    state = {"last_done": 0.0, "observe_failed": False, "shrunk": False}
    cuda = device.type == "cuda"
    dev_keys = [device_key(device)]

    def shrink() -> bool:
        if agree is None:
            return mem_budget.shrink_needed()
        # the group's decision: one all_reduce MAX a boundary, and none
        # at all while no budget is set
        return mem_budget.budget_bytes() > 0 and \
            agree(mem_budget.shrink_needed())

    def maybe_split() -> None:
        # degrade-not-die: while any device sits past the pressure
        # high-water mark, halve the next slice before staging it
        while (split and (pending_sl[0].stop - pending_sl[0].start)
               > _MIN_SHRINK_ROWS and shrink()):
            sl = pending_sl.popleft()
            mid = (sl.start + sl.stop) // 2
            pending_sl.appendleft(slice(mid, sl.stop))
            pending_sl.appendleft(slice(sl.start, mid))
            if metrics.enabled:
                metrics.count("mem/chunk_shrink")
            if not state["shrunk"]:        # recorded once a stream
                state["shrunk"] = True
                recorder.record("mem_chunk_shrink", site=site,
                                rows=sl.stop - sl.start)

    def pull() -> Optional[slice]:
        if not pending_sl:
            with record_function("stream/pull"):
                sl = next(source, None)
            if sl is None:
                return None
            if n_staged(sl) > rows:
                raise ValueError(f"chunk of {n_staged(sl)} rows "
                                 f"exceeds the stream's bound of {rows}")
            pending_sl.append(sl)
        maybe_split()
        return pending_sl.popleft()

    def staged(n: int) -> Optional[int]:
        nb = 4 * n * width
        if metrics.enabled:
            metrics.count("pipeline/h2d_bytes", nb)
        charge_h2d_bytes(nb)
        return memwatch.register(f"{site}/staged", nb, devices=dev_keys) \
            if memwatch.enabled else None

    def boundary() -> None:
        checkpoint("pipeline.stream")   # chunk-boundary cancel
        faults.stall("pipeline.chunk")  # latency chaos

    def fetched(host: Tuple[np.ndarray, ...]) -> None:
        if metrics.enabled or inflight._by_trace:
            nb = sum(int(h.nbytes) for h in host)
            if metrics.enabled:
                metrics.count("pipeline/d2h_bytes", nb)
            charge_d2h_bytes(nb)

    def observed(i: int, sl: slice, dispatch_t: float) -> None:
        now = time.perf_counter()
        start = max(dispatch_t, state["last_done"])
        state["last_done"] = now
        try:
            observe(i, sl, now - start)
        except Exception as exc:
            # observability must never take down the data path
            metrics.count("pipeline/observe_errors")
            if not state["observe_failed"]:
                state["observe_failed"] = True
                recorder.record("pipeline_observe_error", chunk=i,
                                error=f"{type(exc).__name__}: {exc}")

    if cuda:
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        h2d = None                     # pinned input buffers, made lazily
        h2d_free = [None, None]        # event: last copy out of h2d[j]
        d2h: list = [None, None]       # pinned output buffers per parity

    def upload(k: int, sl: slice):
        """Stage slice ``sl`` and put it on the device: (x, ready event
        or None, ledger token)."""
        nonlocal h2d
        n = n_staged(sl)
        if not cuda:
            buf = np.empty((n, width), np.float32)
            with record_function("stream/stage"):
                stage(sl, buf)
            return torch.from_numpy(buf), None, staged(n)
        j = k % 2
        if h2d is None:
            h2d = [torch.empty((rows, width), dtype=torch.float32,
                               pin_memory=True) for _ in range(2)]
        if h2d_free[j] is not None:
            h2d_free[j].synchronize()
        with record_function("stream/stage"):
            stage(sl, h2d[j].numpy()[:n])
        tok = staged(n)
        with torch.cuda.stream(side):
            x = torch.empty((n, width), dtype=torch.float32, device=device)
            x.copy_(h2d[j][:n], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        h2d_free[j] = ready
        return x, ready, tok

    def download(k: int, out: Tuple[torch.Tensor, ...]):
        if not cuda:
            return out, None
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

    live = {}      # launch index -> ledger tokens of a chunk not fetched
    held = {}      # launch index -> its device input and outputs

    def finish(i, sl, host, done, dispatch_t):
        toks = live.pop(i)
        try:
            faults.maybe_fail("pipeline.fetch")
            if done is not None:
                with record_function("stream/wait"):
                    done.synchronize()
            host = tuple(t.numpy() for t in host)
        finally:
            # the chunk's buffers are drained — input consumed by the
            # launch, outputs copied out — and both leave the ledger
            # even when the fetch itself unwinds (fault, cancel)
            for tok in reversed(toks):     # outputs, then the input
                memwatch.release(tok)
            # the chunk's device tensors live until here, so the ledger's
            # live bytes are bytes the allocator holds
            held.pop(i, None)
        if observe is not None:
            observed(i, sl, dispatch_t)
        fetched(host)
        with record_function("stream/consume"):
            consume(i, sl, host)

    pending = None                     # chunk awaiting its fetch
    try:
        sl = pull()
        if sl is None:
            return
        k = 0
        x, ready, tok = upload(0, sl)
        live[0] = [tok]
        while sl is not None:
            boundary()
            if ready is not None:
                main.wait_event(ready)
            dispatch_t = time.perf_counter()
            with record_function("stream/compute"):
                out = compute(k, x)
            if cuda:
                # x was allocated on the side stream and read on the main
                x.record_stream(main)
            held[k] = (x, out)
            if memwatch.enabled:
                live[k].append(memwatch.register(
                    f"{site}/out", tensor_bytes(out),
                    devices=device_keys_of(out)))
            host, done = download(k, out)
            nxt = pull()
            if nxt is not None:
                x, ready, tok = upload(k + 1, nxt)
                live[k + 1] = [tok]
            if pending is not None:
                finish(*pending)
            pending = (k, sl, host, done, dispatch_t)
            k, sl = k + 1, nxt
        finish(*pending)
    except BaseException:
        if cuda:
            # leave nothing of this call running on either stream: the
            # pinned buffers it copies into are freed with the frame
            side.synchronize()
            main.synchronize()
        # a stream unwinding mid-loop (cancel, deadline, fault) holds
        # chunks staged or launched but never fetched: drop their
        # registrations so a clean cancellation never reads as a leak
        for toks in live.values():
            for tok in toks:
                memwatch.release(tok)
        raise
