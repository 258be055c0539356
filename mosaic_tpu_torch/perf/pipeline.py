"""Double-buffered host<->device chunk streaming on CUDA streams.

Port of ``mosaic_tpu.perf.pipeline.stream``, lean: the JAX version's
observability, memory-ledger and cancellation planes are left out.  A big
host batch is cut into row chunks; for each chunk the host stages its
input in pinned memory, a side CUDA stream copies it to the device, the
compute runs on the current stream, and its outputs come back to pinned
host buffers for a host pass.  Three things overlap:

* the host staging and host->device copy of chunk k+1 (side stream) with
  the device compute of chunk k;
* the host pass (``consume``) of chunk k-1 with the device compute of
  chunk k;
* the device->host copy of chunk k with nothing the host waits on until
  ``consume`` needs it.

CUDA events order the two streams; two pinned buffers per direction are
reused alternately, and a buffer is refilled only after the copy that read
it finished.  On a CPU device the same calls run in order, without
streams.  Host phases carry ``torch.profiler`` labels (``stream/stage``,
``stream/compute``, ``stream/wait``, ``stream/consume``) for a
``torch.profiler`` breakdown; with no profiler running each label costs
~14 µs of host time (measured on a CPU host), under 1% of a 2^18-row
chunk.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

__all__ = ["stream", "chunk_rows"]


def chunk_rows(n: int, chunk: int) -> List[slice]:
    """Row slices cutting ``n`` rows into ``chunk``-sized pieces (the
    last may be short)."""
    chunk = max(1, int(chunk))
    return [slice(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def stream(chunks: Sequence[slice], stage: Callable[[slice, np.ndarray],
                                                    None],
           width: int, compute: Callable[[int, torch.Tensor],
                                         Tuple[torch.Tensor, ...]],
           consume: Callable[[int, slice, Tuple[np.ndarray, ...]], None],
           device: torch.device) -> None:
    """Run row ``chunks`` through stage -> upload -> compute -> download
    -> consume.

    ``stage(sl, out)`` fills ``out`` ([rows, width] f32 numpy, pinned
    when on CUDA) with the chunk's device input; ``compute(i, x)`` takes
    the chunk's index in ``chunks`` and its [rows, width] f32 device
    tensor (so per-chunk parameters, such as a block's center, can be
    looked up) and returns a tuple of device tensors, enqueued on the
    current stream; ``consume(i, sl, host)`` receives those outputs as
    numpy arrays, in chunk order."""
    if not chunks:
        return
    if device.type != "cuda":
        for i, sl in enumerate(chunks):
            buf = np.empty((sl.stop - sl.start, width), np.float32)
            with record_function("stream/stage"):
                stage(sl, buf)
            with record_function("stream/compute"):
                out = compute(i, torch.from_numpy(buf))
            with record_function("stream/consume"):
                consume(i, sl, tuple(o.numpy() for o in out))
        return

    rows = max(sl.stop - sl.start for sl in chunks)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    h2d = [torch.empty((rows, width), dtype=torch.float32,
                       pin_memory=True) for _ in range(2)]
    h2d_free = [None, None]            # event: last copy out of h2d[j]
    d2h: list = [None, None]           # pinned output buffers per parity

    def upload(k: int):
        j = k % 2
        sl = chunks[k]
        n = sl.stop - sl.start
        if h2d_free[j] is not None:
            h2d_free[j].synchronize()
        with record_function("stream/stage"):
            stage(sl, h2d[j].numpy()[:n])
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
        with record_function("stream/wait"):
            done.synchronize()
        with record_function("stream/consume"):
            consume(i, sl, tuple(t.numpy() for t in host))

    pending = None                     # (i, slice, host, done) awaiting consume
    x, ready = upload(0)
    for k in range(len(chunks)):
        main.wait_event(ready)
        with record_function("stream/compute"):
            out = compute(k, x)
        # x was allocated on the side stream and read on the main one
        x.record_stream(main)
        host, done = download(k, out)
        if k + 1 < len(chunks):
            x, ready = upload(k + 1)
        if pending is not None:
            finish(*pending)
        pending = (k, chunks[k], host, done)
    finish(*pending)
