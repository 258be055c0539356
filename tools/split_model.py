"""A host model of the port's streamed executor under a memory budget:
which row slices ``mosaic_tpu_torch.perf.pipeline.stream`` launches, and
how many halvings (``mem/chunk_shrink``) it makes.

    from tools.split_model import split_model
    slices, shrinks = split_model(n, chunk, in_bpr, out_bpr, budget, high)

The model is written from the executor's contract, not from its code:
chunk k's staged input (``in_bpr`` bytes a row) is live from its upload
until its host fetch, its outputs (``out_bpr`` bytes a row) from its
launch until that fetch; the executor launches chunk k, stages chunk
k + 1, and only then fetches chunk k - 1.  So when it decides how to
stage chunk k + 1, chunks k - 1 and k are live (inputs and outputs).
While those bytes over the budget reach ``high`` (the ledger's pressure
against ``mosaic.mem.pressure.high``) the next slice is halved, down to
``floor`` rows.  ``chip_smoke.py`` phase 21 and
``tests/test_torch_memwatch.py`` hold the executor to it.
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple


def split_model(n: int, chunk: int, in_bpr: int, out_bpr: int,
                budget: int, high: float, floor: int = 64
                ) -> Tuple[List[Tuple[int, int]], int]:
    """(the launched slices as (start, stop), the halvings) of a stream
    of ``n`` rows cut into ``chunk``-row slices, under ``budget`` bytes
    (0 = none) and the pressure fraction ``high``."""
    source = deque((s, min(s + chunk, n)) for s in range(0, n, chunk))
    pending: deque = deque()
    live = {}                      # launch -> bytes held until its fetch
    shrinks = 0

    def pressed() -> bool:
        return budget > 0 and high > 0 and \
            sum(live.values()) / float(budget) >= high

    def pull():
        nonlocal shrinks
        if not pending:
            if not source:
                return None
            pending.append(source.popleft())
        while pressed() and pending[0][1] - pending[0][0] > floor:
            a, b = pending.popleft()
            mid = (a + b) // 2
            pending.appendleft((mid, b))
            pending.appendleft((a, mid))
            shrinks += 1
        return pending.popleft()

    launched = []
    k, sl = 0, pull()
    if sl is not None:
        live[0] = in_bpr * (sl[1] - sl[0])
    while sl is not None:
        launched.append(sl)
        live[k] += out_bpr * (sl[1] - sl[0])       # its outputs
        nxt = pull()                               # decide, then stage
        if nxt is not None:
            live[k + 1] = in_bpr * (nxt[1] - nxt[0])
        live.pop(k - 1, None)                      # fetch chunk k - 1
        k, sl = k + 1, nxt
    return launched, shrinks
