"""Chrome-trace (Perfetto) JSON export of host spans.

Port copy of ``mosaic_tpu.obs.chrometrace``.  The tracer keeps a bounded
ring of completed spans; this module renders them in the Trace Event
Format (``ph: "X"`` complete events, timestamps in microseconds) that
chrome://tracing and https://ui.perfetto.dev load directly.

Track layout: spans recorded under a trace context get one lane per
(trace, thread), labelled with the trace id and name through ``"M"``
``thread_name`` metadata, so concurrent queries render as separate
lanes.  Spans outside any trace fall back to one lane per OS thread.
Each ``X`` event's ``args`` carry the span and parent ids, the trace id,
the native thread id, and the error if the span body raised.

The one stated difference from the JAX package (ROADMAP C14): the
``process_name`` label names this package, ``mosaic_tpu_torch host``.
The device timeline is ``obs.device_trace``'s ``torch.profiler`` trace;
this export lines the host stages up beside it.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict

from .tracer import tracer

__all__ = ["chrome_trace_events", "export_chrome_trace"]


def chrome_trace_events() -> Dict[str, object]:
    """Build the Trace Event Format document from the tracer's ring."""
    pid = os.getpid()
    meta = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "mosaic_tpu_torch host"},
    }]
    events = []
    lanes: Dict[tuple, tuple] = {}   # lane key -> (tid, label)
    for ev in tracer.events():
        if ev.trace_id is not None:
            key = ("trace", ev.trace_id, ev.tid)
            label = f"{ev.trace_id} {ev.trace_name or ''}".strip()
        else:
            key = ("thread", ev.tid)
            label = f"thread {ev.native_tid}"
        lane = lanes.get(key)
        if lane is None:
            lane = (len(lanes) + 1, label)
            lanes[key] = lane
        args = {"span_id": ev.span_id, "thread_id": ev.native_tid}
        if ev.trace_id is not None:
            args["trace_id"] = ev.trace_id
        if ev.parent_id is not None:
            args["parent_id"] = ev.parent_id
        if ev.error:
            args["error"] = ev.error
        events.append({
            "name": ev.qual,
            "cat": "host",
            "ph": "X",
            "ts": ev.start_s * 1e6,
            "dur": ev.dur_s * 1e6,
            "pid": pid,
            "tid": lane[0],
            "args": args,
        })
    for i, (lane_tid, label) in enumerate(lanes.values()):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": lane_tid, "args": {"name": label},
        })
        meta.append({
            "name": "thread_sort_index", "ph": "M", "pid": pid,
            "tid": lane_tid, "args": {"sort_index": i},
        })
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str) -> str:
    """Write the host-span timeline to ``path`` as Perfetto-loadable
    JSON; returns ``path``."""
    doc = chrome_trace_events()
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
