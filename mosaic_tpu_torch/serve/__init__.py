"""Multi-tenant query service: a long-lived server over one
SQLSession — bounded admission with per-tenant quotas, micro-batched
point lookups, cooperative cancel on disconnect/deadline, and
degrade-not-die overload behavior (shed lowest priority first, drain
on SIGTERM).  Stdlib only: asyncio streams + hand-rolled HTTP/1.1.

Port of ``mosaic_tpu.serve``.  Usage::

    from mosaic_tpu_torch.serve import QueryServer
    with QueryServer(session, port=8817) as srv:
        srv.install_sigterm_drain()
        ...

Tuned by the ``mosaic.serve.*`` conf keys (``config.py``).
"""

from .admission import AdmissionQueue, Deny, ServeRequest
from .batching import KERNEL_NAME, execute_batch
from .scoreboard import Scoreboard, ScoreboardError, SlotToken
from .server import QueryServer, current_server, install_sigterm_drain
from .supervisor import ServeFleet, WorkerSlot, worker_main
from .workers import WorkerPool

__all__ = [
    "AdmissionQueue", "Deny", "ServeRequest",
    "KERNEL_NAME", "execute_batch",
    "Scoreboard", "ScoreboardError", "SlotToken",
    "QueryServer", "current_server", "install_sigterm_drain",
    "ServeFleet", "WorkerSlot", "worker_main",
    "WorkerPool",
]
