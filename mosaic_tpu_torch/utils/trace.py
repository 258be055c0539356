"""Compat shim: the tracing subsystem lives in :mod:`mosaic_tpu_torch.obs`.

Port copy of ``mosaic_tpu.utils.trace``: ``tracer``, ``Tracer``,
``metrics``, ``record_command``, ``record_error`` and ``device_trace``
re-export from the observability package, the same objects.  Import
from ``mosaic_tpu_torch.obs`` in new code.
"""

from __future__ import annotations

from ..obs import (Tracer, device_trace, metrics, record_command,
                   record_error, tracer)

__all__ = ["Tracer", "tracer", "metrics", "record_command",
           "record_error", "device_trace"]
