"""Resilience layer: fault injection, retry/backoff, degrade-not-die.

Port of ``mosaic_tpu.resilience``:

* ``resilience.faults`` — deterministic, seedable fault plans armed via
  ``MOSAIC_TPU_FAULT_PLAN`` or :func:`faults.arm`, consulted by cheap
  probes (``maybe_fail`` / ``corrupt`` / ``degrade`` / ``stall``) placed
  at named sites across io / raster / native / parallel / store;
* ``resilience.retry`` — declarative :class:`RetryPolicy` (attempt
  budget, exponential backoff, deterministic jitter, exception
  allowlist, obs counters) applied to checkpoint IO and the native
  library's compile and load;
* ``resilience.ingest`` — the codecs' ``on_error="raise"|"skip"|"null"``
  policy: malformed records become structured :class:`ErrorRecord`\\ s
  plus ``io/records_dropped`` metrics instead of exceptions;
* ``resilience.testing`` — the ``fault_plan`` and ``no_faults`` pytest
  fixtures.
"""

from . import faults
from .faults import FaultPlan, FaultRule, InjectedFault
from .ingest import (ON_ERROR_MODES, CodecError, ErrorRecord, ErrorSink,
                     decode_guard)
from .retry import (CHECKPOINT_RETRY, NATIVE_COMPILE_RETRY,
                    NATIVE_LOAD_RETRY, ProbeFailure, RetryPolicy, retrying)

__all__ = [
    "faults", "FaultPlan", "FaultRule", "InjectedFault",
    "RetryPolicy", "retrying", "ProbeFailure", "CHECKPOINT_RETRY",
    "NATIVE_COMPILE_RETRY", "NATIVE_LOAD_RETRY",
    "CodecError", "ErrorRecord", "ErrorSink", "decode_guard",
    "ON_ERROR_MODES",
]
