"""Retry / timeout / backoff policies.

Port copy of ``mosaic_tpu.resilience.retry``.  :class:`RetryPolicy` is
immutable and declarative: attempt budget, exponential backoff with
**deterministic jitter** (seeded from the armed fault plan, so chaos
runs replay identically, and equal to the JAX package's delays for the
same seed), an exception allowlist, and per-attempt obs counters
(``retry/attempts/<name>``, ``retry/recovered/<name>``,
``retry/giveups/<name>``).  Each attempt also lands a ``retry`` /
``retry_recovered`` / ``retry_giveup`` event in the flight recorder.
Apply with ``policy.call(fn, ...)`` or the ``retrying(policy)``
decorator.  The bench probe's policy is left out: the port has no
bench probe.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import subprocess as _subprocess
import time
from typing import Callable, Optional, Tuple, Type

from ..obs import metrics
from ..obs.recorder import recorder
from . import faults

__all__ = ["RetryPolicy", "retrying", "ProbeFailure",
           "CHECKPOINT_RETRY", "NATIVE_COMPILE_RETRY",
           "NATIVE_LOAD_RETRY", "SERVE_SPAWN_RETRY",
           "FLEET_RESPAWN_BACKOFF", "LOADTEST_CONNECT_RETRY"]


class ProbeFailure(RuntimeError):
    """One out-of-process probe attempt failed (nonzero exit or hung
    subprocess): a type narrower than SubprocessError for a policy's
    allowlist to name."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Declarative retry/backoff policy.

    ``delay(attempt)`` for attempt ``a`` (0-based) is
    ``min(base * multiplier**a, max_delay)`` scaled by a deterministic
    jitter in ``[1-jitter, 1+jitter]`` derived from the fault-plan seed
    (0 when no plan is armed), the policy name, and the attempt number
    — never from wall-clock entropy.
    """

    name: str = "default"
    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.25
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)

    def delay(self, attempt: int, seed: Optional[int] = None) -> float:
        d = min(self.base_delay_s * self.multiplier ** attempt,
                self.max_delay_s)
        if self.jitter:
            if seed is None:
                plan = faults.active()
                seed = plan.seed if plan is not None else 0
            rnd = random.Random(f"{seed}:{self.name}:{attempt}")
            d *= 1.0 + self.jitter * (2.0 * rnd.random() - 1.0)
        return d

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable[[BaseException, int], None]]
             = None,
             sleep: Callable[[float], None] = time.sleep, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying allowlisted exceptions.

        ``on_retry(exc, attempt)`` runs before each re-attempt (e.g.
        invalidate a cache); the final failure re-raises the last
        exception unchanged.
        """
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                out = fn(*args, **kwargs)
                if attempt:
                    metrics.count(f"retry/recovered/{self.name}")
                    recorder.record("retry_recovered", policy=self.name,
                                    attempts=attempt + 1)
                return out
            except self.retry_on as e:
                last = e
                metrics.count(f"retry/attempts/{self.name}")
                if attempt + 1 >= max(1, self.max_attempts):
                    break
                if on_retry is not None:
                    on_retry(e, attempt)
                delay = self.delay(attempt)
                recorder.record("retry", policy=self.name,
                                attempt=attempt, backoff_s=round(delay, 6),
                                error=f"{type(e).__name__}: {e}"[:200])
                sleep(delay)
        metrics.count(f"retry/giveups/{self.name}")
        assert last is not None
        recorder.record("retry_giveup", policy=self.name,
                        attempts=max(1, self.max_attempts),
                        error=f"{type(last).__name__}: {last}"[:200])
        raise last


def retrying(policy: RetryPolicy):
    """Decorator form of :meth:`RetryPolicy.call`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return policy.call(fn, *args, **kwargs)
        return wrapper
    return deco


#: raster / model checkpoint file IO (read and write sides)
CHECKPOINT_RETRY = RetryPolicy(name="checkpoint", max_attempts=3,
                               base_delay_s=0.01, max_delay_s=0.5,
                               retry_on=(OSError,))

#: native toolchain invocation (g++ subprocess): one re-attempt covers
#: transient fork/tmpfile failures; a missing compiler fails fast twice
NATIVE_COMPILE_RETRY = RetryPolicy(
    name="native.compile", max_attempts=2, base_delay_s=0.05,
    max_delay_s=0.2,
    retry_on=(OSError, _subprocess.SubprocessError))

#: CDLL load of the built .so: the retry hook rebuilds the artifact
NATIVE_LOAD_RETRY = RetryPolicy(name="native.load", max_attempts=2,
                                base_delay_s=0.0, jitter=0.0,
                                retry_on=(OSError,))

#: fleet worker exec (serve/supervisor.py): transient fork/exec
#: failures (the ``serve.spawn`` fault site among them) retry fast; a
#: missing interpreter fails fast three times and the health loop's
#: breaker takes over
SERVE_SPAWN_RETRY = RetryPolicy(
    name="serve.spawn", max_attempts=3, base_delay_s=0.05,
    max_delay_s=0.5, retry_on=(OSError,
                               _subprocess.SubprocessError))

#: crash-respawn schedule (not a call-retry: the supervisor only uses
#: ``delay(k)`` for the k-th respawn inside the breaker window, so a
#: crash-looping worker backs off exponentially instead of spinning)
FLEET_RESPAWN_BACKOFF = RetryPolicy(
    name="fleet.respawn", max_attempts=1_000_000,
    base_delay_s=0.1, max_delay_s=2.0, multiplier=2.0)

#: load-test client connects (tools/loadtest_torch.py): jittered
#: backoff over refused/reset connects, so a kill drill's clients ride
#: through a worker SIGKILL window instead of booking instant errors
LOADTEST_CONNECT_RETRY = RetryPolicy(
    name="loadtest.connect", max_attempts=4, base_delay_s=0.05,
    max_delay_s=0.5, retry_on=(ConnectionError, OSError))
