"""Deterministic, seedable fault injection.

Port copy of ``mosaic_tpu.resilience.faults``: the same spec language,
the same sites and the same decisions.  A :class:`FaultPlan` is armed
process-wide (programmatically or via ``MOSAIC_TPU_FAULT_PLAN``) and
cheap probes placed at named sites in the io / raster / native /
parallel / store layers consult it.

Four probe kinds:

* ``maybe_fail(site)`` — raise an injected exception (an
  :class:`InjectedFault` subclass of a realistic base type such as
  ``OSError``) when the plan selects this invocation;
* ``corrupt(site, data)`` — deterministically truncate or bit-flip a
  byte payload (codec chaos: damaged strips / shards);
* ``degrade(site, value)`` — shrink an integer capacity (forces the
  sharded overlay's bucket overflow-retry path);
* ``stall(site)`` — sleep an injected ``delay_ms`` (latency chaos,
  results intact).

Every decision is a pure function of ``(seed, site, per-site call
number)`` (a sha256 of the three, and a ``random.Random`` seeded by
them for corruption), so the same spec injects the same faults at the
same places in this package and in the JAX package, and chaos tests are
ordinary, reproducible tests (fixture: ``resilience.testing``).

Disarmed cost is one module-global ``None`` check per probe.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import os
import random
import struct as _struct
import threading
import zlib as _zlib
from typing import Dict, List, Optional, Tuple, Type

from ..obs import metrics

__all__ = ["InjectedFault", "FaultRule", "FaultPlan", "arm", "disarm",
           "active", "maybe_fail", "corrupt", "degrade", "stall"]


class InjectedFault(Exception):
    """Marker mixin: every exception a FaultPlan raises is-a
    InjectedFault, so handlers/tests can tell chaos from real damage
    while production code still sees the realistic base type."""


_INJECTED_TYPES: Dict[type, type] = {}


def injected_type(base: Type[BaseException]) -> type:
    """``OSError`` -> ``InjectedOSError`` (subclass of both)."""
    t = _INJECTED_TYPES.get(base)
    if t is None:
        t = type("Injected" + base.__name__, (base, InjectedFault), {})
        _INJECTED_TYPES[base] = t
    return t


#: error= spec values -> base exception types
ERROR_TYPES: Dict[str, Type[BaseException]] = {
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
    "IndexError": IndexError,
    "RuntimeError": RuntimeError,
    "MemoryError": MemoryError,
    "struct.error": _struct.error,
    "zlib.error": _zlib.error,
}

_MODES = ("raise", "truncate", "flip", "degrade", "delay")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One clause of a plan: which sites, how often, what happens."""

    pattern: str                      # fnmatch over the site name
    rate: float = 0.0                 # per-call injection probability
    fails: int = 0                    # fail the first N calls instead
    error: Type[BaseException] = OSError
    mode: str = "raise"       # raise | truncate | flip | degrade | delay
    factor: int = 4                   # degrade: capacity divisor
    delay_ms: float = 100.0           # delay: injected stall length

    def matches(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.pattern)


class FaultPlan:
    """Seeded set of :class:`FaultRule`\\ s with per-site call counters.

    Decisions are deterministic: call ``n`` at ``site`` is selected iff
    ``n < fails`` (transient-failure rules) or the 64-bit hash of
    ``(seed, site, n)`` falls under ``rate``.
    """

    def __init__(self, seed: int = 0,
                 rules: Tuple[FaultRule, ...] = ()):
        self.seed = int(seed)
        self.rules: List[FaultRule] = list(rules)
        self.injected: List[Tuple[str, int, str]] = []  # (site, n, kind)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- spec DSL -----------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the ``MOSAIC_TPU_FAULT_PLAN`` mini-DSL.

        ``spec := clause (';' clause)*`` where a clause is ``seed=N``
        or ``site=PATTERN[,rate=F][,fails=N][,error=NAME][,mode=M]
        [,factor=N][,delay_ms=F]``, e.g.::

            seed=1234;site=checkpoint.*,rate=0.1,error=OSError;
            site=native.compile,fails=1;
            site=overlay.*,mode=degrade,rate=1.0,factor=4;
            site=sql.query,mode=delay,fails=1,delay_ms=120
        """
        seed = 0
        rules: List[FaultRule] = []
        for clause in filter(None,
                             (c.strip() for c in spec.split(";"))):
            kv: Dict[str, str] = {}
            for part in clause.split(","):
                if "=" not in part:
                    raise ValueError(
                        f"fault-plan clause {clause!r}: bad item "
                        f"{part!r} (want key=value)")
                k, v = part.split("=", 1)
                kv[k.strip()] = v.strip()
            if list(kv) == ["seed"]:
                seed = int(kv["seed"])
                continue
            if "site" not in kv:
                raise ValueError(
                    f"fault-plan clause {clause!r} missing site=")
            err = kv.get("error", "OSError")
            if err not in ERROR_TYPES:
                raise ValueError(
                    f"fault-plan error {err!r} unknown "
                    f"(have: {sorted(ERROR_TYPES)})")
            mode = kv.get("mode", "raise")
            if mode not in _MODES:
                raise ValueError(f"fault-plan mode {mode!r} unknown "
                                 f"(have: {_MODES})")
            rules.append(FaultRule(
                pattern=kv["site"],
                rate=float(kv.get("rate", 0.0)),
                fails=int(kv.get("fails", 0)),
                error=ERROR_TYPES[err],
                mode=mode,
                factor=int(kv.get("factor", 4)),
                delay_ms=float(kv.get("delay_ms", 100.0))))
        return cls(seed=seed, rules=tuple(rules))

    # -- decision core ------------------------------------------------
    def _next_call(self, site: str) -> int:
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            return n

    def _hit(self, rule: FaultRule, site: str, n: int) -> bool:
        if rule.fails:
            return n < rule.fails
        if rule.rate <= 0.0:
            return False
        h = hashlib.sha256(
            f"{self.seed}:{site}:{n}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < rule.rate

    def _record(self, site: str, n: int, kind: str) -> None:
        # probes fire on whatever thread hit the site; the ledger list
        # shares the counter lock (callers never hold it here)
        with self._lock:
            self.injected.append((site, n, kind))
        metrics.count("faults/injected")
        metrics.count(f"faults/injected/{site}")
        from ..obs.recorder import recorder
        recorder.record("fault_injected", site=site, call=n,
                        fault=kind, seed=self.seed)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self.injected.clear()

    # -- probes -------------------------------------------------------
    def maybe_fail(self, site: str) -> None:
        n = self._next_call(site)
        for rule in self.rules:
            if rule.mode != "raise" or not rule.matches(site):
                continue
            if self._hit(rule, site, n):
                self._record(site, n, rule.error.__name__)
                raise injected_type(rule.error)(
                    f"injected fault at {site} "
                    f"(call {n}, seed {self.seed})")

    def corrupt(self, site: str, data: bytes) -> bytes:
        n = self._next_call(site)
        for rule in self.rules:
            if rule.mode not in ("truncate", "flip") \
                    or not rule.matches(site):
                continue
            if self._hit(rule, site, n) and len(data):
                rnd = random.Random(f"{self.seed}:{site}:{n}")
                if rule.mode == "truncate":
                    data = data[:rnd.randrange(len(data))]
                else:
                    i = rnd.randrange(len(data))
                    b = bytearray(data)
                    b[i] ^= 0xFF
                    data = bytes(b)
                self._record(site, n, rule.mode)
                return data
        return data

    def degrade(self, site: str, value: int) -> int:
        n = self._next_call(site)
        for rule in self.rules:
            if rule.mode != "degrade" or not rule.matches(site):
                continue
            if self._hit(rule, site, n):
                self._record(site, n, "degrade")
                return max(1, int(value) // max(rule.factor, 1))
        return value

    def stall(self, site: str) -> float:
        """Sleep ``delay_ms`` when selected (latency chaos: slow
        queries / SLO drills without breaking results); returns the
        injected delay in seconds (0.0 = not selected)."""
        import time as _time
        n = self._next_call(site)
        for rule in self.rules:
            if rule.mode != "delay" or not rule.matches(site):
                continue
            if self._hit(rule, site, n):
                self._record(site, n, "delay")
                _time.sleep(rule.delay_ms / 1e3)
                return rule.delay_ms / 1e3
        return 0.0


# ---------------------------------------------------------- module API

_active: Optional[FaultPlan] = None


def arm(plan) -> FaultPlan:
    """Arm a plan process-wide (a FaultPlan or a spec string)."""
    global _active
    if isinstance(plan, str):
        plan = FaultPlan.from_spec(plan)
    _active = plan
    return plan


def disarm() -> None:
    global _active
    _active = None


def active() -> Optional[FaultPlan]:
    return _active


def maybe_fail(site: str) -> None:
    """Probe: raise the armed plan's injected exception, or no-op."""
    p = _active
    if p is not None:
        p.maybe_fail(site)


def corrupt(site: str, data: bytes) -> bytes:
    """Probe: deterministically damage a byte payload, or pass through."""
    p = _active
    return data if p is None else p.corrupt(site, data)


def degrade(site: str, value: int) -> int:
    """Probe: shrink a capacity (skew amplification), or pass through."""
    p = _active
    return value if p is None else p.degrade(site, value)


def stall(site: str) -> float:
    """Probe: sleep the armed plan's injected delay, or no-op.
    Returns the injected seconds (0.0 when disarmed / not selected)."""
    p = _active
    return 0.0 if p is None else p.stall(site)


# env arming: chaos lanes set MOSAIC_TPU_FAULT_PLAN before pytest
_env_spec = os.environ.get("MOSAIC_TPU_FAULT_PLAN")
if _env_spec:
    arm(FaultPlan.from_spec(_env_spec))
