"""Fleet-wide admission state: an mmap-backed tenant scoreboard.

Port copy of ``mosaic_tpu.serve.scoreboard``: the same file layout
(magic ``MSCB``, version 1, 64-byte header and slots), so either
package's workers can share one scoreboard file.  The
:class:`~.admission.AdmissionQueue` keeps rate windows and concurrency
counts in process memory, which is exactly right for one worker and
exactly wrong for a fleet: N workers each enforcing a per-tenant quota
of Q admit N x Q.  The scoreboard moves that state into one mmap'd file
every worker opens, so quotas hold fleet-wide and — the robustness half
— a SIGKILLed worker *releases* its claims instead of leaking them.

Design (all sizes fixed so readers can never mis-frame a record):

* one 64-byte header (magic, version, geometry, a monotone high-water
  mark of per-tenant concurrency observed at claim time — the kill
  drill's over-admission witness), then ``nslots`` 64-byte slots;
* a slot is ``seq | kind | owner pid | claim ts | tenant``; ``kind``
  is FREE / CONC (one queued-or-running query) / RATE (one admission
  in the 1 s sliding window);
* every mutation runs under ONE advisory ``fcntl.lockf`` region (plus
  an in-process ``threading.Lock`` — POSIX record locks do not
  exclude threads of the same process), so admit is an atomic
  count-and-claim: **over-admission is impossible by construction**,
  and because the kernel drops a dead process's locks, a worker dying
  inside the critical section cannot wedge the fleet;
* slot sequence numbers are a seqlock: a writer bumps ``seq`` odd,
  writes the record, bumps it even.  A slot left odd means its writer
  died mid-write; parsers treat it (and any unparseable bytes — the
  ``scoreboard.slot`` fault site corrupts reads in chaos tests) as
  invalid, count ``scoreboard/torn``, and the allocator reuses it —
  torn state degrades to a fresh slot, never a crash;
* CONC slots carry the owner pid; :meth:`reap` frees slots whose
  owner is gone (``os.kill(pid, 0)``).  Admission also self-heals: a
  tenant about to be denied on concurrency first reaps its own dead
  holders and recounts.  Under-admission is therefore bounded by the
  supervisor's reap interval (``mosaic.serve.fleet.reap.ms``), and by
  one denied request under load.

RATE slots expire out of the window by timestamp and are reclaimed by
the allocator; they need no owner liveness.
"""

from __future__ import annotations

import contextlib
import errno
import mmap
import os
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from ..obs import metrics
from ..resilience import faults

try:                                    # POSIX advisory record locks;
    import fcntl                        # the repo targets linux (CI +
except ImportError:                     # container), but keep imports
    fcntl = None                        # degradable for doc tooling

__all__ = ["Scoreboard", "ScoreboardError", "SlotToken",
           "RATE_WINDOW_S"]

#: rate-quota sliding window — must match admission._RATE_WINDOW_S
RATE_WINDOW_S = 1.0

_MAGIC = b"MSCB"
_VERSION = 1

#: header: magic 4s | version I | nslots I | slot_size I | created d |
#: high_water I (max per-tenant concurrency ever observed at claim)
_HEADER = struct.Struct("<4sIIIdI")
_HEADER_SIZE = 64

#: slot: seq I | kind B | pad 3x | pid I | ts d | tenant 44s
_SLOT = struct.Struct("<IBxxxId44s")
_SLOT_SIZE = 64
assert _SLOT.size == _SLOT_SIZE and _HEADER.size <= _HEADER_SIZE

_FREE, _CONC, _RATE = 0, 1, 2
_TENANT_BYTES = 44

#: default slot count when config carries none (import-order safety)
_DEFAULT_SLOTS = 512


class ScoreboardError(RuntimeError):
    """The scoreboard file is unusable (wrong magic/version/geometry).
    Raised at open time only — a live scoreboard degrades per-slot."""


class SlotToken:
    """One held concurrency claim: slot index + the seq stamped at
    claim time, so a stale release (the slot was reaped and reused)
    is detected instead of freeing someone else's claim."""

    __slots__ = ("index", "seq")

    def __init__(self, index: int, seq: int):
        self.index = index
        self.seq = seq

    def __repr__(self) -> str:          # pragma: no cover - debug aid
        return f"SlotToken(index={self.index}, seq={self.seq})"


def _pid_alive(pid: int) -> bool:
    """Liveness probe for a slot owner.  Signal 0 delivers nothing;
    EPERM means the pid exists under another uid — alive."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return True                     # unknown: do not reap
    return True


class Scoreboard:
    """Shared per-tenant admission ledger over one mmap'd file.

    Thread-safe and process-safe: every mutation (and every counting
    read that feeds an admit decision) runs under the in-process lock
    plus the advisory file lock.  ``snapshot()`` is read-only but
    takes the same locks — the file is tiny (64 KiB at the default
    512 slots) and admission latency is dominated by the query, not
    this scan.
    """

    def __init__(self, path: str, slots: Optional[int] = None,
                 reap_ms: Optional[float] = None):
        from .. import config as _config
        cfg = _config.default_config()
        self.path = path
        self.nslots = int(slots if slots is not None else getattr(
            cfg, "serve_scoreboard_slots", _DEFAULT_SLOTS))
        if self.nslots <= 0:
            raise ScoreboardError("scoreboard needs at least one slot")
        self.reap_ms = float(reap_ms if reap_ms is not None else
                             getattr(cfg, "serve_fleet_reap_ms",
                                     1_000.0))
        self._lock = threading.Lock()
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self._mm: Optional[mmap.mmap] = None
        try:
            with self._flock():
                self._init_or_attach_locked()
        except Exception:
            os.close(self._fd)
            raise

    # -- file lifecycle ------------------------------------------------
    def _init_or_attach_locked(self) -> None:
        """Called under the file lock: first opener writes the header
        and zeroed slots; later openers validate geometry (a mismatch
        means two configs disagree about the same path — refuse)."""
        size = _HEADER_SIZE + self.nslots * _SLOT_SIZE
        st = os.fstat(self._fd)
        if st.st_size == 0:
            os.ftruncate(self._fd, size)
            os.pwrite(self._fd, _HEADER.pack(
                _MAGIC, _VERSION, self.nslots, _SLOT_SIZE,
                time.time(), 0), 0)
        else:
            head = os.pread(self._fd, _HEADER.size, 0)
            if len(head) < _HEADER.size:
                raise ScoreboardError(
                    f"scoreboard {self.path}: truncated header")
            magic, ver, nslots, ssize, _, _ = _HEADER.unpack(head)
            if magic != _MAGIC or ver != _VERSION \
                    or ssize != _SLOT_SIZE:
                raise ScoreboardError(
                    f"scoreboard {self.path}: bad magic/version "
                    f"({magic!r} v{ver} slot {ssize})")
            self.nslots = nslots
            size = _HEADER_SIZE + nslots * _SLOT_SIZE
            if st.st_size < size:
                raise ScoreboardError(
                    f"scoreboard {self.path}: file shorter than its "
                    f"declared geometry")
        self._mm = mmap.mmap(self._fd, size)

    def close(self) -> None:
        with self._lock:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            if self._fd >= 0:
                os.close(self._fd)
                self._fd = -1

    def __enter__(self) -> "Scoreboard":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- locking -------------------------------------------------------
    @contextlib.contextmanager
    def _flock(self) -> Iterator[None]:
        """The cross-process critical section.  The kernel releases
        record locks when the holder dies, so a worker SIGKILLed here
        cannot deadlock the fleet."""
        if fcntl is None:               # pragma: no cover - non-posix
            yield
            return
        while True:
            try:
                fcntl.lockf(self._fd, fcntl.LOCK_EX, 1)
                break
            except OSError as e:        # pragma: no cover - rare
                if e.errno != errno.EINTR:
                    raise
        try:
            yield
        finally:
            try:
                fcntl.lockf(self._fd, fcntl.LOCK_UN, 1)
            except OSError:             # pragma: no cover - teardown
                pass

    # -- slot codec ----------------------------------------------------
    def _slot_off(self, i: int) -> int:
        return _HEADER_SIZE + i * _SLOT_SIZE

    def _read_slot_locked(self, i: int
                          ) -> Optional[Tuple[int, int, int, float,
                                              bytes]]:
        """Parse slot ``i`` -> (seq, kind, pid, ts, tenant) or None
        when the bytes are torn (odd seq, bad kind, undecodable).
        Routes the raw bytes through the ``scoreboard.slot`` fault
        site so chaos tests can tear any read deterministically."""
        raw = self._mm[self._slot_off(i):self._slot_off(i) + _SLOT_SIZE]
        raw = faults.corrupt("scoreboard.slot", raw)
        try:
            seq, kind, pid, ts, tenant = _SLOT.unpack(raw)
        except struct.error:
            metrics.count("scoreboard/torn")
            return None
        if seq % 2 or kind not in (_FREE, _CONC, _RATE):
            metrics.count("scoreboard/torn")
            return None
        return seq, kind, pid, ts, tenant.rstrip(b"\0")

    def _write_slot_locked(self, i: int, kind: int, pid: int,
                           ts: float, tenant: bytes,
                           prev_seq: int) -> int:
        """Seqlock write: odd (in progress) -> record -> even.  Only
        ever called under both locks; the odd intermediate exists so a
        writer dying mid-write leaves a self-describing torn slot."""
        off = self._slot_off(i)
        odd = (prev_seq + 1) | 1
        struct.pack_into("<I", self._mm, off, odd & 0xFFFFFFFF)
        new_seq = (odd + 1) & 0xFFFFFFFF
        self._mm[off:off + _SLOT_SIZE] = _SLOT.pack(
            new_seq, kind, pid, ts,
            tenant[:_TENANT_BYTES].ljust(_TENANT_BYTES, b"\0"))
        return new_seq

    def _free_slot_locked(self, i: int, prev_seq: int) -> None:
        self._write_slot_locked(i, _FREE, 0, 0.0, b"", prev_seq)

    # -- header helpers ------------------------------------------------
    def _high_water_locked(self) -> int:
        try:
            return _HEADER.unpack(
                bytes(self._mm[:_HEADER.size]))[5]
        except struct.error:            # pragma: no cover - torn header
            return 0

    def _bump_high_water_locked(self, conc: int) -> None:
        if conc > self._high_water_locked():
            struct.pack_into("<I", self._mm, _HEADER.size - 4, conc)

    # -- core scan -----------------------------------------------------
    def _scan_locked(self, now: float):
        """One pass over every slot -> (per-tenant conc list, rate
        list, free indices).  Torn slots land in ``free`` (we hold the
        lock, so no live writer can own them)."""
        conc: Dict[bytes, List[Tuple[int, int, int]]] = {}
        rate: Dict[bytes, List[Tuple[int, float]]] = {}
        free: List[Tuple[int, int]] = []
        for i in range(self.nslots):
            parsed = self._read_slot_locked(i)
            if parsed is None:
                free.append((i, 0))     # torn: reuse, seq restarts
                continue
            seq, kind, pid, ts, tenant = parsed
            if kind == _FREE:
                free.append((i, seq))
            elif kind == _CONC:
                conc.setdefault(tenant, []).append((i, seq, pid))
            else:                       # RATE: expired == free
                if now - ts <= RATE_WINDOW_S:
                    rate.setdefault(tenant, []).append((i, ts))
                else:
                    free.append((i, seq))
        return conc, rate, free

    # -- public API ----------------------------------------------------
    def admit(self, tenant: str, quota_concurrency: int,
              quota_qps: float, now: Optional[float] = None
              ) -> Tuple[Optional[SlotToken],
                         Optional[Tuple[str, float]]]:
        """Atomic count-and-claim for one request.

        Returns ``(token, None)`` on admission — the token holds the
        CONC slot until :meth:`release` — or ``(None, (reason,
        retry_after_s))`` on refusal, with the same reason strings the
        in-process queue uses (``rate_quota`` / ``concurrency_quota``)
        plus ``scoreboard_full`` when no slot is free.
        """
        now = time.time() if now is None else now
        tb = tenant.encode("utf-8", "replace")[:_TENANT_BYTES]
        with self._lock, self._flock():
            conc, rate, free = self._scan_locked(now)
            tr = rate.get(tb, [])
            if quota_qps > 0 and len(tr) >= quota_qps:
                oldest = min(ts for _, ts in tr)
                return None, ("rate_quota",
                              max(0.05, oldest + RATE_WINDOW_S - now))
            holders = conc.get(tb, [])
            if quota_concurrency > 0 \
                    and len(holders) >= quota_concurrency:
                # self-heal before refusing: a dead holder's claim
                # must not deny a live tenant for a full reap interval
                live = []
                for i, seq, pid in holders:
                    if _pid_alive(pid):
                        live.append((i, seq, pid))
                    else:
                        self._free_slot_locked(i, seq)
                        free.append((i, seq + 2))
                        metrics.count("scoreboard/reaped")
                holders = live
                if len(holders) >= quota_concurrency:
                    return None, ("concurrency_quota", 0.1)
            need = 1 + (1 if quota_qps > 0 else 0)
            if len(free) < need:
                metrics.count("scoreboard/full")
                return None, ("scoreboard_full", 1.0)
            i, seq = free[0]
            new_seq = self._write_slot_locked(i, _CONC, os.getpid(),
                                              now, tb, seq)
            if quota_qps > 0:
                j, jseq = free[1]
                self._write_slot_locked(j, _RATE, os.getpid(), now,
                                        tb, jseq)
            self._bump_high_water_locked(len(holders) + 1)
            metrics.count("scoreboard/admits")
            return SlotToken(i, new_seq), None

    def release(self, token: Optional[SlotToken]) -> bool:
        """Free a held CONC slot.  A stale token (the slot was reaped
        and reused after its owner was presumed dead) is refused with
        a counter, never corrupts the new holder's claim."""
        if token is None:
            return False
        with self._lock, self._flock():
            parsed = self._read_slot_locked(token.index)
            if parsed is None:
                return False
            seq, kind, pid, _, _ = parsed
            if kind != _CONC or seq != token.seq:
                metrics.count("scoreboard/release_stale")
                return False
            self._free_slot_locked(token.index, seq)
            return True

    def reap(self, now: Optional[float] = None) -> int:
        """Free CONC slots whose owner pid is gone (plus expired RATE
        slots and torn slots); returns the number of dead-owner claims
        reclaimed.  The supervisor calls this on its health tick, so
        under-admission after a worker SIGKILL is bounded by
        ``mosaic.serve.fleet.reap.ms``."""
        now = time.time() if now is None else now
        reaped = 0
        with self._lock, self._flock():
            for i in range(self.nslots):
                parsed = self._read_slot_locked(i)
                if parsed is None:
                    self._free_slot_locked(i, 0)
                    continue
                seq, kind, pid, ts, _ = parsed
                if kind == _CONC and not _pid_alive(pid):
                    self._free_slot_locked(i, seq)
                    reaped += 1
                elif kind == _RATE and now - ts > RATE_WINDOW_S:
                    self._free_slot_locked(i, seq)
        if reaped:
            metrics.count("scoreboard/reaped", reaped)
        return reaped

    def counts(self, tenant: str, now: Optional[float] = None
               ) -> Dict[str, int]:
        """Live claim counts for one tenant (dead owners included —
        call :meth:`reap` first for the healed view)."""
        now = time.time() if now is None else now
        tb = tenant.encode("utf-8", "replace")[:_TENANT_BYTES]
        with self._lock, self._flock():
            conc, rate, _ = self._scan_locked(now)
            return {"concurrency": len(conc.get(tb, [])),
                    "rate": len(rate.get(tb, []))}

    def high_water(self) -> int:
        """Max per-tenant concurrency ever observed at claim time —
        the over-admission witness the kill drill asserts on."""
        with self._lock, self._flock():
            return self._high_water_locked()

    def snapshot(self, now: Optional[float] = None
                 ) -> Dict[str, object]:
        """Aggregate view for /stats and supervisor.json."""
        now = time.time() if now is None else now
        with self._lock, self._flock():
            conc, rate, free = self._scan_locked(now)
            tenants = sorted({t.decode("utf-8", "replace")
                              for t in (set(conc) | set(rate))})
            return {
                "path": self.path,
                "slots": self.nslots,
                "free": len(free),
                "high_water": self._high_water_locked(),
                "tenants": {
                    t: {"concurrency":
                        len(conc.get(t.encode(), [])),
                        "rate": len(rate.get(t.encode(), []))}
                    for t in tenants},
            }
