"""Supervised serving fleet: N crash-recovering worker processes.

Port copy of ``mosaic_tpu.serve.supervisor``.  The scheduler/executor
split (LocationSpark, arxiv 1907.03736) at the process level:
:class:`ServeFleet` spawns N worker processes, each running its own
:class:`~.server.QueryServer` + ``SQLSession`` on a **shared listening
socket** — ``SO_REUSEPORT`` where the kernel supports it
(per-connection load balancing, each worker owns its accept queue),
else one parent-bound socket inherited through ``pass_fds`` (shared
accept queue).  Each worker is its own CUDA process on the card: its
``MosaicContext`` runs on CUDA unless the fleet was given a device
(``device="cpu"``, the CPU tests' request), and it never falls back.
The port compiles nothing at run time: its kernels are built from
``csrc/`` into ``_build/``, keyed by their sources' hash
(``_kernels.build``), so a parent that built the cell kernel before
spawning leaves every worker a built library to load — a warm fleet
runs no ``nvcc`` (the JAX package's proof of the same is
``jax/cache/cache_misses == 0``).

Robustness contract — the fleet degrades, never dies:

* the supervisor health-checks children every ``mosaic.serve.fleet.
  health.ms``: ``Popen.poll`` liveness, a ``/healthz`` probe on the
  shared port, and spool-mtime staleness (``obs/spool.py`` heartbeat;
  a hung worker is SIGKILLed and treated as a crash);
* a crashed worker respawns through ``resilience.RetryPolicy``
  backoff (``FLEET_RESPAWN_BACKOFF`` schedules the delay, the
  ``serve.spawn`` fault site + ``SERVE_SPAWN_RETRY`` cover exec
  failures); K respawns inside ``mosaic.serve.fleet.restart.window.
  ms`` trips the circuit breaker: the slot is parked, a
  ``fleet_degraded`` event + ``fleet/degraded_workers`` gauge (SLO
  ``fleet_degraded``) fire, and the fleet runs at N-1;
* per-tenant admission state lives in the shared
  :class:`~.scoreboard.Scoreboard`; the supervisor reaps dead-owner
  slots every ``mosaic.serve.fleet.reap.ms``;
* SIGTERM/SIGINT forward to every child, which drains (the workers
  install :meth:`QueryServer.install_sigterm_drain`); children still
  alive after ``mosaic.serve.drain.ms`` are hard-killed and counted
  in ``serve/drain_forced``.  The parent-bound socket (fallback mode)
  closes only after the last worker exits, so queued connections
  drain before the listener disappears.

CLI (also the worker entry point — the supervisor re-execs this
module with ``--worker``)::

    python -m mosaic_tpu_torch.serve.supervisor --workers 3 \
        --port 8817 --tables /path/tables.npz \
        --conf mosaic.serve.quota.qps=50 [--device cpu]

Status is written atomically to ``<fleet.dir>/supervisor.json`` each
tick; the same directory doubles as the telemetry fleet plane
(``mosaic.obs.fleet.dir``), so ``tools/fleetctl.py`` and the
dashboard's fleet panel see supervisor + workers in one place.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence

from ..obs import metrics
from ..obs.recorder import recorder
from ..obs.timeseries import timeseries
from ..resilience import faults
from ..resilience.retry import FLEET_RESPAWN_BACKOFF, SERVE_SPAWN_RETRY
from .scoreboard import Scoreboard

__all__ = ["ServeFleet", "WorkerSlot", "worker_main", "main",
           "SCOREBOARD_FILE", "SUPERVISOR_FILE"]

SCOREBOARD_FILE = "scoreboard.bin"
SUPERVISOR_FILE = "supervisor.json"
_READY_PREFIX = "ready-"

#: environment contract between supervisor and worker processes
_ENV_DIR = "MOSAIC_FLEET_DIR"
_ENV_HOST = "MOSAIC_FLEET_HOST"
_ENV_PORT = "MOSAIC_FLEET_PORT"
_ENV_SOCK_FD = "MOSAIC_FLEET_SOCKET_FD"
_ENV_TABLES = "MOSAIC_FLEET_TABLES"
_ENV_FACTORY = "MOSAIC_FLEET_FACTORY"
_ENV_CONF = "MOSAIC_FLEET_CONF"
_ENV_GRID = "MOSAIC_FLEET_GRID"
_ENV_INDEX = "MOSAIC_FLEET_INDEX"
#: the port's own: the device a worker's context runs on ("" = CUDA)
_ENV_DEVICE = "MOSAIC_FLEET_DEVICE"

_DEFAULT_GRID = "CUSTOM(-180,180,-90,90,2,360,180)"


def _atomic_write_json(path: str, payload: Dict[str, object]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, sort_keys=True)
    os.replace(tmp, path)


def _reuse_port_supported() -> bool:
    return hasattr(socket, "SO_REUSEPORT")


class WorkerSlot:
    """One worker position in the fleet: the live process (if any),
    its restart history inside the breaker window, and the respawn
    schedule.  Mutated only under the fleet's lock."""

    __slots__ = ("index", "proc", "pid", "spawned_t", "restarts",
                 "degraded", "next_respawn_t", "ready")

    def __init__(self, index: int):
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.pid: int = 0
        self.spawned_t: float = 0.0
        #: crash timestamps inside the breaker window
        self.restarts: Deque[float] = collections.deque()
        self.degraded = False
        self.next_respawn_t: float = 0.0
        self.ready = False

    def view(self, now: float) -> Dict[str, object]:
        alive = self.proc is not None and self.proc.poll() is None
        return {"index": self.index, "pid": self.pid,
                "alive": alive, "ready": self.ready,
                "degraded": self.degraded,
                "restarts": len(self.restarts),
                "uptime_s": round(now - self.spawned_t, 1)
                if alive and self.spawned_t else 0.0}


class ServeFleet:
    """Spawn, watch, and drain N query-server worker processes.

    ``worker_cmd`` swaps the child argv (tests use a torch-free stub
    that writes its ready file and sleeps); the default re-execs this
    module with ``--worker`` so the child builds a real
    ``QueryServer`` from the environment contract above.  ``device``
    is the workers' device ("cpu" or "cuda"; None = CUDA, which raises
    in a worker on a host without it).
    """

    def __init__(self, workers: Optional[int] = None,
                 host: str = "127.0.0.1",
                 port: Optional[int] = None,
                 fleet_dir: Optional[str] = None,
                 tables: Optional[Dict[str, Dict[str, object]]] = None,
                 tables_npz: Optional[str] = None,
                 factory: Optional[str] = None,
                 grid: str = _DEFAULT_GRID,
                 conf: Optional[Dict[str, object]] = None,
                 worker_cmd: Optional[Sequence[str]] = None,
                 force_parent_socket: bool = False,
                 device: Optional[str] = None):
        from .. import config as _config
        cfg = _config.default_config()
        self.workers_n = int(cfg.serve_fleet_workers
                             if workers is None else workers)
        if self.workers_n <= 0:
            raise ValueError("a fleet needs at least one worker")
        self.host = host
        self.port = int(cfg.serve_port if port is None else port)
        self.fleet_dir = fleet_dir or cfg.serve_fleet_dir or ""
        self.grid = grid
        self.conf = dict(conf or {})
        self.factory = factory or ""
        self.device = str(device) if device else ""
        self.worker_cmd = list(worker_cmd) if worker_cmd else None
        self._tables = tables
        self._tables_npz = tables_npz or ""
        self._restart_max = int(cfg.serve_fleet_restart_max)
        self._restart_window_s = cfg.serve_fleet_restart_window_ms / 1e3
        self._health_ms = float(cfg.serve_fleet_health_ms)
        self._reap_s = cfg.serve_fleet_reap_ms / 1e3
        self._stale_s = cfg.obs_fleet_stale_ms / 1e3
        self._drain_s = cfg.serve_drain_ms / 1e3
        self._force_parent_socket = bool(force_parent_socket)
        self.mode = ""                  # reuse_port | parent_socket
        self.scoreboard: Optional[Scoreboard] = None
        self._sock: Optional[socket.socket] = None
        self._slots: List[WorkerSlot] = []
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._started = False
        self._stopping = False
        self._last_reap = 0.0
        self._prev_handlers: Dict[int, object] = {}

    # -- lifecycle -----------------------------------------------------
    def start(self, wait_ready: bool = True,
              ready_timeout_s: float = 90.0) -> "ServeFleet":
        with self._lock:
            if self._started:
                return self
            self._started = True
            if not self.fleet_dir:
                import tempfile
                self.fleet_dir = tempfile.mkdtemp(prefix="mosaic-fleet-")
            os.makedirs(self.fleet_dir, exist_ok=True)
            if self._tables is not None and not self._tables_npz:
                self._tables_npz = os.path.join(self.fleet_dir,
                                                "tables.npz")
                self._save_tables_locked()
            self._bind_locked()
            self.scoreboard = Scoreboard(
                os.path.join(self.fleet_dir, SCOREBOARD_FILE))
            self._slots = [WorkerSlot(i) for i in range(self.workers_n)]
        for slot in self._slots:
            self._spawn(slot, respawn=False)
        if wait_ready:
            self._wait_ready(ready_timeout_s)
        from ..obs.slo import fleet_objectives, monitor
        for obj in fleet_objectives():
            monitor.add_objective(obj)
        metrics.gauge("fleet/live_workers", float(self.workers_n))
        timeseries.record("fleet/degraded_workers", 0.0)
        if self._health_ms > 0:
            t = threading.Thread(target=self._health_main, daemon=True,
                                 name="mosaic-fleet-health")
            with self._lock:
                self._health_thread = t
            t.start()
        self._write_status()
        return self

    def _save_tables_locked(self) -> None:
        import numpy as np
        flat = {f"{t}::{c}": arr
                for t, cols in (self._tables or {}).items()
                for c, arr in cols.items()}
        np.savez(self._tables_npz, **flat)

    def _bind_locked(self) -> None:
        """Pick the socket-sharing mode and pin the fleet port."""
        if _reuse_port_supported() and not self._force_parent_socket:
            self.mode = "reuse_port"
            if self.port == 0:
                probe = socket.socket(socket.AF_INET,
                                      socket.SOCK_STREAM)
                probe.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEPORT, 1)
                probe.bind((self.host, 0))
                self.port = probe.getsockname()[1]
                probe.close()
            return
        self.mode = "parent_socket"
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(128)
        s.set_inheritable(True)
        self._sock = s
        self.port = s.getsockname()[1]

    def __enter__(self) -> "ServeFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- spawning ------------------------------------------------------
    def _worker_env(self, index: int) -> Dict[str, str]:
        env = dict(os.environ)
        env[_ENV_DIR] = self.fleet_dir
        env[_ENV_HOST] = self.host
        env[_ENV_PORT] = str(self.port)
        env[_ENV_GRID] = self.grid
        env[_ENV_INDEX] = str(index)
        env[_ENV_CONF] = json.dumps(self.conf)
        if self._tables_npz:
            env[_ENV_TABLES] = self._tables_npz
        if self.factory:
            env[_ENV_FACTORY] = self.factory
        if self.device:
            env[_ENV_DEVICE] = self.device
        else:
            env.pop(_ENV_DEVICE, None)
        if self._sock is not None:
            env[_ENV_SOCK_FD] = str(self._sock.fileno())
        else:
            env.pop(_ENV_SOCK_FD, None)
        return env

    def _spawn_once(self, slot: WorkerSlot) -> subprocess.Popen:
        faults.maybe_fail("serve.spawn")
        cmd = self.worker_cmd or [sys.executable, "-m",
                                  "mosaic_tpu_torch.serve.supervisor",
                                  "--worker"]
        pass_fds = (self._sock.fileno(),) if self._sock is not None \
            else ()
        return subprocess.Popen(cmd, env=self._worker_env(slot.index),
                                pass_fds=pass_fds)

    def _spawn(self, slot: WorkerSlot, respawn: bool) -> bool:
        """Spawn one worker through the retry policy; returns False
        when even the retried spawn failed (the health loop treats
        that as a crash for the breaker)."""
        try:
            proc = SERVE_SPAWN_RETRY.call(self._spawn_once, slot)
        except OSError:
            metrics.count("serve/worker_spawn_failures")
            return False
        now = time.time()
        with self._lock:
            slot.proc = proc
            slot.pid = proc.pid
            slot.spawned_t = now
            slot.ready = False
        metrics.count("serve/worker_spawns")
        if respawn:
            metrics.count("serve/worker_respawns")
        recorder.record("fleet_worker_spawn", index=slot.index,
                        pid=proc.pid, respawn=respawn)
        return True

    def _wait_ready(self, timeout_s: float) -> int:
        """Block until every live slot's pid has published its ready
        file (workers write it once their listener is up).  Returns
        the ready count; raises only when NOTHING came up."""
        deadline = time.time() + timeout_s
        while True:
            ready = self._ready_pids()
            n = pending = 0
            with self._lock:
                for slot in self._slots:
                    if slot.pid in ready:
                        slot.ready = True
                for slot in self._slots:
                    n += bool(slot.ready)
                    if not slot.ready and slot.proc is not None \
                            and slot.proc.poll() is None:
                        pending += 1
            if n >= self.workers_n or time.time() >= deadline:
                break
            if pending == 0:
                break       # the rest crashed or never spawned
            time.sleep(0.05)
        if n == 0:
            self.stop(drain=False)
            raise RuntimeError(
                f"no fleet worker became ready within {timeout_s}s")
        return n

    def _ready_pids(self) -> set:
        out = set()
        try:
            names = os.listdir(self.fleet_dir)
        except OSError:
            return out
        for name in names:
            if name.startswith(_READY_PREFIX) \
                    and name.endswith(".json"):
                try:
                    out.add(int(name[len(_READY_PREFIX):-5]))
                except ValueError:
                    continue
        return out

    # -- health loop ---------------------------------------------------
    def _health_main(self) -> None:
        period = self._health_ms / 1e3
        while not self._stop_evt.wait(period):
            try:
                self.tick()
            except Exception:           # the watchdog must outlive any
                metrics.count("serve/health_errors")     # one bad tick

    def tick(self, now: Optional[float] = None) -> None:
        """One health pass (public so tests drive it without the
        thread): crash detection + breaker, due respawns, stale-spool
        kills, scoreboard reaping, status publication."""
        now = time.time() if now is None else now
        with self._lock:
            if self._stopping:
                return
            slots = list(self._slots)
        ready = self._ready_pids()
        for slot in slots:
            self._check_slot(slot, now, ready)
        with self._lock:
            if now - self._last_reap >= self._reap_s \
                    and self.scoreboard is not None:
                self._last_reap = now
                sb = self.scoreboard
            else:
                sb = None
        if sb is not None:
            sb.reap(now)
        self._probe_healthz()
        n_live = sum(1 for s in slots
                     if s.proc is not None and s.proc.poll() is None)
        n_deg = sum(1 for s in slots if s.degraded)
        metrics.gauge("fleet/live_workers", float(n_live))
        metrics.gauge("fleet/degraded_workers", float(n_deg))
        timeseries.record("fleet/degraded_workers", float(n_deg))
        self._write_status(now)

    def _check_slot(self, slot: WorkerSlot, now: float,
                    ready: set) -> None:
        with self._lock:
            proc = slot.proc
            if proc is not None and slot.pid in ready:
                slot.ready = True
        if slot.degraded:
            return
        if proc is not None:
            rc = proc.poll()
            if rc is None:
                self._check_stale(slot, proc, now)
                return
            # the worker died under us: book the crash, schedule the
            # respawn (or trip the breaker)
            metrics.count("serve/worker_crashes")
            recorder.record("fleet_worker_exit", index=slot.index,
                            pid=slot.pid, returncode=rc)
            with self._lock:
                slot.proc = None
                slot.ready = False
                slot.restarts.append(now)
                while slot.restarts and \
                        now - slot.restarts[0] > self._restart_window_s:
                    slot.restarts.popleft()
                if len(slot.restarts) > self._restart_max:
                    slot.degraded = True
                    n = len(slot.restarts)
                else:
                    slot.next_respawn_t = now + \
                        FLEET_RESPAWN_BACKOFF.delay(
                            max(0, len(slot.restarts) - 1))
                    return
            # breaker tripped: run degraded at N-1, never exit
            metrics.count("serve/fleet_degraded")
            recorder.record(
                "fleet_degraded", index=slot.index, restarts=n,
                window_ms=self._restart_window_s * 1e3)
            return
        # parked between crash and respawn: is the backoff due?
        if now >= slot.next_respawn_t:
            if not self._spawn(slot, respawn=True):
                with self._lock:
                    slot.restarts.append(now)
                    if len(slot.restarts) > self._restart_max:
                        slot.degraded = True
                    else:
                        slot.next_respawn_t = now + \
                            FLEET_RESPAWN_BACKOFF.delay(
                                max(0, len(slot.restarts) - 1))

    def _check_stale(self, slot: WorkerSlot,
                     proc: subprocess.Popen, now: float) -> None:
        """A live pid whose telemetry spool stopped aging is hung
        (deadlocked loop, wedged device call): SIGKILL it and let the
        crash path respawn a fresh one.  Only applies once the worker
        has spooled at least once — spooling is conf-gated."""
        from ..obs.spool import spool_path
        path = spool_path(self.fleet_dir, slot.pid)
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            return
        if age > max(0.1, 4.0 * self._stale_s):
            metrics.count("serve/worker_stale_kills")
            try:
                proc.kill()
            except OSError:
                pass

    def _probe_healthz(self) -> None:
        """One GET /healthz against the shared port per tick.  With
        SO_REUSEPORT the kernel picks a worker, so over successive
        ticks this samples the fleet; failures are counted, not
        attributed (a single refused connect cannot name a pid)."""
        import http.client
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=1.0)
            try:
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    metrics.count("serve/healthz_ok")
                else:
                    metrics.count("serve/healthz_errors")
            finally:
                conn.close()
        except OSError:
            metrics.count("serve/healthz_errors")

    # -- status --------------------------------------------------------
    def status(self, now: Optional[float] = None) -> Dict[str, object]:
        now = time.time() if now is None else now
        with self._lock:
            slots = [s.view(now) for s in self._slots]
            stopping = self._stopping
        sb = self.scoreboard
        return {
            "pid": os.getpid(),
            "t": now,
            "host": self.host,
            "port": self.port,
            "mode": self.mode,
            "stopping": stopping,
            "workers": slots,
            "live": sum(1 for s in slots if s["alive"]),
            "degraded": sum(1 for s in slots if s["degraded"]),
            "scoreboard": sb.snapshot(now) if sb is not None else None,
        }

    def _write_status(self, now: Optional[float] = None) -> None:
        try:
            _atomic_write_json(
                os.path.join(self.fleet_dir, SUPERVISOR_FILE),
                self.status(now))
        except OSError:
            metrics.count("serve/status_write_errors")

    def worker_pids(self) -> List[int]:
        with self._lock:
            return [s.pid for s in self._slots
                    if s.proc is not None and s.proc.poll() is None]

    # -- signals + drain -----------------------------------------------
    def install_signal_handlers(self) -> None:
        """Forward SIGTERM/SIGINT into the fleet drain (main thread
        only — CPython restricts ``signal.signal``)."""
        def _on_signal(signum, frame):
            threading.Thread(target=self.stop, kwargs={"drain": True},
                             daemon=True,
                             name="mosaic-fleet-drain").start()
        with self._lock:
            self._prev_handlers = {
                signal.SIGTERM: signal.signal(signal.SIGTERM,
                                              _on_signal),
                signal.SIGINT: signal.signal(signal.SIGINT,
                                             _on_signal),
            }

    def stop(self, drain: bool = True) -> None:
        """Stop the fleet.  ``drain=True`` forwards SIGTERM to every
        child (each worker runs its own drain-with-deadline) and
        waits ``mosaic.serve.drain.ms`` + grace; whatever survives is
        hard-killed and counted in ``serve/drain_forced``.  The signal
        handlers :meth:`install_signal_handlers` replaced go back when
        a stop runs on the main thread (CPython's rule): a drain started
        by the signal leaves them for the owner's later ``stop()``."""
        with self._lock:
            if self._stopping:
                stopped = True
            else:
                stopped, self._stopping = False, True
                health = self._health_thread
                self._health_thread = None
        if stopped:
            self._restore_handlers()
            return
        self._stop_evt.set()
        if health is not None and health is not \
                threading.current_thread():
            health.join(5.0)
        with self._lock:
            procs = [(s, s.proc) for s in self._slots
                     if s.proc is not None]
        sig = signal.SIGTERM if drain else signal.SIGKILL
        for _, p in procs:
            try:
                p.send_signal(sig)
            except (OSError, ProcessLookupError):
                pass
        # workers drain against their own mosaic.serve.drain.ms; give
        # them that budget plus scheduling grace before forcing
        deadline = time.time() + (self._drain_s + 2.0 if drain else 5.0)
        pending = list(procs)
        while pending and time.time() < deadline:
            pending = [(s, p) for s, p in pending if p.poll() is None]
            if pending:
                time.sleep(0.05)
        for _, p in pending:
            metrics.count("serve/drain_forced")
            try:
                p.kill()
            except (OSError, ProcessLookupError):
                pass
        for _, p in procs:
            try:
                p.wait(5.0)
            except Exception:
                pass
        # the shared listener (fallback mode) outlives every worker:
        # queued connections drained above, nothing new gets lost
        with self._lock:
            sock, self._sock = self._sock, None
            sb, self.scoreboard = self.scoreboard, None
        if sock is not None:
            sock.close()
        if sb is not None:
            sb.close()
        self._restore_handlers()
        self._write_status()

    def _restore_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        with self._lock:
            prev, self._prev_handlers = self._prev_handlers, {}
        for signum, handler in prev.items():
            try:
                signal.signal(signum, handler)
            except (ValueError, OSError):
                pass

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until :meth:`stop` ran (signal handler or another
        thread); True when it did."""
        return self._stop_evt.wait(timeout)


# ---------------------------------------------------------------- worker

def _apply_worker_conf(fleet_dir: str, conf: Dict[str, object]) -> None:
    from .. import config as _config
    cfg = _config.default_config()
    merged = dict(conf)
    # the fleet runtime dir IS the telemetry fleet dir unless the
    # operator pointed spools elsewhere — one directory, one plane
    merged.setdefault(_config.MOSAIC_OBS_FLEET_DIR, fleet_dir)
    for key, value in merged.items():
        cfg = _config.apply_conf(cfg, key, str(value))
    _config.set_default_config(cfg)


def _build_session(grid: str, tables_npz: str, factory: str,
                   device: str = ""):
    from ..functions.context import MosaicContext
    from ..sql.engine import SQLSession
    ctx = MosaicContext.build(grid, device=device or None)
    if factory:
        mod, _, fn = factory.partition(":")
        import importlib
        session = getattr(importlib.import_module(mod), fn)(ctx)
        if not isinstance(session, SQLSession):
            raise TypeError(f"fleet factory {factory!r} returned "
                            f"{type(session).__name__}, not SQLSession")
        return session
    session = SQLSession(ctx)
    if tables_npz:
        import numpy as np
        with np.load(tables_npz) as data:
            tables: Dict[str, Dict[str, object]] = {}
            for key in data.files:
                tname, _, col = key.partition("::")
                tables.setdefault(tname, {})[col] = data[key]
        for tname, cols in tables.items():
            session.create_table(tname, cols)
    return session


def worker_main() -> int:
    """Child entry: build the session from the environment contract,
    serve on the shared socket, heartbeat via the telemetry spool,
    drain on SIGTERM, exit 0."""
    fleet_dir = os.environ[_ENV_DIR]
    host = os.environ.get(_ENV_HOST, "127.0.0.1")
    port = int(os.environ.get(_ENV_PORT, "0"))
    conf = json.loads(os.environ.get(_ENV_CONF, "{}"))
    _apply_worker_conf(fleet_dir, conf)
    metrics.enable()
    recorder.enable()
    session = _build_session(
        os.environ.get(_ENV_GRID, _DEFAULT_GRID),
        os.environ.get(_ENV_TABLES, ""),
        os.environ.get(_ENV_FACTORY, ""),
        os.environ.get(_ENV_DEVICE, ""))
    # MosaicContext.build installs its own fresh MosaicConfig as the
    # process default, wiping the fleet conf (sampler, quotas) —
    # re-apply so serving runs under the supervisor's conf
    _apply_worker_conf(fleet_dir, conf)
    sock = None
    fd = os.environ.get(_ENV_SOCK_FD, "")
    if fd:
        sock = socket.fromfd(int(fd), socket.AF_INET,
                             socket.SOCK_STREAM)
    sb = Scoreboard(os.path.join(fleet_dir, SCOREBOARD_FILE))
    from .server import QueryServer
    srv = QueryServer(session, host=host, port=port, sock=sock,
                      reuse_port=sock is None, scoreboard=sb)
    srv.start()
    srv.install_sigterm_drain()
    _atomic_write_json(
        os.path.join(fleet_dir, f"{_READY_PREFIX}{os.getpid()}.json"),
        {"pid": os.getpid(), "port": srv.port, "t": time.time()})
    try:
        srv.wait_stopped()
    finally:
        sb.close()
    return 0


# ------------------------------------------------------------------ CLI

def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="mosaic_tpu_torch serving-fleet supervisor")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)   # internal child mode
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--fleet-dir", default=None)
    ap.add_argument("--tables", default=None,
                    help="npz of table columns (keys 'table::col')")
    ap.add_argument("--factory", default=None,
                    help="module:callable -> SQLSession(ctx)")
    ap.add_argument("--grid", default=_DEFAULT_GRID)
    ap.add_argument("--device", default=None,
                    help="the workers' device, cpu or cuda (default: "
                         "CUDA)")
    ap.add_argument("--conf", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="conf forwarded to every worker (repeat)")
    args = ap.parse_args(argv)
    if args.worker:
        if args.device:
            os.environ[_ENV_DEVICE] = args.device
        return worker_main()
    conf: Dict[str, object] = {}
    for item in args.conf:
        if "=" not in item:
            ap.error(f"--conf wants KEY=VALUE, got {item!r}")
        k, v = item.split("=", 1)
        conf[k.strip()] = v.strip()
    fleet = ServeFleet(workers=args.workers, host=args.host,
                       port=args.port, fleet_dir=args.fleet_dir,
                       tables_npz=args.tables, factory=args.factory,
                       grid=args.grid, conf=conf, device=args.device)
    fleet.start()
    fleet.install_signal_handlers()
    print(json.dumps({"port": fleet.port, "mode": fleet.mode,
                      "fleet_dir": fleet.fleet_dir,
                      "workers": fleet.workers_n}))
    sys.stdout.flush()
    fleet.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
