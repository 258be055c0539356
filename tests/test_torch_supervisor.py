"""The port's serving-fleet supervisor
(``mosaic_tpu_torch.serve.supervisor``): the 10 cases of
``tests/test_supervisor.py`` on fake workers, and one fleet of a real
port worker asked for the CPU.

The ten swap ``worker_cmd`` for a tiny torch-free stub that writes its
ready file and sleeps, so the supervisor's control plane —
spawn/ready bookkeeping, crash detection + backoff respawn, the
crash-loop circuit breaker, SIGTERM drain with the bounded hard-kill
path, and the ``serve.spawn`` fault site — is exercised in
milliseconds.  The last case spawns the real worker
(``python -m mosaic_tpu_torch.serve.supervisor --worker`` with the CPU
asked for), loads its table from the fleet's npz and answers a
micro-batched point lookup equal to the host ``point_to_cell``.  The
fleet on the card (kill drill, no ``nvcc`` in a worker) runs in
``chip_smoke.py`` phase 24d.
"""

import http.client
import json
import os
import signal
import socket
import sys
import textwrap
import time

import numpy as np
import pytest

from mosaic_tpu_torch import config as _config
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.obs.recorder import recorder
from mosaic_tpu_torch.resilience import faults
from mosaic_tpu_torch.resilience.testing import fault_plan  # noqa: F401
from mosaic_tpu_torch.serve.supervisor import (SCOREBOARD_FILE,
                                               SUPERVISOR_FILE, ServeFleet)

pytestmark = pytest.mark.skipif(os.name != "posix",
                                reason="fleet supervisor is POSIX")

#: a worker that comes up instantly: ready file, then sleep; exits 0
#: on SIGTERM like a draining QueryServer would
_STUB = textwrap.dedent("""
    import json, os, signal, sys, time
    d = os.environ["MOSAIC_FLEET_DIR"]
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    with open(os.path.join(d, "ready-%d.json" % os.getpid()), "w") as f:
        json.dump({"pid": os.getpid()}, f)
    time.sleep(120)
""")

#: a worker that refuses to drain: SIGTERM is ignored
_STUB_DEAF = _STUB.replace(
    "lambda *a: sys.exit(0)", "signal.SIG_IGN")

#: a worker that dies before ever becoming ready
_STUB_DOA = "import sys; sys.exit(3)"


def _stub_cmd(src=_STUB):
    return [sys.executable, "-c", src]


@pytest.fixture
def fleet_env():
    prev = _config.default_config()
    metrics.reset()
    metrics.enable()
    recorder.reset()
    recorder.enable()
    yield
    faults.disarm()
    _config.set_default_config(prev)
    metrics.disable()
    metrics.reset()
    recorder.reset()


def _conf(**keys):
    cfg = _config.default_config()
    for k, v in keys.items():
        cfg = _config.apply_conf(cfg, k.replace("_", "."), str(v))
    _config.set_default_config(cfg)


def _counter(name):
    return metrics.report()["counters"].get(name, 0)


def _events(name):
    return recorder.events(name)


def _fleet(tmp_path, workers=2, stub=_STUB, **kw):
    return ServeFleet(workers=workers, port=0,
                      fleet_dir=str(tmp_path / "fleet"),
                      worker_cmd=_stub_cmd(stub), **kw)


# --------------------------------------------------------- lifecycle

def test_start_ready_status_stop(tmp_path, fleet_env):
    _conf(mosaic_serve_fleet_health_ms=0)    # tests drive tick()
    fleet = _fleet(tmp_path, workers=2)
    with fleet:
        assert len(fleet.worker_pids()) == 2
        st = fleet.status()
        assert st["live"] == 2 and st["degraded"] == 0
        assert all(w["ready"] for w in st["workers"])
        assert _counter("serve/worker_spawns") == 2
        assert len(_events("fleet_worker_spawn")) == 2
        # the fleet dir carries the whole control plane
        names = os.listdir(fleet.fleet_dir)
        assert SCOREBOARD_FILE in names and SUPERVISOR_FILE in names
    # clean drain: stubs exit on SIGTERM, nothing was forced
    assert _counter("serve/drain_forced") == 0
    assert fleet.worker_pids() == []
    disk = json.load(open(os.path.join(fleet.fleet_dir,
                                       SUPERVISOR_FILE)))
    assert disk["stopping"] is True and disk["live"] == 0


def test_no_worker_ready_raises(tmp_path, fleet_env):
    _conf(mosaic_serve_fleet_health_ms=0)
    fleet = _fleet(tmp_path, workers=2, stub=_STUB_DOA)
    with pytest.raises(RuntimeError, match="no fleet worker"):
        fleet.start(ready_timeout_s=10)


def test_parent_socket_fallback_mode(tmp_path, fleet_env):
    _conf(mosaic_serve_fleet_health_ms=0)
    with _fleet(tmp_path, workers=1,
                force_parent_socket=True) as fleet:
        assert fleet.mode == "parent_socket"
        # the parent holds a real listener: connects are accepted
        # (queued) even though the stub never calls accept()
        with socket.create_connection(("127.0.0.1", fleet.port),
                                      timeout=5):
            pass
    # stop() closed it
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", fleet.port),
                                 timeout=0.5)


# ------------------------------------------------- crash -> respawn

def test_crash_respawns_through_backoff(tmp_path, fleet_env):
    _conf(mosaic_serve_fleet_health_ms=0)
    with _fleet(tmp_path, workers=2) as fleet:
        victim = fleet.worker_pids()[0]
        os.kill(victim, signal.SIGKILL)
        deadline = time.time() + 1.0      # let the kernel reap it
        while time.time() < deadline:
            fleet.tick()
            if _counter("serve/worker_crashes"):
                break
            time.sleep(0.02)
        assert _counter("serve/worker_crashes") == 1
        assert len(_events("fleet_worker_exit")) == 1
        # parked until the backoff is due; a far-future tick respawns
        fleet.tick(now=time.time() + 60.0)
        pids = fleet.worker_pids()
        assert len(pids) == 2 and victim not in pids
        assert _counter("serve/worker_respawns") == 1
        st = fleet.status()
        assert st["degraded"] == 0
        assert [w for w in st["workers"]
                if w["restarts"] == 1] != []


def test_breaker_parks_slot_and_fleet_survives(tmp_path, fleet_env):
    _conf(mosaic_serve_fleet_health_ms=0,
          mosaic_serve_fleet_restart_max=1,
          mosaic_serve_fleet_restart_window_ms=600_000)
    with _fleet(tmp_path, workers=2) as fleet:
        for round_ in range(2):           # crash 1 respawns; 2 trips
            victim = fleet.status()["workers"][0]["pid"]
            os.kill(victim, signal.SIGKILL)
            deadline = time.time() + 1.0
            while time.time() < deadline:
                fleet.tick(now=time.time() + 60.0 * (round_ + 1))
                ws = fleet.status()["workers"][0]
                if ws["degraded"] or (ws["alive"] and
                                      ws["pid"] != victim):
                    break
                time.sleep(0.02)
        st = fleet.status()
        assert st["degraded"] == 1
        assert st["live"] == 1            # degraded = run at N-1
        assert _counter("serve/fleet_degraded") == 1
        evs = _events("fleet_degraded")
        assert len(evs) == 1 and evs[0]["index"] == 0
        # the breaker holds: more ticks never resurrect the slot
        fleet.tick(now=time.time() + 600.0)
        assert fleet.status()["live"] == 1
        assert _counter("serve/fleet_degraded") == 1


# ------------------------------------------------------- drain paths

def test_sigterm_ignoring_worker_is_force_killed(tmp_path, fleet_env):
    _conf(mosaic_serve_fleet_health_ms=0,
          mosaic_serve_drain_ms=200)
    fleet = _fleet(tmp_path, workers=2, stub=_STUB_DEAF)
    fleet.start()
    pids = fleet.worker_pids()
    t0 = time.time()
    fleet.stop(drain=True)
    assert _counter("serve/drain_forced") == 2
    assert time.time() - t0 < 10.0        # bounded, not a hang
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_signal_handler_drains_fleet(tmp_path, fleet_env):
    _conf(mosaic_serve_fleet_health_ms=0)
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    fleet = _fleet(tmp_path, workers=1)
    fleet.start()
    fleet.install_signal_handlers()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert fleet.wait(timeout=10.0)
        deadline = time.time() + 5.0
        while fleet.worker_pids() and time.time() < deadline:
            time.sleep(0.05)
        assert fleet.worker_pids() == []
        assert _counter("serve/drain_forced") == 0
    finally:
        fleet.stop()
    # the owner's stop on the main thread put the handlers back
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


# ------------------------------------------------------ spawn chaos

def test_spawn_fault_is_retried(tmp_path, fleet_env, fault_plan):
    _conf(mosaic_serve_fleet_health_ms=0)
    fault_plan("seed=5;site=serve.spawn,fails=1,error=OSError")
    with _fleet(tmp_path, workers=2) as fleet:
        # first exec raised, SERVE_SPAWN_RETRY recovered it
        assert len(fleet.worker_pids()) == 2
        assert _counter("retry/recovered/serve.spawn") == 1
        assert _counter("serve/worker_spawns") == 2


def test_spawn_fault_exhaustion_counts_failure(tmp_path, fleet_env,
                                               fault_plan):
    """Every attempt for one slot fails: the slot books a spawn
    failure and the OTHER worker still comes up — degrade, not die."""
    _conf(mosaic_serve_fleet_health_ms=0)
    fault_plan("seed=5;site=serve.spawn,fails=3,error=OSError")
    fleet = _fleet(tmp_path, workers=2)
    with fleet:
        assert _counter("serve/worker_spawn_failures") == 1
        assert _counter("retry/giveups/serve.spawn") == 1
        assert len(fleet.worker_pids()) == 1


# -------------------------------------------------------- reap tick

def test_tick_reaps_dead_scoreboard_claims(tmp_path, fleet_env):
    from mosaic_tpu_torch.serve.scoreboard import Scoreboard
    _conf(mosaic_serve_fleet_health_ms=0,
          mosaic_serve_fleet_reap_ms=0)     # reap on every tick
    with _fleet(tmp_path, workers=1) as fleet:
        sb_path = os.path.join(fleet.fleet_dir, SCOREBOARD_FILE)
        victim = fleet.worker_pids()[0]
        with Scoreboard(sb_path) as mine:
            # plant a claim owned by the worker, then kill the worker
            tok, deny = mine.admit("t", 0, 0)
            assert deny is None
            from mosaic_tpu_torch.serve import scoreboard as _sbmod
            off = _sbmod._HEADER_SIZE + tok.index * _sbmod._SLOT_SIZE
            with open(sb_path, "r+b") as f:
                raw = bytearray(_sbmod._SLOT.pack(
                    tok.seq, 1, victim, time.time(),
                    b"t".ljust(44, b"\0")))
                f.seek(off)
                f.write(bytes(raw))
            os.kill(victim, signal.SIGKILL)
            deadline = time.time() + 2.0
            while time.time() < deadline:
                fleet.tick()
                if mine.counts("t")["concurrency"] == 0:
                    break
                time.sleep(0.02)
            assert mine.counts("t")["concurrency"] == 0


# ------------------------------------------------- a real port worker

def test_real_worker_on_cpu_answers_point_lookup(tmp_path, fleet_env):
    """One real port worker, asked for the CPU, serves its npz table
    on the fleet port: a point lookup answers 200 with cells equal to
    the host ``point_to_cell``; SIGTERM drains it with nothing
    forced."""
    from mosaic_tpu_torch.core.index.factory import get_index_system
    _conf(mosaic_serve_fleet_health_ms=0)
    rng = np.random.default_rng(24)
    xy = np.stack([rng.uniform(-74.05, -73.85, 700),
                   rng.uniform(40.6, 40.9, 700)], -1)
    tables = {"pts": {"lon": xy[:, 0], "lat": xy[:, 1],
                      "id": np.arange(len(xy))}}
    fleet = ServeFleet(workers=1, port=0,
                       fleet_dir=str(tmp_path / "fleet"), tables=tables,
                       grid="H3", device="cpu",
                       conf={"mosaic.serve.workers": "1"})
    with fleet:
        assert fleet.status()["live"] == 1
        conn = http.client.HTTPConnection("127.0.0.1", fleet.port,
                                          timeout=30)
        try:
            conn.request("POST", "/query", body=(
                b"SELECT id, grid_longlatascellid(lon, lat, 9) AS cell "
                b"FROM pts"), headers={"X-Mosaic-Principal": "w"})
            r = conn.getresponse()
            status, body = r.status, r.read()
        finally:
            conn.close()
        assert status == 200, body[:300]
        lines = body.decode().splitlines()
        assert json.loads(lines[0])["columns"] == ["id", "cell"]
        rows = np.asarray([r for ln in lines[1:] for r in json.loads(ln)],
                          dtype=np.int64)
        want = get_index_system("H3").point_to_cell(xy, 9)
        assert np.array_equal(rows[:, 0], np.arange(len(xy)))
        assert np.array_equal(rows[:, 1], want)
    assert _counter("serve/drain_forced") == 0
    assert fleet.worker_pids() == []
