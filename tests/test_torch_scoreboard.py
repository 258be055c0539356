"""The port's fleet admission scoreboard
(``mosaic_tpu_torch.serve.scoreboard``): the 15 cases of
``tests/test_scoreboard.py`` on the port, the two-process ones with a
child that imports only the port, and one more: the same admit /
release / reap sequence through both packages' ``Scoreboard`` gives
equal snapshots and equal slot bytes, and either package reads the
other's file.

The robustness contract under test: quotas hold across processes
through one mmap'd file (over-admission impossible by construction),
a SIGKILLed holder's claims are reclaimed — by ``reap()`` within the
supervisor's interval, or immediately by admission's self-heal on a
concurrency deny — and torn slot bytes (a writer dying mid-seqlock,
or the ``scoreboard.slot`` chaos site flipping bits) degrade to a
fresh slot, never a crash.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from mosaic_tpu_torch import config as _config
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.resilience import faults
from mosaic_tpu_torch.resilience.testing import fault_plan  # noqa: F401
from mosaic_tpu_torch.serve.scoreboard import (RATE_WINDOW_S, Scoreboard,
                                               ScoreboardError, SlotToken)

pytestmark = pytest.mark.skipif(os.name != "posix",
                                reason="fcntl/mmap scoreboard is POSIX")


@pytest.fixture
def sb_env():
    """Metrics on + clean, config restored, faults disarmed."""
    prev = _config.default_config()
    metrics.reset()
    metrics.enable()
    yield
    faults.disarm()
    _config.set_default_config(prev)
    metrics.disable()
    metrics.reset()


def _counter(name):
    return metrics.report()["counters"].get(name, 0)


# ------------------------------------------------------ basic claims

def test_admit_release_roundtrip(tmp_path, sb_env):
    with Scoreboard(str(tmp_path / "sb.bin"), slots=16) as sb:
        tok, deny = sb.admit("a", quota_concurrency=2, quota_qps=0)
        assert deny is None and isinstance(tok, SlotToken)
        assert sb.counts("a")["concurrency"] == 1
        assert sb.release(tok) is True
        assert sb.counts("a")["concurrency"] == 0
        # releasing twice is refused, not corrupting
        assert sb.release(tok) is False
        assert _counter("scoreboard/release_stale") == 1


def test_concurrency_quota_denies_at_limit(tmp_path, sb_env):
    with Scoreboard(str(tmp_path / "sb.bin"), slots=16) as sb:
        toks = [sb.admit("a", 2, 0)[0] for _ in range(2)]
        assert all(toks)
        tok, deny = sb.admit("a", 2, 0)
        assert tok is None and deny[0] == "concurrency_quota"
        # another tenant is unaffected
        tok_b, deny_b = sb.admit("b", 2, 0)
        assert deny_b is None
        sb.release(tok_b)
        for t in toks:
            sb.release(t)
        assert sb.admit("a", 2, 0)[0] is not None


def test_rate_quota_denies_with_retry_after(tmp_path, sb_env):
    with Scoreboard(str(tmp_path / "sb.bin"), slots=16) as sb:
        t0 = 1_000.0
        for k in range(3):
            tok, deny = sb.admit("a", 0, 3, now=t0 + k * 0.01)
            assert deny is None
            sb.release(tok)
        tok, deny = sb.admit("a", 0, 3, now=t0 + 0.05)
        assert tok is None
        reason, retry = deny
        assert reason == "rate_quota"
        assert 0.0 < retry <= RATE_WINDOW_S
        # the window slides: past RATE_WINDOW_S the claims expire
        tok, deny = sb.admit("a", 0, 3, now=t0 + RATE_WINDOW_S + 0.1)
        assert deny is None
        sb.release(tok)


def test_scoreboard_full_reason(tmp_path, sb_env):
    with Scoreboard(str(tmp_path / "sb.bin"), slots=2) as sb:
        assert sb.admit("a", 0, 0)[0] is not None
        assert sb.admit("b", 0, 0)[0] is not None
        tok, deny = sb.admit("c", 0, 0)
        assert tok is None and deny[0] == "scoreboard_full"
        assert _counter("scoreboard/full") == 1


def test_high_water_tracks_max_concurrency(tmp_path, sb_env):
    with Scoreboard(str(tmp_path / "sb.bin"), slots=16) as sb:
        toks = [sb.admit("a", 8, 0)[0] for _ in range(3)]
        for t in toks:
            sb.release(t)
        assert sb.high_water() == 3
        # high water is monotone: draining does not lower it
        tok = sb.admit("a", 8, 0)[0]
        sb.release(tok)
        assert sb.high_water() == 3


def test_reopen_attaches_and_validates(tmp_path, sb_env):
    path = str(tmp_path / "sb.bin")
    with Scoreboard(path, slots=8) as sb:
        tok = sb.admit("a", 0, 0)[0]
        assert tok is not None
    # a second opener sees the same geometry and live claims
    with Scoreboard(path, slots=999) as sb2:   # slots from the file
        assert sb2.nslots == 8
        assert sb2.counts("a")["concurrency"] == 1
    with open(path, "r+b") as f:
        f.write(b"XXXX")
    with pytest.raises(ScoreboardError):
        Scoreboard(path)


def test_snapshot_shape(tmp_path, sb_env):
    with Scoreboard(str(tmp_path / "sb.bin"), slots=8) as sb:
        sb.admit("a", 0, 5)
        snap = sb.snapshot()
        assert snap["slots"] == 8
        assert snap["tenants"]["a"]["concurrency"] == 1
        assert snap["tenants"]["a"]["rate"] == 1
        assert snap["free"] == 8 - 2


# ----------------------------------------- crash-recovery property

_CHILD = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    sys.modules["jax"] = None
    sys.modules["mosaic_tpu"] = None
    from mosaic_tpu_torch.serve.scoreboard import Scoreboard
    sb = Scoreboard({path!r})
    toks = []
    for _ in range({n}):
        tok, deny = sb.admit({tenant!r}, {quota}, 0)
        assert deny is None, deny
        toks.append(tok)
    print(json.dumps({{"pid": os.getpid(),
                       "held": len(toks)}}), flush=True)
    time.sleep(60)        # hold the claims until SIGKILLed
""")


def _spawn_holder(path, tenant, n, quota):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, "-c",
         _CHILD.format(repo=repo, path=path, tenant=tenant,
                       n=n, quota=quota)],
        stdout=subprocess.PIPE, text=True)
    line = p.stdout.readline()
    return p, json.loads(line)


def test_killed_holder_never_over_admits(tmp_path, sb_env):
    """The property the fleet depends on: at every point between a
    holder's SIGKILL and its reap, admitted-live + admitted-dead never
    exceeds the quota (no over-admission), and the dead claims are
    reclaimed — immediately by the deny-path self-heal, and at the
    latest by the next reap tick."""
    path = str(tmp_path / "sb.bin")
    quota = 3
    with Scoreboard(path, slots=32) as sb:
        p, info = _spawn_holder(path, "a", 2, quota)
        assert info["held"] == 2
        assert sb.counts("a")["concurrency"] == 2
        # one more fits; the fourth would breach the quota
        tok3, deny = sb.admit("a", quota, 0)
        assert deny is None
        tok4, deny = sb.admit("a", quota, 0)
        assert tok4 is None and deny[0] == "concurrency_quota"

        os.kill(p.pid, signal.SIGKILL)
        p.wait(10)
        # the dead holder's 2 claims still occupy slots until healed;
        # admission self-heals on the deny path, so the very next
        # admit both reclaims them and admits — never over the quota
        tok5, deny = sb.admit("a", quota, 0)
        assert deny is None, deny
        assert _counter("scoreboard/reaped") >= 2
        assert sb.counts("a")["concurrency"] == 2   # tok3 + tok5
        assert sb.high_water() <= quota             # the witness
        sb.release(tok3)
        sb.release(tok5)


def test_reap_reclaims_within_interval(tmp_path, sb_env):
    path = str(tmp_path / "sb.bin")
    with Scoreboard(path, slots=32) as sb:
        p, info = _spawn_holder(path, "a", 3, 0)
        assert sb.counts("a")["concurrency"] == 3
        os.kill(p.pid, signal.SIGKILL)
        p.wait(10)
        # no admission pressure: reap() alone must reclaim all three
        assert sb.reap() == 3
        assert sb.counts("a")["concurrency"] == 0
        assert sb.reap() == 0               # idempotent


def test_stale_token_release_after_reap_is_refused(tmp_path, sb_env):
    """A token whose slot was reaped (owner presumed dead) and reused
    by another tenant must not free the new holder's claim."""
    path = str(tmp_path / "sb.bin")
    with Scoreboard(path, slots=1) as sb:
        p, _ = _spawn_holder(path, "a", 1, 0)
        os.kill(p.pid, signal.SIGKILL)
        p.wait(10)
        sb.reap()
        tok_b, deny = sb.admit("b", 0, 0)
        assert deny is None
        # forge the dead holder's view: same slot, older seq
        stale = SlotToken(tok_b.index, tok_b.seq - 2)
        assert sb.release(stale) is False
        assert sb.counts("b")["concurrency"] == 1
        assert sb.release(tok_b) is True


# --------------------------------------------------- torn-slot chaos

def test_torn_mmap_write_degrades_to_fresh_slot(tmp_path, sb_env):
    """Stomp a held slot with garbage (a writer dying mid-write):
    readers count it torn, reap re-zeroes it, admission reuses it —
    and nothing ever raises."""
    from mosaic_tpu_torch.serve import scoreboard as _sbmod
    path = str(tmp_path / "sb.bin")
    with Scoreboard(path, slots=4) as sb:
        tok, _ = sb.admit("a", 0, 0)
        off = _sbmod._HEADER_SIZE + tok.index * _sbmod._SLOT_SIZE
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(b"\xff" * 8)            # odd seq + bad kind
        assert sb.counts("a")["concurrency"] == 0
        assert _counter("scoreboard/torn") >= 1
        sb.reap()
        # all four slots admit again — the torn one was reclaimed
        toks = [sb.admit("b", 0, 0)[0] for _ in range(4)]
        assert all(toks)


def test_chaos_site_flips_slot_reads(tmp_path, sb_env, fault_plan):
    """The ``scoreboard.slot`` fault site: a flipped read parses as
    torn (or as a phantom record the seqlock rejects) and admission
    continues; the clean path afterwards is intact."""
    path = str(tmp_path / "sb.bin")
    with Scoreboard(path, slots=8) as sb:
        tok, _ = sb.admit("a", 0, 0)
        fault_plan("seed=31;site=scoreboard.slot,fails=8,mode=flip")
        # every slot read in this scan is damaged: degrade, not raise
        sb.counts("a")
        sb.reap()
        faults.disarm()
        # the claim survives on disk unless reap freed a torn copy;
        # either way the board still serves admissions
        tok2, deny = sb.admit("b", 4, 0)
        assert deny is None
        assert sb.release(tok2) is True


def test_truncated_chaos_read_counts_torn(tmp_path, sb_env, fault_plan):
    with Scoreboard(str(tmp_path / "sb.bin"), slots=4) as sb:
        sb.admit("a", 0, 0)
        fault_plan("seed=7;site=scoreboard.slot,fails=1,mode=truncate")
        sb.counts("a")                      # first slot read is torn
        assert _counter("scoreboard/torn") >= 1


# ------------------------------------------- admission-queue wiring

def test_admission_queue_enforces_via_scoreboard(tmp_path, sb_env):
    """Two AdmissionQueues (two would-be workers) over one scoreboard
    share one fleet-wide concurrency quota, and release() returns the
    claim for the next admit."""
    from mosaic_tpu_torch.serve.admission import (AdmissionQueue,
                                                  ServeRequest)
    with Scoreboard(str(tmp_path / "sb.bin"), slots=32) as sb:
        qa = AdmissionQueue(depth=8, quota_concurrency=2,
                            quota_qps=0, scoreboard=sb)
        qb = AdmissionQueue(depth=8, quota_concurrency=2,
                            quota_qps=0, scoreboard=sb)
        r1 = ServeRequest("SELECT 1", "a")
        r2 = ServeRequest("SELECT 1", "a")
        r3 = ServeRequest("SELECT 1", "a")
        assert qa.offer(r1) is None
        assert qb.offer(r2) is None       # second worker, same board
        deny = qa.offer(r3)
        assert deny is not None and deny.reason == "concurrency_quota"
        assert sb.counts("a")["concurrency"] == 2
        # take r1 through its worker lifecycle, then the slot frees
        assert qa.take(timeout=1.0) is r1
        qa.release(r1)
        assert sb.counts("a")["concurrency"] == 1
        r4 = ServeRequest("SELECT 1", "b")
        assert qb.offer(r4) is None
        qb.flush(503, "draining")
        assert sb.counts("b")["concurrency"] == 0


# ------------------------------------------- cross-process quotas

def test_two_processes_share_one_quota(tmp_path, sb_env):
    """N workers x quota Q must admit Q total, not N x Q — the bug
    the scoreboard exists to fix."""
    path = str(tmp_path / "sb.bin")
    with Scoreboard(path, slots=32) as sb:
        p, info = _spawn_holder(path, "a", 2, 4)
        try:
            assert info["held"] == 2
            # this process sees the other worker's claims: only two
            # more admissions fit under the fleet-wide quota of 4
            toks = []
            for _ in range(2):
                tok, deny = sb.admit("a", 4, 0)
                assert deny is None
                toks.append(tok)
            tok, deny = sb.admit("a", 4, 0)
            assert tok is None and deny[0] == "concurrency_quota"
            assert sb.high_water() == 4
            for t in toks:
                sb.release(t)
        finally:
            p.kill()
            p.wait(10)


# ------------------------------------------------- both packages alike

def _sequence(sb, t0):
    """One admit / release / reap sequence at fixed clocks; returns the
    decisions and the snapshot after each step (path dropped)."""
    out = []

    def snap(now):
        s = sb.snapshot(now=now)
        s.pop("path")
        return s

    toks = []
    for k, (tenant, conc, qps) in enumerate(
            [("a", 2, 0), ("a", 2, 0), ("a", 2, 0), ("b", 0, 3),
             ("b", 0, 3), ("b", 0, 3), ("b", 0, 3), ("c", 1, 2)]):
        now = t0 + 0.01 * k
        tok, deny = sb.admit(tenant, conc, qps, now=now)
        toks.append(tok)
        out.append((tenant, tok is not None, deny, snap(now)))
    for tok in toks[:2]:
        out.append(("release", sb.release(tok), None, snap(t0 + 0.2)))
    out.append(("reap", sb.reap(now=t0 + 2.0), None, snap(t0 + 2.0)))
    tok, deny = sb.admit("b", 0, 3, now=t0 + 2.1)
    out.append(("b", tok is not None, deny, snap(t0 + 2.1)))
    out.append(("high_water", sb.high_water(), None, None))
    return out


def test_same_sequence_same_board_in_both_packages(tmp_path, sb_env):
    """The same admit / release / reap sequence through both packages'
    ``Scoreboard`` (this process owns every claim): equal decisions,
    equal snapshots, equal slot bytes; each package opens the other's
    file and counts the same claims."""
    from mosaic_tpu.serve import scoreboard as jsb
    from mosaic_tpu_torch.serve import scoreboard as tsb
    t0 = 5_000.0
    mine, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    with tsb.Scoreboard(mine, slots=16) as a, \
            jsb.Scoreboard(theirs, slots=16) as b:
        assert _sequence(a, t0) == _sequence(b, t0)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        pa, pb = f.read(), g.read()
    assert len(pa) == len(pb) == tsb._HEADER_SIZE + 16 * tsb._SLOT_SIZE
    assert pa[tsb._HEADER_SIZE:] == pb[tsb._HEADER_SIZE:]
    with jsb.Scoreboard(mine) as b, tsb.Scoreboard(theirs) as a:
        for t in ("a", "b", "c"):
            assert b.counts(t, now=t0 + 2.1) == a.counts(t, now=t0 + 2.1)
        assert a.high_water() == b.high_water()
