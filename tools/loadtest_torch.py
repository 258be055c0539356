#!/usr/bin/env python
"""Load generator for the mosaic_tpu_torch query server (serve/).

Port of ``tools/loadtest.py``: it imports ``mosaic_tpu_torch`` only.
Importable (``chip_smoke.py``'s fleet drill calls :func:`run_loadtest`
in-process; :func:`deadline_curve` is the same sweep) and a CLI::

    python tools/loadtest_torch.py --url http://127.0.0.1:8817 \
        --clients 8 --duration 3 --sql "SELECT count(*) FROM pts"

N concurrent closed-loop clients (one thread + one keep-alive-free
HTTP connection each) replay a weighted query mix against ``POST
/query``; client-observed latency lands in the repo's own metrics
histograms (``serve/client_ms`` — the same reservoir machinery every
other percentile in the codebase uses), so the report's p50/p95/p99
are computed by ``obs.metrics``, not by this script.  Outcomes are
bucketed by HTTP status: ok (200), denied (429 admission), shed
(429 with reason=shed), deadline (504), cancelled (499), error.

Fleet mode (``--fleet`` / ``failover=True``): connects retry with
jittered backoff through the port's
``resilience.retry.LOADTEST_CONNECT_RETRY`` (bounded — a down fleet
still fails), and a request that dies with a torn connection mid-flight
(a reset, or a 200 JSON-lines answer with fewer rows than its head
says: a worker killed while writing it) is retried ONCE on a fresh
connection —
against a ``ServeFleet`` the kernel routes the retry to a surviving
worker, so a SIGKILLed worker costs latency, not answers.  The
summary reports ``connect_retries`` and ``failovers`` separately from
the ``lost`` outcome bucket (dead even after the retry), so a kill
drill distinguishes lost-forever from retried-ok.

:func:`deadline_curve` sweeps offered QPS (open-loop pacing) under a
fixed per-request deadline and reports the deadline-miss fraction at
each level — the knee of that curve is the server's sustainable
throughput for an SLO.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

_HIST = "serve/client_ms"


def _w3c_traceparent(rng) -> str:
    """A fresh W3C traceparent from the client's RNG (all-zero ids
    are invalid per spec, so re-roll the astronomically unlikely)."""
    trace = rng.getrandbits(128) or 1
    span = rng.getrandbits(64) or 1
    return f"00-{trace:032x}-{span:016x}-01"


class ClientCounters:
    """Thread-safe tally shared by every client thread: connect
    retries, mid-flight failovers — the kill drill's evidence that
    requests were retried-ok rather than lost."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, int] = {}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._data[key] = self._data.get(key, 0) + n

    def get(self, key: str) -> int:
        with self._lock:
            return self._data.get(key, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._data)


def _connect(host: str, port: int, timeout: float,
             counters: Optional[ClientCounters]):
    """A connected HTTPConnection, retrying refused/reset connects
    with the bounded jittered-backoff policy (a fleet worker dying
    between accept queues surfaces here)."""
    import http.client
    from mosaic_tpu_torch.resilience.retry import LOADTEST_CONNECT_RETRY

    def attempt():
        c = http.client.HTTPConnection(host, port, timeout=timeout)
        c.connect()
        return c

    def on_retry(exc, n):
        if counters is not None:
            counters.bump("connect_retries")

    return LOADTEST_CONNECT_RETRY.call(attempt, on_retry=on_retry)


def _check_complete(body: bytes) -> None:
    """Raise ConnectionError when a 200 JSON-lines answer ended early.
    The server streams it with no length and closes the connection, so
    a worker killed while writing it leaves a clean EOF that
    ``HTTPResponse.read`` takes for the end: the rows read must add up
    to the head's count.  (The JAX package's tool counts such an answer
    ok; ROADMAP C19.)"""
    lines = body.split(b"\n")
    try:
        want = json.loads(lines[0])["rows"]
        got = sum(len(json.loads(ln)) for ln in lines[1:] if ln)
    except (ValueError, KeyError, TypeError):
        raise ConnectionError("torn JSON-lines answer") from None
    if got != want:
        raise ConnectionError(f"torn JSON-lines answer: {got} of {want} "
                              "rows")


def _post_query(host: str, port: int, sql: str, principal: str,
                priority: int = 0, deadline_ms: float = 0.0,
                timeout: float = 30.0,
                traceparent: Optional[str] = None,
                counters: Optional[ClientCounters] = None,
                failover: bool = False) -> Tuple[int, str]:
    """One POST /query on a fresh connection; returns (status,
    reason) where reason is the deny reason for 429s, "" otherwise.
    ``failover=True`` retries a torn-connection request exactly once
    on a fresh connection (queries are read-only — safe to replay);
    the second failure propagates to the caller as lost."""

    def attempt() -> Tuple[int, str]:
        conn = _connect(host, port, timeout, counters)
        try:
            headers = {"X-Mosaic-Principal": principal,
                       "Content-Type": "text/plain"}
            if priority:
                headers["X-Mosaic-Priority"] = str(priority)
            if deadline_ms > 0:
                headers["X-Mosaic-Deadline-Ms"] = str(deadline_ms)
            if traceparent:
                headers["traceparent"] = traceparent
            conn.request("POST", "/query", body=sql.encode(),
                         headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status == 200 and \
                    "jsonl" in (resp.getheader("Content-Type") or ""):
                _check_complete(body)
            reason = ""
            if resp.status in (429, 503):
                try:
                    reason = json.loads(body).get("reason", "")
                except Exception:
                    pass
            return resp.status, reason
        finally:
            conn.close()

    try:
        return attempt()
    except Exception:
        if not failover:
            raise
        if counters is not None:
            counters.bump("failovers")
        return attempt()


def _bucket(status: int, reason: str) -> str:
    if status == 200:
        return "ok"
    if status == 429:
        return "shed" if reason == "shed" else "denied"
    if status == 504:
        return "deadline"
    if status == 499:
        return "cancelled"
    if status == 503:
        return "denied"
    return "error"


def run_loadtest(host: str, port: int,
                 mix: Sequence[Tuple[str, float]],
                 clients: int = 8,
                 duration_s: float = 3.0,
                 principals: Optional[Sequence[str]] = None,
                 deadline_ms: float = 0.0,
                 priority_of: Optional[Dict[str, int]] = None,
                 failover: bool = False
                 ) -> Dict[str, object]:
    """Closed-loop burst: ``clients`` threads each loop pick-query →
    POST → record for ``duration_s``.  ``mix`` is ``[(sql, weight)]``;
    clients are assigned principals round-robin from ``principals``
    (default: one shared "loadtest" tenant).  ``failover=True`` is
    fleet mode: torn requests retry once against surviving workers.
    Returns the aggregate report (see module docstring)."""
    from mosaic_tpu_torch.obs import metrics
    from mosaic_tpu_torch.obs.context import link_traceparent, new_trace
    from mosaic_tpu_torch.obs.tracer import tracer
    tracer.enable()               # client spans must exist to stitch
    metrics.enable()
    principals = list(principals or ["loadtest"])
    priority_of = priority_of or {}
    weights = [max(0.0, w) for _, w in mix]
    total_w = sum(weights) or 1.0
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total_w
        cum.append(acc)
    lock = threading.Lock()
    outcomes: Dict[str, int] = {}
    by_principal: Dict[str, Dict[str, int]] = {}
    counters = ClientCounters()
    lat_key = f"{_HIST}@{time.monotonic_ns()}"  # fresh reservoir per run

    def pick(r: float) -> str:
        for (sql, _), edge in zip(mix, cum):
            if r <= edge:
                return sql
        return mix[-1][0]

    def client(idx: int) -> None:
        import random
        rng = random.Random(1_000 + idx)
        principal = principals[idx % len(principals)]
        prio = priority_of.get(principal, 0)
        t_end = time.perf_counter() + duration_s
        while time.perf_counter() < t_end:
            sql = pick(rng.random())
            # every request carries a fresh W3C traceparent, and the
            # client's own trace links to the SAME id — the server
            # worker links its query trace to it too, so both sides'
            # spans stitch into one cross-process tree in the fleet
            # bundle (fleet.stitched_traces)
            tp = _w3c_traceparent(rng)
            t0 = time.perf_counter()
            lost = False
            try:
                with link_traceparent(tp), \
                        new_trace(f"client:{principal}"):
                    with tracer.span("loadtest/request"):
                        status, reason = _post_query(
                            host, port, sql, principal, priority=prio,
                            deadline_ms=deadline_ms, traceparent=tp,
                            counters=counters, failover=failover)
            except Exception:
                # no answer even after the failover retry (or failover
                # off): this request is gone for good
                status, reason, lost = -1, "", True
            dt_ms = (time.perf_counter() - t0) * 1e3
            b = "lost" if lost else _bucket(status, reason)
            if b == "ok":
                metrics.observe(lat_key, dt_ms)
            with lock:
                outcomes[b] = outcomes.get(b, 0) + 1
                per = by_principal.setdefault(principal, {})
                per[b] = per.get(b, 0) + 1
            if b in ("denied", "shed"):
                time.sleep(0.01)     # honor the 429 a little

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_s + 30.0)
    wall = time.perf_counter() - t0
    snap = metrics.report().get("histograms", {}).get(lat_key, {})
    n = sum(outcomes.values())
    answered = n - outcomes.get("lost", 0)
    return {
        "clients": clients,
        "duration_s": round(wall, 3),
        "requests": n,
        "qps": round(n / max(1e-9, wall), 1),
        "ok_qps": round(outcomes.get("ok", 0) / max(1e-9, wall), 1),
        "outcomes": dict(sorted(outcomes.items())),
        # answered / sent: every request the server answered (ok,
        # denied, shed, ... — an honest 429 is availability, a torn
        # socket with no retry success is not)
        "availability": round(answered / max(1, n), 4),
        "connect_retries": counters.get("connect_retries"),
        "failovers": counters.get("failovers"),
        "lost": outcomes.get("lost", 0),
        "by_principal": {p: dict(sorted(v.items()))
                         for p, v in sorted(by_principal.items())},
        "latency_ms": {k: snap.get(k) for k in
                       ("count", "mean", "p50", "p95", "p99", "max")},
    }


def deadline_curve(host: str, port: int, sql: str,
                   deadline_ms: float,
                   qps_levels: Sequence[float] = (2, 5, 10, 20, 40),
                   duration_s: float = 2.0,
                   principal: str = "loadtest"
                   ) -> List[Dict[str, object]]:
    """QPS-vs-deadline-miss curve: open-loop paced offers at each
    level; a miss is any request that did not come back 200 within
    the deadline (504s, denies, sheds all count — the client asked
    and the answer wasn't the data in time)."""
    curve: List[Dict[str, object]] = []
    for qps in qps_levels:
        period = 1.0 / float(qps)
        results: List[str] = []
        lock = threading.Lock()
        threads: List[threading.Thread] = []

        def fire() -> None:
            try:
                status, reason = _post_query(
                    host, port, sql, principal,
                    deadline_ms=deadline_ms,
                    timeout=deadline_ms / 1e3 + 5.0)
            except Exception:
                status, reason = -1, ""
            with lock:
                results.append(_bucket(status, reason))

        t_end = time.perf_counter() + duration_s
        nxt = time.perf_counter()
        while time.perf_counter() < t_end:
            th = threading.Thread(target=fire, daemon=True)
            th.start()
            threads.append(th)
            nxt += period
            lag = nxt - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        for th in threads:
            th.join(deadline_ms / 1e3 + 10.0)
        n = len(results)
        miss = sum(1 for b in results if b != "ok")
        curve.append({"offered_qps": float(qps),
                      "requests": n,
                      "miss": miss,
                      "miss_frac": round(miss / max(1, n), 4)})
    return curve


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", required=True,
                    help="server base url, e.g. http://127.0.0.1:8817")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--sql", action="append", required=True,
                    help="query to replay (repeat for a mix; "
                         "'WEIGHT:SQL' to weight)")
    ap.add_argument("--principal", action="append", default=None,
                    help="tenant name (repeat; clients round-robin)")
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--fleet", action="store_true",
                    help="fleet mode: retry a torn-connection request "
                         "once against surviving workers (failover)")
    ap.add_argument("--curve", action="store_true",
                    help="also sweep the QPS-vs-deadline-miss curve "
                         "(first --sql, needs --deadline-ms)")
    args = ap.parse_args(argv)
    from urllib.parse import urlparse
    u = urlparse(args.url)
    host, port = u.hostname or "127.0.0.1", u.port or 80
    mix: List[Tuple[str, float]] = []
    for s in args.sql:
        if ":" in s and s.split(":", 1)[0].replace(".", "").isdigit():
            w, q = s.split(":", 1)
            mix.append((q, float(w)))
        else:
            mix.append((s, 1.0))
    report = run_loadtest(host, port, mix, clients=args.clients,
                          duration_s=args.duration,
                          principals=args.principal,
                          deadline_ms=args.deadline_ms,
                          failover=args.fleet)
    if args.curve and args.deadline_ms > 0:
        report["deadline_curve"] = deadline_curve(
            host, port, mix[0][0], args.deadline_ms)
    json.dump(report, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
