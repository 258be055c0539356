"""The long-lived multi-tenant query frontend over one SQLSession.

Port copy of ``mosaic_tpu.serve.server``: the same endpoints, headers,
statuses and ``/stats`` payload.  Hand-rolled HTTP/1.1 on asyncio
streams (stdlib only — no http.server
thread-per-connection, no external framework): an event loop in a
background thread accepts connections, admits queries through
:class:`~.admission.AdmissionQueue`, and hands them to the shared
:class:`~.workers.WorkerPool`.  The asyncio side owns everything a
socket can tell us that a worker can't: a client that disconnects
mid-query (stream EOF) and a request that outlives its deadline both
flow into the request's cancel plumbing → ``inflight.cancel`` → the
running query raises at its next checkpoint, within one pipeline
chunk.  Overload degrades, never dies: quota and budget denies answer
429 with Retry-After, a full queue sheds lowest-priority principals
first, and SIGTERM (opt-in :func:`install_sigterm_drain`) drains with
a deadline — stop accepting, let in-flight work finish, then cancel
stragglers — instead of dropping connections on the floor.

Endpoints::

    POST /query     body = SQL text (or JSON {"sql": ...})
                    headers: X-Mosaic-Principal, X-Mosaic-Priority,
                             X-Mosaic-Deadline-Ms
                    200 JSON-lines stream | 400 | 429(+Retry-After) |
                    499 client closed | 503 draining | 504 deadline
    GET  /healthz   liveness + queue/worker gauges
    GET  /stats     the same payload the dashboard's /api/server shows
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import threading
import time
import weakref
from typing import Dict, Optional, Tuple

import numpy as np

from .. import _kernels, config as _config
from ..obs import metrics
from ..obs.recorder import recorder
from ..obs.timeseries import timeseries
from ..resilience import faults
from ..resilience.faults import InjectedFault
from ..sql.engine import SQLSession, Table, classify_batchable
from .admission import AdmissionQueue, ServeRequest
from .workers import WorkerPool

__all__ = ["QueryServer", "current_server", "install_sigterm_drain"]

#: rows per JSON-lines response chunk — small enough that a torn
#: connection surfaces within one write, large enough to amortize
#: serialization
_RESPONSE_CHUNK_ROWS = 8_192

_MAX_HEADER_BYTES = 65_536

#: the live server (weakly held) the dashboard's /api/server reads
_current: "Optional[weakref.ref]" = None


def current_server() -> "Optional[QueryServer]":
    return _current() if _current is not None else None


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def _column_cell(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


class QueryServer:
    """One server = one session, one admission queue, one worker pool,
    one background asyncio loop.  Context manager: ``with
    QueryServer(session) as srv: ...`` serves until exit."""

    def __init__(self, session: SQLSession,
                 host: str = "127.0.0.1",
                 port: Optional[int] = None,
                 workers: Optional[int] = None,
                 sock=None,
                 reuse_port: bool = False,
                 scoreboard=None):
        cfg = _config.default_config()
        self.session = session
        self.host = host
        self._want_port = cfg.serve_port if port is None else int(port)
        self.port: int = 0
        #: fleet mode (serve/supervisor.py): either an already-bound
        #: listening socket inherited from the supervisor, or
        #: SO_REUSEPORT so N worker processes share one (host, port)
        self._sock = sock
        self._reuse_port = bool(reuse_port)
        #: shared mmap Scoreboard — when set, per-tenant rate +
        #: concurrency quotas are enforced fleet-wide
        self.scoreboard = scoreboard
        self.queue = AdmissionQueue(
            depth=cfg.serve_queue_depth,
            quota_concurrency=cfg.serve_quota_concurrency,
            quota_qps=cfg.serve_quota_qps,
            scoreboard=scoreboard)
        self.pool = WorkerPool(
            session, self.queue,
            workers=cfg.serve_workers if workers is None else workers,
            batch_max=cfg.serve_batch_max,
            batch_window_ms=cfg.serve_batch_window_ms)
        self._default_deadline_ms = cfg.serve_deadline_ms
        self._drain_ms = cfg.serve_drain_ms
        self._batch_rows_max = cfg.serve_batch_rows_max
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._ready = threading.Event()
        self._stopped = threading.Event()
        self.draining = False
        self._sigterm_prev = None
        self.t_start = 0.0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "QueryServer":
        if self._thread is not None:
            return self
        self.t_start = time.time()
        self.pool.start()
        self._thread = threading.Thread(target=self._loop_main,
                                        daemon=True,
                                        name="mosaic-serve-loop")
        self._thread.start()
        if not self._ready.wait(10.0):
            raise RuntimeError("query server failed to start listening")
        from ..obs.slo import monitor, serve_objectives
        for obj in serve_objectives(self.queue.depth):
            monitor.add_objective(obj)
        global _current
        _current = weakref.ref(self)
        return self

    def stop(self, drain: bool = False) -> None:
        """Stop serving.  ``drain=True`` runs the graceful SIGTERM
        path first (finish in-flight work until ``mosaic.serve.
        drain.ms``); plain stop just closes and joins."""
        if drain:
            self.initiate_drain()
            self.await_drained(self._drain_ms / 1e3)
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(self._shutdown_loop)
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.queue.flush(503, "shutdown")
        self.pool.stop()
        # the previous SIGTERM handler goes back only from the main
        # thread (CPython's rule): a drain run by the signal itself
        # stops on a helper thread and leaves it for the owner's stop()
        if self._sigterm_prev is not None and \
                threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGTERM, self._sigterm_prev)
            except (ValueError, OSError):
                pass
            else:
                self._sigterm_prev = None
        global _current
        if _current is not None and _current() is self:
            _current = None

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- drain-on-SIGTERM ----------------------------------------------
    def initiate_drain(self) -> None:
        """Flip into drain mode: new queries answer 503, queued +
        running ones keep going until the drain deadline."""
        if self.draining:
            return
        self.draining = True
        self.queue.start_drain()
        recorder.record("serve_drain",
                        queued=self.queue.queued_count(),
                        running=self.queue.running_count(),
                        deadline_ms=self._drain_ms)
        if metrics.enabled:
            metrics.count("serve/drains")

    def await_drained(self, timeout_s: float) -> bool:
        """Wait for queue + workers to empty; past the deadline,
        cancel whatever still runs (reason ``drain`` → cooperative
        stop within one chunk) and flush the queue with 503s."""
        deadline = time.perf_counter() + max(0.0, timeout_s)
        while time.perf_counter() < deadline:
            if self.queue.queued_count() == 0 and self.pool.idle():
                return True
            time.sleep(0.02)
        from ..obs.inflight import inflight
        for snap in inflight.list_active():
            inflight.cancel(snap["query_id"], "drain")
        self.queue.flush(503, "draining")
        return False

    def _on_sigterm(self, signum, frame) -> None:
        # signal handlers must return fast: run the drain elsewhere
        threading.Thread(target=self.stop, kwargs={"drain": True},
                         daemon=True,
                         name="mosaic-serve-drain").start()

    def install_sigterm_drain(self) -> None:
        """Route SIGTERM into drain-then-stop (main thread only —
        CPython restricts ``signal.signal``)."""
        self._sigterm_prev = signal.signal(signal.SIGTERM,
                                           self._on_sigterm)

    def wait_stopped(self, timeout: Optional[float] = None) -> bool:
        """Block until the serve loop exited (drain finished or plain
        stop); fleet workers park their main thread here.  True when
        it stopped within ``timeout``."""
        return self._stopped.wait(timeout)

    # -- asyncio side --------------------------------------------------
    def _loop_main(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._serve_forever())
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            except Exception:
                pass
            loop.close()
            self._stopped.set()

    async def _serve_forever(self) -> None:
        if self._sock is not None:
            self._server = await asyncio.start_server(
                self._handle_conn, sock=self._sock)
        elif self._reuse_port:
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self._want_port,
                reuse_port=True)
        else:
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self._want_port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._ready.set()
        try:
            await self._server.serve_forever()
        except asyncio.CancelledError:
            pass

    def _shutdown_loop(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in asyncio.all_tasks(self._loop):
            task.cancel()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            faults.maybe_fail("serve.accept")
        except InjectedFault:
            # degrade, don't die: this connection is refused with a
            # retryable 503, the listener keeps accepting
            if metrics.enabled:
                metrics.count("serve/accept_errors")
            await self._respond_json(
                writer, 503, {"error": "accept fault injected",
                              "retry_after_s": 0.1},
                extra=[("Retry-After", "1")])
            await self._close(writer)
            return
        if metrics.enabled:
            metrics.count("serve/connections")
        try:
            while True:
                parsed = await self._read_request(reader)
                if parsed is None:
                    break
                method, target, headers, body = parsed
                keep = await self._route(reader, writer, method,
                                         target, headers, body)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            if metrics.enabled:
                metrics.count("serve/conn_errors")
        except asyncio.CancelledError:
            raise
        except Exception:
            if metrics.enabled:
                metrics.count("serve/conn_errors")
        finally:
            await self._close(writer)

    @staticmethod
    async def _close(writer: asyncio.StreamWriter) -> None:
        try:
            writer.close()
            await writer.wait_closed()
        except Exception:
            pass

    async def _read_request(self, reader: asyncio.StreamReader
                            ) -> Optional[Tuple[str, str,
                                                Dict[str, str], bytes]]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        except asyncio.LimitOverrunError:
            return None
        if len(head) > _MAX_HEADER_BYTES:
            return None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split()
        if len(parts) < 3:
            return None
        method, target = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", "0") or 0)
        if n > 0:
            body = await reader.readexactly(n)
        return method, target, headers, body

    async def _route(self, reader, writer, method: str, target: str,
                     headers: Dict[str, str], body: bytes) -> bool:
        keep = headers.get("connection", "").lower() != "close"
        if method == "GET" and target == "/healthz":
            await self._respond_json(writer, 200, {
                "status": "draining" if self.draining else "ok",
                "pid": os.getpid(),
                "queued": self.queue.queued_count(),
                "running": self.queue.running_count(),
                "workers": self.pool.workers}, keep=keep)
            return keep
        if method == "GET" and target == "/stats":
            await self._respond_json(writer, 200, self.stats(),
                                     keep=keep)
            return keep
        if method == "POST" and target == "/query":
            await self._handle_query(reader, writer, headers, body)
            return False            # /query always closes (streamed)
        await self._respond_json(writer, 404,
                                 {"error": f"no route {target}"},
                                 keep=keep)
        return keep

    # -- the query path ------------------------------------------------
    def _parse_query_body(self, headers: Dict[str, str],
                          body: bytes) -> str:
        text = body.decode("utf-8", "replace")
        if "json" in headers.get("content-type", ""):
            obj = json.loads(text)
            return str(obj["sql"])
        return text

    def _est_bytes(self, sql: str) -> int:
        """The planner's byte pre-pass for memory admission; 0 when
        the query can't be planned (it will fail in the worker with a
        proper 400 instead)."""
        try:
            from ..sql.parser import parse
            from ..sql.planner import planner
            if not planner.enabled:
                return 0
            plan = planner.plan_query(parse(sql), self.session)
            return plan.est_bytes_peak() if plan is not None else 0
        except Exception:
            return 0

    async def _handle_query(self, reader, writer,
                            headers: Dict[str, str],
                            body: bytes) -> None:
        t0 = time.perf_counter()
        if metrics.enabled:
            metrics.count("serve/requests")
        try:
            sql = self._parse_query_body(headers, body)
        except Exception as exc:
            await self._respond_json(
                writer, 400, {"error": f"bad request body: {exc}"})
            return
        principal = headers.get("x-mosaic-principal", "").strip() \
            or "anonymous"
        try:
            priority = int(headers.get("x-mosaic-priority", "0"))
        except ValueError:
            priority = 0
        try:
            deadline_ms = float(headers.get("x-mosaic-deadline-ms",
                                            self._default_deadline_ms))
        except ValueError:
            deadline_ms = self._default_deadline_ms
        lookup = classify_batchable(sql, self.session,
                                    max_rows=self._batch_rows_max) \
            if self.pool.batch_max > 0 else None
        # W3C cross-process trace propagation: a malformed header is
        # ignored per spec (the request still runs, unlinked)
        traceparent = headers.get("traceparent", "").strip() or None
        req = ServeRequest(sql, principal, priority=priority,
                           deadline_ms=deadline_ms, lookup=lookup,
                           traceparent=traceparent)
        deny = self.queue.offer(req, est_bytes=self._est_bytes(sql))
        if deny is not None:
            await self._respond_json(
                writer, deny.status, deny.payload(),
                extra=[("Retry-After",
                        str(max(1, int(round(deny.retry_after)))))])
            self._observe_request(principal, "denied:" + deny.reason,
                                  t0)
            return
        status, payload, outcome = await self._await_result(
            reader, req, deadline_ms)
        if status is None:
            # client vanished; the worker (or queue flush) still
            # resolves the future and the ticket books close — there
            # is just nobody left to write to
            self._observe_request(principal, outcome or "disconnect",
                                  t0)
            return
        trace_headers = self._trace_headers(req)
        if isinstance(payload, Table):
            await self._stream_table(writer, payload,
                                     extra=trace_headers)
        else:
            await self._respond_json(writer, status, payload,
                                     extra=trace_headers)
        self._observe_request(principal, outcome, t0)

    @staticmethod
    def _trace_headers(req: ServeRequest):
        """Response trace headers for one served query: the W3C
        ``traceparent`` (the client's trace id when it sent one, else
        one derived from the worker's local trace; the span id is this
        server's own — derived exactly the way the worker derives it,
        so client-side logs and the fleet bundle name the same span)
        plus ``X-Mosaic-Trace`` with the worker-local trace id the
        flight recorder / dashboard key off."""
        ticket = req.ticket
        local = getattr(ticket, "trace_id", None) if ticket else None
        if not local:
            return None
        from ..obs.context import (TraceContext, make_traceparent,
                                   parse_traceparent)
        link = parse_traceparent(req.traceparent)
        hdr = make_traceparent(TraceContext(
            trace_id=local, name=req.label,
            w3c_trace=link[0] if link else None,
            w3c_parent=link[1] if link else None))
        return [("traceparent", hdr), ("X-Mosaic-Trace", local)]

    def _observe_request(self, principal: str, outcome: str,
                         t0: float) -> None:
        dt_ms = (time.perf_counter() - t0) * 1e3
        if metrics.enabled:
            metrics.observe("serve/request_ms", dt_ms)
            metrics.count(f"serve/outcome_{outcome.split(':')[0]}")
        timeseries.record("serve/request_ms", dt_ms)
        # feed the saturation SLO (gauge_max reads the series store)
        timeseries.record("serve/queue_depth",
                          float(self.queue.queued_count()))

    async def _await_result(self, reader, req: ServeRequest,
                            deadline_ms: float):
        """Wait for the worker's result while watching the socket for
        client disconnect and the clock for the request deadline —
        both flow into the request's cancel plumbing.  Returns
        ``(status, payload, outcome)``; status None means the client
        is gone."""
        loop = asyncio.get_running_loop()
        result_f = asyncio.wrap_future(req.future, loop=loop)
        watch = asyncio.ensure_future(reader.read(1))
        timeout = deadline_ms / 1e3 + 1.0 if deadline_ms > 0 else None
        disconnect = False
        try:
            while True:
                done, _ = await asyncio.wait(
                    {result_f, watch},
                    timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                if result_f in done:
                    break
                if watch in done:
                    data = watch.result()
                    if not data:          # EOF: the client hung up
                        disconnect = True
                        if metrics.enabled:
                            metrics.count("serve/disconnects")
                        req.request_cancel("disconnect")
                        await result_f    # cooperative: ≤ one chunk
                        break
                    # stray pipelined bytes — ignore, keep waiting
                    watch = asyncio.ensure_future(reader.read(1))
                    continue
                # timeout: enforce the deadline even for queued work
                req.request_cancel("deadline")
                timeout = None
        finally:
            if not watch.done():
                watch.cancel()
        status, payload, outcome = result_f.result()
        if disconnect:
            return None, None, outcome
        return status, payload, outcome

    # -- response writing ----------------------------------------------
    async def _respond_json(self, writer, code: int, payload,
                            extra=None, keep: bool = False) -> None:
        body = json.dumps(payload, default=_json_default,
                          sort_keys=True).encode()
        await self._write_head(writer, code, "application/json",
                               len(body), extra, keep)
        writer.write(body)
        await writer.drain()

    async def _stream_table(self, writer, table: Table,
                            extra=None) -> None:
        """200 + JSON-lines: a header object, then row chunks.  Each
        chunk drains the socket, so a torn connection surfaces (and
        stops the serialization work) within one chunk."""
        names = list(table.columns)
        head = json.dumps({"columns": names, "rows": len(table)},
                          default=_json_default).encode() + b"\n"
        await self._write_head(writer, 200, "application/jsonl",
                               None, extra, False)
        writer.write(head)
        try:
            cols = [table.columns[n] for n in names]
            for s in range(0, max(1, len(table)),
                           _RESPONSE_CHUNK_ROWS):
                rows = []
                hi = min(len(table), s + _RESPONSE_CHUNK_ROWS)
                for i in range(s, hi):
                    rows.append([_column_cell(c[i]) for c in cols])
                writer.write(json.dumps(rows).encode() + b"\n")
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            # torn mid-response: the query already completed; count it
            # and let the connection close — nothing leaks (buffers
            # were host-side rows, tickets are long closed)
            if metrics.enabled:
                metrics.count("serve/response_errors")
            raise

    @staticmethod
    async def _write_head(writer, code: int, ctype: str,
                          length: Optional[int], extra,
                          keep: bool) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests", 499: "Client Closed",
                  500: "Internal Server Error",
                  503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(code, "Status")
        lines = [f"HTTP/1.1 {code} {reason}",
                 f"Content-Type: {ctype}",
                 "Cache-Control: no-store"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        lines.append("Connection: keep-alive" if keep
                     else "Connection: close")
        for k, v in (extra or []):
            lines.append(f"{k}: {v}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
        await writer.drain()

    # -- introspection -------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """The /api/server payload: queue + quotas + workers +
        counters (the dashboard's server panel polls this)."""
        q = self.queue.snapshot()
        counters = {}
        for name in ("serve/requests", "serve/admitted", "serve/shed",
                     "serve/denied", "serve/batches",
                     "serve/batched_queries", "serve/disconnects",
                     "serve/errors", "serve/dispatch_errors",
                     "serve/accept_errors", "serve/drains"):
            v = metrics.counter_value(name)
            if v:
                counters[name.split("/", 1)[1]] = int(v)
        out = {
            "running": True,
            "pid": os.getpid(),
            "addr": f"{self.host}:{self.port}",
            "draining": self.draining,
            "uptime_s": round(time.time() - self.t_start, 1)
            if self.t_start else 0.0,
            "workers": {"total": self.pool.workers,
                        "busy": self.pool.busy,
                        "utilization": round(
                            self.pool.busy / max(1, self.pool.workers),
                            3)},
            "queue": q,
            "quotas": {"concurrency": self.queue.quota_concurrency,
                       "qps": self.queue.quota_qps,
                       "queue_depth": self.queue.depth,
                       "scope": "fleet" if self.scoreboard is not None
                       else "process"},
            "batching": {"max": self.pool.batch_max,
                         "window_ms": self.pool.batch_window_ms},
            # warm-fleet proof: a respawned worker over a shared
            # persistent kernel cache (mosaic.jit.cache.dir) must show
            # persistent_misses == 0 — it loads, never runs nvcc
            "jit": _kernels.cache_stats(),
            "counters": counters,
        }
        if self.scoreboard is not None:
            try:
                out["scoreboard"] = self.scoreboard.snapshot()
            except (OSError, ValueError):
                out["scoreboard"] = None
        return out


def install_sigterm_drain(server: QueryServer) -> None:
    """Module-level convenience mirroring the method (docs + __main__
    style usage: ``install_sigterm_drain(srv)``)."""
    server.install_sigterm_drain()
