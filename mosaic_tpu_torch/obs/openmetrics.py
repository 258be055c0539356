"""OpenMetrics / Prometheus text exposition and a stdlib scrape endpoint.

Port copy of ``mosaic_tpu.obs.openmetrics``: for equal registry contents
the two packages' expositions are the same string.  The ``obs.metrics``
registry renders in the Prometheus text exposition format:

* counters  -> ``mosaic_<name>_total``
* gauges    -> ``mosaic_<name>``
* histograms -> cumulative ``_bucket{le="..."}`` series (the registry's
  exponential buckets, non-empty ones only, plus ``+Inf``), ``_count``,
  ``_sum``

Metric names are sanitized to ``[a-zA-Z0-9_]`` under a ``mosaic_``
namespace prefix (``sql/scan_s`` -> ``mosaic_sql_scan_s``).

Per-principal accounting series (``principal/<field>/<principal>``
from ``obs.accounting``) render as one labeled family per field —
``mosaic_principal_<field>_total{principal="..."}``.  Principal names
are free-form user input, so label values (and HELP text) are escaped
per the Prometheus text format: ``\\`` -> ``\\\\``, ``"`` ->
``\\"``, newline -> ``\\n``.

:func:`serve_metrics` starts a stdlib ``ThreadingHTTPServer`` on a
daemon thread serving ``GET /metrics``; :func:`fleet_to_openmetrics`
renders a merged :class:`~.fleet.FleetView`.
"""

from __future__ import annotations

import http.server
import math
import re
import threading
from typing import List, Optional

from .metrics import MetricsRegistry, _bucket_upper, metrics

__all__ = ["to_openmetrics", "fleet_to_openmetrics", "serve_metrics",
           "ServerHandle"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: Prometheus content type for the text exposition format
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _sanitize(name: str) -> str:
    s = _NAME_RE.sub("_", name)
    if not s or s[0].isdigit():
        s = "_" + s
    return "mosaic_" + s


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return f"{float(v):.10g}"


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping (backslash first —
    it is the escape character itself)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping: only ``\\`` and newline are special there
    (quotes are literal in HELP text)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _split_principal(name: str):
    """``principal/<field>/<principal>`` -> (field, principal), else
    None.  maxsplit keeps any further ``/`` inside the principal."""
    parts = name.split("/", 2)
    if len(parts) == 3 and parts[0] == "principal":
        return parts[1], parts[2]
    return None


def _principal_family(lines: List[str], field: str, kind: str,
                      samples) -> None:
    m = _sanitize(f"principal_{field}")
    if kind == "counter":
        m += "_total"
    lines.append(f"# HELP {m} " + _escape_help(
        f"Per-principal {field} from the query accounting plane "
        "(obs.accounting)."))
    lines.append(f"# TYPE {m} {kind}")
    for principal, v in sorted(samples):
        lines.append(
            f'{m}{{principal="{_escape_label_value(principal)}"}}'
            f' {_fmt(v)}')


def to_openmetrics(registry: Optional[MetricsRegistry] = None) -> str:
    """Render a registry (default: the process-global one) in the
    Prometheus text exposition format, terminated by ``# EOF``."""
    reg = registry if registry is not None else metrics
    rep = reg.report()
    lines: List[str] = []
    principals: dict = {}      # (field, kind) -> [(principal, value)]
    for name, v in sorted(rep["counters"].items()):
        hit = _split_principal(name)
        if hit is not None:
            principals.setdefault((hit[0], "counter"), []) \
                .append((hit[1], v))
            continue
        m = _sanitize(name) + "_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(v)}")
    for name, v in sorted(rep["gauges"].items()):
        hit = _split_principal(name)
        if hit is not None:
            principals.setdefault((hit[0], "gauge"), []) \
                .append((hit[1], v))
            continue
        m = _sanitize(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(v)}")
    for (field, kind), samples in sorted(principals.items()):
        _principal_family(lines, field, kind, samples)
    for name, h in sorted(reg.histograms().items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for i, c in enumerate(h.counts):
            if c:
                cum += c
                le = _fmt(_bucket_upper(i, h.scale))
                lines.append(f'{m}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{m}_count {h.count}")
        lines.append(f"{m}_sum {_fmt(h.sum)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def fleet_to_openmetrics(view) -> str:
    """Render a :class:`~.fleet.FleetView` as one exposition: counters
    and gauges become labeled families with one ``{worker="<pid>"}``
    sample per contributing worker (a scraper re-derives the fleet sum
    / max with plain label aggregation — and can tell WHICH worker is
    hot), while histograms render from the aggregator's bucket-wise
    EXACT merge, unlabeled: per-worker quantiles still live on each
    worker's own ``/metrics``, but a fleet p99 computed any other way
    would be an approximation.  Stale workers keep their counter
    samples (completed work stands) and lose their gauge samples,
    mirroring the aggregator's merge rules."""
    lines: List[str] = []
    counters: dict = {}        # name -> [(pid, value)]
    gauges: dict = {}
    for w in view.workers:
        if not w.readable:
            continue
        reg = (w.snapshot or {}).get("metrics", {})
        for name, v in reg.get("counters", {}).items():
            counters.setdefault(name, []).append((w.pid, v))
        if not w.stale:
            for name, v in reg.get("gauges", {}).items():
                gauges.setdefault(name, []).append((w.pid, v))
    for name, samples in sorted(counters.items()):
        m = _sanitize(name) + "_total"
        lines.append(f"# TYPE {m} counter")
        for pid, v in sorted(samples):
            lines.append(f'{m}{{worker="{pid}"}} {_fmt(v)}')
    for name, samples in sorted(gauges.items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m} gauge")
        for pid, v in sorted(samples):
            lines.append(f'{m}{{worker="{pid}"}} {_fmt(v)}')
    for name, h in sorted(view.histograms.items()):
        m = _sanitize(name)
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for i, c in enumerate(h.counts):
            if c:
                cum += c
                le = _fmt(_bucket_upper(i, h.scale))
                lines.append(f'{m}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{m}_count {h.count}")
        lines.append(f"{m}_sum {_fmt(h.sum)}")
    lines.append("# TYPE mosaic_fleet_workers gauge")
    lines.append(f"mosaic_fleet_workers {len(view.workers)}")
    lines.append("# TYPE mosaic_fleet_stale_workers gauge")
    lines.append("mosaic_fleet_stale_workers "
                 f"{sum(1 for w in view.workers if w.stale)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class ServerHandle:
    """A started HTTP endpoint you can actually stop.

    Wraps the ``ThreadingHTTPServer`` + its serve thread; ``close()``
    shuts the server down, closes the listening socket and joins the
    thread.  ``shutdown()`` / ``server_close()`` / ``server_address``
    are kept as aliases so existing callers of the raw server keep
    working; the handle is also a context manager."""

    def __init__(self, server, thread):
        self._server = server
        self._thread = thread
        self._closed = False

    @property
    def server_address(self):
        return self._server.server_address

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # raw-server compat: callers used server.shutdown();
    # server.server_close() as the teardown pair
    def shutdown(self) -> None:
        if not self._closed:
            self._server.shutdown()

    def server_close(self) -> None:
        self.close()

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_server(handler_cls, port: int, addr: str,
                 name: str) -> ServerHandle:
    """Spin a ``ThreadingHTTPServer`` on a named daemon thread and
    return the stoppable handle (shared by the metrics endpoint and
    the ops dashboard)."""
    server = http.server.ThreadingHTTPServer((addr, port), handler_cls)
    thread = threading.Thread(target=server.serve_forever,
                              name=name, daemon=True)
    thread.start()
    return ServerHandle(server, thread)


def serve_metrics(port: int = 9464, addr: str = "127.0.0.1",
                  registry: Optional[MetricsRegistry] = None
                  ) -> ServerHandle:
    """Start a scrape endpoint on a daemon thread; returns a
    :class:`ServerHandle`.

    ``GET /metrics`` (or ``/``) answers with :func:`to_openmetrics` at
    scrape time.  Pass ``port=0`` for an ephemeral port — the bound one
    is ``handle.port``.  Stop with ``handle.close()``.
    """

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = to_openmetrics(registry).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # scrapes must not spam stderr
            pass

    return start_server(_Handler, port, addr, "mosaic-metrics-http")
