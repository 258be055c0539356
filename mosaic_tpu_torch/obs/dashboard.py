"""Live ops dashboard: JSON endpoints + one self-contained HTML page.

Port copy of ``mosaic_tpu.obs.dashboard``: the same routes, payloads
and pages (their titles name this package).  A stdlib scrape server
grown into a small operator console — no templates, no JS bundles; the
page is one inline HTML string that polls the JSON endpoints below with
``fetch()``.

Routes:

* ``/``                 — the polling HTML page
* ``/metrics``          — the OpenMetrics exposition (scraper compat)
* ``/api/summary``      — alerts_active, series/metric counts, uptime
* ``/api/series``       — known time-series names (``?prefix=``)
* ``/api/timeseries``   — windowed stats + raw points for one series
  (``?name=...&window=300``)
* ``/api/alerts``       — active SLO breaches + recent breach events
* ``/api/traces``       — recent completed trace trees (tracer on)
* ``/api/planner``      — planner decisions/coefficients report
* ``/api/devices``      — per-device attribution (``obs.devicemon``)
* ``/api/memory``       — the device-memory ledger snapshot
  (``obs.memwatch``): per-device live/peak/capacity/pressure, top live
  holders by (site, trace, device), recent leaks, budget state
* ``/memory``           — the memory page over ``/api/memory``
* ``/api/profile``      — profiler snapshot: host stacks (``?trace=``
  filters to one trace context), kernel ledger, collapsed text
* ``/profile``          — the flamegraph view over ``/api/profile``
* ``/api/queries``      — live query console: in-flight tickets
  (``obs.inflight``) + recent audit completions (``?limit=``)
* ``/api/principals``   — per-principal meter totals (``obs.accounting``)
* ``/api/server``       — the live query server's ``stats()``
  (``serve/server.py``), ``{"running": False}`` when none is up
* ``/api/fleet``        — the merged fleet view over the spool dir
  (``obs.fleet``; ``?dir=``, ``?bundle=1``); ``{"enabled": False}``
  when no spool dir is configured
* ``/api/history``      — workload history (``obs.history``): merged
  window payloads + totals from ``mosaic.history.dir`` (``?dir=``
  overrides; ``?window=<ms>`` re-windows), plus the live partition
  heat report (``obs.heat``); ``{"enabled": False}`` when no history
  dir is configured
* ``POST /api/queries/<id>/cancel`` — request cooperative cancellation
  of an in-flight query (POST-only: GET answers 405; an unknown id
  answers a JSON 404)

Every JSON response carries ``Cache-Control: no-store``, and unknown
``/api/*`` paths answer a JSON 404 body.

``serve_dashboard(port=0)`` returns the same stoppable
:class:`~.openmetrics.ServerHandle` as ``serve_metrics`` — close it
with ``handle.close()``.
"""

from __future__ import annotations

import http.server
import json
import re
import time
import urllib.parse
from typing import Dict, Optional

from .metrics import metrics
from .openmetrics import CONTENT_TYPE, ServerHandle, start_server, \
    to_openmetrics
from .recorder import recorder
from .timeseries import timeseries
from .tracer import tracer

__all__ = ["serve_dashboard"]

_MAX_POINTS = 500          # raw points per /api/timeseries response
_MAX_TRACES = 20
_MAX_EVENTS = 50
_MAX_AUDIT = 100           # recent completions per /api/queries
_CANCEL_RE = re.compile(r"^/api/queries/([^/]+)/cancel$")


def _summary(t0: float) -> Dict[str, object]:
    from .slo import monitor
    from .timeseries import sampler
    rep = metrics.report()
    smp = sampler()
    return {
        "ts": time.time(),
        "uptime_s": round(time.time() - t0, 1),
        "alerts_active": monitor.alerts_active(),
        "breaches": monitor.breach_count(),
        "series": len(timeseries),
        "counters": len(rep["counters"]),
        "gauges": len(rep["gauges"]),
        "histograms": len(rep["histograms"]),
        "metrics_enabled": metrics.enabled,
        "sampler": {"running": smp is not None and smp.alive,
                    "interval_ms": smp.interval_ms if smp else 0,
                    "ticks": smp.ticks if smp else 0},
    }


def _timeseries_payload(qs: Dict[str, list]) -> Dict[str, object]:
    name = (qs.get("name") or [""])[0]
    try:
        window = float((qs.get("window") or ["300"])[0])
    except ValueError:
        window = 300.0
    s = timeseries.series(name)
    if s is None:
        return {"name": name, "window_s": window, "found": False,
                "stats": {}, "points": []}
    now = time.time()
    pts = [(t, v) for t, v in s.raw if t >= now - window]
    if len(pts) > _MAX_POINTS:
        step = len(pts) / _MAX_POINTS
        pts = [pts[int(i * step)] for i in range(_MAX_POINTS)]
    return {
        "name": name, "window_s": window, "found": True,
        "stats": s.window_stats(window, now),
        "rate": s.rate(window, now),
        "p99": s.quantile_over_window(99, window, now),
        "points": [[round(t, 3), v] for t, v in pts],
    }


def _alerts_payload() -> Dict[str, object]:
    from .slo import monitor
    return {
        "active": monitor.active_alerts(),
        "objectives": [o["name"] for o in
                       monitor.report()["objectives"]],
        "recent_breaches": recorder.events("slo_breach")[-_MAX_EVENTS:],
        "recent_recoveries":
            recorder.events("slo_recovered")[-_MAX_EVENTS:],
    }


def _traces_payload() -> Dict[str, object]:
    traces = tracer.report().get("traces", {})
    items = list(traces.items())[-_MAX_TRACES:]
    return {"traces": {tid: {"name": t.get("name"),
                             "spans": t.get("spans", [])[:200]}
                       for tid, t in items}}


def _planner_payload() -> Dict[str, object]:
    try:
        from ..sql.planner import planner
        return planner.report()
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def _devices_payload() -> Dict[str, object]:
    from .devicemon import devicemon
    return devicemon.report()


def _memory_payload() -> Dict[str, object]:
    from .memwatch import mem_budget, memwatch
    snap = memwatch.snapshot()
    snap["budget"] = {"budget_bytes": mem_budget.budget_bytes(),
                      "pressure_high": mem_budget.pressure_high()}
    if metrics.enabled:
        rep = metrics.report()
        snap["counters"] = {
            "chunk_shrink": rep["counters"].get("mem/chunk_shrink", 0.0),
            "admit_denied": rep["counters"].get("mem/admit_denied", 0.0),
            "release_skipped":
                rep["counters"].get("mem/release_skipped", 0.0),
        }
    return snap


def _queries_payload(qs: Dict[str, list]) -> Dict[str, object]:
    from .accounting import audit
    from .inflight import inflight
    try:
        limit = int((qs.get("limit") or ["20"])[0])
    except ValueError:
        limit = 20
    limit = max(1, min(limit, _MAX_AUDIT))
    return {
        "inflight": inflight.list_active(),
        "recent": audit.records(limit=limit),
        "audited": audit.written(),
    }


def _principals_payload() -> Dict[str, object]:
    from .accounting import meter
    return {"principals": meter.report()}


def _server_payload() -> Dict[str, object]:
    """The query-server panel: the live :class:`~..serve.server.
    QueryServer`'s stats, or ``{"running": False}`` when no server is
    up in this process (the dashboard works stand-alone)."""
    try:
        from ..serve.server import current_server
    except Exception:
        return {"running": False}
    srv = current_server()
    if srv is None:
        return {"running": False}
    try:
        return srv.stats()
    except Exception as exc:
        return {"running": True,
                "error": f"{type(exc).__name__}: {exc}"}


def _fleet_payload(qs: Dict[str, list]) -> Dict[str, object]:
    """The fleet panel: merged cross-worker view from the spool dir
    (``?dir=`` overrides ``mosaic.obs.fleet.dir``).  ``?bundle=1``
    returns the full fleet bundle (stitched traces + every worker's
    recent events) instead of the summary view.  No spool dir
    configured -> ``{"enabled": False}``, same stand-alone contract as
    the server panel."""
    from .. import config as _config
    directory = (qs.get("dir") or [""])[0] or \
        _config.default_config().obs_fleet_dir
    if not directory:
        return {"enabled": False}
    from .fleet import aggregator_for
    agg = aggregator_for(directory)
    try:
        view = agg.scan()
        if (qs.get("bundle") or [""])[0] in ("1", "true"):
            return dict(agg.bundle(view), enabled=True)
        traces = agg.stitched_traces(view)
        return {"enabled": True,
                "fleet": view.payload(),
                "supervisor": _supervisor_status(directory),
                "slo_fleet": agg.evaluate_slo(view),
                "traces": {tid: {"workers": t["workers"],
                                 "spans": len(t["spans"])}
                           for tid, t in traces.items()}}
    except Exception as exc:      # a broken spool dir must not 500
        return {"enabled": True, "dir": directory,
                "error": f"{type(exc).__name__}: {exc}"}


def _supervisor_status(directory: str):
    """The serving-fleet supervisor's status file, when the spool dir
    doubles as a ServeFleet runtime dir (serve/supervisor.py writes
    ``supervisor.json`` atomically each health tick).  None when no
    supervisor runs over this directory; a torn/absent file is a
    degrade, never a panel error."""
    import json as _json
    import os as _os
    path = _os.path.join(directory, "supervisor.json")
    try:
        with open(path) as f:
            return _json.load(f)
    except (OSError, ValueError):
        return None


def _history_payload(qs: Dict[str, list]) -> Dict[str, object]:
    """The workload-history panel: merged windows + totals for the
    history dir (``?dir=`` overrides ``mosaic.history.dir`` / the
    feed's resolved dir) plus the live heat report.  No dir ->
    ``{"enabled": False}``; a broken dir degrades to an error field,
    never a 500 (same stand-alone contract as the fleet panel)."""
    from .heat import heat
    from .history import history, report
    directory = (qs.get("dir") or [""])[0] or history.directory()
    out: Dict[str, object] = {"heat": heat.report(top=10)}
    if not directory:
        out["enabled"] = False
        return out
    out["enabled"] = True
    try:
        window = (qs.get("window") or [""])[0]
        out.update(report(directory,
                          float(window) if window else None))
        out["write_errors"] = history.write_errors()
    except Exception as exc:
        out["dir"] = directory
        out["error"] = f"{type(exc).__name__}: {exc}"
    return out


def _profile_payload(qs: Dict[str, list]) -> Dict[str, object]:
    from .profiler import ledger, profiler
    trace = (qs.get("trace") or [None])[0] or None
    p = profiler()
    out: Dict[str, object] = {
        "running": p is not None and p.alive,
        "ledger": ledger.report(),
    }
    if p is not None:
        rep = p.report(max_stacks=_MAX_POINTS)
        if trace:
            rep["stacks"] = [s for s in rep["stacks"]
                             if s["trace"] == trace]
        out["host"] = rep
        out["collapsed"] = p.collapsed(trace)
    else:
        out["host"] = {}
        out["collapsed"] = ""
    return out


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>mosaic_tpu_torch ops</title>
<style>
 body{font:13px/1.5 system-ui,sans-serif;margin:1.5em;max-width:70em}
 h1{font-size:1.2em} h2{font-size:1em;margin:1.2em 0 .3em}
 table{border-collapse:collapse} td,th{padding:.15em .7em;
  border-bottom:1px solid #ddd;text-align:left;font-variant-numeric:
  tabular-nums}
 .ok{color:#2a7} .bad{color:#c33;font-weight:600}
 #alerts li{color:#c33} code{background:#f4f4f4;padding:0 .3em}
 svg{border:1px solid #ddd;background:#fafafa}
</style></head><body>
<h1>mosaic_tpu_torch ops dashboard</h1>
<p><a href="/profile">profiler / flamegraph</a> ·
 <a href="/memory">memory</a> ·
 <a href="/metrics">openmetrics</a></p>
<div id="summary">loading…</div>
<h2>Active alerts</h2><ul id="alerts"><li class="ok">none</li></ul>
<h2>Series <select id="pick"></select>
 <span id="stats"></span></h2>
<svg id="chart" width="640" height="120"></svg>
<h2>Devices</h2><table id="devices"></table>
<h2>Queries in flight</h2><table id="queries"></table>
<h2>Recent completions</h2><table id="recent"></table>
<h2>Principals</h2><table id="principals"></table>
<h2>Query server</h2><div id="server">not running</div>
<table id="servertab"></table>
<h2>Workload history</h2><div id="history">not configured</div>
<table id="histwin"></table>
<h2>Partition heat</h2><table id="heat"></table>
<script>
const $=id=>document.getElementById(id);
async function j(u){const r=await fetch(u);return r.json()}
function draw(pts){const s=$("chart");if(!pts.length){s.innerHTML="";
 return}const xs=pts.map(p=>p[0]),ys=pts.map(p=>p[1]);
 const x0=Math.min(...xs),x1=Math.max(...xs)||x0+1,
 y0=Math.min(...ys),y1=Math.max(...ys);const yr=(y1-y0)||1;
 const d=pts.map((p,i)=>(i?"L":"M")+(620*(p[0]-x0)/(x1-x0||1)+10)+
 ","+(110-100*(p[1]-y0)/yr)).join(" ");
 s.innerHTML='<path d="'+d+'" fill="none" stroke="#27c"/>'}
async function tick(){
 const s=await j("/api/summary");
 $("summary").innerHTML=
  (s.alerts_active?'<span class="bad">'+s.alerts_active+
   ' alert(s) active</span>':'<span class="ok">healthy</span>')+
  " — "+s.series+" series, "+s.counters+" counters, sampler "+
  (s.sampler.running?s.sampler.interval_ms+"ms ("+s.sampler.ticks+
   " ticks)":"off")+", up "+s.uptime_s+"s";
 const a=await j("/api/alerts");
 $("alerts").innerHTML=a.active.length?a.active.map(x=>"<li>"+x.name+
  " ("+x.kind+") short="+x.short.toFixed(4)+" long="+
  x.long.toFixed(4)+" budget="+x.budget.toFixed(4)+"</li>").join("")
  :'<li class="ok">none</li>';
 const names=(await j("/api/series")).names;
 const pick=$("pick");const cur=pick.value;
 pick.innerHTML=names.map(n=>"<option"+(n===cur?" selected":"")+">"+
  n+"</option>").join("");
 if(pick.value){const ts=await j("/api/timeseries?name="+
  encodeURIComponent(pick.value)+"&window=300");
  $("stats").textContent=" n="+ts.stats.count+" mean="+
   (+ts.stats.mean).toPrecision(4)+" max="+
   (+ts.stats.max).toPrecision(4)+" p99="+(+ts.p99).toPrecision(4);
  draw(ts.points)}
 const d=await j("/api/devices");
 $("devices").innerHTML="<tr><th>device</th><th>busy_s</th>"+
  "<th>util</th><th>rows</th><th>peak_bytes</th></tr>"+
  Object.entries(d.devices).map(([k,v])=>"<tr><td>"+k+"</td><td>"+
   v.busy_s.toFixed(3)+"</td><td>"+(v.util||0).toFixed(2)+
   "</td><td>"+v.rows+"</td><td>"+(v.peak_bytes||"-")+
   "</td></tr>").join("");
 const esc=t=>String(t).replace(/&/g,"&amp;").replace(/</g,"&lt;");
 const q=await j("/api/queries");
 $("queries").innerHTML="<tr><th>id</th><th>principal</th>"+
  "<th>sql</th><th>operator</th><th>wall_ms</th><th>rows</th>"+
  "<th></th></tr>"+(q.inflight.length?q.inflight.map(x=>"<tr><td>"+
   esc(x.query_id)+"</td><td>"+esc(x.principal)+"</td><td><code>"+
   esc(x.sql)+"</code></td><td>"+esc(x.operator)+"</td><td>"+
   x.cost.wall_ms.toFixed(0)+"</td><td>"+x.cost.rows+"</td><td>"+
   (x.cancel_requested?"cancelling…":'<button onclick="cancelQ(\\''+
    x.query_id+'\\')">cancel</button>')+"</td></tr>").join(""):
   '<tr><td colspan="7" class="ok">idle</td></tr>');
 $("recent").innerHTML="<tr><th>id</th><th>principal</th>"+
  "<th>outcome</th><th>wall_ms</th><th>device_s</th><th>rows</th>"+
  "</tr>"+q.recent.slice().reverse().map(r=>"<tr><td>"+
   esc(r.query_id)+"</td><td>"+esc(r.principal)+"</td><td"+
   (r.outcome==="ok"?">":' class="bad">')+esc(r.outcome)+
   "</td><td>"+r.cost.wall_ms.toFixed(0)+"</td><td>"+
   r.cost.device_s.toFixed(4)+"</td><td>"+r.cost.rows_out+
   "</td></tr>").join("");
 const pr=await j("/api/principals");
 $("principals").innerHTML="<tr><th>principal</th><th>queries</th>"+
  "<th>wall_ms</th><th>device_s</th><th>rows_out</th>"+
  "<th>h2d_bytes</th><th>compiles</th></tr>"+
  Object.entries(pr.principals).map(([p,v])=>"<tr><td>"+esc(p)+
   "</td><td>"+v.queries+"</td><td>"+v.wall_ms.toFixed(0)+
   "</td><td>"+v.device_s.toFixed(4)+"</td><td>"+v.rows_out+
   "</td><td>"+v.h2d_bytes+"</td><td>"+v.compiles+
   "</td></tr>").join("");
 const sv=await j("/api/server");
 if(!sv.running){$("server").textContent="not running";
  $("server").className="ok";$("servertab").innerHTML="";}
 else{
  $("server").className=sv.draining?"bad":"ok";
  $("server").textContent=sv.addr+(sv.draining?" DRAINING":" serving")+
   " · workers "+sv.workers.busy+"/"+sv.workers.total+
   " · queue "+sv.queue.queued+"/"+sv.quotas.queue_depth+
   " · running "+sv.queue.running+
   (sv.counters.shed?" · shed "+sv.counters.shed:"");
  $("servertab").innerHTML="<tr><th>tenant</th><th>queued</th>"+
   "<th>running</th><th>admitted</th><th>shed</th></tr>"+
   Object.entries(sv.queue.principals).map(([p,v])=>"<tr><td>"+
    esc(p)+"</td><td>"+v.queued+"</td><td>"+v.running+"</td><td>"+
    v.admitted+"</td><td"+(v.shed?' class="bad">':">")+v.shed+
    "</td></tr>").join("");
 }
 const hi=await j("/api/history");
 const he=hi.heat||{cells:[]};
 $("heat").innerHTML="<tr><th>cell</th><th>scans</th><th>rows</th>"+
  "<th>bytes</th><th>bytes/row</th></tr>"+(he.cells.length?
  he.cells.map(c=>"<tr><td>"+c.cell+"</td><td>"+c.scans.toFixed(1)+
   "</td><td>"+c.rows.toFixed(0)+"</td><td>"+c.bytes.toFixed(0)+
   "</td><td>"+c.bytes_per_row.toFixed(1)+"</td></tr>").join("")
  :'<tr><td colspan="5" class="ok">no partitions touched</td></tr>');
 if(!hi.enabled){$("history").textContent="not configured";
  $("history").className="ok";$("histwin").innerHTML="";}
 else if(hi.error){$("history").className="bad";
  $("history").textContent=hi.dir+" — "+hi.error;}
 else{
  const tq=(hi.totals||{}).queries||0;
  $("history").className="ok";
  $("history").textContent=hi.dir+" — "+tq+" queries in "+
   (hi.windows||[]).length+" window(s)"+
   (hi.write_errors?", "+hi.write_errors+" write error(s)":"");
  $("histwin").innerHTML="<tr><th>window</th><th>queries</th>"+
   "<th>errors</th><th>p50 ms</th><th>p95 ms</th>"+
   "<th>mispredicts</th></tr>"+(hi.windows||[]).slice(-8).map(w=>{
    const op=Object.values(w.operators||{});
    const p50=op.length?Math.max(...op.map(o=>o.p50_ms)):0;
    const p95=op.length?Math.max(...op.map(o=>o.p95_ms)):0;
    const err=(w.outcomes||{}).error||0;
    return "<tr><td>"+w.window+"</td><td>"+w.queries+"</td><td"+
     (err?' class="bad">':">")+err+"</td><td>"+
     p50.toFixed(1)+"</td><td>"+p95.toFixed(1)+"</td><td>"+
     (w.mispredicts||0)+"</td></tr>"}).join("");
 }
}
async function cancelQ(id){
 await fetch("/api/queries/"+encodeURIComponent(id)+"/cancel",
  {method:"POST"});tick()}
tick();setInterval(tick,2000);
</script></body></html>
"""

# The flamegraph view: folds /api/profile's collapsed stacks into a
# trie client-side and renders one SVG rect per node (width = sample
# share, icicle layout, root on top).  Same zero-dependency rules as
# the main page: inline HTML, stdlib server, fetch() polling.
_PROFILE_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>mosaic_tpu_torch profile</title>
<style>
 body{font:13px/1.5 system-ui,sans-serif;margin:1.5em;max-width:80em}
 h1{font-size:1.2em} h2{font-size:1em;margin:1.2em 0 .3em}
 table{border-collapse:collapse} td,th{padding:.15em .7em;
  border-bottom:1px solid #ddd;text-align:left;font-variant-numeric:
  tabular-nums}
 svg{border:1px solid #ddd;background:#fafafa;width:100%}
 svg text{font:10px monospace;pointer-events:none}
 #meta{color:#666}
</style></head><body>
<h1>mosaic_tpu_torch profile <a href="/" style="font-size:.7em">(dashboard)
</a></h1>
<div id="meta">loading…</div>
<h2>Flame graph (host samples) <select id="trace"></select></h2>
<svg id="fg" height="0"></svg>
<h2>Kernel ledger</h2><table id="ledger"></table>
<script>
const $=id=>document.getElementById(id);
async function j(u){const r=await fetch(u);return r.json()}
function fold(stacks){const root={n:"all",v:0,c:{}};
 for(const s of stacks){root.v+=s.count;let cur=root;
  for(const f of s.frames){cur=cur.c[f]||(cur.c[f]={n:f,v:0,c:{}});
   cur.v+=s.count}}
 return root}
function render(root){const W=1200,H=16,rows=[];
 (function walk(node,x,d){rows.push([node,x,d]);let cx=x;
  for(const k of Object.keys(node.c).sort())
   {walk(node.c[k],cx,d+1);cx+=node.c[k].v}})(root,0,0);
 const depth=Math.max(...rows.map(r=>r[2]))+1;
 const sv=$("fg");sv.setAttribute("viewBox","0 0 "+W+" "+depth*H);
 sv.setAttribute("height",depth*H);
 sv.innerHTML=rows.map(([n,x,d])=>{const w=W*n.v/(root.v||1);
  if(w<1)return"";const px=W*x/(root.v||1);
  const hue=(n.n.split("").reduce((a,c)=>a+c.charCodeAt(0),0)%60)+10;
  return '<g><title>'+n.n+' ('+n.v+' samples)</title>'+
   '<rect x="'+px+'" y="'+d*H+'" width="'+Math.max(w-.5,.5)+
   '" height="'+(H-1)+'" fill="hsl('+hue+',70%,72%)"/>'+
   (w>60?'<text x="'+(px+3)+'" y="'+(d*H+H-5)+'">'+
    n.n.replace(/&/g,"&amp;").replace(/</g,"&lt;")
     .slice(0,Math.floor(w/7))+'</text>':'')+'</g>'}).join("")}
async function tick(){
 const sel=$("trace"),cur=sel.value;
 const p=await j("/api/profile"+(cur&&cur!=="(all)"?
  "?trace="+encodeURIComponent(cur):""));
 const h=p.host||{};
 $("meta").textContent=p.running?
  "sampler on @ "+h.hz+" Hz — "+h.samples+" samples, "+
  h.distinct_stacks+" distinct stacks, "+h.truncated+" truncated":
  "host sampler off (start_profiler() / MOSAIC_TPU_PROFILE_HZ) — "+
  "ledger below is always on";
 const traces=Object.entries(h.traces||{});
 sel.innerHTML=["(all)",...traces.map(([t,i])=>t)].map(t=>
  "<option"+(t===cur?" selected":"")+">"+t+"</option>").join("");
 render(fold(h.stacks||[]));
 const L=p.ledger||{kernels:[]};
 $("ledger").innerHTML="<tr><th>kernel</th><th>key</th>"+
  "<th>launches</th><th>seconds</th><th>rows/s</th><th>gflops/s</th>"+
  "</tr>"+L.kernels.map(k=>{const f=k.name.startsWith("fused:");
   return "<tr"+(f?' style="background:#eef6ee"':"")+"><td>"+
   (f?"<b>"+k.name+"</b> <span style=\"color:#484\">⧉</span>":k.name)+
   "</td><td><code>"+
   k.key.slice(0,60)+"</code></td><td>"+k.launches+"</td><td>"+
   k.seconds.toFixed(4)+"</td><td>"+(k.rows_per_s||"-")+"</td><td>"+
   (k.gflops_s||"-")+"</td></tr>"}).join("");
}
tick();setInterval(tick,3000);
</script></body></html>
"""


# The memory page: per-device live/peak/pressure bars over the
# /api/memory ledger snapshot, top live holders, and the leak list.
# Same zero-dependency rules as the other pages.
_MEMORY_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>mosaic_tpu_torch memory</title>
<style>
 body{font:13px/1.5 system-ui,sans-serif;margin:1.5em;max-width:70em}
 h1{font-size:1.2em} h2{font-size:1em;margin:1.2em 0 .3em}
 table{border-collapse:collapse} td,th{padding:.15em .7em;
  border-bottom:1px solid #ddd;text-align:left;font-variant-numeric:
  tabular-nums}
 .ok{color:#2a7} .bad{color:#c33;font-weight:600}
 .bar{display:inline-block;height:.7em;background:#27c;
  vertical-align:baseline} code{background:#f4f4f4;padding:0 .3em}
 #meta{color:#666}
</style></head><body>
<h1>mosaic_tpu_torch device memory <a href="/" style="font-size:.7em">
(dashboard)</a></h1>
<div id="meta">loading…</div>
<h2>Devices</h2><table id="devs"></table>
<h2>Top live holders</h2><table id="holders"></table>
<h2>Site peak attribution</h2><table id="sites"></table>
<h2>Leaks</h2><table id="leaks"></table>
<script>
const $=id=>document.getElementById(id);
async function j(u){const r=await fetch(u);return r.json()}
const fmt=b=>b>=1<<30?(b/2**30).toFixed(2)+" GiB":b>=1<<20?
 (b/2**20).toFixed(2)+" MiB":b>=1024?(b/1024).toFixed(1)+" KiB":b+" B";
async function tick(){
 const m=await j("/api/memory");
 const t=m.totals||{},c=m.counters||{};
 $("meta").innerHTML=(m.enabled?"ledger on":
  '<span class="bad">ledger off</span>')+" — live "+
  fmt(t.live_bytes||0)+" in "+(t.live_buffers||0)+" buffers, "+
  t.registered+" registered / "+t.released+" released, budget "+
  (m.budget.budget_bytes?fmt(m.budget.budget_bytes):"unlimited")+
  ", shrinks "+(c.chunk_shrink||0)+", admit denials "+
  (c.admit_denied||0)+", leaks "+
  (t.leaks?'<span class="bad">'+t.leaks+"</span>":"0");
 $("devs").innerHTML="<tr><th>device</th><th>live</th><th>peak</th>"+
  "<th>capacity</th><th>pressure</th></tr>"+
  Object.entries(m.devices).map(([k,v])=>"<tr><td>"+k+"</td><td>"+
   fmt(v.live_bytes)+"</td><td>"+fmt(v.peak_bytes)+"</td><td>"+
   fmt(v.capacity_bytes)+'</td><td><span class="bar" style="width:'+
   Math.min(100,100*v.pressure)+'px"></span> '+
   (100*v.pressure).toFixed(2)+"%</td></tr>").join("");
 $("holders").innerHTML="<tr><th>site</th><th>trace</th>"+
  "<th>device</th><th>bytes</th></tr>"+(m.holders.length?
  m.holders.map(h=>"<tr><td><code>"+h.site+"</code></td><td>"+
   (h.trace||"-")+"</td><td>"+h.device+"</td><td>"+fmt(h.bytes)+
   "</td></tr>").join("")
  :'<tr><td colspan="4" class="ok">nothing live</td></tr>');
 $("sites").innerHTML="<tr><th>site</th><th>peak bytes</th></tr>"+
  Object.entries(m.site_peak_bytes).map(([s,b])=>"<tr><td><code>"+
   s+"</code></td><td>"+fmt(b)+"</td></tr>").join("");
 $("leaks").innerHTML="<tr><th>query</th><th>site</th><th>bytes</th>"+
  "<th>buffers</th></tr>"+(m.leaks.length?m.leaks.map(l=>
  '<tr class="bad"><td>'+l.query_id+"</td><td><code>"+l.site+
  "</code></td><td>"+fmt(l.bytes)+"</td><td>"+l.buffers+
  "</td></tr>").join("")
  :'<tr><td colspan="4" class="ok">none</td></tr>');
}
tick();setInterval(tick,2000);
</script></body></html>
"""


def serve_dashboard(port: int = 0, addr: str = "127.0.0.1"
                    ) -> ServerHandle:
    """Start the ops dashboard; returns a stoppable
    :class:`~.openmetrics.ServerHandle` (ephemeral port by default —
    read it off ``handle.port``)."""
    t0 = time.time()

    class _Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str, code: int = 200,
                  extra: Optional[Dict[str, str]] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, payload, code: int = 200,
                  extra: Optional[Dict[str, str]] = None) -> None:
            # no-store: these are live snapshots; a cached /api/queries
            # would show phantom in-flight queries
            hdrs = {"Cache-Control": "no-store"}
            hdrs.update(extra or {})
            self._send(json.dumps(payload, default=str).encode(),
                       "application/json", code=code, extra=hdrs)

        def _api_404(self, path: str) -> None:
            self._json({"error": "not found", "path": path}, code=404)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            qs = urllib.parse.parse_qs(query)
            try:
                if path == "/":
                    self._send(_PAGE.encode(), "text/html; charset=utf-8")
                elif path == "/metrics":
                    self._send(to_openmetrics().encode(), CONTENT_TYPE)
                elif path == "/api/summary":
                    self._json(_summary(t0))
                elif path == "/api/series":
                    prefix = (qs.get("prefix") or [""])[0]
                    self._json({"names": timeseries.names(prefix)})
                elif path == "/api/timeseries":
                    self._json(_timeseries_payload(qs))
                elif path == "/api/alerts":
                    self._json(_alerts_payload())
                elif path == "/api/traces":
                    self._json(_traces_payload())
                elif path == "/api/planner":
                    self._json(_planner_payload())
                elif path == "/api/devices":
                    self._json(_devices_payload())
                elif path == "/api/memory":
                    self._json(_memory_payload())
                elif path == "/api/profile":
                    self._json(_profile_payload(qs))
                elif path == "/api/queries":
                    self._json(_queries_payload(qs))
                elif path == "/api/principals":
                    self._json(_principals_payload())
                elif path == "/api/server":
                    self._json(_server_payload())
                elif path == "/api/fleet":
                    self._json(_fleet_payload(qs))
                elif path == "/api/history":
                    self._json(_history_payload(qs))
                elif _CANCEL_RE.match(path):
                    # cancel mutates: POST-only, so a prefetching
                    # browser/crawler can never kill a query
                    self._json({"error": "method not allowed",
                                "path": path}, code=405,
                               extra={"Allow": "POST"})
                elif path == "/profile":
                    self._send(_PROFILE_PAGE.encode(),
                               "text/html; charset=utf-8")
                elif path == "/memory":
                    self._send(_MEMORY_PAGE.encode(),
                               "text/html; charset=utf-8")
                elif path.startswith("/api/"):
                    self._api_404(path)
                else:
                    self.send_error(404)
            except BrokenPipeError:
                pass              # poller navigated away mid-response

        def do_POST(self):
            path, _, _ = self.path.partition("?")
            try:
                m = _CANCEL_RE.match(path)
                if m:
                    from .inflight import inflight
                    qid = m.group(1)
                    ok = inflight.cancel(qid)
                    self._json({"query_id": qid, "cancelled": ok},
                               code=200 if ok else 404)
                elif path.startswith("/api/"):
                    self._api_404(path)
                else:
                    self.send_error(404)
            except BrokenPipeError:
                pass

        def log_message(self, *args):   # polls must not spam stderr
            pass

    return start_server(_Handler, port, addr, "mosaic-ops-dashboard")
