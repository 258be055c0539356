"""Workload history plane: durable per-query statistics on disk.

Port copy of ``mosaic_tpu.obs.history``: the same names, on-disk layout,
``HISTORY_VERSION``, counters, events and fault site, so a history
directory that either package writes loads in the other.
:func:`~.accounting.complete` hands this module exactly one record per
completed query (principal, outcome, the full cost vector, planner
strategy picks and mispredict count, fusion groups run, and the store
partitions the query touched).  The port has no jit, so the cost
vector's ``compiles`` is 0 (ROADMAP C14).

On-disk layout under ``mosaic.history.dir`` (env
``MOSAIC_TPU_HISTORY_DIR`` pins the directory over conf):

* ``history-<pid>.open.jsonl`` — this process's open segment: a version
  header line, then one JSON record per completed query, appended and
  flushed per record.  Per-pid names keep writers of different
  processes apart.
* ``history-<ts>-<pid>-<n>.jsonl`` — closed segments.  Rotation (size
  over ``mosaic.history.segment.bytes`` or age over
  ``mosaic.history.segment.age.ms``) publishes the open segment by fsync
  + ``os.replace``, so a closed segment is never torn.
  ``mosaic.history.retain`` caps how many closed segments survive,
  oldest dropped first.
* ``summary-<window>.json`` — compaction output: closed segments fold
  into one versioned summary per ``mosaic.history.window.ms`` window
  (tmp + fsync + ``os.replace``), then the segments are deleted.
  Summaries keep per-operator wall-time histograms in the registry's
  bucket layout (:class:`~.metrics.Histogram`), so merging summaries —
  across windows, or across workers (:func:`~.fleet.merge_history`) —
  gives p50/p95 bit-equal to one store fed every record.

Degrade, not die: a torn or wrong-version segment costs a
``history_segment_torn`` recorder event and a ``history/segments_torn``
count — readers keep every record before the tear and never raise;
the feed turns an ``OSError`` into ``history/write_errors`` so a full
disk cannot fail a query.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import _NBUCKETS, Histogram, _bucket_of, metrics
from .recorder import recorder

__all__ = ["HISTORY_VERSION", "HistoryStore", "history",
           "history_record", "read_segment", "read_summary",
           "segment_paths", "summary_paths", "load_records",
           "new_summary", "fold_record", "merge_summary",
           "summarize_records", "summary_payload", "report",
           "window_diff"]

HISTORY_VERSION = 1

#: wall-time histograms in summaries bucket milliseconds — bucket 0
#: tops out at 1 us of wall, the range covers ~70 min per query
_WALL_SCALE = 1e-3

#: cost-vector fields summed per principal in a window summary
_COST_FIELDS = ("wall_ms", "device_s", "rows_in", "rows_out",
                "h2d_bytes", "d2h_bytes", "mem_peak_bytes", "compiles")

#: a window-vs-window p50/p95 regression past this fraction is flagged
SLIP_THRESHOLD = 0.20


def _note_torn(path: str, why: str) -> None:
    """The degrade path for anything unusable on disk: event +
    counter, never an exception."""
    recorder.record("history_segment_torn", path=path, why=why[:300])
    if metrics.enabled:
        metrics.count("history/segments_torn")


# ------------------------------------------------------------ file map

def segment_paths(directory: str) -> Tuple[List[str], List[str]]:
    """(closed segments sorted oldest-first, open segments) under
    ``directory`` — name order IS age order for closed segments (the
    rotation timestamp is zero-padded)."""
    allseg = glob.glob(os.path.join(directory, "history-*.jsonl"))
    opens = sorted(p for p in allseg if p.endswith(".open.jsonl"))
    closed = sorted(p for p in allseg if not p.endswith(".open.jsonl"))
    return closed, opens


def summary_paths(directory: str) -> List[str]:
    return sorted(glob.glob(os.path.join(directory, "summary-*.json")))


# ----------------------------------------------------------- segments

def read_segment(path: str) -> List[Dict[str, Any]]:
    """Every intact record in one segment.  Torn tails (a kill -9
    mid-append), torn headers, and alien versions degrade per
    :func:`_note_torn` — the records before a tear are kept, the loss
    is confined to what follows it."""
    recs: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().split("\n")
    except OSError as e:
        _note_torn(path, f"unreadable: {e}")
        return recs
    if not lines or not lines[0].strip():
        _note_torn(path, "empty segment (no header)")
        return recs
    try:
        header = json.loads(lines[0])
    except ValueError as e:
        _note_torn(path, f"torn header: {e}")
        return recs
    if not isinstance(header, dict) or \
            header.get("history") != HISTORY_VERSION:
        got = header.get("history") if isinstance(header, dict) \
            else header
        _note_torn(path, f"version {got!r} != {HISTORY_VERSION}")
        return recs
    for i, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            _note_torn(path, f"torn record at line {i}: {e}")
            break
        if isinstance(rec, dict):
            recs.append(rec)
    return recs


def load_records(directory: str) -> List[Dict[str, Any]]:
    """Raw per-query records from every segment (closed oldest-first,
    then open) — the ``mosaicstat top`` substrate.  Compacted records
    live only in summaries and are not returned here."""
    closed, opens = segment_paths(directory)
    out: List[Dict[str, Any]] = []
    for p in closed + opens:
        out.extend(read_segment(p))
    return out


# ---------------------------------------------------------- summaries

def _new_hist(scale: float = _WALL_SCALE) -> Dict[str, Any]:
    return {"scale": scale, "counts": [0] * _NBUCKETS,
            "count": 0, "sum": 0.0, "min": 0.0, "max": 0.0}


def _hist_observe(h: Dict[str, Any], v: float) -> None:
    v = float(v)
    h["counts"][_bucket_of(v, h["scale"])] += 1
    h["count"] += 1
    h["sum"] += v
    if h["count"] == 1:
        h["min"] = v
        h["max"] = v
    else:
        h["min"] = min(h["min"], v)
        h["max"] = max(h["max"], v)


def _hist_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Bucket-wise sum — exact iff the layouts match (the fleet
    aggregator's contract); a mismatch raises for the caller's
    degrade path."""
    if float(src["scale"]) != float(dst["scale"]):
        raise ValueError(f"histogram scale {src['scale']} "
                         f"!= {dst['scale']}")
    counts = [int(c) for c in src["counts"]]
    if len(counts) != len(dst["counts"]):
        raise ValueError(f"{len(counts)} buckets "
                         f"!= {len(dst['counts'])}")
    for i, c in enumerate(counts):
        dst["counts"][i] += c
    n = int(src["count"])
    if n:
        dst["min"] = float(src["min"]) if dst["count"] == 0 \
            else min(dst["min"], float(src["min"]))
        dst["max"] = max(dst["max"], float(src["max"]))
    dst["count"] += n
    dst["sum"] += float(src["sum"])


def _as_histogram(name: str, h: Dict[str, Any]) -> Histogram:
    """Re-hydrate a summary histogram for exact percentile reads."""
    import math
    hh = Histogram(name, float(h["scale"]))
    hh.counts = [int(c) for c in h["counts"]]
    hh.count = int(h["count"])
    hh.sum = float(h["sum"])
    hh.min = float(h["min"]) if hh.count else math.inf
    hh.max = float(h["max"])
    return hh


def new_summary(window: Optional[int],
                window_ms: float) -> Dict[str, Any]:
    """An empty per-window summary record (``window`` None = the
    all-windows totals accumulator)."""
    return {
        "history": HISTORY_VERSION,
        "window": window,
        "window_ms": float(window_ms),
        "start_ts": 0.0,
        "end_ts": 0.0,
        "queries": 0,
        "outcomes": {},
        "principals": {},
        "operators": {},
        "strategies": {},
        "fusion_groups": {},
        "mispredicts": 0,
        "partitions": {},
    }


def fold_record(summary: Dict[str, Any], rec: Dict[str, Any]) -> None:
    """Fold one per-query record into a window summary."""
    cost = rec.get("cost") or {}
    ts = float(rec.get("end_ts") or rec.get("start_ts") or 0.0)
    if summary["queries"] == 0:
        summary["start_ts"] = ts
        summary["end_ts"] = ts
    else:
        summary["start_ts"] = min(summary["start_ts"], ts)
        summary["end_ts"] = max(summary["end_ts"], ts)
    summary["queries"] += 1
    outcome = str(rec.get("outcome", "ok"))
    summary["outcomes"][outcome] = \
        summary["outcomes"].get(outcome, 0) + 1
    p = str(rec.get("principal", "anonymous"))
    pt = summary["principals"].get(p)
    if pt is None:
        pt = summary["principals"][p] = dict(
            {"queries": 0}, **{f: 0 for f in _COST_FIELDS})
    pt["queries"] += 1
    for f in _COST_FIELDS:
        v = cost.get(f, 0)
        pt[f] = pt[f] + (float(v) if f in ("wall_ms", "device_s")
                         else int(v))
    op = str(rec.get("operator") or "-")
    h = summary["operators"].get(op)
    if h is None:
        h = summary["operators"][op] = _new_hist()
    _hist_observe(h, float(cost.get("wall_ms", 0.0)))
    for sop, strat in (rec.get("strategies") or {}).items():
        per = summary["strategies"].setdefault(str(sop), {})
        per[str(strat)] = per.get(str(strat), 0) + 1
    for g in rec.get("fusion_groups") or ():
        summary["fusion_groups"][str(g)] = \
            summary["fusion_groups"].get(str(g), 0) + 1
    summary["mispredicts"] += int(rec.get("mispredicts", 0))
    for cell, pv in (rec.get("partitions") or {}).items():
        e = summary["partitions"].get(str(cell))
        if e is None:
            e = summary["partitions"][str(cell)] = \
                {"queries": 0, "rows": 0, "bytes": 0}
        e["queries"] += 1
        e["rows"] += int((pv or {}).get("rows", 0))
        e["bytes"] += int((pv or {}).get("bytes", 0))


def merge_summary(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Exact summary merge: integer counters summed, histograms
    bucket-wise (raises ``ValueError`` on a layout mismatch — the
    caller degrades).  Merging N workers' summaries for one window
    reproduces the single-store summary's percentiles bit-for-bit."""
    if src.get("queries", 0):
        if dst["queries"] == 0:
            dst["start_ts"] = float(src["start_ts"])
            dst["end_ts"] = float(src["end_ts"])
        else:
            dst["start_ts"] = min(dst["start_ts"],
                                  float(src["start_ts"]))
            dst["end_ts"] = max(dst["end_ts"], float(src["end_ts"]))
    dst["queries"] += int(src.get("queries", 0))
    for o, n in (src.get("outcomes") or {}).items():
        dst["outcomes"][o] = dst["outcomes"].get(o, 0) + int(n)
    for p, pt in (src.get("principals") or {}).items():
        cur = dst["principals"].get(p)
        if cur is None:
            cur = dst["principals"][p] = dict(
                {"queries": 0}, **{f: 0 for f in _COST_FIELDS})
        cur["queries"] += int(pt.get("queries", 0))
        for f in _COST_FIELDS:
            v = pt.get(f, 0)
            cur[f] = cur[f] + (float(v) if f in ("wall_ms", "device_s")
                               else int(v))
    for op, h in (src.get("operators") or {}).items():
        cur = dst["operators"].get(op)
        if cur is None:
            dst["operators"][op] = {
                "scale": float(h["scale"]),
                "counts": [int(c) for c in h["counts"]],
                "count": int(h["count"]), "sum": float(h["sum"]),
                "min": float(h["min"]), "max": float(h["max"])}
        else:
            _hist_merge(cur, h)
    for sop, per in (src.get("strategies") or {}).items():
        cur = dst["strategies"].setdefault(sop, {})
        for strat, n in per.items():
            cur[strat] = cur.get(strat, 0) + int(n)
    for g, n in (src.get("fusion_groups") or {}).items():
        dst["fusion_groups"][g] = dst["fusion_groups"].get(g, 0) \
            + int(n)
    dst["mispredicts"] += int(src.get("mispredicts", 0))
    for cell, pv in (src.get("partitions") or {}).items():
        e = dst["partitions"].get(cell)
        if e is None:
            e = dst["partitions"][cell] = \
                {"queries": 0, "rows": 0, "bytes": 0}
        e["queries"] += int(pv.get("queries", 0))
        e["rows"] += int(pv.get("rows", 0))
        e["bytes"] += int(pv.get("bytes", 0))


def _window_of(rec: Dict[str, Any], window_ms: float) -> int:
    ts = float(rec.get("end_ts") or rec.get("start_ts") or 0.0)
    if window_ms <= 0:
        return 0
    return int(ts * 1e3 // window_ms)


def summarize_records(records: List[Dict[str, Any]],
                      window_ms: float) -> Dict[int, Dict[str, Any]]:
    """Window id -> summary for a record stream (the in-memory twin of
    compaction; the fleet-merge oracle tests run through this)."""
    out: Dict[int, Dict[str, Any]] = {}
    for rec in records:
        wid = _window_of(rec, window_ms)
        s = out.get(wid)
        if s is None:
            s = out[wid] = new_summary(wid, window_ms)
        fold_record(s, rec)
    return out


def summary_payload(s: Dict[str, Any]) -> Dict[str, Any]:
    """The JSON view of a summary: raw bucket arrays replaced with
    derived per-operator latency stats (p50/p95 exact to one bucket)."""
    ops = {}
    for op, h in sorted(s.get("operators", {}).items()):
        hh = _as_histogram(op, h)
        ops[op] = {
            "count": hh.count,
            "mean_ms": round(hh.sum / hh.count, 3) if hh.count else 0.0,
            "p50_ms": round(hh.percentile(50), 3),
            "p95_ms": round(hh.percentile(95), 3),
            "max_ms": round(hh.max, 3),
        }
    return {
        "window": s.get("window"),
        "window_ms": s.get("window_ms"),
        "start_ts": round(float(s.get("start_ts", 0.0)), 3),
        "end_ts": round(float(s.get("end_ts", 0.0)), 3),
        "queries": s.get("queries", 0),
        "outcomes": dict(sorted(s.get("outcomes", {}).items())),
        "principals": {p: dict(t) for p, t in
                       sorted(s.get("principals", {}).items())},
        "operators": ops,
        "strategies": {op: dict(sorted(per.items())) for op, per in
                       sorted(s.get("strategies", {}).items())},
        "fusion_groups": dict(sorted(
            s.get("fusion_groups", {}).items())),
        "mispredicts": s.get("mispredicts", 0),
        "partitions": {c: dict(v) for c, v in
                       sorted(s.get("partitions", {}).items(),
                              key=lambda kv: (-kv[1]["rows"],
                                              kv[0]))},
    }


def read_summary(path: str) -> Optional[Dict[str, Any]]:
    """One summary file, or None after the torn/alien degrade path."""
    try:
        with open(path, encoding="utf-8") as fh:
            s = json.load(fh)
    except (OSError, ValueError) as e:
        _note_torn(path, f"torn summary: {e}")
        return None
    if not isinstance(s, dict) or \
            s.get("history") != HISTORY_VERSION:
        got = s.get("history") if isinstance(s, dict) else s
        _note_torn(path, f"summary version {got!r} "
                         f"!= {HISTORY_VERSION}")
        return None
    return s


# ----------------------------------------------------------- reports

def _resolve_window_ms(window_ms: Optional[float]) -> float:
    if window_ms is not None:
        return float(window_ms)
    # env pin first (same contract as MOSAIC_TPU_HISTORY_DIR): a CI
    # lane or operator shell with no conf can still window a drill
    env = os.environ.get("MOSAIC_TPU_HISTORY_WINDOW_MS", "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    from .. import config as _config
    return float(getattr(_config.default_config(),
                         "history_window_ms", 3_600_000.0))


def merged_windows(directory: str,
                   window_ms: Optional[float] = None
                   ) -> Dict[int, Dict[str, Any]]:
    """Window id -> exact summary over EVERYTHING in a history dir:
    on-disk summaries merged with raw segment records windowed at
    ``window_ms``.  Torn anything degrades (event + counter)."""
    window_ms = _resolve_window_ms(window_ms)
    windows: Dict[int, Dict[str, Any]] = {}
    for sp in summary_paths(directory):
        s = read_summary(sp)
        if s is None:
            continue
        wid = int(s.get("window", 0))
        cur = windows.get(wid)
        if cur is None:
            windows[wid] = s
        else:
            try:
                merge_summary(cur, s)
            except (KeyError, TypeError, ValueError) as e:
                _note_torn(sp, f"unmergeable summary: {e}")
    for wid, s in summarize_records(load_records(directory),
                                    window_ms).items():
        cur = windows.get(wid)
        if cur is None:
            windows[wid] = s
        else:
            try:
                merge_summary(cur, s)
            except (KeyError, TypeError, ValueError) as e:
                _note_torn(directory, f"unmergeable window {wid}: {e}")
    return windows


def report(directory: str,
           window_ms: Optional[float] = None) -> Dict[str, Any]:
    """The merged JSON view of one history dir: every window's payload
    (oldest first) plus all-windows totals."""
    windows = merged_windows(directory, window_ms)
    totals = new_summary(None, _resolve_window_ms(window_ms))
    for wid in sorted(windows):
        try:
            merge_summary(totals, windows[wid])
        except (KeyError, TypeError, ValueError) as e:
            _note_torn(directory, f"unmergeable window {wid}: {e}")
    return {
        "dir": directory,
        "windows": [summary_payload(windows[w])
                    for w in sorted(windows)],
        "totals": summary_payload(totals),
    }


def window_diff(a: Dict[str, Any],
                b: Dict[str, Any]) -> Dict[str, Any]:
    """Window-vs-window regression diff over two summary payloads
    (``a`` the baseline, ``b`` the candidate): per-operator p50/p95
    with the fractional slip, flagging operators past
    ``SLIP_THRESHOLD`` (+20%)."""
    ops: Dict[str, Any] = {}
    flagged: List[str] = []
    for op in sorted(set(a.get("operators", {}))
                     | set(b.get("operators", {}))):
        ah = a.get("operators", {}).get(op)
        bh = b.get("operators", {}).get(op)
        row: Dict[str, Any] = {
            "a_p50_ms": ah["p50_ms"] if ah else None,
            "b_p50_ms": bh["p50_ms"] if bh else None,
            "a_p95_ms": ah["p95_ms"] if ah else None,
            "b_p95_ms": bh["p95_ms"] if bh else None,
        }
        if ah and bh:
            for q in ("p50", "p95"):
                base = float(ah[f"{q}_ms"])
                cand = float(bh[f"{q}_ms"])
                slip = (cand - base) / base if base > 0 else 0.0
                row[f"slip_{q}"] = round(slip, 4)
            row["flagged"] = bool(
                row["slip_p50"] > SLIP_THRESHOLD or
                row["slip_p95"] > SLIP_THRESHOLD)
            if row["flagged"]:
                flagged.append(op)
        else:
            row["flagged"] = False
        ops[op] = row
    return {
        "a": a.get("window"),
        "b": b.get("window"),
        "a_queries": a.get("queries", 0),
        "b_queries": b.get("queries", 0),
        "threshold": SLIP_THRESHOLD,
        "operators": ops,
        "flagged": flagged,
    }


# -------------------------------------------------------- the writer

class HistoryStore:
    """One process's append side of a history directory (reads are
    module functions — any process may read or compact any dir).

    Rotation/retention/compaction knobs default to the live conf per
    call (``SET`` takes effect immediately); constructor overrides pin
    them for tests."""

    def __init__(self, directory: str, *,
                 segment_bytes: Optional[int] = None,
                 segment_age_ms: Optional[float] = None,
                 retain: Optional[int] = None,
                 window_ms: Optional[float] = None):
        self.directory = str(directory)
        self._segment_bytes = segment_bytes
        self._segment_age_ms = segment_age_ms
        self._retain = retain
        self._window_ms = window_ms
        self._lock = threading.Lock()
        self._fh = None
        self._open_bytes = 0
        self._opened_ts = 0.0
        self._rotations = 0

    # -- conf ---------------------------------------------------------
    def _cfg(self):
        from .. import config as _config
        return _config.default_config()

    def segment_bytes(self) -> int:
        if self._segment_bytes is not None:
            return int(self._segment_bytes)
        return int(getattr(self._cfg(), "history_segment_bytes",
                           1_048_576))

    def segment_age_ms(self) -> float:
        if self._segment_age_ms is not None:
            return float(self._segment_age_ms)
        return float(getattr(self._cfg(), "history_segment_age_ms",
                             0.0))

    def retain(self) -> int:
        if self._retain is not None:
            return int(self._retain)
        return int(getattr(self._cfg(), "history_retain", 64))

    def window_ms(self) -> float:
        if self._window_ms is not None:
            return float(self._window_ms)
        return _resolve_window_ms(None)

    # -- paths --------------------------------------------------------
    @property
    def open_path(self) -> str:
        return os.path.join(self.directory,
                            f"history-{os.getpid()}.open.jsonl")

    def _closed_path(self, ts: float) -> str:
        n = self._rotations          # callers hold self._lock
        path = os.path.join(
            self.directory,
            f"history-{int(ts * 1e3):013d}-{os.getpid()}-{n:04d}"
            ".jsonl")
        while os.path.exists(path):
            n += 1
            path = os.path.join(
                self.directory,
                f"history-{int(ts * 1e3):013d}-{os.getpid()}-{n:04d}"
                ".jsonl")
        return path

    # -- append -------------------------------------------------------
    def _ensure_open_locked(self):
        if self._fh is not None:
            return self._fh
        os.makedirs(self.directory, exist_ok=True)
        if os.path.exists(self.open_path):
            # a previous incarnation of this pid left an open segment
            # behind (crash, or pid reuse): publish it as closed so
            # its records survive and this run starts a fresh header
            self._publish_locked(self.open_path)
        now = time.time()
        fh = open(self.open_path, "w", encoding="utf-8")
        header = json.dumps({"history": HISTORY_VERSION,
                             "pid": os.getpid(), "opened_ts": now})
        fh.write(header + "\n")
        fh.flush()
        self._fh = fh
        self._open_bytes = len(header) + 1
        self._opened_ts = now
        return fh

    def _publish_locked(self, open_path: str) -> None:
        """fsync + atomic rename of an open segment to its closed
        name — after this a reader can never see it torn."""
        closed = self._closed_path(time.time())
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        else:
            fd = os.open(open_path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        os.replace(open_path, closed)
        self._rotations += 1
        self._open_bytes = 0
        if metrics.enabled:
            metrics.count("history/segments_rotated")

    def append(self, record: Dict[str, Any]) -> None:
        """Append one completed-query record to the open segment,
        rotating first if the segment is over size or age.  Raises
        ``OSError`` on I/O trouble — the feed singleton downgrades it
        to a counter so queries never fail over history."""
        from ..resilience import faults
        faults.maybe_fail("history.write")
        line = json.dumps(record, default=str, sort_keys=True)
        with self._lock:
            fh = self._ensure_open_locked()
            age_ms = (time.time() - self._opened_ts) * 1e3
            max_age = self.segment_age_ms()
            if self._open_bytes + len(line) + 1 > self.segment_bytes() \
                    and self._open_bytes > 0 or \
                    (max_age > 0 and age_ms > max_age):
                self._publish_locked(self.open_path)
                self._enforce_retention_locked()
                fh = self._ensure_open_locked()
            fh.write(line + "\n")
            fh.flush()
            self._open_bytes += len(line) + 1
        if metrics.enabled:
            metrics.count("history/records_written")

    def rotate(self) -> Optional[str]:
        """Force-publish the open segment (bench round boundaries and
        tests); returns the closed path, or None with nothing open."""
        with self._lock:
            if self._fh is None and \
                    not os.path.exists(self.open_path):
                return None
            before = {p for p in segment_paths(self.directory)[0]}
            self._publish_locked(self.open_path)
            self._enforce_retention_locked()
            after = segment_paths(self.directory)[0]
            new = [p for p in after if p not in before]
            return new[-1] if new else None

    def _enforce_retention_locked(self) -> None:
        cap = self.retain()
        if cap <= 0:
            return
        closed, _ = segment_paths(self.directory)
        for p in closed[:max(0, len(closed) - cap)]:
            try:
                os.remove(p)
            except OSError:
                continue
            if metrics.enabled:
                metrics.count("history/segments_dropped")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # -- compaction ---------------------------------------------------
    def compact(self) -> Dict[str, Any]:
        """Fold every CLOSED segment into per-window summary files
        (tmp + fsync + ``os.replace``), then delete the segments.
        Open segments are untouched.  Torn segments contribute their
        readable prefix and are removed with the rest — their loss is
        already counted.  Returns compaction stats for bench."""
        window_ms = self.window_ms()
        closed, _ = segment_paths(self.directory)
        bytes_before = 0
        records = 0
        by_window: Dict[int, Dict[str, Any]] = {}
        for p in closed:
            try:
                bytes_before += os.path.getsize(p)
            except OSError:
                pass
            for rec in read_segment(p):
                records += 1
                wid = _window_of(rec, window_ms)
                s = by_window.get(wid)
                if s is None:
                    s = by_window[wid] = new_summary(wid, window_ms)
                fold_record(s, rec)
        bytes_after = 0
        for wid, s in sorted(by_window.items()):
            path = os.path.join(self.directory,
                                f"summary-{wid:013d}.json")
            if os.path.exists(path):
                prev = read_summary(path)
                if prev is not None:
                    try:
                        merge_summary(prev, s)
                        s = prev
                    except (KeyError, TypeError, ValueError) as e:
                        _note_torn(path, f"unmergeable summary: {e}")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(s, fh, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            try:
                bytes_after += os.path.getsize(path)
            except OSError:
                pass
        for p in closed:
            try:
                os.remove(p)
            except OSError:
                continue
            if metrics.enabled:
                metrics.count("history/segments_compacted")
        return {"segments": len(closed), "records": records,
                "summaries": len(by_window),
                "bytes_before": bytes_before,
                "bytes_after": bytes_after}


# ----------------------------------------------------------- the feed

def history_record(record: Dict[str, Any],
                   ticket) -> Dict[str, Any]:
    """The audit completion record widened with the ticket's history
    columns: mispredict count, fusion groups run, partitions touched
    (rows read + bytes staged per store cell)."""
    hrec = dict(record)
    hrec["mispredicts"] = int(getattr(ticket, "mispredicts", 0) or 0)
    hrec["fusion_groups"] = [str(g) for g in
                             getattr(ticket, "fusion_groups", ()) or ()]
    parts = getattr(ticket, "partitions", None) or {}
    hrec["partitions"] = {str(c): {"rows": int(v[0]),
                                   "bytes": int(v[1])}
                          for c, v in parts.items()}
    return hrec


class HistoryFeed:
    """The conf-driven process singleton :func:`~.accounting.complete`
    writes through.  Re-resolves ``mosaic.history.dir`` (or the
    ``MOSAIC_TPU_HISTORY_DIR`` env pin) per record so ``SET`` takes
    effect immediately; "" keeps the plane off at one string check
    per completed query."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._store: Optional[HistoryStore] = None
        self._write_errors = 0

    @staticmethod
    def _resolve_dir() -> str:
        env = os.environ.get("MOSAIC_TPU_HISTORY_DIR")
        if env is not None:
            return env.strip()
        from .. import config as _config
        return getattr(_config.default_config(), "history_dir",
                       "") or ""

    def directory(self) -> str:
        """The resolved history dir ("" = plane off)."""
        return self._resolve_dir()

    def store(self) -> Optional[HistoryStore]:
        d = self._resolve_dir()
        with self._lock:
            if not d:
                if self._store is not None:
                    self._store.close()
                    self._store = None
                    self._dir = None
                return None
            if self._store is None or self._dir != d:
                if self._store is not None:
                    self._store.close()
                self._store = HistoryStore(d)
                self._dir = d
            return self._store

    def record_completion(self, record: Dict[str, Any],
                          ticket) -> Optional[Dict[str, Any]]:
        """Write one completed query's history record; never raises
        (full disk / injected I/O faults land in
        ``history/write_errors``)."""
        st = self.store()
        if st is None:
            return None
        hrec = history_record(record, ticket)
        try:
            st.append(hrec)
        except OSError:
            with self._lock:
                self._write_errors += 1
            if metrics.enabled:
                metrics.count("history/write_errors")
            return None
        return hrec

    def write_errors(self) -> int:
        with self._lock:
            return self._write_errors

    def reset(self) -> None:
        with self._lock:
            if self._store is not None:
                self._store.close()
            self._store = None
            self._dir = None
            self._write_errors = 0


#: the process-global feed accounting.complete writes through
history = HistoryFeed()
