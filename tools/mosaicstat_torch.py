#!/usr/bin/env python
"""mosaicstat: analyze a workload history directory with the port.

The port's counterpart of ``tools/mosaicstat.py``: the same subcommands,
flags, output and exit codes, over ``mosaic_tpu_torch`` alone.  Every
worker with ``mosaic.history.dir`` set writes one durable record per
completed query (``mosaic_tpu_torch/obs/history.py``; the JAX package
writes the same format); this CLI reads that directory — raw segments
and compacted summaries alike — from the outside.

    python tools/mosaicstat_torch.py top        --dir /tmp/hist
    python tools/mosaicstat_torch.py principals --dir /tmp/hist
    python tools/mosaicstat_torch.py strategies --dir /tmp/hist
    python tools/mosaicstat_torch.py heatmap    --dir /tmp/hist --top 20
    python tools/mosaicstat_torch.py diff       --dir /tmp/hist --json
    python tools/mosaicstat_torch.py layout     --store /tmp/store
    python tools/mosaicstat_torch.py report     --dir /tmp/hist

* ``top``        — the costliest raw-record queries by ``--by``
  (wall_ms by default; any cost-vector field works), outcome-tagged.
* ``principals`` — per-principal totals over every window: queries,
  wall, device seconds, rows, transfer bytes, compiles (0 in the
  port's own records: no jit).
* ``strategies`` — planner strategy win rates per decision point plus
  the mispredict count.
* ``heatmap``    — partition heat from the stored records: rows/bytes
  per store cell, hottest first, with the hot/cold skew ratio.
* ``diff``       — window-over-window regression check on the two
  most recent windows: per-operator p50/p95 slips, flagged past the
  20% threshold (exit code 3 when anything is flagged).  ``--json``
  emits the machine-readable verdict.
* ``layout``     — the learned store-layout recommendation
  (``mosaic_tpu_torch.sql.layout.advise_layout``): grid res + shard
  rows from an existing store's manifest (``--store``) plus whatever
  heat and history evidence the history dirs contribute.
* ``report``     — the full merged JSON report (all windows + totals).

``--dir`` defaults to ``MOSAIC_TPU_HISTORY_DIR`` then the configured
``mosaic.history.dir``; pass ``--dir`` more than once to merge several
workers' histories (exact merge — percentiles come from summed
buckets).  ``--window-ms`` re-windows raw records without touching
on-disk summaries.  Exit code 1 when the directory holds no records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _resolve_dirs(args) -> list:
    if args.dir:
        return list(args.dir)
    env = os.environ.get("MOSAIC_TPU_HISTORY_DIR", "").strip()
    if env:
        return [env]
    from mosaic_tpu_torch import config as _config
    d = _config.default_config().history_dir
    return [d] if d else []


def _merged(dirs, window_ms):
    """One report dict over one or many history dirs."""
    if len(dirs) == 1:
        from mosaic_tpu_torch.obs.history import report
        return report(dirs[0], window_ms)
    from mosaic_tpu_torch.obs.fleet import merge_history
    return merge_history(dirs, window_ms)


def cmd_top(dirs, args) -> int:
    from mosaic_tpu_torch.obs.history import load_records
    recs = []
    for d in dirs:
        recs.extend(load_records(d))
    if not recs:
        return 1
    by = args.by
    recs.sort(key=lambda r: -float((r.get("cost") or {}).get(by, 0)))
    print(f"{'query':<14} {'principal':<12} {'outcome':<10} "
          f"{by:>14}  sql")
    for r in recs[:args.top]:
        cost = r.get("cost") or {}
        sql = str(r.get("sql", ""))[:48]
        print(f"{str(r.get('query_id', '-')):<14} "
              f"{str(r.get('principal', '-')):<12} "
              f"{str(r.get('outcome', '-')):<10} "
              f"{float(cost.get(by, 0)):>14.3f}  {sql}")
    return 0


def cmd_principals(dirs, args) -> int:
    rep = _merged(dirs, args.window_ms)
    totals = rep["totals"]
    if not totals["queries"]:
        return 1
    print(f"{'principal':<16} {'queries':>8} {'wall_ms':>12} "
          f"{'device_s':>10} {'rows_out':>12} {'h2d_bytes':>14} "
          f"{'compiles':>9}")
    for p, t in totals["principals"].items():
        print(f"{p:<16} {t['queries']:>8} {t['wall_ms']:>12.1f} "
              f"{t['device_s']:>10.4f} {t['rows_out']:>12} "
              f"{t['h2d_bytes']:>14} {t['compiles']:>9}")
    return 0


def cmd_strategies(dirs, args) -> int:
    rep = _merged(dirs, args.window_ms)
    totals = rep["totals"]
    if not totals["queries"]:
        return 1
    strategies = totals.get("strategies", {})
    if not strategies:
        print("no planner strategy decisions recorded")
    for op, per in strategies.items():
        total = sum(per.values())
        print(f"{op} ({total} decisions)")
        for strat, n in sorted(per.items(), key=lambda kv: -kv[1]):
            print(f"  {strat:<40} {n:>7}  {100.0 * n / total:6.1f}%")
    print(f"mispredicts: {totals.get('mispredicts', 0)} over "
          f"{totals['queries']} queries")
    return 0


def cmd_heatmap(dirs, args) -> int:
    rep = _merged(dirs, args.window_ms)
    totals = rep["totals"]
    if not totals["queries"]:
        return 1
    parts = totals.get("partitions", {})
    if not parts:
        print("no partition accesses recorded")
        return 0
    rows = [r["rows"] for r in parts.values()]
    mean = sum(rows) / len(rows)
    skew = (max(rows) / mean) if mean else 0.0
    width = max(max(rows), 1)
    print(f"{len(parts)} partitions touched, hot/cold skew "
          f"{skew:.2f}x")
    print(f"{'cell':>8} {'queries':>8} {'rows':>12} {'bytes':>14}  "
          f"heat")
    for cell, v in list(parts.items())[:args.top]:
        bar = "#" * max(1, int(round(40.0 * v["rows"] / width))) \
            if v["rows"] else ""
        print(f"{cell:>8} {v['queries']:>8} {v['rows']:>12} "
              f"{v['bytes']:>14}  {bar}")
    return 0


def cmd_diff(dirs, args) -> int:
    from mosaic_tpu_torch.obs.history import window_diff
    rep = _merged(dirs, args.window_ms)
    windows = rep["windows"]
    if len(windows) < 2:
        print(f"mosaicstat: need 2 windows to diff, have "
              f"{len(windows)}", file=sys.stderr)
        return 1
    prev, cur = windows[-2], windows[-1]
    verdict = window_diff(prev, cur)
    if args.json:
        json.dump(verdict, sys.stdout, indent=2, default=str)
        print()
    else:
        print(f"window {verdict['a']} ({verdict['a_queries']} q) -> "
              f"{verdict['b']} ({verdict['b_queries']} q), "
              f"threshold {verdict['threshold']:.0%}")
        for op, d in verdict["operators"].items():
            flag = "  << REGRESSION" if d["flagged"] else ""
            print(f"  {op:<20} p50 {d['a_p50_ms']:>9.3f} -> "
                  f"{d['b_p50_ms']:>9.3f} ms ({d['slip_p50']:+.1%})  "
                  f"p95 {d['a_p95_ms']:>9.3f} -> "
                  f"{d['b_p95_ms']:>9.3f} ms "
                  f"({d['slip_p95']:+.1%}){flag}")
        if verdict["flagged"]:
            print(f"FLAGGED: {', '.join(verdict['flagged'])}")
    return 3 if verdict["flagged"] else 0


def cmd_layout(dirs, args) -> int:
    from mosaic_tpu_torch.sql.layout import advise_layout
    adv = advise_layout(store_root=args.store or None,
                        history_dir=dirs[0] if dirs else None)
    if args.json:
        json.dump({"grid_res": adv.grid_res,
                   "shard_rows": adv.shard_rows,
                   "reason": adv.reason,
                   "evidence": adv.evidence},
                  sys.stdout, indent=2, default=str)
        print()
        return 0
    print(f"recommended mosaic.store.grid.res   = {adv.grid_res}")
    print(f"recommended mosaic.store.shard.rows = {adv.shard_rows}")
    print(f"why: {adv.reason}")
    for src, ev in adv.evidence.items():
        print(f"  {src}: {ev}")
    if args.store:
        print(f"rewrite: mosaic_tpu_torch.sql.layout.rewrite_store("
              f"{args.store!r}, <dst>) re-buckets and proves "
              f"read-back bit-parity")
    return 0


def cmd_report(dirs, args) -> int:
    rep = _merged(dirs, args.window_ms)
    json.dump(rep, sys.stdout, indent=2, default=str)
    print()
    return 0 if rep["totals"]["queries"] else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    # --dir/--window-ms parse on BOTH sides of the subcommand: the
    # top-level parser owns real defaults, the subparsers share a
    # parent whose defaults are SUPPRESS so an after-subcommand
    # occurrence appends to (never clobbers) a before-subcommand one.
    # The parent must stay separate from the top-level options —
    # parents= shares action OBJECTS, and set_defaults on a shared
    # action would overwrite SUPPRESS for the subparsers too.
    _dir_help = ("history directory (repeatable for a fleet-wide "
                 "merge; default: MOSAIC_TPU_HISTORY_DIR / "
                 "configured mosaic.history.dir)")
    _win_help = ("re-window raw records at this width (default: "
                 "configured mosaic.history.window.ms)")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--dir", action="append", dest="dir_after",
                        default=argparse.SUPPRESS, help=_dir_help)
    common.add_argument("--window-ms", type=float,
                        dest="window_ms_after",
                        default=argparse.SUPPRESS, help=_win_help)
    ap = argparse.ArgumentParser(
        prog="mosaicstat", description=__doc__.splitlines()[0])
    ap.add_argument("--dir", action="append", default=None,
                    help=_dir_help)
    ap.add_argument("--window-ms", type=float, default=None,
                    help=_win_help)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("top", parents=[common],
                       help="costliest queries (raw records)")
    p.add_argument("--by", default="wall_ms",
                   choices=["wall_ms", "device_s", "rows_in",
                            "rows_out", "h2d_bytes", "d2h_bytes",
                            "mem_peak_bytes", "compiles"])
    p.add_argument("--top", type=int, default=10)
    sub.add_parser("principals", parents=[common],
                   help="per-principal totals")
    sub.add_parser("strategies", parents=[common],
                   help="planner strategy win rates")
    p = sub.add_parser("heatmap", parents=[common],
                       help="partition heat ranking")
    p.add_argument("--top", type=int, default=20)
    p = sub.add_parser("diff", parents=[common],
                       help="window-over-window regression check")
    p.add_argument("--json", action="store_true",
                   help="machine-readable verdict")
    p = sub.add_parser("layout", parents=[common],
                       help="learned store-layout recommendation")
    p.add_argument("--store", default=None,
                   help="existing store root whose manifest seeds "
                        "the evidence (else heat/history only)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable recommendation")
    sub.add_parser("report", parents=[common],
                   help="full merged JSON report")
    args = ap.parse_args(argv)
    # fold after-subcommand occurrences into the top-level dests
    args.dir = ((args.dir or [])
                + list(getattr(args, "dir_after", None) or [])) or None
    if getattr(args, "window_ms_after", None) is not None:
        args.window_ms = args.window_ms_after

    dirs = _resolve_dirs(args)
    if not dirs and args.cmd != "layout":
        # layout can run from a store manifest (or heat) alone
        print("mosaicstat: no history dir (--dir, "
              "MOSAIC_TPU_HISTORY_DIR, or SET mosaic.history.dir)",
              file=sys.stderr)
        return 2
    handler = {"top": cmd_top, "principals": cmd_principals,
               "strategies": cmd_strategies, "heatmap": cmd_heatmap,
               "diff": cmd_diff, "layout": cmd_layout,
               "report": cmd_report}[args.cmd]
    rc = handler(dirs, args)
    if rc == 1 and args.cmd != "diff":   # diff prints its own reason
        print(f"mosaicstat: no records under "
              f"{', '.join(dirs)}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
