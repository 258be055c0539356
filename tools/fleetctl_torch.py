#!/usr/bin/env python
"""fleetctl: inspect a fleet telemetry spool directory with the port.

The port's counterpart of ``tools/fleetctl.py``: the same subcommands,
flags, output and exit codes, over ``mosaic_tpu_torch`` alone.  Every
worker process spools its telemetry under ``mosaic.obs.fleet.dir``
(``mosaic_tpu_torch/obs/spool.py``; the JAX package writes the same
format); this CLI runs :class:`~mosaic_tpu_torch.obs.fleet.
FleetAggregator` over that directory from the outside — an operator
shell, a cron probe, a CI assert.

    python tools/fleetctl_torch.py list    --dir /tmp/fleet
    python tools/fleetctl_torch.py alerts  --dir /tmp/fleet
    python tools/fleetctl_torch.py metrics --dir /tmp/fleet
    python tools/fleetctl_torch.py traces  --dir /tmp/fleet
    python tools/fleetctl_torch.py bundle  --dir /tmp/fleet --out fleet.json

* ``list``    — one line per worker: pid, spool age, fresh/STALE, any
  read error (torn spool, alien version).
* ``alerts``  — merged per-worker active SLO alerts plus the fleet-
  level burn-rate evaluation over the merged series.
* ``metrics`` — the worker-labeled OpenMetrics exposition of the
  merged view (counters/gauges per worker, histograms exactly merged).
* ``traces``  — stitched cross-process traces: every W3C trace id the
  fleet served, which workers took part, and their spans.
* ``bundle``  — the full fleet bundle as JSON (to ``--out`` or
  stdout): merged view + fleet SLO + stitched traces + every worker's
  recent flight-recorder events.

``--dir`` defaults to the configured ``mosaic.obs.fleet.dir`` (env
``MOSAIC_TPU_FLEET_DIR`` overrides for shells with no conf).  Exit
code 1 when the directory has no readable spools at all, 2 when no
directory is named.
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


def _resolve_dir(arg: Optional[str]) -> str:
    if arg:
        return arg
    env = os.environ.get("MOSAIC_TPU_FLEET_DIR", "").strip()
    if env:
        return env
    from mosaic_tpu_torch import config as _config
    return _config.default_config().obs_fleet_dir


def cmd_list(agg, view, args) -> int:
    for w in view.workers:
        state = "STALE" if w.stale else "fresh"
        err = f"  [{w.error}]" if w.error else ""
        print(f"worker {w.pid:>7}  age {w.age_s:7.2f}s  "
              f"{state}{err}")
    print(f"{len(view.workers)} workers, "
          f"{sum(1 for w in view.workers if w.stale)} stale, "
          f"{view.merge_errors} merge errors")
    return 0


def cmd_alerts(agg, view, args) -> int:
    out = {"active": view.slo_active,
           "breaches": view.slo_breaches,
           "fleet": [r for r in agg.evaluate_slo(view)
                     if args.all or r.get("breached")]}
    json.dump(out, sys.stdout, indent=2, default=str)
    print()
    return 0


def cmd_metrics(agg, view, args) -> int:
    from mosaic_tpu_torch.obs.openmetrics import fleet_to_openmetrics
    sys.stdout.write(fleet_to_openmetrics(view))
    return 0


def cmd_traces(agg, view, args) -> int:
    json.dump(agg.stitched_traces(view), sys.stdout, indent=2,
              default=str)
    print()
    return 0


def cmd_bundle(agg, view, args) -> int:
    bundle = agg.bundle(view)
    if args.out:
        tmp = f"{args.out}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh, default=str)
        os.replace(tmp, args.out)
        print(f"fleet bundle -> {args.out}")
    else:
        json.dump(bundle, sys.stdout, indent=2, default=str)
        print()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleetctl", description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None,
                    help="spool directory (default: configured "
                         "mosaic.obs.fleet.dir / MOSAIC_TPU_FLEET_DIR)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="workers + freshness")
    p = sub.add_parser("alerts", help="merged + fleet-level alerts")
    p.add_argument("--all", action="store_true",
                   help="include non-breaching fleet objectives")
    sub.add_parser("metrics", help="worker-labeled OpenMetrics")
    sub.add_parser("traces", help="stitched cross-process traces")
    p = sub.add_parser("bundle", help="dump the fleet bundle")
    p.add_argument("--out", default=None,
                   help="write JSON here (default: stdout)")
    args = ap.parse_args(argv)

    directory = _resolve_dir(args.dir)
    if not directory:
        print("fleetctl: no spool dir (--dir, MOSAIC_TPU_FLEET_DIR, "
              "or SET mosaic.obs.fleet.dir)", file=sys.stderr)
        return 2
    from mosaic_tpu_torch.obs.fleet import aggregator_for
    agg = aggregator_for(directory)
    view = agg.scan()
    handler = {"list": cmd_list, "alerts": cmd_alerts,
               "metrics": cmd_metrics, "traces": cmd_traces,
               "bundle": cmd_bundle}[args.cmd]
    rc = handler(agg, view, args)
    if rc == 0 and not any(w.readable for w in view.workers):
        print(f"fleetctl: no readable spools under {directory}",
              file=sys.stderr)
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
