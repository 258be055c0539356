#!/usr/bin/env python3
"""graftlint CLI: run the static-analysis rules over the port (mosaic_tpu_torch).

Usage (from the repo root):

    python tools/graftlint_torch.py --check          # CI gate: exit 0/1
    python tools/graftlint_torch.py --json           # machine output
    python tools/graftlint_torch.py --rules device-raw-load,lock-unguarded-attr
    python tools/graftlint_torch.py --changed        # findings in the diff
    python tools/graftlint_torch.py --changed origin/main   # ...vs a ref
    python tools/graftlint_torch.py --sarif out.sarif  # PR-annotation output
    python tools/graftlint_torch.py --list-rules     # rule catalogue
    python tools/graftlint_torch.py --update-baseline  # rewrite baseline

Exit codes: 0 clean (every finding suppressed or baselined), 1 new
findings (or stale baseline entries under --check), 2 tool error
(corrupt baseline, bad arguments).

The rules are the port's copy of mosaic_tpu/lint, in
mosaic_tpu_torch/lint; --list-rules prints their catalogue, and
docs/usage/linting.md describes the suppression/baseline workflow both
linters share.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, _ROOT)


def _import_lint():
    """Load mosaic_tpu_torch.lint WITHOUT importing mosaic_tpu_torch:
    the package __init__ pulls torch, which the pure-stdlib linter never
    touches — skipping it keeps ``--changed`` pre-commit runs inside
    their latency budget.  The lint package only uses relative imports
    internally, so it loads cleanly under a private name."""
    import importlib.util
    pkg = os.path.join(_ROOT, "mosaic_tpu_torch", "lint")
    spec = importlib.util.spec_from_file_location(
        "_graftlint_torch_rules", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_graftlint_torch_rules"] = mod
    spec.loader.exec_module(mod)
    return mod


lint = _import_lint()

DEFAULT_BASELINE = os.path.join("tools", "graftlint_torch_baseline.json")


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="graftlint_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=_ROOT,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE} "
                         "under --root)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run "
                         "(default: all)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object instead of text")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: also fail (exit 1) on stale "
                         "baseline entries")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to cover current "
                         "findings (reasons carry over; new entries "
                         "get a TODO reason to fill in)")
    ap.add_argument("--show-baselined", action="store_true",
                    help="also print grandfathered findings")
    ap.add_argument("--changed", nargs="?", const="HEAD",
                    default=None, metavar="REF",
                    help="report only findings anchored in files "
                         "changed vs REF (default HEAD: working-tree "
                         "diff + untracked).  Every rule still sees "
                         "the whole repo — graph and cross-file rules "
                         "need it — so this scopes the REPORT, not "
                         "the analysis; stale-baseline noise is "
                         "suppressed")
    ap.add_argument("--sarif", default=None, metavar="PATH",
                    help="also write findings as SARIF 2.1.0 to PATH "
                         "(CI uploads it so findings annotate the PR "
                         "diff)")
    return ap.parse_args(argv)


def _changed_paths(root: str, ref: str):
    """Repo-relative paths changed vs ``ref`` plus untracked files;
    None when git is unavailable (caller falls back to a full
    report)."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"],
            cwd=root, capture_output=True, text=True, timeout=30)
        extra = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if diff.returncode != 0:
        return None
    paths = set()
    for out in (diff.stdout, extra.stdout if extra.returncode == 0
                else ""):
        paths.update(p.strip() for p in out.splitlines() if p.strip())
    return paths


def _sarif(findings, rules) -> dict:
    """Minimal SARIF 2.1.0: one run, one result per NEW finding —
    enough for GitHub code-scanning upload to pin findings to diff
    lines."""
    by_id = {r.id: r for r in rules}
    used = sorted({f.rule for f in findings})
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0"
                    ".json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "tools/graftlint_torch.py",
                "rules": [{
                    "id": rid,
                    "shortDescription": {"text": by_id[rid].doc
                                         if rid in by_id else rid},
                } for rid in used],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {"startLine": max(1, f.line)},
                    },
                }],
            } for f in findings],
        }],
    }


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])

    if args.list_rules:
        fam = None
        for r in sorted(lint.all_rules(),
                        key=lambda r: (r.family, r.id)):
            if r.family != fam:
                fam = r.family
                print(f"[{fam}]")
            print(f"  {r.id:28s} {r.doc}")
        print("[no counterpart in the port]")
        for rid, why in sorted(lint.NO_COUNTERPART.items()):
            print(f"  {rid:28s} {why}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = [s.strip() for s in args.rules.split(",")
                    if s.strip()]
        known = {r.id for r in lint.all_rules()}
        bad = sorted(set(rule_ids) - known)
        if bad:
            print(f"graftlint: unknown rule(s): {', '.join(bad)}",
                  file=sys.stderr)
            return 2

    baseline_path = args.baseline or os.path.join(args.root,
                                                  DEFAULT_BASELINE)
    try:
        baseline = lint.load_baseline(baseline_path)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2

    repo = lint.Repo.from_root(args.root)
    changed = None
    if args.changed is not None:
        changed = _changed_paths(args.root, args.changed)
        if changed is not None:
            # graph and cross-file collection passes still see the
            # whole repo; per-module walks and the REPORT are scoped
            # to the diff.  Stale entries are a full-run concern, not
            # a pre-commit one.
            repo.focus_paths = changed
        else:
            print("graftlint: --changed: git diff failed; reporting "
                  "the full repo", file=sys.stderr)
    findings = lint.run_lint(repo, rule_ids)
    new, grandfathered, stale = lint.apply_baseline(findings, baseline)
    if changed is not None:
        stale = []

    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(_sarif(new, lint.all_rules()), fh, indent=2)
            fh.write("\n")

    if args.update_baseline:
        data = lint.baseline_from_findings(findings,
                                           previous=baseline)
        os.makedirs(os.path.dirname(os.path.abspath(baseline_path)),
                    exist_ok=True)
        with open(baseline_path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"graftlint: baseline rewritten with "
              f"{len(data['findings'])} entr"
              f"{'y' if len(data['findings']) == 1 else 'ies'} "
              f"-> {baseline_path}")
        todo = [k for k, v in data["findings"].items()
                if str(v["reason"]).startswith("TODO")]
        if todo:
            print(f"graftlint: {len(todo)} entries need a reason "
                  "before committing:")
            for k in todo:
                print(f"  {k}")
        return 0

    if args.json:
        out = {
            "version": 1,
            "counts": {"new": len(new),
                       "baselined": len(grandfathered),
                       "stale_baseline": len(stale)},
            "findings": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in grandfathered],
            "stale_baseline": stale,
        }
        json.dump(out, sys.stdout, indent=2)
        print()
    else:
        for f in new:
            print(f.render())
        if args.show_baselined:
            for f in grandfathered:
                print(f"{f.render()}  [baselined]")
        for key in stale:
            print(f"stale baseline entry (debt paid — prune with "
                  f"--update-baseline): {key}")
        n, b, s = len(new), len(grandfathered), len(stale)
        print(f"graftlint: {n} finding{'s' if n != 1 else ''}, "
              f"{b} baselined, {s} stale baseline "
              f"entr{'y' if s == 1 else 'ies'}")

    if new:
        return 1
    if args.check and stale:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
