"""Contract-drift rules: the cross-artifact consistency checks.

Four contracts span code, docs, and tests, and each has drifted (or
will) because nothing enforced it:

* **conf keys** — a ``mosaic.*`` key means nothing unless
  ``config.py`` registers it in ``_CONF_FIELDS`` with a validator, and
  an operator can't use it unless ``docs/usage/*.md`` mentions it;
* **metric names** — the OpenMetrics exporter sanitizes
  ``family/name`` paths into ``mosaic_family_name``; a segment
  with uppercase, leading digits, or stray punctuation silently
  mangles the exported series;
* **recorder events** — dashboards and tests filter
  ``recorder.events(kind)`` by exact string; an event emitted under a
  name the catalogue (``recorder.EVENTS``) doesn't declare is
  invisible debt, and a declared-but-never-emitted name is a dead
  dashboard panel;
* **fault sites** — a ``faults.maybe_fail("x.y")`` probe that no
  chaos test ever arms is untested error handling: exactly the code
  that only runs on the worst day.

All four rules are repo-wide (they read :class:`Repo` docs/tests, not
just one module), which is why rules receive the whole repo.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import PACKAGE, Finding, Module, Repo, dotted, rule

CONFIG_MODULE = f"{PACKAGE}/config.py"
RECORDER_MODULE = f"{PACKAGE}/obs/recorder.py"
FAULTS_MODULE = f"{PACKAGE}/resilience/faults.py"
#: the linter itself (its docstrings and messages name keys and sites)
LINT_PREFIX = f"{PACKAGE}/lint/"

#: a full conf-key literal (dot-separated lowercase words)
_CONF_KEY_RE = re.compile(r"^mosaic\.[a-z][a-z0-9.]*[a-z0-9]$")
#: conf-key tokens inside prose/docs
_CONF_TOKEN_RE = re.compile(r"\bmosaic\.[a-z][a-z0-9.]*[a-z0-9]")
#: one path segment of a metric name (OpenMetrics-sanitizable)
_METRIC_SEG_RE = re.compile(r"^[a-z][a-z0-9_]*$")
#: fault-site pattern inside a FaultPlan spec string in tests
_SITE_PATTERN_RE = re.compile(r"site=([A-Za-z0-9_.*?\[\]]+)")

_FAULT_FNS = {"maybe_fail", "corrupt", "degrade", "stall"}


# --------------------------------------------------- config registry

def _conf_registry(repo: Repo) -> Tuple[Dict[str, int], Optional[str],
                                        Optional[Module]]:
    """(registered key -> defining line, force prefix, config module)
    parsed out of ``config.py``: module-level string constants feeding
    the ``_CONF_FIELDS`` dict keys."""
    m = repo.module(CONFIG_MODULE)
    if m is None or m.tree is None:
        return {}, None, m
    consts: Dict[str, Tuple[str, int]] = {}   # NAME -> (value, line)
    for node in m.tree.body:
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = (node.value.value, node.lineno)
    prefix = consts.get("MOSAIC_PLANNER_FORCE_PREFIX", (None, 0))[0]
    registered: Dict[str, int] = {}
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Dict):
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if "_CONF_FIELDS" not in names:
                continue
            for k in node.value.keys:
                if isinstance(k, ast.Name) and k.id in consts:
                    val, line = consts[k.id]
                    registered[val] = line
                elif isinstance(k, ast.Constant) and \
                        isinstance(k.value, str):
                    registered[k.value] = k.lineno
    return registered, prefix, m


def _key_known(key: str, registered: Dict[str, int],
               prefix: Optional[str]) -> bool:
    if key in registered:
        return True
    if prefix and (key.startswith(prefix) or key == prefix.rstrip(".")):
        return True
    return False


@rule("contract-conf-key", "contract",
      "every mosaic.* conf-key literal in code must be registered in "
      "config.py _CONF_FIELDS (or extend the planner force prefix)")
def check_conf_key(repo: Repo) -> Iterable[Finding]:
    registered, prefix, cfg = _conf_registry(repo)
    if cfg is None:
        return
    for m in repo.focused(repo.all_code_modules()):
        if m.tree is None or m.path == CONFIG_MODULE or \
                m.path.startswith(LINT_PREFIX):
            continue
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    _CONF_KEY_RE.match(node.value):
                if not _key_known(node.value, registered, prefix):
                    yield m.finding(
                        "contract-conf-key", node,
                        f"conf key {node.value!r} is not registered "
                        "in config.py _CONF_FIELDS — apply_conf will "
                        "reject it at runtime")


@rule("contract-conf-docs", "contract",
      "registered conf keys must be documented in docs/, and every "
      "mosaic.* key docs mention must be registered (both directions)")
def check_conf_docs(repo: Repo) -> Iterable[Finding]:
    registered, prefix, cfg = _conf_registry(repo)
    if cfg is None or not repo.doc_files:
        return
    all_docs = "\n".join(text for _, text in repo.doc_files)
    for key, line in sorted(registered.items()):
        if key not in all_docs:
            yield Finding(
                "contract-conf-docs", CONFIG_MODULE, line,
                f"conf key {key!r} is registered but never documented "
                "in docs/ — add it to the configuration reference")
    for path, text in repo.doc_files:
        for i, ln in enumerate(text.splitlines(), start=1):
            for tok in _CONF_TOKEN_RE.findall(ln):
                # "mosaic.raster.*"-style family references are fine
                # as long as the family has at least one real key
                if any(k.startswith(tok + ".") for k in registered):
                    continue
                if not _key_known(tok, registered, prefix):
                    yield Finding(
                        "contract-conf-docs", path, i,
                        f"docs mention conf key {tok!r} which "
                        "config.py does not register — stale docs or "
                        "a typo'd key")


# ------------------------------------------------------- metric names

def _metric_segments(arg: ast.AST) -> Optional[List[str]]:
    """Fully-literal '/'-segments of a metric-name argument; dynamic
    f-string segments come back as None entries (not checkable)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value.split("/")
    if isinstance(arg, ast.JoinedStr):
        DYN = "\x00"
        parts: List[str] = []
        for v in arg.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append(DYN)
        segs = "".join(parts).split("/")
        return [None if DYN in s else s for s in segs]  # type: ignore
    return None


@rule("contract-metric-name", "contract",
      "metric names are '/'-separated lowercase-snake paths "
      "(family/name) — anything else mangles the OpenMetrics export")
def check_metric_name(repo: Repo) -> Iterable[Finding]:
    for m in repo.focused(repo.modules):
        if m.tree is None or m.path.startswith(LINT_PREFIX):
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute) or \
                    node.func.attr not in ("count", "gauge", "observe"):
                continue
            recv = dotted(node.func.value)
            if not recv or recv.split(".")[-1] != "metrics":
                continue
            if not node.args:
                continue
            segs = _metric_segments(node.args[0])
            if segs is None:
                continue
            shown = "/".join("{…}" if s is None else s for s in segs)
            bad = [s for s in segs
                   if s is not None and not _METRIC_SEG_RE.match(s)]
            if bad or len(segs) < 2:
                why = (f"segment(s) {', '.join(map(repr, bad))} not "
                       "lowercase-snake" if bad
                       else "needs a family/ prefix")
                yield m.finding(
                    "contract-metric-name", node,
                    f"metric name {shown!r}: {why} (OpenMetrics "
                    "export sanitizes names; keep "
                    "[a-z][a-z0-9_]* segments)")


# ---------------------------------------------------- recorder events

def _event_catalogue(repo: Repo) -> Tuple[Set[str], int,
                                          Optional[Module]]:
    m = repo.module(RECORDER_MODULE)
    if m is None or m.tree is None:
        return set(), 1, m
    for node in m.tree.body:
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets
                     if isinstance(t, ast.Name)]
            if "EVENTS" not in names:
                continue
            out: Set[str] = set()
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and \
                        isinstance(sub.value, str):
                    out.add(sub.value)
            return out, node.lineno, m
    return set(), 1, m


def _recorded_events(repo: Repo) -> List[Tuple[Module, ast.Call, str]]:
    out = []
    for m in repo.modules:
        if m.tree is None or m.path.startswith(LINT_PREFIX):
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute) or \
                    node.func.attr != "record":
                continue
            recv = dotted(node.func.value)
            is_recorder = recv is not None and (
                recv == "recorder" or recv.endswith(".recorder") or
                (recv == "self" and m.path == RECORDER_MODULE))
            if not is_recorder:
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                out.append((m, node, node.args[0].value))
    return out


@rule("contract-recorder-event", "contract",
      "recorder.record() event names must come from the declared "
      "recorder.EVENTS catalogue, and every catalogue entry must be "
      "emitted somewhere (dashboards filter by exact kind)")
def check_recorder_event(repo: Repo) -> Iterable[Finding]:
    catalogue, cat_line, rec_mod = _event_catalogue(repo)
    if rec_mod is None:
        return
    if not catalogue:
        yield Finding(
            "contract-recorder-event", RECORDER_MODULE, cat_line,
            "no EVENTS catalogue declared — add a module-level "
            "EVENTS = frozenset({...}) naming every event kind")
        return
    used: Set[str] = set()
    for m, node, name in _recorded_events(repo):
        used.add(name)
        if name not in catalogue:
            yield m.finding(
                "contract-recorder-event", node,
                f"recorder event {name!r} is not in the "
                "recorder.EVENTS catalogue — declare it (dashboards "
                "and dumps filter on exact kind strings)")
    for name in sorted(catalogue - used):
        yield Finding(
            "contract-recorder-event", RECORDER_MODULE, cat_line,
            f"EVENTS catalogue entry {name!r} is never emitted by "
            "any recorder.record() call — dead event, drop it or "
            "wire the emitter")


# ---------------------------------------------------- fault coverage

def _test_site_patterns(repo: Repo) -> Set[str]:
    pats: Set[str] = set()
    for _, text in repo.test_files:
        pats.update(_SITE_PATTERN_RE.findall(text))
    return pats


@rule("contract-fault-coverage", "contract",
      "every fault-injection site in code must be armed by at least "
      "one chaos test (a site= pattern in tests/ that matches it)")
def check_fault_coverage(repo: Repo) -> Iterable[Finding]:
    if not repo.test_files:
        return
    patterns = _test_site_patterns(repo)
    for m in repo.focused(repo.modules):
        if m.tree is None or m.path.startswith(LINT_PREFIX) \
                or m.path == FAULTS_MODULE:
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if not d or d.split(".")[-1] not in _FAULT_FNS:
                continue
            if not (node.args and
                    isinstance(node.args[0], ast.Constant) and
                    isinstance(node.args[0].value, str)):
                continue
            site = node.args[0].value
            if any(fnmatch.fnmatchcase(site, p) for p in patterns):
                continue
            yield m.finding(
                "contract-fault-coverage", node,
                f"fault site {site!r} has no chaos-test coverage — "
                "no site= pattern in tests/ matches it, so its "
                "error-handling path never runs under test")
