"""graftlint framework: modules, rule registry, suppressions, baseline.

Port of ``mosaic_tpu.lint.core``, pointed at ``mosaic_tpu_torch/``, its
end-to-end script ``chip_smoke.py``, ``tools/*_torch.py`` and the port's tests.

Everything here is deliberately boring stdlib: ``ast`` for code,
``re`` for comments and docs, JSON for the baseline.  Rules are plain
functions registered with :func:`rule`; each receives the whole
:class:`Repo` (cross-file contracts need repo-wide visibility) and
yields :class:`Finding` records.

Suppression and baseline are the two escape hatches, with different
jobs:

* an inline ``# graftlint: ignore[rule-id] — reason`` marks a line the
  rule is *wrong or over-strict* about, forever, with the reason in
  the code where reviewers see it;
* a baseline entry grandfathers a *real but accepted* finding (debt),
  with a reason in ``tools/graftlint_torch_baseline.json`` — new code can't
  add to it, and deleting the debt makes the entry stale (reported,
  so the baseline shrinks monotonically).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Finding", "Module", "Repo", "Rule", "RULES", "rule",
           "all_rules", "run_lint", "load_baseline", "apply_baseline",
           "baseline_from_findings", "dotted", "add_parents",
           "enclosing", "under_with"]

# --------------------------------------------------------- findings

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore\[([A-Za-z0-9_*,\- ]+)\]")
_SKIP_FILE_RE = re.compile(r"#\s*graftlint:\s*skip-file")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit.  ``key`` deliberately excludes the line number so
    baselined findings survive unrelated edits above them; two
    identical findings in one file share a key and are baselined by
    count."""

    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path,
                "line": self.line, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ----------------------------------------------------------- modules

class Module:
    """One parsed python file: source, AST, per-line suppressions."""

    def __init__(self, path: str, text: str):
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.error: Optional[str] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(text)
        except SyntaxError as e:
            self.tree = None
            self.error = f"syntax error: {e.msg} (line {e.lineno})"
        self.skip_file = bool(_SKIP_FILE_RE.search(text))
        #: line -> set of suppressed rule ids ("*" = all)
        self.suppressions: Dict[int, set] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(ln)
            if m:
                ids = {s.strip() for s in m.group(1).split(",")
                       if s.strip()}
                self.suppressions[i] = ids
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def suppressed(self, line: int, rule_id: str) -> bool:
        """A finding on ``line`` is suppressed by a marker on the same
        line or on the line directly above (comment-above style)."""
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln)
            if ids and (rule_id in ids or "*" in ids):
                return True
        return False

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = add_parents(self.tree) if self.tree else {}
        return self._parents

    def finding(self, rule_id: str, node_or_line, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(rule_id, self.path, int(line), message)


# --------------------------------------------------------- ast utils

def add_parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def dotted(node: Optional[ast.AST]) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def enclosing(node: ast.AST, parents: Dict[ast.AST, ast.AST],
              kinds: tuple) -> Iterable[ast.AST]:
    """Ancestors of ``node`` (inner-first) that are instances of
    ``kinds``."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, kinds):
            yield cur
        cur = parents.get(cur)


def under_with(node: ast.AST, parents: Dict[ast.AST, ast.AST],
               ctx_names: Iterable[str],
               stop_at: Optional[ast.AST] = None) -> bool:
    """True when ``node`` sits inside a ``with`` whose context
    expression's dotted name is in ``ctx_names`` (walking up at most
    to ``stop_at``, typically the enclosing function)."""
    names = set(ctx_names)
    cur = parents.get(node)
    while cur is not None and cur is not stop_at:
        if isinstance(cur, ast.With):
            for item in cur.items:
                d = dotted(item.context_expr)
                if d in names:
                    return True
        cur = parents.get(cur)
    return False


# -------------------------------------------------------------- repo

#: the package the rules hold to their contracts
PACKAGE = "mosaic_tpu_torch"
#: code the AST rules walk (repo-relative prefixes / files): the port's
#: package and its end-to-end script
CODE_ROOTS = (PACKAGE,)
CODE_FILES = ("chip_smoke.py",)
#: the port's tools only: ``tools/*_torch.py``
TOOL_ROOT = "tools"
TOOL_SUFFIX = "_torch.py"
#: the port's tests only (``site=`` patterns): a JAX chaos test arms the
#: JAX package's fault site, not the port's
TEST_ROOTS = ("tests",)
TEST_PREFIXES = ("test_torch_", "torch_")
DOC_GLOB_DIRS = ("docs", "docs/usage", "docs/api")


def _walk_py(root_dir: str, rel: str) -> List[str]:
    out = []
    base = os.path.join(root_dir, rel)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames
                       if not d.startswith((".", "__pycache__"))]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.relpath(
                    os.path.join(dirpath, fn), root_dir))
    return sorted(out)


class Repo:
    """The lint subject: parsed code modules + raw test/doc text.

    Built either from a checkout root (:meth:`from_root`) or from
    in-memory sources (:meth:`from_sources`, the test path) — rules
    never touch the filesystem themselves."""

    def __init__(self):
        self.modules: List[Module] = []        # package + chip_smoke.py
        self.tool_modules: List[Module] = []   # tools/*_torch.py
        self.test_files: List[Tuple[str, str]] = []   # (path, text)
        self.doc_files: List[Tuple[str, str]] = []    # (path, text)
        self._graph = None                     # memoized RepoGraph
        #: when set (--changed), findings are only reported for these
        #: paths, and per-module rules skip walking everything else
        self.focus_paths: Optional[set] = None

    # -- construction
    @classmethod
    def from_root(cls, root: str) -> "Repo":
        repo = cls()
        paths: List[str] = []
        for r in CODE_ROOTS:
            if os.path.isdir(os.path.join(root, r)):
                paths.extend(_walk_py(root, r))
        for f in CODE_FILES:
            if os.path.isfile(os.path.join(root, f)):
                paths.append(f)
        for p in paths:
            repo.modules.append(cls._read_module(root, p))
        if os.path.isdir(os.path.join(root, TOOL_ROOT)):
            for p in _walk_py(root, TOOL_ROOT):
                if os.path.basename(p).endswith(TOOL_SUFFIX):
                    repo.tool_modules.append(cls._read_module(root, p))
        for r in TEST_ROOTS:
            if os.path.isdir(os.path.join(root, r)):
                for p in _walk_py(root, r):
                    if not os.path.basename(p).startswith(TEST_PREFIXES):
                        continue
                    with open(os.path.join(root, p),
                              encoding="utf-8") as fh:
                        repo.test_files.append(
                            (p.replace(os.sep, "/"), fh.read()))
        for d in DOC_GLOB_DIRS:
            dd = os.path.join(root, d)
            if not os.path.isdir(dd):
                continue
            for fn in sorted(os.listdir(dd)):
                if fn.endswith(".md"):
                    p = os.path.join(d, fn)
                    with open(os.path.join(root, p),
                              encoding="utf-8") as fh:
                        repo.doc_files.append(
                            (p.replace(os.sep, "/"), fh.read()))
        return repo

    @staticmethod
    def _read_module(root: str, rel: str) -> Module:
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            return Module(rel, fh.read())

    @classmethod
    def from_sources(cls, code: Optional[Dict[str, str]] = None,
                     tools: Optional[Dict[str, str]] = None,
                     tests: Optional[Dict[str, str]] = None,
                     docs: Optional[Dict[str, str]] = None) -> "Repo":
        repo = cls()
        for p, t in sorted((code or {}).items()):
            repo.modules.append(Module(p, t))
        for p, t in sorted((tools or {}).items()):
            repo.tool_modules.append(Module(p, t))
        repo.test_files = sorted((tests or {}).items())
        repo.doc_files = sorted((docs or {}).items())
        return repo

    # -- lookups rules share
    def all_code_modules(self) -> List[Module]:
        return self.modules + self.tool_modules

    def module(self, path: str) -> Optional[Module]:
        for m in self.all_code_modules():
            if m.path == path:
                return m
        return None

    def graph(self):
        """The whole-repo symbol table / call graph (:mod:`.graph`),
        built on first use and shared by every graph rule in the run.
        Lazy import: graph.py imports from core.py.  Never focused —
        graph rules must always see the whole repo."""
        if self._graph is None:
            from .graph import RepoGraph
            self._graph = RepoGraph(self)
        return self._graph

    def focused(self, mods: List[Module]) -> List[Module]:
        """Filter an ANCHOR iteration down to the focus set.  Use for
        the outer loop a rule emits findings from; collection passes
        (builder names, conf registry, event catalogue, the graph)
        must keep scanning everything, or focused runs would lose the
        cross-file context and invent findings."""
        if self.focus_paths is None:
            return mods
        return [m for m in mods if m.path in self.focus_paths]


# ------------------------------------------------------ rule registry

@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    family: str
    doc: str
    check: Callable[[Repo], Iterable[Finding]]


RULES: List[Rule] = []


def rule(rule_id: str, family: str, doc: str):
    """Register a checker.  ``doc`` is the one-line catalogue entry
    (``--list-rules`` shows it)."""
    def deco(fn: Callable[[Repo], Iterable[Finding]]):
        RULES.append(Rule(rule_id, family, doc.strip(), fn))
        return fn
    return deco


def all_rules() -> List[Rule]:
    return list(RULES)


# ------------------------------------------------------------ runner

def run_lint(repo: Repo,
             rule_ids: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run (selected) rules over ``repo``; returns findings with
    inline suppressions already applied, sorted by (path, line).
    Unparseable files surface as ``parse-error`` findings rather than
    aborting the run."""
    wanted = set(rule_ids) if rule_ids is not None else None
    findings: List[Finding] = []
    by_path = {m.path: m for m in repo.all_code_modules()}
    for m in repo.all_code_modules():
        if m.error and not m.skip_file:
            findings.append(Finding("parse-error", m.path, 1, m.error))
    for r in RULES:
        if wanted is not None and r.id not in wanted:
            continue
        for f in r.check(repo):
            mod = by_path.get(f.path)
            if mod is not None and (mod.skip_file or
                                    mod.suppressed(f.line, f.rule)):
                continue
            findings.append(f)
    if repo.focus_paths is not None:
        # graph rules (and any rule not routed through focused())
        # report repo-wide; a focused run keeps only findings anchored
        # in the focus set
        findings = [f for f in findings if f.path in repo.focus_paths]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


# ---------------------------------------------------------- baseline

BASELINE_VERSION = 1


def load_baseline(path: str) -> Dict[str, Dict[str, object]]:
    """``{finding key: {"count": n, "reason": str}}`` from the
    committed JSON; empty on a missing file, raises on a corrupt or
    wrong-version one (a broken baseline must fail loudly in CI, not
    silently pass everything)."""
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or \
            data.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: not a graftlint baseline "
                         f"(want version={BASELINE_VERSION})")
    out: Dict[str, Dict[str, object]] = {}
    for key, ent in (data.get("findings") or {}).items():
        out[key] = {"count": int(ent.get("count", 1)),
                    "reason": str(ent.get("reason", ""))}
    return out


def apply_baseline(findings: List[Finding],
                   baseline: Dict[str, Dict[str, object]]
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (new, baselined) and report stale baseline
    keys (entries no current finding consumes — debt that got paid;
    prune them with ``--update-baseline``)."""
    budget = {k: int(v.get("count", 1)) for k, v in baseline.items()}
    new: List[Finding] = []
    grandfathered: List[Finding] = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            grandfathered.append(f)
        else:
            new.append(f)
    stale = sorted(k for k, n in budget.items() if n > 0
                   and n == int(baseline[k].get("count", 1)))
    return new, grandfathered, stale


def baseline_from_findings(findings: List[Finding],
                           reasons: Optional[Dict[str, str]] = None,
                           previous: Optional[Dict[str, Dict[str, object]]]
                           = None) -> Dict[str, object]:
    """A serializable baseline covering ``findings``.  Reasons carry
    over from ``previous`` (or ``reasons``); new keys get a TODO
    reason the author must fill in before committing."""
    ents: Dict[str, Dict[str, object]] = {}
    for f in findings:
        ent = ents.setdefault(f.key, {"count": 0, "reason": ""})
        ent["count"] += 1
    for key, ent in ents.items():
        if reasons and key in reasons:
            ent["reason"] = reasons[key]
        elif previous and key in previous:
            ent["reason"] = previous[key].get("reason", "")
        if not ent["reason"]:
            ent["reason"] = "TODO: justify or fix"
    return {"version": BASELINE_VERSION,
            "findings": {k: ents[k] for k in sorted(ents)}}
