"""DeviceMemoryLedger release-pairing analysis (graph rule).

Every buffer the repo parks on device goes through one choke point —
``memwatch.register(site, nbytes) -> token`` — and the ledger only
stays truthful if every token meets a ``memwatch.release(token)`` on
*every* path out of the owning scope, including the exception and
cancellation-unwind paths.  The leak sentinel (``on_query_complete``)
force-releases what slips through, but each force-release is a bug
report; this rule finds them at lint time.

``resource-release-path`` resolves register/release through the call
graph, so only :class:`DeviceMemoryLedger` methods count —
``inflight.register`` (query registry) and the KernelLedger's
``ledger.register`` share the name and must not match.  For each
register site it requires one of:

* a release reachable with **no may-raise work in between** (any call
  or ``raise`` between register and release can strand the token), or
* a release in a ``finally`` whose ``try`` covers the window, or
* the token **escaping ownership**: returned/yielded to the caller,
  stored into a container/attribute, or handed to another call —
  except a thread handoff (``submit``/``Thread``), which is followed
  one level: the worker must release its token parameter behind a
  ``finally`` (the pipeline's fetch worker is the model).

``obs/memwatch.py`` itself is exempt (the ledger manipulates its own
tokens).  Like every graph rule this under-approximates: an
unresolvable release helper reads as "no release", so suppress with a
reason when ownership genuinely moves somewhere the graph cannot see.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from .core import PACKAGE, Finding, Module, Repo, rule
from .graph import FuncInfo, RepoGraph, body_walk

_LEDGER = f"{PACKAGE}/obs/memwatch.py::DeviceMemoryLedger"
_REGISTER = f"{_LEDGER}.register"
_RELEASE = f"{_LEDGER}.release"
_EXEMPT = f"{PACKAGE}/obs/memwatch.py"


def _assigned_name(m: Module, call: ast.Call) -> Optional[str]:
    """Token variable a register call binds: walks up through
    IfExp/BoolOp to a single-Name Assign.  None when the result is
    discarded or lands somewhere unnameable."""
    cur, parent = call, m.parents.get(call)
    while isinstance(parent, (ast.IfExp, ast.BoolOp)):
        cur, parent = parent, m.parents.get(parent)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
            and isinstance(parent.targets[0], ast.Name):
        return parent.targets[0].id
    return None


def _stored(m: Module, call: ast.Call) -> bool:
    """Register result goes straight into an attribute / subscript /
    return — ownership leaves the scope without a local name."""
    cur, parent = call, m.parents.get(call)
    while isinstance(parent, (ast.IfExp, ast.BoolOp, ast.Tuple,
                              ast.List, ast.Dict)):
        cur, parent = parent, m.parents.get(parent)
    if isinstance(parent, ast.Assign):
        t = parent.targets[0]
        return isinstance(t, (ast.Attribute, ast.Subscript, ast.Tuple))
    return isinstance(parent, (ast.Return, ast.Yield, ast.Call))


def _uses(fi: FuncInfo, name: str,
          after_line: int) -> List[ast.Name]:
    out = []
    for node in body_walk(fi.node):
        if isinstance(node, ast.Name) and node.id == name and \
                isinstance(node.ctx, ast.Load) and \
                node.lineno >= after_line:
            out.append(node)
    return out


def _enclosing_call(m: Module, node: ast.AST) -> Optional[ast.Call]:
    parent = m.parents.get(node)
    while isinstance(parent, (ast.Starred, ast.Tuple, ast.List,
                              ast.IfExp, ast.keyword)):
        parent = m.parents.get(parent)
    if isinstance(parent, ast.Call):
        return parent
    return None


def _escapes(m: Module, use: ast.Name) -> bool:
    """The token leaves the function's ownership through this use."""
    cur = use
    parent = m.parents.get(cur)
    while parent is not None:
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(parent, ast.Assign):
            t = parent.targets[0]
            return isinstance(t, (ast.Attribute, ast.Subscript))
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda, ast.stmt)):
            return False
        cur, parent = parent, m.parents.get(parent)
    return False


def _in_finally(m: Module, node: ast.AST,
                upto: ast.AST) -> Optional[ast.Try]:
    """The Try whose ``finally`` block contains ``node`` (searching up
    to the enclosing function)."""
    cur = node
    parent = m.parents.get(cur)
    while parent is not None and parent is not upto:
        if isinstance(parent, ast.Try) and any(
                _contains(s, cur) for s in parent.finalbody):
            return parent
        cur, parent = parent, m.parents.get(parent)
    return None


def _contains(root: ast.AST, node: ast.AST) -> bool:
    for sub in ast.walk(root):
        if sub is node:
            return True
    return False


def _may_raise_between(fi: FuncInfo, lo: int, hi: int,
                       skip: Tuple[ast.AST, ...]) -> bool:
    """Any call/raise strictly between lines ``lo`` and ``hi`` in the
    function body — work that can unwind past an unprotected token.
    Nodes inside a ``skip`` span (the register/release statements
    themselves, which may be multi-line) don't count."""
    def in_skip(node):
        return any(s.lineno <= node.lineno <=
                   getattr(s, "end_lineno", s.lineno) for s in skip)
    for node in body_walk(fi.node):
        if isinstance(node, (ast.Call, ast.Raise, ast.Assert)) and \
                lo < node.lineno < hi and not in_skip(node):
            return True
    return False


def _conditional(m: Module, release: ast.AST, register: ast.AST,
                 fn_node: ast.AST) -> bool:
    """Release runs under a branch/loop/handler that the register is
    not itself inside — some paths skip it."""
    cur = m.parents.get(release)
    while cur is not None and cur is not fn_node:
        if isinstance(cur, (ast.If, ast.For, ast.While, ast.IfExp,
                            ast.ExceptHandler)) and \
                not _contains(cur, register):
            return True
        cur = m.parents.get(cur)
    return False


def _worker_releases_param(g: RepoGraph, callee: FuncInfo,
                           param: str) -> bool:
    """Thread-handoff follow-up: the worker releases its token param
    behind a ``finally``, or releases it before any may-raise work."""
    m = callee.module
    for node in body_walk(callee.node):
        if not isinstance(node, ast.Call):
            continue
        if g.resolve_call_target(callee, m, node.func) != _RELEASE:
            continue
        if not any(isinstance(a, ast.Name) and a.id == param
                   for a in node.args):
            continue
        if _in_finally(m, node, callee.node) is not None:
            return True
        first = min((n.lineno for n in body_walk(callee.node)
                     if isinstance(n, (ast.Call, ast.Raise))
                     and n is not node), default=node.lineno + 1)
        if node.lineno <= first:
            return True
    return False


def _thread_handoff(g: RepoGraph, fi: FuncInfo, m: Module,
                    use: ast.Name) -> Optional[Tuple[FuncInfo, str]]:
    """(worker FuncInfo, param name) when this use passes the token to
    a thread edge's target; None for ordinary calls."""
    call = _enclosing_call(m, use)
    if call is None:
        return None
    for e in g.edges_from(fi.qname):
        if e.kind != "thread" or e.node is not call:
            continue
        callee = g.functions.get(e.callee)
        if callee is None:
            return None
        for i, a in enumerate(call.args):
            if a is use or (isinstance(a, ast.Name) and
                            _contains(a, use)):
                idx = i - e.arg_offset
                if 0 <= idx < len(callee.params):
                    return callee, callee.params[idx]
        for kw in call.keywords:
            if kw.arg and _contains(kw.value, use):
                return callee, kw.arg
    return None


@rule("resource-release-path", "release",
      "a DeviceMemoryLedger register is not matched by a release on "
      "every path out of its scope (exception/cancel-unwind leaks "
      "device memory until the leak sentinel force-releases it)")
def check_release_path(repo: Repo) -> Iterable[Finding]:
    g = repo.graph()
    for e in g.edges:
        if e.callee != _REGISTER or e.module.path == _EXEMPT:
            continue
        m = e.module
        fi = g.functions.get(e.caller)
        if fi is None:
            continue
        fn = RepoGraph.short(fi.qname)
        tok = _assigned_name(m, e.node)
        if tok is None:
            if _stored(m, e.node):
                continue                  # ownership leaves directly
            yield m.finding(
                "resource-release-path", e.node,
                f"{fn}: memwatch.register result discarded — the "
                "token is unreleasable and the buffer leaks until "
                "the query-complete sentinel")
            continue

        uses = _uses(fi, tok, e.node.lineno)
        releases = []
        handoffs = []
        escaped = False
        for u in uses:
            call = _enclosing_call(m, u)
            if call is not None and g.resolve_call_target(
                    fi, m, call.func) == _RELEASE:
                releases.append(call)
                continue
            h = _thread_handoff(g, fi, m, u)
            if h is not None:
                handoffs.append((u, h))
                continue
            if _escapes(m, u) or call is not None:
                # returned/stored, or handed to a call the graph sees
                # as opaque — ownership transferred
                escaped = True

        if escaped:
            continue
        bad_handoff = None
        for u, (callee, param) in handoffs:
            if not _worker_releases_param(g, callee, param):
                bad_handoff = (u, callee, param)
        if handoffs and bad_handoff is None:
            continue
        if bad_handoff is not None:
            _, callee, param = bad_handoff
            yield m.finding(
                "resource-release-path", e.node,
                f"{fn}: token '{tok}' is handed to thread worker "
                f"{RepoGraph.short(callee.qname)}, which can raise "
                f"before releasing '{param}' — wrap the worker's "
                "body in try/finally around the release")
            continue

        if not releases:
            yield m.finding(
                "resource-release-path", e.node,
                f"{fn}: token '{tok}' from memwatch.register is "
                "never released in this scope and never escapes — "
                "guaranteed ledger leak")
            continue

        protected = False
        for rel in releases:
            t = _in_finally(m, rel, fi.node)
            if t is not None:
                covers = _contains(t, e.node) or (
                    e.node.lineno < t.lineno and not
                    _may_raise_between(fi, e.node.lineno, t.lineno,
                                       skip=(e.node,)))
                if covers:
                    protected = True
                    break
            else:
                if _conditional(m, rel, e.node, fi.node):
                    continue
                if not _may_raise_between(fi, e.node.lineno,
                                          rel.lineno,
                                          skip=(e.node, rel)):
                    protected = True
                    break
        if not protected:
            yield m.finding(
                "resource-release-path", e.node,
                f"{fn}: release of token '{tok}' is not on every "
                "path from its register (work in between can raise, "
                "or the release is conditional) — move the release "
                "into a finally covering the window")
