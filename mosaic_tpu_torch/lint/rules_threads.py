"""Thread-escape analysis (graph rule).

``lock-unguarded-attr`` covers methods of lock-bearing classes, but it
deliberately skips nested defs — and nested defs are exactly what
escapes into other threads: ``threading.Thread(target=...)`` in the
sampler and profiler, ``pool.submit`` in the pipeline, the
``consume=``/``observe=`` worker callbacks handed to
``perf.pipeline.stream``.  This rule follows the graph's *thread
edges* to whatever function actually runs on the spawned thread and
checks its writes:

* mutating an attribute of an object whose class owns a ``_lock``
  (``self.x`` through the enclosing method's class, or a module
  singleton like ``memwatch``/``kernel_cache``) without holding that
  class's lock fires ``thread-escape-unguarded``;
* bound *methods* used as thread targets are skipped here —
  ``lock-unguarded-attr`` already has jurisdiction over every method
  body, on-thread or off.

Reads are out of scope (the repo's convention tolerates racy reads of
monotonic counters), as are attributes in the known thread-safe set
(queues, events).  The check is direct-body only: a mutation two calls
deep fires in *that* function if it is itself a thread target or a
method, which keeps findings anchored where the fix goes.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Set, Tuple

from .core import Finding, Module, Repo, dotted, rule
from .graph import RepoGraph, body_walk
from .rules_locks import _MUTATORS, _SAFE_ATTR_HINTS


def _mutation_targets(node: ast.AST) -> Iterable[Tuple[ast.AST, str]]:
    """(base expression, description) pairs for attribute mutations in
    one statement/expression node: ``X.attr = ..``, ``X.attr += ..``,
    ``del X.attr[..]``, ``X.attr.append(..)``."""
    def attr_base(t):
        while isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, ast.Attribute):
            return t.value, t.attr
        return None, None

    if isinstance(node, ast.Assign):
        for t in node.targets:
            for tt in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                base, attr = attr_base(tt)
                if base is not None:
                    yield base, f".{attr} = ..."
    elif isinstance(node, ast.AugAssign):
        base, attr = attr_base(node.target)
        if base is not None:
            yield base, f".{attr} += ..."
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            base, attr = attr_base(t)
            if base is not None:
                yield base, f".{attr} deleted"
    elif isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            base, attr = attr_base(f.value)
            if base is not None and attr not in _SAFE_ATTR_HINTS:
                yield base, f".{attr}.{f.attr}(...)"


def _attr_name(base: ast.AST, desc: str) -> str:
    return f"{dotted(base) or '<expr>'}{desc.split(' ')[0]}"


def _owner_class(g: RepoGraph, fi, m: Module,
                 base: ast.AST) -> Optional[str]:
    """ClassInfo qname of a lock-bearing owner for ``base`` (the
    receiver of a mutated attribute), else None."""
    d = dotted(base)
    if d is None:
        return None
    head = d.split(".")[0]
    if head == "self":
        cq = g._owning_class(fi)
        ci = g.classes.get(cq) if cq else None
        return cq if ci is not None and ci.lock_kind else None
    r = g.resolve_dotted(fi, m, d) if "." not in d else \
        g.resolve_dotted(fi, m, head)
    if r is None:
        r = g.lookup(m.path, head)
    if r and r[0] == "instance":
        ci = g.classes.get(r[1])
        if ci is not None and ci.lock_kind:
            return r[1]
    return None


def _guarded_by(g: RepoGraph, fi, m: Module, node: ast.AST,
                lock_id: str) -> bool:
    """The mutation sits inside a ``with`` whose context resolves to
    ``lock_id`` (walking up to the thread-target function)."""
    cur = m.parents.get(node)
    while cur is not None and cur is not fi.node:
        if isinstance(cur, ast.With):
            for item in cur.items:
                lk = g.resolve_lock(fi, m, item.context_expr)
                if lk and lk[0] == lock_id:
                    return True
        cur = m.parents.get(cur)
    return False


@rule("thread-escape-unguarded", "thread",
      "a function running on a spawned thread (Thread target, "
      "executor submit, stream worker callback) mutates a "
      "lock-bearing owner's attribute without taking its lock")
def check_thread_escape(repo: Repo) -> Iterable[Finding]:
    g = repo.graph()
    seen: Set[Tuple[str, int]] = set()
    for e in g.thread_edges():
        fi = g.functions.get(e.callee)
        if fi is None:
            continue
        if fi.cls is not None and fi.parent is None and \
                not isinstance(fi.node, ast.Lambda):
            # bound method target: lock-unguarded-attr's jurisdiction
            continue
        m = fi.module
        for node in body_walk(fi.node):
            for base, desc in _mutation_targets(node):
                owner = _owner_class(g, fi, m, base)
                if owner is None:
                    continue
                lock_id = f"{owner}._lock"
                if _guarded_by(g, fi, m, node, lock_id):
                    continue
                key = (fi.qname, node.lineno)
                if key in seen:
                    continue
                seen.add(key)
                fn = RepoGraph.short(fi.qname)
                cls = RepoGraph.short(owner)
                yield m.finding(
                    "thread-escape-unguarded", node,
                    f"{fn} runs on a spawned thread and mutates "
                    f"{_attr_name(base, desc)} ({cls} state) without "
                    f"'with ..._lock' — races the owning thread; take "
                    f"{cls}._lock or route through a locked method")
