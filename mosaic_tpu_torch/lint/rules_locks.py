"""Lock discipline / race detection rules.

The obs plane is a set of process-global singletons (metrics registry,
recorder, InflightRegistry, KernelLedger, SLOMonitor, Planner,
PrincipalMeter, DeviceMemoryLedger) mutated concurrently by query
threads, the pipeline's fetch worker, the Sampler tick, the
HostProfiler, and the dashboard's HTTP handlers.  The codebase's
convention is explicit: a class that owns shared state holds a
``self._lock`` and every mutation runs under it; helpers that a caller
already locks are named ``*_locked``.  Module-level lifecycle state
(the active sampler/profiler, the persistent-cache dir) gets a
module-level ``*_lock``.

Two rules enforce the convention statically:

* ``lock-unguarded-attr`` — in any class whose ``__init__`` takes a
  ``self._lock``, a method that mutates ``self.*`` state (assignment,
  augmented assignment, ``del``, or a mutating container method)
  outside ``with self._lock`` is flagged.  ``__init__`` (no sharing
  yet) and ``*_locked`` helpers (caller holds it) are exempt.
* ``lock-global-state`` — in any module that declares a module-level
  ``threading.Lock``, a function that rebinds a module global
  (``global x`` + assignment) outside a ``with <module lock>`` block
  is flagged.  Modules without a module-level lock are out of scope:
  declaring one is the signal that cross-thread lifecycle mutation
  happens here.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .core import PACKAGE, Finding, Module, Repo, dotted, rule

#: container methods that mutate their receiver
_MUTATORS = {"append", "appendleft", "extend", "insert", "add",
             "remove", "discard", "pop", "popitem", "popleft",
             "clear", "update", "setdefault", "move_to_end",
             "sort", "reverse"}

#: receiver types whose "mutators" are themselves thread-safe or
#: whose methods collide with the list above (threading.Event.set,
#: queue.Queue.put...) — matched on attribute name
_SAFE_ATTR_HINTS = {"_stop", "_event", "_queue"}


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = dotted(node.func)
    return d in ("threading.Lock", "threading.RLock", "Lock", "RLock")


def _class_has_lock(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "_lock" \
                        and dotted(t.value) == "self" \
                        and _is_lock_ctor(node.value):
                    return True
    return False


def _self_attr_of(node: ast.AST) -> Optional[str]:
    """``self.X`` or ``self.X[...]`` (any subscript depth) -> ``X``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and dotted(node.value) == "self":
        return node.attr
    return None


def _under_self_lock(node: ast.AST, m: Module,
                     fn: ast.AST) -> bool:
    cur = m.parents.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, ast.With):
            for item in cur.items:
                if dotted(item.context_expr) == "self._lock":
                    return True
        cur = m.parents.get(cur)
    return False


def _method_mutations(fn: ast.FunctionDef, m: Module
                      ) -> Iterable[tuple]:
    """(node, attr, description) for every self-state mutation in a
    method body (skipping nested function defs — they run later, on
    whatever thread calls them, and usually re-enter a locked API)."""
    def walk(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
                continue
            yield stmt
            for child in ast.iter_child_nodes(stmt):
                yield from walk([child])

    for node in walk(fn.body):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                targets = t.elts if isinstance(
                    t, (ast.Tuple, ast.List)) else [t]
                for tt in targets:
                    attr = _self_attr_of(tt)
                    if attr:
                        yield node, attr, f"self.{attr} = ..."
        elif isinstance(node, ast.AugAssign):
            attr = _self_attr_of(node.target)
            if attr:
                yield node, attr, f"self.{attr} {_op(node.op)}= ..."
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr_of(t)
                if attr:
                    yield node, attr, f"del self.{attr}[...]"
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                attr = _self_attr_of(f.value)
                if attr and attr not in _SAFE_ATTR_HINTS:
                    yield node, attr, f"self.{attr}.{f.attr}(...)"


def _op(op: ast.AST) -> str:
    return {"Add": "+", "Sub": "-", "Mult": "*"}.get(
        type(op).__name__, "?")


@rule("lock-unguarded-attr", "lock",
      "a class holding self._lock mutates shared attributes outside "
      "'with self._lock' (race against sampler/worker/HTTP threads)")
def check_unguarded_attr(repo: Repo) -> Iterable[Finding]:
    for m in repo.focused(repo.modules):
        if not m.path.startswith(f"{PACKAGE}/") or m.tree is None:
            continue
        for cls in ast.walk(m.tree):
            if not isinstance(cls, ast.ClassDef) or \
                    not _class_has_lock(cls):
                continue
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                if fn.name == "__init__" or \
                        fn.name.endswith("_locked"):
                    continue
                for node, attr, desc in _method_mutations(fn, m):
                    if attr == "_lock":
                        continue
                    if _under_self_lock(node, m, fn):
                        continue
                    yield m.finding(
                        "lock-unguarded-attr", node,
                        f"{cls.name}.{fn.name}: {desc} outside "
                        "'with self._lock' — guard it, or rename the "
                        "helper *_locked if every caller holds the "
                        "lock")


def _module_locks(m: Module) -> Set[str]:
    out: Set[str] = set()
    for node in m.tree.body:
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _under_module_lock(node: ast.AST, m: Module, fn: ast.AST,
                       locks: Set[str]) -> bool:
    cur = m.parents.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, ast.With):
            for item in cur.items:
                if dotted(item.context_expr) in locks:
                    return True
        cur = m.parents.get(cur)
    return False


@rule("lock-global-state", "lock",
      "a lock-bearing module rebinds a module global outside "
      "'with <module lock>' (lost updates between conf/env threads)")
def check_global_state(repo: Repo) -> Iterable[Finding]:
    for m in repo.focused(repo.modules):
        if not m.path.startswith(f"{PACKAGE}/") or m.tree is None:
            continue
        locks = _module_locks(m)
        if not locks:
            continue
        for fn in ast.walk(m.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            declared: Set[str] = set()
            for node in fn.body:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Global):
                        declared.update(sub.names)
            declared -= locks
            if not declared:
                continue
            for node in ast.walk(fn):
                names: List[str] = []
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and \
                                t.id in declared:
                            names.append(t.id)
                elif isinstance(node, ast.AugAssign) and \
                        isinstance(node.target, ast.Name) and \
                        node.target.id in declared:
                    names.append(node.target.id)
                for name in names:
                    if _under_module_lock(node, m, fn, locks):
                        continue
                    yield m.finding(
                        "lock-global-state", node,
                        f"{fn.name}: global {name!r} rebound outside "
                        f"{'/'.join(sorted(locks))} — concurrent "
                        "configure calls race (check-then-act on the "
                        "previous value)")
