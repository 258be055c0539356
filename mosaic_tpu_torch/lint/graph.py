"""Whole-repo symbol table + call graph for interprocedural rules.

The per-module visitor contract sees one file at a time; the
bugs the server arc will ship are cross-module by nature — a lock-order
cycle between two singletons lives in neither file alone.  This module
builds, once per lint run, the three indexes the graph rules query:

* a **symbol table** — every module-level function, class, method,
  nested closure and lambda gets a stable qualified name
  (``path::Class.method``, ``path::outer.<locals>.inner``), plus the
  module-level singleton bindings (``memwatch = DeviceMemoryLedger()``)
  and the import graph (relative imports, ``__init__`` re-exports);
* a **call graph** — every call site resolved best-effort through that
  table: ``self.method()``, bare locals/globals, dotted chains through
  imported modules / classes / singleton instances, the builder-by-name
  indirection of ``kernel_cache.get_or_build`` (the fusion pass's
  program cache), and *thread edges* (``threading.Thread(target=...)``,
  ``executor.submit(fn, ...)``, the ``consume=``/``observe=`` worker
  callbacks handed to ``perf.pipeline.stream``);
* a **lock index** — every ``with <lock>`` region mapped to a lock
  identity at class granularity (``path::Class._lock``) or module
  granularity (``path::_lock_name``), with the Lock-vs-RLock kind, and
  the transitive *lock closure* of every function (locks it or any
  callee acquires, thread edges excluded: a spawned thread acquires on
  its own stack, which is an ordering hazard but not a reentrancy one).

Resolution is deliberately static and modest: no dynamic dispatch, no
data-flow through containers, no decorators-that-return-other-functions.
An unresolved call is silently dropped — the rules built on the graph
therefore under-approximate (they miss, they don't invent), which is the
right polarity for a CI gate.  Port of ``mosaic_tpu.lint.graph``, the
same resolution with the same limits (``docs/usage/linting.md``).

The graph is built lazily and cached on the :class:`~.core.Repo`
(``repo.graph()``), so any number of graph rules share one build.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Module, Repo, dotted

__all__ = ["RepoGraph", "FuncInfo", "ClassInfo", "CallEdge",
           "LockSite", "body_walk"]


def body_walk(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body WITHOUT descending into nested function /
    lambda / class definitions — those are separate graph nodes that
    run later, on whoever calls them."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def _is_lock_ctor(node: ast.AST) -> Optional[str]:
    """'Lock' / 'RLock' when ``node`` constructs a threading lock."""
    if not isinstance(node, ast.Call):
        return None
    d = dotted(node.func)
    if d in ("threading.Lock", "Lock"):
        return "Lock"
    if d in ("threading.RLock", "RLock"):
        return "RLock"
    return None


@dataclasses.dataclass
class ClassInfo:
    qname: str                       # path::Name
    name: str
    module: Module
    node: ast.ClassDef
    lock_kind: Optional[str]         # Lock / RLock / None (no _lock)
    methods: Dict[str, str]          # method name -> func qname
    bases: List[str]                 # dotted base names, unresolved

    @property
    def lock_id(self) -> Optional[str]:
        return f"{self.qname}._lock" if self.lock_kind else None


@dataclasses.dataclass
class FuncInfo:
    qname: str                       # path::scope-qualified name
    name: str
    module: Module
    node: ast.AST                    # FunctionDef/AsyncFunctionDef/Lambda
    cls: Optional[str]               # owning ClassInfo qname (methods)
    parent: Optional[str]            # enclosing FuncInfo qname (closures)
    params: List[str] = dataclasses.field(default_factory=list)
    nested: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: With/Call nodes in this function's DIRECT body (nested defs
    #: own their own), collected in the single indexing pass so edge
    #: resolution never re-walks the tree
    interest: List[ast.AST] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CallEdge:
    caller: str                      # FuncInfo qname ("" = module level)
    callee: str                      # FuncInfo qname
    node: ast.Call
    module: Module                   # module holding the call site
    kind: str                        # "call" | "thread"
    #: for thread edges: positional args after the target, so token
    #: arguments map onto the target's parameters (submit(fn, a, b))
    arg_offset: int = 0


@dataclasses.dataclass
class LockSite:
    lock: str                        # lock identity
    kind: str                        # Lock / RLock / "?" (unresolved ctor)
    node: ast.With
    func: str                        # acquiring FuncInfo qname


class RepoGraph:
    """The queryable product: built once from a parsed :class:`Repo`."""

    def __init__(self, repo: Repo):
        self.repo = repo
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        #: per module path: top-level name -> ("func"|"class", qname)
        self._defs: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: per module path: name -> ("module", path) |
        #:                          ("import", target path, remote name)
        self._imports: Dict[str, Dict[str, Tuple]] = {}
        #: per module path: global var -> dotted ctor name (lazy-resolved)
        self._instances_raw: Dict[str, Dict[str, str]] = {}
        #: per module path: module-level lock name -> kind
        self.module_locks: Dict[str, Dict[str, str]] = {}
        #: With/Call nodes in module-level code, per path
        self._module_interest: Dict[str, List[ast.AST]] = {}
        self.edges: List[CallEdge] = []
        self._edges_from: Dict[str, List[CallEdge]] = {}
        self.lock_sites: List[LockSite] = []
        self._lock_sites_by_func: Dict[str, List[LockSite]] = {}
        self._paths = {m.path for m in repo.all_code_modules()}
        self._closure: Optional[Dict[str, Set[str]]] = None

        for m in repo.all_code_modules():
            if m.tree is not None:
                self._index_module(m)
        for m in repo.all_code_modules():
            if m.tree is not None:
                self._resolve_module(m)

    # ------------------------------------------------- symbol table
    def _index_module(self, m: Module) -> None:
        defs: Dict[str, Tuple[str, str]] = {}
        imports: Dict[str, Tuple] = {}
        instances: Dict[str, str] = {}
        locks: Dict[str, str] = {}
        self._defs[m.path] = defs
        self._imports[m.path] = imports
        self._instances_raw[m.path] = instances
        self.module_locks[m.path] = locks

        for node in m.tree.body:
            if isinstance(node, ast.Assign):
                kind = _is_lock_ctor(node.value)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        if kind:
                            locks[t.id] = kind
                        elif isinstance(node.value, ast.Call):
                            ctor = dotted(node.value.func)
                            if ctor:
                                instances[t.id] = ctor
        self._index_scope(m, m.tree, prefix="", cls=None, parent=None,
                          defs=defs)

    def _index_import(self, m: Module, node, imports: Dict) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                path = self._module_file(node=None, base="",
                                         mod=alias.name)
                if path:
                    imports[alias.asname or
                            alias.name.split(".")[0]] = ("module", path)
            return
        # ImportFrom: resolve the source package/module file
        base = m.path.rsplit("/", 1)[0]
        for _ in range(max(0, node.level - 1)):
            base = base.rsplit("/", 1)[0] if "/" in base else ""
        if node.level == 0:
            base = ""
        mod = node.module or ""
        src = self._module_file(node, base, mod)
        for alias in node.names:
            bound = alias.asname or alias.name
            # "from .pkg import sub" where sub is itself a module file
            sub = self._module_file(
                node, src[:-len("/__init__.py")] if src and
                src.endswith("/__init__.py") else (src[:-3] if src
                                                   else None),
                alias.name) if src else None
            if sub:
                imports[bound] = ("module", sub)
            elif src:
                imports[bound] = ("import", src, alias.name)

    def _module_file(self, node, base: Optional[str],
                     mod: str) -> Optional[str]:
        """Repo file for dotted module ``mod`` relative to directory
        ``base`` ('' = repo root); None for external packages."""
        if base is None:
            return None
        rel = mod.replace(".", "/")
        cand = f"{base}/{rel}" if base and rel else (base or rel)
        cand = cand.strip("/")
        if f"{cand}.py" in self._paths:
            return f"{cand}.py"
        if f"{cand}/__init__.py" in self._paths:
            return f"{cand}/__init__.py"
        return None

    def _index_scope(self, m: Module, root: ast.AST, prefix: str,
                     cls: Optional[str], parent: Optional[str],
                     defs: Optional[Dict] = None) -> None:
        # Single traversal of the module: scope indexing, import scan
        # and With/Call collection all happen here, so resolution never
        # walks the tree again.  Iterative with an explicit stack — the
        # recursive version dominated the build profile.  Children are
        # pushed reversed so pop order stays lexical (pre-order DFS).
        imports = self._imports[m.path]
        mod_interest = self._module_interest.setdefault(m.path, [])
        stack = [(root, prefix, cls, parent, defs, None)]
        while stack:
            node, prefix, cls, parent, defs, owner = stack.pop()
            sink = owner.interest if owner is not None else mod_interest
            push = []
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    local = f"{prefix}{child.name}"
                    qname = f"{m.path}::{local}"
                    lock_kind = None
                    for sub in ast.walk(child):
                        if isinstance(sub, ast.Assign):
                            k = _is_lock_ctor(sub.value)
                            if k:
                                for t in sub.targets:
                                    if isinstance(t, ast.Attribute) and \
                                            t.attr == "_lock" and \
                                            dotted(t.value) == "self":
                                        lock_kind = k
                    ci = ClassInfo(qname, child.name, m, child,
                                   lock_kind, {},
                                   [dotted(b) or "" for b in
                                    child.bases])
                    self.classes[qname] = ci
                    if defs is not None and not prefix:
                        defs[child.name] = ("class", qname)
                    push.append((child, f"{local}.", qname, parent,
                                 None, owner))
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    local = f"{prefix}{child.name}"
                    qname = f"{m.path}::{local}"
                    fi = FuncInfo(qname, child.name, m, child, cls,
                                  parent,
                                  params=[a.arg for a in
                                          child.args.args +
                                          child.args.posonlyargs +
                                          child.args.kwonlyargs])
                    self.functions[qname] = fi
                    if cls is not None and parent is None:
                        self.classes[cls].methods[child.name] = qname
                    if defs is not None and not prefix:
                        defs[child.name] = ("func", qname)
                    if parent is not None:
                        self.functions[parent].nested[child.name] = \
                            qname
                    push.append((child, f"{local}.<locals>.",
                                 None if cls is None or parent
                                 else cls, qname, None, fi))
                elif isinstance(child, ast.Lambda):
                    # lambdas get positional names; only the ones
                    # reachable by position (get_or_build args, Thread
                    # target) are ever resolved to, via _lambda_qname
                    self._register_lambda(m, child, prefix, cls, parent)
                    lq = self._lambda_qname(m, child)
                    push.append((child, self._lambda_prefix(m, child),
                                 cls, lq, None, self.functions[lq]))
                else:
                    if isinstance(child, (ast.Import, ast.ImportFrom)):
                        # imports anywhere in the file: the repo's
                        # lazy-import idiom binds names inside
                        # functions, but for resolution purposes a flat
                        # per-module namespace is the right
                        # approximation
                        self._index_import(m, child, imports)
                    elif isinstance(child, (ast.With, ast.Call)):
                        sink.append(child)
                    push.append((child, prefix, cls, parent,
                                 defs if isinstance(node, ast.Module)
                                 else None, owner))
            stack.extend(reversed(push))

    def _lambda_qname(self, m: Module, node: ast.Lambda) -> str:
        return f"{m.path}::<lambda:{node.lineno}:{node.col_offset}>"

    def _lambda_prefix(self, m: Module, node: ast.Lambda) -> str:
        return f"<lambda:{node.lineno}:{node.col_offset}>.<locals>."

    def _register_lambda(self, m: Module, node: ast.Lambda, prefix,
                         cls, parent) -> None:
        qname = self._lambda_qname(m, node)
        if qname not in self.functions:
            self.functions[qname] = FuncInfo(
                qname, "<lambda>", m, node,
                cls if parent else None, parent,
                params=[a.arg for a in node.args.args])

    # ---------------------------------------------- name resolution
    def lookup(self, mpath: str, name: str,
               _depth: int = 0) -> Optional[Tuple[str, str]]:
        """Resolve a bare name in ``mpath``'s module scope to
        ("func"|"class"|"instance"|"module", qname/path).  Instances
        resolve to their class qname.  Follows imports (and one-hop
        ``__init__`` re-exports) with a depth guard."""
        if _depth > 8:
            return None
        d = self._defs.get(mpath, {})
        if name in d:
            return d[name]
        inst = self._instances_raw.get(mpath, {}).get(name)
        if inst is not None:
            ci = self._resolve_class_name(mpath, inst, _depth + 1)
            if ci is not None:
                return ("instance", ci)
        imp = self._imports.get(mpath, {}).get(name)
        if imp is not None:
            if imp[0] == "module":
                return ("module", imp[1])
            return self.lookup(imp[1], imp[2], _depth + 1)
        return None

    def _resolve_class_name(self, mpath: str, dotted_name: str,
                            _depth: int = 0) -> Optional[str]:
        parts = dotted_name.split(".")
        cur = self.lookup(mpath, parts[0], _depth)
        for seg in parts[1:]:
            if cur is None:
                return None
            if cur[0] == "module":
                cur = self.lookup(cur[1], seg, _depth + 1)
            else:
                return None
        if cur and cur[0] == "class":
            return cur[1]
        return None

    def resolve_dotted(self, fi: Optional[FuncInfo], m: Module,
                       name: str) -> Optional[Tuple[str, str]]:
        """Resolve dotted ``name`` at a call site inside ``fi`` (None =
        module level) to ("func"|"class"|"instance"|"module", id)."""
        parts = name.split(".")
        head = parts[0]
        cur: Optional[Tuple[str, str]] = None
        if head == "self" and fi is not None:
            ci = self._owning_class(fi)
            if ci is None or len(parts) != 2:
                return None
            meth = self._class_method(ci, parts[1])
            return ("func", meth) if meth else None
        # enclosing-scope locals: nested defs of this and outer fns
        scope = fi
        while scope is not None and cur is None:
            q = scope.nested.get(head)
            if q:
                cur = ("func", q)
            scope = self.functions.get(scope.parent) \
                if scope.parent else None
        if cur is None:
            cur = self.lookup(m.path, head)
        for seg in parts[1:]:
            if cur is None:
                return None
            kind, ident = cur
            if kind == "module":
                cur = self.lookup(ident, seg)
            elif kind in ("class", "instance"):
                meth = self._class_method(ident, seg)
                cur = ("func", meth) if meth else None
            else:
                return None
        return cur

    def resolve_call_target(self, fi: Optional[FuncInfo], m: Module,
                            expr: ast.AST) -> Optional[str]:
        """FuncInfo qname a call/target expression lands in, or None.
        A class resolves to its ``__init__`` (constructor body runs)."""
        if isinstance(expr, ast.Lambda):
            self._register_lambda(m, expr, "", None,
                                  fi.qname if fi else None)
            return self._lambda_qname(m, expr)
        d = dotted(expr)
        if not d:
            return None
        r = self.resolve_dotted(fi, m, d)
        if r is None:
            return None
        kind, ident = r
        if kind == "func":
            return ident if ident in self.functions else None
        if kind == "class":
            init = self._class_method(ident, "__init__")
            return init
        return None

    def _owning_class(self, fi: FuncInfo) -> Optional[str]:
        cur: Optional[FuncInfo] = fi
        while cur is not None:
            if cur.cls is not None:
                return cur.cls
            cur = self.functions.get(cur.parent) if cur.parent else None
        return None

    def _class_method(self, class_qname: str,
                      name: str) -> Optional[str]:
        """Method lookup including repo-resolvable base classes."""
        seen: Set[str] = set()
        stack = [class_qname]
        while stack:
            cq = stack.pop()
            if cq in seen:
                continue
            seen.add(cq)
            ci = self.classes.get(cq)
            if ci is None:
                continue
            if name in ci.methods:
                return ci.methods[name]
            for b in ci.bases:
                if b:
                    bq = self._resolve_class_name(ci.module.path, b)
                    if bq:
                        stack.append(bq)
        return None

    # ------------------------------------------------- lock identity
    def resolve_lock(self, fi: Optional[FuncInfo], m: Module,
                     expr: ast.AST) -> Optional[Tuple[str, str]]:
        """(lock id, kind) for a ``with`` context expression, or None
        when it isn't a recognizable lock."""
        d = dotted(expr)
        if not d:
            return None
        parts = d.split(".")
        if parts[-1] == "_lock" and len(parts) == 2:
            holder = parts[0]
            if holder == "self" and fi is not None:
                cq = self._owning_class(fi)
                ci = self.classes.get(cq) if cq else None
                if ci is not None:
                    # 'with self._lock' in a class whose ctor we never
                    # saw still names a real lock — kind unknown
                    return (f"{cq}._lock", ci.lock_kind or "?")
                return None
            r = self.resolve_dotted(fi, m, holder)
            if r and r[0] == "instance":
                ci = self.classes.get(r[1])
                if ci is not None:
                    return (f"{r[1]}._lock", ci.lock_kind or "?")
            return None
        if len(parts) == 1:
            kind = self.module_locks.get(m.path, {}).get(d)
            if kind:
                return (f"{m.path}::{d}", kind)
            # imported module lock: from .x import _lock
            imp = self._imports.get(m.path, {}).get(d)
            if imp and imp[0] == "import":
                kind = self.module_locks.get(imp[1], {}).get(imp[2])
                if kind:
                    return (f"{imp[1]}::{imp[2]}", kind)
            return None
        if len(parts) == 2:
            # modname._some_lock through an imported module
            r = self.lookup(m.path, parts[0])
            if r and r[0] == "module":
                kind = self.module_locks.get(r[1], {}).get(parts[1])
                if kind:
                    return (f"{r[1]}::{parts[1]}", kind)
        return None

    # --------------------------------------------------- edge build
    #: keyword callbacks of perf.pipeline.stream that run on the fetch
    #: worker thread (put= runs on the dispatching thread)
    STREAM_WORKER_KWARGS = ("consume", "observe")

    def _resolve_module(self, m: Module) -> None:
        # map every function's calls; module-level code gets caller ""
        for qname, fi in list(self.functions.items()):
            if fi.module is not m:
                continue
            self._resolve_calls(fi, m)
        self._resolve_calls(None, m)     # module-level statements

    def _resolve_calls(self, fi: Optional[FuncInfo],
                       m: Module) -> None:
        caller = fi.qname if fi else ""
        it = fi.interest if fi else self._module_interest.get(
            m.path, [])
        for node in it:
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = self.resolve_lock(fi, m, item.context_expr)
                    if lk:
                        site = LockSite(lk[0], lk[1], node, caller)
                        self.lock_sites.append(site)
                        self._lock_sites_by_func.setdefault(
                            caller, []).append(site)
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            # thread edges -------------------------------------------
            if d and d.split(".")[-1] in ("Thread", "Timer"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        t = self.resolve_call_target(fi, m, kw.value)
                        if t:
                            self._add_edge(caller, t, node, m,
                                           "thread", arg_offset=0)
            elif d and d.split(".")[-1] == "submit" and node.args:
                t = self.resolve_call_target(fi, m, node.args[0])
                if t:
                    self._add_edge(caller, t, node, m, "thread",
                                   arg_offset=1)
            elif d and d.split(".")[-1] == "stream":
                for kw in node.keywords:
                    if kw.arg in self.STREAM_WORKER_KWARGS:
                        t = self.resolve_call_target(fi, m, kw.value)
                        if t:
                            self._add_edge(caller, t, node, m,
                                           "thread", arg_offset=0)
            # builder-by-name through the jit-cache choke point ------
            if d and d.split(".")[-1] == "get_or_build":
                for arg in list(node.args[2:]) + \
                        [kw.value for kw in node.keywords
                         if kw.arg == "build"]:
                    t = self.resolve_call_target(fi, m, arg)
                    if t:
                        self._add_edge(caller, t, node, m, "call")
            # the plain call edge ------------------------------------
            t = self.resolve_call_target(fi, m, node.func)
            if t:
                self._add_edge(caller, t, node, m, "call")

    def _add_edge(self, caller: str, callee: str, node: ast.Call,
                  m: Module, kind: str, arg_offset: int = 0) -> None:
        e = CallEdge(caller, callee, node, m, kind, arg_offset)
        self.edges.append(e)
        self._edges_from.setdefault(caller, []).append(e)

    # ------------------------------------------------------- queries
    def edges_from(self, qname: str) -> List[CallEdge]:
        return self._edges_from.get(qname, [])

    def thread_edges(self) -> List[CallEdge]:
        return [e for e in self.edges if e.kind == "thread"]

    def lock_sites_in(self, qname: str) -> List[LockSite]:
        return self._lock_sites_by_func.get(qname, [])

    def direct_locks(self, qname: str) -> Set[str]:
        return {s.lock for s in self.lock_sites_in(qname)}

    def lock_closure(self) -> Dict[str, Set[str]]:
        """func qname -> every lock it or a transitive callee acquires
        on the caller's own stack ("call" edges only).  Fixpoint over
        the (possibly cyclic) call graph."""
        if self._closure is not None:
            return self._closure
        clo: Dict[str, Set[str]] = {q: set(self.direct_locks(q))
                                    for q in self.functions}
        clo.setdefault("", set())
        call_edges: Dict[str, List[str]] = {}
        for e in self.edges:
            if e.kind == "call":
                call_edges.setdefault(e.caller, []).append(e.callee)
        changed = True
        while changed:
            changed = False
            for q, outs in call_edges.items():
                mine = clo.setdefault(q, set())
                before = len(mine)
                for callee in outs:
                    mine |= clo.get(callee, set())
                if len(mine) != before:
                    changed = True
        self._closure = clo
        return clo

    def call_chain(self, start: str, want_lock: str,
                   limit: int = 12) -> List[str]:
        """A shortest 'call' path from ``start`` to a function that
        DIRECTLY acquires ``want_lock`` — the human-readable evidence
        attached to lock findings.  Empty when unreachable."""
        clo = self.lock_closure()
        from collections import deque
        prev: Dict[str, Optional[str]] = {start: None}
        dq = deque([start])
        goal = None
        while dq:
            cur = dq.popleft()
            if want_lock in self.direct_locks(cur):
                goal = cur
                break
            if len(prev) > 4096:
                break
            for e in self._edges_from.get(cur, []):
                if e.kind != "call" or e.callee in prev:
                    continue
                if want_lock not in clo.get(e.callee, set()):
                    continue
                prev[e.callee] = cur
                dq.append(e.callee)
        if goal is None:
            return []
        path = []
        cur: Optional[str] = goal
        while cur is not None and len(path) < limit:
            path.append(cur)
            cur = prev[cur]
        return list(reversed(path))

    # pretty names for findings: drop the path for same-module symbols
    @staticmethod
    def short(qname: str) -> str:
        return qname.split("::", 1)[-1] if "::" in qname else qname
