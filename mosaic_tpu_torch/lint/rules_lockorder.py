"""Interprocedural lock-order analysis (graph rules).

The obs/perf/serve planes hold twenty-odd locks and the per-module rules prove each one
guards its own state — but a deadlock needs *two* locks taken in
opposite orders on two threads, which no single module shows.  This
family runs on :meth:`Repo.graph`:

* ``lock-order-cycle`` — for every ``with <lock>`` region, the set of
  *other* locks reachable through the calls made while holding it
  (transitively, ``call`` edges only) defines the lock-order digraph
  ``A -> B`` ("A is held while B is acquired").  Any edge on a cycle
  is flagged, one finding per edge, with the call chain as evidence.
  Fix by hoisting the inner acquisition out of the outer region or by
  agreeing a global order; suppress only with a reason stating why the
  two regions can never interleave.
* ``lock-reentrant-call`` — a non-reentrant ``threading.Lock`` held
  while calling a function whose transitive callees re-acquire the
  *same* lock: self-deadlock on the caller's own stack.  ``RLock``
  owners are exempt by construction.

Both under-approximate: calls the graph cannot resolve (dynamic
dispatch, callbacks through containers) contribute no edges, so a
clean report is evidence, not proof — see "Interprocedural rules" in
``docs/usage/linting.md``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from .core import Finding, Repo, rule
from .graph import CallEdge, LockSite, RepoGraph


def _short_lock(lock: str) -> str:
    """Readable lock name for messages: drop directory prefixes but
    keep enough to be unambiguous ('memwatch.py::DeviceMemoryLedger
    ._lock' -> 'DeviceMemoryLedger._lock', module locks keep the
    file)."""
    path, _, rest = lock.partition("::")
    if rest.endswith("._lock"):
        return rest
    return f"{path.rsplit('/', 1)[-1]}::{rest}"


def _span_contains(outer: ast.AST, inner: ast.AST) -> bool:
    o0 = getattr(outer, "lineno", 0)
    o1 = getattr(outer, "end_lineno", o0)
    i0 = getattr(inner, "lineno", 0)
    return o0 <= i0 <= o1 and inner is not outer


def _calls_in_site(g: RepoGraph, site: LockSite) -> List[CallEdge]:
    return [e for e in g.edges_from(site.func)
            if e.kind == "call" and _span_contains(site.node, e.node)]


def _held_acquisitions(g: RepoGraph) -> Iterable[Tuple[
        LockSite, str, CallEdge, List[str]]]:
    """(outer site, inner lock, evidence edge, chain) for every lock
    acquired — lexically or through calls — while another is held."""
    clo = g.lock_closure()
    for site in g.lock_sites:
        # lexically nested 'with' in the same function
        for inner in g.lock_sites_in(site.func):
            if _span_contains(site.node, inner.node):
                yield site, inner.lock, None, []
        # through calls made inside the region
        for e in _calls_in_site(g, site):
            for lk in clo.get(e.callee, set()):
                chain = g.call_chain(e.callee, lk)
                yield site, lk, e, chain


@rule("lock-order-cycle", "lockorder",
      "two lock regions acquire the same pair of locks in opposite "
      "orders (whole-repo call graph; deadlock under thread "
      "interleaving)")
def check_lock_order(repo: Repo) -> Iterable[Finding]:
    g = repo.graph()
    # digraph: held -> acquired, with per-edge evidence
    edges: Dict[Tuple[str, str], List[Tuple[LockSite, CallEdge,
                                            List[str]]]] = {}
    for site, inner, e, chain in _held_acquisitions(g):
        if inner == site.lock:
            continue                      # reentrancy rule's job
        edges.setdefault((site.lock, inner), []).append(
            (site, e, chain))
    adj: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)

    def reaches(src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(adj.get(cur, ()))
        return False

    for (a, b), evidence in sorted(edges.items()):
        if not reaches(b, a):
            continue                      # edge not on any cycle
        for site, e, chain in evidence:
            anchor = e.node if e is not None else site.node
            m = e.module if e is not None else \
                g.functions[site.func].module if site.func else None
            if m is None:
                continue
            via = ""
            if chain:
                via = " via " + " -> ".join(
                    RepoGraph.short(q) for q in chain)
            fn = RepoGraph.short(site.func) if site.func \
                else "<module>"
            yield m.finding(
                "lock-order-cycle", anchor,
                f"{fn}: acquires {_short_lock(b)} while holding "
                f"{_short_lock(a)}{via} — the reverse order exists "
                "elsewhere in the repo (deadlock window); pick one "
                "global order or drop the nesting")


@rule("lock-reentrant-call", "lockorder",
      "a non-reentrant Lock is re-acquired through a callee while "
      "already held (self-deadlock on the caller's own stack)")
def check_reentrant(repo: Repo) -> Iterable[Finding]:
    g = repo.graph()
    clo = g.lock_closure()
    for site in g.lock_sites:
        if site.kind != "Lock":
            continue                      # RLock / unknown ctor exempt
        # lexically nested re-acquisition of the same lock
        for inner in g.lock_sites_in(site.func):
            if inner.lock == site.lock and \
                    _span_contains(site.node, inner.node):
                m = g.functions[site.func].module if site.func else None
                if m is None:
                    continue
                fn = RepoGraph.short(site.func)
                yield m.finding(
                    "lock-reentrant-call", inner.node,
                    f"{fn}: re-enters {_short_lock(site.lock)} inside "
                    "its own 'with' region — guaranteed deadlock "
                    "(Lock is not reentrant)")
        for e in _calls_in_site(g, site):
            if site.lock not in clo.get(e.callee, set()):
                continue
            chain = g.call_chain(e.callee, site.lock)
            via = " -> ".join(RepoGraph.short(q) for q in chain) \
                or RepoGraph.short(e.callee)
            fn = RepoGraph.short(site.func) if site.func \
                else "<module>"
            yield e.module.finding(
                "lock-reentrant-call", e.node,
                f"{fn}: holds {_short_lock(site.lock)} while calling "
                f"{via}, which re-acquires it — deadlock (Lock is not "
                "reentrant); call the *_locked variant or move the "
                "call outside the region")
