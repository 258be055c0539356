"""Cancellation-checkpoint coverage.

Cooperative cancellation (obs.inflight) only works if the code under
a query actually polls: ``cancel()`` and deadline expiry take effect
at the next ``checkpoint()`` call, never mid-kernel.  The two places
the repo guarantees a bounded reaction time are

* **chunk loops in the streaming executors** — ``perf.pipeline`` and
  the streamed join paths advance chunk-by-chunk; a loop that forgets
  the probe turns "cancels within one chunk" into "cancels when the
  whole stream finishes";
* **engine operator boundaries** — ``sql.engine``'s per-operator
  ``stage()`` and ``perf.fusion``'s ``execute_group()`` are the
  coarse-grained fallback for non-streamed operators.

The rule is deliberately repo-shaped: the module and function names
below are this codebase's cancellation surface.  Growing a new
streaming executor?  Add its module here and the linter starts
holding it to the same contract.
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from .core import PACKAGE, Finding, Module, Repo, dotted, rule

#: modules whose chunk loops must poll the inflight checkpoint
STREAM_MODULES = {
    f"{PACKAGE}/perf/pipeline.py",
    f"{PACKAGE}/parallel/pip_join.py",
    f"{PACKAGE}/sql/engine.py",
    f"{PACKAGE}/perf/fusion.py",
    f"{PACKAGE}/serve/batching.py",
}

#: (module, function) pairs that ARE an operator boundary: each must
#: call the checkpoint so a cancel lands between operators
BOUNDARY_FUNCS = {
    (f"{PACKAGE}/sql/engine.py", "stage"),
    (f"{PACKAGE}/perf/fusion.py", "execute_group"),
    # the query server's per-request loop: a request popped off the
    # admission queue passes through dispatch() before any work runs
    (f"{PACKAGE}/serve/workers.py", "dispatch"),
}

_CHECKPOINT_NAMES = {"checkpoint", "_checkpoint"}


def _calls_checkpoint(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            d = dotted(sub.func)
            if d and d.split(".")[-1] in _CHECKPOINT_NAMES:
                return True
    return False


def _mentions_chunk(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "chunk" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and \
                "chunk" in sub.attr.lower():
            return True
    return False


def _is_chunk_loop(node: ast.AST) -> bool:
    """A loop that *advances through* chunks: ``for ... in <something
    chunk-named>`` or ``while <cond involving len(<chunks>)>``.
    Bounded helper loops that merely index a chunk list (pressure
    splitting, retry) don't advance the stream and are out of scope."""
    if isinstance(node, ast.For):
        return _mentions_chunk(node.iter)
    if isinstance(node, ast.While):
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Call) and \
                    dotted(sub.func) == "len" and sub.args and \
                    _mentions_chunk(sub.args[0]):
                return True
    return False


@rule("cancel-checkpoint", "cancel",
      "chunk loops in streaming executors and engine/fusion operator "
      "boundaries must call the inflight checkpoint (bounded "
      "cancellation latency)")
def check_cancel_checkpoint(repo: Repo) -> Iterable[Finding]:
    for m in repo.focused(repo.modules):
        if m.tree is None:
            continue
        if m.path in STREAM_MODULES:
            for node in ast.walk(m.tree):
                if not isinstance(node, (ast.For, ast.While)) or \
                        not _is_chunk_loop(node):
                    continue
                if any(_calls_checkpoint(stmt) for stmt in node.body):
                    continue
                yield m.finding(
                    "cancel-checkpoint", node,
                    "chunk loop without an inflight checkpoint() in "
                    "its body — a cancel/deadline won't land until "
                    "the stream drains; probe once per chunk")
        wanted: Set[str] = {fn for (path, fn) in BOUNDARY_FUNCS
                            if path == m.path}
        if not wanted:
            continue
        for node in ast.walk(m.tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) and \
                    node.name in wanted:
                if not _calls_checkpoint(node):
                    yield m.finding(
                        "cancel-checkpoint", node,
                        f"operator boundary {node.name}() never calls "
                        "the inflight checkpoint — cancels can't land "
                        "between operators")
