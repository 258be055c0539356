"""Device choke-point rules, the port's counterpart of ``rules_jit.py``.

The port compiles nothing at run time, so it has two choke points where
the JAX package has ``kernel_cache`` and ``perf.pipeline``:

* ``_kernels.py`` builds every hand kernel with ``nvcc`` into the kernel
  cache directory (``mosaic.jit.cache.dir``, by default ``_build/``),
  keyed by a hash of its sources and flags, counts each load as a
  persistent hit or miss and raises :class:`KernelError` for a kernel
  that does not build or load; ``native/__init__.py`` is the same for
  the g++ host library.  A library loaded anywhere else bypasses the
  source-hash key, ``KernelError`` and the counters;
* ``perf.pipeline`` staging counts H2D bytes and registers the staged
  buffers with memwatch; a bare ``.cuda()`` / ``.to(device)`` moves
  bytes no ledger sees.

The rules, and the JAX rules they stand for:

* ``device-raw-load`` (``jit-raw-jit``): ``ctypes.CDLL``,
  ``ctypes.cdll.LoadLibrary``, ``torch.utils.cpp_extension.load*``, or a
  subprocess naming ``nvcc``, outside the two loaders;
* ``device-raw-h2d`` (``jit-raw-device-put``): ``.cuda()``,
  ``.to(<device>)``, ``torch.as_tensor``/``torch.tensor(...,
  device=...)`` outside ``perf/pipeline.py`` and outside the ``put``
  callbacks handed to ``stream`` (the sanctioned shapes of
  ``rules_jit``).  A device argument is recognised by its shape: a
  ``"cuda..."`` string, a ``torch.device(...)`` call, or a name whose
  last segment says ``dev``/``device``; ``.to(torch.float32)`` and
  other casts do not count.

``jit-host-sync`` has no counterpart: nothing in the port is traced, so
no function runs under a trace that a host read could break.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .core import PACKAGE, Finding, Module, Repo, dotted, enclosing, rule

#: the JAX package's jit rules and the port's counterpart of each, and
#: the one without a counterpart, with the reason ``--list-rules`` prints
JAX_COUNTERPARTS = {
    "jit-raw-jit": "device-raw-load",
    "jit-raw-device-put": "device-raw-h2d",
}
NO_COUNTERPART = {
    "jit-host-sync": "nothing in the port is traced: no function runs "
                     "under a trace that a host read could break",
}

#: modules that ARE the loaders (they may load a library and run nvcc)
LOADER_MODULES = {
    f"{PACKAGE}/_kernels.py",
    f"{PACKAGE}/native/__init__.py",
}

#: the staging choke point (it may move host bytes to the device)
STAGING_MODULES = {
    f"{PACKAGE}/perf/pipeline.py",
}

_LOAD_NAMES = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary", "cdll.LoadLibrary",
               "ctypes.PyDLL",
               "torch.utils.cpp_extension.load",
               "torch.utils.cpp_extension.load_inline",
               "cpp_extension.load", "cpp_extension.load_inline"}
_SUBPROCESS_NAMES = {"subprocess.run", "subprocess.Popen",
                     "subprocess.call", "subprocess.check_call",
                     "subprocess.check_output", "os.system"}
_H2D_CTORS = {"torch.as_tensor", "torch.tensor"}


def _in_scope(m: Module) -> bool:
    return m.path.startswith(f"{PACKAGE}/") and m.tree is not None


def _load_call_names(m: Module) -> Set[str]:
    """Spellings of the raw loaders live in this module: the dotted names
    plus bare ``CDLL``/``load``/``load_inline`` imported from ctypes or
    ``torch.utils.cpp_extension``."""
    names = set(_LOAD_NAMES)
    for node in ast.walk(m.tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.module == "ctypes":
            for alias in node.names:
                if alias.name in ("CDLL", "PyDLL", "cdll"):
                    bound = alias.asname or alias.name
                    names.add(bound if alias.name != "cdll"
                              else f"{bound}.LoadLibrary")
        elif node.module == "torch.utils.cpp_extension":
            for alias in node.names:
                if alias.name in ("load", "load_inline"):
                    names.add(alias.asname or alias.name)
    return names


def _names_nvcc(call: ast.Call) -> bool:
    for arg in call.args + [kw.value for kw in call.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Constant) and \
                    isinstance(sub.value, str) and "nvcc" in sub.value:
                return True
            d = dotted(sub) if isinstance(sub, (ast.Name,
                                                ast.Attribute)) else None
            if d and "nvcc" in d.split(".")[-1].lower():
                return True
    return False


def _fn_name(node: ast.AST, m: Module) -> str:
    """Dotted enclosing-function name of ``node`` (``<module>`` at the
    top level): it keys the finding, so each site's baseline entry
    survives edits elsewhere in the file."""
    names = [fn.name for fn in enclosing(
        node, m.parents, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef))]
    return ".".join(reversed(names)) or "<module>"


# --------------------------------------------------- device-raw-load

@rule("device-raw-load", "device",
      "a library loaded (ctypes.CDLL, cpp_extension.load) or nvcc run "
      "outside _kernels.py / native/ bypasses the source-hash kernel "
      "cache, KernelError and the persistent hit/miss counters "
      "(the JAX package's jit-raw-jit)")
def check_raw_load(repo: Repo) -> Iterable[Finding]:
    for m in repo.focused(repo.modules):
        if not _in_scope(m) or m.path in LOADER_MODULES:
            continue
        load_names = _load_call_names(m)
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in load_names:
                what = f"raw {d}()"
            elif d in _SUBPROCESS_NAMES and _names_nvcc(node):
                what = f"{d}() running nvcc"
            else:
                continue
            yield m.finding(
                "device-raw-load", node,
                f"{_fn_name(node, m)}: {what} bypasses _kernels — build "
                "and load through _kernels.load so the library is keyed "
                "by its sources, counted and raises KernelError")


# ---------------------------------------------------- device-raw-h2d

def _is_device_expr(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and \
            node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        return dotted(node.func) in ("torch.device", "device") and not (
            node.args and isinstance(node.args[0], ast.Constant) and
            node.args[0].value == "cpu")
    d = dotted(node)
    if not d:
        return False
    last = d.split(".")[-1].lower().lstrip("_")
    return last in ("dev", "device", "devices") or \
        last.endswith(("_dev", "_device"))


def _h2d_kind(node: ast.Call) -> Optional[str]:
    f = node.func
    kw = {k.arg: k.value for k in node.keywords if k.arg}
    if isinstance(f, ast.Attribute) and f.attr == "cuda" and \
            dotted(f) != "torch.cuda":
        return ".cuda()"
    if isinstance(f, ast.Attribute) and f.attr == "to":
        target = node.args[0] if node.args else kw.get("device")
        if _is_device_expr(target) or _is_device_expr(kw.get("device")):
            return ".to(<device>)"
        return None
    d = dotted(f)
    if d in _H2D_CTORS and "device" in kw and not (
            isinstance(kw["device"], ast.Constant) and
            kw["device"].value in (None, "cpu")):
        return f"{d}(..., device=...)"
    return None


def _put_callbacks(m: Module) -> Set[str]:
    """Functions handed to ``stream(..., put=...)`` in this module: their
    transfers run inside the pipeline's accounting (plus any function
    named ``put``)."""
    out: Set[str] = {"put"}
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d and d.split(".")[-1] == "stream":
                for kw in node.keywords:
                    if kw.arg == "put":
                        pd = dotted(kw.value)
                        if pd:
                            out.add(pd.split(".")[-1])
    return out


def _enclosing_fn_names(node: ast.AST, m: Module) -> List[str]:
    return [fn.name for fn in enclosing(
        node, m.parents, (ast.FunctionDef, ast.AsyncFunctionDef))]


@rule("device-raw-h2d", "device",
      "a bare .cuda() / .to(device) / torch.as_tensor(..., device=) "
      "outside perf.pipeline staging bypasses H2D byte accounting and "
      "the memwatch ledger (the JAX package's jit-raw-device-put)")
def check_raw_h2d(repo: Repo) -> Iterable[Finding]:
    for m in repo.focused(repo.modules):
        if not _in_scope(m) or m.path in STAGING_MODULES:
            continue
        put_fns = _put_callbacks(m)
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            what = _h2d_kind(node)
            if what is None:
                continue
            if any(fn in put_fns for fn in _enclosing_fn_names(node, m)):
                continue
            yield m.finding(
                "device-raw-h2d", node,
                f"{_fn_name(node, m)}: bare {what} — stage through "
                "perf.pipeline (or a put= callback handed to stream) so "
                "H2D bytes and live-buffer tracking see the transfer")
