"""The port's linter (``mosaic_tpu_torch/lint``) held against the JAX
package's (``mosaic_tpu/lint``) on the CPU.

Every case of ``tests/test_lint.py`` is ported as a parametrised case: its
fixture, with paths renamed ``mosaic_tpu/`` -> ``mosaic_tpu_torch/``, goes
through both linters, and the findings must be equal in rule, line and
message, apart from the package prefix, besides meeting the case's own
check.  The ``jit-*`` fixtures have ``device-*`` twins (``jax.jit`` ->
``ctypes.CDLL``, ``jax.device_put`` -> ``.to(device)``), each firing on
its bad fixture and silent on its good one; ``jit-host-sync`` has no
counterpart (nothing in the port is traced), which a case pins.  The CLI
cases drive ``tools/graftlint_torch.py`` on small roots; the real tree is
linted once, by the CLI, and is clean under
``tools/graftlint_torch_baseline.json``.  A subprocess shows that loading
the linter imports no torch, jax or ``mosaic_tpu``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from typing import Callable, Dict, Optional

import pytest

from mosaic_tpu import lint as jlint
from mosaic_tpu_torch import lint as tlint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO_ROOT, "tools", "graftlint_torch.py")
JP, TP = "mosaic_tpu/", "mosaic_tpu_torch/"


def dedent(src):
    return textwrap.dedent(src).lstrip("\n")


def port(files: Optional[Dict[str, str]]) -> Optional[Dict[str, str]]:
    """A fixture's files with the package prefix renamed to the port's."""
    if files is None:
        return None
    return {(TP + p[len(JP):] if p.startswith(JP) else p): t
            for p, t in files.items()}


def run_t(rule_id, code=None, tools=None, tests=None, docs=None):
    repo = tlint.Repo.from_sources(code=code, tools=tools, tests=tests,
                                   docs=docs)
    return tlint.run_lint(repo, [rule_id])


def run_j(rule_id, code=None, tools=None, tests=None, docs=None):
    repo = jlint.Repo.from_sources(code=code, tools=tools, tests=tests,
                                   docs=docs)
    return jlint.run_lint(repo, [rule_id])


def _unprefixed(findings, prefix):
    return [(f.rule, JP + f.path[len(prefix):] if f.path.startswith(prefix)
             else f.path, f.line, f.message) for f in findings]


def both(rule_id, code=None, tools=None, tests=None, docs=None):
    """Run a JAX-path fixture through the JAX linter and its renamed twin
    through the port's; the findings must be equal apart from the
    prefix.  Returns the port's findings."""
    j = run_j(rule_id, code, tools, tests, docs)
    t = run_t(rule_id, port(code), port(tools), port(tests), docs)
    assert _unprefixed(t, TP) == _unprefixed(j, JP)
    return t


# Minimal config.py / recorder.py stand-ins the contract rules parse.
CONFIG_SRC = dedent("""
    MOSAIC_PLANNER_FORCE_PREFIX = "mosaic.planner.force."
    KEY_KNOWN = "mosaic.known.key"
    _CONF_FIELDS = {
        KEY_KNOWN: int,
        "mosaic.other.key": str,
    }
""")

RECORDER_SRC = dedent("""
    EVENTS = frozenset({"boot", "tick"})
""")

MEMWATCH_SRC = dedent("""
    class DeviceMemoryLedger:
        def register(self, site, nbytes):
            return object()

        def release(self, token):
            return None

    memwatch = DeviceMemoryLedger()
""")

BAD_JIT = "import jax\nf = jax.jit(lambda x: x)"
BAD_LOAD = 'import ctypes\nf = ctypes.CDLL("libk.so")'


@dataclasses.dataclass
class Case:
    """One ported case: ``rule`` over ``kw`` (JAX paths) through both
    linters, then ``check`` on the port's findings."""
    name: str
    rule: str
    kw: dict
    check: Callable


def _lines(*want):
    return lambda found: sorted(f.line for f in found) == sorted(want)


def _count(n):
    return lambda found: len(found) == n


def _msgs(*parts):
    def ok(found):
        msgs = " | ".join(f.message for f in found)
        return all(p in msgs for p in parts)
    return ok


# --------------------------------------------- the rule cases, both ways

LOCK_CASES = [
    Case("unguarded_attr_fires", "lock-unguarded-attr", dict(code={
        "mosaic_tpu/c.py": dedent("""
            import threading

            class Counter:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0
                    self.items = []

                def bump(self):
                    self.n += 1

                def push(self, x):
                    self.items.append(x)
        """)}), _lines(10, 13)),
    Case("guarded_and_locked_helpers_pass", "lock-unguarded-attr", dict(code={
        "mosaic_tpu/c.py": dedent("""
            import threading

            class Counter:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0

                def bump(self):
                    with self._lock:
                        self.n += 1

                def _reset_locked(self):
                    self.n = 0
        """)}), _count(0)),
    Case("lockless_class_out_of_scope", "lock-unguarded-attr", dict(code={
        "mosaic_tpu/c.py": dedent("""
            class Plain:
                def bump(self):
                    self.n = 1
        """)}), _count(0)),
    Case("global_rebind_fires", "lock-global-state", dict(code={
        "mosaic_tpu/g.py": dedent("""
            import threading

            _lock = threading.Lock()
            _conf = None

            def configure(v):
                global _conf
                _conf = v
        """)}), _lines(8)),
    Case("global_rebind_under_lock_passes", "lock-global-state", dict(code={
        "mosaic_tpu/g.py": dedent("""
            import threading

            _lock = threading.Lock()
            _conf = None

            def configure(v):
                global _conf
                with _lock:
                    _conf = v
        """)}), _count(0)),
]

_FAULT_SRC = dedent("""
    from .resilience import faults

    def read(path):
        faults.maybe_fail("thing.read")
""")

CONTRACT_CASES = [
    Case("unregistered_conf_key_fires", "contract-conf-key", dict(code={
        "mosaic_tpu/config.py": CONFIG_SRC,
        "mosaic_tpu/u.py": 'KEY = "mosaic.unknown.key"\n'}),
        lambda f: len(f) == 1 and "mosaic.unknown.key" in f[0].message),
    Case("registered_and_force_prefix_keys_pass", "contract-conf-key",
         dict(code={"mosaic_tpu/config.py": CONFIG_SRC,
                    "mosaic_tpu/u.py": dedent("""
                        A = "mosaic.known.key"
                        B = "mosaic.planner.force.fusion"
                    """)}), _count(0)),
    Case("conf_docs_both_directions", "contract-conf-docs", dict(
        code={"mosaic_tpu/config.py": CONFIG_SRC},
        docs={"docs/usage/conf.md":
              "Set `mosaic.known.key` or `mosaic.bogus.key`.\n"}),
        lambda f: _msgs("mosaic.other.key", "mosaic.bogus.key")(f) and
        {x.path for x in f} == {TP + "config.py", "docs/usage/conf.md"}),
    Case("conf_docs_family_glob_passes", "contract-conf-docs", dict(
        code={"mosaic_tpu/config.py": CONFIG_SRC},
        docs={"docs/usage/conf.md":
              "All `mosaic.known.key`, `mosaic.other.key` and the "
              "`mosaic.known.*` family.\n"}), _count(0)),
    Case("bad_metric_name_fires", "contract-metric-name", dict(code={
        "mosaic_tpu/m.py": dedent("""
            def probe(metrics, n):
                metrics.count("BadName")
                metrics.gauge("fam/Mixed-Case", n)
        """)}), _count(2)),
    Case("good_metric_names_pass", "contract-metric-name", dict(code={
        "mosaic_tpu/m.py": dedent("""
            def probe(metrics, dev, n):
                metrics.count("fam/name")
                metrics.gauge(f"mem/{dev}/bytes", n)
        """)}), _count(0)),
    Case("undeclared_event_and_dead_entry_fire", "contract-recorder-event",
         dict(code={"mosaic_tpu/obs/recorder.py": RECORDER_SRC,
                    "mosaic_tpu/e.py": dedent("""
                        from .obs.recorder import recorder

                        def go():
                            recorder.record("mystery", x=1)
                            recorder.record("boot")
                    """)}), _msgs("'mystery'", "'tick'")),
    Case("catalogue_matches_emissions_passes", "contract-recorder-event",
         dict(code={"mosaic_tpu/obs/recorder.py": RECORDER_SRC,
                    "mosaic_tpu/e.py": dedent("""
                        from .obs.recorder import recorder

                        def go():
                            recorder.record("boot")
                            recorder.record("tick")
                    """)}), _count(0)),
    Case("missing_catalogue_is_one_finding", "contract-recorder-event",
         dict(code={"mosaic_tpu/obs/recorder.py": "x = 1\n"}),
         lambda f: len(f) == 1 and "EVENTS" in f[0].message),
    Case("uncovered_fault_site_fires", "contract-fault-coverage", dict(
        code={"mosaic_tpu/io/thing.py": _FAULT_SRC},
        tests={"tests/test_x.py": "def test_ok(): pass\n"}),
        lambda f: len(f) == 1 and "thing.read" in f[0].message),
    Case("fnmatch_covered_site_passes", "contract-fault-coverage", dict(
        code={"mosaic_tpu/io/thing.py": _FAULT_SRC},
        tests={"tests/test_chaos.py":
               'plan("seed=1;site=thing.*,fails=1,error=OSError")\n'}),
        _count(0)),
]

_PUMP = dedent("""
    def pump(chunks, consume):
        for c in chunks:
            consume(c)
""")

CANCEL_CASES = [
    Case("chunk_loop_without_checkpoint_fires", "cancel-checkpoint",
         dict(code={"mosaic_tpu/perf/pipeline.py": _PUMP}), _lines(2)),
    Case("chunk_loop_with_checkpoint_passes", "cancel-checkpoint", dict(code={
        "mosaic_tpu/perf/pipeline.py": dedent("""
            def pump(chunks, consume, inflight):
                for c in chunks:
                    inflight.checkpoint()
                    consume(c)
        """)}), _count(0)),
    Case("chunk_loop_outside_stream_modules_out_of_scope",
         "cancel-checkpoint", dict(code={"mosaic_tpu/util.py": _PUMP}),
         _count(0)),
    Case("operator_boundary_without_checkpoint_fires", "cancel-checkpoint",
         dict(code={"mosaic_tpu/sql/engine.py": dedent("""
             def stage(op, rows):
                 return op(rows)
         """)}), lambda f: len(f) == 1 and "stage()" in f[0].message),
    Case("operator_boundary_with_checkpoint_passes", "cancel-checkpoint",
         dict(code={"mosaic_tpu/sql/engine.py": dedent("""
             def stage(op, rows, handle):
                 handle._checkpoint()
                 return op(rows)
         """)}), _count(0)),
    # the port's stream-fed generator, as parallel/pip_join.py has it:
    # the loop fires unless it carries the suppression with its reason
    Case("stream_fed_generator_fires_unless_suppressed",
         "cancel-checkpoint", dict(code={
             "mosaic_tpu/parallel/pip_join.py": dedent("""
                 def run(store, stream):
                     def blocks():
                         for ck in store.iter_chunks():
                             yield ck
                     stream(blocks())

                 def run2(store, stream):
                     def blocks():
                         # graftlint: ignore[cancel-checkpoint] — stream polls
                         for ck in store.iter_chunks():
                             yield ck
                     stream(blocks())
             """)}), _lines(3)),
]

BAD_CYCLE = dedent("""
    import threading

    _lock_a = threading.Lock()
    _lock_b = threading.Lock()

    def _take_b():
        with _lock_b:
            pass

    def ab():
        with _lock_a:
            _take_b()

    def ba():
        with _lock_b:
            with _lock_a:
                pass
""")

_BOX = dedent("""
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.{kind}()
            self.n = 0

        def _bump(self):
            with self._lock:
                self.n += 1

        def bump_twice(self):
            with self._lock:
                self._bump()
""")

_LEXICAL_REENTRY = dedent("""
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()

        def oops(self):
            with self._lock:
                with self._lock:
                    pass
""")

LOCKORDER_CASES = [
    Case("ab_ba_cycle_fires_per_edge", "lock-order-cycle",
         dict(code={"mosaic_tpu/x.py": BAD_CYCLE}),
         lambda f: len(f) == 2 and _msgs("_lock_a", "_lock_b", "via")(f)),
    Case("consistent_order_passes", "lock-order-cycle", dict(code={
        "mosaic_tpu/x.py": dedent("""
            import threading

            _lock_a = threading.Lock()
            _lock_b = threading.Lock()

            def ab():
                with _lock_a:
                    with _lock_b:
                        pass

            def also_ab():
                with _lock_a:
                    with _lock_b:
                        pass
        """)}), _count(0)),
    Case("reentrant_call_through_callee_fires", "lock-reentrant-call",
         dict(code={"mosaic_tpu/b.py": _BOX.replace("{kind}", "Lock")}),
         lambda f: len(f) == 1 and "_bump" in f[0].message),
    Case("rlock_reentry_exempt", "lock-reentrant-call",
         dict(code={"mosaic_tpu/b.py": _BOX.replace("{kind}", "RLock")}),
         _count(0)),
    Case("lexical_reentry_fires", "lock-reentrant-call",
         dict(code={"mosaic_tpu/b.py": _LEXICAL_REENTRY}),
         lambda f: len(f) == 1 and "re-enters" in f[0].message),
]

_SAMPLER = dedent("""
    import threading

    class Sampler:
        def __init__(self):
            self._lock = threading.Lock()
            self.rows = []

        def start(self):
            def _work():
                {body}
            threading.Thread(target=_work).start()
""")

THREAD_CASES = [
    Case("unguarded_mutation_on_thread_fires", "thread-escape-unguarded",
         dict(code={"mosaic_tpu/s.py": _SAMPLER.replace(
             "{body}", "self.rows.append(1)")}),
         lambda f: len(f) == 1 and _msgs("self.rows", "Sampler")(f)),
    Case("locked_mutation_on_thread_passes", "thread-escape-unguarded",
         dict(code={"mosaic_tpu/s.py": _SAMPLER.replace(
             "{body}", "with self._lock:\n                    "
                       "self.rows.append(1)")}), _count(0)),
    Case("bound_method_target_is_other_rules_jurisdiction",
         "thread-escape-unguarded", dict(code={"mosaic_tpu/s.py": dedent("""
             import threading

             class Sampler:
                 def __init__(self):
                     self._lock = threading.Lock()
                     self.rows = []

                 def _drain(self):
                     self.rows.append(1)

                 def start(self):
                     threading.Thread(target=self._drain).start()
         """)}), _count(0)),
]


def _release(client):
    return dict(code={"mosaic_tpu/obs/memwatch.py": MEMWATCH_SRC,
                      "mosaic_tpu/stage.py": dedent(client)})


RELEASE_CASES = [
    Case("raise_before_release_fires", "resource-release-path", _release("""
        from .obs.memwatch import memwatch

        def stage(buf, work):
            tok = memwatch.register("stage", 8)
            work(buf)
            memwatch.release(tok)
    """), lambda f: len(f) == 1 and "'tok'" in f[0].message),
    Case("finally_twin_passes", "resource-release-path", _release("""
        from .obs.memwatch import memwatch

        def stage(buf, work):
            tok = memwatch.register("stage", 8)
            try:
                work(buf)
            finally:
                memwatch.release(tok)
    """), _count(0)),
    Case("discarded_token_fires", "resource-release-path", _release("""
        from .obs.memwatch import memwatch

        def stage():
            memwatch.register("stage", 8)
    """), lambda f: len(f) == 1 and "discarded" in f[0].message),
    Case("returned_token_escapes_passes", "resource-release-path", _release("""
        from .obs.memwatch import memwatch

        def stage():
            return memwatch.register("stage", 8)
    """), _count(0)),
    Case("thread_handoff_to_finally_worker_passes", "resource-release-path",
         _release("""
        from .obs.memwatch import memwatch

        def _worker(tok):
            try:
                consume(tok)
            finally:
                memwatch.release(tok)

        def go(pool):
            tok = memwatch.register("s", 8)
            pool.submit(_worker, tok)
    """), _count(0)),
    Case("thread_handoff_to_unprotected_worker_fires",
         "resource-release-path", _release("""
        from .obs.memwatch import memwatch

        def _worker(tok):
            consume(tok)
            memwatch.release(tok)

        def go(pool):
            tok = memwatch.register("s", 8)
            pool.submit(_worker, tok)
    """), lambda f: len(f) == 1 and "thread worker" in f[0].message),
    Case("other_ledgers_named_register_ignored", "resource-release-path",
         _release("""
        class KernelLedger:
            def register(self, k, v):
                return object()

        ledger = KernelLedger()

        def note(k, v):
            ledger.register(k, v)
    """), _count(0)),
]

PARITY_CASES = (LOCK_CASES + CONTRACT_CASES + CANCEL_CASES +
                LOCKORDER_CASES + THREAD_CASES + RELEASE_CASES)


@pytest.mark.parametrize("case", PARITY_CASES, ids=lambda c: c.name)
def test_rule_case_as_jax(case):
    found = both(case.rule, **case.kw)
    assert case.check(found), [f.render() for f in found]


# ------------------------------------- jit-* cases and their device twins

@dataclasses.dataclass
class Twin:
    """A ``tests/test_lint.py`` jit case (``jrule`` over ``jcode``, whose
    JAX findings must number ``jn``) and its device twin (``trule`` over
    ``tcode``, ``tn`` port findings)."""
    name: str
    jrule: str
    jcode: dict
    jn: int
    trule: str
    tcode: dict
    tn: int


TWINS = [
    Twin("raw_jit_fires", "jit-raw-jit",
         {"mosaic_tpu/k.py": "import jax\nsquare = jax.jit(lambda x: x * x)\n"},
         1, "device-raw-load",
         {TP + "k.py": 'import ctypes\nlib = ctypes.CDLL("libk.so")\n'}, 1),
    Twin("bare_jit_import_fires", "jit-raw-jit",
         {"mosaic_tpu/k.py": "from jax import jit\nsquare = jit(lambda x: x)\n"},
         1, "device-raw-load",
         {TP + "k.py": 'from ctypes import CDLL\nlib = CDLL("libk.so")\n'}, 1),
    Twin("jit_via_get_or_build_passes", "jit-raw-jit", {
        "mosaic_tpu/k.py": dedent("""
            import jax
            from .perf.jit_cache import kernel_cache

            def _build():
                return jax.jit(lambda x: x * x)

            def kernel(key):
                return kernel_cache.get_or_build("square", key, _build)
        """)}, 0, "device-raw-load", {TP + "k.py": dedent("""
            from . import _kernels

            def kernel():
                return _kernels.load("h3_cell")
        """)}, 0),
    Twin("jit_in_choke_module_passes", "jit-raw-jit",
         {"mosaic_tpu/perf/jit_cache.py": "import jax\nf = jax.jit(lambda x: x)\n"},
         0, "device-raw-load",
         {TP + "_kernels.py": 'import ctypes\nf = ctypes.CDLL("x.so")\n',
          TP + "native/__init__.py": 'import ctypes\nf = ctypes.CDLL("g.so")\n'},
         0),
    Twin("raw_device_put_fires", "jit-raw-device-put", {
        "mosaic_tpu/k.py": dedent("""
            import jax

            def stage(chunk):
                return jax.device_put(chunk)
        """)}, 1, "device-raw-h2d", {TP + "k.py": dedent("""
            import torch

            def stage(chunk, device):
                return torch.from_numpy(chunk).to(device)
        """)}, 1),
    Twin("device_put_in_stream_put_callback_passes", "jit-raw-device-put", {
        "mosaic_tpu/k.py": dedent("""
            import jax
            from .perf.pipeline import stream

            def _stage(chunk):
                return jax.device_put(chunk)

            def go(chunks):
                return stream(chunks, put=_stage)
        """)}, 0, "device-raw-h2d", {TP + "k.py": dedent("""
            from .perf.pipeline import stream

            def _stage(chunk, dev):
                return chunk.to(dev)

            def go(chunks):
                return stream(chunks, put=_stage)
        """)}, 0),
    Twin("constant_fold_and_device_code_pass", "jit-host-sync", {
        "mosaic_tpu/k.py": dedent("""
            import jax

            @jax.jit
            def f(x):
                nan = float("nan")
                return x * 2 + nan

            def host_side(x):
                return float(x)
        """)}, 0, "device-raw-h2d", {TP + "k.py": dedent("""
            import torch

            def casts(x, dtype):
                torch.cuda.synchronize()
                y = torch.tensor([1.0, 2.0])
                return x.to(torch.float32), x.to(dtype), x.to("cpu"), y
        """)}, 0),
]

#: device twins beyond the jit cases: each other spelling the rules catch
EXTRA_TWINS = [
    ("cdll_loadlibrary", "device-raw-load",
     'import ctypes\nlib = ctypes.cdll.LoadLibrary("x.so")\n', 1),
    ("cpp_extension_load", "device-raw-load", dedent("""
        from torch.utils.cpp_extension import load
        ext = load(name="k", sources=["k.cu"])
    """), 1),
    ("subprocess_nvcc", "device-raw-load", dedent("""
        import subprocess

        def build(src):
            subprocess.run(["nvcc", "-O3", src], check=True)
            subprocess.run(["g++", src], check=True)
    """), 1),
    ("dot_cuda", "device-raw-h2d", "def f(t):\n    return t.cuda()\n", 1),
    ("as_tensor_on_device", "device-raw-h2d", dedent("""
        import torch

        def f(a, dev):
            x = torch.as_tensor(a, device=dev)
            y = torch.tensor(a, device="cuda:0")
            z = torch.as_tensor(a, device="cpu")
            return x.to(device=torch.device("cuda")), y, z
    """), 3),
    ("staging_module_passes", "device-raw-h2d",
     "def upload(x, device):\n    return x.to(device, non_blocking=True)\n",
     0),
]


@pytest.mark.parametrize("twin", TWINS, ids=lambda t: t.name)
def test_jit_case_and_device_twin(twin):
    assert len(run_j(twin.jrule, code=twin.jcode)) == twin.jn
    found = run_t(twin.trule, code=twin.tcode)
    assert len(found) == twin.tn, [f.render() for f in found]
    if twin.tn:
        assert found[0].line == 2 or twin.trule == "device-raw-h2d"


@pytest.mark.parametrize("name,rule_id,src,n", EXTRA_TWINS,
                         ids=[t[0] for t in EXTRA_TWINS])
def test_device_rule_spellings(name, rule_id, src, n):
    path = TP + ("perf/pipeline.py" if name == "staging_module_passes"
                 else "k.py")
    found = run_t(rule_id, code={path: src})
    assert len(found) == n, [f.render() for f in found]


def test_host_sync_has_no_counterpart():
    """The JAX rule fires on a host sync inside a jitted function; the
    port has no such rule (nothing is traced), states why, and none of its
    rules fires on the renamed fixture."""
    src = dedent("""
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return float(x) + 1.0

        g = jax.jit(lambda x: np.asarray(x))
    """)
    found = run_j("jit-host-sync", code={"mosaic_tpu/k.py": src})
    assert {f.line for f in found} == {6, 8}
    ids = {r.id for r in tlint.all_rules()}
    assert "jit-host-sync" not in ids
    assert "jit-host-sync" not in tlint.JAX_COUNTERPARTS
    assert "traced" in tlint.NO_COUNTERPART["jit-host-sync"]
    repo = tlint.Repo.from_sources(code={TP + "k.py": src})
    assert tlint.run_lint(repo) == []


def test_every_jax_rule_has_a_counterpart_or_a_reason():
    jids = {r.id for r in jlint.all_rules()}
    tids = {r.id for r in tlint.all_rules()}
    for jid in sorted(jids - tids):
        assert tlint.JAX_COUNTERPARTS.get(jid) in tids or \
            jid in tlint.NO_COUNTERPART, jid
    assert tids - jids == set(tlint.JAX_COUNTERPARTS.values())


# ------------------------------------------- suppressions & parse errors

SUPPRESSION_CASES = [
    ("same_line_marker", "  # graftlint: ignore[{rule}] — test fixture\n",
     "", 0),
    ("comment_above_marker", None, "", 0),
    ("star_suppresses_any_rule", "  # graftlint: ignore[*] — test fixture\n",
     "", 0),
    ("wrong_rule_id_does_not_suppress",
     "  # graftlint: ignore[{other}] — wrong id\n", "", 1),
    ("skip_file", "\n", "# graftlint: skip-file\n", 0),
]


@pytest.mark.parametrize("name,tail,head,n", SUPPRESSION_CASES,
                         ids=[c[0] for c in SUPPRESSION_CASES])
def test_suppression_case(name, tail, head, n):
    """Each JAX suppression case on BAD_JIT, and its port twin on
    BAD_LOAD."""
    for runner, bad, rule_id, other, pkg in (
            (run_j, BAD_JIT, "jit-raw-jit", "jit-host-sync", JP),
            (run_t, BAD_LOAD, "device-raw-load", "device-raw-h2d", TP)):
        if tail is None:
            first, second = bad.split("\n")
            src = (f"{first}\n# graftlint: ignore[{rule_id}] — test "
                   f"fixture\n{second}\n")
        else:
            src = head + bad + tail.format(rule=rule_id, other=other)
        assert len(runner(rule_id, code={pkg + "k.py": src})) == n


def test_parse_error_surfaces_as_finding():
    j = jlint.run_lint(jlint.Repo.from_sources(
        code={"mosaic_tpu/broken.py": "def f(:\n"}))
    t = tlint.run_lint(tlint.Repo.from_sources(
        code={TP + "broken.py": "def f(:\n"}))
    assert [f.rule for f in t] == ["parse-error"]
    assert "syntax error" in t[0].message
    assert _unprefixed(t, TP) == _unprefixed(j, JP)


# --------------------------------------------------------- baseline

def _bad():
    return run_t("device-raw-load", code={TP + "k.py": BAD_LOAD})


def _base_round_trip(tmp_path):
    findings = _bad()
    data = tlint.baseline_from_findings(
        findings, reasons={findings[0].key: "legacy loader"})
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(data))
    new, old, stale = tlint.apply_baseline(findings,
                                           tlint.load_baseline(str(p)))
    assert new == [] and stale == [] and old == findings


def _base_stale(tmp_path):
    findings = _bad()
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(tlint.baseline_from_findings(findings)))
    new, old, stale = tlint.apply_baseline([], tlint.load_baseline(str(p)))
    assert new == [] and old == [] and stale == [findings[0].key]


def _base_line_drift(tmp_path):
    findings = _bad()
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(tlint.baseline_from_findings(findings)))
    shifted = run_t("device-raw-load",
                    code={TP + "k.py": "# moved\n" + BAD_LOAD})
    assert shifted[0].line != findings[0].line
    new, old, _ = tlint.apply_baseline(shifted, tlint.load_baseline(str(p)))
    assert new == [] and old == shifted


def _base_count(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(tlint.baseline_from_findings(_bad())))
    doubled = run_t("device-raw-load", code={
        TP + "k.py": BAD_LOAD + '\ng = ctypes.CDLL("other.so")\n'})
    assert len(doubled) == 2
    new, old, _ = tlint.apply_baseline(doubled, tlint.load_baseline(str(p)))
    assert len(new) == 1 and len(old) == 1


def _base_missing(tmp_path):
    assert tlint.load_baseline(str(tmp_path / "nope.json")) == {}


def _base_version(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text('{"version": 99, "findings": {}}')
    with pytest.raises(ValueError):
        tlint.load_baseline(str(p))


def _base_todo(tmp_path):
    data = tlint.baseline_from_findings(_bad())
    assert next(iter(data["findings"].values()))["reason"].startswith("TODO")


BASELINE_CASES = [_base_round_trip, _base_stale, _base_line_drift,
                  _base_count, _base_missing, _base_version, _base_todo]


@pytest.mark.parametrize("case", BASELINE_CASES,
                         ids=lambda c: c.__name__[1:])
def test_baseline_case(case, tmp_path):
    case(tmp_path)


def test_baseline_file_format_as_jax(tmp_path):
    """The port's baseline is the JAX package's format: either package
    loads a file the other wrote."""
    data = tlint.baseline_from_findings(_bad(), reasons={})
    p = tmp_path / "b.json"
    p.write_text(json.dumps(data))
    assert jlint.load_baseline(str(p)) == tlint.load_baseline(str(p))


# -------------------------------------------------------------- CLI

def _cli(args, cwd=REPO_ROOT, python_args=()):
    return subprocess.run([sys.executable, *python_args, TOOL, *args],
                          cwd=cwd, capture_output=True, text=True)


def _mini_root(tmp_path, name="k.py"):
    pkg = tmp_path / "mosaic_tpu_torch"
    pkg.mkdir(exist_ok=True)
    (pkg / name).write_text(BAD_LOAD + "\n")
    return str(tmp_path)


def _cli_json_schema(tmp_path):
    r = _cli(["--root", _mini_root(tmp_path), "--json"])
    assert r.returncode == 1
    out = json.loads(r.stdout)
    assert out["version"] == 1 and out["counts"]["new"] == 1
    f = out["findings"][0]
    assert set(f) == {"rule", "path", "line", "message"}
    assert f["rule"] == "device-raw-load"
    assert f["path"] == "mosaic_tpu_torch/k.py"


def _cli_update_then_check(tmp_path):
    root = _mini_root(tmp_path)
    r = _cli(["--root", root, "--update-baseline"])
    assert r.returncode == 0 and "need a reason" in r.stdout
    assert (tmp_path / "tools" / "graftlint_torch_baseline.json").exists()
    assert _cli(["--root", root, "--check"]).returncode == 0


def _cli_stale(tmp_path):
    root = _mini_root(tmp_path)
    assert _cli(["--root", root, "--update-baseline"]).returncode == 0
    (tmp_path / "mosaic_tpu_torch" / "k.py").write_text("x = 1\n")
    r = _cli(["--root", root, "--check"])
    assert r.returncode == 1 and "stale" in r.stdout


def _cli_unknown_rule(tmp_path):
    r = _cli(["--root", _mini_root(tmp_path), "--rules", "jit-raw-jit"])
    assert r.returncode == 2


def _cli_list_rules(tmp_path):
    r = _cli(["--list-rules"])
    assert r.returncode == 0
    for rule in tlint.all_rules():
        assert rule.id in r.stdout
    # every JAX rule id is named: the port's own or its stated counterpart
    for rule in jlint.all_rules():
        assert rule.id in r.stdout


def _cli_scope(tmp_path):
    """Only the port is linted: the JAX package, JAX tools and JAX tests
    in the same root are out of scope (a JAX chaos test's site= does not
    cover the port's site)."""
    root = tmp_path
    (root / "mosaic_tpu").mkdir()
    (root / "mosaic_tpu" / "k.py").write_text(BAD_LOAD + "\n")
    (root / "tools").mkdir()
    (root / "tools" / "other.py").write_text(BAD_LOAD + "\n")
    (root / "mosaic_tpu_torch" / "io").mkdir(parents=True)
    (root / "mosaic_tpu_torch" / "io" / "thing.py").write_text(_FAULT_SRC)
    (root / "tests").mkdir()
    (root / "tests" / "test_chaos.py").write_text(
        'plan("seed=1;site=thing.*,fails=1")\n')
    (root / "tests" / "test_torch_x.py").write_text("def test_ok(): pass\n")
    r = _cli(["--root", str(root), "--json"])
    out = json.loads(r.stdout)
    assert [(f["rule"], f["path"]) for f in out["findings"]] == [
        ("contract-fault-coverage", "mosaic_tpu_torch/io/thing.py")]
    (root / "tests" / "torch_chaos_plans.py").write_text(
        'plan("seed=1;site=thing.*,fails=1")\n')
    assert _cli(["--root", str(root)]).returncode == 0


CLI_CASES = [_cli_json_schema, _cli_update_then_check, _cli_stale,
             _cli_unknown_rule, _cli_list_rules, _cli_scope]


@pytest.mark.parametrize("case", CLI_CASES, ids=lambda c: c.__name__[5:])
def test_cli_case(case, tmp_path):
    case(tmp_path)


def _git(*args, cwd):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                    *args], cwd=cwd, check=True, capture_output=True)


def test_changed_scopes_report_to_diff(tmp_path):
    _mini_root(tmp_path, "old.py")
    _git("init", "-q", cwd=tmp_path)
    _git("add", "-A", cwd=tmp_path)
    _git("commit", "-qm", "seed", cwd=tmp_path)
    r = _cli(["--root", str(tmp_path), "--changed", "--json"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout)["counts"]["new"] == 0
    _mini_root(tmp_path, "new.py")
    r = _cli(["--root", str(tmp_path), "--changed", "--json"])
    assert r.returncode == 1
    assert {f["path"] for f in json.loads(r.stdout)["findings"]} == \
        {"mosaic_tpu_torch/new.py"}


def test_changed_without_git_falls_back_to_full(tmp_path):
    r = _cli(["--root", _mini_root(tmp_path), "--changed", "--json"])
    assert r.returncode == 1 and "full repo" in r.stderr
    assert json.loads(r.stdout)["counts"]["new"] == 1


def test_sarif_output_schema(tmp_path):
    sarif = tmp_path / "out.sarif"
    r = _cli(["--root", _mini_root(tmp_path), "--sarif", str(sarif),
              "--json"])
    assert r.returncode == 1
    doc = json.loads(sarif.read_text())
    assert doc["version"] == "2.1.0"
    drv = doc["runs"][0]["tool"]["driver"]
    assert any(rd["id"] == "device-raw-load" for rd in drv["rules"])
    res = doc["runs"][0]["results"][0]
    assert res["ruleId"] == "device-raw-load"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "mosaic_tpu_torch/k.py"
    assert loc["region"]["startLine"] >= 1


def test_loading_the_lint_imports_no_torch_jax_or_mosaic_tpu():
    """The CLI loads the lint package under a private name, without
    ``mosaic_tpu_torch/__init__.py``: after a full --list-rules run the
    child holds no torch, jax or mosaic_tpu module."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['graftlint_torch', '--list-rules']\n"
        "try:\n"
        f"    runpy.run_path({TOOL!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'mosaic_tpu',\n"
        "              'mosaic_tpu_torch', 'numpy'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad, 'lint': sorted(\n"
        "    m for m in sys.modules if m.startswith('_graftlint'))}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                       capture_output=True, text=True)
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["bad"] == []
    assert "_graftlint_torch_rules.rules_device" in out["lint"]


# ------------------------------------------------ graph, both ways

def graphs(code):
    return (jlint.Repo.from_sources(code=code).graph(),
            tlint.Repo.from_sources(code=port(code)).graph())


def _callees(g, caller, prefix):
    return {e.callee.replace(prefix, JP, 1)
            for e in g.edges_from(caller.replace(JP, prefix, 1))}


GRAPH_CASES = {
    "method_and_cross_module_calls_resolve": (
        {"mosaic_tpu/util.py": "def helper():\n    return 1\n",
         "mosaic_tpu/engine.py": dedent("""
             from .util import helper

             class Engine:
                 def run(self):
                     return self._step()

                 def _step(self):
                     return helper()
         """)},
        [("mosaic_tpu/engine.py::Engine.run",
          "mosaic_tpu/engine.py::Engine._step"),
         ("mosaic_tpu/engine.py::Engine._step",
          "mosaic_tpu/util.py::helper")]),
    "builder_by_name_edge": (
        {"mosaic_tpu/k.py": dedent("""
            from .perf.jit_cache import kernel_cache

            def _build():
                return 1

            def kernel(key):
                return kernel_cache.get_or_build("k", key, _build)
        """)},
        [("mosaic_tpu/k.py::kernel", "mosaic_tpu/k.py::_build")]),
    "singleton_instance_method_resolves": (
        {"mosaic_tpu/a.py": dedent("""
            class Thing:
                def poke(self):
                    return 1

            thing = Thing()
        """),
         "mosaic_tpu/b.py": dedent("""
            from .a import thing

            def go():
                thing.poke()
         """)},
        [("mosaic_tpu/b.py::go", "mosaic_tpu/a.py::Thing.poke")]),
}


@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_graph_edges_as_jax(name):
    code, want = GRAPH_CASES[name]
    jg, tg = graphs(code)
    for caller, callee in want:
        assert callee in _callees(jg, caller, JP)
        assert _callees(tg, caller, TP) == _callees(jg, caller, JP)


def test_thread_edges_and_arg_offset():
    code = {"mosaic_tpu/t.py": dedent("""
        import threading

        def _work():
            pass

        def _job(tok):
            pass

        def go(pool, tok):
            threading.Thread(target=_work).start()
            pool.submit(_job, tok)
    """)}
    jg, tg = graphs(code)
    jt = {e.callee: e.arg_offset for e in jg.thread_edges()}
    tt = {e.callee.replace(TP, JP, 1): e.arg_offset
          for e in tg.thread_edges()}
    assert tt == jt
    assert tt["mosaic_tpu/t.py::_work"] == 0
    assert tt["mosaic_tpu/t.py::_job"] == 1


def test_lock_closure_is_transitive():
    code = {"mosaic_tpu/x.py": dedent("""
        import threading

        _lock = threading.Lock()

        def inner():
            with _lock:
                pass

        def outer():
            inner()
    """)}
    jg, tg = graphs(code)
    assert TP + "x.py::_lock" in tg.lock_closure()[TP + "x.py::outer"]
    assert {k.replace(TP, JP) for k in
            tg.lock_closure()[TP + "x.py::outer"]} == \
        jg.lock_closure()["mosaic_tpu/x.py::outer"]


# ---------------------------------- every port rule: bad fires, good silent

def _rule_fixtures():
    """Per port rule, a bad fixture that must fire and a good twin that
    must stay silent: the device rules' own, the others' from the ported
    cases (a case whose check passes on no findings is a good twin)."""
    out = {
        "device-raw-load": {
            "bad": dict(code={TP + "k.py": BAD_LOAD + "\n"}),
            "good": dict(code={TP + "k.py": 'from . import _kernels\n'
                               'f = _kernels.load("k")\n'})},
        "device-raw-h2d": {
            "bad": dict(code={TP + "k.py":
                              "def stage(x, dev):\n    return x.to(dev)\n"}),
            "good": dict(code={TP + "k.py": "def stage(x, dtype):\n"
                               "    return x.to(dtype)\n"})},
    }
    for c in PARITY_CASES:
        kw = {k: (v if k == "docs" else port(v)) for k, v in c.kw.items()}
        slot = "good" if c.check([]) else "bad"
        out.setdefault(c.rule, {}).setdefault(slot, kw)
    return out


_RULE_FIXTURES = _rule_fixtures()


@pytest.mark.parametrize("rule_id", sorted(r.id for r in tlint.all_rules()))
def test_every_rule_fires_on_bad_and_not_on_good(rule_id):
    fx = _RULE_FIXTURES.get(rule_id, {})
    assert set(fx) == {"bad", "good"}, f"rule {rule_id} lacks a fixture"
    assert run_t(rule_id, **fx["bad"]), f"rule {rule_id} is vacuous"
    assert run_t(rule_id, **fx["good"]) == [], rule_id


# -------------------------------------------------- the real tree, once

@pytest.fixture(scope="module")
def tree_report():
    """One CLI run over the real tree: --check --json."""
    r = _cli(["--check", "--json"])
    return r.returncode, json.loads(r.stdout), r.stderr


@pytest.fixture(scope="module")
def tree_repo():
    """The tree's Repo, parsed once, for the cheap per-module checks."""
    return tlint.Repo.from_root(REPO_ROOT)


def test_repo_is_clean_under_committed_baseline(tree_report):
    rc, out, err = tree_report
    assert rc == 0, json.dumps(out["findings"]) + err
    assert out["counts"]["new"] == 0
    assert out["counts"]["stale_baseline"] == 0


def test_baseline_reasons_are_real(tree_report):
    with open(os.path.join(REPO_ROOT, "tools",
                           "graftlint_torch_baseline.json")) as fh:
        data = json.load(fh)
    reasons = [e["reason"] for e in data["findings"].values()]
    assert reasons and not [r for r in reasons if r.startswith("TODO")]
    assert len(set(reasons)) == len(reasons), "each entry its own reason"
    rules = {k.split("::")[0] for k in data["findings"]}
    assert rules == {"device-raw-h2d", "contract-fault-coverage"}
    _, out, _ = tree_report
    sites = sorted(f["message"].split("'")[1] for f in out["baselined"]
                   if f["rule"] == "contract-fault-coverage")
    assert sites == ["gpkg.read", "gtiff.read", "mvt.decode",
                     "netcdf.read_var"]


def test_trial_run_findings_resolved(tree_repo):
    """What a first run over the port found is gone: the obs switches'
    markers, the stream-fed generator's suppression and the three conf
    keys.  Without the markers the same rules fire again."""
    for rule_id in ("lock-unguarded-attr", "cancel-checkpoint",
                    "contract-conf-docs", "contract-conf-key"):
        assert tlint.run_lint(tree_repo, [rule_id]) == [], rule_id
    paths = [TP + p for p in ("obs/metrics.py", "obs/recorder.py",
                              "obs/tracer.py", "parallel/pip_join.py")]
    stripped = {}
    for p in paths:
        text = tree_repo.module(p).text
        stripped[p] = "\n".join(ln for ln in text.splitlines()
                                if "graftlint: ignore" not in ln)
    unmarked = tlint.Repo.from_sources(code=stripped)
    assert len(tlint.run_lint(unmarked, ["lock-unguarded-attr"])) == 6
    assert [f.path for f in tlint.run_lint(
        unmarked, ["cancel-checkpoint"])] == [TP + "parallel/pip_join.py"]


def test_tree_scope(tree_repo):
    paths = {m.path for m in tree_repo.all_code_modules()}
    assert "chip_smoke.py" in paths and "bench.py" not in paths
    assert not [p for p in paths if p.startswith(JP)]
    assert {p for p in paths if p.startswith("tools/")} == {
        "tools/" + f for f in os.listdir(os.path.join(REPO_ROOT, "tools"))
        if f.endswith("_torch.py")}
    assert all(os.path.basename(p).startswith(("test_torch_", "torch_"))
               for p, _ in tree_repo.test_files)
    assert os.path.relpath(__file__, REPO_ROOT) in \
        {p for p, _ in tree_repo.test_files}
