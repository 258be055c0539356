"""graftlint for the port: repo-native static analysis of mosaic_tpu_torch.

Port of ``mosaic_tpu.lint``, a copy rather than a re-export: the same
framework, graph and rules, pointed at ``mosaic_tpu_torch/``, its end-to-end
script ``chip_smoke.py``, ``tools/*_torch.py`` and the port's tests
(``tests/test_torch_*.py``, ``tests/torch_*.py``), with ``docs/`` as the
conf-key reference both packages share.  The test suite proves the
port's dynamic invariants for the paths it runs; this package proves
the code shape that keeps them true everywhere, at lint time.

Five rule families (``python tools/graftlint_torch.py --list-rules``):

* ``device-*``   — the port's choke points, the counterpart of the JAX
  package's ``jit-*``: no library loaded or ``nvcc`` run outside
  ``_kernels.py`` / ``native/``, no bare ``.cuda()`` / ``.to(device)``
  bypassing ``perf.pipeline`` staging (``jit-host-sync`` has no
  counterpart: nothing in the port is traced);
* ``lock-*``     — lock discipline: classes holding a ``_lock`` mutate
  shared attributes under it; module globals in lock-bearing modules
  mutate under the module lock; no lock-order cycle, no re-entered
  ``Lock``;
* ``thread-*`` / ``resource-*`` — thread-escape and memwatch
  register/release pairing over the whole-repo call graph;
* ``contract-*`` — contract drift: conf keys vs. ``config.py``
  validators vs. docs, metric names vs. OpenMetrics rules, recorder
  events vs. the declared catalogue, fault sites vs. chaos coverage;
* ``cancel-*``   — cooperative-cancellation coverage: chunk loops and
  operator boundaries call the inflight checkpoint.

Pure stdlib (``ast`` + ``re`` + ``json``): it imports neither torch nor
jax nor anything of ``mosaic_tpu``.  Driven by
``tools/graftlint_torch.py``; per-line suppressions (``# graftlint:
ignore[rule-id] — reason``) and a committed baseline
(``tools/graftlint_torch_baseline.json``) grandfather intentional or
historical findings without silencing the rule.
"""

from .core import (Finding, Module, Repo, RULES, all_rules, run_lint,
                   load_baseline, apply_baseline, baseline_from_findings)

# importing the rule modules registers them with core.RULES
from . import rules_device   # noqa: F401  (registration side effect)
from .rules_device import JAX_COUNTERPARTS, NO_COUNTERPART
from . import rules_locks    # noqa: F401
from . import rules_contracts  # noqa: F401
from . import rules_cancel   # noqa: F401
from . import rules_lockorder  # noqa: F401  (graph rules)
from . import rules_threads  # noqa: F401
from . import rules_release  # noqa: F401

__all__ = ["Finding", "Module", "Repo", "RULES", "all_rules",
           "run_lint", "load_baseline", "apply_baseline",
           "baseline_from_findings", "JAX_COUNTERPARTS", "NO_COUNTERPART"]
