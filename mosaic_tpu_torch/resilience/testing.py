"""Pytest fixtures so chaos tests are ordinary tests.

Port copy of ``mosaic_tpu.resilience.testing``: the fixtures arm and
disarm the port's own plan (``mosaic_tpu_torch.resilience.faults``).
Import them into a test module (or a conftest) with::

    from mosaic_tpu_torch.resilience.testing import fault_plan  # noqa: F401

In a module that also has the JAX package's fixtures of the same names,
the import shadows them there; a test that arms both packages arms each
through its own ``faults.arm`` with the same spec string.  In a
test::

    def test_checkpoint_rides_out_transient_io(fault_plan):
        plan = fault_plan("seed=7;site=checkpoint.write,fails=2")
        ...  # first two writes raise InjectedOSError, third succeeds
"""

from __future__ import annotations

import pytest

from . import faults

__all__ = ["fault_plan", "no_faults"]


@pytest.fixture
def fault_plan():
    """Arm a fault plan for one test; restore the prior plan after.

    Yields an ``arm(spec_or_plan) -> FaultPlan`` callable; whatever was
    armed before the test (e.g. a chaos-lane env plan) is re-armed on
    teardown, so tests compose with ``MOSAIC_TPU_FAULT_PLAN`` lanes.
    """
    prev = faults.active()

    def _arm(spec_or_plan) -> faults.FaultPlan:
        return faults.arm(spec_or_plan)

    try:
        yield _arm
    finally:
        if prev is None:
            faults.disarm()
        else:
            faults.arm(prev)


@pytest.fixture
def no_faults():
    """Disarm injection for one test; restore the prior plan after.

    For tests asserting clean-path behavior (byte parity, probe no-ops)
    that must hold even under a chaos-lane ``MOSAIC_TPU_FAULT_PLAN``.
    """
    prev = faults.active()
    faults.disarm()
    try:
        yield
    finally:
        if prev is not None:
            faults.arm(prev)
