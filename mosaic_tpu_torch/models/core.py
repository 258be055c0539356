"""Model-layer scaffolding: iterative and binary transformers.

Port of ``mosaic_tpu.models.core``.  Reference counterparts:
models/core/IterativeTransformer.scala:16 (generic iterate-until-converged
transform with early stopping) and models/core/BinaryTransformer.scala
(two-dataset left/right transformer with per-side pre-transforms).  A
transformer drives device steps from a host loop: iteration control flow
is host-side (it is data-dependent), each step body is a kernel launch or
a few torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class IterationState:
    """What survives between iterations (and what checkpoints persist)."""

    iteration: int
    payload: Any                     # transformer-specific dict of arrays
    converged: bool = False
    metrics: Optional[dict] = None


class IterativeTransformer:
    """Iterate ``step`` until ``early_stop`` or ``max_iterations``.

    Subclasses implement ``step(state) -> IterationState`` and
    ``early_stop(prev, cur) -> bool``.  A CheckpointManager (see
    checkpoint.py) can be attached to persist state at iteration
    boundaries and resume after failure — the reference persists interim
    matches to Delta between KNN iterations
    (models/util/CheckpointManager.scala:12-45)."""

    def __init__(self, max_iterations: int = 10, checkpoint=None):
        self.max_iterations = int(max_iterations)
        self.checkpoint = checkpoint

    # -- to be provided by subclasses
    def initial_state(self, *datasets) -> IterationState:
        raise NotImplementedError

    def step(self, state: IterationState) -> IterationState:
        raise NotImplementedError

    def early_stop(self, prev: IterationState,
                   cur: IterationState) -> bool:
        return cur.converged

    # -- the iteration loop
    def iterative_transform(self, *datasets) -> IterationState:
        state = None
        if self.checkpoint is not None:
            state = self.checkpoint.load_latest()
        if state is None:
            state = self.initial_state(*datasets)
        while state.iteration < self.max_iterations and \
                not state.converged:
            prev = state
            state = self.step(prev)
            state.iteration = prev.iteration + 1
            if self.early_stop(prev, state):
                state.converged = True
            if self.checkpoint is not None:
                self.checkpoint.save(state)
        return state


class BinaryTransformer(IterativeTransformer):
    """Left/right two-dataset transformer with optional pre-transforms
    (reference: BinaryTransformer.leftTransform/rightTransform)."""

    def __init__(self, max_iterations: int = 10, checkpoint=None,
                 left_transform: Optional[Callable] = None,
                 right_transform: Optional[Callable] = None):
        super().__init__(max_iterations, checkpoint)
        self.left_transform = left_transform
        self.right_transform = right_transform

    def transform(self, left, right):
        if self.left_transform is not None:
            left = self.left_transform(left)
        if self.right_transform is not None:
            right = self.right_transform(right)
        return self.iterative_transform(left, right)
