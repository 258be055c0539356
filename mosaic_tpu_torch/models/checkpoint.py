"""Iteration-boundary checkpointing for models.

Port of ``mosaic_tpu.models.checkpoint``, lean: the JAX package's fault
injection, metrics counter and write retry are left out.  Reference
counterpart: models/util/{CheckpointManager, DeltaFileCheckpoint,
DeltaTableCheckpoint}.scala — interim KNN matches written between
iterations so a failed job resumes mid-algorithm.  Here state is a flat
dict of arrays; checkpoints are npz files in a directory with a monotonic
iteration index and an atomic rename commit, so a crash mid-write never
corrupts the latest good state.
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Optional

import numpy as np
import torch

from .core import IterationState


def _host(v) -> np.ndarray:
    """A payload value as a host numpy array (tensors are pulled off their
    device)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class CheckpointManager:
    """npz-per-iteration checkpoint directory.

    save(state) writes ``iter_{n:04d}.npz`` atomically; load_latest()
    returns the newest complete state or None.  ``payload`` must be a
    flat dict of arrays or tensors; tensors are pulled to the host
    (checkpoints are host/storage artifacts), and a loaded payload holds
    numpy arrays."""

    def __init__(self, path: str, keep: int = 2):
        self.path = path
        self.keep = int(keep)
        os.makedirs(path, exist_ok=True)

    def _file(self, it: int) -> str:
        return os.path.join(self.path, f"iter_{it:04d}.npz")

    def save(self, state: IterationState) -> str:
        arrays = {k: _host(v) for k, v in state.payload.items()}
        arrays["__iteration"] = np.int64(state.iteration)
        arrays["__converged"] = np.bool_(state.converged)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, self._file(state.iteration))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._gc()
        return self._file(state.iteration)

    def _iterations(self):
        its = []
        for name in os.listdir(self.path):
            if name.startswith("iter_") and name.endswith(".npz"):
                try:
                    its.append(int(name[5:-4]))
                except ValueError:
                    pass
        return sorted(its)

    def _gc(self):
        for it in self._iterations()[:-self.keep]:
            os.unlink(self._file(it))

    def load_latest(self) -> Optional[IterationState]:
        """Newest complete state, falling back through older
        checkpoints when the latest is unreadable (a torn npz from a
        crashed writer must not strand the resume — degrade to the
        previous iteration instead)."""
        last_err: Optional[BaseException] = None
        for it in reversed(self._iterations()):
            try:
                with np.load(self._file(it)) as z:
                    payload = {k: z[k] for k in z.files
                               if not k.startswith("__")}
                    return IterationState(
                        iteration=int(z["__iteration"]),
                        payload=payload,
                        converged=bool(z["__converged"]))
            except (OSError, ValueError, KeyError, zipfile.BadZipFile
                    ) as e:
                last_err = e
                continue
        if last_err is not None:
            raise last_err
        return None
