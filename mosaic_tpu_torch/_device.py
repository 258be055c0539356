"""Device resolution for the port's entry points.

Entry points that create device state run on CUDA unless the caller asks
for the CPU.  With no CUDA device and no explicit request they raise:
nothing carries on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (RuntimeError if there is
    none); anything else -> that device, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mosaic_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
