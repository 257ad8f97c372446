"""The device a computation runs on when its inputs name none."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The card, for inputs that name no device; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")
