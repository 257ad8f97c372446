"""Checkpoint save and restore with torch.save / torch.load, the port's
counterpart of geo4d_tpu/models/checkpoint.py (orbax there).

Two kinds, as the JAX launcher writes them: a params-only checkpoint
({"unet": {name: tensor}}, the EMA weights, loadable into a UNet with
`load_unet_weights`), and the full train state (master weights, AdamW
moments, EMA and step: `TrainState.state_dict()`), which `restore_train_state`
turns back into a TrainState bit for bit. A checkpoint is one file, written
to a temporary name and renamed, so a reader never sees half of one.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def save_checkpoint(path: str, obj: Any) -> str:
    """Write a (nested) dict of tensors and numbers to `path`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, device="cpu") -> Any:
    """Read what `save_checkpoint` wrote, with its tensors on `device`."""
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)


def restore_train_state(path: str, device="cpu"):
    """The TrainState a full-state checkpoint holds."""
    from geo4d_tpu_torch.training.step import TrainState

    return TrainState(**restore_checkpoint(path, device))


def load_unet_weights(unet: torch.nn.Module, path: str) -> None:
    """Load a params-only checkpoint's UNet weights (cast to the module's
    dtypes), strictly."""
    unet.load_state_dict(restore_checkpoint(path)["unet"], strict=True)
