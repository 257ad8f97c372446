"""Checkpoint save and restore with torch.save / torch.load, the port's
counterpart of geo4d_tpu/models/checkpoint.py (orbax there).

Two kinds, as the JAX launcher writes them: a params-only checkpoint
({"unet": {name: tensor}}, the EMA weights, loadable into a UNet with
`load_unet_weights`), and the full train state (master weights, AdamW
moments, EMA and step: `TrainState.state_dict()`), which `restore_train_state`
turns back into a TrainState bit for bit. A checkpoint is one file, written
to a temporary name and renamed, so a reader never sees half of one.

Across ranks (`mesh=`, with the run's `ShardLayout`), `save_train_state`
and `save_ema` gather every sharded tensor to rank 0, which alone writes the
same full checkpoint a one-process run writes; `restore_train_state` with a
layout reads the full checkpoint on every rank and keeps each rank's slices,
so a run may resume at another world size.
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


def _gathered(tensors, mesh, layout):
    """Full tensors on the CPU at rank 0 (None elsewhere), or `tensors`
    unchanged without a mesh."""
    if mesh is None:
        return tensors
    from geo4d_tpu_torch.parallel.sharding import ShardLayout, gather_state_dict

    layout = layout or ShardLayout.replicated(list(tensors), mesh)
    return gather_state_dict(tensors, layout, mesh, keep=mesh.rank == 0)


def save_train_state(path: str, state, mesh=None, layout=None) -> None:
    """Write the full train state (`TrainState.state_dict()`); under a mesh
    the shards are gathered to rank 0, which writes."""
    parts = {k: _gathered(getattr(state, k), mesh, layout)
             for k in ("params", "exp_avg", "exp_avg_sq", "ema")}
    if mesh is None or mesh.rank == 0:
        save_checkpoint(path, dict(parts, step=state.step))
    if mesh is not None:
        mesh.barrier()


def save_ema(path: str, state, mesh=None, layout=None) -> None:
    """Write the params-only checkpoint {"unet": EMA weights}, gathered to
    rank 0 under a mesh."""
    ema = _gathered(state.ema, mesh, layout)
    if mesh is None or mesh.rank == 0:
        save_checkpoint(path, {"unet": ema})
    if mesh is not None:
        mesh.barrier()


def restore_train_state(path: str, device="cpu", layout=None):
    """The TrainState a full-state checkpoint holds; with a ShardLayout,
    this rank's slices of its sharded parameters."""
    from geo4d_tpu_torch.training.step import TrainState

    if layout is None:
        return TrainState(**restore_checkpoint(path, device))
    state = restore_checkpoint(path, "cpu")     # sliced on the host, then moved
    for k in ("params", "exp_avg", "exp_avg_sq", "ema"):
        state[k] = {n: layout.local(n, t).to(device) for n, t in state[k].items()}
    return TrainState(**state)


def load_unet_weights(unet: torch.nn.Module, path: str) -> None:
    """Load a params-only checkpoint's UNet weights (cast to the module's
    dtypes), strictly."""
    unet.load_state_dict(restore_checkpoint(path)["unet"], strict=True)
