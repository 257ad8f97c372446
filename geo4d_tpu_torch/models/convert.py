"""Weights bridge: a JAX param tree -> this package's state dict.

The port's modules carry the original Geo4D PyTorch key names, so the
mapping is geo4d_tpu/models/convert.py's (a numpy-only module): its
`*_torch_key` functions name each leaf's key and `inverse_transform` puts
each array in PyTorch's layout. Published checkpoints load the same way,
through `strip_prefixes`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from geo4d_tpu.models.convert import (
    clip_vision_torch_key,
    inverse_transform,
    resampler_torch_key,
    unet_torch_key,
    vae_torch_key,
)

KEY_FNS = {
    "unet": unet_torch_key,
    "vae": vae_torch_key,
    "pointmap_vae": vae_torch_key,
    "clip_img": clip_vision_torch_key,
    "resampler": resampler_torch_key,
}

# tower -> attribute of GeoDiffusion holding it
TOWER_MODULES = {"unet": "unet", "vae": "vae", "pointmap_vae": "pointmap_vae",
                 "clip_img": "image_encoder", "resampler": "resampler"}


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[List[str], Any]]:
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out.extend(_leaves(v, path + (str(k),)))
        return out
    return [(list(path), tree)]


def state_dict_from_jax(params: Any, tower: str) -> Dict[str, torch.Tensor]:
    """One tower's JAX param tree ({'params': ...}, arrays as numpy or JAX
    arrays) -> the state dict of the matching module of this package.
    Raises on a leaf with no mapping rule."""
    key_fn = KEY_FNS[tower]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        key = key_fn(path)
        if key is None:
            raise KeyError(f"{tower}: no torch key for {'/'.join(path)}")
        arr = inverse_transform(path[-1], np.asarray(leaf, dtype=np.float32))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_from_jax(model: torch.nn.Module, params: Dict[str, Any]) -> None:
    """Load every tower present in a JAX `init_params`-style dict into a
    GeoDiffusion, strictly."""
    for tower, attr in TOWER_MODULES.items():
        module = getattr(model, attr)
        if tower in params:
            module.load_state_dict(state_dict_from_jax(params[tower], tower), strict=True)
