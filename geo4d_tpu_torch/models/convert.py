"""Published checkpoints -> this package's modules.

The port's modules carry the original Geo4D PyTorch key names, so a
published `.ckpt` state dict loads into each tower once its prefix is
stripped: the model checkpoint holds every tower but the pointmap VAE under
CKPT_PREFIXES, and `vae.ckpt` holds the pointmap VAE under `model.`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import torch

# tower -> attribute of GeoDiffusion holding it
TOWER_MODULES = {"unet": "unet", "vae": "vae", "pointmap_vae": "pointmap_vae",
                 "clip_text": "text_encoder", "clip_img": "image_encoder",
                 "resampler": "resampler"}

# key prefix of each tower in the published model checkpoint
CKPT_PREFIXES = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
                 "clip_text": "cond_stage_model.model.", "clip_img": "embedder.model.",
                 "resampler": "image_proj_model."}


def strip_prefixes(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Unwrap the Lightning (`state_dict`) and DeepSpeed (`module`, keys
    under `_forward_module.`) layouts, and rename the reference's
    `framestride_embed` to `fps_embedding`."""
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    if "module" in state_dict and isinstance(state_dict["module"], dict):
        state_dict = {k[len("_forward_module."):]: v for k, v in state_dict["module"].items()}
    return {k.replace("framestride_embed", "fps_embedding"): v for k, v in state_dict.items()}


def load_tower(module: torch.nn.Module, state_dict: Mapping, prefix: str = "",
               name: str = "") -> int:
    """Load the tensors under `prefix` into `module`. Every tensor of the
    module must be present (tensors the module does not have are ignored:
    a checkpoint carries other towers and unused layers). Raises KeyError
    listing the missing ones. Returns the count of tensors loaded."""
    want = module.state_dict().keys()
    sub = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    missing = [k for k in want if k not in sub]
    if missing:
        raise KeyError(f"{name or prefix}: {len(missing)} of {len(want)} tensors missing from "
                       f"the checkpoint, e.g. {missing[:3]}")
    module.load_state_dict({k: sub[k] for k in want}, strict=True)
    return len(want)


def load_checkpoints(model: torch.nn.Module, ckpt_path: Optional[str] = None,
                     vae_ckpt_path: Optional[str] = None, verbose: bool = True
                     ) -> Dict[str, int]:
    """Fill a GeoDiffusion from the published checkpoints: the model .ckpt
    (Lightning or DeepSpeed layout) for every tower the model has, and
    `vae.ckpt` for the pointmap VAE. Plain tensor checkpoints only
    (`weights_only` unpickling). Returns {tower: tensors loaded}; a tower
    with tensors missing raises."""
    reports: Dict[str, int] = {}
    if ckpt_path:
        sd = strip_prefixes(torch.load(ckpt_path, map_location="cpu", weights_only=True))
        for tower, prefix in CKPT_PREFIXES.items():
            module = getattr(model, TOWER_MODULES[tower])
            if module is not None:
                reports[tower] = load_tower(module, sd, prefix, tower)
    if vae_ckpt_path:
        if model.pointmap_vae is None:
            raise ValueError(f"{vae_ckpt_path}: the model has no pointmap VAE to load it into")
        raw = torch.load(vae_ckpt_path, map_location="cpu", weights_only=True)
        reports["pointmap_vae"] = load_tower(model.pointmap_vae, raw.get("state_dict", raw),
                                             "model.", "pointmap_vae")
    if verbose:
        for tower, used in reports.items():
            print(f"[ckpt] {tower}: {used} tensors loaded, 0 missing")
    return reports
