"""Shared CLI plumbing, port of geo4d_tpu/cli/common.py: model building,
checkpoint loading, conditioning.

The port's modules carry their weights, so "params" are the module's own
tensors. The JAX package casts its f32 parameter tree to bf16 for
inference; here the towers are built in their inference dtype from the
start (`dtype=`, bf16 for the shipped model), which leaves nothing to cast.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from geo4d_tpu_torch.alignment.optimizer import AlignerConfig
from geo4d_tpu_torch.data.tokenizer import CLIPTokenizer


def build_model_and_params(ckpt_path: Optional[str] = None, vae_ckpt_path: Optional[str] = None,
                           seed: int = 123, verbose: bool = True, device="cuda",
                           dtype=torch.bfloat16):
    """The shipped GeoDiffusion on `device`: seeded random-normal weights,
    overwritten by the published checkpoints where given."""
    from geo4d_tpu_torch.models.presets import flagship

    return _materialise(flagship(dtype=dtype), ckpt_path, vae_ckpt_path, seed, verbose, device)


def build_model_from_config(config_path: str, ckpt_path: Optional[str] = None,
                            vae_ckpt_path: Optional[str] = None, seed: int = 123,
                            verbose: bool = True, device="cuda", dtype=torch.bfloat16):
    """Reference-layout YAML -> (model on `device`, postprocess dict)."""
    from geo4d_tpu_torch.core.registry import build_from_yaml

    model, postprocess = build_from_yaml(config_path, dtype=dtype)
    return _materialise(model, ckpt_path, vae_ckpt_path, seed, verbose, device), postprocess


def build_model(args, device):
    """(model, postprocess or None) as a CLI's arguments ask: the tiny preset
    with random weights (`--tiny`; bf16 on the card, float32 on the CPU,
    where the kernels' plain versions run), a YAML config (`--config`), or
    the shipped model, with the checkpoints given."""
    if args.tiny:
        from geo4d_tpu_torch.models.presets import init_random_, tiny

        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        model = tiny(temporal_length=args.video_length, dtype=dtype, device="meta")
        return init_random_(model, device, seed=args.seed).eval(), None
    if args.config:
        return build_model_from_config(args.config, args.ckpt_path, args.vae_path, args.seed,
                                       device=device)
    return build_model_and_params(args.ckpt_path, args.vae_path, args.seed, device=device), None


def _materialise(model, ckpt_path, vae_ckpt_path, seed, verbose, device):
    from geo4d_tpu_torch.models.convert import load_checkpoints
    from geo4d_tpu_torch.models.presets import init_random_

    init_random_(model, torch.device(device), seed=seed)
    load_checkpoints(model, ckpt_path, vae_ckpt_path, verbose=verbose)
    return model.eval()


def aligner_config_from_postprocess(pp: dict, n_iter: Optional[int] = None) -> AlignerConfig:
    """Map the reference postprocess block (configs/inference_geo4d.yaml)
    onto AlignerConfig; unknown keys are ignored."""
    fn = {"smooth_l1": "l1", "l1": "l1", "l2": "l2"}.get(str(pp.get("flow_loss_fn", "l1")), "l1")
    return AlignerConfig(
        n_iter=int(n_iter if n_iter is not None else pp.get("n_iter", 500)),
        temporal_smoothing_weight=float(pp.get("temporal_smoothing_weight", 0.015)),
        translation_weight=float(pp.get("translation_weight", 1.0)),
        schedule=str(pp.get("pose_schedule", "linear")),
        shared_focal=not bool(pp.get("not_shared_focal", False)),
        flow_loss_weight=float(pp.get("flow_loss_weight", 0.0)),
        flow_loss_fn=fn,
        flow_loss_start_frac=float(pp.get("flow_loss_start_epoch", 0.1)),
        motion_mask_thre=float(pp.get("motion_mask_thre", 0.35)),
        depth_regularize_weight=float(pp.get("depth_regularize_weight", 0.0)),
    )


@torch.no_grad()
def compute_text_context(model, prompt: str, bpe_path: Optional[str] = None) -> np.ndarray:
    """Prompt -> (1, 77, ctx_dim) float32 context: the BPE tokenizer, then
    the model's text tower on its device."""
    dev = next(model.text_encoder.parameters()).device
    ids = torch.as_tensor(CLIPTokenizer(bpe_path)([prompt]), dtype=torch.long, device=dev)
    return model.embed_text(ids).cpu().numpy()


def prepare_inference_params(model, prompt: str, bpe_path: Optional[str] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Compute the prompt and empty-prompt contexts once (the unconditional
    CFG branch embeds the empty prompt), then drop the text tower, which
    inference never uses again. Returns (text_ctx, uncond_text_ctx), each
    (1, 77, ctx_dim) float32."""
    text_ctx = compute_text_context(model, prompt, bpe_path)
    uncond = text_ctx if prompt == "" else compute_text_context(model, "", bpe_path)
    model.text_encoder = None
    return text_ctx, uncond
