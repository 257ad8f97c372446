"""Model FLOPs of one unit of work, counted by the benchmark on its own
reference at the cell's shapes, on the meta device (no memory, no device
time): `torch.utils.flop_counter.FlopCounterMode` counts the matrix
products and convolutions, forward and backward. The count is the same
whatever implements the work, so replacing a kernel cannot move it."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import models


def _count(fn) -> float:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return float(mode.get_total_flops())


def _meta_model(model_cfg: dict):
    return models.build("geo4d_ref", model_cfg, torch.float32, device="meta")


def reconstruct_flops(model_cfg: dict, frames: int, hw, windows: int, window: int,
                      ddim_steps: int) -> dict:
    """FLOPs of one reconstruct by stage: the towers over every frame (CLIP
    image tower, VAE encoder) and every window (resampler), the UNet at each
    DDIM step of each window, and each window's 4-head decode."""
    m = _meta_model(model_cfg)
    h, w = hw
    dev = "meta"
    from geo4d_ref.nn.clip import clip_preprocess

    chunk = 16
    video = torch.empty((chunk, h, w, 3), device=dev)
    clip = _count(lambda: m.image_encoder(clip_preprocess(video))) * frames / chunk
    enc = _count(lambda: m.vae.encode(video)) * frames / chunk
    width = model_cfg["image_encoder"]["width"]
    tokens = torch.empty((1, window, 257, width), device=dev)
    res = _count(lambda: m.resample_tokens(tokens)) * windows
    lh, lw = h // 8, w // 8
    unet_cfg = model_cfg["unet"]
    x = torch.empty((1, window, lh, lw, unet_cfg["in_channels"]), device=dev)
    t = torch.zeros((1,), dtype=torch.int32, device=dev)
    ctx = torch.empty((1, 77 + window * model_cfg["resampler"]["num_queries"],
                       unet_cfg["context_dim"]), device=dev)
    fs = torch.full((1,), 24, dtype=torch.int32, device=dev)
    unet = _count(lambda: m.unet(x, t, ctx, fs)) * ddim_steps * windows
    z = torch.empty((1, window, lh, lw, unet_cfg["out_channels"]), device=dev)
    dec = _count(lambda: m.decode_geometry(z)) * windows
    return {"towers": clip + enc + res, "unet": unet, "decode": dec,
            "clip": clip, "vae_encode": enc, "resampler": res}


def train_step_flops(model_cfg: dict, batch: int, frames: int, hw, encodes: int) -> dict:
    """FLOPs of one training step: batch building (`encodes` VAE encodes of
    the clip, the CLIP image tower and the resampler) and the UNet's forward
    and backward."""
    m = _meta_model(model_cfg)
    h, w = hw
    dev = "meta"
    video = torch.empty((batch * frames, h, w, 3), device=dev)
    clip_video = torch.empty((batch, frames, h, w, 3), device=dev)
    build = _count(lambda: m.vae.encode(video)) * encodes
    build += _count(lambda: m.embed_frames(clip_video))
    unet_cfg = model_cfg["unet"]
    lh, lw = h // 8, w // 8
    for p in m.unet.parameters():
        p.requires_grad_(True)
    x = torch.empty((batch, frames, lh, lw, unet_cfg["in_channels"]), device=dev)
    t = torch.zeros((batch,), dtype=torch.int64, device=dev)
    ctx = torch.empty((batch, 77 + frames * model_cfg["resampler"]["num_queries"],
                       unet_cfg["context_dim"]), device=dev)
    fs = torch.full((batch,), 24, dtype=torch.int32, device=dev)

    def fwd_bwd():
        m.unet(x, t, ctx, fs).float().square().mean().backward()

    return {"build": build, "fwd_bwd": _count(fwd_bwd)}
