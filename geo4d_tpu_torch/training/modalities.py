"""Modality batch builders: raw geometry -> diffusion training batches, port
of geo4d_tpu/training/modalities.py (all ten branches of the reference's
ddpm3d.py `shared_step`: rgb, pc, pc_ray, pc_ray_cross_depth, pc_task,
img_vidpc, multipc, multipc_dynamic, novelview, multimodality).

The shipped `pc_ray_cross_depth`: z0 = [pointmap 4 | raymap 4 | crossmap 4 |
inverse depth 4] VAE latents, c_concat = the video latent, context =
[prompt | per-frame image tokens]; classifier-free dropout draws u ~ U[0, 1)
per element: u < 2p drops the TEXT (null prompt), p <= u < 3p drops the
IMAGE (zeroed frames through CLIP). Single-channel inverse depth is
repeated to 3 channels before the encode.

The frozen towers (VAE encoder, CLIP image tower, resampler) run under
`torch.no_grad()`. Draws (a `core.draws.Draws` or `GivenDraws`), in the
JAX builders' key order: one posterior noise per encode, then the dropout
uniforms.
"""

from __future__ import annotations

from typing import Dict

import torch

from geo4d_tpu_torch.core.timing import span
from geo4d_tpu_torch.models.diffusion import GeoDiffusion

Batch = Dict[str, torch.Tensor]


def _encode(model: GeoDiffusion, frames: torch.Tensor, draws) -> torch.Tensor:
    """(B, T, H, W, 3) -> scaled posterior samples (B, T, h, w, 4), the noise
    drawn from `draws` (the JAX builders sample the posterior). A span
    "build_encode"."""
    with span("build_encode"):
        b, t = frames.shape[:2]
        mean, logvar = model.vae.encode(frames.reshape(b * t, *frames.shape[2:]))
        z = model.scale_factor * (mean + torch.exp(0.5 * logvar) * draws.normal(mean.shape))
        return z.reshape(b, t, *z.shape[1:])


def _cfg_dropout_masks(draws, batch_size: int, uncond_prob: float, enabled: bool, device):
    """(drop_text (B,), drop_image (B,)) booleans."""
    if not enabled or uncond_prob <= 0:
        z = torch.zeros((batch_size,), dtype=torch.bool, device=device)
        return z, z
    u = draws.uniform((batch_size,)).to(device)
    return u < 2 * uncond_prob, (u >= uncond_prob) & (u < 3 * uncond_prob)


def _conditioning(model: GeoDiffusion, video: torch.Tensor, prompt_emb: torch.Tensor,
                  null_prompt_emb: torch.Tensor, draws, uncond_prob: float,
                  random_uncond: bool) -> torch.Tensor:
    """[prompt (77) | image tokens (T * 16)] with the CFG dropout applied
    (CLIP and the resampler): a span "build_context"."""
    with span("build_context"):
        b = video.shape[0]
        drop_text, drop_image = _cfg_dropout_masks(draws, b, uncond_prob, random_uncond,
                                                   video.device)
        prompt = torch.where(drop_text[:, None, None], null_prompt_emb.expand_as(prompt_emb),
                             prompt_emb)
        frames_in = torch.where(drop_image[:, None, None, None, None], torch.zeros_like(video),
                                video)
        img_ctx = model.embed_frames(frames_in)
        return torch.cat([prompt, img_ctx.to(prompt.dtype)], dim=1)


def _out(z0, c_concat, context, batch) -> Batch:
    return {"z0": z0, "c_concat": c_concat, "context": context, "fs": batch["fps"]}


def build_batch_pc_ray_cross_depth(model, batch, draws, prompt_emb, null_prompt_emb,
                                   uncond_prob=0.05, random_uncond=True) -> Batch:
    """The shipped 16-ch geometry modality (ddpm3d.py:1661-1768).

    batch keys: normed_allpts, plucker_raymap, plucker_cross (B,T,H,W,3);
    inverse_depth (B,T,H,W,1); video (B,T,H,W,3); fps (B,)."""
    z_pc = _encode(model, batch["normed_allpts"], draws)
    z_ray = _encode(model, batch["plucker_raymap"], draws)
    z_cross = _encode(model, batch["plucker_cross"], draws)
    z_depth = _encode(model, batch["inverse_depth"].repeat_interleave(3, dim=-1), draws)
    z_video = _encode(model, batch["video"], draws)
    context = _conditioning(model, batch["video"], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    return _out(torch.cat([z_pc, z_ray, z_cross, z_depth], dim=-1), z_video, context, batch)


def build_batch_pc_ray(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob=0.05,
                       random_uncond=True) -> Batch:
    """8-ch [pointmap | raymap] modality."""
    z_pc = _encode(model, batch["normed_allpts"], draws)
    z_ray = _encode(model, batch["plucker_raymap"], draws)
    z_video = _encode(model, batch["video"], draws)
    context = _conditioning(model, batch["video"], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    return _out(torch.cat([z_pc, z_ray], dim=-1), z_video, context, batch)


def build_batch_pc(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob=0.05,
                   random_uncond=True) -> Batch:
    """4-ch pointmap-only modality."""
    z_pc = _encode(model, batch["normed_allpts"], draws)
    z_video = _encode(model, batch["video"], draws)
    context = _conditioning(model, batch["video"], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    return _out(z_pc, z_video, context, batch)


def build_batch_rgb(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob=0.05,
                    random_uncond=True) -> Batch:
    """Plain video-diffusion modality (the DynamiCrafter base task)."""
    z = _encode(model, batch["video"], draws)
    context = _conditioning(model, batch["video"], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    return _out(z, z, context, batch)


def build_batch_multipc(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob=0.05,
                        random_uncond=True) -> Batch:
    """12-ch [pointmap_t0 | pointmap_t1 | video] two-view modality; batch
    carries normed_allpts and normed_allpts_1 (the second view's points)."""
    z_pc0 = _encode(model, batch["normed_allpts"], draws)
    z_pc1 = _encode(model, batch["normed_allpts_1"], draws)
    z_video = _encode(model, batch["video"], draws)
    context = _conditioning(model, batch["video"], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    return _out(torch.cat([z_pc0, z_pc1, z_video], dim=-1), z_video, context, batch)


def build_batch_img_vidpc(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob=0.05,
                          random_uncond=True) -> Batch:
    """8-ch [video | pointmap] joint modality: c_concat is the FIRST frame's
    latent repeated over time."""
    z_video = _encode(model, batch["video"], draws)
    z_pc = _encode(model, batch["normed_allpts"], draws)
    c_concat = z_video[:, :1].expand_as(z_video).contiguous()
    context = _conditioning(model, batch["video"], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    return _out(torch.cat([z_video, z_pc], dim=-1), c_concat, context, batch)


def build_batch_pc_task(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob=0.05,
                        random_uncond=True) -> Batch:
    """pc modality + per-element integer task ids, routed to the UNet's task
    embedding (batch carries 'task' (B,))."""
    out = build_batch_pc(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob,
                         random_uncond)
    out["task"] = batch["task"].to(torch.int32)
    return out


def build_batch_multimodality(model, batch, draws, prompt_emb, null_prompt_emb,
                              uncond_prob=0.05, random_uncond=True) -> Batch:
    """16-ch [pointmap | normal map | optical flow | object coordinates]
    latents, each encoded from its own 3-ch map; c_concat = video latent.
    The reference's 'objectcooridnate' spelling is accepted too."""
    obj = batch.get("objectcoordinate", batch.get("objectcooridnate"))
    z_pc = _encode(model, batch["normed_allpts"], draws)
    z_normal = _encode(model, batch["normalmap"], draws)
    z_flow = _encode(model, batch["opticalflow"], draws)
    z_obj = _encode(model, obj, draws)
    z_video = _encode(model, batch["video"], draws)
    context = _conditioning(model, batch["video"], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    return _out(torch.cat([z_pc, z_normal, z_flow, z_obj], dim=-1), z_video, context, batch)


def build_batch_novelview(model, batch, draws, prompt_emb, null_prompt_emb, uncond_prob=0.05,
                          random_uncond=True, temporal_length: int = 16) -> Batch:
    """8-ch novel-view modality: V views x T frames stacked along time; the
    model denoises the LAST view's [pointmap | video] latents conditioned on
    the FIRST view's video latent concatenated with the last view's raw
    Plücker raymap (latent resolution), CLIP from the first view's frames.

    batch keys: normed_allpts, video (B, V*T, H, W, 3); plucker_raymap_all
    (B, V*T, h, w, C); fps (B,)."""
    t = temporal_length
    z_allview = _encode(model, batch["normed_allpts"], draws)
    z_video_allview = _encode(model, batch["video"], draws)
    raymap_last = batch["plucker_raymap_all"][:, -t:]
    context = _conditioning(model, batch["video"][:, :t], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    z_video = z_video_allview[:, :t]
    c_concat = torch.cat([z_video, raymap_last.to(z_video.dtype)], dim=-1)
    z0 = torch.cat([z_allview[:, -t:], z_video_allview[:, -t:]], dim=-1)
    return _out(z0, c_concat, context, batch)


def build_batch_multipc_dynamic(model, batch, draws, prompt_emb, null_prompt_emb,
                                uncond_prob=0.05, random_uncond=True,
                                temporal_length: int = 16) -> Batch:
    """Multi-view pointmaps + dynamic masks: z0 = [every view's pointmap
    latents (V*4) | every view's mask latents (V*4) | the other views' video
    latents ((V-1)*4)]; c_concat = the first view's video latent; CLIP from
    the first view's frames. batch keys: normed_allpts, dynamic_mask, video
    (B, V*T, H, W, 3); fps (B,)."""
    t = temporal_length
    v = batch["video"].shape[1] // t

    def split_cat(z):  # (B, V*T, h, w, 4) -> (B, T, h, w, V*4)
        return torch.cat([z[:, i * t:(i + 1) * t] for i in range(v)], dim=-1)

    z_all = _encode(model, batch["normed_allpts"], draws)
    z_mask = _encode(model, batch["dynamic_mask"], draws)
    z_video_all = _encode(model, batch["video"], draws)
    z_other = torch.cat([z_video_all[:, i * t:(i + 1) * t] for i in range(1, v)], dim=-1)
    context = _conditioning(model, batch["video"][:, :t], prompt_emb, null_prompt_emb, draws,
                            uncond_prob, random_uncond)
    z0 = torch.cat([split_cat(z_all), split_cat(z_mask), z_other], dim=-1)
    return _out(z0, z_video_all[:, :t], context, batch)


MODALITY_BUILDERS = {
    "pc_ray_cross_depth": build_batch_pc_ray_cross_depth,
    "pc_ray": build_batch_pc_ray,
    "pc": build_batch_pc,
    "pc_task": build_batch_pc_task,
    "rgb": build_batch_rgb,
    "multipc": build_batch_multipc,
    "multipc_dynamic": build_batch_multipc_dynamic,
    "img_vidpc": build_batch_img_vidpc,
    "novelview": build_batch_novelview,
    "multimodality": build_batch_multimodality,
}


@torch.no_grad()
def build_batch(modality: str, *args, **kwargs) -> Batch:
    """The named modality's builder, with the frozen towers under no_grad: a
    span "build" (`core.timing`) holding one "build_encode" per VAE encode
    and one "build_context"."""
    if modality not in MODALITY_BUILDERS:
        raise NotImplementedError(f"modality {modality!r}; available: {sorted(MODALITY_BUILDERS)}")
    with span("build"):
        return MODALITY_BUILDERS[modality](*args, **kwargs)
