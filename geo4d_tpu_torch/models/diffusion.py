"""GeoDiffusion: the towers of the Geo4D latent diffusion model and the
diffusion methods that tie them together, port of
geo4d_tpu/models/diffusion.py.

The 16-channel geometry latent of the shipped model is the
`pc_ray_cross_depth` layout [pointmap 4 | raymap 4 | crossmap 4 | inverse
depth 4]; `decode_modality` also decodes the reference's other layouts.
Conditioning is hybrid: the 4-channel video latent is concatenated on
channels and the context [text 77 | per-frame image tokens] goes to
cross-attention.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from geo4d_tpu_torch.core.schedules import DiffusionSchedule
from geo4d_tpu_torch.core.timing import span
from geo4d_tpu_torch.models.autoencoder import AutoencoderKL
from geo4d_tpu_torch.models.unet3d import UNet3D
from geo4d_tpu_torch.nn.clip import CLIPTextEncoder, CLIPVisionEncoder, clip_preprocess
from geo4d_tpu_torch.nn.resampler import Resampler
from geo4d_tpu_torch.sampling.ddim import DDIMTables, ddim_sample

SCALE_FACTOR = 0.18215


class GeoDiffusion(nn.Module):
    """Module bundle: `unet`, `vae`, `pointmap_vae` (with the confidence
    adaptor; optional), `text_encoder` (None once the text context is
    computed), `image_encoder`, `resampler`, plus the noise schedule and the
    latent layout `modality` that `decode_modality` decodes by default."""

    def __init__(self, unet: UNet3D, vae: AutoencoderKL, pointmap_vae: Optional[AutoencoderKL],
                 image_encoder: CLIPVisionEncoder, resampler: Resampler,
                 schedule: Optional[DiffusionSchedule] = None,
                 scale_factor: float = SCALE_FACTOR,
                 text_encoder: Optional[CLIPTextEncoder] = None,
                 modality: str = "pc_ray_cross_depth"):
        super().__init__()
        self.modality = modality
        self.unet = unet
        self.text_encoder = text_encoder
        self.vae = vae
        self.pointmap_vae = pointmap_vae
        self.image_encoder = image_encoder
        self.resampler = resampler
        self.schedule = schedule or DiffusionSchedule.create()
        self.scale_factor = scale_factor

    # ---------------- first stage (VAE) ----------------

    def encode_first_stage(self, frames: torch.Tensor,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, H, W, 3) in [-1, 1] -> scaled latents (B, T, h, w, 4): a
        posterior sample drawn from `generator`, or the mean without one."""
        b, t = frames.shape[:2]
        mean, logvar = self.vae.encode(frames.reshape(b * t, *frames.shape[2:]))
        z = mean
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            z = mean + torch.exp(0.5 * logvar) * noise
        z = self.scale_factor * z
        return z.reshape(b, t, *z.shape[1:])

    def encode_frames_chunked(self, frames: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              chunk: int = 16) -> torch.Tensor:
        """Flat (N, H, W, 3) -> (N, h, w, 4), `chunk` frames per encoder call."""
        return torch.cat([self.encode_first_stage(frames[i:i + chunk][None], generator)[0]
                          for i in range(0, frames.shape[0], chunk)])

    def _decode(self, vae: AutoencoderKL, z: torch.Tensor, method: str) -> torch.Tensor:
        b, t = z.shape[:2]
        out = getattr(vae, method)(z.reshape(b * t, *z.shape[2:]) / self.scale_factor)
        return out.reshape(b, t, *out.shape[1:])

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """4-channel latents -> 3-channel maps through the RGB VAE."""
        return self._decode(self.vae, z, "decode")

    def decode_pointmap_conf(self, z: torch.Tensor) -> torch.Tensor:
        """Pointmap latents -> (..., 4) = [xyz | confidence] through the
        pointmap VAE's confidence adaptor; without a pointmap VAE, the RGB
        VAE's decode with a confidence of 1."""
        if self.pointmap_vae is not None:
            return self._decode(self.pointmap_vae, z, "decode_with_conf")
        rgb = self.decode_first_stage(z)
        return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)

    def decode_geometry(self, samples: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, T, h, w, 16) -> pointmap_conf, raymap, crossmap, inv_depth maps.
        The three RGB-VAE heads decode as one 3x-frames batch; windows are
        decoded one at a time to bound the full-resolution working set. Each
        decode (the pointmap VAE's, the RGB VAE's) is a span "decode_head"
        (`core.timing`)."""
        outs = []
        for s in samples.split(1):
            with span("decode_head"):
                pc = self.decode_pointmap_conf(s[..., 0:4])
            with span("decode_head"):
                rgb3 = torch.cat([s[..., 4:8], s[..., 8:12], s[..., 12:16]], dim=0)
                ray, cross, depth3 = self.decode_first_stage(rgb3).split(1)
            outs.append({"pointmap_conf": pc, "raymap": ray, "crossmap": cross,
                         "inv_depth": depth3.mean(dim=-1, keepdim=True)})
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def decode_modality(self, samples: torch.Tensor, modality: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
        """Decode the latent layouts of the reference's inference branches
        (`modality` defaults to the model's own):
          pc_ray_cross_depth  [pc 4 | ray 4 | cross 4 | depth 4] (shipped;
                              `decode_geometry`)
          pc_ray              [pc 4 | ray 4]
          pc                  [pc 4]
          multipc             [pc0 4 | pc1 4 | video 4]
          img_vidpc           [video 4 | pc 4]
          rgb                 [video 4]"""
        modality = modality or self.modality
        if modality == "pc_ray_cross_depth":
            return self.decode_geometry(samples)
        if modality == "pc_ray":
            return {"pointmap_conf": self.decode_pointmap_conf(samples[..., 0:4]),
                    "raymap": self.decode_first_stage(samples[..., 4:8])}
        if modality == "pc":
            return {"pointmap_conf": self.decode_pointmap_conf(samples)}
        if modality == "multipc":
            return {"pointmap_conf": self.decode_pointmap_conf(samples[..., 0:4]),
                    "pointmap_conf_1": self.decode_pointmap_conf(samples[..., 4:8]),
                    "video": self.decode_first_stage(samples[..., 8:12])}
        if modality == "img_vidpc":
            return {"video": self.decode_first_stage(samples[..., 0:4]),
                    "pointmap_conf": self.decode_pointmap_conf(samples[..., 4:8])}
        if modality == "rgb":
            return {"video": self.decode_first_stage(samples)}
        raise NotImplementedError(f"modality {modality!r}")

    def encode_first_stage_perchannel(self, x: torch.Tensor,
                                      generator: Optional[torch.Generator] = None
                                      ) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T, h, w, 4 C): each channel repeated to
        three and encoded on its own, channel by channel."""
        return torch.cat([self.encode_first_stage(x[..., c:c + 1].expand(*x.shape[:-1], 3),
                                                  generator)
                          for c in range(x.shape[-1])], dim=-1)

    def decode_perchannel_conf(self, z: torch.Tensor) -> torch.Tensor:
        """12-channel latents -> (..., 4): three confidence decodes, each
        head's RGB reduced to its channel mean, the confidences averaged."""
        if z.shape[-1] % 3:
            raise ValueError(f"latent channels {z.shape[-1]} not divisible by 3")
        per = z.shape[-1] // 3
        outs = [self.decode_pointmap_conf(z[..., i * per:(i + 1) * per]) for i in range(3)]
        conf = torch.cat([o[..., 3:] for o in outs], dim=-1).mean(dim=-1, keepdim=True)
        return torch.cat([o[..., :3].mean(dim=-1, keepdim=True) for o in outs] + [conf], dim=-1)

    # ---------------- conditioners ----------------

    def clip_tokens_chunked(self, frames: torch.Tensor, chunk: int = 16) -> torch.Tensor:
        """Flat (N, H, W, 3) [-1, 1] frames -> (N, 257, width) CLIP tokens."""
        return torch.cat([self.image_encoder(clip_preprocess(frames[i:i + chunk]))
                          for i in range(0, frames.shape[0], chunk)])

    def embed_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(B, 77) int token ids -> (B, 77, ctx) float32 text context."""
        return self.text_encoder(token_ids)

    def resample_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T, 257, width) -> (B, T*16, ctx) image context."""
        return self.resampler(tokens)

    def embed_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) [-1, 1] -> (B, T*16, ctx) image context."""
        b, t = frames.shape[:2]
        tokens = self.clip_tokens_chunked(frames.reshape(b * t, *frames.shape[2:]))
        return self.resample_tokens(tokens.reshape(b, t, *tokens.shape[1:]))

    # ---------------- denoiser ----------------

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                    c_concat: torch.Tensor, fs: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.unet(torch.cat([x, c_concat], dim=-1), t, context, fs)

    def sample_window(self, context: torch.Tensor, c_concat: torch.Tensor, fs: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None,
                      uncond_context: Optional[torch.Tensor] = None,
                      uncond_img_context: Optional[torch.Tensor] = None,
                      num_steps: int = 5, timestep_spacing: str = "uniform_trailing",
                      eta: float = 0.0, cfg_scale: float = 1.0, cfg_img: Optional[float] = None,
                      guidance_rescale: float = 0.7, x_T: Optional[torch.Tensor] = None,
                      timer=None) -> torch.Tensor:
        """Denoise windows -> (B, T, h, w, 16) geometry latents; `generator`
        as `ddim_sample`'s."""
        b, t, h, w, _ = c_concat.shape
        tables = DDIMTables.from_schedule(self.schedule, num_steps, timestep_spacing, eta)
        use_cfg = cfg_scale != 1.0
        ctxs = [context]
        if use_cfg:
            ctxs.append(uncond_context)
            if cfg_img is not None and cfg_img != 1.0:
                ctxs.append(uncond_img_context)
        ctx_all = torch.cat(ctxs, dim=0)

        def model_fn(x_in, t_step, branches):
            tt = torch.full((x_in.shape[0],), t_step, dtype=torch.int32, device=x_in.device)
            return self.apply_model(x_in, tt, ctx_all, torch.cat([c_concat] * branches),
                                    torch.cat([fs] * branches))

        return ddim_sample(model_fn, (b, t, h, w, self.unet.out_channels), tables,
                           device=c_concat.device, generator=generator,
                           parameterization=self.schedule.parameterization,
                           cfg_scale=cfg_scale, cfg_img=cfg_img,
                           guidance_rescale=guidance_rescale, x_T=x_T, timer=timer)

    # ---------------- q-process (training) ----------------

    def _abar_terms(self, t: torch.Tensor, like: torch.Tensor):
        shape = (-1,) + (1,) * (like.dim() - 1)
        sa = torch.as_tensor(self.schedule.sqrt_alphas_cumprod, dtype=like.dtype,
                             device=like.device)[t].reshape(shape)
        sb = torch.as_tensor(self.schedule.sqrt_one_minus_alphas_cumprod, dtype=like.dtype,
                             device=like.device)[t].reshape(shape)
        return sa, sb

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward noising to timesteps t (B,): sqrt(abar) x0 + sqrt(1 - abar) noise."""
        sa, sb = self._abar_terms(t, x_start)
        return sa * x_start + sb * noise

    def get_v(self, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The v target: sqrt(abar) noise - sqrt(1 - abar) x."""
        sa, sb = self._abar_terms(t, x)
        return sa * noise - sb * x
