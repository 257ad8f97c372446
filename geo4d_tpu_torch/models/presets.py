"""Model presets (the shipped `flagship` and the test-size `tiny`, as in
geo4d_tpu/models/presets.py) and seeded random-normal initialisation."""

from __future__ import annotations

import torch

from geo4d_tpu_torch.models.autoencoder import AutoencoderKL, VAEConfig
from geo4d_tpu_torch.models.diffusion import GeoDiffusion
from geo4d_tpu_torch.models.unet3d import UNet3D
from geo4d_tpu_torch.nn.clip import CLIPTextEncoder, CLIPVisionEncoder
from geo4d_tpu_torch.nn.resampler import Resampler


def flagship(dtype=torch.bfloat16, device="meta") -> GeoDiffusion:
    """The shipped Geo4D configuration (configs/inference_geo4d.yaml).

    Built on the meta device by default (no memory, no init cost): move it
    with `init_random_` or `to_empty` + `load_state_dict`."""
    with torch.device(device):
        return GeoDiffusion(
            unet=UNet3D(dtype=dtype),
            vae=AutoencoderKL(with_adaptor=False, dtype=dtype),
            pointmap_vae=AutoencoderKL(with_adaptor=True, dtype=dtype),
            image_encoder=CLIPVisionEncoder(dtype=dtype),
            resampler=Resampler(dtype=dtype),
            text_encoder=CLIPTextEncoder(dtype=dtype),
        )


def tiny(temporal_length: int = 4, dtype=torch.float32, device="cpu",
         **unet_options) -> GeoDiffusion:
    """Every tower present at ~1/100 of the channel counts (the JAX tiny
    preset's shapes); `unet_options` go to the UNet (for example
    use_relative_position=True). One difference: the text tower keeps the
    tokenizer's full vocabulary (49408 rows of width 64), since the shared
    tokenizer's ids (start/end of text are 49406/49407) must index it; the
    JAX tiny preset's 128-row table works only because XLA clamps
    out-of-range gathers."""
    ctx_dim = 64
    vae_cfg = VAEConfig(ch=16, ch_mult=(1, 2, 2, 2), num_res_blocks=1, adaptor_ch=16)
    with torch.device(device):
        return GeoDiffusion(
            unet=UNet3D(model_channels=32, num_res_blocks=1, attention_resolutions=(1, 2),
                        channel_mult=(1, 2), num_head_channels=16, context_dim=ctx_dim,
                        temporal_length=temporal_length, dtype=dtype, **unet_options),
            vae=AutoencoderKL(vae_cfg, with_adaptor=False, dtype=dtype),
            pointmap_vae=AutoencoderKL(vae_cfg, with_adaptor=True, dtype=dtype),
            image_encoder=CLIPVisionEncoder(width=48, heads=4, layers=2, patch_size=14,
                                            dtype=dtype),
            resampler=Resampler(dim=ctx_dim, depth=1, dim_head=16, heads=4, num_queries=16,
                                embedding_dim=48, output_dim=ctx_dim,
                                video_length=temporal_length, dtype=dtype),
            text_encoder=CLIPTextEncoder(width=ctx_dim, heads=4, layers=2, dtype=dtype),
        )


@torch.no_grad()
def init_random_(model: torch.nn.Module, device, seed: int = 0,
                 std: float = 0.02) -> torch.nn.Module:
    """Materialise `model` on `device` and draw every parameter from
    N(0, std^2) with a seeded generator on that device, in the parameter's
    own dtype (bf16 weights, f32 norm parameters). Random-normal tails keep
    the zero-init residual branches from making the sampler trivial."""
    model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for p in model.parameters():
        p.normal_(0.0, std, generator=gen)
    return model
