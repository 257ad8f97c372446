"""Build the port's model bundle from a reference-layout YAML, port of
geo4d_tpu/core/registry.py. Each `target:` of the YAML tree resolves,
through this module's registry, to the torch module of this package. Both the
`geo4d_tpu.*` names and the original `lvdm.*` import paths are accepted.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from geo4d_tpu_torch.core.config import Registry, instantiate, load_config

components = Registry()


def _register_all():
    from geo4d_tpu_torch.models.autoencoder import AutoencoderKL, VAEConfig
    from geo4d_tpu_torch.models.unet3d import UNet3D
    from geo4d_tpu_torch.nn.clip import CLIPTextEncoder, CLIPVisionEncoder
    from geo4d_tpu_torch.nn.resampler import Resampler

    @components.register("geo4d_tpu.UNet3D", "lvdm.modules.networks.openaimodel3d.UNetModel")
    def _unet(dtype, **p):
        # `dropout` is a training knob: inference runs the modules in eval mode
        return UNet3D(
            in_channels=p.get("in_channels", 20),
            out_channels=p.get("out_channels", 16),
            model_channels=p.get("model_channels", 320),
            num_res_blocks=p.get("num_res_blocks", 2),
            attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
            channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
            num_head_channels=p.get("num_head_channels", 64),
            transformer_depth=p.get("transformer_depth", 1),
            context_dim=p.get("context_dim", 1024),
            temporal_length=p.get("temporal_length", 16),
            temporal_conv=p.get("temporal_conv", True),
            temporal_attention=p.get("temporal_attention", True),
            use_relative_position=p.get("use_relative_position", False),
            use_causal_attention=p.get("use_causal_attention", False),
            addition_attention=p.get("addition_attention", True),
            image_cross_attention=p.get("image_cross_attention", True),
            fs_condition=p.get("fs_condition", False),
            default_fs=p.get("default_fs", 4),
            dtype=dtype,
        )

    @components.register("geo4d_tpu.AutoencoderKL", "lvdm.models.autoencoder.AutoencoderKL")
    def _vae(dtype, **p):
        dd = p.get("ddconfig", {})
        ad = p.get("adaptorconfig") or {}
        cfg = VAEConfig(
            ch=dd.get("ch", 128),
            ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2),
            z_channels=dd.get("z_channels", 4),
            embed_dim=p.get("embed_dim", 4),
            in_channels=dd.get("in_channels", 3),
            out_ch=dd.get("out_ch", 3),
            double_z=dd.get("double_z", True),
            adaptor_ch=ad.get("ch", 128),
            adaptor_num_res_blocks=ad.get("num_res_blocks", 1),
            adaptor_out_ch=ad.get("out_ch", 1),
        )
        return AutoencoderKL(cfg, with_adaptor=bool(ad), dtype=dtype)

    @components.register("geo4d_tpu.CLIPTextEncoder",
                         "lvdm.modules.encoders.condition.FrozenOpenCLIPEmbedder")
    def _text(dtype, **p):
        return CLIPTextEncoder(penultimate=p.get("layer", "penultimate") == "penultimate",
                               dtype=dtype)

    @components.register("geo4d_tpu.CLIPVisionEncoder",
                         "lvdm.modules.encoders.condition.FrozenOpenCLIPImageEmbedderV2")
    def _vision(dtype, **p):
        return CLIPVisionEncoder(dtype=dtype)

    @components.register("geo4d_tpu.Resampler", "lvdm.modules.encoders.resampler.Resampler")
    def _resampler(dtype, **p):
        return Resampler(
            dim=p.get("dim", 1024),
            depth=p.get("depth", 4),
            dim_head=p.get("dim_head", 64),
            heads=p.get("heads", 12),
            num_queries=p.get("num_queries", 16),
            embedding_dim=p.get("embedding_dim", 1280),
            output_dim=p.get("output_dim", 1024),
            ff_mult=p.get("ff_mult", 4),
            video_length=p.get("video_length", 16),
            dtype=dtype,
        )


def build_from_yaml(path: str, dtype=torch.bfloat16, device="meta") -> Tuple[Any, Dict[str, Any]]:
    """Reference-layout YAML -> (GeoDiffusion, postprocess dict). The model
    is built on `device` (default meta: no memory until `init_random_` or a
    checkpoint load materialises it). The top-level `pointmap_vae_config` is
    optional: without it the pointmap decodes through the RGB VAE."""
    if "geo4d_tpu.UNet3D" not in components:
        _register_all()
    from geo4d_tpu_torch.core.schedules import DiffusionSchedule
    from geo4d_tpu_torch.models.diffusion import GeoDiffusion

    cfg = load_config(path)
    mp = cfg["model"]["params"]

    def build(node):
        return instantiate(node, components, dtype=dtype)

    schedule = DiffusionSchedule.create(
        timesteps=mp.get("timesteps", 1000),
        linear_start=mp.get("linear_start", 0.00085),
        linear_end=mp.get("linear_end", 0.012),
        rescale_betas_zero_snr=mp.get("rescale_betas_zero_snr", True),
        parameterization=mp.get("parameterization", "v"),
        use_dynamic_rescale=mp.get("use_dynamic_rescale", True),
        base_scale=mp.get("base_scale", 0.7),
    )
    with torch.device(device):
        model = GeoDiffusion(
            unet=build(mp["unet_config"]),
            vae=build(mp["first_stage_config"]),
            pointmap_vae=(build(cfg["pointmap_vae_config"]) if "pointmap_vae_config" in cfg
                          else None),
            text_encoder=build(mp["cond_stage_config"]),
            image_encoder=build(mp["img_cond_stage_config"]),
            resampler=build(mp["image_proj_stage_config"]),
            schedule=schedule,
            scale_factor=mp.get("scale_factor", 0.18215),
            modality=mp.get("modality", "pc_ray_cross_depth"),
        )
    return model, cfg.get("postprocess", {})
