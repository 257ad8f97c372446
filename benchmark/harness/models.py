"""Builds a configuration's model, with its seeded weights, in either package.

The port (`geo4d_tpu_torch`) and the benchmark's frozen reference
(`geo4d_ref`) have the same module layout, so one builder serves both: it
imports `<package>.models...` by name and passes the configuration file's
keys to the same constructors.

Weights are made on the device from the seed in a few large calls: for each
tower, in a fixed order, one normal draw per served dtype over all of that
tower's parameters served in it, in that dtype, then split into the leaves
and scaled by the configuration's `init` rule.
The reference makes the program's values again (the same draws in the same
dtype) and holds them in its own dtype.
"""

from __future__ import annotations

import gc
import importlib

import torch

TOWERS = ("unet", "vae", "pointmap_vae", "image_encoder", "resampler", "text_encoder")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the text tower's ids for the empty prompt: start of text, end of text, zeros
START_OF_TEXT, END_OF_TEXT, CONTEXT_LENGTH = 49406, 49407, 77


def _mod(package: str, name: str):
    return importlib.import_module(f"{package}.{name}")


def build(package: str, model_cfg: dict, dtype: torch.dtype, device="meta"):
    """GeoDiffusion of `package` with every tower as `model_cfg` states, its
    parameters in `dtype` (norm parameters stay float32), built on `device`
    without initialising anything."""
    unet3d = _mod(package, "models.unet3d")
    ae = _mod(package, "models.autoencoder")
    clip = _mod(package, "nn.clip")
    res = _mod(package, "nn.resampler")
    diff = _mod(package, "models.diffusion")
    sched = _mod(package, "core.schedules")

    def vae(spec):
        cfg = dict(spec["cfg"])
        cfg["ch_mult"] = tuple(cfg["ch_mult"])
        return ae.AutoencoderKL(ae.VAEConfig(**cfg), with_adaptor=spec["with_adaptor"],
                                dtype=dtype)

    u = dict(model_cfg["unet"])
    u["attention_resolutions"] = tuple(u["attention_resolutions"])
    u["channel_mult"] = tuple(u["channel_mult"])
    with torch.device(device):
        return diff.GeoDiffusion(
            unet=unet3d.UNet3D(**u, dtype=dtype),
            vae=vae(model_cfg["vae"]),
            pointmap_vae=vae(model_cfg["pointmap_vae"]),
            image_encoder=clip.CLIPVisionEncoder(**model_cfg["image_encoder"], dtype=dtype),
            resampler=res.Resampler(**model_cfg["resampler"], dtype=dtype),
            schedule=sched.DiffusionSchedule.create(**model_cfg["schedule"]),
            scale_factor=model_cfg["scale_factor"],
            text_encoder=clip.CLIPTextEncoder(**model_cfg["text_encoder"], dtype=dtype),
            modality=model_cfg["modality"],
        )


def _leaf_scales(served_tower, init: dict) -> dict:
    """id(served leaf) -> (std, mean) of its draw: a norm's weight centred
    on `norm_weight`, a matrix or convolution weight with std
    1/sqrt(fan in), every other leaf (biases, embeddings' 1-D parts) with
    `other_std`. Activations then keep their scale through the depth, as
    in a trained model, so every layer's arithmetic shows in the output."""
    out = {}
    for m in served_tower.modules():
        if type(m).__name__ == "GroupNorm32" or isinstance(m, torch.nn.LayerNorm):
            for name, p in m.named_parameters(recurse=False):
                out[id(p)] = ((init["other_std"], init["norm_weight"]) if name == "weight"
                              else (init["other_std"], 0.0))
    for p in served_tower.parameters():
        if id(p) not in out:
            fan_in = p[0].numel() if p.dim() >= 2 else 0
            out[id(p)] = ((fan_in ** -0.5, 0.0) if fan_in else (init["other_std"], 0.0))
    return out


@torch.no_grad()
def fill_weights_(model, seed: int, init: dict, served, device, towers=TOWERS):
    """Materialise `towers` of `model` on `device` and give them the seed's
    weights: per tower, one standard normal draw per served dtype from a
    generator on the device (`towers` is a prefix of TOWERS: the draws of a
    tower do not depend on the towers after it), each leaf's part scaled
    and shifted as `_leaf_scales` says, in the served dtype. `served` is the
    model as it is served (built on the meta device in the served dtype):
    each leaf is drawn in its served dtype, whatever dtype `model` holds it
    in, so the reference holds the program's values."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for name in towers:
        getattr(model, name).to_empty(device=device)
        scales = _leaf_scales(getattr(served, name), init)
        groups = {}
        for p, s in zip(getattr(model, name).parameters(), getattr(served, name).parameters()):
            groups.setdefault(s.dtype, []).append((p, scales[id(s)]))
        for dtype in sorted(groups, key=str):
            leaves = groups[dtype]
            flat = torch.randn(sum(p.numel() for p, _ in leaves), dtype=dtype, device=device,
                               generator=gen)
            for (p, (std, mean)), chunk in zip(leaves, flat.split([p.numel() for p, _ in leaves])):
                p.copy_(chunk.mul_(std).add_(mean).view(p.shape))
            del flat
    return model


def empty_prompt_ids(device) -> torch.Tensor:
    """(1, 77) ids of the empty prompt, as the CLIP tokenizer gives them."""
    ids = torch.zeros((1, CONTEXT_LENGTH), dtype=torch.long, device=device)
    ids[0, 0], ids[0, 1] = START_OF_TEXT, END_OF_TEXT
    return ids


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def free(device) -> None:
    """Return the memory of dropped tensors to the device."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
