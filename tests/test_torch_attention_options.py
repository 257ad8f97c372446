"""Relative-position and causal temporal attention, and the registry that
builds them, against the JAX package on the CPU in float32.

Weights: the JAX init with every leaf replaced by seeded random values
(`_torch_parity.randomize`), carried across by `state_dict_from_jax` (which
names the relative-position tables) and loaded strictly.

Tolerances: 2e-5 abs + rel for one temporal transformer; 1e-5 relative L2
for the tiny UNet with each option on (the plain tiny slice matches to
~2e-6); 1e-5 relative for `decode_modality` with the model's own layout.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from geo4d_tpu.core import registry as jax_registry
from geo4d_tpu.models.presets import tiny as jax_tiny
from geo4d_tpu.nn import attention as jattn
from geo4d_tpu_torch.core import registry as port_registry
from geo4d_tpu_torch.models.convert import load_checkpoints
from geo4d_tpu_torch.models.presets import tiny
from geo4d_tpu_torch.nn.attention import TemporalTransformer
from _torch_parity import (assert_close, jax_apply, jax_init, load_from_jax, rel_err,
                           state_dict_from_jax, sub_state_dict, to_torch)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_TOL = 2e-5
UNET_REL = 1e-5
DECODE_REL = 1e-5
T = 4
OPTIONS = {"relative_position": dict(use_relative_position=True),
           "causal": dict(use_causal_attention=True),
           "both": dict(use_relative_position=True, use_causal_attention=True)}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_temporal_transformer_options(option):
    """One temporal transformer (16 frames, distances clipped at 6 so that
    the clip is reached)."""
    rel = "use_relative_position" in OPTIONS[option]
    causal = "use_causal_attention" in OPTIONS[option]
    (x,) = _inputs(3, (1, 16, 3, 5, 64))
    jmod = jattn.TemporalTransformer(heads=2, dim_head=32, relative_position=rel, causal=causal,
                                     temporal_length=6, dtype=jnp.float32)
    params = jax_init(jmod, x)
    want = jax_apply(jmod, params, x)
    port = TemporalTransformer(64, 2, 32, relative_position=rel, causal=causal,
                               temporal_length=6, dtype=torch.float32)
    port.load_state_dict(sub_state_dict(params, ["input_blocks_1_2"], "input_blocks.1.2."),
                         strict=True)
    with torch.no_grad():
        assert_close(port.eval()(to_torch(x)), want, BLOCK_TOL, BLOCK_TOL, option)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_tiny_unet_options_match_jax(option):
    jm = dataclasses.replace(jax_tiny(temporal_length=T, dtype=jnp.float32).unet,
                             **OPTIONS[option])
    pm = tiny(temporal_length=T, **OPTIONS[option]).unet
    x, ctx = _inputs(5, (1, T, 4, 8, 20), (1, 77 + T * 16, 64))
    ts, fs = np.array([500], np.int32), np.array([24], np.int32)
    params = jax_init(jm, x, ts, ctx, fs)
    want = jax_apply(jm, params, x, ts, ctx, fs)
    state = state_dict_from_jax(params, "unet")
    tables = [k for k in state if k.endswith("embeddings_table")]
    assert bool(tables) == ("use_relative_position" in OPTIONS[option])
    pm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = pm.eval()(to_torch(x), torch.from_numpy(ts), to_torch(ctx), torch.from_numpy(fs))
    assert rel_err(got.numpy(), want) <= UNET_REL, rel_err(got.numpy(), want)


def test_relative_position_checkpoint_loads(tmp_path):
    """A checkpoint in the published layout with the relative-position
    tables loads into the port strictly."""
    model = tiny(temporal_length=T, use_relative_position=True)
    sd = {f"model.diffusion_model.{k}": torch.randn_like(v)
          for k, v in model.unet.state_dict().items()}
    assert any(k.endswith("attn1.relative_position_k.embeddings_table") for k in sd)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": sd}, path)
    model.vae = model.text_encoder = model.image_encoder = model.resampler = None
    assert load_checkpoints(model, str(path), verbose=False) == {"unet": len(sd)}
    key = next(k for k in sd if k.endswith("relative_position_v.embeddings_table"))
    assert torch.equal(model.unet.state_dict()[key[len("model.diffusion_model."):]], sd[key])


# ---------------- the registry ----------------

MODALITY_CHANNELS = {"pc_ray_cross_depth": 16, "pc_ray": 8, "pc": 4, "multipc": 12,
                     "img_vidpc": 8, "rgb": 4}


def tiny_yaml(tmp_path, modality, pointmap_vae=True, **unet_flags):
    """A copy of the shipped config cut to the tiny preset's sizes, with the
    given modality and UNet flags."""
    with open(os.path.join(REPO, "configs", "inference_geo4d.yaml")) as f:
        cfg = yaml.safe_load(f)
    mp = cfg["model"]["params"]
    mp["modality"] = modality
    mp["unet_config"]["params"].update(
        model_channels=32, num_res_blocks=1, attention_resolutions=[1, 2], channel_mult=[1, 2],
        num_head_channels=16, context_dim=64, temporal_length=T,
        out_channels=MODALITY_CHANNELS[modality],
        in_channels=MODALITY_CHANNELS[modality] + 4, **unet_flags)
    if not pointmap_vae:
        cfg.pop("pointmap_vae_config")
    path = tmp_path / f"{modality}_{int(pointmap_vae)}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("modality", sorted(MODALITY_CHANNELS))
def test_registry_builds_every_modality(tmp_path, modality):
    path = tiny_yaml(tmp_path, modality, use_relative_position=True, use_causal_attention=True)
    jmodel, jpost = jax_registry.build_from_yaml(path)
    pmodel, ppost = port_registry.build_from_yaml(path, dtype=torch.float32)
    assert pmodel.modality == jmodel.modality == modality
    assert ppost == jpost
    assert pmodel.unet.out_channels == jmodel.unet.out_channels == MODALITY_CHANNELS[modality]
    attn = pmodel.unet.init_attn[0].transformer_blocks[0].attn1
    assert attn.relative_position and attn.causal
    assert jmodel.unet.use_relative_position and jmodel.unet.use_causal_attention


@pytest.mark.parametrize("pointmap_vae", [True, False])
def test_decode_modality_default_matches_jax(tmp_path, pointmap_vae):
    """`decode_modality(samples)` with no layout decodes the model's own (here
    pc_ray), with and without a pointmap VAE in the config."""
    path = tiny_yaml(tmp_path, "pc_ray", pointmap_vae=pointmap_vae)
    jmodel, _ = jax_registry.build_from_yaml(path)
    pmodel, _ = port_registry.build_from_yaml(path, dtype=torch.float32)
    assert (pmodel.pointmap_vae is None) == (jmodel.pointmap_vae is None) == (not pointmap_vae)
    vae_cfg = jax_tiny().vae.cfg
    jmodel = dataclasses.replace(
        jmodel, vae=dataclasses.replace(jmodel.vae, cfg=vae_cfg, dtype=jnp.float32),
        pointmap_vae=(dataclasses.replace(jmodel.pointmap_vae, cfg=vae_cfg, dtype=jnp.float32)
                      if pointmap_vae else None))
    pmodel.vae = tiny().vae
    if pointmap_vae:
        pmodel.pointmap_vae = tiny().pointmap_vae
    (z,) = _inputs(9, (1, 2, 4, 8, 8))
    params = {"vae": jax_init(jmodel.vae, np.zeros((1, 32, 64, 3), np.float32), seed=1)}
    if pointmap_vae:
        params["pointmap_vae"] = jax_init(jmodel.pointmap_vae,
                                          np.zeros((1, 32, 64, 3), np.float32),
                                          method=jmodel.pointmap_vae.init_all, seed=2)
    load_from_jax(pmodel, params)
    want = jmodel.decode_modality(params, jnp.asarray(z))
    with torch.no_grad():
        got = pmodel.decode_modality(to_torch(z))
    assert sorted(got) == sorted(want) == ["pointmap_conf", "raymap"]
    for k in want:
        assert rel_err(got[k].numpy(), np.asarray(want[k])) <= DECODE_REL, k
