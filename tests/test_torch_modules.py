"""Each kernel-holding module of the PyTorch port, and each tower of the tiny
preset, against the JAX package on the CPU in float32.

Weights: the JAX init, every leaf replaced by seeded random values
(`_torch_parity.randomize`), carried across by the weights bridge
(`state_dict_from_jax`, or the UNet key rules for a submodule) and loaded
strictly. Inputs: seeded numpy. The JAX side is jitted.

Tolerances (abs + rel, float32): 2e-5 for a single block (a few matmuls
and norms, summed in another order); 1e-4 for a whole tower, where those
differences compound through tens of layers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geo4d_tpu.models.presets import tiny as jax_tiny
from geo4d_tpu.models.unet3d import ResBlock as JaxResBlock
from geo4d_tpu.nn import attention as jattn
from geo4d_tpu.nn.basics import GroupNorm32 as JaxGroupNorm32
from geo4d_tpu_torch.models.presets import tiny
from geo4d_tpu_torch.models.unet3d import ResBlock
from geo4d_tpu_torch.nn.attention import CrossAttention, SpatialTransformer, TemporalTransformer
from geo4d_tpu_torch.nn.basics import GroupNorm32
from _torch_parity import (assert_close, jax_apply, jax_init, state_dict_from_jax,
                           sub_state_dict, to_torch)

torch.set_num_threads(1)

BLOCK_TOL = 2e-5
TOWER_TOL = 1e-4
F32 = jnp.float32


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm32_module(silu):
    (x,) = _inputs(0, (2, 4, 6, 96))
    jmod = JaxGroupNorm32(epsilon=1e-6, silu=silu)
    params = jax_init(jmod, x)
    want = jax_apply(jmod, params, x)
    port = _load(GroupNorm32(96, eps=1e-6, silu=silu),
                 sub_state_dict(params, ["input_blocks_1_1", "norm"], "input_blocks.1.1.norm."))
    with torch.no_grad():
        assert_close(port(to_torch(x)), want, BLOCK_TOL, BLOCK_TOL, "GroupNorm32")


CROSS_CASES = {
    # temporal self-attention: N = 16 -> K3 route
    "self_n16": dict(x=(24, 16, 64), ctx=None, heads=2, dim_head=32, ctx_dim=None, img=False),
    # spatial self-attention: N = 576 -> K2 route
    "self_n576": dict(x=(2, 576, 128), ctx=None, heads=2, dim_head=64, ctx_dim=None, img=False),
    # text (77, plain) + image stream (16 tokens, K2 route)
    "cross_img": dict(x=(2, 512, 128), ctx=(2, 77 + 16, 48), heads=2, dim_head=64, ctx_dim=48,
                      img=True),
}


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
def test_cross_attention(case):
    c = CROSS_CASES[case]
    shapes = [c["x"]] + ([c["ctx"]] if c["ctx"] else [])
    arrays = _inputs(1, *shapes)
    kw = dict(heads=c["heads"], dim_head=c["dim_head"], context_dim=c["ctx_dim"],
              image_cross_attention=c["img"], image_cross_attention_scale=0.7, dtype=F32)
    jmod = jattn.CrossAttention(**kw)
    params = jax_init(jmod, *arrays)
    want = jax_apply(jmod, params, *arrays)
    port = CrossAttention(c["x"][-1], c["heads"], c["dim_head"], c["ctx_dim"], c["img"], 0.7,
                          dtype=torch.float32)
    prefix = ["input_blocks_1_1", "block_0", "attn2"]
    _load(port, sub_state_dict(params, prefix, "input_blocks.1.1.transformer_blocks.0.attn2."))
    with torch.no_grad():
        assert_close(port(*map(to_torch, arrays)), want, BLOCK_TOL, BLOCK_TOL, case)


def test_spatial_transformer():
    x, ctx = _inputs(2, (2, 24, 24, 64), (2, 77 + 16, 48))
    jmod = jattn.SpatialTransformer(heads=2, dim_head=64, context_dim=48,
                                    image_cross_attention=True, dtype=F32)
    params = jax_init(jmod, x, ctx)
    want = jax_apply(jmod, params, x, ctx)
    port = _load(SpatialTransformer(64, 2, 64, context_dim=48, image_cross_attention=True,
                                    dtype=torch.float32),
                 sub_state_dict(params, ["input_blocks_1_1"], "input_blocks.1.1."))
    with torch.no_grad():
        assert_close(port(to_torch(x), to_torch(ctx)), want, BLOCK_TOL, BLOCK_TOL,
                     "SpatialTransformer")


@pytest.mark.parametrize("conv1d_proj", [False, True])
def test_temporal_transformer(conv1d_proj):
    (x,) = _inputs(3, (1, 16, 4, 6, 64))
    jmod = jattn.TemporalTransformer(heads=2, dim_head=32, dtype=F32)
    params = jax_init(jmod, x)
    want = jax_apply(jmod, params, x)
    state = sub_state_dict(params, ["input_blocks_1_2"], "input_blocks.1.2.")
    if conv1d_proj:  # checkpoints that hold proj_in/out as kernel-1 Conv1d weights
        for k in ("proj_in.weight", "proj_out.weight"):
            state[k] = state[k][..., None]
    port = _load(TemporalTransformer(64, 2, 32, dtype=torch.float32), state)
    with torch.no_grad():
        assert_close(port(to_torch(x)), want, BLOCK_TOL, BLOCK_TOL, "TemporalTransformer")


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (32, 64)])
def test_resblock(c_in, c_out):
    t = 4
    x, emb = _inputs(4, (2 * t, 6, 8, c_in), (2 * t, 128))
    jmod = JaxResBlock(c_out, dropout=0.0, dtype=F32)
    params = jax_init(jmod, x, emb, temporal_length=t)
    want = jax_apply(jmod, params, x, emb, temporal_length=t)
    port = _load(ResBlock(c_in, c_out, 128, t, dtype=torch.float32),
                 sub_state_dict(params, ["input_blocks_1_0"], "input_blocks.1.0."))
    with torch.no_grad():
        assert_close(port(to_torch(x), to_torch(emb)), want, BLOCK_TOL, BLOCK_TOL, "ResBlock")


# ---------------- whole towers of the tiny preset ----------------

T = 4


@pytest.fixture(scope="module")
def models():
    return jax_tiny(temporal_length=T, dtype=F32), tiny(temporal_length=T)


def test_unet3d(models):
    jm, pm = models
    x, ctx = _inputs(5, (1, T, 4, 8, 20), (1, 77 + T * 16, 64))
    ts, fs = np.array([500], np.int32), np.array([24], np.int32)
    params = jax_init(jm.unet, x, ts, ctx, fs)
    want = jax_apply(jm.unet, params, x, ts, ctx, fs)
    _load(pm.unet, state_dict_from_jax(params, "unet"))
    with torch.no_grad():
        got = pm.unet(to_torch(x), torch.from_numpy(ts), to_torch(ctx), torch.from_numpy(fs))
    assert_close(got, want, TOWER_TOL, TOWER_TOL, "UNet3D")


def test_autoencoder(models):
    jm, pm = models
    x, z = _inputs(6, (2, 32, 64, 3), (2, 4, 8, 4))
    jvae = jm.pointmap_vae
    params = jax_init(jvae, x, method=jvae.init_all)
    _load(pm.pointmap_vae, state_dict_from_jax(params, "pointmap_vae"))
    mean, logvar = jax_apply(jvae, params, x, method=jvae.encode)
    with torch.no_grad():
        pmean, plogvar = pm.pointmap_vae.encode(to_torch(x))
        assert_close(pmean, mean, TOWER_TOL, TOWER_TOL, "encode mean")
        assert_close(plogvar, logvar, TOWER_TOL, TOWER_TOL, "encode logvar")
        for method in ("decode", "decode_with_conf", "encode_with_adaptor"):
            want = jax_apply(jvae, params, z if "decode" in method else x,
                             method=getattr(jvae, method))
            got = getattr(pm.pointmap_vae, method)(to_torch(z if "decode" in method else x))
            want, got = (want[0], got[0]) if method == "encode_with_adaptor" else (want, got)
            assert_close(got, want, TOWER_TOL, TOWER_TOL, method)


def test_clip_vision_encoder(models):
    jm, pm = models
    (img,) = _inputs(7, (2, 224, 224, 3))
    params = jax_init(jm.image_encoder, img)
    want = jax_apply(jm.image_encoder, params, img)
    _load(pm.image_encoder, state_dict_from_jax(params, "clip_img"))
    with torch.no_grad():
        got = pm.image_encoder(to_torch(img))
    assert got.shape == (2, 257, 48)
    assert_close(got, want, TOWER_TOL, TOWER_TOL, "CLIPVisionEncoder")


def test_resampler(models):
    jm, pm = models
    (tok,) = _inputs(8, (2, T, 257, 48))
    params = jax_init(jm.resampler, tok)
    want = jax_apply(jm.resampler, params, tok)
    _load(pm.resampler, state_dict_from_jax(params, "resampler"))
    with torch.no_grad():
        got = pm.resampler(to_torch(tok))
    assert got.shape == (2, T * 16, 64)
    assert_close(got, want, TOWER_TOL, TOWER_TOL, "Resampler")
