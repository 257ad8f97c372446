"""The PyTorch port's diffusion stage against the JAX package, on the CPU in
float32, with the tiny preset (T = 4, 32 x 64 frames).

Both sides get the same randomised weights (carried by the weights bridge),
the same frames and the same injected DDIM noise x_T; the VAE posterior
runs in mode (`sample_posterior=False`) and eta = 0, so nothing else is
random. One module-scoped JAX run serves every assertion on the slice.

Tolerances:
  * pts3d, conf, inv_depth: 1e-3 relative to each map's scale (+1e-4 abs).
    Two DDIM steps over the UNet, then two VAE decoders, compound the
    per-block float32 differences (2e-5) of tests/test_torch_modules.py.
  * valid: at most 0.1% of the points differ (a point within the map
    tolerance of a sky/far threshold may land on either side).
  * traj: 1e-2 abs. Rotations come from a 3x3 SVD of random-weight ray
    maps, whose singular values can lie close together; there a small
    input difference turns the singular vectors visibly.
"""

import numpy as np
import pytest
import torch

import jax

from geo4d_tpu.core.schedules import DiffusionSchedule
from geo4d_tpu.data.video import sliding_windows
from geo4d_tpu.models.presets import init_params, tiny as jax_tiny
from geo4d_tpu.nn.clip import clip_preprocess as jax_clip_preprocess
from geo4d_tpu.pipeline.inference import (InferenceConfig as JaxInferenceConfig,
                                          WindowPredictor as JaxWindowPredictor)
from geo4d_tpu.sampling.ddim import DDIMTables as JaxDDIMTables, ddim_sample as jax_ddim_sample
from geo4d_tpu_torch.models.presets import tiny
from geo4d_tpu_torch.nn.clip import clip_preprocess
from geo4d_tpu_torch.core.schedules import DiffusionSchedule as PortDiffusionSchedule
from geo4d_tpu_torch.pipeline.inference import InferenceConfig, WindowPredictor
from geo4d_tpu_torch.pipeline.inference import sliding_windows as port_sliding_windows
from geo4d_tpu_torch.sampling.ddim import DDIMTables, ddim_sample
from _torch_parity import assert_close, load_from_jax, randomize, to_torch

torch.set_num_threads(1)

T, H, W = 4, 32, 64
CFG = dict(window=T, stride=2, ddim_steps=2, window_batch=1, sample_posterior=False)
MAP_RTOL = 1e-3
TRAJ_ATOL = 1e-2


@pytest.fixture(scope="module")
def slice_run():
    jm = jax_tiny(temporal_length=T)
    params = randomize(init_params(jm, jax.random.PRNGKey(0), (H, W), temporal_length=T,
                                   with_text=False), seed=0)
    pm = tiny(temporal_length=T)
    load_from_jax(pm, params)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(2, T, H, W, 3), dtype=np.uint8)
    text_ctx = rng.normal(size=(1, 77, 64)).astype(np.float32)
    x_T = rng.normal(size=(2, T, H // 8, W // 8, 16)).astype(np.float32)
    want = JaxWindowPredictor(jm, params, JaxInferenceConfig(**CFG)).predict_windows(
        frames, text_ctx, fps=24, x_T=x_T)
    got = WindowPredictor(pm, InferenceConfig(**CFG)).predict_windows(
        frames, text_ctx, fps=24, x_T=x_T)
    return pm, want, got


@pytest.mark.parametrize("key", ["pts3d", "conf", "inv_depth"])
def test_slice_maps_match_jax(slice_run, key):
    _, want, got = slice_run
    scale = float(np.abs(want[key]).max())
    assert_close(got[key], want[key], 1e-4 + MAP_RTOL * scale, 0.0, key)


def test_slice_valid_mask_matches_jax(slice_run):
    _, want, got = slice_run
    diff = want["valid"] != got["valid"]
    assert diff.mean() <= 1e-3, f"valid masks differ at {int(diff.sum())} points"


def test_slice_traj_matches_jax(slice_run):
    _, want, got = slice_run
    assert got["traj"].shape == (2, T, 4, 4)
    assert_close(got["traj"], want["traj"], TRAJ_ATOL, 0.0, "traj")


@pytest.mark.parametrize("window_batch", [1, 2])
def test_predict_video_matches_predict_windows(slice_run, window_batch):
    """3 windows: with window_batch 2 the last launch is padded."""
    pm = slice_run[0]
    predictor = WindowPredictor(pm, InferenceConfig(**dict(CFG, window_batch=window_batch)))
    frames = np.random.default_rng(3).integers(0, 256, size=(T + 4, H, W, 3), dtype=np.uint8)
    groups = sliding_windows(T + 4, T, 2)
    text_ctx = np.zeros((1, 77, 64), np.float32)
    out_w = predictor.predict_windows(frames[groups], text_ctx, fps=24, seed=5)
    out_v = predictor.predict_video(frames, groups, text_ctx, fps=24, seed=5)
    out_d = predictor.predict_video(frames, groups, text_ctx, fps=24, seed=5, return_device=True)
    for k in out_w:
        assert_close(out_v[k], out_w[k], 1e-5, 1e-5, k)
        assert isinstance(out_d[k], torch.Tensor)
        assert_close(out_d[k], out_w[k], 1e-5, 1e-5, k)


def test_clip_preprocess_matches_jax_resize():
    frames = np.random.default_rng(4).uniform(-1, 1, size=(2, 256, 576, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_clip_preprocess)(frames))
    got = clip_preprocess(to_torch(frames))
    assert got.shape == (2, 224, 224, 3)
    assert_close(got, want, 1e-5, 1e-5, "clip_preprocess 256x576 -> 224")


@pytest.mark.parametrize("steps,eta,method", [(5, 0.0, "uniform_trailing"),
                                              (2, 0.5, "uniform_trailing"), (10, 0.0, "uniform")])
def test_ddim_tables_match_jax(steps, eta, method):
    want = JaxDDIMTables.from_schedule(DiffusionSchedule.create(), steps, method, eta)
    got = DDIMTables.from_schedule(PortDiffusionSchedule.create(), steps, method, eta)
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("n", [16, 18, 20, 24, 41])
def test_sliding_windows_match_jax(n):
    np.testing.assert_array_equal(port_sliding_windows(n, 16, 4), sliding_windows(n, 16, 4))


@pytest.mark.parametrize("cfg_scale,cfg_img", [(1.0, None), (2.5, None), (2.5, 1.5)])
@pytest.mark.parametrize("parameterization", ["v", "eps"])
def test_ddim_sample_matches_jax(cfg_scale, cfg_img, parameterization):
    """1-, 2- and 3-way CFG, guidance rescale 0.7, the v/eps conversions and
    the dynamic rescale, through a stand-in model that gives each CFG branch
    its own output; same x_T on both sides, eta 0."""
    shape = (2, 3, 4, 5, 6)
    x_T = np.random.default_rng(5).normal(size=shape).astype(np.float32)

    def model(x, t, branches, lib):
        gains = lib.asarray([1.0, 0.6, 0.3][:branches], dtype=lib.float32)
        per_branch = gains.reshape((branches,) + (1,) * len(shape)) * x.reshape((branches,) + shape)
        return (lib.tanh(per_branch) + t / 1000.0).reshape(x.shape)

    kw = dict(parameterization=parameterization, cfg_scale=cfg_scale, cfg_img=cfg_img,
              guidance_rescale=0.7)
    # eps cannot start from the zero-terminal-SNR step (sqrt(abar_T) = 0)
    sched_kw = dict(parameterization=parameterization,
                    rescale_betas_zero_snr=parameterization == "v")
    want = jax_ddim_sample(lambda x, t, b: model(x, t, b, jax.numpy), shape,
                           JaxDDIMTables.from_schedule(DiffusionSchedule.create(**sched_kw), 5),
                           jax.random.PRNGKey(0), x_T=jax.numpy.asarray(x_T), **kw)
    got = ddim_sample(lambda x, t, b: model(x, t, b, torch), shape,
                      DDIMTables.from_schedule(PortDiffusionSchedule.create(**sched_kw), 5),
                      device=torch.device("cpu"), x_T=to_torch(x_T), **kw)
    assert_close(got, np.asarray(want), 1e-5, 1e-5, "ddim_sample")
