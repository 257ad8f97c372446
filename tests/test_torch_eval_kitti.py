"""The evaluation preset's batched windows through `reconstruct` on the CPU, at
the tiny preset (float32, windows of 4 at stride 2, 32 x 64 frames): the
window outputs against the JAX package's `WindowPredictor.predict_video` at
the same window_batch, and the windows and the aligner against the
benchmark's plain-PyTorch reference (`benchmark/geo4d_ref`) on the same
seeded weights and draws; the program's window and aligner counters; and the
benchmark's evaluation configuration (`benchmark/configs/geo4d_eval.json`)
against what `cli/evaluate.py` builds.

11 frames make 5 windows, the last a tail window (starts 0, 2, 4, 6 and 7);
at window_batch 3 they run as two UNet calls, the second with one padded
row, as KITTI's 110 frames make 25 windows, the last a tail window.

Tolerances:
  * against the JAX package (the weights carried by the weights bridge, the
    VAE posterior in mode, eta 0, and each chunk's initial noise the JAX
    package's own draw): as tests/test_torch_pipeline.py, pts3d, conf and
    inv_depth 1e-3 relative to each map's scale (+1e-4 abs), since the DDIM
    steps over the UNet, then the decoders, compound the per-block float32
    differences (2e-5) of tests/test_torch_modules.py; valid, at most 0.1%
    of the points differ (a point within that tolerance of a sky or far
    threshold may land on either side); traj 1e-2 abs, since rotations come
    from 3x3 SVDs of random-weight ray maps, whose singular values can lie
    close together.
  * against the plain reference, window outputs (pts3d, conf, inv_depth,
    traj): 1e-5 relative L2. The
    reference is a copy of the port's plain paths in float32 on the same
    weights, frames and generator draws; only the order of a few float32
    sums may differ between the two copies.
  * the aligner: the reference's objective at the port's answers against
    at its own, 1e-5 relative, and the port's final loss against the
    reference's, 1e-5 relative: the same float32 arithmetic over the same
    window predictions, iterations and schedule, so only rounding
    separates them.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geo4d_tpu_torch.alignment.optimizer import AlignerConfig
from geo4d_tpu_torch.core import timing
from geo4d_tpu_torch.pipeline.inference import InferenceConfig, reconstruct, sliding_windows

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "benchmark", ROOT / "benchmark" / "tests"):
    if str(p) not in sys.path:
        sys.path.append(str(p))

import bench_tiny  # noqa: E402
from _torch_parity import assert_close  # noqa: E402
from harness import models  # noqa: E402

torch.set_num_threads(1)
EVAL_CONFIG = json.loads((ROOT / "benchmark/configs/geo4d_eval.json").read_text())
FRAMES, H, W, WINDOW, STRIDE = 11, 32, 64, 4, 2
WINDOW_REL, ALIGN_REL = 1e-5, 1e-5
JAX_MAP_RTOL, JAX_TRAJ_ATOL, JAX_VALID_SHARE = 1e-3, 1e-2, 1e-3
SEED, FPS = 7, 10


def _configs(package: str, window_batch: int, n_iter: int = 8):
    from importlib import import_module

    inf = import_module(f"{package}.pipeline.inference")
    opt = import_module(f"{package}.alignment.optimizer")
    icfg = inf.InferenceConfig(**dict(EVAL_CONFIG["inference"], window=WINDOW, stride=STRIDE),
                               window_batch=window_batch)
    acfg = opt.AlignerConfig(**dict(EVAL_CONFIG["aligner"], n_iter=n_iter,
                                    depth_traj_start_iter=n_iter // 2))
    return inf, icfg, acfg


def _model(package: str):
    cfg = dict(bench_tiny.MODEL, schedule=EVAL_CONFIG["model"]["schedule"],
               scale_factor=EVAL_CONFIG["model"]["scale_factor"],
               modality=EVAL_CONFIG["model"]["modality"])
    served = models.build("geo4d_tpu_torch", cfg, torch.float32)
    m = models.build(package, cfg, torch.float32)
    return models.fill_weights_(m, 3, EVAL_CONFIG["init"], served, "cpu").eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(FRAMES, H, W, 3), dtype=np.uint8)
    text = rng.normal(size=(1, 77, bench_tiny.MODEL["unet"]["context_dim"])).astype(np.float32)
    return frames, text


@pytest.fixture(scope="module")
def program():
    return _model("geo4d_tpu_torch")


@pytest.fixture(scope="module")
def batched(program, inputs):
    """The port's reconstruct at window_batch 3 and the reference's window
    predictions and aligner on the same inputs and draws."""
    frames, text = inputs
    _, icfg, acfg = _configs("geo4d_tpu_torch", 3)
    scene, preds, _ = reconstruct(program, frames, text, FPS, icfg, acfg, seed=SEED,
                                  device="cpu")
    inf, ricfg, racfg = _configs("geo4d_ref", 3)
    groups = inf.sliding_windows(FRAMES, WINDOW, STRIDE)
    ref_model = _model("geo4d_ref")
    ref_preds = inf.WindowPredictor(ref_model, ricfg, device="cpu").predict_video(
        frames, groups, text, FPS, SEED, return_device=True)
    ref_scene = inf.align_predictions(groups, ref_preds, (H, W), racfg, device="cpu")
    return scene, preds, ref_scene, ref_preds


@pytest.fixture(scope="module")
def against_jax(inputs):
    """reconstruct's window predictions at window_batch 3 and the JAX
    package's `predict_video` at window_batch 3, on the tiny preset's
    weights, in posterior mode. The JAX package draws each chunk's initial
    noise from its key: PRNGKey(seed) split once per chunk, the second half
    split into the encoder's and the sampler's keys, and the sampler's split
    again in `ddim_sample` for the draw. The port's draws are replaced by
    those, chunk by chunk."""
    import jax

    from geo4d_tpu.models.presets import init_params, tiny as jax_tiny
    from geo4d_tpu.pipeline.inference import (InferenceConfig as JaxInferenceConfig,
                                              WindowPredictor as JaxWindowPredictor)
    from geo4d_tpu_torch.models.presets import tiny
    from geo4d_tpu_torch.sampling import ddim
    from _torch_parity import load_from_jax, randomize

    frames, text = inputs
    fields = dict(EVAL_CONFIG["inference"], window=WINDOW, stride=STRIDE, window_batch=3,
                  sample_posterior=False)
    jm = jax_tiny(temporal_length=WINDOW)
    params = randomize(init_params(jm, jax.random.PRNGKey(0), (H, W), temporal_length=WINDOW,
                                   with_text=False), seed=0)
    pm = tiny(temporal_length=WINDOW)
    load_from_jax(pm, params)
    groups = sliding_windows(FRAMES, WINDOW, STRIDE)
    want = JaxWindowPredictor(jm, params, JaxInferenceConfig(**fields)).predict_video(
        frames, groups, text, FPS, seed=SEED)

    shape = (3, WINDOW, H // 8, W // 8, pm.unet.out_channels)
    draws, key = [], jax.random.PRNGKey(SEED)
    for _ in range(math.ceil(len(groups) / 3)):
        key, sub = jax.random.split(key)
        _, key_samp = jax.random.split(sub)
        _, nkey = jax.random.split(key_samp)
        draws.append(np.asarray(jax.random.normal(nkey, shape, dtype=np.float32)))

    def drawn(generator, got_shape, device):
        assert tuple(got_shape) == shape
        return torch.tensor(draws.pop(0), device=device)

    _, _, acfg = _configs("geo4d_tpu_torch", 3, n_iter=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ddim, "_normal", drawn)
        _, preds, _ = reconstruct(pm.eval(), frames, text, FPS, InferenceConfig(**fields), acfg,
                                  seed=SEED, device="cpu")
    assert draws == []
    return {k: v.numpy() for k, v in preds.items()}, want


@pytest.mark.parametrize("key", ["pts3d", "conf", "inv_depth"])
def test_batched_windows_match_jax(against_jax, key):
    got, want = against_jax
    assert got[key].shape[:2] == (5, WINDOW)
    scale = float(np.abs(want[key]).max())
    assert_close(got[key], want[key], 1e-4 + JAX_MAP_RTOL * scale, 0.0, key)


def test_batched_valid_masks_and_trajectories_match_jax(against_jax):
    got, want = against_jax
    diff = got["valid"] != want["valid"]
    assert diff.mean() <= JAX_VALID_SHARE, f"valid masks differ at {int(diff.sum())} points"
    assert got["traj"].shape == (5, WINDOW, 4, 4)
    assert_close(got["traj"], want["traj"], JAX_TRAJ_ATOL, 0.0, "traj")


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def test_the_video_has_a_tail_window_and_a_partial_chunk():
    groups = sliding_windows(FRAMES, WINDOW, STRIDE)
    assert groups[:, 0].tolist() == [0, 2, 4, 6, 7] and len(groups) % 3 != 0


@pytest.mark.parametrize("key", ["pts3d", "conf", "inv_depth", "traj"])
def test_batched_windows_match_the_reference(batched, key):
    _, preds, _, ref_preds = batched
    assert preds[key].shape == ref_preds[key].shape
    assert preds[key].shape[:2] == (5, WINDOW)
    assert _rel(preds[key], ref_preds[key]) <= WINDOW_REL


def test_aligner_objective_matches_the_reference(batched):
    scene, _, ref_scene, _ = batched
    ours = {k: v.detach() for k, v in scene.params.items()}
    with torch.no_grad():
        at_ours = float(ref_scene.loss_fn(ours, True))
        at_ref = float(ref_scene.loss_fn(ref_scene.params, True))
    assert np.isfinite(at_ours) and abs(at_ours - at_ref) <= ALIGN_REL * abs(at_ref)
    assert abs(scene.final_loss - ref_scene.final_loss) <= ALIGN_REL * abs(ref_scene.final_loss)


@pytest.mark.parametrize("window_batch", [1, 3])
def test_counters_read_the_chunks_padding_and_points(program, inputs, window_batch):
    frames, text = inputs
    _, icfg, acfg = _configs("geo4d_tpu_torch", window_batch, n_iter=2)
    rec = timing.SpanRecorder()
    with timing.recording(rec):
        reconstruct(program, frames, text, FPS, icfg, acfg, seed=SEED, device="cpu")
    totals = rec.totals()
    g = len(sliding_windows(FRAMES, WINDOW, STRIDE))
    chunks = math.ceil(g / window_batch)
    assert totals["window_chunks"] == chunks
    assert totals["window_rows_padded"] == chunks * window_batch - g
    assert totals["align_points"] == g * WINDOW * H * W
    assert timing.current() is None


def test_nothing_is_counted_without_a_recorder(program, inputs, monkeypatch):
    frames, text = inputs
    calls = []
    monkeypatch.setattr(timing.SpanRecorder, "count", lambda self, *a: calls.append(a))
    _, icfg, acfg = _configs("geo4d_tpu_torch", 3, n_iter=2)
    assert timing.current() is None
    reconstruct(program, frames, text, FPS, icfg, acfg, seed=SEED, device="cpu")
    assert calls == []


def test_current_is_the_installed_recorder():
    rec = timing.SpanRecorder()
    assert timing.current() is None
    with timing.recording(rec):
        assert timing.current() is rec
    assert timing.current() is None


class _Captured(Exception):
    pass


def test_eval_config_is_what_the_evaluation_cli_builds(tmp_path, monkeypatch):
    """cli/evaluate.py's configurations for KITTI at window_batch 5, caught
    where it calls reconstruct, against geo4d_eval.json's."""
    from geo4d_tpu_torch.cli import evaluate
    from geo4d_tpu_torch.data import datasets
    from geo4d_tpu_torch.pipeline import inference

    sample = type("Sample", (), {"frames": np.zeros((16, 192, 640, 3), np.uint8),
                                 "intrinsics": None})
    monkeypatch.setattr(datasets, "load_eval_sequence", lambda *a, **k: sample)

    def caught(model, frames, text_ctx, fps=24, inference_config=None, aligner_config=None,
               **kw):
        raise _Captured(inference_config, aligner_config)
    monkeypatch.setattr(inference, "reconstruct", caught)
    args = evaluate.get_parser().parse_args(
        ["--dataset", "kitti", "--data_root", str(tmp_path), "--seq_list", "00",
         "--window_batch", "5", "--savedir", str(tmp_path / "out")])
    with pytest.raises(_Captured) as got:
        evaluate.evaluate(args, None, None, None, "cpu")
    icfg, acfg = got.value.args
    assert icfg == InferenceConfig(**EVAL_CONFIG["inference"], window_batch=5)
    assert acfg == AlignerConfig(**EVAL_CONFIG["aligner"])
    assert icfg.sky_eps == 0.1 and dataclasses.asdict(acfg)["n_iter"] == 500
    assert EVAL_CONFIG["reduced"] == []
