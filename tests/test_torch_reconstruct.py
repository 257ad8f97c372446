"""The PyTorch port's entry points on the CPU: the CLIP text tower against the
JAX package, `align_predictions` against the JAX aligner (init, calibration
and 20 iterations) on the same tiny predictions, `reconstruct` and the CLI
writing the results-directory contract (the port's exporter writes the
same bytes as the JAX package's), the YAML registry, and the checkpoint
loader.

Tolerances: the text tower 1e-4 relative to the output's scale (float32,
weights carried by the weights bridge). The aligners are compared by
bounds that need no ground truth, since the two packages' PnP differ
(OpenCV in the JAX package, the port's own RANSAC): both runs end finite and
their shared focals agree within 2%.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from geo4d_tpu.alignment.init import init_from_group as jax_init_from_group
from geo4d_tpu.alignment.optimizer import AlignerConfig as JaxAlignerConfig
from geo4d_tpu.alignment.optimizer import GroupAligner as JaxGroupAligner
from geo4d_tpu.core.registry import build_from_yaml as jax_build_from_yaml
from geo4d_tpu.data.tokenizer import CLIPTokenizer
from geo4d_tpu.data.video import sliding_windows
from geo4d_tpu.nn.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from geo4d_tpu.pipeline.export import save_results_dir as jax_save_results_dir
from geo4d_tpu_torch.alignment.optimizer import AlignerConfig
from geo4d_tpu_torch.cli import infer
from geo4d_tpu_torch.core.registry import build_from_yaml
from geo4d_tpu_torch.data.images import read_png
from geo4d_tpu_torch.models.convert import CKPT_PREFIXES, TOWER_MODULES, load_checkpoints
from geo4d_tpu_torch.models.presets import init_random_, tiny
from geo4d_tpu_torch.nn.clip import CLIPTextEncoder
from geo4d_tpu_torch.pipeline.export import save_results_dir
from geo4d_tpu_torch.pipeline.inference import (InferenceConfig, WindowPredictor,
                                                align_predictions, reconstruct)
from _torch_parity import assert_close, jax_init, state_dict_from_jax

torch.set_num_threads(1)
T, H, W = 4, 32, 64
CONTRACT = ["pred_traj.txt", "pred_focal.txt", "pred_intrinsics.txt", "frame_0000.npy",
            "conf_0000.npy", "init_conf_0000.npy", "frame_0000.png", "scene.glb"]


def check_contract(out_dir, n_frames):
    for fname in CONTRACT:
        assert os.path.exists(os.path.join(out_dir, fname)), fname
    assert np.loadtxt(os.path.join(out_dir, "pred_traj.txt")).shape == (n_frames, 8)
    assert np.loadtxt(os.path.join(out_dir, "pred_intrinsics.txt")).shape == (n_frames, 9)
    depth = np.load(os.path.join(out_dir, f"frame_{n_frames - 1:04d}.npy"))
    assert np.isfinite(depth).all()


def test_clip_text_encoder_matches_jax():
    ids = CLIPTokenizer()(["a video of a street at night", ""])
    kw = dict(vocab_size=49408, width=64, heads=4, layers=3)
    jm = JaxCLIPTextEncoder(dtype=jnp.float32, **kw)
    params = jax_init(jm, jnp.asarray(ids), seed=0)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(ids)))
    pm = CLIPTextEncoder(dtype=torch.float32, **kw)
    pm.load_state_dict(state_dict_from_jax(params, "clip_text"), strict=True)
    with torch.no_grad():
        got = pm(torch.as_tensor(ids, dtype=torch.long))
    assert got.shape == (2, 77, 64) and got.dtype == torch.float32
    assert_close(got, want, 1e-4 * float(np.abs(want).max()), 0.0, "text context")


@pytest.fixture(scope="module")
def tiny_predictions():
    """Tiny-preset predictions of 3 windows over 8 frames (posterior mode,
    injected x_T), made by the port's predict_windows, which
    tests/test_torch_pipeline.py holds to the JAX one; as numpy, so both
    aligners get the same input."""
    model = init_random_(tiny(temporal_length=T, device="meta"), "cpu", seed=0).eval()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(8, H, W, 3), dtype=np.uint8)
    groups = sliding_windows(8, T, 2)
    x_T = rng.normal(size=(len(groups), T, H // 8, W // 8, 16)).astype(np.float32)
    cfg = InferenceConfig(window=T, stride=2, ddim_steps=2, window_batch=len(groups),
                          sample_posterior=False)
    preds = WindowPredictor(model, cfg).predict_windows(
        frames[groups], np.zeros((1, 77, 64), np.float32), fps=24, x_T=x_T)
    return groups, preds


def test_align_predictions_against_jax_aligner(tiny_predictions):
    groups, preds = tiny_predictions
    kw = dict(n_iter=20, depth_traj_start_iter=20)
    ja = JaxGroupAligner(groups, jnp.asarray(preds["pts3d"]), jnp.asarray(preds["conf"]), (H, W),
                         invdepth=jnp.asarray(preds["inv_depth"]), trajs=jnp.asarray(preds["traj"]),
                         config=JaxAlignerConfig(**kw))
    jax_init_from_group(ja, jnp.asarray(preds["pts3d"]), jnp.asarray(preds["conf"]))
    final_j = ja.run()
    pa = align_predictions(groups, preds, (H, W), AlignerConfig(**kw), device="cpu")
    assert pa.params["log_depth"].device.type == "cpu"
    final_p = pa.loss_fn(pa.params, False).item()
    for al, final in ((ja, final_j), (pa, final_p)):
        assert np.isfinite(final)
        assert np.isfinite(al.get_depthmaps()).all() and np.isfinite(al.get_im_poses()).all()
        assert al.get_tum_poses().shape == (8, 8)
    f_j, f_p = float(ja.get_focals()[0]), float(pa.get_focals()[0])
    assert abs(f_p - f_j) <= 0.02 * f_j, (f_p, f_j)


def test_reconstruct_writes_results_contract(tmp_path):
    model = init_random_(tiny(temporal_length=T, device="meta"), "cpu", seed=1).eval()
    frames = np.random.default_rng(1).integers(0, 256, size=(8, H, W, 3), dtype=np.uint8)
    scene, preds, timing = reconstruct(
        model, frames, np.zeros((1, 77, 64), np.float32), fps=24,
        inference_config=InferenceConfig(window=T, stride=2, ddim_steps=2),
        aligner_config=AlignerConfig(n_iter=10, depth_traj_start_iter=5))
    assert isinstance(preds["pts3d"], torch.Tensor)
    assert set(timing) == {"diffusion_s", "alignment_s", "frames", "sec_per_frame"}
    assert timing["frames"] == 8.0 and timing["sec_per_frame"] > 0
    out_dir = str(tmp_path / "seq")
    save_results_dir(out_dir, scene, rgb_frames=frames)
    check_contract(out_dir, 8)
    # the JAX package's exporter, duck-typed on the port's aligner, writes
    # the same bytes; the frame PNGs (the port's own encoder, Pillow's in
    # the JAX package) decode to the same pixels
    jax_dir = str(tmp_path / "jax")
    jax_save_results_dir(jax_dir, scene, rgb_frames=frames)
    assert sorted(os.listdir(out_dir)) == sorted(os.listdir(jax_dir))
    for fname in os.listdir(out_dir):
        a, b = os.path.join(out_dir, fname), os.path.join(jax_dir, fname)
        if fname.endswith(".png"):
            np.testing.assert_array_equal(read_png(a), np.asarray(Image.open(b)), fname)
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), fname


def test_cli_tiny_on_cpu_writes_results_contract(tmp_path):
    from PIL import Image

    img_dir = tmp_path / "clip"
    img_dir.mkdir()
    rng = np.random.default_rng(2)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)).save(
            img_dir / f"{i:03d}.png")
    infer.main(["--video_path", str(img_dir), "--savedir", str(tmp_path / "out"), "--tiny",
                "--device", "cpu", "--height", str(H), "--width", str(W), "--video_length", str(T),
                "--stride", "2", "--ddim_steps", "2", "--n_iter", "8", "--clean_pointcloud"])
    check_contract(str(tmp_path / "out" / "clip" / "clip"), 6)
    assert os.path.exists(tmp_path / "out" / "clip" / "time_cost.txt")


def test_cli_cuda_device_absent_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.resolve_device("cuda")
    assert infer.resolve_device("cpu").type == "cpu"


def test_registry_parameter_counts_match_jax():
    """The shipped YAML through both registries: the same parameter count per
    tower (JAX shapes by eval_shape; the port is built on the meta device)."""
    path = "configs/inference_geo4d.yaml"
    jm, pp_j = jax_build_from_yaml(path)
    pm, pp_p = build_from_yaml(path)
    assert pp_p == pp_j
    key = jax.random.PRNGKey(0)
    inits = {
        "unet": lambda k: jm.unet.init(k, jnp.zeros((1, 16, 8, 8, 20)), jnp.array([0]),
                                       jnp.zeros((1, 77 + 256, 1024)), jnp.array([24])),
        "vae": lambda k: jm.vae.init(k, jnp.zeros((1, 64, 64, 3))),
        "pointmap_vae": lambda k: jm.pointmap_vae.init(k, jnp.zeros((1, 64, 64, 3)),
                                                       method=jm.pointmap_vae.init_all),
        "clip_text": lambda k: jm.text_encoder.init(k, jnp.zeros((1, 77), jnp.int32)),
        "clip_img": lambda k: jm.image_encoder.init(k, jnp.zeros((1, 224, 224, 3))),
        "resampler": lambda k: jm.resampler.init(k, jnp.zeros((1, 16, 257, 1280))),
    }
    for tower, attr in TOWER_MODULES.items():
        want = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(jax.eval_shape(inits[tower], key)))
        got = sum(p.numel() for p in getattr(pm, attr).parameters())
        assert got == want, (tower, got, want)


def test_checkpoint_loader_fills_every_tower(tmp_path):
    """A model .ckpt (Lightning `state_dict` layout, towers under their
    published prefixes) and a vae.ckpt (`model.` prefix) load every tower."""
    want = init_random_(tiny(temporal_length=T, device="meta"), "cpu", seed=4)
    sd = {prefix + k: v for t, prefix in CKPT_PREFIXES.items()
          for k, v in getattr(want, TOWER_MODULES[t]).state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "model.ckpt")
    vae = {"model." + k: v for k, v in want.pointmap_vae.state_dict().items()}
    torch.save({"state_dict": vae}, tmp_path / "vae.ckpt")

    got = init_random_(tiny(temporal_length=T, device="meta"), "cpu", seed=3)
    report = load_checkpoints(got, str(tmp_path / "model.ckpt"), str(tmp_path / "vae.ckpt"),
                              verbose=False)
    assert set(report) == set(TOWER_MODULES)
    got_sd = got.state_dict()
    for k, v in want.state_dict().items():
        assert torch.equal(got_sd[k], v), k

    del sd["cond_stage_model.model.ln_final.weight"]
    torch.save(sd, tmp_path / "partial.ckpt")
    with pytest.raises(KeyError, match="clip_text"):
        load_checkpoints(got, str(tmp_path / "partial.ckpt"), verbose=False)
