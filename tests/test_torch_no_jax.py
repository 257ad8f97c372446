"""The PyTorch port imports nothing of JAX, Flax, Optax, Orbax, OpenCV,
Pillow or the JAX package `geo4d_tpu`: a fresh interpreter in which Pillow
cannot be imported runs the runtime path, `reconstruct` on the tiny preset
from frames to an aligned scene, then the inference CLI from a directory of
PNG frames to a results directory, loads a directory of JPEG frames (the
decoder of data/jpeg.py), runs the evaluation CLI on a synthetic Sintel
sequence and two steps of the training CLI, crops and resizes a frame and
its depth map (data/cropping.py) and reads a rank's batches of the
DataModule (data/loader.py), and checks what is loaded; it then imports
every module of the port (among them data/jpeg.py, data/preprocess.py,
geometry/warp.py, the training modules and parallel/) and checks again."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import os, pkgutil, importlib, shutil, struct, sys, tempfile
sys.modules["PIL"] = None      # import PIL raises: the port must not need it
import numpy as np
import torch

FOREIGN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "geo4d_tpu", "PIL")

def foreign():
    return sorted(m for m, mod in sys.modules.items()
                  if mod is not None and m.split(".")[0] in FOREIGN_ROOTS)

import geo4d_tpu_torch
from geo4d_tpu_torch.alignment.optimizer import AlignerConfig
from geo4d_tpu_torch.cli import evaluate, infer
from geo4d_tpu_torch.data.images import write_png
from geo4d_tpu_torch.data.video import load_image_dir
FIXTURES = os.path.join("tests", "fixtures", "torch_inputs")
from geo4d_tpu_torch.models.presets import init_random_, tiny
from geo4d_tpu_torch.pipeline.inference import InferenceConfig, reconstruct

model = init_random_(tiny(temporal_length=4, device="meta"), "cpu", seed=0).eval()
frames = np.random.default_rng(0).integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
scene, preds, timing = reconstruct(
    model, frames, np.zeros((1, 77, 64), np.float32),
    inference_config=InferenceConfig(window=4, stride=2, ddim_steps=1),
    aligner_config=AlignerConfig(n_iter=4, depth_traj_start_iter=2))
assert scene.get_depthmaps().shape == (6, 32, 32) and np.isfinite(scene.get_depthmaps()).all()
with tempfile.TemporaryDirectory() as tmp:
    os.makedirs(os.path.join(tmp, "clip"))
    for i, f in enumerate(frames):
        write_png(os.path.join(tmp, "clip", f"{i:03d}.png"), f)
    infer.main(["--video_path", os.path.join(tmp, "clip"), "--savedir", os.path.join(tmp, "out"),
                "--tiny", "--device", "cpu", "--height", "32", "--width", "32",
                "--video_length", "4", "--stride", "2", "--ddim_steps", "1", "--n_iter", "4"])
    assert os.path.exists(os.path.join(tmp, "out", "clip", "clip", "pred_traj.txt"))
    os.makedirs(os.path.join(tmp, "jpeg"))
    for name in os.listdir(FIXTURES):
        if name.endswith(".jpg"):
            shutil.copy(os.path.join(FIXTURES, name), os.path.join(tmp, "jpeg", name))
    jpeg_frames, _ = load_image_dir(os.path.join(tmp, "jpeg"), (64, 32))
    assert jpeg_frames.shape == (5, 32, 64, 3)
    # a Sintel sequence: PNG frames, .dpt depths, .cam cameras
    dirs = [os.path.join(tmp, "sintel", "training", d, "alley_2")
            for d in ("final", "depth", "camdata_left")]
    K = np.array([[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]])
    for i in range(6):
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        write_png(os.path.join(dirs[0], f"frame_{i:04d}.png"), frames[i])
        with open(os.path.join(dirs[1], f"frame_{i:04d}.dpt"), "wb") as f:
            f.write(struct.pack("<fii", 202021.25, 32, 32))
            np.full((32, 32), 3.0 + i, np.float32).tofile(f)
        with open(os.path.join(dirs[2], f"frame_{i:04d}.cam"), "wb") as f:
            f.write(struct.pack("<f", 202021.25))
            K.tofile(f)
            np.hstack([np.eye(3), [[0.1 * i], [0.0], [0.0]]]).tofile(f)
    out = evaluate.main(["--dataset", "sintel", "--data_root", os.path.join(tmp, "sintel"),
                         "--savedir", os.path.join(tmp, "eval"), "--seq_list", "alley_2",
                         "--tiny", "--device", "cpu", "--video_length", "4", "--stride", "2",
                         "--ddim_steps", "1", "--n_iter", "4"])
    assert out["pose_failed"] == [] and len(out["depth"]) == 1
    assert os.path.exists(os.path.join(tmp, "eval", "_error_log_all.txt"))
    # two training steps of the tiny preset from .npz shards, with checkpoints
    from geo4d_tpu_torch.cli import train
    os.makedirs(os.path.join(tmp, "shards"))
    rng = np.random.default_rng(1)
    np.savez(os.path.join(tmp, "shards", "clip.npz"),
             **{k: rng.uniform(-1, 1, (4, 32, 32, c)).astype(np.float32) for k, c in
                (("video", 3), ("normed_allpts", 3), ("plucker_raymap", 3),
                 ("plucker_cross", 3), ("inverse_depth", 1))}, fps=24)
    run = train.main(["--data_dir", os.path.join(tmp, "shards"), "--out_dir",
                      os.path.join(tmp, "run"), "--tiny", "--device", "cpu", "--height", "32",
                      "--width", "32", "--video_length", "4", "--steps", "2"])
    assert len(run["losses"]) == 2 and os.path.exists(os.path.join(tmp, "run", "ckpt_final"))
# cropping and the rank-sharded loader (Pillow is not importable here)
from geo4d_tpu_torch.data import cropping, loader
K = np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]])
for out in ((16, 16), (48, 40)):
    img, depth, _ = cropping.crop_resize_to(frames[0], np.ones((32, 32), np.float32), K, out)
    assert img.shape == (out[1], out[0], 3) and depth.shape == (out[1], out[0])
batches = list(loader.DataModule(2, train=[{"x": np.zeros(3)}] * 5, multi_resolution=True,
                                 world_size=2, rank=1).loader("train"))
assert len(batches) == 1 and batches[0]["x"].shape == (2, 3)
assert not foreign(), foreign()
for mod in pkgutil.walk_packages(geo4d_tpu_torch.__path__, "geo4d_tpu_torch."):
    importlib.import_module(mod.name)
assert not foreign(), foreign()
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
