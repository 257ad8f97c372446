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


BLOCKED = r"""
import json, os, sys, tempfile
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "geo4d_tpu"):
    sys.modules[name] = None       # importing any of these now raises
import numpy as np
import torch
from geo4d_tpu_torch.core.profiling import trace
from geo4d_tpu_torch.data.save_video import save_video_grid
from geo4d_tpu_torch.models.presets import init_random_, tiny
from geo4d_tpu_torch.pipeline.export import save_depth_visualizations
from geo4d_tpu_torch.tools import longseq

with tempfile.TemporaryDirectory() as tmp:
    with trace(os.path.join(tmp, "prof")):
        model = init_random_(tiny(temporal_length=16, device="meta"), "cpu", seed=0).eval()
        rec = longseq.run_longseq(model, np.zeros((1, 77, 64), np.float32), frames=16,
                                  hw=(16, 32), window_batch=1, n_iter=2, device="cpu")
    assert rec["windows"] == 1 and np.isfinite(rec["e2e_s"])
    assert json.load(open(os.path.join(tmp, "prof", "trace.json")))["traceEvents"]
    save_video_grid(os.path.join(tmp, "grid.avi"), [np.zeros((2, 8, 8, 3), np.float32)] * 3)
    save_depth_visualizations(os.path.join(tmp, "viz"), np.ones((2, 8, 8), np.float32))
    assert os.path.getsize(os.path.join(tmp, "viz", "depth.gif")) > 0
print("ok")
"""


def test_new_modules_run_with_jax_opencv_and_pillow_blocked():
    """tools/longseq.py, data/save_video.py and core/profiling.py in an
    interpreter where JAX, OpenCV, Pillow and the JAX package cannot be
    imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCKED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


OFFLINE = r"""
import importlib.abc, json, os, sys, tempfile
BLOCK = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "geo4d_tpu", "h5py")

class Blocker(importlib.abc.MetaPathFinder):
    # importing any of BLOCK raises (a finder, not None in sys.modules: scipy
    # looks jax up in sys.modules)
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"No module named {name!r} (blocked)")

sys.meta_path.insert(0, Blocker())
import numpy as np
import geo4d_tpu_torch
from geo4d_tpu_torch.tools import offline_check as oc
from geo4d_tpu_torch.data import preprocess, preprocess_train
from geo4d_tpu_torch.pipeline.export import save_results_dir
from geo4d_tpu_torch.viz.visualizer import export_html, load_results_dir

with tempfile.TemporaryDirectory() as tmp:
    raw, out = os.path.join(tmp, "raw"), os.path.join(tmp, "out")
    man = oc.write_raw(raw, seed=1)
    for case in oc.CASES:
        oc.run_case(case, raw, out, man, seed=1)
        assert oc.list_tree(os.path.join(out, case)), case
    # the HDF5 readers raise the JAX package's errors
    try:
        preprocess_train.megadepth_process_view(raw, "a.jpg", None, None, tmp)
        raise AssertionError("megadepth ran without h5py")
    except RuntimeError as e:
        assert str(e) == "megadepth depth maps need h5py", e
    try:
        preprocess.prepare_nyuv2(tmp)
        raise AssertionError("nyuv2 ran without h5py")
    except ImportError as e:
        assert "h5py" in str(e), e
    # the viewer over a results directory
    res = os.path.join(tmp, "res")
    os.makedirs(res)
    np.savetxt(os.path.join(res, "pred_traj.txt"), [[i, 0.1 * i, 0, 0, 0, 0, 0, 1] for i in range(2)])
    np.savetxt(os.path.join(res, "pred_intrinsics.txt"), [[12, 0, 5, 0, 12, 4, 0, 0, 1]] * 2)
    for i in range(2):
        np.save(os.path.join(res, f"frame_{i:04d}.npy"), np.full((8, 10), 2.0 + i, np.float32))
        oc.write_png(os.path.join(res, f"frame_{i:04d}.png"), np.zeros((8, 10, 3), np.uint8))
    clouds, poses = load_results_dir(res)
    assert len(clouds) == 2 and os.path.exists(export_html(res))
    srv = geo4d_tpu_torch.ViewerServer(res, port=0).start()
    try:
        meta, frames = oc.fetch_viewer(srv.port)
        assert json.loads(meta)["n_frames"] == 2 and len(frames) == 2
    finally:
        srv.stop()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print("ok")
"""


def test_offline_tools_run_with_jax_opencv_pillow_and_h5py_blocked():
    """Every offline tool of the port on seeded raw data, the HDF5 readers'
    errors, and the viewer (load, HTML export, websocket server), in an
    interpreter where JAX, OpenCV, Pillow, h5py and the JAX package cannot
    be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", OFFLINE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
