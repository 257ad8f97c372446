"""The port's own copies of the JAX package's numpy-only modules against the
originals, on the same inputs: trajectory metrics (exact), the YAML config
(the same trees and the same errors), the CLIP tokenizer (the same ids
with a merge table; a fallback that repeats across processes), frame
loading (the same uint8 frames), the epoch-seeded batch sampler (the
same plans), the loader's collation and worker split, and the intrinsics
and crop geometry of data/cropping.py (its resizes, which the original does
through Pillow and OpenCV, are held in tests/test_torch_data_loader.py). The results exporter is held to the
original in tests/test_torch_reconstruct.py. The offline tools' and the
viewer's numpy-only functions are kept verbatim: their code (docstrings
aside) is the original's, statement for statement; what they compute is held
to the original in tests/test_torch_preprocess_train.py and
tests/test_torch_viz.py."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from geo4d_tpu.core import config as jax_config
from geo4d_tpu.data import cropping as jax_cropping
from geo4d_tpu.data import loader as jax_loader
from geo4d_tpu.data import sampler as jax_sampler
from geo4d_tpu.data import tokenizer as jax_tokenizer
from geo4d_tpu.data import video as jax_video
from geo4d_tpu.evals import trajectory as jax_traj
from geo4d_tpu_torch.core import config as port_config
from geo4d_tpu_torch.data import cropping as port_cropping
from geo4d_tpu_torch.data import loader as port_loader
from geo4d_tpu_torch.data import sampler as port_sampler
from geo4d_tpu_torch.data import tokenizer as port_tokenizer
from geo4d_tpu_torch.data import video as port_video
from geo4d_tpu_torch.evals import trajectory as port_traj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_poses(rng, n, near_half_turn=False):
    q = rng.normal(size=(n, 4))
    if near_half_turn:               # w ~ 0: the trace is negative, other branches run
        q[:, 0] = rng.normal(scale=1e-3, size=n)
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :3] = jax_traj.quat_wxyz_to_rotmat(q)
    P[:, :3, 3] = rng.normal(size=(n, 3))
    return P


@pytest.mark.parametrize("case", ["to_tum", "to_tum_half_turns", "eval_metrics",
                                  "align_trajectory_with_eval"])
def test_trajectory_metrics_match_jax(case):
    rng = np.random.default_rng(0)
    est = random_poses(rng, 12, near_half_turn=case == "to_tum_half_turns")
    ref = random_poses(rng, 12)
    if case.startswith("to_tum"):
        np.testing.assert_array_equal(port_traj.Trajectory.from_matrices(est).to_tum(),
                                      jax_traj.Trajectory.from_matrices(est).to_tum())
        return
    got = getattr(port_traj, case)(port_traj.Trajectory.from_matrices(est),
                                   port_traj.Trajectory.from_matrices(ref))
    want = getattr(jax_traj, case)(jax_traj.Trajectory.from_matrices(est),
                                   jax_traj.Trajectory.from_matrices(ref))
    assert got[:3] == want[:3]
    if case == "align_trajectory_with_eval":
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[4].matrices(), want[4].matrices())


def test_config_matches_jax():
    path = os.path.join(REPO, "configs", "inference_geo4d.yaml")
    assert port_config.load_config(path) == jax_config.load_config(path)
    for mod in (port_config, jax_config):
        reg = mod.Registry()
        reg.register("a.B", "lvdm.B")(lambda x=1, y=2: (x, y))
        assert "lvdm.B" in reg and "c" not in reg
        assert mod.instantiate({"target": "lvdm.B", "params": {"x": 5}}, reg, y=7) == (5, 7)
        with pytest.raises(KeyError, match="duplicate"):
            reg.register("a.B")(lambda: None)
        with pytest.raises(KeyError, match="unknown target"):
            mod.instantiate({"target": "nope"}, reg)
        with pytest.raises(ValueError, match="not an instantiable"):
            mod.instantiate({"params": {}}, reg)


PROMPTS = ["Output a video that assigns each 3D location in the world a consistent color.",
           "it's 123 o'clock &amp; naïve_café!!", "", "   spaces\tand\nlines  "]


@pytest.fixture(scope="module")
def merge_table(tmp_path_factory):
    """A small merge table in the CLIP file layout (header line, then one
    merge per line): every merge joins two symbols the table already has."""
    merges = ["o u", "t p", "ou tp", "outp u", "c o", "co l", "col o", "colo r</w>", "i t",
              "t h", "th e</w>", "l o", "lo c", "a t", "i o", "io n</w>", "e a", "ea c", "h</w>",
              "v i", "vi d", "e o</w>", "w o", "wo r", "l d</w>", "n a", "c a", "f é</w>"]
    path = tmp_path_factory.mktemp("bpe") / "merges.txt"
    path.write_text("#version: 0.2\n" + "\n".join(merges) + "\n", encoding="utf-8")
    return str(path)


def test_tokenizer_matches_jax_with_a_merge_table(merge_table):
    got = port_tokenizer.CLIPTokenizer(merge_table)(PROMPTS)
    want = jax_tokenizer.CLIPTokenizer(merge_table)(PROMPTS)
    assert got.dtype == np.int32 and got.shape == (4, 77)
    np.testing.assert_array_equal(got, want)
    assert ((got[0] >= 512) & (got[0] < 49406)).any()          # merges fired


def test_tokenizer_fallback_repeats_across_processes():
    """Without a merge table each word is CRC-32-hashed, so a prompt gives
    the same ids in every process (Python's `hash` of a str would not)."""
    ids = port_tokenizer.CLIPTokenizer()(PROMPTS[0])
    words = PROMPTS[0].lower().split()
    assert ids[0, 0] == 49406 and ids[0, len(words) + 1] == 49407 and not ids[0, len(words) + 2:].any()
    assert ids[0, 1] == zlib.crc32(b"output") % 49405 + 1
    code = ("from geo4d_tpu_torch.data.tokenizer import CLIPTokenizer; "
            f"print(CLIPTokenizer()({PROMPTS[0]!r}).tolist())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED="random"),
                         timeout=120, check=True).stdout
    assert out.strip() == str(ids.tolist())


def test_load_image_dir_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, size=(30, 50, 3), dtype=np.uint8)).save(
            tmp_path / f"{i:03d}.png")
    (tmp_path / "notes.txt").write_text("not a frame")
    got, names = port_video.load_image_dir(str(tmp_path), (40, 24), max_frames=2)
    want, want_names = jax_video.load_image_dir(str(tmp_path), (40, 24), max_frames=2,
                                                raw_uint8=True)
    assert got.shape == (2, 24, 40, 3) and got.dtype == np.uint8 and names == want_names
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride,max_frames", [(1, -1), (2, 30)])
def test_load_video_matches_jax(tmp_path, stride, max_frames):
    """The native decoder through both loaders: the same frames, fps and
    last-frame padding."""
    import cv2

    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (64, 48))
    yy, xx = np.mgrid[:48, :64].astype(np.float32)
    for i in range(20):
        writer.write(np.stack([xx * 3 + i * 5, yy * 4, (xx + yy) * 2], -1).clip(0, 255)
                     .astype(np.uint8))
    writer.release()
    got, fps = port_video.load_video(path, stride, (24, 32), max_frames)
    assert jax_video._load_native(), "the native decoder did not build"
    want, want_fps = jax_video.load_video(path, stride, (24, 32), max_frames, raw_uint8=True)
    assert got.dtype == np.uint8 and fps == want_fps == 24 // stride
    assert got.shape == (20 // stride if max_frames < 0 else max_frames, 24, 32, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,batch,pool,world", [(7, 2, 1, 1), (23, 3, 4, 2), (10, 4, 2, 1)])
def test_sampler_matches_jax(n, batch, pool, world):
    for up in (False, True):
        assert port_sampler.round_by(n, batch * world, up) == jax_sampler.round_by(
            n, batch * world, up)
    for epoch in range(3):
        got = port_sampler.epoch_plan(n, batch, pool, epoch, world)
        want = jax_sampler.epoch_plan(n, batch, pool, epoch, world)
        np.testing.assert_array_equal(got, want)
        for rank in range(world):
            np.testing.assert_array_equal(port_sampler.shard_plan(got, rank, world, batch),
                                          jax_sampler.shard_plan(want, rank, world, batch))
    for rank in range(world):
        ours = port_sampler.BatchedRandomSampler(n, batch, pool, world, rank)
        theirs = jax_sampler.BatchedRandomSampler(n, batch, pool, world, rank)
        ours.set_epoch(5)
        theirs.set_epoch(5)
        assert len(ours) == len(theirs) and list(ours) == list(theirs)


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_collate_and_worker_split_match_jax():
    samples = [{"video": np.full((2, 3), i, np.float32), "fps": 24 - i, "scale": i / 3,
                "name": f"clip{i}", "pair": (np.arange(i, i + 2), i)} for i in range(4)]
    _same(port_loader.default_collate(samples), jax_loader.default_collate(samples))
    _same(port_loader.default_collate([(1, 2.0), (3, 4.0)]),
          jax_loader.default_collate([(1, 2.0), (3, 4.0)]))
    for n in (1, 10, 11):
        ds = list(range(n))
        for workers in (1, 3, 4):
            for w in range(workers):
                assert port_loader.shard_iterable(ds, w, workers) == \
                    jax_loader.shard_iterable(ds, w, workers)


K_CROP = np.array([[120.0, 0.0, 61.3], [0.0, 118.0, 40.7], [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("case", ["colmap", "camera_matrix_of_crop", "bbox", "crop",
                                  "center_crop"])
def test_crop_geometry_matches_jax(case):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 20.0, (45, 61)).astype(np.float32)
    if case == "colmap":
        for fn in ("opencv_to_colmap_intrinsics", "colmap_to_opencv_intrinsics"):
            np.testing.assert_array_equal(getattr(port_cropping, fn)(K_CROP),
                                          getattr(jax_cropping, fn)(K_CROP))
    elif case == "camera_matrix_of_crop":
        for kw in ({}, {"scaling": 2.7, "offset_factor": 0.3}, {"scaling": 3.0, "offset": (4, 9)}):
            np.testing.assert_array_equal(
                port_cropping.camera_matrix_of_crop(K_CROP, (61, 45), (60, 40), **kw),
                jax_cropping.camera_matrix_of_crop(K_CROP, (61, 45), (60, 40), **kw))
    elif case == "bbox":
        for K_out in (K_CROP * 0.9, K_CROP + 3.49):
            assert port_cropping.bbox_from_intrinsics_in_out(K_CROP, K_out, (40, 30)) == \
                jax_cropping.bbox_from_intrinsics_in_out(K_CROP, K_out, (40, 30))
    else:
        args = (0.7,) if case == "center_crop" else ((3, 5, 40, 30),)
        fn = "center_crop_image_depthmap" if case == "center_crop" else "crop_image_depthmap"
        for d in (depth, None):
            got = getattr(port_cropping, fn)(img, d, K_CROP, *args)
            want = getattr(jax_cropping, fn)(img, d, K_CROP, *args)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(g, w)


# functions and classes of the offline tools and the viewer kept verbatim
VERBATIM = {
    "data.habitat_prep": ["PerspectiveCamera", "camera_intrinsics_from_hfov",
                          "colmap_to_opencv_intrinsics", "crop_remap_coords", "envmap_pointmap",
                          "equirect_project", "equirect_unproject", "make_habitat_render_fn",
                          "opencv_to_colmap_intrinsics", "perspective_project",
                          "perspective_unproject", "pixel_grid"],
    "viz.server": ["ViewerServer", "main", "ws_accept_key", "ws_decode", "ws_encode",
                   "_PLAYER_PAGE"],
    "viz.visualizer": ["export_html", "main", "_HTML_TEMPLATE"],
    "data.sens_reader": ["SensFrame", "SensHeader", "_read_mat4", "iter_frames", "main",
                         "read_header"],
    "data.preprocess_train": ["arkit_scene_orientation", "arkitscenes_concat_metadata",
                              "co3d_get_set_list", "colmap_qt_to_w2c", "load_blendedmvs_cam",
                              "load_megadepth_poses", "load_pfm", "ndc_to_pinhole_intrinsics",
                              "object_centric_crop", "prepare_blendedmvs",
                              "prepare_staticthings3d", "pytorch3d_camera_to_opencv_pose",
                              "read_arkit_traj", "read_float3", "scannetpp_concat_metadata",
                              "scannetpp_frame_number", "waymo_extract_frames",
                              "waymo_make_video_pairs", "wildrgbd_get_set_list"],
}


def _code(module) -> dict:
    """Top-level definitions and assignments of a module's source, as AST
    dumps without docstrings (formatting and comments do not count)."""
    out = {}
    for node in ast.parse(inspect.getsource(module)).body:
        for n in ast.walk(node):
            if (isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.body
                    and isinstance(n.body[0], ast.Expr)
                    and isinstance(n.body[0].value, ast.Constant)
                    and isinstance(n.body[0].value.value, str)):
                n.body = n.body[1:] or [ast.Pass()]
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node.value)
    return out


@pytest.mark.parametrize("module", list(VERBATIM))
def test_offline_and_viewer_copies_are_verbatim(module):
    port = _code(importlib.import_module(f"geo4d_tpu_torch.{module}"))
    jax = _code(importlib.import_module(f"geo4d_tpu.{module}"))
    for name in VERBATIM[module]:
        assert port[name] == jax[name], f"{module}.{name} differs from the original"
