"""The PyTorch port's evaluation path against the JAX package (or against
Pillow and OpenCV, which the JAX package calls), on the CPU: the PNG codec
and the Lanczos frame resize (data/images.py), the dataset readers, the
bicubic resize to the ground truth's resolution, depth evaluation in every
alignment mode, the evaluation loop file for file, and the port's CLI end to
end on a synthetic Sintel layout (18 frames of `alley_2`, .dpt depths, .cam
cameras).

Tolerances:
  * PNG decode, Lanczos, the readers and the trajectories: exact;
  * bicubic resize: 1e-5 of each map's largest magnitude against
    cv2.INTER_CUBIC; the thresholded mask equal except where cv2's value
    lies within 1e-5 of 0.8;
  * depth evaluation with lstsq, scale, median, none: metrics, s, t and the
    error map 1e-5 relative;
  * lad2 at its defaults (lr 1e-4, 1000 steps): s and t 1e-3 relative;
  * lad2 at the evaluation's lr 1e-2 and 5000 steps: the port's L1
    objective at most 1e-3 (relative) above the JAX package's, the
    metrics 1e-3 relative. Adam on an L1 objective near its optimum
    amplifies summation order: over six inputs the objectives agreed
    within 7.5e-6 while the metrics moved 7e-4 to 2.1e-3 apart; the test
    holds one of them (7.3e-4);
  * the evaluation loop on one fixed scene: the lad2-driven depth numbers
    of the logs 1e-3 relative, the pose numbers 1e-6, the results files
    equal; the error maps within 1 LSB of the JAX package's (the fits end
    apart, see above) and equal, but at <= 0.1% of pixels, to the JAX
    formula evaluated with the port's own (s, t).
"""

import io
import os
import re
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from geo4d_tpu.data import datasets as jax_datasets
from geo4d_tpu.data.video import load_image_dir as jax_load_image_dir
from geo4d_tpu.evals import depth as jax_depth
from geo4d_tpu.evals.trajectory import Trajectory as JaxTrajectory
from geo4d_tpu.evals.trajectory import quat_wxyz_to_rotmat
from geo4d_tpu_torch.cli import evaluate as port_evaluate
from geo4d_tpu_torch.data import datasets as port_datasets
from geo4d_tpu_torch.data import images
from geo4d_tpu_torch.data.video import load_image_dir
from geo4d_tpu_torch.evals import depth as port_depth
from test_cli_evaluate import _write_cam, _write_dpt

torch.set_num_threads(1)
SEQ = "alley_2"
N_FRAMES, GT_H, GT_W = 18, 48, 96


def write_sintel(root):
    """The Sintel layout of tests/test_cli_evaluate.py: 18 shifted random
    frames (PNG by data/images.py), a smooth depth field with 5% noise, and
    cameras stepping along x."""
    dirs = [os.path.join(root, "training", d, SEQ) for d in ("final", "depth", "camdata_left")]
    for d in dirs:
        os.makedirs(d)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (GT_H, GT_W, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:GT_H, :GT_W]
    K = np.array([[100.0, 0, GT_W / 2], [0, 100.0, GT_H / 2], [0, 0, 1]])
    for i in range(N_FRAMES):
        images.write_png(os.path.join(dirs[0], f"frame_{i + 1:04d}.png"),
                         np.roll(base, 2 * i, axis=1))
        depth = (2 + 4 * xx / GT_W + yy / GT_H + 0.1 * i) * rng.uniform(0.95, 1.05, xx.shape)
        _write_dpt(os.path.join(dirs[1], f"frame_{i + 1:04d}.dpt"), depth)
        E = np.hstack([np.eye(3), np.array([[0.05 * i], [0.0], [0.0]])])
        _write_cam(os.path.join(dirs[2], f"frame_{i + 1:04d}.cam"), K, E)
    return root


@pytest.fixture(scope="module")
def sintel_root(tmp_path_factory):
    return write_sintel(str(tmp_path_factory.mktemp("sintel")))


# ------------------------------------------------------------ PNG and Lanczos


def pattern(h, w, c, dtype=np.uint8, seed=0):
    """Bands of noise, repeated rows, ramps and a smooth noisy field, so that
    an adaptive PNG writer has reason to choose each row filter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    top = 255 if dtype == np.uint8 else 65535
    f = top / 255
    img = np.stack([(xx * 2 + yy * 3) * f + rng.integers(0, 3, (h, w)) * f + k * 40 * f
                    for k in range(c)], -1) % (top + 1)
    img[: h // 4] = rng.integers(0, top + 1, img[: h // 4].shape)
    img[h // 4: h // 2] = (xx[:1, :, None] * 7 * f) % (top + 1)
    img[h // 2: 5 * h // 8] = ((xx * 5 * f) % (top + 1))[h // 2: 5 * h // 8, :, None]
    img = img.astype(dtype)
    return img[..., 0] if c == 1 else img


def png_filters(data: bytes) -> set:
    """The row filter types of a non-interlaced PNG file's bytes."""
    pos, idat = 8, b""
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    row = 1 + w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    return set(np.frombuffer(zlib.decompress(idat), np.uint8)[::row][:h].tolist())


def bgr(img):
    """RGB(A) <-> OpenCV's BGR(A) channel order."""
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[2]]] if img.shape[2] >= 3 else img


CODEC_CASES = {"gray8": (1, np.uint8), "gray16": (1, np.uint16), "gray_alpha8": (2, np.uint8),
               "rgb8": (3, np.uint8), "rgba8": (4, np.uint8), "rgb16": (3, np.uint16)}
# OpenCV's writer with each row filter forced, then libpng's adaptive choice
CV2_FILTERS = {"none": 0, "sub": 1, "up": 2, "avg": 3, "paeth": 4, "adaptive": None}


# Pillow writes no 16-bit RGB, OpenCV no gray + alpha
DECODE_CASES = [(case, writer) for case, (c, dtype) in CODEC_CASES.items()
                for writer in ["pillow"] + [f"cv2_{k}" for k in CV2_FILTERS]
                if not (writer == "pillow" and case == "rgb16")
                and not (writer != "pillow" and c == 2)]


@pytest.mark.parametrize("case,writer", DECODE_CASES)
def test_png_decode_matches_opencv_and_pillow(case, writer):
    c, dtype = CODEC_CASES[case]
    img = pattern(40, 70, c, dtype)
    if writer == "pillow":
        b = io.BytesIO()
        Image.fromarray(img, mode={2: "LA"}.get(c)).save(b, format="PNG")
        data = b.getvalue()
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    else:
        name = writer[4:]
        flag = (cv2.IMWRITE_PNG_ALL_FILTERS if name == "adaptive"
                else getattr(cv2, f"IMWRITE_PNG_FILTER_{name.upper()}"))
        ok, buf = cv2.imencode(".png", bgr(img), [cv2.IMWRITE_PNG_FILTER, flag])
        data = buf.tobytes()
        if CV2_FILTERS[name] is not None:
            assert png_filters(data) == {CV2_FILTERS[name]}
        np.testing.assert_array_equal(bgr(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)), img)
        if case == "gray16":                     # the evaluation's depth-PNG read
            np.testing.assert_array_equal(images.decode_png(data),
                                          cv2.imdecode(buf, cv2.IMREAD_ANYDEPTH))
    got = images.decode_png(data)
    assert got.dtype == dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("shape", [(33, 47), (33, 47, 3)])
def test_png_encode_decodes_equal(shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    data = images.encode_png(img)
    np.testing.assert_array_equal(images.decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(
        bgr(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)), img)


def test_png_refuses_interlaced_palette_and_other_depths(tmp_path):
    """Adam7, palette and 1-bit files decode as Pillow decodes them
    (test_torch_formats.py holds every mode); what no PNG reader takes is
    refused: an unknown interlace method, a palette without PLTE, a bit depth
    that the colour type does not allow."""
    data = bytearray(images.encode_png(np.zeros((4, 5, 3), np.uint8)))
    data[28] = 2                                 # IHDR interlace method: none is 2
    path = str(tmp_path / "interlaced.png")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=r"interlaced.png: .*\(interlace 2\)"):
        images.read_png(path)
    path = str(tmp_path / "palette.png")
    Image.fromarray(pattern(8, 8, 3)).convert("P").save(path)
    np.testing.assert_array_equal(images.read_png(path),
                                  np.asarray(Image.open(path).convert("RGB")))
    with open(path, "rb") as f:
        data = f.read()
    start = data.index(b"PLTE") - 4
    data = data[:start] + data[start + 12 + int.from_bytes(data[start:start + 4], "big"):]
    with pytest.raises(ValueError, match="palette.png: palette PNG without a PLTE chunk"):
        images.decode_png(data, "palette.png")
    path = str(tmp_path / "bits.png")
    Image.fromarray(np.eye(8, dtype=bool)).save(path)
    np.testing.assert_array_equal(images.read_png(path), np.asarray(Image.open(path).convert("L")))
    data = bytearray(images.encode_png(np.zeros((4, 5, 3), np.uint8)))
    data[24] = 4                                 # IHDR bit depth 4 for RGB
    with pytest.raises(ValueError, match="bits.png: PNG colour type 2 at bit depth 4"):
        images.decode_png(bytes(data), "bits.png")
    with pytest.raises(ValueError, match="encode_png takes uint8"):
        images.encode_png(np.zeros((4, 4, 3), np.uint16))     # 16-bit gray is written


@pytest.mark.parametrize("src,dst", [((436, 1024), (576, 256)), ((48, 96), (576, 256)),
                                     ((64, 96), (40, 100)), ((7, 1), (5, 3)), ((13, 17), (1, 1)),
                                     ((30, 50), (50, 30))])
def test_lanczos_matches_pillow(src, dst):
    img = pattern(*src, 3, seed=3)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.LANCZOS))
    got = images.lanczos_resize(img, dst)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_load_image_dir_needs_no_pillow_for_png(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)).save(
            tmp_path / f"{i:03d}.png")
    Image.fromarray(rng.integers(0, 256, (30, 50), dtype=np.uint8)).save(tmp_path / "003.png")
    want, _ = jax_load_image_dir(str(tmp_path), (40, 24), raw_uint8=True)
    monkeypatch.setitem(sys.modules, "PIL", None)            # import PIL now fails
    got, names = load_image_dir(str(tmp_path), (40, 24))
    assert got.shape == (4, 24, 40, 3) and len(names) == 4
    np.testing.assert_array_equal(got, want)
    # JPEG frames take data/jpeg.py, not Pillow: a broken one is its error
    (tmp_path / "004.jpg").write_bytes(b"")
    with pytest.raises(ValueError, match="004.jpg: not a JPEG file"):
        load_image_dir(str(tmp_path), (40, 24))


# ------------------------------------------------------------ dataset readers


def test_dataset_tables_match_jax():
    for name in ("DATASET_RESOLUTION", "DATASET_FPS", "SINTEL_POSE_SEQS", "BONN_SEQS",
                 "DEFAULT_PROMPT"):
        assert getattr(port_datasets, name) == getattr(jax_datasets, name), name
    assert set(port_datasets.DATASETS) == set(jax_datasets.DATASETS)
    for name, spec in jax_datasets.DATASETS.items():
        mine = port_datasets.DATASETS[name]
        for field in ("name", "traj_format", "seq_list", "depth_reader"):
            assert getattr(mine, field) == getattr(spec, field), (name, field)
        for field in ("img_dir", "gt_traj", "depth_path"):
            fn, want = getattr(mine, field), getattr(spec, field)
            assert (fn is None) == (want is None), (name, field)
            if fn is not None:
                assert fn("/r", "s") == want("/r", "s"), (name, field)


def test_load_eval_sequence_matches_jax(sintel_root):
    want = jax_datasets.load_eval_sequence("sintel", sintel_root, SEQ, max_frames=12)
    got = port_datasets.load_eval_sequence("sintel", sintel_root, SEQ, max_frames=12)
    assert got.frames.dtype == np.uint8 and got.frames.shape == (12, 256, 576, 3)
    np.testing.assert_array_equal((got.frames.astype(np.float32) / 255.0 - 0.5) * 2.0,
                                  want.frames)
    for field in ("gt_depth", "gt_traj", "intrinsics"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
    assert (got.seq, got.fps, got.caption) == (want.seq, want.fps, want.caption)
    for name in ("sintel", "custom"):
        assert (port_datasets.list_sequences(name, sintel_root)
                == jax_datasets.list_sequences(name, sintel_root))


@pytest.mark.parametrize("dataset", ["bonn", "scannet", "kitti"])
def test_depth_png_and_trajectories_match_jax(tmp_path, dataset):
    """16-bit depth PNGs written by OpenCV (read by cv2 in the JAX package)
    and the TUM / flattened-matrix trajectory files."""
    root, seq = str(tmp_path), "seq0"
    spec = jax_datasets.DATASETS[dataset]
    ddir = spec.depth_path(root, seq)
    os.makedirs(ddir)
    rng = np.random.default_rng(5)
    for i in range(3):
        cv2.imwrite(os.path.join(ddir, f"{i:05d}.png"), pattern(20, 30, 1, np.uint16, i))
    traj = spec.gt_traj(root, seq)
    if traj is not None:
        poses = np.tile(np.eye(4), (5, 1, 1))
        q = rng.normal(size=(5, 4))
        poses[:, :3, :3] = quat_wxyz_to_rotmat(q)
        poses[:, :3, 3] = rng.normal(size=(5, 3))
        rows = (JaxTrajectory.from_matrices(poses).to_tum() if spec.traj_format == "tum"
                else poses.reshape(5, 16))
        np.savetxt(traj, np.concatenate([rows, rng.normal(size=(5, 1))], 1)
                   if spec.traj_format == "tum" else rows)
    want_d = jax_datasets.read_gt_depths(spec, root, seq)
    got_d = port_datasets.read_gt_depths(port_datasets.DATASETS[dataset], root, seq)
    assert got_d.dtype == np.float32 and got_d.shape == (3, 20, 30)
    np.testing.assert_array_equal(got_d, want_d)
    want_t = jax_datasets.load_traj(spec, root, seq)
    got_t = port_datasets.load_traj(port_datasets.DATASETS[dataset], root, seq)
    assert (got_t is None) == (want_t is None) == (traj is None)
    if want_t is not None:
        np.testing.assert_array_equal(got_t, want_t)


# ------------------------------------------------------------ resize to GT


@pytest.mark.parametrize("src,dst", [((32, 64), (48, 96)), ((256, 576), (436, 1024)),
                                     ((48, 96), (20, 37)), ((1, 7), (5, 9)), ((9, 1), (4, 3))])
def test_bicubic_resize_matches_opencv(src, dst):
    maps = np.random.default_rng(6).uniform(0.5, 8.0, (2,) + src).astype(np.float32)
    want = np.stack([cv2.resize(m, dst[::-1], interpolation=cv2.INTER_CUBIC).reshape(dst)
                     for m in maps])
    got = port_evaluate.resize_to_gt(maps, dst, torch.device("cpu"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("border", [False, True])
def test_align_mask_threshold_matches_opencv(border):
    """Validity masks resized and cut at 0.8; `border` leaves a one-pixel
    invalid frame round each map, as the sky/far mask of a real scene can."""
    rng = np.random.default_rng(7)
    masks = rng.uniform(size=(3, 8, 16)) > 0.3
    masks = np.repeat(np.repeat(masks, 4, 1), 4, 2)          # blobs, (3, 32, 64)
    if border:
        masks[:] = True
        masks[:, [0, -1]] = False
        masks[:, :, [0, -1]] = False
    want_v = np.stack([cv2.resize(m.astype(np.float32), (96, 48), interpolation=cv2.INTER_CUBIC)
                       for m in masks])
    got = port_evaluate.resize_to_gt(masks, (48, 96), torch.device("cpu")) > 0.8
    differ = got != (want_v > 0.8)
    assert not differ[np.abs(want_v - 0.8) >= 1e-5].any()


# ------------------------------------------------------------ depth evaluation


def depth_case(seed=8, shape=(3, 24, 32), noisy=False):
    """Ground truth with invalid (0) and far (> 70) pixels, and a prediction
    at 0.4 x the depth but for 10% outliers, so that the scale-only
    Weiszfeld fit has a sharp optimum (on noisy data it stops, in float32,
    at points that depend on summation order: 1e-3 apart between the two
    packages). `noisy`: 0.4 x the depth + 0.3, times 0.8-1.2, the flat
    optimum the lad2 tests take (Adam at lr 1e-2 jitters around a sharp
    one)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1.0, 90.0, shape).astype(np.float32)
    gt[rng.uniform(size=shape) < 0.1] = 0.0
    if noisy:
        pred = (0.4 * gt + 0.3) * rng.uniform(0.8, 1.2, shape)
    else:
        pred = 0.4 * gt * np.where(rng.uniform(size=shape) < 0.1, rng.uniform(0.5, 2, shape), 1)
    return pred.astype(np.float32), gt, rng.uniform(size=shape) > 0.3, rng.uniform(size=shape) > 0.2


def rel_close(got, want, rtol, what):
    assert abs(got - want) <= rtol * max(abs(want), 1e-12), (what, got, want)


@pytest.mark.parametrize("masks", ["plain", "masked_clipped"])
@pytest.mark.parametrize("align", ["lstsq", "scale", "median", "none"])
def test_depth_evaluation_matches_jax(align, masks):
    pred, gt, custom, amask = depth_case()
    kw = dict(align=align, max_depth=70.0, return_st=True, return_error_map=True)
    if masks == "masked_clipped":
        kw.update(custom_mask=custom, align_mask=amask, post_clip_min=2.0, post_clip_max=60.0)
    want, want_err = jax_depth.depth_evaluation(pred, gt, **kw)
    got, got_err = port_depth.depth_evaluation(pred, gt, device="cpu", **kw)
    assert set(got) == set(want) and got["valid_pixels"] == want["valid_pixels"]
    for k, v in want.items():
        rel_close(got[k], v, 1e-5, k)
    assert got_err.shape == gt.shape
    np.testing.assert_allclose(got_err, want_err, rtol=0, atol=1e-5 * float(want_err.max()))


def test_lad2_defaults_match_jax():
    """lr 1e-4, 1000 steps, single and batched over a group axis. The
    offset of 3 lies farther than 1000 steps of ~1e-4 can go, so both
    packages walk the same path."""
    pred, gt, _, amask = depth_case(shape=(3, 400), noisy=True)
    pred = pred + 3.0
    mask = (gt > 0) & amask
    want = jax_depth.lad2_align_batched(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask),
                                        1e-4, 1000)
    got = port_depth.lad2_align(torch.from_numpy(pred), torch.from_numpy(gt),
                                torch.from_numpy(mask))
    single = port_depth.lad2_align(torch.from_numpy(pred[1]), torch.from_numpy(gt[1]),
                                   torch.from_numpy(mask[1]))
    for name, g, w, one in zip("st", got, want, single):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=0, err_msg=name)
        rel_close(float(one), float(g[1]), 1e-6, f"batched {name}")


def test_lad2_at_the_evaluation_settings_matches_jax():
    pred, gt, _, amask = depth_case(shape=(2, 48, 64), noisy=True)
    kw = dict(max_depth=70.0, align="lad2", align_mask=amask, lr=1e-2, max_iters=5000,
              post_clip_max=70.0, return_st=True)
    want = jax_depth.depth_evaluation(pred, gt, **kw)
    got = port_depth.depth_evaluation(pred, gt, device="cpu", **kw)
    fit = (gt > 0) & (gt < 70.0) & amask

    def l1(r):
        return float(np.abs(r["s"] * pred.astype(np.float64) + r["t"] - gt)[fit].sum())

    assert l1(got) <= l1(want) * (1 + 1e-3), (l1(got), l1(want))
    for k in ("Abs Rel", "Sq Rel", "RMSE", "Log RMSE", "δ < 1.25", "δ < 1.25^2", "δ < 1.25^3"):
        rel_close(got[k], want[k], 1e-3, k)


def test_depth_evaluation_runs_where_told(monkeypatch):
    pred, gt, _, _ = depth_case(shape=(50,))
    out = port_depth.depth_evaluation(torch.from_numpy(pred), torch.from_numpy(gt), align="lstsq")
    rel_close(out["Abs Rel"], port_depth.depth_evaluation(pred, gt, align="lstsq",
                                                          device="cpu")["Abs Rel"], 0, "tensor")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_depth.depth_evaluation(pred, gt, align="lstsq")


# ------------------------------------------------------------ the evaluation loop


class FixedScene:
    """One aligned scene, made from a seed, with the getters the evaluation
    and the exporter read (numpy, as both packages' aligners return): depth
    maps at 32 x 64 near half the layout's ground truth, with 10% noise."""

    def __init__(self, seed=9, h=32, w=64):
        rng = np.random.default_rng(seed)
        self.N = N_FRAMES
        yy, xx = np.mgrid[:h, :w]
        base = (2 + 4 * xx / w + yy / h) * 0.5 + 0.3
        self.depth = np.stack([base + 0.05 * i for i in range(self.N)])
        self.depth = (self.depth * rng.uniform(0.9, 1.1, self.depth.shape)).astype(np.float32)
        self.conf = rng.uniform(0.5, 3.0, self.depth.shape).astype(np.float32)
        self.poses = np.tile(np.eye(4), (self.N, 1, 1))
        self.poses[:, 0, 3] = 0.11 * np.arange(self.N) + rng.normal(0, 0.01, self.N)
        self.poses[:, 1, 3] = rng.normal(0, 0.01, self.N)
        angle = rng.normal(0, 0.02, self.N)
        self.poses[:, 0, 0] = self.poses[:, 2, 2] = np.cos(angle)
        self.poses[:, 0, 2], self.poses[:, 2, 0] = np.sin(angle), -np.sin(angle)
        self.poses = self.poses.astype(np.float32)
        self.valid = rng.uniform(size=(2, 16, h, w)) > 0.1
        self.pnp_failures = 0

    def get_depthmaps(self):
        return self.depth

    def get_conf(self):
        return self.conf

    def get_init_conf(self):
        return self.conf

    def get_focals(self):
        return np.full(self.N, 60.0, np.float32)

    def get_intrinsics(self):
        K = np.tile(np.eye(3, dtype=np.float32), (self.N, 1, 1))
        K[:, 0, 0] = K[:, 1, 1] = 60.0
        return K

    def get_im_poses(self):
        return self.poses

    def get_tum_poses(self):
        return JaxTrajectory.from_matrices(self.poses).to_tum()

    def get_pts3d(self):
        return np.zeros(self.depth.shape + (3,), np.float32)


TIMING = {"diffusion_s": 1.5, "alignment_s": 2.5, "frames": float(N_FRAMES),
          "sec_per_frame": 4.0 / N_FRAMES}
FLOAT = re.compile(r"[-+]?\d+\.\d+(?:[eE][-+]?\d+)?|\d+")


def numbers(path):
    with open(path) as f:
        return [[float(x) for x in FLOAT.findall(line)] for line in f]


def test_evaluation_loop_files_match_jax(sintel_root, tmp_path, monkeypatch):
    """Both packages' CLIs on the same layout, with model building and
    reconstruct replaced by one fixed scene (reconstruct itself is held to
    the JAX package elsewhere)."""
    import geo4d_tpu.cli.common as jax_common
    import geo4d_tpu.cli.evaluate as jax_evaluate
    import geo4d_tpu.pipeline.inference as jax_inference
    import geo4d_tpu_torch.pipeline.inference as port_inference

    scene = FixedScene()
    ctx = np.zeros((1, 77, 64), np.float32)
    monkeypatch.setattr(jax_common, "build_model_and_params", lambda *a, **k: (None, None))
    monkeypatch.setattr(jax_common, "prepare_inference_params", lambda *a, **k: (None, ctx, ctx))
    monkeypatch.setattr(jax_inference, "reconstruct",
                        lambda *a, **k: (scene, {"valid": scene.valid}, dict(TIMING)))
    monkeypatch.setattr(port_evaluate, "build_model", lambda *a, **k: (None, None))
    monkeypatch.setattr(port_evaluate, "prepare_inference_params", lambda *a, **k: (ctx, ctx))
    monkeypatch.setattr(port_inference, "reconstruct",
                        lambda *a, **k: (scene, {"valid": torch.from_numpy(scene.valid)},
                                         dict(TIMING)))
    args = ["--dataset", "sintel", "--data_root", sintel_root, "--seq_list", SEQ]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_evaluate.main(args + ["--savedir", jax_dir])
    out = port_evaluate.main(args + ["--savedir", port_dir, "--device", "cpu"])
    assert out["pose_failed"] == [] and len(out["depth"]) == 1

    for name, rtol in (("_error_log_depth.txt", 1e-3), ("_error_log.txt", 1e-6),
                       ("_error_log_all.txt", None)):
        want, got = numbers(os.path.join(jax_dir, name)), numbers(os.path.join(port_dir, name))
        assert len(got) == len(want) and all(len(a) == len(b) for a, b in zip(got, want))
        for line, (a, b) in enumerate(zip(got, want)):
            # _error_log_all.txt: 7 depth lines (lad2), then ATE, RPE_trans, RPE_rot
            tol = rtol if rtol is not None else (1e-3 if line < 7 else 1e-6)
            np.testing.assert_allclose(a, b, rtol=tol, atol=0, err_msg=f"{name}:{line}")
    with open(os.path.join(jax_dir, "time_cost.txt")) as a, \
            open(os.path.join(port_dir, "time_cost.txt")) as b:
        assert a.read() == b.read()

    gt = port_datasets.load_eval_sequence("sintel", sintel_root, SEQ).gt_depth
    st, flips = out["stages"][SEQ], []
    jseq, pseq = os.path.join(jax_dir, SEQ), os.path.join(port_dir, SEQ)
    assert sorted(os.listdir(pseq)) == sorted(os.listdir(jseq))
    assert any(f.startswith("error_") for f in os.listdir(pseq))
    for fname in sorted(os.listdir(pseq)):
        a, b = os.path.join(pseq, fname), os.path.join(jseq, fname)
        if fname.startswith("error_"):
            # the two lad2 fits end apart (see above), which moves 1.1-1.6%
            # of the pixels by 1 LSB; with the port's own (s, t), JAX's
            # formula on OpenCV's resize gives the port's map
            got, want = images.read_png(a).astype(int), cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert np.abs(got - want).max() <= 1, fname
            i = int(fname[6:-4])
            pred = cv2.resize(scene.depth[i], (GT_W, GT_H), interpolation=cv2.INTER_CUBIC)
            err = np.where((gt[i] > 0) & (gt[i] < 70), np.abs(st["s"] * pred + st["t"] - gt[i])
                           / np.where(gt[i] > 0, gt[i], 1), 0).astype(np.float32)
            mine = np.clip(err * 255, 0, 255).astype(np.uint8)
            assert (mine != got).mean() <= 1e-3, fname
            flips.append(float((got != want).mean()))
        elif fname.endswith(".png"):
            np.testing.assert_array_equal(images.read_png(a), np.asarray(Image.open(b)), fname)
        elif fname.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), fname)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), fname
    assert len(flips) == N_FRAMES and max(flips) <= 0.05


def test_port_evaluation_end_to_end_on_cpu(sintel_root, tmp_path):
    savedir = str(tmp_path / "out")
    out = port_evaluate.main([
        "--dataset", "sintel", "--data_root", sintel_root, "--savedir", savedir,
        "--seq_list", SEQ, "--tiny", "--device", "cpu", "--video_length", "4", "--stride", "2",
        "--n_iter", "10", "--ddim_steps", "2"])
    assert out["pose_failed"] == []
    for name in ("_error_log_depth.txt", "_error_log.txt", "_error_log_all.txt",
                 "time_cost.txt"):
        vals = [x for line in numbers(os.path.join(savedir, name)) for x in line]
        assert vals and np.isfinite(vals).all(), name
    seq_dir = os.path.join(savedir, SEQ)
    for i in range(N_FRAMES):
        for fname in (f"frame_{i:04d}.npy", f"conf_{i:04d}.npy", f"frame_{i:04d}.png",
                      f"error_{i}.png"):
            assert os.path.exists(os.path.join(seq_dir, fname)), fname
    assert not os.path.exists(os.path.join(seq_dir, "scene.glb"))
    traj = np.loadtxt(os.path.join(seq_dir, "pred_traj.txt"))
    assert traj.shape == (N_FRAMES, 8) and np.isfinite(traj).all()
    st = out["stages"][SEQ]
    assert np.isfinite([st["s"], st["t"], st["l1"]]).all()
    assert images.read_png(os.path.join(seq_dir, "error_0.png")).shape == (GT_H, GT_W)
