"""Offline preparation of the evaluation datasets and Sintel's dynamic
masks, the port's copy of geo4d_tpu/data/preprocess.py (the reference's
datasets_preprocess/prepare_{bonn,tum,scannet,kitti}.py and
sintel_get_dynamics.py), without Pillow:

  prepare_bonn     first 110 frames -> rgbd_bonn_<seq>/{rgb_110, depth_110,
                   groundtruth_110.txt}
  prepare_tum      90 frames at stride 3 -> <seq>/{rgb_90, groundtruth_90.txt}
  prepare_scannet  90 frames at stride 3 -> <seq>/{color_90, depth_90,
                   pose_90.txt}
  prepare_kitti    val_selection_cropped gathered per sequence into
                   image_gathered/ and depth_gathered/
  prepare_nyuv2    official/*.h5 -> nyu_images/*.png, nyu_depths/*.npy and
                   normalised nyu_depth_imgs/*.png (reads HDF5 through h5py,
                   imported where it is needed, as the JAX package does)
  read_flo         a Middlebury .flo optical-flow file
  sintel_get_dynamics    per-frame dynamic labels of a Sintel sequence
                   (GT flow against the rigid flow of GT depth and cameras),
                   written as PNG by data/images.py
  compute_dynamic_masks  the same test on tensors, on their device

The prepare_* functions are plain file operations.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

from geo4d_tpu_torch.data.datasets import read_dpt, read_sintel_cam
from geo4d_tpu_torch.data.images import write_png
from geo4d_tpu_torch.geometry.warp import depth_based_flow

FLO_TAG = 202021.25


def _copy_subset(files: List[str], out_dir: str, n: int, stride: int = 1) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    taken = files[: n * stride: stride]
    for f in taken:
        shutil.copy2(f, os.path.join(out_dir, os.path.basename(f)))
    return taken


def _gt_rows(path: str) -> List[str]:
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def prepare_bonn(root: str, seqs: Optional[List[str]] = None, n_frames: int = 110):
    """rgbd_bonn_<seq>/rgb -> rgb_110 (+ depth_110, groundtruth_110.txt)."""
    seqs = seqs or ["balloon2", "crowd2", "crowd3", "person_tracking2", "synchronous"]
    for seq in seqs:
        base = os.path.join(root, f"rgbd_bonn_{seq}")
        rgbs = sorted(glob.glob(os.path.join(base, "rgb", "*.png")))
        depths = sorted(glob.glob(os.path.join(base, "depth", "*.png")))
        _copy_subset(rgbs, os.path.join(base, f"rgb_{n_frames}"), n_frames)
        _copy_subset(depths, os.path.join(base, f"depth_{n_frames}"), n_frames)
        gt = os.path.join(base, "groundtruth.txt")
        if os.path.exists(gt):
            with open(os.path.join(base, f"groundtruth_{n_frames}.txt"), "w") as f:
                f.writelines(_gt_rows(gt)[:n_frames])


def _subdirs(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))


def prepare_tum(root: str, seqs: Optional[List[str]] = None, n_frames: int = 90,
                stride: int = 3):
    """<seq>/rgb -> rgb_90 at stride 3 (+ groundtruth_90.txt)."""
    for seq in seqs or _subdirs(root):
        base = os.path.join(root, seq)
        rgbs = sorted(glob.glob(os.path.join(base, "rgb", "*.png")))
        if not rgbs:
            continue
        _copy_subset(rgbs, os.path.join(base, f"rgb_{n_frames}"), n_frames, stride)
        gt = os.path.join(base, "groundtruth.txt")
        if os.path.exists(gt):
            with open(os.path.join(base, f"groundtruth_{n_frames}.txt"), "w") as f:
                f.writelines(_gt_rows(gt)[: n_frames * stride: stride])


def _by_number(paths: List[str]) -> List[str]:
    return sorted(paths, key=lambda p: int(re.sub(r"\D", "", os.path.basename(p)) or 0))


def prepare_scannet(root: str, seqs: Optional[List[str]] = None, n_frames: int = 90,
                    stride: int = 3):
    """<seq>/color -> color_90 (+ depth_90, pose_90.txt of flattened c2w)."""
    for seq in seqs or _subdirs(root):
        base = os.path.join(root, seq)
        colors = _by_number(glob.glob(os.path.join(base, "color", "*")))
        if not colors:
            continue
        _copy_subset(colors, os.path.join(base, f"color_{n_frames}"), n_frames, stride)
        depths = _by_number(glob.glob(os.path.join(base, "depth", "*")))
        _copy_subset(depths, os.path.join(base, f"depth_{n_frames}"), n_frames, stride)
        pose_files = _by_number(glob.glob(os.path.join(base, "pose", "*.txt")))
        if pose_files:
            poses = [np.loadtxt(p).reshape(-1) for p in pose_files[: n_frames * stride: stride]]
            np.savetxt(os.path.join(base, f"pose_{n_frames}.txt"), np.stack(poses))


def prepare_kitti(root: str):
    """Gather image/ and groundtruth_depth/ (files named
    <seq>_drive_<n>_sync_..._<cam>.png) into image_gathered/<seq>/ and
    depth_gathered/<seq>/."""
    for src, dst in [(os.path.join(root, "image"), "image_gathered"),
                     (os.path.join(root, "groundtruth_depth"), "depth_gathered")]:
        if not os.path.isdir(src):
            continue
        for f in sorted(glob.glob(os.path.join(src, "*.png"))):
            name = os.path.basename(f)
            m = re.match(r"(.+?_drive_\d+_sync)", name)
            out = os.path.join(root, dst, m.group(1) if m else "seq")
            os.makedirs(out, exist_ok=True)
            shutil.copy2(f, os.path.join(out, name))


def prepare_nyuv2(root: str):
    """NYUv2 val split: official/*.h5 -> nyu_images/*.png + nyu_depths/*.npy
    + normalized nyu_depth_imgs/*.png (datasets_preprocess/
    prepare_nyuv2.py:1-84 semantics)."""
    import h5py

    src = os.path.join(root, "official")
    img_dir = os.path.join(root, "nyu_images")
    dep_dir = os.path.join(root, "nyu_depths")
    dimg_dir = os.path.join(root, "nyu_depth_imgs")
    for d in (img_dir, dep_dir, dimg_dir):
        os.makedirs(d, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(src, "*.h5"))):
        base = os.path.splitext(os.path.basename(path))[0]
        with h5py.File(path, "r") as h5:
            depth = np.asarray(h5["depth"])
            rgb = np.transpose(np.asarray(h5["rgb"]), (1, 2, 0))
        write_png(os.path.join(img_dir, f"{base}.png"), rgb.astype(np.uint8))
        np.save(os.path.join(dep_dir, f"{base}.npy"), depth)
        lo, hi = depth.min(), depth.max()
        norm = (depth - lo) / max(hi - lo, 1e-12)
        write_png(os.path.join(dimg_dir, f"{base}.png"), (norm * 255).astype(np.uint8))


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo optical flow -> (H, W, 2) float32 (u, v)."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        if abs(tag - FLO_TAG) >= 1e-3:
            raise ValueError(f"bad .flo tag in {path}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, -1).reshape(h, w * 2)
    return np.stack([data[:, 0::2], data[:, 1::2]], axis=-1)


def sintel_get_dynamics(base_dir: str, seq: str, threshold: float = 13.75,
                        continuous: bool = False, save_dir: str = "dynamic_label") -> List[str]:
    """Dynamic labels of one Sintel training sequence (base_dir/{depth,
    camdata_left,flow}/seq): for each frame but the last, the rigid flow of
    its GT depth under the GT cameras' motion (float64, on the host) against
    the GT optical flow; pixels whose flow error exceeds `threshold` pixels
    are dynamic (255). With `continuous` the error map normalised to 0-255
    is written instead. Writes base_dir/save_dir/seq/<frame>.png (8-bit
    grayscale) and returns the paths."""
    depth_dir = os.path.join(base_dir, "depth", seq)
    cam_dir = os.path.join(base_dir, "camdata_left", seq)
    flow_dir = os.path.join(base_dir, "flow", seq)
    out_dir = os.path.join(base_dir, save_dir, seq)
    os.makedirs(out_dir, exist_ok=True)

    frames = sorted(f for f in os.listdir(depth_dir) if f.endswith(".dpt"))
    written = []
    for cur, nxt in zip(frames[:-1], frames[1:]):
        fid1, fid2 = cur.split(".")[0], nxt.split(".")[0]
        d1 = read_dpt(os.path.join(depth_dir, cur))
        K1, E1 = read_sintel_cam(os.path.join(cam_dir, f"{fid1}.cam"))
        K2, E2 = read_sintel_cam(os.path.join(cam_dir, f"{fid2}.cam"))
        h, w = d1.shape
        # Sintel's extrinsics are world-to-camera
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        p1 = np.stack([(x - K1[0, 2]) * d1 / K1[0, 0], (y - K1[1, 2]) * d1 / K1[1, 1], d1],
                      axis=-1).reshape(-1, 3)
        pose1 = np.linalg.inv(np.vstack([E1, [0, 0, 0, 1]]))
        pose2 = np.linalg.inv(np.vstack([E2, [0, 0, 0, 1]]))
        rel = np.linalg.inv(pose2) @ pose1
        p2 = p1 @ rel[:3, :3].T + rel[:3, 3]
        uv1 = p1 @ K1.T
        uv2 = p2 @ K2.T
        rigid = (uv2[:, :2] / uv2[:, 2:] - uv1[:, :2] / uv1[:, 2:]).reshape(h, w, 2)
        err = np.linalg.norm(read_flo(os.path.join(flow_dir, f"{fid1}.flo")) - rigid, axis=-1)
        if continuous:
            img = (err / max(err.max(), 1e-12) * 255).astype(np.uint8)
        else:
            img = (err > threshold).astype(np.uint8) * 255
        out_path = os.path.join(out_dir, f"{fid1}.png")
        write_png(out_path, img)
        written.append(out_path)
    return written


def compute_dynamic_masks(flows_fwd: torch.Tensor, depths: torch.Tensor, poses: torch.Tensor,
                          K: torch.Tensor, motion_thresh: float = 0.35) -> torch.Tensor:
    """Dynamic-region masks on the inputs' device: a pixel of frame i is
    dynamic where the observed flow i -> i + 1 (flows_fwd (N-1, H, W, 2))
    departs from the rigid flow of depths (N, H, W) under c2w poses
    (N, 4, 4) and intrinsics K (3, 3) by more than `motion_thresh` of the
    observed flow's magnitude + 1, and the point stays in front of camera
    i + 1. Returns (N-1, H, W) bool. (The JAX package's function also takes
    the backward flows and does not use them.)"""
    rigid, valid = depth_based_flow(depths[:-1], poses[:-1], poses[1:], K)
    err = torch.linalg.norm(flows_fwd - rigid, dim=-1)
    mag = torch.linalg.norm(flows_fwd, dim=-1) + 1.0
    return (err / mag > motion_thresh) & valid
