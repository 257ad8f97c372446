"""Results directory in the reference's file contract, the port's copy of
geo4d_tpu/pipeline/export.py's `save_results_dir` and `save_time_cost`
(reference dust3r/cloud_opt/base_opt_group.py:383-464; the files the viser
visualizer reads):

  pred_traj.txt        TUM rows
  pred_focal.txt       one focal per line
  pred_intrinsics.txt  flattened 3x3 per line
  frame_XXXX.npy       per-frame depth (H, W) float32
  conf_XXXX.npy        per-frame confidence
  init_conf_XXXX.npy   initial confidence
  frame_XXXX.png       rgb frame (data/images.py's encoder)
  enlarged_dynamic_mask_<i>.png  dynamic mask of frame i (0 / 255; the
                       index is not zero-padded: the viewer globs this name)
  scene.glb            point cloud and camera frusta (binary glTF 2.0)

The aligner is duck-typed: any object with the GroupAligner getters works.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np

from geo4d_tpu_torch.data.images import write_png

# per-camera edge colours, cycled
_CAM_PALETTE = np.asarray(
    [[0.90, 0.10, 0.10], [0.10, 0.60, 0.90], [0.10, 0.80, 0.30], [0.95, 0.75, 0.10],
     [0.70, 0.30, 0.85], [0.95, 0.45, 0.10], [0.20, 0.85, 0.80], [0.55, 0.55, 0.55]],
    np.float32)


def save_results_dir(out_dir: str, aligner, rgb_frames: Optional[np.ndarray] = None,
                     save_glb: bool = True, conf_threshold: float = 1e-3,
                     dynamic_masks: Optional[np.ndarray] = None):
    """Write the results files of `aligner`; rgb_frames (N, H, W, 3) uint8
    or [-1, 1] float; dynamic_masks (N, H, W) bool or 0/1, nonzero =
    dynamic. `save_glb=False` leaves out scene.glb (evaluation does); its
    point cloud keeps the points of confidence above `conf_threshold`."""
    if rgb_frames is not None and rgb_frames.dtype == np.uint8:
        rgb_frames = (rgb_frames.astype(np.float32) / 255.0 - 0.5) * 2.0
    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, "pred_traj.txt"), aligner.get_tum_poses())
    np.savetxt(os.path.join(out_dir, "pred_focal.txt"), aligner.get_focals())
    K = aligner.get_intrinsics()
    np.savetxt(os.path.join(out_dir, "pred_intrinsics.txt"), K.reshape(len(K), 9))

    depths = aligner.get_depthmaps()
    confs = aligner.get_conf()
    init_confs = aligner.get_init_conf()
    for i in range(len(depths)):
        np.save(os.path.join(out_dir, f"frame_{i:04d}.npy"), depths[i])
        np.save(os.path.join(out_dir, f"conf_{i:04d}.npy"), confs[i])
        np.save(os.path.join(out_dir, f"init_conf_{i:04d}.npy"), init_confs[i])
    if rgb_frames is not None:
        for i in range(len(rgb_frames)):
            img = ((rgb_frames[i] + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
            write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
    if dynamic_masks is not None:
        for i, m in enumerate(dynamic_masks):
            write_png(os.path.join(out_dir, f"enlarged_dynamic_mask_{i}.png"),
                      (np.asarray(m) > 0).astype(np.uint8) * 255)
    if not save_glb:
        return

    pts = aligner.get_pts3d().reshape(-1, 3)
    mask = (confs > conf_threshold).reshape(-1)
    if rgb_frames is not None:
        colors = ((rgb_frames + 1) / 2).clip(0, 1).reshape(-1, 3)
    else:
        colors = np.full_like(pts, 0.5)
    poses = aligner.get_im_poses()
    h, w = depths.shape[1:]
    scene_scale = float(np.linalg.norm(poses[:, :3, 3] - poses[:, :3, 3].mean(0), axis=1).max())
    fv, fc, ff = camera_frusta_mesh(poses, aligner.get_focals(), (w, h),
                                    screen_width=max(scene_scale, 1e-3) * 0.1)
    write_scene_glb(os.path.join(out_dir, "scene.glb"), pts[mask], colors[mask], fv, fc, ff)


def camera_frustum_mesh(c2w: np.ndarray, focal: float, imsize_wh: tuple, color: np.ndarray,
                        screen_width: float):
    """One camera as a 5-vertex pyramid: apex at the optical centre, base on
    the image plane (OpenCV convention, +z forward, +y down). Returns
    (verts (5, 3), colors (5, 3), faces (6, 3))."""
    w, h = imsize_wh
    focal = float(np.atleast_1d(focal)[0]) or min(h, w) * 1.1
    height = max(screen_width / 10, focal * screen_width / h)
    half = screen_width * 0.5**0.5
    aspect = w / h
    corners = np.asarray([[-half * aspect, -half, height], [half * aspect, -half, height],
                          [half * aspect, half, height], [-half * aspect, half, height]],
                         np.float32)
    verts = np.concatenate([np.zeros((1, 3), np.float32), corners], axis=0)
    verts = verts @ c2w[:3, :3].T.astype(np.float32) + c2w[:3, 3].astype(np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 2, 3], [1, 3, 4]],
                       np.uint32)
    return verts, np.tile(np.asarray(color, np.float32), (5, 1)), faces


def camera_frusta_mesh(poses: np.ndarray, focals: np.ndarray, imsize_wh: tuple,
                       screen_width: float):
    """All cameras merged into one coloured triangle soup."""
    vs, cs, fs = [], [], []
    off = 0
    for i in range(len(poses)):
        v, c, f = camera_frustum_mesh(poses[i], focals[i] if i < len(focals) else focals[-1],
                                      imsize_wh, _CAM_PALETTE[i % len(_CAM_PALETTE)],
                                      screen_width)
        vs.append(v)
        cs.append(c)
        fs.append(f + off)
        off += len(v)
    return np.concatenate(vs, axis=0), np.concatenate(cs, axis=0), np.concatenate(fs, axis=0)


def write_scene_glb(path: str, points: np.ndarray, point_colors: np.ndarray,
                    tri_verts: np.ndarray, tri_colors: np.ndarray, tri_faces: np.ndarray):
    """Binary glTF with two primitives: the point cloud and the camera frusta."""
    points = np.asarray(points, np.float32)
    point_colors = np.asarray(point_colors, np.float32)
    tri_verts = np.asarray(tri_verts, np.float32)
    tri_colors = np.asarray(tri_colors, np.float32)
    tri_faces = np.asarray(tri_faces, np.uint32)

    chunks = [points.tobytes(), point_colors.tobytes(), tri_verts.tobytes(),
              tri_colors.tobytes(), tri_faces.tobytes()]
    offsets, off = [], 0
    for c in chunks:
        offsets.append(off)
        off += len(c)
    bin_data = b"".join(chunks)
    bin_data += b"\x00" * ((4 - len(bin_data) % 4) % 4)

    def vec3_acc(view, count, arr=None):
        acc = {"bufferView": view, "componentType": 5126, "count": count, "type": "VEC3"}
        if arr is not None:
            acc["min"] = arr.min(0).tolist() if count else [0, 0, 0]
            acc["max"] = arr.max(0).tolist() if count else [0, 0, 0]
        return acc

    gltf = {
        "asset": {"version": "2.0", "generator": "geo4d_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0, "name": "pointcloud"}, {"mesh": 1, "name": "cameras"}],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "COLOR_0": 1}, "mode": 0}]},
            {"primitives": [{"attributes": {"POSITION": 2, "COLOR_0": 3}, "indices": 4,
                             "mode": 4}]},
        ],
        "accessors": [
            vec3_acc(0, len(points), points),
            vec3_acc(1, len(point_colors)),
            vec3_acc(2, len(tri_verts), tri_verts),
            vec3_acc(3, len(tri_colors)),
            {"bufferView": 4, "componentType": 5125, "count": tri_faces.size, "type": "SCALAR"},
        ],
        "bufferViews": [{"buffer": 0, "byteOffset": offsets[i], "byteLength": len(chunks[i])}
                        for i in range(5)],
        "buffers": [{"byteLength": len(bin_data)}],
    }
    json_data = json.dumps(gltf).encode()
    json_data += b" " * ((4 - len(json_data) % 4) % 4)
    total = 12 + 8 + len(json_data) + 8 + len(bin_data)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))       # glTF header
        f.write(struct.pack("<II", len(json_data), 0x4E4F534A))  # JSON chunk
        f.write(json_data)
        f.write(struct.pack("<II", len(bin_data), 0x004E4942))   # BIN chunk
        f.write(bin_data)


def save_time_cost(path: str, timing: dict):
    """Append one time_cost.txt line (the reference's contract)."""
    with open(path, "a") as f:
        f.write(f"diffusion {timing['diffusion_s']:.3f}s "
                f"alignment {timing['alignment_s']:.3f}s "
                f"frames {int(timing['frames'])} "
                f"sec/frame {timing['sec_per_frame']:.4f}\n")
