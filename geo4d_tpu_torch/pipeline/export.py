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

from geo4d_tpu_torch.data.images import write_gif, write_png

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
    bin_data, offsets = _padded_bin(chunks)
    gltf = _gltf(
        [{"mesh": 0, "name": "pointcloud"}, {"mesh": 1, "name": "cameras"}],
        [{"primitives": [{"attributes": {"POSITION": 0, "COLOR_0": 1}, "mode": 0}]},
         {"primitives": [{"attributes": {"POSITION": 2, "COLOR_0": 3}, "indices": 4,
                          "mode": 4}]}],
        [_vec3(0, points, True), _vec3(1, point_colors, False), _vec3(2, tri_verts, True),
         _vec3(3, tri_colors, False),
         {"bufferView": 4, "componentType": 5125, "count": tri_faces.size, "type": "SCALAR"}],
        chunks, offsets, len(bin_data))
    _write_glb(path, gltf, bin_data)


def _padded_bin(chunks):
    """The BIN chunk: the byte strings back to back, zero-padded to 4 bytes;
    and each one's offset."""
    offsets, off = [], 0
    for c in chunks:
        offsets.append(off)
        off += len(c)
    bin_data = b"".join(chunks)
    return bin_data + b"\x00" * ((4 - len(bin_data) % 4) % 4), offsets


def _write_glb(path: str, gltf: dict, bin_data: bytes):
    """A binary glTF 2.0 file: header, the JSON chunk (space-padded), the
    BIN chunk."""
    json_data = json.dumps(gltf).encode()
    json_data += b" " * ((4 - len(json_data) % 4) % 4)
    total = 12 + 8 + len(json_data) + 8 + len(bin_data)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))       # glTF header
        f.write(struct.pack("<II", len(json_data), 0x4E4F534A))  # JSON chunk
        f.write(json_data)
        f.write(struct.pack("<II", len(bin_data), 0x004E4942))   # BIN chunk
        f.write(bin_data)


def _gltf(nodes: list, meshes: list, accessors: list, chunks: list, offsets: list,
          bin_len: int) -> dict:
    return {
        "asset": {"version": "2.0", "generator": "geo4d_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "accessors": accessors,
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": len(c)}
                        for o, c in zip(offsets, chunks)],
        "buffers": [{"byteLength": bin_len}],
    }


def _vec3(view: int, arr: np.ndarray, bounds: bool) -> dict:
    acc = {"bufferView": view, "componentType": 5126, "count": len(arr), "type": "VEC3"}
    if bounds:
        acc["min"] = arr.min(0).tolist() if len(arr) else [0, 0, 0]
        acc["max"] = arr.max(0).tolist() if len(arr) else [0, 0, 0]
    return acc


def write_pointcloud_glb(path: str, points: np.ndarray, colors: np.ndarray):
    """Binary glTF point cloud: one POINTS primitive, POSITION + COLOR_0."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    chunks = [points.tobytes(), colors.tobytes()]
    bin_data, offsets = _padded_bin(chunks)
    gltf = _gltf([{"mesh": 0}],
                 [{"primitives": [{"attributes": {"POSITION": 0, "COLOR_0": 1}, "mode": 0}]}],
                 [_vec3(0, points, True), _vec3(1, colors, False)], chunks, offsets,
                 len(bin_data))
    _write_glb(path, gltf, bin_data)


def pointmap_to_mesh(pts: np.ndarray, colors: np.ndarray, mask: Optional[np.ndarray] = None):
    """Grid mesh of an (H, W, 3) point map with (H, W, 3) colours in [0, 1]:
    two triangles per pixel quad, a triangle dropped when any of its
    vertices is masked out. Returns (vertices (V, 3), vertex colours (V, 3),
    faces (F, 3) uint32)."""
    h, w = pts.shape[:2]
    verts = pts.reshape(-1, 3).astype(np.float32)
    cols = colors.reshape(-1, 3).astype(np.float32)
    idx = np.arange(h * w).reshape(h, w)
    tl, tr = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    bl, br = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([tl, bl, tr], 1), np.stack([tr, bl, br], 1)],
                           axis=0).astype(np.uint32)
    if mask is not None:
        faces = faces[mask.reshape(-1)[faces].all(axis=1)]
    return verts, cols, faces


def write_mesh_glb(path: str, vertices: np.ndarray, colors: np.ndarray, faces: np.ndarray):
    """Binary glTF triangle mesh with vertex colours."""
    vertices = np.asarray(vertices, np.float32)
    colors = np.asarray(colors, np.float32)
    faces = np.asarray(faces, np.uint32)
    chunks = [vertices.tobytes(), colors.tobytes(), faces.tobytes()]
    bin_data, offsets = _padded_bin(chunks)
    gltf = _gltf([{"mesh": 0}],
                 [{"primitives": [{"attributes": {"POSITION": 0, "COLOR_0": 1}, "indices": 2,
                                   "mode": 4}]}],
                 [_vec3(0, vertices, True), _vec3(1, colors, False),
                  {"bufferView": 2, "componentType": 5125, "count": faces.size,
                   "type": "SCALAR"}], chunks, offsets, len(bin_data))
    _write_glb(path, gltf, bin_data)


# matplotlib's `jet` (its _cm.py segment data): (x, y0, y1) breakpoints per channel
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1, 0, 0)),
}


def jet_lut(n: int = 256) -> np.ndarray:
    """(n, 3) float64 RGB table of matplotlib's `jet`, built as
    LinearSegmentedColormap builds it (gamma 1)."""
    cols = []
    for ch in ("red", "green", "blue"):
        a = np.asarray(_JET_SEGMENTS[ch], np.float64)
        x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                              [y0[-1]]])
        cols.append(np.clip(lut, 0.0, 1.0))
    return np.stack(cols, axis=-1)


def jet_indices(norm: np.ndarray, n: int = 256) -> np.ndarray:
    """The jet table's index of each value of a float array in [0, 1], by
    matplotlib's Colormap rule: x * n in the array's dtype, n -> n - 1,
    truncated."""
    xa = np.array(norm, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    return xa.astype(int)


def save_depth_visualizations(out_dir: str, depths: np.ndarray, fps: int = 8):
    """Jet-coloured depth PNGs `depth_XXXX.png` and an animated `depth.gif`,
    the depths normalised between their 2nd and 98th percentiles. The GIF's
    global palette is the jet table, so its frames are the PNGs exactly."""
    os.makedirs(out_dir, exist_ok=True)
    d = np.asarray(depths, np.float32)
    lo, hi = np.percentile(d, 2), np.percentile(d, 98)
    norm = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    palette = (jet_lut() * 255).astype(np.uint8)
    idx = jet_indices(norm).astype(np.uint8)
    for i in range(len(d)):
        write_png(os.path.join(out_dir, f"depth_{i:04d}.png"), palette[idx[i]])
    if len(d):
        write_gif(os.path.join(out_dir, "depth.gif"), idx, palette, int(1000 / fps))


def save_time_cost(path: str, timing: dict):
    """Append one time_cost.txt line (the reference's contract)."""
    with open(path, "a") as f:
        f.write(f"diffusion {timing['diffusion_s']:.3f}s "
                f"alignment {timing['alignment_s']:.3f}s "
                f"frames {int(timing['frames'])} "
                f"sec/frame {timing['sec_per_frame']:.4f}\n")
