"""The offline tools on synthetic raw data: seeded raw layouts of every
dataset the training-set preparers read, a run of each tool over them, and
a comparison of two output trees.

The raw files (`write_raw`) are made from numpy with a seed and written
with the port's own encoders (data/jpeg.py, data/images.py, the EXR and PFM
layouts), whose bytes are Pillow's and OpenCV's, so the JAX package run over
the same seed reads the same files:
tests/fixtures/torch_offline/make_fixtures.py runs it there and commits its
outputs, which `compare_trees` holds the port's outputs to.

`run_case` takes the modules to run as a namespace (preprocess_train,
habitat_prep, sens_reader, raster, preprocess), the port's by default, so
the same cases drive either package. Images are 64x48-class; each case
names the preparer it drives:

  blendedmvs       blendedmvs_process_view, two views, at 64x48
  staticthings3d   staticthings3d_process_view, left and right, at 64x48
  co3d             prepare_co3d_category, two frames, img_size 64
  wildrgbd         prepare_wildrgbd_sequence, 3 of 4 frames, img_size 64
  arkitscenes      prepare_arkitscenes_scene (a RIGHT and an UP scene) and
                   arkitscenes_concat_metadata
  waymo            waymo_crop_sequence (two cameras, three frames, 64) and
                   waymo_make_video_pairs
  scannetpp        prepare_scannetpp_scene (a fisheye DSLR frame and two
                   radial-tangential iPhone frames, target 64) and
                   scannetpp_concat_metadata
  habitat          habitat preprocess_metadata, four 32x32 crops from two
                   positions of a seeded 64x128 envmap
  sens             sens_reader.export_scene, whole and at frame_skip 2
                   resized to 48x36
  raster           render_mesh_depth of a seeded 200-triangle PLY mesh
  megadepth, nyuv2 (with h5=True: they read HDF5 through h5py)

`ViewerClient` is a stdlib websocket client of viz/server.py: the upgrade
handshake, masked text requests, the server's frames; `fetch_viewer` reads
the meta message and every frame of a running server.
"""

from __future__ import annotations

import base64
import gzip
import json
import os
import socket
import struct
import time
import types
import zlib
from typing import Callable, Dict, Tuple

import numpy as np

from geo4d_tpu_torch.data.images import read_png, write_png
from geo4d_tpu_torch.data.jpeg import encode_jpeg, write_jpeg

CASES = ("blendedmvs", "staticthings3d", "co3d", "wildrgbd", "arkitscenes", "waymo",
         "scannetpp", "habitat", "sens", "raster")
H5_CASES = ("megadepth", "nyuv2")
# arrays of .npz, .npy, .json and .txt outputs: |got - want| <= ATOL + RTOL |want|
RTOL = 1e-9
ATOL = 1e-12
BLENDEDMVS_SEQ = "5a3ca9cb270f55008b0aa0b2"
CO3D_CATEGORY, CO3D_SEQ = "apple", "110_13051_23361"
ARKIT_SCENES = ("41069021", "41069042")
WAYMO_SEQ = "segment-0001.tfrecord"
HABITAT_ENV = (64, 128)
HABITAT_CROP = (32, 32)


def port_modules() -> types.SimpleNamespace:
    from geo4d_tpu_torch.data import habitat_prep, preprocess, preprocess_train, sens_reader
    from geo4d_tpu_torch.geometry import raster

    return types.SimpleNamespace(preprocess_train=preprocess_train, habitat_prep=habitat_prep,
                                 sens_reader=sens_reader, raster=raster, preprocess=preprocess)


# ------------------------------------------------------------ raw data ----

def smooth_image(rng: np.random.Generator, h: int, w: int, c: int = 3) -> np.ndarray:
    """uint8 (h, w, c): a bilinear blow-up of a coarse random grid plus a
    little noise (JPEG-friendly, yet every pixel differs)."""
    coarse = rng.uniform(0, 255, (4, 5, c))
    ys = np.linspace(0, 3, h)[:, None]
    xs = np.linspace(0, 4, w)[None]
    y0, x0 = np.minimum(ys.astype(int), 2), np.minimum(xs.astype(int), 3)
    fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
    img = (coarse[y0, x0] * (1 - fy) * (1 - fx) + coarse[y0 + 1, x0] * fy * (1 - fx)
           + coarse[y0, x0 + 1] * (1 - fy) * fx + coarse[y0 + 1, x0 + 1] * fy * fx)
    img = img + rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _rotation(rng: np.random.Generator, scale: float) -> np.ndarray:
    """A rotation of about `scale` radians about a random axis (Rodrigues)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = scale * rng.uniform(0.5, 1.0)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * (k @ k)


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix near the identity."""
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def _rotvec(R: np.ndarray) -> np.ndarray:
    angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if angle < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * angle / (2 * np.sin(angle))


def _write_pfm(path: str, depth: np.ndarray):
    h, w = depth.shape
    with open(path, "wb") as f:
        f.write(f"Pf\n{w} {h}\n-1.0\n".encode())
        f.write(np.ascontiguousarray(depth[::-1], "<f4").tobytes())


def _write_float3(path: str, arr: np.ndarray):
    arr = np.asarray(arr, np.float32)
    with open(path, "wb") as f:
        f.write(b"float\n" + str(arr.ndim).encode() + b"\n")
        for d in reversed(arr.shape):
            f.write(str(d).encode() + b"\n")
        f.write(arr.tobytes())


def _write_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(np.asarray(verts, "<f4").tobytes())
        rec = np.zeros(len(faces), np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
        rec["n"], rec["idx"] = 3, faces
        f.write(rec.tobytes())


def room_mesh(rng: np.random.Generator, n_extra: int = 188) -> Tuple[np.ndarray, np.ndarray]:
    """A closed box of half-size 3 around the origin (12 triangles) plus
    n_extra random triangles floating inside it."""
    c = np.array([[x, y, z] for x in (-3, 3) for y in (-3, 3) for z in (-3, 3)], np.float64)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = [f for a, b, cc, d in quads for f in ((a, b, cc), (a, cc, d))]
    centres = rng.uniform(-2.2, 2.2, (n_extra, 1, 3))
    extra = centres + rng.normal(0, 0.35, (n_extra, 3, 3))
    verts = np.concatenate([c, extra.reshape(-1, 3)])
    faces = np.concatenate([np.asarray(faces), 8 + np.arange(3 * n_extra).reshape(-1, 3)])
    return verts.astype(np.float32), faces.astype(np.int32)


def write_sens(path: str, rng: np.random.Generator, n: int = 3,
               color_hw=(72, 96), depth_hw=(48, 64)):
    """A ScanNet SensorData v4 file: n frames of JPEG colour (quality 90)
    and zlib'd uint16 depth in millimetres."""
    ch, cw = color_hw
    dh, dw = depth_hw
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 80.0, 80.0, cw / 2, ch / 2
    Kd = K.copy()
    Kd[0, 0], Kd[1, 1], Kd[0, 2], Kd[1, 2] = 55.0, 55.0, dw / 2, dh / 2
    name = b"StructureSensor"
    with open(path, "wb") as f:
        f.write(struct.pack("<IQ", 4, len(name)) + name)
        for m in (K, np.eye(4, dtype=np.float32), Kd, np.eye(4, dtype=np.float32)):
            f.write(m.astype("<f4").tobytes())
        f.write(struct.pack("<iiIIIIfQ", 2, 1, cw, ch, dw, dh, 1000.0, n))
        for i in range(n):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = _rotation(rng, 0.2)
            c2w[:3, 3] = rng.normal(0, 0.5, 3)
            color = encode_jpeg(smooth_image(rng, ch, cw), 90)
            depth = rng.integers(500, 4000, (dh, dw)).astype("<u2")
            depth[rng.uniform(size=(dh, dw)) < 0.1] = 0
            dz = zlib.compress(depth.tobytes())
            f.write(c2w.astype("<f4").tobytes())
            f.write(struct.pack("<QQQQ", 1000 * i, 1000 * i + 5, len(color), len(dz)))
            f.write(color + dz)


def envmap(seed: int, hw=HABITAT_ENV) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded equirectangular colour (uint8) and distance (float32) map."""
    rng = np.random.default_rng(seed)
    h, w = hw
    color = smooth_image(rng, h, w)
    dist = (1.5 + smooth_image(rng, h, w, 1)[..., 0].astype(np.float32) / 64).astype(np.float32)
    return color, dist


def habitat_render_fn(seed: int) -> Callable:
    """render_fn(position) -> the envmap of `envmap(seed + k)`, k the
    position's index in the order first seen (so each position differs)."""
    seen: Dict[Tuple[float, ...], int] = {}

    def render(position):
        key = tuple(np.asarray(position, float))
        seen.setdefault(key, len(seen))
        return envmap(seed + 1000 + seen[key])

    return render


def write_raw(root: str, seed: int = 0, h5: bool = False) -> Dict:
    """Every case's raw layout under root/<case>; returns what the runs need
    besides the files (selections and pair arrays)."""
    rng = np.random.default_rng(seed)
    man: Dict = {}
    j = os.path.join

    # BlendedMVS: cams (w2c then K), blended_images jpg, rendered_depth_maps pfm
    seq = j(root, "blendedmvs", BLENDEDMVS_SEQ)
    for sub in ("cams", "blended_images", "rendered_depth_maps"):
        os.makedirs(j(seq, sub), exist_ok=True)
    with open(j(seq, "cams", "pair.txt"), "w") as f:
        f.write("2\n")
    for v in range(2):
        name = f"{v:08d}"
        w2c = np.eye(4)
        w2c[:3, :3] = _rotation(rng, 0.3)
        w2c[:3, 3] = rng.normal(0, 1, 3)
        K = np.array([[80.0 + v, 0, 48.3], [0, 80.0 + v, 35.7], [0, 0, 1]])
        with open(j(seq, "cams", name + "_cam.txt"), "w") as f:
            f.write("extrinsic\n" + "".join(" ".join(f"{x:.9f}" for x in r) + "\n" for r in w2c))
            f.write("\nintrinsic\n" + "".join(" ".join(f"{x:.9f}" for x in r) + "\n" for r in K))
            f.write("\n425.0 2.5\n")
        write_jpeg(j(seq, "blended_images", name + ".jpg"), smooth_image(rng, 72, 96), 95)
        _write_pfm(j(seq, "rendered_depth_maps", name + ".pfm"),
                   rng.uniform(1, 9, (72, 96)).astype(np.float32))

    # StaticThings3D: .float3 intrinsics, poses, depths; clean and final PNGs
    st = j(root, "staticthings3d")
    seq_rel = os.path.join("TRAIN", "A", "0000")
    for sub in ("poses", "depths", "frames_cleanpass", "frames_finalpass"):
        for cam in ("left", "right"):
            os.makedirs(j(st, sub, seq_rel, cam), exist_ok=True)
    os.makedirs(j(st, "intrinsics", seq_rel), exist_ok=True)
    _write_float3(j(st, "intrinsics", seq_rel, "0006.float3"),
                  [[105.0, 0, 48.0], [0, 105.0, 27.0], [0, 0, 1]])
    for cam in ("left", "right"):
        pose = np.eye(4)
        pose[:3, :3] = _rotation(rng, 0.2)
        pose[:3, 3] = rng.normal(0, 1, 3)
        _write_float3(j(st, "poses", seq_rel, cam, "0006.float3"), pose)
        _write_float3(j(st, "depths", seq_rel, cam, "0006.float3"),
                      rng.uniform(2, 40, (54, 96)))
        for p in ("cleanpass", "finalpass"):
            write_png(j(st, f"frames_{p}", seq_rel, cam, "0006.png"), smooth_image(rng, 54, 96))

    # CO3D: set list, gzipped frame and sequence annotations, jpg/png/depth png
    cat = j(root, "co3d", CO3D_CATEGORY)
    for sub in ("set_lists", f"{CO3D_SEQ}/images", f"{CO3D_SEQ}/masks", f"{CO3D_SEQ}/depths"):
        os.makedirs(j(cat, sub), exist_ok=True)
    frames, entries = [], []
    for n in (1, 7):
        img_path = f"{CO3D_CATEGORY}/{CO3D_SEQ}/images/frame{n:06d}.jpg"
        depth_path = f"{CO3D_CATEGORY}/{CO3D_SEQ}/depths/frame{n:06d}.jpg.geometric.png"
        write_jpeg(j(root, "co3d", img_path), smooth_image(rng, 60, 80), 95)
        mask = np.zeros((60, 80), np.uint8)
        mask[10:50, 15:70] = 255
        write_png(j(root, "co3d", img_path.replace("images", "masks").replace(".jpg", ".png")),
                  mask)
        depth16 = rng.uniform(0.5, 6.0, (60, 80)).astype(np.float16).view(np.uint16)
        write_png(j(root, "co3d", depth_path), depth16)
        frames.append({"sequence_name": CO3D_SEQ, "frame_number": n,
                       "image": {"path": img_path, "size": [60, 80]},
                       "depth": {"path": depth_path, "scale_adjustment": 1.0},
                       "viewpoint": {"focal_length": [2.1, 2.05],
                                     "principal_point": [0.03 * n, -0.02],
                                     "R": _rotation(rng, 0.4).tolist(),
                                     "T": rng.normal(0, 1, 3).tolist()}})
        entries.append([CO3D_SEQ, n, img_path])
    with open(j(cat, "set_lists", "set_lists_fewview_train.json"), "w") as f:
        json.dump({"train": entries, "val": [], "test": []}, f)
    with gzip.open(j(cat, "frame_annotations.jgz"), "wt") as f:
        json.dump(frames, f)
    with gzip.open(j(cat, "sequence_annotations.jgz"), "wt") as f:
        json.dump([{"sequence_name": CO3D_SEQ, "viewpoint_quality_score": 0.9},
                   {"sequence_name": "other", "viewpoint_quality_score": 0.1}], f)

    # WildRGB-D: metadata K (column-major), cam_poses.txt, rgb/depth/mask PNGs
    wr = j(root, "wildrgbd", "scene_000")
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(j(wr, sub), exist_ok=True)
    with open(j(wr, "metadata"), "w") as f:
        json.dump({"K": [70.0, 0, 0, 0, 71.0, 0, 41.2, 29.6, 1.0]}, f)
    rows = []
    for i in range(4):
        c2w = np.eye(4)
        c2w[:3, :3] = _rotation(rng, 0.3)
        c2w[:3, 3] = rng.normal(0, 1, 3)
        rows.append(np.concatenate([[i], c2w.reshape(-1)]))
        write_png(j(wr, "rgb", f"{i:05d}.png"), smooth_image(rng, 60, 80))
        write_png(j(wr, "depth", f"{i:05d}.png"),
                  rng.integers(300, 3000, (60, 80)).astype(np.uint16))
        mask = np.zeros((60, 80), np.uint8)
        mask[8 + i:52, 12:66 - i] = 255
        write_png(j(wr, "masks", f"{i:05d}.png"), mask)
    np.savetxt(j(wr, "cam_poses.txt"), np.asarray(rows))

    # ARKitScenes: a scene whose device x points up (RIGHT) and an upright one
    man["arkitscenes"] = {}
    axes = {"RIGHT": np.array([[0.0, 1, 0], [0, 0, 1], [1, 0, 0]]),
            "UP": np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])}
    for scene, label in zip(ARKIT_SCENES, ("RIGHT", "UP")):
        sd = j(root, "arkitscenes", scene)
        for sub in ("vga_wide", "vga_wide_intrinsics", "lowres_depth"):
            os.makedirs(j(sd, sub), exist_ok=True)
        ts = 100.0 + 0.1 * np.arange(5)
        with open(j(sd, "lowres_wide.traj"), "w") as f:
            for t in ts:
                R = axes[label] @ _rotation(rng, 0.05)
                c = rng.normal(0, 0.3, 3)
                f.write(f"{t:.3f} " + " ".join(f"{x:.8f}" for x in _rotvec(R.T))
                        + " " + " ".join(f"{x:.8f}" for x in -R.T @ c) + "\n")
        selection = []
        for fid in ("100.000", "100.150", "100.300"):
            base = f"{scene}_{fid}.png"
            selection.append(base)
            write_png(j(sd, "vga_wide", base), smooth_image(rng, 48, 64))
            write_png(j(sd, "lowres_depth", base),
                      rng.integers(200, 5000, (24, 32)).astype(np.uint16))
            with open(j(sd, "vga_wide_intrinsics", f"{scene}_{fid}.pincam"), "w") as f:
                f.write("64 48 52.1 52.3 31.7 24.2\n")
        man["arkitscenes"][scene] = (selection, np.array([[0, 1, 0.9], [1, 2, 0.8]]))

    # Waymo: calib.json and per-frame jpg + npz (car pose, lidar pixels, points)
    ws = j(root, "waymo", WAYMO_SEQ)
    os.makedirs(ws, exist_ok=True)
    calib = []
    Ks, cam_to_car = {}, {}
    axes_inv = np.linalg.inv(np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                                       [0, 0, 0, 1]], np.float64))
    for cam in (1, 2):
        T = np.eye(4)
        T[:3, :3] = _rotation(rng, 0.1)
        T[:3, 3] = rng.normal(0, 1, 3)
        cam_to_car[cam] = T
        Ks[cam] = np.array([[90.0, 0, 47.5], [0, 90.0, 31.5], [0, 0, 1]])
        calib.append([cam, {"width": 96, "height": 64,
                            "intrinsics": [90.0, 90.0, 47.5, 31.5, 0.01, -0.002, 0.0, 0.0, 0.0],
                            "extrinsics": T.reshape(-1).tolist()}])
    with open(j(ws, "calib.json"), "w") as f:
        json.dump(calib, f)
    man["waymo_frames"] = []
    for i in range(3):
        pose = np.eye(4)
        pose[:3, :3] = _rotation(rng, 0.1)
        pose[:3, 3] = [2.0 * i, 0, 0]
        for cam in (1, 2):
            name = f"{i:05d}_{cam}"
            man["waymo_frames"].append(name)
            write_jpeg(j(ws, name + ".jpg"), smooth_image(rng, 64, 96), 95)
            px = rng.uniform(0, [96, 64], (40, 2))
            z = rng.uniform(2, 30, 40)
            opt = np.stack([(px[:, 0] - 47.5) / 90 * z, (px[:, 1] - 31.5) / 90 * z, z], -1)
            car = (cam_to_car[cam] @ axes_inv @ np.c_[opt, np.ones(40)].T).T[:, :3]
            np.savez(j(ws, name + ".npz"), pose=pose, pixels=px, pts3d=car)
    man["waymo_frames"].sort()

    # ScanNet++: scan mesh, DSLR (fisheye) and iPhone (radial-tangential) frames
    sp = j(root, "scannetpp", "scene0")
    for sub in ("scans", "dslr/colmap", "dslr/resized_images", "dslr/resized_anon_masks",
                "iphone/colmap", "iphone/rgb", "iphone/rgb_masks"):
        os.makedirs(j(sp, sub), exist_ok=True)
    _write_ply(j(sp, "scans", "mesh_aligned_0.05.ply"), *room_mesh(rng))
    cams = {"dslr": ("OPENCV_FISHEYE", 96, 64, [52.0, 52.4, 48.2, 31.9, 0.02, -0.01, 0.003, -0.001],
                     ["DSC00001.JPG"]),
            "iphone": ("OPENCV", 96, 72, [75.0, 75.5, 48.1, 36.3, -0.05, 0.01, 0.001, -0.0005],
                       ["frame_000001.jpg", "frame_000002.jpg"])}
    for cam, (model, w, h, params, names) in cams.items():
        with open(j(sp, cam, "colmap", "cameras.txt"), "w") as f:
            f.write("# Camera list\n# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n# 1\n")
            f.write(f"1 {model} {w} {h} " + " ".join(repr(p) for p in params) + "\n")
        with open(j(sp, cam, "colmap", "images.txt"), "w") as f:
            f.write("# Image list\n# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
            for k, name in enumerate(names):
                q = _quat_wxyz(_rotation(rng, 0.6))
                t = rng.normal(0, 0.3, 3)
                f.write(f"{k + 1} " + " ".join(repr(float(x)) for x in (*q, *t))
                        + f" 1 {name}\n\n")
                rgb_dir = "resized_images" if cam == "dslr" else "rgb"
                mask_dir = "resized_anon_masks" if cam == "dslr" else "rgb_masks"
                write_jpeg(j(sp, cam, rgb_dir, name), smooth_image(rng, h, w), 95)
                mask = np.full((h, w), 255, np.uint8)
                mask[5:15, 60:80] = 0
                write_png(j(sp, cam, mask_dir, name[:-3] + "png"), mask)
    man["scannetpp"] = (["DSC00001", "frame_000001", "frame_000002"],
                        np.array([[0, 1, 1.0], [1, 2, 1.0]]))

    # habitat: a metadata.json of two view batches, two positions
    hb = j(root, "habitat")
    os.makedirs(hb, exist_ok=True)
    batches = {}
    for b, pos in enumerate(([0.0, 0.0, 0.0], [0.5, -0.2, 0.1])):
        views = {}
        for v in range(2):
            hh, ww = HABITAT_CROP
            f_px = ww / 2 / np.tan(np.radians(60.0 + 10 * v) / 2)
            K = np.array([[f_px, 0, ww / 2 - 0.5], [0, f_px, hh / 2 - 0.5], [0, 0, 1]])
            views[f"view{v}"] = {"camera_intrinsics": K.tolist(), "size": [ww, hh],
                                 "R_cam2world": _rotation(rng, 1.0).tolist(),
                                 "t_cam2world": pos}
        batches[f"batch{b}"] = views
    with open(j(hb, "metadata.json"), "w") as f:
        json.dump({"view_batches": batches}, f)

    # .sens and the raster mesh
    os.makedirs(j(root, "sens"), exist_ok=True)
    write_sens(j(root, "sens", "scene0000_00.sens"), rng)
    os.makedirs(j(root, "raster"), exist_ok=True)
    _write_ply(j(root, "raster", "mesh.ply"), *room_mesh(rng))

    if h5:
        import h5py

        md = j(root, "megadepth", "0001")
        sub = j(md, "sparse", "manhattan", "0")
        os.makedirs(sub, exist_ok=True)
        os.makedirs(j(md, "dense0", "imgs"), exist_ok=True)
        os.makedirs(j(md, "dense0", "depths"), exist_ok=True)
        with open(j(sub, "cameras.txt"), "w") as f:
            f.write("# c\n# c\n# c\n1 SIMPLE_RADIAL 96 64 80.0 47.6 32.2 -0.05\n"
                    "2 SIMPLE_RADIAL 64 96 70.0 31.8 48.1 0.03\n")
        tags = ["1001.jpg", "1002.jpg"]
        with open(j(sub, "images.txt"), "w") as f:
            f.write("# i\n# i\n# i\n# i\n")
            for k, tag in enumerate(tags):
                q = _quat_wxyz(_rotation(rng, 0.4))
                t = rng.normal(0, 1, 3)
                f.write(f"{k + 1} " + " ".join(repr(float(x)) for x in (*q, *t))
                        + f" {k + 1} {tag}\n1.0 2.0 -1\n")
        for k, tag in enumerate(tags):
            hw = (64, 96) if k == 0 else (96, 64)
            write_jpeg(j(md, "dense0", "imgs", tag), smooth_image(rng, *hw), 95)
            with h5py.File(j(md, "dense0", "depths", tag[:-4] + ".h5"), "w") as f5:
                f5["depth"] = rng.uniform(1, 20, hw).astype(np.float32)
        np.savez(j(root, "megadepth", "pairs.npz"), scenes=np.array(["0001 0"], object),
                 images=np.array(tags, object), pairs=np.array([(0, 0, 1, 0.5)], object))
        ny = j(root, "nyuv2", "official")
        os.makedirs(ny, exist_ok=True)
        for k in range(2):
            with h5py.File(j(ny, f"scene_{k}.h5"), "w") as f5:
                f5["depth"] = rng.uniform(1, 5, (48, 64)).astype(np.float32)
                f5["rgb"] = np.moveaxis(smooth_image(rng, 48, 64), -1, 0)
    return man


# ------------------------------------------------------------ the runs ----

def run_case(case: str, raw: str, out: str, man: Dict, mods=None, seed: int = 0) -> float:
    """Run one case's tool from raw/<case> into out/<case>; returns its wall
    seconds."""
    mods = mods or port_modules()
    pt = mods.preprocess_train
    src, dst = os.path.join(raw, case), os.path.join(out, case)
    os.makedirs(dst, exist_ok=True)
    t0 = time.perf_counter()
    if case == "blendedmvs":
        out_dir = os.path.join(dst, BLENDEDMVS_SEQ)
        os.makedirs(out_dir, exist_ok=True)
        for v in range(2):
            pt.blendedmvs_process_view(os.path.join(src, BLENDEDMVS_SEQ), f"{v:08d}", out_dir,
                                       resolution=(64, 48))
    elif case == "staticthings3d":
        for cam in ("left", "right"):
            pt.staticthings3d_process_view(src, os.path.join("TRAIN", "A", "0000"), cam, "0006",
                                           dst, resolution=(64, 48))
    elif case == "co3d":
        sel = pt.prepare_co3d_category(CO3D_CATEGORY, src, dst, img_size=64)
        with open(os.path.join(dst, "selected.json"), "w") as f:
            json.dump(sel, f)
    elif case == "wildrgbd":
        frames = pt.prepare_wildrgbd_sequence(os.path.join(src, "scene_000"),
                                              os.path.join(dst, "scene_000"), img_size=64,
                                              num_frames=3)
        with open(os.path.join(dst, "frames.json"), "w") as f:
            json.dump(frames, f)
    elif case == "arkitscenes":
        labels = {}
        for scene, (selection, pairs) in man["arkitscenes"].items():
            labels[scene] = pt.prepare_arkitscenes_scene(
                os.path.join(src, scene), os.path.join(dst, scene), selection, pairs)
        pt.arkitscenes_concat_metadata(dst, list(man["arkitscenes"]))
        with open(os.path.join(dst, "labels.json"), "w") as f:
            json.dump(labels, f)
    elif case == "waymo":
        pt.waymo_crop_sequence(src, dst, WAYMO_SEQ, resolution=64)
        scenes, frames, pairs = pt.waymo_make_video_pairs(dst, man["waymo_frames"],
                                                          strides=(1, 2))
        np.savez(os.path.join(dst, "pairs.npz"), scenes=scenes, frames=frames, pairs=pairs)
    elif case == "scannetpp":
        selection, pairs = man["scannetpp"]
        pt.prepare_scannetpp_scene(os.path.join(src, "scene0"), os.path.join(dst, "scene0"),
                                   selection, pairs, target_resolution=64)
        pt.scannetpp_concat_metadata(dst, ["scene0"])
    elif case == "habitat":
        n = mods.habitat_prep.preprocess_metadata(
            os.path.join(src, "metadata.json"), habitat_render_fn(seed), dst,
            crop_resolution=HABITAT_CROP)
        assert n == 4, n
    elif case == "sens":
        sens = os.path.join(src, "scene0000_00.sens")
        n_all = mods.sens_reader.export_scene(sens, os.path.join(dst, "all"))
        n_small = mods.sens_reader.export_scene(sens, os.path.join(dst, "small"), frame_skip=2,
                                                image_size=(36, 48))
        assert (n_all, n_small) == (3, 2), (n_all, n_small)
    elif case == "raster":
        verts, faces = mods.raster.load_ply_mesh(os.path.join(src, "mesh.ply"))
        for k, (R, t) in enumerate(raster_cameras(seed)):
            c2w = np.eye(4)
            c2w[:3, :3], c2w[:3, 3] = R, t
            np.save(os.path.join(dst, f"depth_{k}.npy"),
                    mods.raster.render_mesh_depth(verts, faces, RASTER_K, c2w, RASTER_HW))
    elif case == "megadepth":
        pt.prepare_megadepth(src, os.path.join(src, "pairs.npz"), dst)
    elif case == "nyuv2":
        mods.preprocess.prepare_nyuv2(src)
        for sub in ("nyu_images", "nyu_depths", "nyu_depth_imgs"):
            os.replace(os.path.join(src, sub), os.path.join(dst, sub))
    else:
        raise ValueError(f"unknown case {case!r}")
    return time.perf_counter() - t0


# the library (float32 barycentrics) against raster_depth_plain (float64):
# covered pixels may differ along triangle edges, depths by float32 rounding
RASTER_EDGE_SHARE = 0.01
RASTER_REL = 1e-4
RASTER_K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]])
RASTER_HW = (48, 64)


def raster_cameras(seed: int, n: int = 2):
    rng = np.random.default_rng(seed + 7)
    return [(_rotation(rng, 1.5), rng.normal(0, 0.3, 3)) for _ in range(n)]


# ---------------------------------------------------------- comparison ----

def _close(got, want, where: str, stats: Dict):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{where}: shape {got.shape} != {want.shape}")
    if want.dtype.kind in "fc":
        if got.dtype.kind not in "fc":
            raise AssertionError(f"{where}: dtype {got.dtype} != {want.dtype}")
        g, w = got.astype(np.float64), want.astype(np.float64)
        same_nan = np.isnan(g) == np.isnan(w)
        err = np.abs(np.where(np.isnan(w), 0, g - w))
        if not same_nan.all() or not (err <= ATOL + RTOL * np.abs(np.nan_to_num(w))).all():
            raise AssertionError(f"{where}: max |diff| {err.max()!r} beyond {RTOL} rel + {ATOL}")
        stats["max_rel"] = max(stats.get("max_rel", 0.0),
                               float((err / np.maximum(np.abs(np.nan_to_num(w)), 1e-300)).max()
                                     if err.size else 0.0))
    elif got.dtype != want.dtype and not (got.dtype.kind == want.dtype.kind == "U"):
        raise AssertionError(f"{where}: dtype {got.dtype} != {want.dtype}")
    elif not np.array_equal(got, want):
        raise AssertionError(f"{where}: values differ")


def _json_close(got, want, where: str, stats: Dict):
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"{where}: keys differ")
        for k in want:
            _json_close(got[k], want[k], f"{where}.{k}", stats)
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], (dict, str, list)):
        if len(got) != len(want):
            raise AssertionError(f"{where}: length differs")
        for i, (g, w) in enumerate(zip(got, want)):
            _json_close(g, w, f"{where}[{i}]", stats)
    elif isinstance(want, str):
        if got != want:
            raise AssertionError(f"{where}: {got!r} != {want!r}")
    else:
        _close(np.asarray(got, np.float64), np.asarray(want, np.float64), where, stats)


def list_tree(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def compare_trees(got: str, want: str) -> Dict:
    """Hold the tree `got` to `want`: the same relative file list; JPEG, EXR
    and other binary files equal byte for byte; PNGs equal in pixels (shape
    and dtype too); .npz, .npy, .json and .txt contents equal, floats within
    RTOL and ATOL. Raises AssertionError naming the first difference;
    returns counts per kind and the largest relative float difference."""
    names, want_names = list_tree(got), list_tree(want)
    if names != want_names:
        raise AssertionError(f"file lists differ: only in {got}: "
                             f"{sorted(set(names) - set(want_names))[:5]}, only in {want}: "
                             f"{sorted(set(want_names) - set(names))[:5]}")
    stats: Dict = {"files": len(names)}
    for rel in names:
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        ext = os.path.splitext(rel)[1].lower()
        kind = ext.lstrip(".")
        stats[kind] = stats.get(kind, 0) + 1
        if ext == ".png":
            _close(read_png(a), read_png(b), rel, stats)
        elif ext == ".npy":
            _close(np.load(a), np.load(b), rel, stats)
        elif ext == ".npz":
            with np.load(a) as za, np.load(b) as zb:
                if sorted(za.files) != sorted(zb.files):
                    raise AssertionError(f"{rel}: keys {sorted(za.files)} != {sorted(zb.files)}")
                for k in zb.files:
                    _close(za[k], zb[k], f"{rel}:{k}", stats)
        elif ext == ".json":
            with open(a) as fa, open(b) as fb:
                _json_close(json.load(fa), json.load(fb), rel, stats)
        elif ext == ".txt":
            _close(np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2), rel, stats)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if fa.read() != fb.read():
                    raise AssertionError(f"{rel}: bytes differ")
    return stats


# -------------------------------------------------------------- viewer ----

class ViewerClient:
    """A websocket client of the viewer server (RFC 6455, client frames
    masked)."""

    def __init__(self, port: int, host: str = "127.0.0.1", timeout: float = 60.0):
        from geo4d_tpu_torch.viz.server import ws_accept_key

        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /ws HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("the viewer closed the connection during the handshake")
            buf += chunk
        head, self._pending = buf.split(b"\r\n\r\n", 1)
        lines = head.decode().split("\r\n")
        if " 101 " not in lines[0] or f"Sec-WebSocket-Accept: {ws_accept_key(key)}" not in lines:
            raise ConnectionError(f"websocket handshake refused: {lines}")

    def _read(self, k: int) -> bytes:
        while len(self._pending) < k:
            chunk = self.sock.recv(max(65536, k - len(self._pending)))
            if not chunk:
                raise ConnectionError("the viewer closed the connection")
            self._pending += chunk
        out, self._pending = self._pending[:k], self._pending[k:]
        return out

    def recv(self) -> Tuple[int, bytes]:
        """(opcode, payload) of the server's next frame."""
        head = self._read(2)
        n = head[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read(8))[0]
        return head[0] & 0x0F, self._read(n) if n else b""

    def send_text(self, text: str):
        payload = text.encode()
        n = len(payload)
        size = (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack(">H", n))
        mask = os.urandom(4)
        self.sock.sendall(bytes([0x81]) + size + mask
                          + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    def close(self):
        self.sock.close()


def fetch_viewer(port: int) -> Tuple[bytes, Dict[int, bytes]]:
    """The meta message and every frame's payload of a running viewer."""
    client = ViewerClient(port)
    try:
        op, meta = client.recv()
        if op != 0x1:
            raise AssertionError(f"the viewer's first message has opcode {op}, not text")
        frames = {}
        for i in range(json.loads(meta)["n_frames"]):
            client.send_text(json.dumps({"type": "get", "i": i}))
            op, frames[i] = client.recv()
            if op != 0x2:
                raise AssertionError(f"frame {i} came with opcode {op}, not binary")
        return meta, frames
    finally:
        client.close()
