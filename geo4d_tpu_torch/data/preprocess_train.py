"""Offline training-set preprocessing on the host: the port's copy of
geo4d_tpu/data/preprocess_train.py, without OpenCV or Pillow.

Each preparer turns a raw dataset download into the processed layout the
training loader reads: cropped and rescaled RGB, depth, adjusted
intrinsics and a cam2world pose per view, plus per-dataset pair and
metadata indexes (reference datasets_preprocess/preprocess_{blendedMVS,
staticthings3d, megadepth, co3d, wildrgbd, arkitscenes, waymo,
scannetpp}.py and waymo_make_pairs.py).

The file formats and codecs are the port's own and write what the JAX
package's OpenCV and Pillow calls write:
  JPEG    data/jpeg.py (Pillow's bytes at the same quality: 75 where Pillow
          is given none, 95 where OpenCV is)
  PNG     data/images.py (8-bit and 16-bit; the same pixels)
  EXR     the uncompressed one-channel layout of `write_depth_exr`
  resize  data/cropping.py (Pillow's Lanczos and bicubic, OpenCV's nearest)
  undistortion  geometry/distortion.py and data/images.py::remap
  mesh depth    geometry/raster.py
Images are held in RGB where the JAX package holds OpenCV's BGR; the files
are the same. h5py (MegaDepth depths), tensorflow with waymo_open_dataset
(Waymo extraction) are imported where they are needed, with the JAX
package's errors; scipy's rotations and interpolation are used as there.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import os.path as osp
import random
import re
import struct
from typing import Dict, List, Optional

import numpy as np

from geo4d_tpu_torch.data.cropping import (
    colmap_to_opencv_intrinsics,
    crop_image_depthmap,
    opencv_to_colmap_intrinsics,
    rescale_image_depthmap,
)
# read_image: np.asarray(Image.open(path)), the JAX preparers' Pillow reads;
# read_rgb(path, convention): Pillow's convert("RGB") or OpenCV's imread, as
# the JAX counterpart of each caller reads colour images
from geo4d_tpu_torch.data.images import read_pillow as read_image
from geo4d_tpu_torch.data.images import read_png, read_rgb, remap, resize_nearest, write_png
from geo4d_tpu_torch.data.jpeg import write_jpeg
from geo4d_tpu_torch.geometry import distortion

# Pillow's JPEG quality when `save` is given none; OpenCV's for `imwrite`
PIL_QUALITY = 75
CV2_QUALITY = 95

# ---------------------------------------------------------------------------
# shared file readers
# ---------------------------------------------------------------------------

EXR_MAGIC = 20000630
_EXR_COMPRESSION = ("none", "rle", "zips", "zip", "piz", "pxr24", "b44", "b44a", "dwaa",
                    "dwab")


def _exr_attr(name: str, typ: str, payload: bytes) -> bytes:
    return (name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload)


def write_depth_exr(path: str, depth: np.ndarray):
    """Write a single-channel float32 depth map as OpenEXR 2.0: one float
    channel 'Y', no compression, increasing-y scanlines (the reference
    stores processed depth as .exr, preprocess_blendedMVS.py:85)."""
    depth = np.ascontiguousarray(depth, np.float32)
    h, w = depth.shape
    chan = b"Y\x00" + struct.pack("<iiii", 2, 0, 1, 1) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        _exr_attr("channels", "chlist", chan)
        + _exr_attr("compression", "compression", b"\x00")
        + _exr_attr("dataWindow", "box2i", box)
        + _exr_attr("displayWindow", "box2i", box)
        + _exr_attr("lineOrder", "lineOrder", b"\x00")
        + _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _exr_attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"                                            # end of header
    )
    magic = struct.pack("<ii", EXR_MAGIC, 2)
    offset0 = len(magic) + len(header) + 8 * h
    row_bytes = 8 + 4 * w                                    # y + size + data
    offsets = b"".join(struct.pack("<Q", offset0 + i * row_bytes) for i in range(h))
    rows = np.zeros((h, 2 + w), np.int32)
    rows[:, 0] = np.arange(h)
    rows[:, 1] = 4 * w
    rows[:, 2:] = depth.view(np.int32)
    with open(path, "wb") as f:
        f.write(magic + header + offsets + rows.astype("<i4").tobytes())


def read_depth_exr(path: str) -> np.ndarray:
    """Read an uncompressed scanline EXR of one float channel (the layout
    `write_depth_exr` writes) as (H, W) float32. A compressed file raises a
    ValueError that names it and its compression."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version = struct.unpack_from("<ii", data, 0)
    if magic != EXR_MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    pos, dw, comp = 8, None, 0
    while data[pos] != 0:                                    # header attributes
        name_end = data.index(b"\x00", pos)
        name = data[pos:name_end].decode()
        type_end = data.index(b"\x00", name_end + 1)
        (size,) = struct.unpack_from("<i", data, type_end + 1)
        pos = type_end + 5
        if name == "dataWindow":
            dw = struct.unpack_from("<iiii", data, pos)
        elif name == "compression":
            comp = data[pos]
        pos += size
    if comp != 0:
        kind = _EXR_COMPRESSION[comp] if comp < len(_EXR_COMPRESSION) else str(comp)
        raise ValueError(f"{path}: EXR compression {kind!r} is not supported (only "
                         "uncompressed files are read)")
    if dw is None:
        raise ValueError(f"{path}: EXR header without a dataWindow")
    pos += 1
    w, h = dw[2] - dw[0] + 1, dw[3] - dw[1] + 1
    pos += 8 * h                                             # offset table
    out = np.empty((h, w), np.float32)
    for y in range(h):
        _, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        out[y] = np.frombuffer(data, np.float32, w, pos)
        pos += size
    return out


def write_image(path: str, img: np.ndarray, quality: int):
    """JPEG (at `quality`) or PNG by the file's extension."""
    if path.lower().endswith(".png"):
        write_png(path, img)
    else:
        write_jpeg(path, img, quality)


def load_pfm(path: str) -> np.ndarray:
    """Portable float map (BlendedMVS rendered depth,
    preprocess_blendedMVS.py:112-146). Returns (H, W[, 3]) float32,
    top-down row order."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path}")
        color = header == "PF"
        dims = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode())
        if not dims:
            raise ValueError(f"bad PFM header in {path}")
        w, h = map(int, dims.groups())
        scale = float(f.readline().decode().strip())
        data = np.frombuffer(f.read(), dtype="<f" if scale < 0 else ">f")
    data = data.reshape((h, w, 3) if color else (h, w))
    return np.ascontiguousarray(data[::-1])  # PFM stores bottom-up


def read_float3(path: str) -> np.ndarray:
    """lmb-freiburg .float3 container (StaticThings3D,
    preprocess_staticthings3d.py:110-126)."""
    with open(path, "rb") as f:
        if f.readline().decode() != "float\n":
            raise ValueError(f"missing float keyword in {path}")
        ndim = int(f.readline())
        dims = [int(f.readline()) for _ in range(ndim)]
        count = int(np.prod(dims))
        data = np.fromfile(f, np.float32, count).reshape(list(reversed(dims)))
    return data


def load_blendedmvs_cam(path: str):
    """BlendedMVS cams/<img>_cam.txt: extrinsic w2c 4x4 then K 3x3
    (preprocess_blendedMVS.py:98-109). Returns (K, R_c2w, t_c2w)."""
    with open(path) as f:
        RT = np.loadtxt(f, skiprows=1, max_rows=4, dtype=np.float32)
        K = np.loadtxt(f, skiprows=2, max_rows=3, dtype=np.float32)
    RT = np.linalg.inv(RT)  # world2cam -> cam2world
    return K, RT[:3, :3], RT[:3, 3]


def colmap_qt_to_w2c(qw, qx, qy, qz, tx, ty, tz) -> np.ndarray:
    """COLMAP images.txt row -> world-to-cam 4x4
    (preprocess_megadepth.py:160-196)."""
    q = np.asarray([qw, qx, qy, qz], np.float64)
    w, x, y, z = q / np.linalg.norm(q)
    R = np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [tx, ty, tz]
    return T


def ndc_to_pinhole_intrinsics(focal_length, principal_point, image_size_hw) -> np.ndarray:
    """PyTorch3D NDC camera -> pixel K (preprocess_co3d.py:65-108 without
    torch: screen scale = min(W,H)/2, principal point flipped)."""
    f = np.asarray(focal_length, np.float64)
    p0 = np.asarray(principal_point, np.float64)
    wh = np.asarray([image_size_hw[1], image_size_hw[0]], np.float64)
    scale = wh.min() / 2.0
    c = wh / 2.0
    pp_px = -p0 * scale + c
    f_px = f * scale
    K = np.eye(3)
    K[0, 0], K[1, 1] = f_px
    K[0, 2], K[1, 2] = pp_px
    return K


def pytorch3d_camera_to_opencv_pose(R, T) -> np.ndarray:
    """PyTorch3D (row-vector, +x left) camera R, T -> OpenCV world-to-cam
    4x4 (preprocess_co3d.py:77-109)."""
    R = np.asarray(R, np.float64).copy()
    T = np.asarray(T, np.float64).copy()
    T[:2] *= -1
    R[:, :2] *= -1
    w2c = np.eye(4)
    w2c[:3, :3] = R.T          # row-vector convention -> column-vector
    w2c[:3, 3] = T
    return w2c


# ---------------------------------------------------------------------------
# BlendedMVS
# ---------------------------------------------------------------------------


def blendedmvs_process_view(root: str, img: str, out_dir: str, resolution=(512, 384)):
    """One view: load cam/image/pfm depth, cover-rescale to 512x384, save
    jpg + exr + npz (preprocess_blendedMVS.py:64-89)."""
    if osp.isfile(osp.join(out_dir, img + ".npz")):
        return
    K, R_c2w, t_c2w = load_blendedmvs_cam(osp.join(root, "cams", img + "_cam.txt"))
    rgb = read_rgb(osp.join(root, "blended_images", img + ".jpg"), "opencv")
    depth = load_pfm(osp.join(root, "rendered_depth_maps", img + ".pfm"))

    rgb, depth, K_out = rescale_image_depthmap(rgb, depth, K, resolution)
    write_jpeg(osp.join(out_dir, img + ".jpg"), rgb, 80)
    write_depth_exr(osp.join(out_dir, img + ".exr"), depth)
    np.savez(osp.join(out_dir, img + ".npz"), intrinsics=K_out,
             R_cam2world=R_c2w, t_cam2world=t_c2w)


def prepare_blendedmvs(db_root: str, output_dir: str, pairs_path: Optional[str] = None):
    """All sequences (24-char hash dirs) -> cropped views; verify the
    precomputed pair index if given (preprocess_blendedMVS.py:36-61)."""
    sequences = [f for f in os.listdir(db_root) if len(f) == 24]
    assert sequences, f"no sequences found at {db_root}"
    for seq in sequences:
        out_dir = osp.join(output_dir, seq)
        os.makedirs(out_dir, exist_ok=True)
        root = osp.join(db_root, seq)
        for f in os.listdir(osp.join(root, "cams")):
            if not f.startswith("pair"):
                blendedmvs_process_view(root, f[:-8], out_dir)
    if pairs_path:
        pairs = np.load(pairs_path)
        for seqh, seql, img1, img2, _score in pairs:
            for view in (img1, img2):
                p = osp.join(output_dir, f"{seqh:08x}{seql:016x}", f"{view:08n}.jpg")
                assert osp.isfile(p), f"missing {p}"


# ---------------------------------------------------------------------------
# StaticThings3D
# ---------------------------------------------------------------------------


def staticthings3d_process_view(db_root: str, seq_rel: str, camera: str, num: str,
                                out_dir: str, resolution=(512, 384)):
    """One (seq, camera, frame): .float3 K/pose/depth + clean/final pngs
    -> jpgs + exr + npz (preprocess_staticthings3d.py:58-88)."""
    rel = osp.join(seq_rel, camera, num)
    if osp.isfile(osp.join(out_dir, rel + ".npz")):
        return
    os.makedirs(osp.join(out_dir, seq_rel, camera), exist_ok=True)
    K = read_float3(osp.join(db_root, "intrinsics", seq_rel, num + ".float3"))
    cam2world = np.linalg.inv(read_float3(osp.join(db_root, "poses", rel + ".float3")))
    depth = read_float3(osp.join(db_root, "depths", rel + ".float3"))
    imgs = {p: read_rgb(osp.join(db_root, f"frames_{p}", rel + ".png"), "opencv")
            for p in ("cleanpass", "finalpass")}
    # both passes share the crop; rescale once with the clean image and
    # re-apply to final (identical geometry)
    clean, depth_out, K_out = rescale_image_depthmap(imgs["cleanpass"], depth, K, resolution)
    final, _, _ = rescale_image_depthmap(imgs["finalpass"], None, K, resolution)
    write_jpeg(osp.join(out_dir, rel + "_clean.jpg"), clean, 80)
    write_jpeg(osp.join(out_dir, rel + "_final.jpg"), final, 80)
    write_depth_exr(osp.join(out_dir, rel + ".exr"), depth_out)
    np.savez(osp.join(out_dir, rel + ".npz"), intrinsics=K_out, cam2world=cam2world)


def prepare_staticthings3d(db_root: str, output_dir: str, pairs_path: Optional[str] = None):
    """TRAIN/A-C scenes x {left,right} x frames 6..15
    (preprocess_staticthings3d.py:36-55)."""
    scenes = []
    for subsplit in "ABC":
        base = osp.join(db_root, "intrinsics", "TRAIN", subsplit)
        if not osp.isdir(base):
            continue
        for seq in sorted(os.listdir(base)):
            scenes.append(osp.join("TRAIN", subsplit, seq))
    assert scenes, f"no scenes at {db_root}"
    for seq_rel in scenes:
        for camera in ("left", "right"):
            for n in range(6, 16):
                staticthings3d_process_view(db_root, seq_rel, camera, f"{n:04d}", output_dir)
    if pairs_path:
        cam_of = {b"l": "left", b"r": "right"}
        for scene, seq, cam1, im1, cam2, im2 in np.load(pairs_path):
            seq_path = osp.join("TRAIN", scene.decode(), f"{seq:04d}")
            for cam, idx in ((cam_of[cam1], im1), (cam_of[cam2], im2)):
                for ext in ("clean", "final"):
                    p = osp.join(output_dir, seq_path, cam, f"{idx:04n}_{ext}.jpg")
                    assert osp.isfile(p), f"missing {p}"


# ---------------------------------------------------------------------------
# MegaDepth
# ---------------------------------------------------------------------------


def load_megadepth_poses(root: str, scene: str, subscene: str):
    """COLMAP manhattan sparse model -> ({img: w2c 4x4},
    {img: ((W,H), K, distortion)}) (preprocess_megadepth.py:108-158)."""
    cam_file = osp.join(root, scene, "sparse", "manhattan", subscene, "cameras.txt")
    with open(cam_file) as f:
        raw = f.readlines()[3:]
    cams = {}
    for line in raw:
        parts = line.split()
        width, height, focal, cx, cy, k0 = [float(v) for v in parts[2:8]]
        K = np.eye(3)
        K[0, 0] = K[1, 1] = focal
        K[0, 2], K[1, 2] = cx, cy
        cams[int(parts[0])] = ((int(width), int(height)), K, (k0, 0, 0, 0))

    img_file = osp.join(root, scene, "sparse", "manhattan", subscene, "images.txt")
    with open(img_file) as f:
        raw = f.read().splitlines()[4:]
    poses, intrinsics = {}, {}
    for image_line in raw[::2]:
        parts = image_line.split()
        img_id = parts[-1]
        cam_id = int(parts[-2])
        vals = [float(v) for v in parts[1:-2]]
        poses[img_id] = colmap_qt_to_w2c(*vals[:7])
        intrinsics[img_id] = cams[cam_id]
    return poses, intrinsics


def megadepth_process_view(in_dir: str, tag: str, K_rectif, pose_w2c, out_dir: str,
                           resolution=(800, 600)):
    """Undistort intrinsics, cover-rescale (no force), save jpg/exr/npz
    (preprocess_megadepth.py:63-97)."""
    if osp.isfile(osp.join(out_dir, tag + ".npz")):
        return
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("megadepth depth maps need h5py") from e

    img = read_rgb(osp.join(in_dir, "imgs", tag), "opencv")
    with h5py.File(osp.join(in_dir, "depths", osp.splitext(tag)[0] + ".h5"), "r") as h5:
        depth = np.asarray(h5["depth"])

    imsize_pre, K_pre, distortion_coeffs = K_rectif
    K_post = distortion.optimal_new_camera_matrix(
        K_pre.astype(np.float64), distortion_coeffs, imsize_pre, 0,
        img.shape[1::-1])
    # landscape/portrait-aware target (preprocess_megadepth.py:92-95)
    h, w = img.shape[:2]
    res = sorted(resolution)[:: 1 if w < h else -1]
    img, depth, K_out = rescale_image_depthmap(img, depth, K_post, res, force=False)
    write_jpeg(osp.join(out_dir, tag + ".jpg"), img, 90)
    write_depth_exr(osp.join(out_dir, tag + ".exr"), depth)
    np.savez(osp.join(out_dir, tag + ".npz"), intrinsics=K_out,
             cam2world=np.linalg.inv(pose_w2c))


def prepare_megadepth(db_root: str, pairs_path: str, output_dir: str):
    """Process exactly the images the precomputed pair index references
    (preprocess_megadepth.py:32-62)."""
    data = np.load(pairs_path, allow_pickle=True)
    scenes, images, pairs = data["scenes"], data["images"], data["pairs"]
    todo = collections.defaultdict(set)
    for scene, im1, im2, _score in pairs:
        todo[scene].update((im1, im2))
    for scene_id, im_idxs in todo.items():
        scene, subscene = scenes[scene_id].split()
        out_dir = osp.join(output_dir, scene, subscene)
        os.makedirs(out_dir, exist_ok=True)
        poses, intrinsics = load_megadepth_poses(db_root, scene, subscene)
        in_dir = osp.join(db_root, scene, "dense" + subscene)
        for im_id in im_idxs:
            tag = images[im_id]
            megadepth_process_view(in_dir, tag, intrinsics[tag], poses[tag], out_dir)


# ---------------------------------------------------------------------------
# object-centric crops (CO3D / WildRGB-D shared geometry)
# ---------------------------------------------------------------------------


def object_centric_crop(
    rgb: np.ndarray,               # (H, W, 3) uint8
    depth_mask: np.ndarray,        # (H, W, 2) [depth | fg-mask]
    K: np.ndarray,
    img_size: int = 512,
):
    """The CO3D/WildRGB-D recipe (preprocess_co3d.py:199-223 =
    preprocess_wildrgbd.py:120-141): center the crop window on the
    principal point (largest symmetric rectangle), then rescale so the
    short side is >= 3/4*img_size (or the long side >= img_size)."""
    H, W = depth_mask.shape[:2]
    cx, cy = np.round(K[:2, 2]).astype(int)
    mx, my = min(cx, W - cx), min(cy, H - cy)
    bbox = (int(cx - mx), int(cy - my), int(cx + mx), int(cy + my))
    rgb, depth_mask, K = crop_image_depthmap(rgb, depth_mask, K, bbox)

    scale = (img_size * 3 // 4) / min(H, W) + 1e-8
    out_res = np.floor(np.array([W, H]) * scale).astype(int)
    if out_res.max() < img_size:
        scale = img_size / max(H, W) + 1e-8
        out_res = np.floor(np.array([W, H]) * scale).astype(int)
    rgb, depth_mask, K = rescale_image_depthmap(rgb, depth_mask, K, out_res)
    return rgb, depth_mask, K


def co3d_read_depth(path: str) -> np.ndarray:
    """CO3D 16-bit png reinterpreted as float16 (preprocess_co3d.py:190-196)."""
    raw = read_png(path).astype(np.uint16)
    return np.frombuffer(raw.tobytes(), dtype=np.float16).astype(np.float32).reshape(raw.shape)


def co3d_get_set_list(category_dir: str, split: str,
                      single_sequence_subset: bool = False) -> List:
    """Parse set_lists/*.json (preprocess_co3d.py:112-127)."""
    listdir = osp.join(category_dir, "set_lists")
    names = os.listdir(listdir)
    key = "manyview_dev" if single_sequence_subset else "fewview_train"
    out = []
    for name in names:
        if key not in name:
            continue
        with open(osp.join(listdir, name)) as f:
            out.extend(json.load(f)[split])
    return out


def prepare_co3d_category(
    category: str,
    co3d_dir: str,
    output_dir: str,
    split: str = "train",
    img_size: int = 512,
    min_quality: float = 0.5,
    max_num_sequences: int = 50,
    seed: int = 42,
    single_sequence_subset: bool = False,
) -> Dict[str, List[int]]:
    """One CO3D category -> processed crops + metadata npz
    (preprocess_co3d.py:130-252). Returns {seq: [frame indices]}."""
    random.seed(seed)
    category_dir = osp.join(co3d_dir, category)
    seq_frames = co3d_get_set_list(category_dir, split, single_sequence_subset)
    seq_names = sorted(set(s for s, _, _ in seq_frames))

    with gzip.open(osp.join(category_dir, "frame_annotations.jgz")) as f:
        frame_data = json.loads(f.read())
    with gzip.open(osp.join(category_dir, "sequence_annotations.jgz")) as f:
        seq_data = json.loads(f.read())
    frames_by_seq: Dict[str, Dict[int, dict]] = {}
    for fd in frame_data:
        frames_by_seq.setdefault(fd["sequence_name"], {})[fd["frame_number"]] = fd
    good = {s["sequence_name"] for s in seq_data if s["viewpoint_quality_score"] > min_quality}
    seq_names = [s for s in seq_names if s in good]
    if len(seq_names) > max_num_sequences:
        seq_names = random.sample(seq_names, max_num_sequences)

    selected: Dict[str, List[int]] = {s: [] for s in seq_names}
    for seq_name, frame_number, filepath in seq_frames:
        if seq_name not in selected:
            continue
        frame_idx = int(filepath.split("/")[-1][5:-4])
        selected[seq_name].append(frame_idx)
        fd = frames_by_seq[seq_name][frame_number]
        assert fd["depth"]["scale_adjustment"] == 1.0

        vp = fd["viewpoint"]
        image_size = fd["image"]["size"]
        K = ndc_to_pinhole_intrinsics(vp["focal_length"], vp["principal_point"], image_size)
        w2c = pytorch3d_camera_to_opencv_pose(vp["R"], vp["T"])

        rgb = read_rgb(osp.join(co3d_dir, filepath), "pillow")
        mask_path = filepath.replace("images", "masks").replace(".jpg", ".png")
        mask = read_image(osp.join(co3d_dir, mask_path)).astype(np.float32) / 255.0
        depth = co3d_read_depth(osp.join(co3d_dir, fd["depth"]["path"]))
        dm = np.stack([depth, mask], axis=-1)

        rgb, dm, K_out = object_centric_crop(rgb, dm, K, img_size)
        depth_out, mask_out = dm[..., 0], dm[..., 1]

        save_img = osp.join(output_dir, filepath)
        save_depth = osp.join(output_dir, fd["depth"]["path"])
        save_mask = osp.join(output_dir, mask_path)
        for p in (save_img, save_depth, save_mask):
            os.makedirs(osp.dirname(p), exist_ok=True)
        write_image(save_img, rgb, PIL_QUALITY)
        dmax = max(float(depth_out.max()), 1e-12)
        write_image(save_depth, (depth_out / dmax * 65535).astype(np.uint16), CV2_QUALITY)
        write_image(save_mask, (mask_out * 255).astype(np.uint8), CV2_QUALITY)
        np.savez(save_img.replace("jpg", "npz"), camera_intrinsics=K_out,
                 camera_pose=np.linalg.inv(w2c), maximum_depth=dmax)
    return selected


def prepare_wildrgbd_sequence(
    scene_dir: str,
    scene_output_dir: str,
    img_size: int = 512,
    num_frames: int = 100,
) -> List[int]:
    """One WildRGB-D sequence: metadata K + cam_poses.txt + uniform frame
    subsample + pp-centered crop (preprocess_wildrgbd.py:82-166)."""
    with open(osp.join(scene_dir, "metadata")) as f:
        meta = json.load(f)
    K = np.array(meta["K"]).reshape(3, 3).T
    poses_raw = np.genfromtxt(osp.join(scene_dir, "cam_poses.txt"))
    c2w = poses_raw[:, 1:].reshape(-1, 4, 4)
    n = len(c2w)
    assert n >= num_frames, f"sequence too short: {n} < {num_frames}"
    frames = np.round(np.linspace(0, n - 1, num_frames)).astype(int).tolist()

    for fid in frames:
        rgb = read_rgb(osp.join(scene_dir, "rgb", f"{fid:0>5d}.png"), "pillow")
        depth = read_png(osp.join(scene_dir, "depth", f"{fid:0>5d}.png")).astype(np.float64)
        mask = read_image(osp.join(scene_dir, "masks", f"{fid:0>5d}.png")).astype(np.float32)
        if mask.max() > 1:
            mask = mask / 255.0
        dm = np.stack([depth, mask], axis=-1)
        rgb, dm, K_out = object_centric_crop(rgb, dm, K, img_size)

        for sub in ("rgb", "depth", "masks", "metadata"):
            os.makedirs(osp.join(scene_output_dir, sub), exist_ok=True)
        write_jpeg(osp.join(scene_output_dir, "rgb", f"{fid:0>5d}.jpg"), rgb, PIL_QUALITY)
        write_png(osp.join(scene_output_dir, "depth", f"{fid:0>5d}.png"),
                  dm[..., 0].astype(np.uint16))
        write_png(osp.join(scene_output_dir, "masks", f"{fid:0>5d}.png"),
                  (dm[..., 1] * 255).astype(np.uint8))
        np.savez(osp.join(scene_output_dir, "metadata", f"{fid:0>5d}.npz"),
                 camera_intrinsics=K_out, camera_pose=c2w[fid])
    return frames


def wildrgbd_get_set_list(category_dir: str, split: str) -> List[str]:
    """Intersect camera_eval/nvs train lists (preprocess_wildrgbd.py:43-57)."""
    listfiles = ["camera_eval_list.json", "nvs_list.json"]
    per_split = {s: {k: set() for k in listfiles} for s in ("train", "val")}
    for lf in listfiles:
        with open(osp.join(category_dir, lf)) as f:
            data = json.load(f)
        for s in ("train", "val"):
            per_split[s][lf].update(data[s])
    train_common = set.intersection(*per_split["train"].values())
    if split == "train":
        return sorted(train_common)
    all_seqs = set.union(*per_split["train"].values(), *per_split["val"].values())
    return sorted(all_seqs - train_common)


# ---------------------------------------------------------------------------
# ARKitScenes
# ---------------------------------------------------------------------------


def read_arkit_traj(traj_path: str):
    """lowres_wide.traj rows: ts, angle-axis(3), t(3) as world-to-device
    (preprocess_arkitscenes.py:60-91). Returns (timestamps (N,),
    c2w poses (N,4,4))."""
    from scipy.spatial.transform import Rotation

    ts, poses = [], []
    with open(traj_path) as f:
        for line in f:
            tok = line.split()
            assert len(tok) == 7
            ts.append(round(float(tok[0]), 3))
            w2p = np.eye(4)
            w2p[:3, :3] = Rotation.from_rotvec(
                [float(tok[1]), float(tok[2]), float(tok[3])]).as_matrix()
            w2p[:3, 3] = [float(tok[4]), float(tok[5]), float(tok[6])]
            poses.append(np.linalg.inv(w2p))
    return np.asarray(ts), np.stack(poses)


def arkit_scene_orientation(poses_c2w: np.ndarray):
    """Which way is the sky, from mean device up/right vectors
    (preprocess_arkitscenes.py:308-349). Returns (label, rotated_to_cam)."""
    from scipy.spatial.transform import Rotation

    up = poses_c2w[:, :3, :3] @ np.array([0.0, -1.0, 0.0])
    right = poses_c2w[:, :3, :3] @ np.array([1.0, 0.0, 0.0])
    up_world = np.array([0.0, 0.0, 1.0])

    def angle(v):
        v = v.mean(0)
        v = v / (np.linalg.norm(v) + 1e-12)
        return np.degrees(np.arccos(np.clip(v @ up_world, -1, 1)))

    a_up, a_right = angle(up), angle(right)
    if abs(a_up - 90) < abs(a_right - 90):
        if a_right > 90:
            label, rz = "LEFT", np.pi / 2
        else:
            label, rz = "RIGHT", -np.pi / 2
    else:
        if a_up > 90:
            label, rz = "DOWN", np.pi
        else:
            label, rz = "UP", 0.0
    cam_to_rotated = np.eye(4)
    cam_to_rotated[:3, :3] = Rotation.from_rotvec([0, 0, rz]).as_matrix()
    return label, np.linalg.inv(cam_to_rotated)


# np.rot90 turns of the images and depths per sky label (RIGHT: 90 degrees
# counter-clockwise, LEFT: clockwise, DOWN: half a turn)
_ARKIT_TURNS = {"RIGHT": 1, "LEFT": -1, "DOWN": 2}


def prepare_arkitscenes_scene(
    scene_dir: str,
    out_scene_dir: str,
    selection: List[str],
    pairs: np.ndarray,
):
    """One ARKitScenes scene: interpolate poses at the selected frames'
    timestamps, read .pincam intrinsics, rotate images/depths so the sky
    is up, write scene_metadata.npz (preprocess_arkitscenes.py:92-257).

    Divergence note (as in the JAX package): the reference interpolates
    rotations with quaternion.squad (cubic); here scipy Slerp (linear) —
    selected frames almost always coincide with trajectory samples, where
    both are exact.
    """
    from scipy.interpolate import interp1d
    from scipy.spatial.transform import Rotation, Slerp

    scene_name = osp.basename(scene_dir.rstrip("/"))
    ts, poses = read_arkit_traj(osp.join(scene_dir, "lowres_wide.traj"))
    label, rotated_to_cam = arkit_scene_orientation(poses)

    sel = [(b, b.split(".png")[0].split("_")[1]) for b in selection]
    ts_sel = np.clip([float(fid) for _, fid in sel], ts.min(), ts.max())
    pos_interp = interp1d(ts, poses[:, :3, 3], kind="linear", axis=0)(ts_sel)
    rot_interp = Slerp(ts, Rotation.from_matrix(poses[:, :3, :3]))(ts_sel)

    trajectories, intrinsics, images = [], [], []
    os.makedirs(osp.join(out_scene_dir, "vga_wide"), exist_ok=True)
    os.makedirs(osp.join(out_scene_dir, "lowres_depth"), exist_ok=True)
    for i, (basename, fid) in enumerate(sel):
        pincam = None
        for delta in (0.0, -0.001, 0.001):
            cand = osp.join(scene_dir, "vga_wide_intrinsics",
                            f"{scene_name}_{float(fid) + delta:.3f}.pincam"
                            if delta else f"{scene_name}_{fid}.pincam")
            if osp.exists(cand):
                pincam = cand
                break
        assert pincam, f"no intrinsics for {basename}"
        w, h, fx, fy, hw, hh = np.loadtxt(pincam)

        pose = np.eye(4)
        pose[:3, :3] = rot_interp[i].as_matrix()
        pose[:3, 3] = pos_interp[i]
        trajectories.append(pose @ rotated_to_cam)
        if label in ("RIGHT", "LEFT"):
            intrinsics.append([h, w, fy, fx, hh, hw])  # axes swap
        else:
            intrinsics.append([w, h, fx, fy, hw, hh])
        images.append(basename)

        img = read_image(osp.join(scene_dir, "vga_wide", basename))
        depth = read_png(osp.join(scene_dir, "lowres_depth", basename))
        if label in _ARKIT_TURNS:
            img = np.ascontiguousarray(np.rot90(img, _ARKIT_TURNS[label]))
            depth = np.ascontiguousarray(np.rot90(depth, _ARKIT_TURNS[label]))
        H, W = img.shape[:2]
        write_jpeg(osp.join(out_scene_dir, "vga_wide", basename.replace(".png", ".jpg")), img,
                   PIL_QUALITY)
        write_png(osp.join(out_scene_dir, "lowres_depth", basename),
                  resize_nearest(depth, (W, H)))

    np.savez(osp.join(out_scene_dir, "scene_metadata.npz"),
             trajectories=np.stack(trajectories),
             intrinsics=np.asarray(intrinsics), images=np.asarray(images), pairs=pairs)
    return label


def arkitscenes_concat_metadata(outsubdir: str, valid_scenes: List[str]):
    """Concat per-scene metadata into all_metadata.npz with pair offsets
    (preprocess_arkitscenes.py:210-266)."""
    offset, counts, sceneids, images = 0, [], [], []
    intrinsics, trajectories, pairs = [], [], []
    for scene_idx, scene in enumerate(valid_scenes):
        with np.load(osp.join(outsubdir, scene, "scene_metadata.npz")) as d:
            n = d["images"].shape[0]
            sceneids.extend([scene_idx] * n)
            images.append(d["images"])
            K = np.tile(np.eye(3), (n, 1, 1))
            K[:, 0, 0] = d["intrinsics"][:, 2]
            K[:, 1, 1] = d["intrinsics"][:, 3]
            K[:, 0, 2] = d["intrinsics"][:, 4]
            K[:, 1, 2] = d["intrinsics"][:, 5]
            intrinsics.append(K)
            trajectories.append(d["trajectories"])
            p = d["pairs"].copy()
            p[:, 0:2] += offset
            pairs.append(p)
            counts.append(offset)
            offset += n
    np.savez(osp.join(outsubdir, "all_metadata.npz"),
             counts=counts, scenes=valid_scenes, sceneids=sceneids,
             images=np.concatenate(images), intrinsics=np.concatenate(intrinsics),
             trajectories=np.concatenate(trajectories), pairs=np.concatenate(pairs))


# ---------------------------------------------------------------------------
# Waymo Open
# ---------------------------------------------------------------------------

# vehicle-frame -> camera-frame axes (x fwd, y left, z up -> optical)
_WAYMO_AXES = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)


def waymo_extract_frames(db_root: str, output_dir: str):
    """tfrecords -> tmp/<seq>/{NNNNN_cam.jpg,.npz,calib.json}
    (preprocess_waymo.py:77-170). Needs the waymo_open_dataset SDK +
    tensorflow, which are deliberately not bundled; install them to run
    this stage. The crop stage below has no such dependency."""
    try:
        import tensorflow.compat.v1 as tf  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "waymo extraction needs `tensorflow` + `waymo_open_dataset` "
            "(see reference preprocess_waymo.py:10-13); the crop stage "
            "(waymo_crop_sequence) runs without them on the extracted tmp/ dir"
        ) from e
    raise NotImplementedError(
        "run the extraction on a machine with the waymo SDK; this repo "
        "implements the geometry stages (waymo_crop_sequence, "
        "waymo_make_video_pairs) which consume the extracted frames"
    )


def waymo_crop_sequence(input_dir: str, output_dir: str, seq: str, resolution: int = 512):
    """Crop stage: per-frame jpg + sparse LIDAR depth (reprojected into
    the rescaled image) + cam2world npz (preprocess_waymo.py:177-246)."""
    seq_dir = osp.join(input_dir, seq)
    out_dir = osp.join(output_dir, seq)
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(seq_dir, "calib.json")) as f:
        calib = json.load(f)

    cam_K, cam_distortion, cam_res, cam_to_car = {}, {}, {}, {}
    for cam_idx, info in calib:
        cam_idx = str(cam_idx)
        cam_res[cam_idx] = (info["width"], info["height"])
        f1, f2, cx, cy, k1, k2, p1, p2, k3 = info["intrinsics"]
        cam_K[cam_idx] = np.asarray([(f1, 0, cx), (0, f2, cy), (0, 0, 1)], np.float64)
        cam_distortion[cam_idx] = np.asarray([k1, k2, p1, p2, k3])
        cam_to_car[cam_idx] = np.asarray(info["extrinsics"]).reshape(4, 4)

    frames = sorted(f[:-4] for f in os.listdir(seq_dir) if f.endswith(".jpg"))
    for frame in frames:
        cam_idx = frame[-1]
        assert cam_idx in "12345", f"bad cam index in {frame}"
        data = np.load(osp.join(seq_dir, frame + ".npz"))
        car_to_world = data["pose"]
        W, H = cam_res[cam_idx]

        pos2d = data["pixels"].round().astype(np.int32)
        T = _WAYMO_AXES @ np.linalg.inv(cam_to_car[cam_idx])
        pts3d = data["pts3d"] @ T[:3, :3].T + T[:3, 3]

        img = read_rgb(osp.join(seq_dir, frame + ".jpg"), "opencv")
        out_res = (resolution, 1) if W > H else (1, resolution)
        img, _, K2 = rescale_image_depthmap(img, None, cam_K[cam_idx], out_res)
        write_jpeg(osp.join(out_dir, frame + ".jpg"), img, 80)

        H2, W2 = img.shape[:2]
        depth = np.zeros((H2, W2), np.float32)
        A = K2 @ np.linalg.inv(cam_K[cam_idx])
        uv = pos2d @ A[:2, :2].T + A[:2, 2]
        x, y = uv.round().astype(np.int32).T
        depth[np.clip(y, 0, H2 - 1), np.clip(x, 0, W2 - 1)] = pts3d[:, 2]
        write_depth_exr(osp.join(out_dir, frame + ".exr"), depth)

        cam2world = car_to_world @ cam_to_car[cam_idx] @ np.linalg.inv(_WAYMO_AXES)
        np.savez(osp.join(out_dir, frame + ".npz"), intrinsics=K2,
                 cam2world=cam2world, distortion=cam_distortion[cam_idx])


def waymo_make_video_pairs(processed_dir: str, frames: List[str],
                           scenes: Optional[List[str]] = None,
                           strides=range(1, 10), step: int = 1):
    """Temporal pair index per camera track (waymo_make_pairs.py:26-58):
    for each sequence, each of the 5 camera tracks, each stride in 1..9,
    pair frame i with frame i+stride. Returns (scenes, frames, pairs)."""
    if scenes is None:
        scenes = sorted(osp.basename(p.rstrip("/"))
                        for p in glob.glob(osp.join(processed_dir, "*/")))
    frame_index = {f: i for i, f in enumerate(frames)}
    pairs = []
    for s_idx, scene in enumerate(scenes):
        for cam in "12345":
            track = sorted(glob.glob(osp.join(processed_dir, scene, f"*_{cam}.jpg")))
            names = [osp.basename(t)[:-4] for t in track]
            ids = [frame_index[n] for n in names if n in frame_index]
            for stride in strides:
                for i in range(0, len(ids) - stride, step):
                    pairs.append([s_idx, ids[i], ids[i + stride]])
    return np.asarray(scenes), np.asarray(frames), np.asarray(pairs, np.int64)


# ---------------------------------------------------------------------------
# ScanNet++
# ---------------------------------------------------------------------------

_RE_DSLR = re.compile(r"^DSC(?P<frameid>\d+).JPG$")
_RE_IPHONE = re.compile(r"frame_(?P<frameid>\d+).jpg$")


def scannetpp_frame_number(name: str, cam_type: str = "dslr") -> str:
    rx = _RE_DSLR if cam_type == "dslr" else _RE_IPHONE
    m = rx.match(name)
    assert m, f"unrecognized {cam_type} image name {name}"
    return m["frameid"]


def load_colmap_sfm(sfm_dir: str, cam_type: str = "dslr"):
    """COLMAP text model -> per-image {intrinsics-row, path, frame_id,
    cam_to_world} (preprocess_scannetpp.py:72-121; the sparse points are
    not needed downstream and are skipped)."""
    from scipy.spatial.transform import Rotation

    with open(osp.join(sfm_dir, "cameras.txt")) as f:
        raw = [line for line in f.read().splitlines() if not line.startswith("#")]
    intrinsics = {}
    for cam in raw:
        parts = cam.split(" ")
        intrinsics[int(parts[0])] = [parts[1]] + [float(v) for v in parts[2:]]

    with open(osp.join(sfm_dir, "images.txt")) as f:
        raw = [line for line in f.read().splitlines() if not line.startswith("#")]
    img_idx, img_infos = {}, {}
    for image_line in raw[0::2]:
        parts = image_line.split(" ")
        idx, img_name = parts[0], parts[-1]
        assert img_name not in img_idx, f"duplicate image {img_name}"
        img_idx[img_name] = idx
        qw, qx, qy, qz, tx, ty, tz = map(float, parts[1:8])
        w2c = np.eye(4)
        w2c[:3, :3] = Rotation.from_quat((qx, qy, qz, qw)).as_matrix()
        w2c[:3, 3] = (tx, ty, tz)
        img_infos[idx] = dict(
            intrinsics=intrinsics[int(parts[-2])],
            path=img_name,
            frame_id=scannetpp_frame_number(img_name, cam_type),
            cam_to_world=np.linalg.inv(w2c),
        )
    return img_idx, img_infos


def scannetpp_undistort(intrinsics_row, rgb, mask):
    """Undistort one view (fisheye DSLR or pinhole iPhone), principal point
    centered (preprocess_scannetpp.py:136-178): bilinear, the image's border
    reflected, the mask's filled with 255."""
    cam_type = intrinsics_row[0]
    width, height = int(intrinsics_row[1]), int(intrinsics_row[2])
    fx, fy, cx, cy = intrinsics_row[3:7]
    dist = np.asarray(intrinsics_row[7:])

    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    K = colmap_to_opencv_intrinsics(K)
    if cam_type == "OPENCV_FISHEYE":
        assert len(dist) == 4
        new_K = distortion.fisheye_estimate_new_camera_matrix(K, dist, (width, height), 0.0)
        new_K[0, 2] = width / 2.0
        new_K[1, 2] = height / 2.0
        map1, map2 = distortion.fisheye_init_undistort_rectify_map(K, dist, new_K,
                                                                   (width, height))
    else:
        new_K = distortion.optimal_new_camera_matrix(K, dist, (width, height), 1,
                                                     (width, height))
        map1, map2 = distortion.init_undistort_rectify_map(K, dist, new_K, (width, height))
    rgb_u = remap(rgb, map1, map2, "linear", "reflect101")
    mask_u = remap(mask, map1, map2, "linear", "constant", 255)
    return width, height, new_K, rgb_u, mask_u


def prepare_scannetpp_scene(
    data_dir: str,
    output_dir_scene: str,
    selection: List[str],
    pairs: np.ndarray,
    target_resolution: int = 512,
    znear: float = 0.05,
    zfar: float = 20.0,
):
    """One ScanNet++ scene: undistort + rescale the selected DSLR/iPhone
    frames, render GT depth from the aligned scan mesh with the host
    z-buffer rasteriser (pyrender replacement), write scene_metadata.npz
    (preprocess_scannetpp.py:181-330)."""
    from geo4d_tpu_torch.geometry.raster import load_ply_mesh, render_mesh_depth

    rgb_out = osp.join(output_dir_scene, "images")
    depth_out = osp.join(output_dir_scene, "depth")
    os.makedirs(rgb_out, exist_ok=True)
    os.makedirs(depth_out, exist_ok=True)

    verts, faces = load_ply_mesh(osp.join(data_dir, "scans", "mesh_aligned_0.05.ply"))

    cams = {
        "dslr": dict(
            sfm=osp.join(data_dir, "dslr", "colmap"),
            rgb=osp.join(data_dir, "dslr", "resized_images"),
            mask=osp.join(data_dir, "dslr", "resized_anon_masks"),
            select=[n + ".JPG" for n in selection if n.startswith("DSC")],
        ),
        "iphone": dict(
            sfm=osp.join(data_dir, "iphone", "colmap"),
            rgb=osp.join(data_dir, "iphone", "rgb"),
            mask=osp.join(data_dir, "iphone", "rgb_masks"),
            select=[n + ".jpg" for n in selection if n.startswith("frame_")],
        ),
    }
    all_infos = {}
    for cam_type, c in cams.items():
        img_idx, img_infos = load_colmap_sfm(c["sfm"], cam_type)
        for imgname in c["select"]:
            info = img_infos[img_idx[imgname]]
            rgb = read_image(osp.join(c["rgb"], info["path"]))
            mask = read_image(osp.join(c["mask"], info["path"][:-3] + "png"))
            _, _, K, rgb, mask = scannetpp_undistort(info["intrinsics"], rgb, mask)
            K = colmap_to_opencv_intrinsics(K)
            rgb, mask, K = rescale_image_depthmap(
                rgb, mask.astype(np.float32), K,
                (target_resolution, target_resolution * 3.0 / 4))
            H, W = rgb.shape[:2]
            K = opencv_to_colmap_intrinsics(K)
            info["intrinsics"] = K
            write_jpeg(osp.join(rgb_out, info["path"][:-3] + "jpg"), rgb, PIL_QUALITY)

            depth = render_mesh_depth(verts, faces, colmap_to_opencv_intrinsics(K),
                                      info["cam_to_world"], (H, W), znear, zfar)
            depth = (depth * 1000).astype(np.uint16)
            depth[mask < 255] = 0      # anonymization mask invalidates depth
            write_png(osp.join(depth_out, info["path"][:-3] + "png"), depth)
            all_infos[imgname] = info

    trajectories, intrinsics = [], []
    for name in selection:
        full = name + (".JPG" if name.startswith("DSC") else ".jpg")
        trajectories.append(all_infos[full]["cam_to_world"])
        intrinsics.append(all_infos[full]["intrinsics"])
    np.savez(osp.join(output_dir_scene, "scene_metadata.npz"),
             trajectories=np.stack(trajectories), intrinsics=np.stack(intrinsics),
             images=np.asarray(selection), pairs=pairs)


def scannetpp_concat_metadata(output_dir: str, scenes: List[str]):
    """all_metadata.npz across scenes with pair-index offsets
    (preprocess_scannetpp.py:333-383)."""
    offset, counts, sceneids = 0, [], []
    images, intrinsics, trajectories, pairs = [], [], [], []
    for scene_idx, scene in enumerate(scenes):
        with np.load(osp.join(output_dir, scene, "scene_metadata.npz")) as d:
            n = d["images"].shape[0]
            sceneids.extend([scene_idx] * n)
            images.append(d["images"])
            intrinsics.append(d["intrinsics"])
            trajectories.append(d["trajectories"])
            p = d["pairs"].copy()
            p[:, 0:2] += offset
            pairs.append(p)
            counts.append(offset)
            offset += n
    np.savez(osp.join(output_dir, "all_metadata.npz"),
             counts=counts, scenes=scenes, sceneids=sceneids,
             images=np.concatenate(images), intrinsics=np.concatenate(intrinsics),
             trajectories=np.concatenate(trajectories), pairs=np.concatenate(pairs))
