"""Evaluation dataset registry and sequence loader, the port's copy of
geo4d_tpu/data/datasets.py (the reference's dust3r/eval_metadata_geo4d.py
paths, sequence lists and trajectory formats, and lvdm/data/
eval_dataset_geo4d.py resolutions, frame rates and ground-truth readers).

Depth PNGs are read by data/images.py (16-bit grayscale, no OpenCV),
frames by data/video.py's `load_image_dir` (as uint8; the pipeline
normalises them on the device).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from geo4d_tpu_torch.data.images import read_png
from geo4d_tpu_torch.data.video import load_image_dir
from geo4d_tpu_torch.evals.trajectory import Trajectory

# (W, H) eval resolutions (eval_dataset_geo4d.py:13-26)
DATASET_RESOLUTION: Dict[str, Tuple[int, int]] = {
    "sintel": (576, 256),
    "bonn": (512, 384),
    "kitti": (640, 192),
    "scannet": (512, 384),
    "tum": (512, 384),
    "davis": (512, 320),
    "custom": (512, 320),
}

DATASET_FPS: Dict[str, int] = {
    "sintel": 24, "bonn": 24, "kitti": 10, "scannet": 24,
    "tum": 24, "davis": 24, "custom": 24,
}

SINTEL_POSE_SEQS = [
    "alley_2", "ambush_4", "ambush_5", "ambush_6", "cave_2", "cave_4",
    "market_2", "market_5", "market_6", "shaman_3", "sleeping_1",
    "sleeping_2", "temple_2", "temple_3",
]

BONN_SEQS = ["balloon2", "crowd2", "crowd3", "person_tracking2", "synchronous"]

DEFAULT_PROMPT = (
    "Output a video that assigns each 3D location in the world a consistent color."
)


@dataclasses.dataclass
class DatasetSpec:
    name: str
    img_dir: Callable[[str, str], str]          # (root, seq) -> frames dir
    gt_traj: Callable[[str, str], Optional[str]]  # (root, seq) -> traj path
    traj_format: Optional[str]                  # 'tum' | 'replica' | 'sintel' | None
    seq_list: Optional[List[str]]
    depth_reader: Optional[str]                 # 'sintel_dpt'|'png_5000'|'kitti_png'|None
    depth_path: Optional[Callable[[str, str], str]] = None


DATASETS: Dict[str, DatasetSpec] = {
    "sintel": DatasetSpec(
        name="sintel",
        img_dir=lambda root, seq: os.path.join(root, "training/final", seq),
        gt_traj=lambda root, seq: os.path.join(root, "training/camdata_left", seq),
        traj_format="sintel",
        seq_list=SINTEL_POSE_SEQS,
        depth_reader="sintel_dpt",
        depth_path=lambda root, seq: os.path.join(root, "training/depth", seq),
    ),
    "bonn": DatasetSpec(
        name="bonn",
        img_dir=lambda root, seq: os.path.join(root, f"rgbd_bonn_{seq}", "rgb_110"),
        gt_traj=lambda root, seq: os.path.join(
            root, f"rgbd_bonn_{seq}", "groundtruth_110.txt"
        ),
        traj_format="tum",
        seq_list=BONN_SEQS,
        depth_reader="png_5000",
        depth_path=lambda root, seq: os.path.join(
            root, f"rgbd_bonn_{seq}", "depth_110"
        ),
    ),
    "kitti": DatasetSpec(
        name="kitti",
        img_dir=lambda root, seq: os.path.join(root, "image_gathered", seq),
        gt_traj=lambda root, seq: None,
        traj_format=None,
        seq_list=None,
        depth_reader="kitti_png",
        depth_path=lambda root, seq: os.path.join(root, "depth_gathered", seq),
    ),
    "tum": DatasetSpec(
        name="tum",
        img_dir=lambda root, seq: os.path.join(root, seq, "rgb_90"),
        gt_traj=lambda root, seq: os.path.join(root, seq, "groundtruth_90.txt"),
        traj_format="tum",
        seq_list=None,
        depth_reader=None,
    ),
    "scannet": DatasetSpec(
        name="scannet",
        img_dir=lambda root, seq: os.path.join(root, seq, "color_90"),
        gt_traj=lambda root, seq: os.path.join(root, seq, "pose_90.txt"),
        traj_format="replica",
        seq_list=None,
        depth_reader="png_1000",
        depth_path=lambda root, seq: os.path.join(root, seq, "depth_90"),
    ),
    "davis": DatasetSpec(
        name="davis",
        img_dir=lambda root, seq: os.path.join(root, "DAVIS/JPEGImages/480p", seq),
        gt_traj=lambda root, seq: None,
        traj_format=None,
        seq_list=None,
        depth_reader=None,
    ),
    "custom": DatasetSpec(
        name="custom",
        img_dir=lambda root, seq: os.path.join(root, seq),
        gt_traj=lambda root, seq: None,
        traj_format=None,
        seq_list=None,
        depth_reader=None,
    ),
}


# ---------------- GT depth readers (eval_dataset_geo4d.py:36-69) ----------------

def read_dpt(path: str) -> np.ndarray:
    """Sintel .dpt (middlebury float map) reader."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        if abs(tag - 202021.25) >= 1e-3:
            raise ValueError(f"bad .dpt tag in {path}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, w * h)
    return data.reshape(h, w)


def read_depth_png(path: str, scale: float) -> np.ndarray:
    """A grayscale depth PNG (16-bit as a rule) divided by `scale`."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: a depth PNG must be grayscale, got shape {img.shape}")
    return img.astype(np.float32) / scale


def read_gt_depths(spec: DatasetSpec, root: str, seq: str,
                   max_frames: int = -1) -> Optional[np.ndarray]:
    if spec.depth_reader is None or spec.depth_path is None:
        return None
    ddir = spec.depth_path(root, seq)
    if not os.path.isdir(ddir):
        return None
    files = sorted(glob.glob(os.path.join(ddir, "*")))
    if max_frames > 0:
        files = files[:max_frames]
    out = []
    for f in files:
        if spec.depth_reader == "sintel_dpt":
            out.append(read_dpt(f))
        elif spec.depth_reader == "png_5000":
            out.append(read_depth_png(f, 5000.0))
        elif spec.depth_reader == "png_1000":
            out.append(read_depth_png(f, 1000.0))
        elif spec.depth_reader == "kitti_png":
            out.append(read_depth_png(f, 256.0))
    return np.stack(out) if out else None


# ---------------- GT trajectory loaders (vo_eval.py:18-138) ----------------

def load_traj(spec: DatasetSpec, root: str, seq: str) -> Optional[np.ndarray]:
    """Returns TUM rows (N, 8) or None."""
    path = spec.gt_traj(root, seq)
    if path is None or not os.path.exists(path):
        return None
    if spec.traj_format == "tum":
        rows = np.loadtxt(path)
        return rows[:, :8]
    if spec.traj_format == "replica":
        # one flattened 4x4 c2w per line
        mats = np.loadtxt(path).reshape(-1, 4, 4)
        return Trajectory.from_matrices(mats).to_tum()
    if spec.traj_format == "sintel":
        # directory of .cam files: each has K (3x3) and w2c E (3x4)
        cams = sorted(glob.glob(os.path.join(path, "*.cam")))
        if not cams:
            return None
        poses = []
        for c in cams:
            K, E = read_sintel_cam(c)
            w2c = np.eye(4)
            w2c[:3] = E
            poses.append(np.linalg.inv(w2c))
        return Trajectory.from_matrices(np.stack(poses)).to_tum()
    return None


def read_sintel_cam(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel .cam: TAG, M (3x3 intrinsics), N (3x4 extrinsics w2c)."""
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, 1)[0]
        if abs(tag - 202021.25) >= 1e-3:
            raise ValueError(f"bad .cam tag in {path}")
        M = np.fromfile(f, np.float64, 9).reshape(3, 3)
        N = np.fromfile(f, np.float64, 12).reshape(3, 4)
    return M, N


def load_intrinsics(spec: DatasetSpec, root: str, seq: str) -> Optional[np.ndarray]:
    if spec.traj_format == "sintel":
        path = spec.gt_traj(root, seq)
        cams = sorted(glob.glob(os.path.join(path, "*.cam")))
        if cams:
            return np.stack([read_sintel_cam(c)[0] for c in cams])
    return None


@dataclasses.dataclass
class EvalSequence:
    """One evaluation sample (the EvalDataloader item contract)."""

    seq: str
    frames: np.ndarray            # (T, H, W, 3) uint8
    fps: int
    caption: str
    gt_depth: Optional[np.ndarray]
    gt_traj: Optional[np.ndarray]  # TUM rows
    intrinsics: Optional[np.ndarray]


def load_eval_sequence(
    dataset: str, root: str, seq: str, max_frames: int = -1,
    resolution: Optional[Tuple[int, int]] = None,
) -> EvalSequence:
    """`resolution` (W, H) overrides the per-dataset table — used by the
    --tiny smoke path; metric-bearing runs use the table
    (eval_dataset_geo4d.py:13-26)."""
    spec = DATASETS[dataset]
    res = resolution or DATASET_RESOLUTION[dataset]
    frames, _ = load_image_dir(spec.img_dir(root, seq), res, max_frames=max_frames)
    return EvalSequence(
        seq=seq,
        frames=frames,
        fps=DATASET_FPS[dataset],
        caption=DEFAULT_PROMPT,
        gt_depth=read_gt_depths(spec, root, seq, max_frames=max_frames),
        gt_traj=load_traj(spec, root, seq),
        intrinsics=load_intrinsics(spec, root, seq),
    )


def list_sequences(dataset: str, root: str) -> List[str]:
    spec = DATASETS[dataset]
    if spec.seq_list is not None:
        return spec.seq_list
    base = spec.img_dir(root, "")
    parent = os.path.dirname(base.rstrip("/"))
    if os.path.isdir(parent):
        return sorted(
            d for d in os.listdir(parent) if os.path.isdir(os.path.join(parent, d))
        )
    return []
