"""Habitat training-data preprocessing: the geometry stages. The port's copy
of geo4d_tpu/data/habitat_prep.py, without OpenCV: the crops are remapped
by data/images.py::remap (OpenCV's bilinear and nearest rules with a
wrapping border), the JPEG written by data/jpeg.py at OpenCV's default
quality 95 (the same bytes).

Counterpart of the reference's
`datasets_preprocess/habitat/` subsystem (preprocess_habitat.py +
habitat_renderer/{projections,projections_conversions,
multiview_crop_generator}.py): given per-viewpoint equirectangular
environment maps (color + distance), extract perspective crops with exact
pointmaps/depthmaps and OpenCV-convention camera parameters, driven by the
same `metadata.json` view-batch format.

Split of concerns (the waymo-style split, PARITY.md): everything geometric
— equirect/perspective projections, rotated frames, envmap->crop remapping
with anti-alias jittering, distance->depth conversion, pointmap assembly,
intrinsics convention conversions, the metadata driver — is implemented
here in vectorized numpy. The ONLY sim-dependent piece, rendering an
equirectangular envmap at a position inside a Habitat scene, is an
injectable `render_fn(position) -> (color (H,W,3) u8, distance (H,W) f32)`;
`make_habitat_render_fn` builds one from habitat-sim when that external SDK
is installed (documented boundary, like the waymo tfrecord extraction).

Conventions (reference projections.py): OpenCV-style axes (+X right,
+Y down, +Z forward) except the top-left pixel CENTER is at (0.5, 0.5)
(colmap-style); `colmap_to_opencv_intrinsics` shifts the principal point
when serializing.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from geo4d_tpu_torch.data.images import remap
from geo4d_tpu_torch.data.jpeg import write_jpeg
from geo4d_tpu_torch.data.preprocess_train import write_depth_exr

RenderFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]


# ----------------------------------------------------------------- rays ----

def equirect_unproject(u: np.ndarray, v: np.ndarray, h: int, w: int):
    """Pixel coords -> unit rays on the equirect sphere (lon in [-pi,pi)
    maps u across the width, latitude maps v down the height)."""
    lon = u * (2 * np.pi / w) - np.pi
    mlat = v * (np.pi / h) - np.pi / 2
    cos_lat = np.cos(mlat)
    return np.stack(
        [np.sin(lon) * cos_lat, np.sin(mlat), np.cos(lon) * cos_lat], axis=-1
    )


def equirect_project(rays: np.ndarray, h: int, w: int):
    """Rays -> equirect pixel coords (inverse of equirect_unproject)."""
    r = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    lon = np.arctan2(r[..., 0], r[..., 2])
    mlat = np.arcsin(np.clip(r[..., 1], -1.0, 1.0))
    u = (lon + np.pi) * (w / (2 * np.pi))
    v = (mlat + np.pi / 2) * (h / np.pi)
    return u, v


def perspective_unproject(u: np.ndarray, v: np.ndarray, K: np.ndarray):
    uv1 = np.stack([u, v, np.ones_like(u)], axis=-1)
    return uv1 @ np.linalg.inv(K).T


def perspective_project(rays: np.ndarray, K: np.ndarray):
    uvw = rays @ K.T
    return uvw[..., 0] / uvw[..., 2], uvw[..., 1] / uvw[..., 2]


def pixel_grid(h: int, w: int, jitter: float = 0.0,
               rng: Optional[np.random.Generator] = None):
    """Pixel-center grid (colmap convention: centers at +0.5), optionally
    jittered for the anti-aliasing multi-map remap."""
    gu, gv = np.meshgrid(0.5 + np.arange(w), 0.5 + np.arange(h))
    if jitter > 0:
        assert rng is not None
        gu = gu + np.clip(jitter * rng.uniform(-0.5, 0.5, gu.shape), 0, w)
        gv = gv + np.clip(jitter * rng.uniform(-0.5, 0.5, gv.shape), 0, h)
    return gu, gv


def camera_intrinsics_from_hfov(h: int, w: int, hfov_deg: float) -> np.ndarray:
    f = w / 2 / np.tan(np.radians(hfov_deg) / 2)
    return np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])


def colmap_to_opencv_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy()
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


# --------------------------------------------------------------- crops ----

@dataclass
class PerspectiveCamera:
    """A crop camera: colmap-convention intrinsics + world rotation
    (R_cam2world) + world position."""

    K: np.ndarray            # (3,3)
    R_cam2world: np.ndarray  # (3,3)
    position: np.ndarray     # (3,)
    height: int
    width: int

    def rays_cam(self, jitter: float = 0.0, rng=None) -> np.ndarray:
        gu, gv = pixel_grid(self.height, self.width, jitter, rng)
        return perspective_unproject(gu, gv, self.K)

    def to_dict(self) -> Dict:
        """Reference camera_params.json layout
        (multiview_crop_generator.perspective_projection_to_dict)."""
        return dict(
            camera_intrinsics=colmap_to_opencv_intrinsics(self.K).tolist(),
            size=(self.width, self.height),
            R_cam2world=self.R_cam2world.tolist(),
            t_cam2world=np.asarray(self.position).tolist(),
        )

    @staticmethod
    def from_dict(d: Dict) -> "PerspectiveCamera":
        w, h = d["size"]
        return PerspectiveCamera(
            K=opencv_to_colmap_intrinsics(np.asarray(d["camera_intrinsics"],
                                                     float)),
            R_cam2world=np.asarray(d["R_cam2world"], float),
            position=np.asarray(d["t_cam2world"], float),
            height=int(h),
            width=int(w),
        )


def envmap_pointmap(distance: np.ndarray, position: np.ndarray,
                    R_env2world: Optional[np.ndarray] = None) -> np.ndarray:
    """World-space point per envmap pixel: unit ray * distance + position."""
    h, w = distance.shape
    gu, gv = pixel_grid(h, w)
    rays = equirect_unproject(gu, gv, h, w)
    if R_env2world is not None:
        rays = rays @ R_env2world.T
    return rays * distance[..., None] + np.asarray(position, float)


def crop_remap_coords(cam: PerspectiveCamera, env_h: int, env_w: int,
                      R_env2world: Optional[np.ndarray] = None,
                      jitter: float = 0.0, rng=None):
    """(map_u, map_v) f32 maps for remap: for each crop pixel, the
    envmap coordinates of its world ray."""
    rays_world = cam.rays_cam(jitter, rng) @ cam.R_cam2world.T
    rays_env = rays_world if R_env2world is None else rays_world @ R_env2world
    u, v = equirect_project(rays_env, env_h, env_w)
    return u.astype(np.float32), v.astype(np.float32)


def extract_crop(
    cam: PerspectiveCamera,
    color_env: np.ndarray,        # (H,W,3) uint8
    distance_env: np.ndarray,     # (H,W) float
    pointmap_env: Optional[np.ndarray] = None,   # (H,W,3) world points
    R_env2world: Optional[np.ndarray] = None,
    jitter_iterations: int = 5,
    jitter_noise: float = 1.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Perspective crop from an equirect envmap -> (color, depth, pointmap).

    Color is averaged over `jitter_iterations` jittered remaps (the
    reference's aliasing mitigation); distance/pointmap use one
    nearest-neighbor map so geometry stays exact. The returned depth is
    z-depth: distance / |cam ray| (reference multiview_crop_generator
    extract_cropped_camera)."""
    env_h, env_w = distance_env.shape
    rng = np.random.default_rng(seed)

    mu, mv = crop_remap_coords(cam, env_h, env_w, R_env2world)
    colors = [remap(color_env, mu, mv, "linear", "wrap").astype(np.float64)]
    for _ in range(jitter_iterations):
        ju, jv = crop_remap_coords(cam, env_h, env_w, R_env2world,
                                   jitter=jitter_noise, rng=rng)
        colors.append(remap(color_env, ju, jv, "linear", "wrap").astype(np.float64))
    color = np.mean(colors, axis=0).astype(color_env.dtype)

    distance = remap(distance_env.astype(np.float32), mu, mv, "nearest", "wrap")
    ray_norm = np.linalg.norm(cam.rays_cam(), axis=-1)
    depth = (distance / ray_norm).astype(np.float32)

    points = None
    if pointmap_env is not None:
        points = remap(pointmap_env.astype(np.float32), mu, mv, "nearest", "wrap")
    return color, depth, points


# -------------------------------------------------------------- driver ----

def preprocess_metadata(
    metadata_path: str,
    render_fn: RenderFn,
    output_dir: str,
    R_env2world: Optional[np.ndarray] = None,
    crop_resolution: Tuple[int, int] = (512, 512),
    fix_existing: bool = False,
) -> int:
    """Process one scene's metadata.json (the reference's 5views_v1 format:
    {"view_batches": {batch: {view: camera_params}}}) into
    <label>.jpeg / <label>_depth.exr / <label>_camera_params.json files.
    Returns the number of views written. render_fn supplies the envmaps
    (see make_habitat_render_fn for the habitat-sim-backed one)."""
    with open(metadata_path) as f:
        metadata = json.load(f)
    os.makedirs(output_dir, exist_ok=True)

    n = 0
    envmap_cache: Dict[Tuple[float, ...], Tuple[np.ndarray, ...]] = {}
    for batch_label, batch in metadata["view_batches"].items():
        for view_label, view_params in batch.items():
            assert list(view_params["size"]) == list(crop_resolution), (
                view_params["size"], crop_resolution)
            label = f"{batch_label}_{view_label}"
            params_path = os.path.join(
                output_dir, f"{label}_camera_params.json")
            if fix_existing and os.path.isfile(params_path):
                continue
            cam = PerspectiveCamera.from_dict(view_params)

            pos_key = tuple(np.asarray(cam.position, float))
            if pos_key not in envmap_cache:
                color_env, dist_env = render_fn(np.asarray(cam.position))
                pointmap_env = envmap_pointmap(dist_env, cam.position,
                                               R_env2world)
                envmap_cache[pos_key] = (color_env, dist_env, pointmap_env)
            color_env, dist_env, pointmap_env = envmap_cache[pos_key]

            color, depth, _ = extract_crop(
                cam, color_env, dist_env, pointmap_env, R_env2world)
            write_jpeg(os.path.join(output_dir, f"{label}.jpeg"), color, 95)
            write_depth_exr(
                os.path.join(output_dir, f"{label}_depth.exr"), depth)
            with open(params_path, "w") as f:
                json.dump(cam.to_dict(), f)
            n += 1
    return n


def make_habitat_render_fn(
    scene: str,
    scene_dataset_config_file: str = "",
    equirectangular_resolution: Tuple[int, int] = (2048, 4096),
) -> RenderFn:
    """Build a render_fn from habitat-sim (external SDK boundary — the only
    part of the reference habitat pipeline that cannot run without the
    simulator; everything geometric lives above in pure numpy)."""
    try:
        import habitat_sim  # noqa: F401
    except ImportError as e:
        raise NotImplementedError(
            "habitat-sim is not installed. Install the Habitat simulator "
            "(https://github.com/facebookresearch/habitat-sim) to render "
            "envmaps; all geometry stages (crop extraction, pointmaps, "
            "camera serialization) run without it via an injected "
            "render_fn."
        ) from e
    raise NotImplementedError(
        "habitat-sim detected but the cubemap->equirect renderer binding "
        "is not wired in this environment; supply render_fn directly."
    )
