"""Joint image + depthmap + intrinsics crop/rescale for training prep, the
port's own copy of geo4d_tpu/data/cropping.py (reference utils/cropping.py:
rescale_image_depthmap :180, center_crop_image_depthmap :210,
camera_matrix_of_crop :268, crop_image_depthmap :283,
bbox_from_intrinsics_in_out :300, and the colmap<->opencv principal-point
convention shift of utils/geometry.py).

Host-side numpy without Pillow or OpenCV: images resize with Pillow's
Lanczos (shrinking) or bicubic (growing) filter bit for bit
(data/images.py), depth maps with OpenCV's INTER_NEAREST rule (source index
floor(x / (out / in)), clamped). All functions take and return numpy arrays;
images are (H, W, 3) or (H, W) uint8, depthmaps (H, W) float, intrinsics
(3, 3). tests/test_torch_data_loader.py holds them to the original.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from geo4d_tpu_torch.data.images import bicubic_resize, lanczos_resize, resize_nearest


def opencv_to_colmap_intrinsics(K: np.ndarray) -> np.ndarray:
    """OpenCV pixel-center origin (0,0 at first pixel center) -> COLMAP
    corner origin: principal point shifts by +0.5."""
    K = K.copy().astype(np.float64)
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def colmap_to_opencv_intrinsics(K: np.ndarray) -> np.ndarray:
    K = K.copy().astype(np.float64)
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def _resize_image(img: np.ndarray, wh: Tuple[int, int], down: bool) -> np.ndarray:
    """Lanczos when shrinking, bicubic when growing (cropping.py:199), as
    Pillow computes them."""
    return (lanczos_resize if down else bicubic_resize)(img, tuple(int(v) for v in wh))


def _resize_depth(depth: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    """Nearest neighbour as cv2.resize(..., INTER_NEAREST) picks it
    (data/images.py::resize_nearest); depth must not be interpolated across
    edges. A trailing channel of one is dropped, as OpenCV drops it."""
    out = resize_nearest(depth, wh)
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out


def camera_matrix_of_crop(
    K: np.ndarray,
    input_resolution,              # (W, H)
    output_resolution,             # (W, H)
    scaling: float = 1.0,
    offset_factor: float = 0.5,
    offset=None,
) -> np.ndarray:
    """Intrinsics after scale-then-crop (cropping.py:268-281): scale in
    COLMAP convention, shift the principal point by the crop offset."""
    margins = np.asarray(input_resolution, np.float64) * scaling - np.asarray(
        output_resolution, np.float64
    )
    assert (margins >= 0).all(), "crop larger than the scaled image"
    if offset is None:
        offset = offset_factor * margins
    Kc = opencv_to_colmap_intrinsics(K)
    Kc[:2, :] *= scaling
    Kc[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(Kc)


def rescale_image_depthmap(
    image: np.ndarray,
    depthmap: Optional[np.ndarray],
    K: np.ndarray,
    output_resolution,             # (W, H) minimum target
    force: bool = True,
):
    """Jointly rescale so the result COVERS output_resolution
    (cropping.py:180-208): scale = max over axes, aspect preserved."""
    in_res = np.asarray([image.shape[1], image.shape[0]])  # (W, H)
    out_req = np.asarray(output_resolution)
    if depthmap is not None:
        assert depthmap.shape[:2] == image.shape[:2]

    scale = float(np.max(out_req / in_res)) + 1e-8
    if scale >= 1 and not force:
        return image, depthmap, K
    out_res = np.floor(in_res * scale).astype(int)

    image = _resize_image(image, tuple(out_res), down=scale < 1)
    if depthmap is not None:
        depthmap = _resize_depth(depthmap, tuple(out_res))
    K = camera_matrix_of_crop(K, in_res, out_res, scaling=scale)
    return image, depthmap, K


def crop_image_depthmap(
    image: np.ndarray,
    depthmap: Optional[np.ndarray],
    K: np.ndarray,
    crop_bbox,                     # (l, t, r, b)
):
    """Crop a view; principal point shifts by the corner
    (cropping.py:283-297)."""
    l, t, r, b = crop_bbox
    image = image[t:b, l:r]
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    K = K.copy().astype(np.float64)
    K[0, 2] -= l
    K[1, 2] -= t
    return image, depthmap, K


def center_crop_image_depthmap(
    image: np.ndarray,
    depthmap: Optional[np.ndarray],
    K: np.ndarray,
    crop_scale: float,
):
    """Keep the central `crop_scale` fraction; focal unchanged, principal
    point shifted (cropping.py:210-266)."""
    assert 0 < crop_scale <= 1
    in_res = np.asarray([image.shape[1], image.shape[0]])
    out_res = np.floor(in_res * crop_scale).astype(int)
    l, t = ((in_res - out_res) / 2).astype(int)
    return crop_image_depthmap(
        image, depthmap, K, (l, t, l + out_res[0], t + out_res[1])
    )


def bbox_from_intrinsics_in_out(
    K_in: np.ndarray, K_out: np.ndarray, output_resolution
):
    """Crop bbox that maps K_in to K_out (cropping.py:300-304)."""
    out_w, out_h = output_resolution
    l, t = np.int32(np.round(K_in[:2, 2] - K_out[:2, 2]))
    return (int(l), int(t), int(l) + int(out_w), int(t) + int(out_h))


def crop_resize_to(
    image: np.ndarray,
    depthmap: Optional[np.ndarray],
    K: np.ndarray,
    resolution,                    # (W, H) exact target
):
    """The preprocessors' standard two-step: cover-rescale, then crop the
    principal-point-centered window of exactly `resolution` (the pattern
    every reference preprocess_*.py applies via dust3r cropping)."""
    image, depthmap, K = rescale_image_depthmap(image, depthmap, K, resolution)
    in_res = np.asarray([image.shape[1], image.shape[0]])
    K_out = camera_matrix_of_crop(K, in_res, resolution, scaling=1.0)
    bbox = bbox_from_intrinsics_in_out(K, K_out, resolution)
    return crop_image_depthmap(image, depthmap, K, bbox)
