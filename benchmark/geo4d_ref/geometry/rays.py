"""Plücker ray maps -> camera poses, port of cameras_from_plucker and its
helpers in geo4d_tpu/geometry/rays.py, batched over frames."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from geo4d_ref.geometry.se3 import procrustes_rotation


def _normalize(d: torch.Tensor) -> torch.Tensor:
    return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)


def plucker_origins(dirs: torch.Tensor, moments: torch.Tensor) -> torch.Tensor:
    """Closest-to-origin point of each ray: o = d x m, with d normalised and m
    rescaled by 1 / |d_raw|."""
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12
    return torch.linalg.cross(dirs / norm, moments / norm, dim=-1)


def intersect_skew_lines(origins: torch.Tensor, dirs: torch.Tensor,
                         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Least-squares intersection of each batch's rays: solve
    (sum w (I - d d^T)) c = sum w (I - d d^T) o. origins/dirs: (..., N, 3);
    weights (..., N), 1 by default."""
    d = _normalize(dirs)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    proj = eye - d[..., :, None] * d[..., None, :]                    # (..., N, 3, 3)
    if weights is not None:
        proj = proj * weights[..., None, None]
    A = proj.sum(dim=-3)
    b = (proj @ origins[..., None]).squeeze(-1).sum(dim=-2)
    return torch.linalg.solve(A + 1e-8 * eye, b)


def _center_crop_square(x: torch.Tensor) -> torch.Tensor:
    """(T, H, W, C) -> (T, S, S, C), S = min(H, W), centred."""
    _, h, w, _ = x.shape
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return x[:, top:top + s, left:left + s, :]


def cameras_from_plucker(raydirs: torch.Tensor, moments: torch.Tensor,
                         ref_raydirs: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, H, W, 3) ray-direction and moment maps -> (poses (T, 4, 4),
    centres (T, 3)): centres from the rays' least-squares intersection,
    rotations by Procrustes of a reference ray grid onto each frame's
    (frame 0's, or `ref_raydirs`, already cropped to the square)."""
    raydirs = _center_crop_square(raydirs)
    moments = _center_crop_square(moments)
    t = raydirs.shape[0]
    d = _normalize(raydirs.reshape(t, -1, 3))
    m = moments.reshape(t, -1, 3)
    centers = intersect_skew_lines(plucker_origins(d, m), d)              # (T, 3)
    ref = d[0] if ref_raydirs is None else ref_raydirs.reshape(-1, 3)
    R = procrustes_rotation(_normalize(ref)[None], d)                     # (T, 3, 3)
    poses = torch.eye(4, dtype=d.dtype, device=d.device).repeat(t, 1, 1)
    poses[:, :3, :3] = R
    poses[:, :3, 3] = centers
    return poses, centers
