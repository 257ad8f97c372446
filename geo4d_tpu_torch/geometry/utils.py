"""Basic projective geometry, port of geo4d_tpu/geometry/utils.py: pixel
grids, transforms, unprojection, pinhole intrinsics."""

from __future__ import annotations

import torch


def xy_grid(width: int, height: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Pixel grid (H, W, 2) with (x, y) ordering."""
    y, x = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                          torch.arange(width, dtype=dtype, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def geotrf(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) or (..., H, W, 3) points
    (the point array's leading axes match T's)."""
    flat = pts.reshape(*T.shape[:-2], -1, 3)
    out = torch.einsum("...ij,...nj->...ni", T[..., :3, :3], flat) + T[..., None, :3, 3]
    return out.reshape(pts.shape)


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Invert rigid or similarity (..., 4, 4) transforms (general inverse of
    the 3x3 block)."""
    Rinv = torch.linalg.inv_ex(T[..., :3, :3])[0]
    tinv = -(Rinv @ T[..., :3, 3:4])
    bottom = torch.zeros_like(T[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([Rinv, tinv], dim=-1), bottom], dim=-2)


def depthmap_to_pts3d(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Unproject depth (..., H, W) with intrinsics (..., 3, 3) to camera-frame
    points (..., H, W, 3): ((x - cx) / fx * z, (y - cy) / fy * z, z)."""
    h, w = depth.shape[-2:]
    grid = xy_grid(w, h, device=depth.device, dtype=depth.dtype)
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    x = (grid[..., 0] - cx) / fx * depth
    y = (grid[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def make_intrinsics(focal, cx, cy) -> torch.Tensor:
    """(..., 3, 3) pinhole K from a focal (...) and a principal point."""
    focal = torch.as_tensor(focal, dtype=torch.float32)
    z, o = torch.zeros_like(focal), torch.ones_like(focal)
    cx = torch.broadcast_to(torch.as_tensor(cx, dtype=torch.float32, device=focal.device), focal.shape)
    cy = torch.broadcast_to(torch.as_tensor(cy, dtype=torch.float32, device=focal.device), focal.shape)
    return torch.stack([focal, z, cx, z, focal, cy, z, z, o], dim=-1).reshape(*focal.shape, 3, 3)
