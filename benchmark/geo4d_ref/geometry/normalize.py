"""The inference inverses of the bbox2 geometry normalisation and the
sky/far masks, port of geo4d_tpu/geometry/normalize.py."""

from __future__ import annotations

import torch


def denormalize_pointcloud_bbox2(pts: torch.Tensor, alpha: float = 2.0,
                                 beta: float = 2.0) -> torch.Tensor:
    """x / alpha, y / beta, z = (z + 1) / 2; scale and shift stay undone (the
    aligner recovers absolute scale)."""
    return torch.stack([pts[..., 0] / alpha, pts[..., 1] / beta,
                        (pts[..., 2] + 1.0) / 2.0], dim=-1)


def denormalize_inverse_depth(norm_disp: torch.Tensor) -> torch.Tensor:
    """[-1, 1] net output -> [0, 1] relative disparity."""
    return (norm_disp + 1.0) / 2.0


def sky_mask(pts: torch.Tensor, sky_value: float = 1.05, eps: float = 0.35) -> torch.Tensor:
    """All three channels within sky_value +- eps (the invalid/sky sentinel)."""
    return torch.all(torch.abs(pts - sky_value) < eps, dim=-1)


def far_mask(pts: torch.Tensor, far_value: float = 1.99) -> torch.Tensor:
    """Any channel beyond the normalised range."""
    return torch.any(torch.abs(pts) > far_value, dim=-1)
