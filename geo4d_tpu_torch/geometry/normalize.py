"""The bbox2 geometry normalisation of training targets, its inference
inverses and the sky/far masks, port of geo4d_tpu/geometry/normalize.py."""

from __future__ import annotations

import torch


def _quantile_bounds(values: torch.Tensor, valid: torch.Tensor, lower_ratio: float,
                     upper_ratio: float):
    """The entries of the sorted valid values at the indices
    int(n_valid * ratio), the product taken in float32 and truncated, as
    the JAX package does (invalid entries sort last as +inf)."""
    big = torch.where(valid, values, torch.full_like(values, float("inf")))
    order = torch.sort(big.reshape(-1)).values
    n_valid = valid.sum().to(torch.float32)
    lo_idx = (n_valid * lower_ratio).to(torch.int32).long()
    hi_idx = (n_valid * upper_ratio).to(torch.int32).long()
    return order[lo_idx], order[torch.maximum(hi_idx, lo_idx)]


def normalize_pointcloud_bbox2(pts: torch.Tensor, valid: torch.Tensor, alpha: float = 2.0,
                               beta: float = 2.0, lower_ratio: float = 0.02,
                               upper_ratio: float = 0.98, clamp: float = 2.0,
                               return_st: bool = False):
    """z-quantile bbox normalisation of (T, H, W, 3) points with a (T, H, W)
    bool mask: z -> [-1, 1] between the quantiles (with a 0.01 margin), x and
    y divided by the same span s and gained by alpha / beta, invalid points
    set to 1.05, all clamped to +-clamp. With `return_st` also (s, t)."""
    lo, hi = _quantile_bounds(pts[..., 2], valid, lower_ratio, upper_ratio)
    t = lo - 0.01
    s = (hi + 0.01) - t
    out = torch.stack([pts[..., 0] / s * alpha, pts[..., 1] / s * beta,
                       ((pts[..., 2] - t) / s) * 2.0 - 1.0], dim=-1)
    out = torch.where(valid[..., None], out, torch.full_like(out, 1.05))
    out = torch.clamp(out, -clamp, clamp)
    return (out, s, t) if return_st else out


def normalize_inverse_depth_bbox2(depth: torch.Tensor, valid: torch.Tensor,
                                  lower_ratio: float = 0.02, upper_ratio: float = 0.98,
                                  clamp: float = 1.1, return_st: bool = False):
    """Disparity of (T, H, W) metric depth, quantile-normalised to [-1, 1];
    invalid pixels -1.05; clamped to +-clamp. With `return_st` also (s, t)."""
    disp = 1.0 / (depth + 1e-8)
    lo, hi = _quantile_bounds(disp, valid, lower_ratio, upper_ratio)
    t = lo - 0.01
    s = (hi + 0.01) - t
    out = ((disp - t) / s) * 2.0 - 1.0
    out = torch.where(valid, out, torch.full_like(out, -1.05))
    out = torch.clamp(out, -clamp, clamp)
    return (out, s, t) if return_st else out


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
