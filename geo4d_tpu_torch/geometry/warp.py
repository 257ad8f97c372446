"""Depth-based warping, rigid flow and occlusion masks, port of
geo4d_tpu/geometry/warp.py (the reference's goem_opt.py DepthBasedWarping,
OccMask and WarpImage), batched over leading axes (frame pairs): every
function takes (..., H, W, ...) maps with matching leading axes.

They feed the aligner's optional rigid-flow term and the dynamic masks of
data/preprocess.py.
"""

from __future__ import annotations

from typing import Tuple

import torch

from geo4d_tpu_torch.geometry.utils import depthmap_to_pts3d, inv_se3, xy_grid


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample img (..., H, W, C) at float pixel coordinates (..., h, w, 2)
    in (x, y) order, clamped to the image: (..., h, w, C)."""
    h, w = img.shape[-3:-1]
    x = coords[..., 0].clamp(0.0, w - 1.0)
    y = coords[..., 1].clamp(0.0, h - 1.0)
    x0, y0 = x.floor(), y.floor()
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    lead = img.shape[:-3]
    flat = img.reshape(*lead, h * w, img.shape[-1])

    def at(yi, xi):
        idx = (yi * w + xi).reshape(*lead, -1, 1).expand(*lead, -1, img.shape[-1])
        return torch.gather(flat, -2, idx).reshape(*coords.shape[:-1], img.shape[-1])

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
            + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)


def warp_image(img_src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp src (..., H, W, C) by flow (..., H, W, 2):
    out(p) = src(p + flow(p))."""
    h, w = img_src.shape[-3:-1]
    return bilinear_sample(img_src, xy_grid(w, h, flow.device, flow.dtype) + flow)


def depth_based_flow(depth_src: torch.Tensor, pose_src: torch.Tensor, pose_dst: torch.Tensor,
                     K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid flow src -> dst of depth (..., H, W) under the cameras' motion
    (c2w poses (..., 4, 4)) with intrinsics K (3, 3) or (..., 3, 3).
    Returns (flow (..., H, W, 2), valid (..., H, W): in front of dst)."""
    h, w = depth_src.shape[-2:]
    pts_cam = depthmap_to_pts3d(depth_src, K)                            # (..., H, W, 3)
    rel = inv_se3(pose_dst) @ pose_src                                  # src cam -> dst cam
    pts = (torch.einsum("...ij,...hwj->...hwi", rel[..., :3, :3], pts_cam)
           + rel[..., None, None, :3, 3])
    z = pts[..., 2]
    valid = z > 1e-4
    z_safe = torch.where(valid, z, torch.ones_like(z))
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    uv = torch.stack([fx * pts[..., 0] / z_safe + cx, fy * pts[..., 1] / z_safe + cy], dim=-1)
    return uv - xy_grid(w, h, depth_src.device, depth_src.dtype), valid


def occlusion_mask(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor, alpha: float = 0.01,
                   beta: float = 0.5) -> torch.Tensor:
    """Forward-backward consistency of flows (..., H, W, 2): True (not
    occluded) where |f_fwd(p) + f_bwd(p + f_fwd(p))|^2 is below
    alpha (|f_fwd(p)|^2 + |f_bwd(p + f_fwd(p))|^2) + beta."""
    h, w = flow_fwd.shape[-3:-1]
    bwd_at_fwd = bilinear_sample(flow_bwd, xy_grid(w, h, flow_fwd.device, flow_fwd.dtype)
                                 + flow_fwd)
    diff = ((flow_fwd + bwd_at_fwd) ** 2).sum(-1)
    bound = alpha * ((flow_fwd ** 2).sum(-1) + (bwd_at_fwd ** 2).sum(-1)) + beta
    return diff < bound


def flow_error_sums(depths: torch.Tensor, poses: torch.Tensor, K: torch.Tensor,
                    target_flows: torch.Tensor, masks: torch.Tensor, fn: str = "l1"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per consecutive pair (i, i + 1) of depths (N, H, W) and c2w poses
    (N, 4, 4): the sum of the rigid flow's error to target_flows
    (N - 1, H, W, 2), L1 or squared L2 over its two components, weighted by
    masks (N - 1, H, W) and the dst-visibility; and the sum of those
    weights. Returns two (N - 1,) tensors."""
    flow, valid = depth_based_flow(depths[:-1], poses[:-1], poses[1:], K)
    err = flow - target_flows
    e = err.abs().sum(-1) if fn == "l1" else (err ** 2).sum(-1)
    wgt = masks * valid
    return (e * wgt).sum((-2, -1)), wgt.sum((-2, -1))


def flow_loss(depths: torch.Tensor, poses: torch.Tensor, K: torch.Tensor,
              target_flows: torch.Tensor, masks: torch.Tensor, fn: str = "l1") -> torch.Tensor:
    """Consecutive-frame rigid-flow consistency: the mean over pairs of each
    pair's weighted mean error (see `flow_error_sums`)."""
    num, den = flow_error_sums(depths, poses, K, target_flows, masks, fn)
    return (num / (den + 1e-8)).mean()
