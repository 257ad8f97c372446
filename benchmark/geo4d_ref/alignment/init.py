"""Initialisation of the group aligner from the window predictions, port of
geo4d_tpu/alignment/init.py, the device-resident path that `reconstruct`
takes (`_init_from_group_device` with `_init_gather_dev` and
`_init_write_dev`):

 1. MoGe focal recovery on every window's FIRST frame, all windows at once
    (64 x 64 nearest downsample, z shifted positive), with outliers clamped
    to the mean;
 2. window 0 defines the world frame; every later window is sim3-registered
    (weighted Umeyama) onto the frames already placed, in window order;
 3. RANSAC-PnP with a focal sweep for all N frames in one batched call on a
    seeded pixel subsample of the final placements, each frame warm-started
    from its window's MoGe focal; a frame whose PnP fails keeps the
    identity pose (the reference's semantics), and the failures are counted;
 4. per-window sim3 poses onto the final placements, the global scale
    normalisation, depth maps from the placed points with the sky fill, and
    the codec writes into the aligner's parameters.

The predictions stay on their device; only (G,) focal values, the (N, p)
subsample mask and the (N,) PnP results cross to the host. The port's host
chain for numpy inputs and its initialisation from known cameras are left
out of this copy.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from geo4d_ref.alignment.optimizer import GroupAligner
from geo4d_ref.core.timing import stage
from geo4d_ref.geometry.moge import point_map_to_depth
from geo4d_ref.geometry.pnp import fast_pnp_points_batched
from geo4d_ref.geometry.se3 import pose_to_params, umeyama_sim3
from geo4d_ref.geometry.utils import inv_se3

MOGE_SIZE = 64
PNP_SUBSAMPLE = 4 * 4096


def pnp_subsample(P: int) -> np.ndarray:
    """The seeded pixel subsample PnP sees (the JAX package's selection)."""
    return np.random.default_rng(0).choice(P, size=min(PNP_SUBSAMPLE, P), replace=False)


def _init_gather(pred_flat: torch.Tensor, conf_flat: torch.Tensor, groups: np.ndarray,
                 sel: torch.Tensor, H: int, W: int, N: int):
    """Everything before PnP. pred_flat (G, S, P, 3), conf_flat (G, S, P).
    Returns (fov_x, fov_y, sub, sub_mask, s_all, R_all, t_all, pts_acc,
    conf_acc) as tensors on the predictions' device."""
    G, S, P, _ = pred_flat.shape
    dev = pred_flat.device
    d = MOGE_SIZE
    ref_pts = pred_flat[:, 0].reshape(G, H, W, 3)
    conf0 = conf_flat[:, 0].reshape(G, H, W)
    yi = torch.arange(d, device=dev) * H // d
    xi = torch.arange(d, device=dev) * W // d
    pts_lr = ref_pts[:, yi][:, :, xi].clone()
    pts_lr[..., 2] += 1.0 - ref_pts[..., 2].min()
    mask_lr = conf0[:, yi][:, :, xi] > 0.5
    _, fov_x, fov_y, _ = point_map_to_depth(pts_lr, mask_lr, downsample_size=(d, d),
                                            image_size=(H, W))

    gidx = torch.as_tensor(groups, device=dev)
    pts_acc = torch.zeros(N, P, 3, device=dev)
    conf_acc = torch.zeros(N, P, device=dev)
    done = torch.zeros(N, device=dev)
    pts_acc[gidx[0]] = pred_flat[0]
    conf_acc[gidx[0]] = conf_flat[0]
    done[gidx[0]] = 1.0
    for g in range(1, G):
        idx = gidx[g]
        # frames not placed yet weigh zero in the registration
        w = conf_flat[g] * conf_acc[idx] * done[idx][:, None]
        s, R, t = umeyama_sim3(pred_flat[g].reshape(-1, 3), pts_acc[idx].reshape(-1, 3),
                               w.reshape(-1))
        pts_acc[idx] = s * pred_flat[g] @ R.T + t
        conf_acc[idx] = conf_flat[g]
        done[idx] = 1.0

    # PnP subsample; the clamp keeps an unbounded sim3 scale from producing
    # coordinates that fail every PnP hypothesis
    sub = torch.clamp(pts_acc[:, sel], -6e4, 6e4)
    sub_mask = conf_acc[:, sel] > 0.5
    placed = pts_acc[gidx].reshape(G, S * P, 3)
    w_all = (conf_flat * conf_acc[gidx]).reshape(G, S * P)
    s_all, R_all, t_all = umeyama_sim3(pred_flat.reshape(G, S * P, 3), placed, w_all)
    return fov_x, fov_y, sub, sub_mask, s_all, R_all, t_all, pts_acc, conf_acc


def _clamped_focals(fov_x: np.ndarray, fov_y: np.ndarray, H: int, W: int,
                    outlier_rel_err: float = 0.6) -> np.ndarray:
    """Pixel focal of each window from MoGe's fields of view, averaged over
    the axes; focals more than `outlier_rel_err` off the mean of those above
    30 px take that mean."""
    focal = (0.5 / np.tan(fov_x / 2) * W + 0.5 / np.tan(fov_y / 2) * H) / 2
    good = focal > 30
    mean_focal = focal[good].mean() if good.any() else float(max(H, W))
    rel_err = np.abs(focal - mean_focal) / (mean_focal + 1e-12)
    return np.where(rel_err > outlier_rel_err, mean_focal, focal)


@torch.no_grad()
def init_from_group(aligner: GroupAligner, pred_pts, conf, niter_pnp: int = 10,
                    verbose: bool = False, timer=None) -> int:
    """Initialise `aligner.params` in place from the window predictions
    pred_pts (G, S, H, W, 3) and conf (G, S, H, W), tensors on the aligner's
    device. Returns the number of frames whose PnP failed (they keep the
    identity pose)."""
    failures = _init_from_group_device(aligner, pred_pts, conf, niter_pnp, verbose, timer)
    aligner.pnp_failures = failures
    if verbose:
        print(f"[init] loss = {float(aligner.loss_fn(aligner.params, False)):.5f}")
    return failures


def _init_from_group_device(aligner: GroupAligner, pred_pts, conf, niter_pnp: int,
                            verbose: bool, timer) -> int:
    cfg = aligner.cfg
    groups = aligner.groups
    G, S = groups.shape
    H, W, N, P = aligner.H, aligner.W, aligner.N, aligner.P
    dev = aligner.device

    with stage(timer, "align_init"):
        pred_flat = torch.as_tensor(pred_pts, dtype=torch.float32, device=dev).reshape(G, S, P, 3)
        conf_flat = torch.as_tensor(conf, dtype=torch.float32, device=dev).reshape(G, S, P)
        sel_np = pnp_subsample(P)
        sel = torch.as_tensor(sel_np, device=dev)
        (fov_x, fov_y, sub, sub_mask, s_all, R_all, t_all, pts_acc,
         conf_acc) = _init_gather(pred_flat, conf_flat, groups, sel, H, W, N)
        focal_group = _clamped_focals(fov_x.cpu().numpy(), fov_y.cpu().numpy(), H, W)

    with stage(timer, "align_pnp"):
        # warm start: each frame takes the focal of the nearest window that
        # starts at or before it
        window_start = {int(groups[g, 0]): g for g in range(G)}
        warm: List[Optional[float]] = []
        cur = None
        for i in range(N):
            if i in window_start:
                cur = float(focal_group[window_start[i]])
            warm.append(cur)
        pix = np.stack([sel_np % W, sel_np // W], -1).astype(np.float64)
        pnp_f, pnp_c2w, pnp_ok = fast_pnp_points_batched(
            sub, pix, sub_mask, (W, H), focals=warm, niter=niter_pnp)
        failures = int((~pnp_ok).sum())
        if failures and verbose:
            print(f"[init] PnP failed for frames {np.flatnonzero(~pnp_ok).tolist()}; "
                  "identity pose")
        im_poses = np.where(pnp_ok[:, None, None], pnp_c2w, np.eye(4))

    with stage(timer, "align_init"):
        s_np = np.clip(s_all.cpu().numpy(), 1e-6, 1e6)
        s_factor = float(np.exp(np.log(cfg.base_scale) - np.mean(np.log(s_np))))
        if not np.isfinite(s_factor):
            s_factor = 1.0
        im_poses[:, :3, 3] *= s_factor
        poses_c2w = torch.as_tensor(im_poses, dtype=torch.float32, device=dev)

        # depth maps from the scaled placements, sky (conf ~0) at frame 0's
        # farthest depth
        w2c = inv_se3(poses_c2w)
        cam = (pts_acc * s_factor) @ w2c[:, :3, :3].transpose(-1, -2) + w2c[:, None, :3, 3]
        depth = cam[..., 2]
        depth = torch.where(conf_acc < 1e-4, depth[0].max(), depth)
        depth = torch.nan_to_num(depth, nan=1.0, posinf=1e4, neginf=1e-6)
        p = aligner.params
        p["log_depth"].copy_(torch.log(torch.clamp(depth, 1e-6, 1e6)))
        p["poses"].copy_(pose_to_params(poses_c2w))
        T = torch.eye(4, device=dev).repeat(G, 1, 1)
        T[:, :3, :3] = R_all
        T[:, :3, 3] = t_all
        s_clip = torch.as_tensor(s_np, dtype=torch.float32, device=dev)
        p["pw_poses"].copy_(torch.cat([pose_to_params(T), torch.log(s_clip)[:, None]], -1))
        if cfg.shared_focal:
            vals = pnp_f[pnp_ok]
            mean_f = float(np.mean(vals)) if vals.size else float(max(H, W))
            p["focal"].copy_(torch.tensor([cfg.focal_break * np.log(mean_f)]))
        else:
            f = np.where(pnp_ok, pnp_f, focal_group[0]).astype(np.float32)
            p["focal"].copy_(torch.from_numpy(cfg.focal_break * np.log(f)))
    return failures
