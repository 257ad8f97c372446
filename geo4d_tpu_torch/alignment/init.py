"""Initialisation of the group aligner from the window predictions, port of
geo4d_tpu/alignment/init.py. Tensors take the device-resident path
(`_init_from_group_device` with `_init_gather_dev` and `_init_write_dev`):

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
subsample mask and the (N,) PnP results cross to the host.

Numpy inputs take the JAX package's host chain (`init_from_group`'s numpy
branch, the reference's `align_group_prefix` order), on the aligner's
device: window by window, each later window sim3-registered (float64) on
its overlap with the frames placed so far, its frames then overwrite their
placements, and every frame of the window gets a dense PnP on all its
masked pixels, warm-started from the previous frame's PnP focal; the
window sim3 poses are fitted on the final placements.

`init_from_known_poses` is the JAX package's initialisation from known
cameras (the reference's init='known_poses').
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from geo4d_tpu_torch.alignment.optimizer import GroupAligner
from geo4d_tpu_torch.core.timing import count, stage
from geo4d_tpu_torch.geometry.moge import point_map_to_depth
from geo4d_tpu_torch.geometry.pnp import fast_pnp, fast_pnp_points_batched
from geo4d_tpu_torch.geometry.se3 import pose_to_params, umeyama_sim3
from geo4d_tpu_torch.geometry.utils import inv_se3

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
    pred_pts (G, S, H, W, 3) and conf (G, S, H, W), on the aligner's device:
    tensors through the device-resident path, numpy arrays through the host
    chain. Returns the number of frames whose PnP failed (they keep the
    identity pose); counters "pnp_frames" and "pnp_failed" (`core.timing`)
    add the frames and those failures."""
    if isinstance(pred_pts, torch.Tensor):
        failures = _init_from_group_device(aligner, pred_pts, conf, niter_pnp, verbose, timer)
    else:
        failures = _init_from_group_host(aligner, pred_pts, conf, niter_pnp, verbose, timer)
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
        count("pnp_frames", N)
        count("pnp_failed", failures)
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


def recover_group_focals(ref_pointmaps: torch.Tensor, ref_conf: torch.Tensor,
                         outlier_rel_err: float = 0.6) -> np.ndarray:
    """MoGe focal (pixels, float64) of each window from its first frame's
    point map (G, H, W, 3) and confidence (G, H, W): z shifted positive over
    all windows, the 64 x 64 nearest downsample, pixels of confidence above
    0.5, focals more than `outlier_rel_err` off the mean clamped to it."""
    g, h, w, _ = ref_pointmaps.shape
    pts = ref_pointmaps.clone()
    pts[..., 2] = pts[..., 2] - pts[..., 2].min() + 1.0
    d = MOGE_SIZE
    yi = torch.arange(d, device=pts.device) * h // d
    xi = torch.arange(d, device=pts.device) * w // d
    _, fov_x, fov_y, _ = point_map_to_depth(pts[:, yi][:, :, xi], (ref_conf > 0.5)[:, yi][:, :, xi],
                                            downsample_size=(d, d), image_size=(h, w))
    return _clamped_focals(fov_x.cpu().numpy(), fov_y.cpu().numpy(), h, w,
                           outlier_rel_err).astype(np.float64)


def _sim3_f64(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Weighted Umeyama of (M, 3) point sets, in float64."""
    return umeyama_sim3(src.double(), dst.double(), w.double())


def _init_from_group_host(aligner: GroupAligner, pred_pts, conf, niter_pnp: int,
                          verbose: bool, timer) -> int:
    cfg = aligner.cfg
    groups = aligner.groups
    G, S = groups.shape
    H, W, N = aligner.H, aligner.W, aligner.N
    dev = aligner.device
    pred = torch.as_tensor(np.asarray(pred_pts), dtype=torch.float32, device=dev)
    cf = torch.as_tensor(np.asarray(conf), dtype=torch.float32, device=dev)
    pred, cf = pred.reshape(G, S, H, W, 3), cf.reshape(G, S, H, W)

    with stage(timer, "align_init"):
        focal_group = recover_group_focals(pred[:, 0], cf[:, 0])
    pts3d: List[Optional[torch.Tensor]] = [None] * N          # (H, W, 3) world placements
    conf_list: List[Optional[torch.Tensor]] = [None] * N
    im_poses: List[Optional[np.ndarray]] = [None] * N
    im_focals: List[Optional[float]] = [None] * N
    failed = set()

    def pnp_frame(i: int, warm: Optional[float]):
        with stage(timer, "align_pnp"):
            res = fast_pnp(pts3d[i], conf_list[i] > 0.5, focal=warm, niter=niter_pnp)
        if res is not None:
            im_focals[i], im_poses[i] = res
            failed.discard(i)
        elif im_poses[i] is None:             # no earlier visit placed it either
            im_poses[i] = np.eye(4)
            failed.add(i)

    for s_idx, i in enumerate(groups[0]):      # window 0 defines the world frame
        pts3d[i], conf_list[i] = pred[0, s_idx], cf[0, s_idx]
        if s_idx == 0:
            im_focals[i] = focal_group[0]
        pnp_frame(i, im_focals[i - 1] if i > 0 else im_focals[i])
    placed = set(int(i) for i in groups[0])
    for g in range(1, G):
        with stage(timer, "align_init"):
            overlap = [(s_idx, i) for s_idx, i in enumerate(groups[g]) if int(i) in placed]
            if not overlap:
                raise ValueError(f"window {g} shares no frame with the windows before it "
                                 "(the stride must be below the window size)")
            s, R, t = _sim3_f64(
                torch.cat([pred[g, s_idx].reshape(-1, 3) for s_idx, _ in overlap]),
                torch.cat([pts3d[i].reshape(-1, 3) for _, i in overlap]),
                torch.cat([(cf[g, s_idx] * conf_list[i]).reshape(-1) for s_idx, i in overlap]))
            s, R, t = s.float(), R.float(), t.float()
        for s_idx, i in enumerate(groups[g]):
            # later windows overwrite: frames near a window's start are taken
            # as the better placed
            pts3d[i] = (s * pred[g, s_idx]).reshape(-1, 3) @ R.T + t
            pts3d[i] = pts3d[i].reshape(H, W, 3)
            conf_list[i] = cf[g, s_idx]
            placed.add(int(i))
            pnp_frame(i, focal_group[g] if s_idx == 0 else im_focals[i - 1])
    count("pnp_frames", N)
    count("pnp_failed", len(failed))
    if verbose and failed:
        print(f"[init] PnP failed for frames {sorted(failed)}; identity pose")

    with stage(timer, "align_init"):
        # window sim3 poses onto the final placements
        fits = [_sim3_f64(pred[g].reshape(-1, 3),
                          torch.stack([pts3d[i] for i in groups[g]]).reshape(-1, 3),
                          torch.stack([cf[g, s_idx] * conf_list[i]
                                       for s_idx, i in enumerate(groups[g])]).reshape(-1))
                for g in range(G)]
        pw_s = torch.stack([f[0] for f in fits])
        T = torch.eye(4, dtype=torch.float64, device=dev).repeat(G, 1, 1)
        T[:, :3, :3] = torch.stack([f[1] for f in fits])
        T[:, :3, 3] = torch.stack([f[2] for f in fits])
        p = aligner.params
        p["pw_poses"].copy_(torch.cat([pose_to_params(T.float()),
                                       torch.log(pw_s.clamp(min=1e-8)).float()[:, None]], -1))

        # global scale normalisation: the mean log window scale -> base_scale
        scales = np.clip(pw_s.cpu().numpy(), 1e-6, 1e6)
        s_factor = float(np.exp(np.log(cfg.base_scale) - np.mean(np.log(scales))))
        if not np.isfinite(s_factor):
            s_factor = 1.0
        c2w = np.stack(im_poses)
        c2w[:, :3, 3] *= s_factor

        # depth of each placement in its camera; sky (conf ~0) at frame 0's
        # farthest depth
        R_w2c = np.transpose(c2w[:, :3, :3], (0, 2, 1))
        w2c = torch.as_tensor(np.concatenate([R_w2c, -R_w2c @ c2w[:, :3, 3:]], -1), device=dev)
        depth = torch.stack([(pts3d[i].reshape(-1, 3) * s_factor).double() @ w2c[i, :, :3].T
                             + w2c[i, :, 3] for i in range(N)])[..., 2]
        sky = torch.stack([c.reshape(-1) for c in conf_list]) < 1e-4
        depth = torch.where(sky, depth[0].max(), depth).float()
        depth = torch.nan_to_num(depth, nan=1.0, posinf=1e4, neginf=1e-6)
        p["log_depth"].copy_(torch.log(torch.clamp(depth, 1e-6, 1e6)))
        p["poses"].copy_(pose_to_params(torch.as_tensor(c2w, dtype=torch.float32, device=dev)))
        if cfg.shared_focal:
            vals = [f for f in im_focals if f is not None]
            mean_f = float(np.mean(vals)) if vals else float(max(H, W))
            p["focal"].copy_(torch.tensor([cfg.focal_break * np.log(mean_f)]))
        else:
            f = np.asarray([fv if fv is not None else focal_group[0] for fv in im_focals],
                           np.float32)
            p["focal"].copy_(torch.from_numpy(cfg.focal_break * np.log(f)))
    return len(failed)


@torch.no_grad()
def init_from_known_poses(aligner: GroupAligner, poses_c2w, focals, pred_pts) -> None:
    """Initialise `aligner.params` in place from known cameras: the focal(s)
    preset and frozen, every frame's pose set from poses_c2w (N, 4, 4), each
    window placed by its first frame's camera at scale 1, and each frame's
    depth the z of the window prediction pred_pts (G, S, H, W, 3) that
    first covers it (clipped to 1e-4). The JAX package passes the window
    confidences too, and uses them nowhere."""
    groups = aligner.groups
    G, dev = aligner.G, aligner.device
    aligner.preset_focal(np.atleast_1d(focals), requires_grad=False)
    poses = torch.as_tensor(np.asarray(poses_c2w, np.float32), device=dev)
    first = poses[torch.as_tensor(groups[:, 0], device=dev)]
    T = torch.eye(4, device=dev).repeat(G, 1, 1)
    T[:, :3] = first[:, :3]
    p = aligner.params
    p["poses"].copy_(pose_to_params(poses))
    p["pw_poses"].copy_(torch.cat([pose_to_params(T), torch.zeros(G, 1, device=dev)], -1))

    # the (window, slot) where each frame first appears, in window order
    seen = {}
    for g in range(G):
        for s, i in enumerate(groups[g]):
            seen.setdefault(int(i), (g, s))
    z = torch.as_tensor(pred_pts, dtype=torch.float32, device=dev)[..., 2]
    depth = torch.ones(aligner.N, aligner.P, device=dev)
    for i, (g, s) in seen.items():
        depth[i] = torch.clamp(z[g, s].reshape(-1), min=1e-4)
    depth = torch.nan_to_num(depth, nan=1.0, posinf=1e4, neginf=1e-6)
    p["log_depth"].copy_(torch.log(torch.clamp(depth, 1e-6, 1e6)))
