"""Group global-alignment optimizer, port of
geo4d_tpu/alignment/optimizer.py: fuses the sliding-window predictions into
one scene and one camera trajectory. The benchmark's copy keeps what
`align_predictions` runs: no optical-flow term (it takes no flows), no
preset focal, no confidence or clean-up outputs.

Parameters (optimized jointly; `params` maps these names to tensors):
  log_depth   (N, P)   per-frame log depth maps
  poses       (N, 7)   per-frame c2w [quat xyzw | signed-log1p t]
  pw_poses    (G, 8)   per-window sim3 [quat | slog1p t | log s]
  traj_align  (G, 8)   per-window SE3(+s) aligning diffusion trajs to poses
  focal       (1 or N,) log-coded: f = exp(p / focal_break)
  s_depth, t_depth (G,) per-window disparity scale/shift (set by calibrate)

Loss = conf-weighted L1 point-map consistency
     + 2 x inverse-depth consistency to the diffusion disparity (phase 2)
     + 0.005 x trajectory loss to the diffusion cameras (phase 2)
     + temporal pose smoothness
     (+ the optional si-log depth pull).

Two phases of Adam (b1 = b2 = 0.9, eps 1e-8 outside the square root, a
linear or cosine learning-rate schedule), with the iteration-150
calibration between them. One optimizer carries its moments and step count
from phase 1 into phase 2, so `calibrate` writes its values into the
existing parameter tensors in place. Layout: plain (N, P, 3) point tensors
and index gathers, all on the device of the predictions.

With `record_states` set, `run` keeps copies of three states (`state()`:
the parameters and the two phase-2 gates) in `states`: "init" before the
first iteration, "calibrated" right after the calibration, "end" after the
last iteration. Copying leaves the arithmetic as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from geo4d_ref.core.device import default_device
from geo4d_ref.core.timing import stage
from geo4d_ref.evals.depth import lad_align_irls
from geo4d_ref.evals.trajectory import Trajectory, align_trajectory_with_eval
from geo4d_ref.geometry.se3 import params_to_pose, pose_to_params
from geo4d_ref.geometry.utils import inv_se3

PARAM_NAMES = ("log_depth", "poses", "pw_poses", "traj_align", "focal", "s_depth", "t_depth")


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    """The JAX package's AlignerConfig, same fields and defaults, less its
    two XLA compile-reuse buckets (eager PyTorch compiles nothing)."""

    n_iter: int = 500
    lr: float = 0.03
    lr_min: float = 1e-3
    schedule: str = "linear"            # 'linear' | 'cosine'
    temporal_smoothing_weight: float = 0.015
    translation_weight: float = 1.0
    depth_traj_start_iter: int = 150
    depth_loss_weight: float = 2.0
    traj_loss_weight: float = 0.005
    conf_optimize: bool = True
    conf_clamp: float = 10.0
    shared_focal: bool = True
    focal_break: float = 20.0
    pw_break: float = 20.0
    base_scale: float = 0.5
    invdepth_valid_thr: float = 0.05
    weight_valid_thr: float = 0.5
    rpe_rot_valid_deg: float = 4.0
    delta_valid_thr: float = 0.3
    min_conf_thr: float = 3.0
    flow_loss_weight: float = 0.0
    flow_loss_fn: str = "l1"
    flow_loss_start_frac: float = 0.1
    motion_mask_thre: float = 0.35
    depth_regularize_weight: float = 0.0


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt((x * x).sum(dim) + 1e-12)


def _rel_pose_loss(RT1: torch.Tensor, RT2: torch.Tensor, translation_weight: float) -> torch.Tensor:
    """Frobenius(R_rel - I) + w * |t_rel| of rel = inv(RT1) @ RT2."""
    rel = inv_se3(RT1) @ RT2
    eye = torch.eye(3, dtype=rel.dtype, device=rel.device)
    rot = torch.sqrt(((rel[:, :3, :3] - eye) ** 2).sum((-2, -1)) + 1e-12)
    return rot + translation_weight * _safe_norm(rel[:, :3, 3])


def _lr_at(step: int, cfg: AlignerConfig) -> float:
    t = step / cfg.n_iter
    if cfg.schedule == "cosine":
        return cfg.lr_min + (cfg.lr - cfg.lr_min) * 0.5 * (1 + math.cos(math.pi * t))
    return cfg.lr + (cfg.lr_min - cfg.lr) * t


class GroupAligner:
    """Optimizer over stacked window predictions.

    Inputs (numpy arrays or tensors; G windows of S frames, P = H * W pixels):
      pred_pts (G, S, P, 3) or (G, S, H, W, 3)  window point maps
      weights  (G, S, P)    inverse-confidence weights (0 = invalid)
      invdepth (G, S, P)    diffusion inverse depth
      trajs    (G, S, 4, 4) diffusion cameras
      groups   (G, S) int   frame index of each window slot
    Everything lives on `device`: by default the device of `pred_pts` when
    it is a tensor, else the CUDA device (an error where there is none);
    pass device="cpu" to run on the CPU."""

    def __init__(self, groups, pred_pts, weights, imshape: Tuple[int, int], invdepth=None,
                 trajs=None, config: AlignerConfig = AlignerConfig(), device=None):
        self.cfg = config
        self.groups = np.asarray(groups, np.int64)
        self.G, self.S = self.groups.shape
        self.H, self.W = imshape
        self.P = self.H * self.W
        self.N = int(self.groups.max()) + 1
        if device is None:
            device = pred_pts.device if isinstance(pred_pts, torch.Tensor) else default_device()
        self.device = dev = torch.device(device)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        G, S, P = self.G, self.S, self.P
        self.buf: Dict[str, torch.Tensor] = {
            "pred_pts": f32(pred_pts).reshape(G, S, P, 3),
            "weights": f32(weights).reshape(G, S, P),
            "e_all": torch.as_tensor(self.groups.reshape(-1), device=dev),
        }
        self.has_depth = invdepth is not None
        self.has_traj = trajs is not None
        if self.has_depth:
            self.buf["invdepth"] = f32(invdepth).reshape(G, S, P)
        if self.has_traj:
            self.buf["trajs"] = f32(trajs).reshape(G, S, 4, 4)
        pix = torch.arange(P, device=dev)
        self.grid = torch.stack([pix % self.W, pix // self.W], -1).float()       # (P, 2)
        self.pp = torch.tensor([self.W / 2, self.H / 2], device=dev)
        self.total_area = float(G * S * P)

        gen = torch.Generator(device=dev).manual_seed(0)
        n_f = 1 if config.shared_focal else self.N
        ident = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
        self.params: Dict[str, torch.Tensor] = {
            # N(0, 0.1) - 3 as in the JAX package; init overwrites every row
            "log_depth": torch.randn(self.N, P, generator=gen, device=dev) / 10 - 3,
            "poses": f32(ident).repeat(self.N, 1),
            "pw_poses": f32(ident + [0.0]).repeat(G, 1),
            "traj_align": f32(ident + [0.0]).repeat(G, 1),
            "focal": torch.full((n_f,), config.focal_break * float(np.log(max(self.H, self.W))),
                                device=dev),
            "s_depth": torch.ones(G, device=dev),
            "t_depth": torch.zeros(G, device=dev),
        }
        # s/t are set by calibration, never by a gradient. Only leaves that
        # require grad are optimized.
        for k, p in self.params.items():
            p.requires_grad_(k not in ("s_depth", "t_depth"))
        self.pnp_failures = 0               # frames left at the identity pose by init
        self.final_loss: Optional[float] = None   # set by run()
        # phase-2 window gates (set by calibrate)
        self.valid_depth_group = torch.ones(G, device=dev)
        self.valid_traj_group = torch.zeros(G, device=dev)
        self._log_depth_init: Optional[torch.Tensor] = None
        self.record_states = False
        self.states: Dict[str, dict] = {}

    def state(self) -> dict:
        """Copies of the parameters and the two phase-2 gates."""
        return {"params": {k: p.detach().clone() for k, p in self.params.items()},
                "valid_depth_group": self.valid_depth_group.clone(),
                "valid_traj_group": self.valid_traj_group.clone()}

    def _record(self, name: str):
        if self.record_states:
            self.states[name] = self.state()

    # ---------------- derived quantities ----------------

    def _focals(self, params) -> torch.Tensor:
        f = torch.exp(params["focal"] / self.cfg.focal_break)
        return f.expand(self.N) if self.cfg.shared_focal else f

    def _pw_scale(self, params) -> torch.Tensor:
        logs = params["pw_poses"][:, 7]
        return torch.exp(logs) * torch.exp(math.log(self.cfg.base_scale) - logs.mean())

    def _pts3d_world(self, params) -> torch.Tensor:
        """(N, P, 3) world points: unproject each depth map, then pose it."""
        depth = torch.exp(params["log_depth"])
        f = self._focals(params)
        rel_xy = depth[..., None] * (self.grid - self.pp) / f[:, None, None]
        rel = torch.cat([rel_xy, depth[..., None]], dim=-1)
        poses = params_to_pose(params["poses"])
        return rel @ poses[:, :3, :3].transpose(-1, -2) + poses[:, None, :3, 3]

    def loss_fn(self, params, use_depth_traj: bool) -> torch.Tensor:
        """The full objective at `params` (a dict like `self.params`)."""
        cfg, buf = self.cfg, self.buf
        G, S, P = self.G, self.S, self.P
        proj = self._pts3d_world(params)
        pw = params_to_pose(params["pw_poses"][:, :7])
        s = self._pw_scale(params)
        pw = torch.cat([pw[:, :3] * s[:, None, None], pw[:, 3:]], dim=1)     # sim3 (G, 4, 4)
        aligned = buf["pred_pts"] @ pw[:, None, :3, :3].transpose(-1, -2) + pw[:, None, None, :3, 3]
        w = torch.clamp(buf["weights"], max=cfg.conf_clamp) if cfg.conf_optimize else buf["weights"]
        proj_e = proj.index_select(0, buf["e_all"]).reshape(G, S, P, 3)
        d = proj_e - aligned
        loss = (torch.sqrt((d * d).sum(-1) + 1e-12) * w).sum() / self.total_area

        if use_depth_traj and self.has_depth:
            inv_pred = 1.0 / (torch.exp(params["log_depth"]) + 1e-6)
            inv_pred_e = inv_pred.index_select(0, buf["e_all"]).reshape(G, S, P)
            dmask = (buf["invdepth"] > cfg.invdepth_valid_thr).float()
            dmask = dmask * self.valid_depth_group[:, None, None]
            scaled = (buf["invdepth"] * params["s_depth"][:, None, None]
                      + params["t_depth"][:, None, None])
            loss = loss + ((inv_pred_e - scaled).abs() * dmask).sum() / self.total_area \
                * cfg.depth_loss_weight

        if use_depth_traj and self.has_traj:
            scale = torch.exp(params["traj_align"][:, 7])
            RT = params_to_pose(params["traj_align"][:, :7])
            traj = buf["trajs"]
            traj = torch.cat([traj[..., :3, :3], traj[..., :3, 3:] * scale[:, None, None, None]],
                             dim=-1)
            traj = torch.cat([traj, buf["trajs"][..., 3:, :]], dim=-2)
            moved = RT[:, None] @ traj
            poses_e = params_to_pose(params["poses"]).index_select(0, buf["e_all"])
            per = _rel_pose_loss(moved.reshape(-1, 4, 4), poses_e,
                                 cfg.translation_weight).reshape(G, S)
            loss = loss + (per * self.valid_traj_group[:, None]).sum() * cfg.traj_loss_weight

        if cfg.temporal_smoothing_weight > 0:
            poses = params_to_pose(params["poses"])
            loss = loss + cfg.temporal_smoothing_weight * _rel_pose_loss(
                poses[:-1], poses[1:], cfg.translation_weight).sum()

        if cfg.depth_regularize_weight > 0 and self._log_depth_init is not None:
            # scale-invariant log-depth pull to the init depth
            ld, ld0 = params["log_depth"], self._log_depth_init
            shift = (ld0 - ld).mean(-1, keepdim=True)
            loss = loss + cfg.depth_regularize_weight * ((ld - ld0 + shift) ** 2).mean(-1).mean()
        return loss

    # ---------------- optimization ----------------

    def run(self, verbose: bool = False, timer=None) -> float:
        """Two-phase optimization: [0, start) point maps only; calibration;
        [start, n_iter) with disparity and trajectory anchors. Returns the
        loss at the last iteration (before its update)."""
        cfg = self.cfg
        start = min(cfg.depth_traj_start_iter, cfg.n_iter)
        trainable = [self.params[k] for k in PARAM_NAMES if self.params[k].requires_grad]
        opt = torch.optim.Adam(trainable, lr=cfg.lr, betas=(0.9, 0.9), eps=1e-8,
                               fused=self.device.type == "cuda")
        if cfg.depth_regularize_weight > 0:
            self._log_depth_init = self.params["log_depth"].detach().clone()

        def phase(iters, use_depth_traj):
            losses = []
            for it in iters:
                loss = self.loss_fn(self.params, use_depth_traj)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                for p in trainable:
                    # a trainable leaf outside this phase's loss (traj_align
                    # in phase 1) still takes an Adam step with a zero
                    # gradient: optax counts steps globally
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                opt.param_groups[0]["lr"] = _lr_at(it, cfg)
                opt.step()
                losses.append(loss.detach())
            return losses

        self._record("init")
        with torch.enable_grad():
            with stage(timer, "align_phase1"):
                losses1 = phase(range(start), False)
            with stage(timer, "calibrate"):
                if self.has_depth or self.has_traj:
                    self.calibrate()
            self._record("calibrated")
            if verbose and losses1:
                print(f"[aligner] phase1 loss {float(losses1[-1]):.5f}")
            with stage(timer, "align_phase2"):
                losses2 = phase(range(start, cfg.n_iter), True)
        if losses2:
            final = float(losses2[-1])
        else:
            final = float(losses1[-1]) if start > 0 else 0.0
        if verbose:
            print(f"[aligner] final loss {final:.5f}")
        self.final_loss = final
        self._record("end")
        return final

    # ---------------- iteration-150 calibration ----------------

    @torch.no_grad()
    def calibrate(self):
        """Per-window disparity (s, t) by batched IRLS with the delta >= 0.3
        gate, and trajectory origin alignment with the rpe_rot < 4 deg gate.
        Values are written into the parameter tensors in place."""
        cfg, G = self.cfg, self.G
        if self.has_depth:
            inv_opt = 1.0 / (torch.exp(self.params["log_depth"]) + 1e-6)
            inv_opt_g = inv_opt.index_select(0, self.buf["e_all"]).reshape(G, -1)
            pred = self.buf["invdepth"].reshape(G, -1)
            mask = (self.buf["weights"].reshape(G, -1) > cfg.weight_valid_thr) & (
                pred > cfg.invdepth_valid_thr)
            s, t = lad_align_irls(pred, inv_opt_g, mask)
            al = torch.clamp(s[:, None] * pred + t[:, None], min=1e-8)
            b = torch.clamp(inv_opt_g, min=1e-8)
            hit = (torch.maximum(al / b, b / al) < 1.25) & mask
            delta = hit.sum(-1) / torch.clamp(mask.sum(-1), min=1)
            self.params["s_depth"].copy_(s)
            self.params["t_depth"].copy_(t)
            self.valid_depth_group = (delta >= cfg.delta_valid_thr).float()

        if self.has_traj:
            im_poses = self.get_im_poses()
            pw_scale = self._pw_scale(self.params).cpu().numpy()
            trajs = self.buf["trajs"].cpu().numpy()
            ta = self.params["traj_align"].cpu().numpy().copy()
            valid = np.zeros((G,), np.float32)
            for g in range(G):
                traj = trajs[g].copy()
                traj[:, :3, 3] *= pw_scale[g]
                est = Trajectory.from_matrices(traj)
                ref = Trajectory.from_matrices(im_poses[self.groups[g]])
                try:
                    _, _, rpe_rot, P, _ = align_trajectory_with_eval(est, ref)
                except np.linalg.LinAlgError:
                    continue
                ta[g, :7] = pose_to_params(torch.as_tensor(P, dtype=torch.float32)).numpy()
                ta[g, 7] = np.log(max(pw_scale[g], 1e-8))
                if rpe_rot < cfg.rpe_rot_valid_deg:
                    valid[g] = 1.0
            self.params["traj_align"].copy_(torch.from_numpy(ta))
            self.valid_traj_group = torch.from_numpy(valid).to(self.device)

    # ---------------- outputs (results-dir contract, numpy) ----------------

    def get_focals(self) -> np.ndarray:
        return self._focals(self.params).detach().cpu().numpy()

    def get_im_poses(self) -> np.ndarray:
        return params_to_pose(self.params["poses"]).detach().cpu().numpy()

    def get_depthmaps(self) -> np.ndarray:
        return torch.exp(self.params["log_depth"]).detach().cpu().numpy().reshape(
            self.N, self.H, self.W)
