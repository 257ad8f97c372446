"""Group global-alignment optimizer, port of
geo4d_tpu/alignment/optimizer.py: fuses the sliding-window predictions into
one scene and one camera trajectory.

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
     (+ the optional rigid-flow term to given optical flow, and the optional
     si-log depth pull).

Two phases of Adam (b1 = b2 = 0.9, eps 1e-8 outside the square root, a
linear or cosine learning-rate schedule), with the iteration-150
calibration between them. One optimizer carries its moments and step count
from phase 1 into phase 2, so `calibrate` writes its values into the
existing parameter and gate tensors in place. The frame gathers sum their
gradients in a fixed order, so a run repeats bit for bit. On CUDA each loss
structure (phase 1; phase 2; a flow term that switches on mid-phase)
computes its first iteration's loss and gradients eagerly and every later
one by replaying one CUDA graph of them (ops/graphs.py); the fused Adam
step stays eager, so a replayed iteration does the eager one's arithmetic
bit for bit. Layout: plain (N, P, 3) point tensors and index gathers, all
on the device of the predictions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from geo4d_tpu_torch.core.device import default_device
from geo4d_tpu_torch.core.timing import count, span, stage
from geo4d_tpu_torch.evals.depth import lad_align_irls
from geo4d_tpu_torch.evals.trajectory import Trajectory, align_trajectory_with_eval
from geo4d_tpu_torch.geometry.se3 import params_to_pose, pose_to_params
from geo4d_tpu_torch.geometry.utils import inv_se3
from geo4d_tpu_torch.geometry.warp import flow_error_sums
from geo4d_tpu_torch.ops import graphs

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


class _GatherFrames(torch.autograd.Function):
    """The rows x[index] of per-frame rows x (N, ...). The backward sums
    each frame's copies one addition at a time, in the order its row of
    `slots` (N, K; entries ascending, padded with len(index)) lists them:
    PyTorch's deterministic index_add does the same, and the default
    backward of index_select adds atomically in whatever order the device
    takes, so two runs would differ in the last bits."""

    @staticmethod
    def forward(ctx, x, index, slots):
        ctx.save_for_backward(slots)
        ctx.rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (slots,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        out = grad.new_zeros((ctx.rows,) + grad.shape[1:])
        for k in range(slots.shape[1]):
            out.add_(padded.index_select(0, slots[:, k]))
        return out, None, None


class GroupAligner:
    """Optimizer over stacked window predictions.

    Inputs (numpy arrays or tensors; G windows of S frames, P = H * W pixels):
      pred_pts (G, S, P, 3) or (G, S, H, W, 3)  window point maps
      weights  (G, S, P)    inverse-confidence weights (0 = invalid)
      invdepth (G, S, P)    diffusion inverse depth
      trajs    (G, S, 4, 4) diffusion cameras
      groups   (G, S) int   frame index of each window slot
      target_flows (N-1, H, W, 2) optical flow from frame i to i + 1, and
      flow_masks   (N-1, H, W)    its weights (default 1): the rigid-flow
                   term, live when config.flow_loss_weight > 0
    Everything lives on `device`: by default the device of `pred_pts` when
    it is a tensor, else the CUDA device (an error where there is none);
    pass device="cpu" to run on the CPU. Construction counts the window
    points held, G * S * P ("align_points", `core.timing`)."""

    def __init__(self, groups, pred_pts, weights, imshape: Tuple[int, int], invdepth=None,
                 trajs=None, config: AlignerConfig = AlignerConfig(), target_flows=None,
                 flow_masks=None, device=None):
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
        count("align_points", G * S * P)
        self.buf: Dict[str, torch.Tensor] = {
            "pred_pts": f32(pred_pts).reshape(G, S, P, 3),
            "weights": f32(weights).reshape(G, S, P),
            "e_all": torch.as_tensor(self.groups.reshape(-1), device=dev),
        }
        # each frame's entries of e_all, ascending, padded with G * S
        flat = self.groups.reshape(-1)
        counts = np.bincount(flat, minlength=self.N)
        slots = np.full((self.N, int(counts.max())), G * S, np.int64)
        by_frame = np.split(np.argsort(flat, kind="stable"), np.cumsum(counts)[:-1])
        for n, entries in enumerate(by_frame):
            slots[n, :len(entries)] = entries
        self.buf["frame_slots"] = torch.as_tensor(slots, device=dev)
        self.has_depth = invdepth is not None
        self.has_traj = trajs is not None
        if self.has_depth:
            self.buf["invdepth"] = f32(invdepth).reshape(G, S, P)
        if self.has_traj:
            self.buf["trajs"] = f32(trajs).reshape(G, S, 4, 4)
        self.has_flow = target_flows is not None and config.flow_loss_weight > 0
        if self.has_flow:
            self.buf["target_flows"] = f32(target_flows).reshape(self.N - 1, self.H, self.W, 2)
            self.buf["flow_masks"] = (torch.ones(self.N - 1, self.H, self.W, device=dev)
                                      if flow_masks is None
                                      else f32(flow_masks).reshape(self.N - 1, self.H, self.W))
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
        # s/t are set by calibration, never by a gradient; preset_focal may
        # freeze the focal too. Only leaves that require grad are optimized.
        for k, p in self.params.items():
            p.requires_grad_(k not in ("s_depth", "t_depth"))
        self.pnp_failures = 0               # frames left at the identity pose by init
        self.final_loss: Optional[float] = None   # set by run()
        # phase-2 window gates (written in place by calibrate: a captured
        # iteration reads them where they are)
        self.valid_depth_group = torch.ones(G, device=dev)
        self.valid_traj_group = torch.zeros(G, device=dev)
        self._log_depth_init: Optional[torch.Tensor] = None
        self._im_conf: Optional[np.ndarray] = None
        self._init_conf: Optional[np.ndarray] = None

    # ---------------- per-frame confidence (lazy, numpy) ----------------

    def _frame_conf(self) -> torch.Tensor:
        """Per-frame max of the window weights (0 for a frame in no window)."""
        w = self.buf["weights"].reshape(self.G * self.S, self.P)
        idx = self.buf["e_all"][:, None].expand(-1, self.P)
        out = torch.zeros(self.N, self.P, device=self.device)
        return out.scatter_reduce_(0, idx, w, "amax", include_self=True)

    @property
    def im_conf(self) -> np.ndarray:
        if self._im_conf is None:
            self._im_conf = self._frame_conf().cpu().numpy()
        return self._im_conf

    @im_conf.setter
    def im_conf(self, value: np.ndarray):
        # snapshot the pristine confidence before anything overwrites it
        if self._init_conf is None:
            self._init_conf = self.im_conf.copy()
        self._im_conf = value

    @property
    def init_conf(self) -> np.ndarray:
        if self._init_conf is None:
            self._init_conf = self.im_conf.copy()
        return self._init_conf

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

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Per-frame rows x (N, ...) -> each window slot's frame's (G * S, ...)."""
        return _GatherFrames.apply(x, self.buf["e_all"], self.buf["frame_slots"])

    def loss_fn(self, params, use_depth_traj: bool, iter_frac: float = 1.0) -> torch.Tensor:
        """The full objective at `params` (a dict like `self.params`)."""
        cfg, buf = self.cfg, self.buf
        G, S, P = self.G, self.S, self.P
        proj = self._pts3d_world(params)
        pw = params_to_pose(params["pw_poses"][:, :7])
        s = self._pw_scale(params)
        pw = torch.cat([pw[:, :3] * s[:, None, None], pw[:, 3:]], dim=1)     # sim3 (G, 4, 4)
        aligned = buf["pred_pts"] @ pw[:, None, :3, :3].transpose(-1, -2) + pw[:, None, None, :3, 3]
        w = torch.clamp(buf["weights"], max=cfg.conf_clamp) if cfg.conf_optimize else buf["weights"]
        proj_e = self._gather(proj).reshape(G, S, P, 3)
        d = proj_e - aligned
        loss = (torch.sqrt((d * d).sum(-1) + 1e-12) * w).sum() / self.total_area

        if use_depth_traj and self.has_depth:
            inv_pred = 1.0 / (torch.exp(params["log_depth"]) + 1e-6)
            inv_pred_e = self._gather(inv_pred).reshape(G, S, P)
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
            poses_e = self._gather(params_to_pose(params["poses"]))
            per = _rel_pose_loss(moved.reshape(-1, 4, 4), poses_e,
                                 cfg.translation_weight).reshape(G, S)
            loss = loss + (per * self.valid_traj_group[:, None]).sum() * cfg.traj_loss_weight

        if cfg.temporal_smoothing_weight > 0:
            poses = params_to_pose(params["poses"])
            loss = loss + cfg.temporal_smoothing_weight * _rel_pose_loss(
                poses[:-1], poses[1:], cfg.translation_weight).sum()

        if self.has_flow and iter_frac >= cfg.flow_loss_start_frac:
            loss = loss + cfg.flow_loss_weight * self._flow_term(params)

        if cfg.depth_regularize_weight > 0 and self._log_depth_init is not None:
            # scale-invariant log-depth pull to the init depth
            ld, ld0 = params["log_depth"], self._log_depth_init
            shift = (ld0 - ld).mean(-1, keepdim=True)
            loss = loss + cfg.depth_regularize_weight * ((ld - ld0 + shift) ** 2).mean(-1).mean()
        return loss

    def _flow_term(self, params) -> torch.Tensor:
        """Rigid flow of each consecutive frame pair (depth i, poses i and
        i + 1, frame 0's focal) against the target flow: the error summed
        over valid, mask-weighted pixels of all pairs over the weights' sum."""
        f = self._focals(params)[0]
        zero, one = torch.zeros_like(f), torch.ones_like(f)
        K = torch.stack([f, zero, zero + self.W / 2, zero, f, zero + self.H / 2,
                         zero, zero, one]).reshape(3, 3)
        depth = torch.exp(params["log_depth"]).reshape(self.N, self.H, self.W)
        num, den = flow_error_sums(depth, params_to_pose(params["poses"]), K,
                                   self.buf["target_flows"], self.buf["flow_masks"],
                                   self.cfg.flow_loss_fn)
        return num.sum() / (den.sum() + 1e-8)

    # ---------------- optimization ----------------

    @property
    def focal_frozen(self) -> bool:
        return not self.params["focal"].requires_grad

    def _structure(self, it: int, use_depth_traj: bool) -> tuple:
        """The loss terms live at iteration `it`: one CUDA graph each."""
        flow = self.has_flow and it / self.cfg.n_iter >= self.cfg.flow_loss_start_frac
        return use_depth_traj, flow

    def run(self, verbose: bool = False, timer=None) -> float:
        """Two-phase optimization: [0, start) point maps only; calibration;
        [start, n_iter) with disparity and trajectory anchors. Returns the
        loss at the last iteration (before its update). Stages
        "align_phase1", "calibrate", "align_phase2"; each iteration is a
        span "align_iter" (`core.timing`). An eager iteration has children
        "align_loss", "align_backward" and "align_adam"; on CUDA each loss
        structure's second iteration captures its loss and gradients (span
        "align_capture" before it) and it and every later one replay them,
        with the child "align_adam" only. The graphs and their memory are
        released before returning. Counters "align_eager_iters" and
        "align_graph_replays" count both kinds."""
        cfg = self.cfg
        start = min(cfg.depth_traj_start_iter, cfg.n_iter)
        trainable = [self.params[k] for k in PARAM_NAMES if self.params[k].requires_grad]
        cuda = self.device.type == "cuda"
        opt = torch.optim.Adam(trainable, lr=cfg.lr, betas=(0.9, 0.9), eps=1e-8, fused=cuda)
        if cfg.depth_regularize_weight > 0:
            self._log_depth_init = self.params["log_depth"].detach().clone()
        losses = torch.zeros(cfg.n_iter, device=self.device)

        def gradients(it, use_depth_traj):
            opt.zero_grad(set_to_none=True)     # a last graph's gradients hold its pool
            with span("align_loss"):
                loss = self.loss_fn(self.params, use_depth_traj, it / cfg.n_iter)
            with span("align_backward"):
                loss.backward()
                for p in trainable:
                    # a trainable leaf outside this phase's loss (traj_align
                    # in phase 1) still takes an Adam step with a zero
                    # gradient: optax counts steps globally
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            return loss.detach()

        replay = graphs.GraphReplay(self.device, "align_capture")

        def phase(iters, use_depth_traj):
            for it in iters:
                key = self._structure(it, use_depth_traj)
                fn = functools.partial(gradients, it, use_depth_traj)
                replay.prepare(key, fn)             # a capture precedes its iteration's span
                with span("align_iter"):
                    loss, replayed = replay(key, fn)
                    losses[it].copy_(loss)
                    count("align_graph_replays" if replayed else "align_eager_iters")
                    with span("align_adam"):
                        opt.param_groups[0]["lr"] = _lr_at(it, cfg)
                        opt.step()

        # the whole run on the stream the graphs are captured on: on the caller's,
        # the eager iterations took 32 MiB more peak (H100, 32 frames at 576x256)
        stream = graphs.side_stream(self.device) if cuda else None
        if cuda:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.enable_grad(), torch.cuda.stream(stream):
                with stage(timer, "align_phase1"):
                    phase(range(start), False)
                with stage(timer, "calibrate"):
                    if self.has_depth or self.has_traj:
                        self.calibrate()
                if verbose and start > 0:
                    print(f"[aligner] phase1 loss {float(losses[start - 1]):.5f}")
                with stage(timer, "align_phase2"):
                    phase(range(start, cfg.n_iter), True)
        finally:
            replay.free()
            opt.zero_grad(set_to_none=True)     # the last graph's gradients live in its pool
            if cuda:
                torch.cuda.current_stream(self.device).wait_stream(stream)
        final = float(losses[-1]) if cfg.n_iter > 0 else 0.0
        if verbose:
            print(f"[aligner] final loss {final:.5f}")
        self.final_loss = final
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
            self.valid_depth_group.copy_(delta >= cfg.delta_valid_thr)

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
            self.valid_traj_group.copy_(torch.from_numpy(valid))

    # ---------------- presets ----------------

    @torch.no_grad()
    def preset_focal(self, focals, requires_grad: bool = False):
        f = np.asarray(focals, np.float32).reshape(-1)
        if self.cfg.shared_focal:
            f = f[:1]
        self.params["focal"].copy_(torch.from_numpy(self.cfg.focal_break * np.log(f)))
        self.params["focal"].requires_grad_(requires_grad)

    # ---------------- outputs (results-dir contract, numpy) ----------------

    def get_focals(self) -> np.ndarray:
        return self._focals(self.params).detach().cpu().numpy()

    def get_intrinsics(self) -> np.ndarray:
        f = self.get_focals()
        K = np.tile(np.eye(3), (self.N, 1, 1)).astype(np.float32)
        K[:, 0, 0] = f
        K[:, 1, 1] = f
        K[:, 0, 2] = self.W / 2
        K[:, 1, 2] = self.H / 2
        return K

    def get_im_poses(self) -> np.ndarray:
        return params_to_pose(self.params["poses"]).detach().cpu().numpy()

    def get_depthmaps(self) -> np.ndarray:
        return torch.exp(self.params["log_depth"]).detach().cpu().numpy().reshape(
            self.N, self.H, self.W)

    def get_pts3d(self) -> np.ndarray:
        with torch.no_grad():
            pts = self._pts3d_world(self.params)
        return pts.cpu().numpy().reshape(self.N, self.H, self.W, 3)

    def get_conf(self) -> np.ndarray:
        return self.im_conf.reshape(self.N, self.H, self.W)

    def get_init_conf(self) -> np.ndarray:
        return self.init_conf.reshape(self.N, self.H, self.W)

    def get_masks(self) -> np.ndarray:
        return self.get_conf() > self.cfg.min_conf_thr

    def get_tum_poses(self) -> np.ndarray:
        return Trajectory.from_matrices(self.get_im_poses()).to_tum()

    def apply_cleanup(self, tol: float = 0.001, bad_conf: float = 0.0) -> np.ndarray:
        """Cross-view consistency filter: floaters that occlude
        better-supported geometry get their confidence clipped; affects
        get_conf / get_masks / exports."""
        from geo4d_tpu_torch.alignment.cleanup import clean_pointcloud

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        w2c = inv_se3(dev(self.get_im_poses()))
        filtered = clean_pointcloud(dev(self.get_conf()), dev(self.get_intrinsics()), w2c,
                                    dev(self.get_depthmaps()), dev(self.get_pts3d()),
                                    tol=tol, bad_conf=bad_conf)
        self.im_conf = filtered.cpu().numpy().reshape(self.N, self.P)
        return self.im_conf
