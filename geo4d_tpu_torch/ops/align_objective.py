"""The group aligner's per-pixel objective and its gradient in one pass:
the kernel `align_objective` (csrc/align_objective.cu) and its plain
version.

`align_objective(data, log_depth, focal, poses, sims, s_depth, t_depth,
valid_depth, depth_term)` is the point-map term of `GroupAligner.loss_fn`
and, with `depth_term`, its disparity term:

    sum over entries e = (window g, slot) of frame n, pixels p of
        w[e, p] |R_n rel[n, p] + t_n - (M_g pred[e, p] + b_g)|      / A
      + depth_weight |1 / (z + 1e-6) - (invdepth[e, p] s_g + t_g)| m  / A

with z = exp(log_depth[n, p]), rel the pixel unprojected at depth z with
frame n's focal, |.| = sqrt(. + 1e-12), w the weights clamped at
`conf_clamp` (when given), m = (invdepth > thr) valid_depth[g] and A = G S P.
`poses` are the frames' rows (R_n | t_n) (N, 3, 4), `sims` the windows'
sim3 rows (M_g | b_g) (G, 3, 4), `focal` one focal per frame (N,) (a view
of a shared one does).

The forward computes the loss and, when autograd records the call, every
gradient at once: a CUDA tensor launches the kernel (one pass over the
pixels, then a fold of its per-block partials, both in a fixed order); a
CPU tensor takes `align_objective_plain`, the same formulas in PyTorch. The
backward scales the saved gradients by the incoming one.

`GroupAligner.loss_fn` does not call it yet. Its sums run in another order
than autograd's, so the aligner's last-bit arithmetic changes, and 500 Adam
iterations turn that into an objective gap of about 1e-3 between two runs.
The benchmark's check of the aligner accepts only bit-equal arithmetic
until it judges the objective at fixed parameters (PERF.md).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from geo4d_tpu_torch.ops.dispatch import (
    KernelStats,
    check_launch,
    kernels,
    require,
    stream_handle,
    use_kernel,
)

stats = KernelStats()

BLOCK_PIXELS = 1024   # pixels of one block, as csrc/align_objective.cu's kBlockPix
FRAME_VALS = 16       # floats of a frame's partial per block (kFrameVals)
ENTRY_VALS = 14       # floats of an entry's partial per block (kEntryVals)


class ObjectiveData:
    """What the objective reads besides the parameters, fixed for one
    aligner: the window predictions viewed per entry e = g * S + slot
    (pred (E, P, 3), weights (E, P), invdepth (E, P) or None), the map from
    each frame to its entries, windows ascending (CSR: `frame_ptr`,
    `entries`; padded per frame in `slots` with E for the plain version),
    and the constants."""

    def __init__(self, groups, pred_pts: torch.Tensor, weights: torch.Tensor,
                 invdepth: Optional[torch.Tensor], hw, conf_clamp: Optional[float],
                 invdepth_thr: float, depth_weight: float):
        groups = np.asarray(groups, np.int64)
        self.G, self.S = groups.shape
        self.E = self.G * self.S
        self.H, self.W = hw
        self.P = self.H * self.W
        frames = groups.reshape(-1)
        self.N = int(frames.max()) + 1
        order = np.argsort(frames, kind="stable")
        counts = np.bincount(frames, minlength=self.N)
        ptr = np.concatenate([[0], np.cumsum(counts)])
        slots = np.full((self.N, int(counts.max())), self.E, np.int64)
        for n in range(self.N):
            slots[n, :counts[n]] = order[ptr[n]:ptr[n + 1]]
        dev = pred_pts.device
        self.frame_ptr = torch.as_tensor(ptr, dtype=torch.int32, device=dev)
        self.entries = torch.as_tensor(order, dtype=torch.int32, device=dev)
        self.slots = torch.as_tensor(slots, device=dev)
        self.entry_frame = torch.as_tensor(frames, device=dev)
        self.entry_window = torch.arange(self.E, device=dev) // self.S
        self.pred = pred_pts.reshape(self.E, self.P, 3)
        self.weights = weights.reshape(self.E, self.P)
        self.invdepth = None if invdepth is None else invdepth.reshape(self.E, self.P)
        self.clamp = math.inf if conf_clamp is None else float(conf_clamp)
        self.thr = float(invdepth_thr)
        self.depth_weight = float(depth_weight)
        self.area = float(self.E * self.P)

    def partial_floats(self) -> int:
        """Floats of the kernel's per-block partials."""
        blocks = math.ceil(self.P / BLOCK_PIXELS)
        return blocks * (self.N * FRAME_VALS + self.E * ENTRY_VALS)

    def grad_floats(self) -> int:
        """Floats of the flat gradient: d log_depth, d poses, d focal, d sims,
        d s_depth, d t_depth."""
        return self.N * self.P + 13 * self.N + 14 * self.G

    def split(self, flat: torch.Tensor):
        """Views of the flat gradient in the inputs' order and shapes: d
        log_depth, d focal, d poses, d sims, d s_depth, d t_depth."""
        N, P, G = self.N, self.P, self.G
        dld, dposes, dfocal, dsims, ds, dt = torch.split(flat, [N * P, 12 * N, N, 12 * G, G, G])
        return dld.view(N, P), dfocal, dposes.view(N, 3, 4), dsims.view(G, 3, 4), ds, dt


def align_objective_plain(data: ObjectiveData, log_depth, focal, poses, sims, s_depth, t_depth,
                          valid_depth, depth_term: bool, grad: bool):
    """(loss, flat gradient or None) by the kernel's formulas in PyTorch:
    each pixel sums its frame's entries in the kernel's order (windows
    ascending); every other sum is PyTorch's."""
    stats.note_plain(log_depth)
    N, P, E, W = data.N, data.P, data.E, data.W
    pix = torch.arange(P, device=log_depth.device)
    u, v = (pix % W).float(), (pix // W).float()
    f = focal[:, None]
    z = torch.exp(log_depth)
    rel = (z * (u - W / 2) / f, z * (v - data.H / 2) / f, z)
    proj = [poses[:, r, 0:1] * rel[0] + poses[:, r, 1:2] * rel[1] + poses[:, r, 2:3] * rel[2]
            + poses[:, r, 3:4] for r in range(3)]
    fe, ge = data.entry_frame, data.entry_window
    M = sims[ge]
    x, y, w0 = data.pred.unbind(-1)
    d = [proj[r][fe] - (M[:, r, 0:1] * x + M[:, r, 1:2] * y + M[:, r, 2:3] * w0 + M[:, r, 3:4])
         for r in range(3)]
    wt = torch.clamp(data.weights, max=data.clamp)
    nrm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-12)
    loss = (wt * nrm).sum() / data.area
    if depth_term:
        idp = data.invdepth
        inv = 1.0 / (z + 1e-6)
        m = (idp > data.thr).float() * valid_depth[ge][:, None]
        r_d = inv[fe] - (idp * s_depth[ge][:, None] + t_depth[ge][:, None])
        loss = loss + (r_d.abs() * m).sum() / data.area * data.depth_weight
    if not grad:
        return loss, None

    c = wt * (1.0 / data.area) / nrm
    q = [c * d[r] for r in range(3)]

    def per_pixel(t):
        """(E, P) -> (N, P): each frame's entries summed in the kernel's order."""
        padded = torch.cat([t, t.new_zeros(1, P)])
        acc = torch.zeros(N, P, dtype=t.dtype, device=t.device)
        for k in range(data.slots.shape[1]):
            acc = acc + padded[data.slots[:, k]]
        return acc

    Gp = [per_pixel(qr) for qr in q]
    dsims = -torch.stack([torch.stack([(qr * x).sum(-1), (qr * y).sum(-1), (qr * w0).sum(-1),
                                       qr.sum(-1)], -1) for qr in q], 1)          # (E, 3, 4)
    ds = torch.zeros(E, device=z.device)
    dt = torch.zeros(E, device=z.device)
    if depth_term:
        depth_scale = data.depth_weight / data.area
        sgn = torch.sign(r_d) * m
        ds = -(sgn * depth_scale * idp).sum(-1)
        dt = -(sgn * depth_scale).sum(-1)
    dposes = torch.stack([torch.stack([(Gp[r] * rel[0]).sum(-1), (Gp[r] * rel[1]).sum(-1),
                                       (Gp[r] * rel[2]).sum(-1), Gp[r].sum(-1)], -1)
                          for r in range(3)], 1)                                     # (N, 3, 4)
    a = [poses[:, 0, col:col + 1] * Gp[0] + poses[:, 1, col:col + 1] * Gp[1]
         + poses[:, 2, col:col + 1] * Gp[2] for col in range(3)]                      # R^T G
    dfocal = (-(a[0] * rel[0] + a[1] * rel[1]) / f).sum(-1)
    dld = a[0] * rel[0] + a[1] * rel[1] + a[2] * rel[2]
    if depth_term:
        dld = dld + per_pixel(sgn) * depth_scale * -(inv * inv) * z
    G = data.G
    flat = torch.cat([dld.reshape(-1), dposes.reshape(-1), dfocal,
                      dsims.reshape(G, data.S, 12).sum(1).reshape(-1),
                      ds.reshape(G, data.S).sum(1), dt.reshape(G, data.S).sum(1)])
    return loss, flat


def _check(data: ObjectiveData, log_depth, focal, poses, sims, s_depth, t_depth, valid_depth,
           depth_term):
    N, P, G = data.N, data.P, data.G
    dev = log_depth.device
    f32 = [log_depth, focal, poses, sims, s_depth, t_depth, valid_depth, data.pred, data.weights]
    require(all(t.dtype == torch.float32 and t.device == dev for t in f32),
            "every input must be float32 on one device")
    require(log_depth.shape == (N, P) and log_depth.is_contiguous(),
            f"log_depth must be contiguous ({N}, {P})")
    require(focal.shape == (N,) and focal.stride(0) in (0, 1), f"focal must be ({N},), stride 0 or 1")
    require(poses.shape == (N, 3, 4) and poses.stride()[1:] == (4, 1),
            f"poses must be ({N}, 3, 4) with contiguous rows")
    require(sims.shape == (G, 3, 4) and sims.is_contiguous(), f"sims must be contiguous ({G}, 3, 4)")
    require(all(t.shape == (G,) and t.is_contiguous() for t in (s_depth, t_depth, valid_depth)),
            f"s_depth, t_depth and valid_depth must be contiguous ({G},)")
    require(data.pred.is_contiguous() and data.weights.is_contiguous(),
            "the window predictions must be contiguous")
    require(not depth_term or (data.invdepth is not None and data.invdepth.is_contiguous()),
            "the depth term needs contiguous inverse depths")
    require(N <= 65535, f"at most 65535 frames, got {N}")


def _kernel(data: ObjectiveData, log_depth, focal, poses, sims, s_depth, t_depth, valid_depth,
            depth_term: bool, grad: bool):
    _check(data, log_depth, focal, poses, sims, s_depth, t_depth, valid_depth, depth_term)
    dev = log_depth.device
    partials = torch.empty(data.partial_floats(), device=dev)
    flat = torch.empty(data.grad_floats(), device=dev) if grad else None
    loss = torch.empty((), device=dev)
    invdepth = data.invdepth if depth_term else None
    err = kernels().align_objective(
        log_depth.data_ptr(), focal.data_ptr(), focal.stride(0), poses.data_ptr(),
        poses.stride(0), sims.data_ptr(), s_depth.data_ptr(), t_depth.data_ptr(),
        valid_depth.data_ptr(), data.pred.data_ptr(), data.weights.data_ptr(),
        0 if invdepth is None else invdepth.data_ptr(), data.frame_ptr.data_ptr(),
        data.entries.data_ptr(), data.N, data.P, data.W, data.G, data.S, data.W / 2,
        data.H / 2, data.clamp, data.thr, data.area, data.depth_weight, int(depth_term),
        int(grad), partials.data_ptr(), 0 if flat is None else flat.data_ptr(), loss.data_ptr(),
        stream_handle(log_depth))
    check_launch("align_objective", err)
    stats.note_launch((data.N, data.P, data.G, data.S, bool(depth_term), bool(grad)))
    return loss, flat


def align_objective_forward(data: ObjectiveData, log_depth, focal, poses, sims, s_depth,
                            t_depth, valid_depth, depth_term: bool, grad: bool):
    """(loss, flat gradient or None) on the kernel's route for the device:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = _kernel if use_kernel(log_depth) else align_objective_plain
    return fn(data, log_depth, focal, poses, sims, s_depth, t_depth, valid_depth,
              bool(depth_term), grad)


class _AlignObjective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_depth, focal, poses, sims, s_depth, t_depth, data, valid_depth,
                depth_term):
        grad = any(ctx.needs_input_grad[:6])
        loss, flat = align_objective_forward(data, log_depth, focal, poses, sims, s_depth,
                                             t_depth, valid_depth, depth_term, grad)
        if grad:
            ctx.save_for_backward(flat)
            ctx.data = data
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        (flat,) = ctx.saved_tensors
        grads = ctx.data.split(flat * grad_loss)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad)) + (
            None, None, None)


def align_objective(data: ObjectiveData, log_depth: torch.Tensor, focal: torch.Tensor,
                    poses: torch.Tensor, sims: torch.Tensor, s_depth: torch.Tensor,
                    t_depth: torch.Tensor, valid_depth: torch.Tensor,
                    depth_term: bool) -> torch.Tensor:
    """The objective's per-pixel terms (module docstring), differentiable in
    log_depth, focal, poses, sims, s_depth and t_depth."""
    return _AlignObjective.apply(log_depth, focal, poses, sims, s_depth, t_depth, data,
                                 valid_depth, bool(depth_term))
