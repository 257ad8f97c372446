"""Depth/disparity evaluation, port of geo4d_tpu/evals/depth.py: scale-shift
alignment and the standard metrics.

Alignment modes: median scale, least-squares (s, t), lad2 (the L1-optimal
(s, t) by Adam from the median ratio, the evaluation's default), scale-only
Weiszfeld, and the same L1 objective by iteratively reweighted least squares
(the group aligner's calibration). Every solver works on the last axis and
batches over leading ones, on the device of its tensors. The metrics are
numpy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from geo4d_tpu_torch.core.device import default_device


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the masked entries of the last axis. Index (n - 1) // 2 is
    the LOWER middle element for even counts (torch.median's convention,
    which the reference alignments seed from)."""
    order = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1).values
    n = mask.sum(-1, keepdim=True)
    return torch.take_along_dim(order, torch.clamp((n - 1) // 2, min=0), dim=-1)[..., 0]


def _median_ratio(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_median(gt, mask) / torch.clamp(_masked_median(pred, mask), min=1e-12)


def lad2_align(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, lr: float = 1e-4,
               max_iters: int = 1000) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, t) minimising sum_mask |s * pred + t - gt| over the last axis by
    `max_iters` Adam steps (b1 0.9, b2 0.999, mhat / (sqrt(vhat) + 1e-8)),
    seeded from s = median(gt) / median(pred), t = 0, for every leading
    index at once. The gradient is closed-form: sum sign(r) pred and
    sum sign(r) over the mask, with the JAX package's sign(0) = +1 (the
    derivative jax.grad takes of |x| at 0)."""
    m = mask.to(pred.dtype)
    st = torch.stack([_median_ratio(pred, gt, mask), torch.zeros(pred.shape[:-1], dtype=pred.dtype,
                                                                 device=pred.device)], -1)
    mom, vel = torch.zeros_like(st), torch.zeros_like(st)
    b1, b2 = np.float32(0.9), np.float32(0.999)
    for step in range(1, max_iters + 1):
        sg = torch.where(st[..., :1] * pred + st[..., 1:] - gt >= 0, m, -m)
        g = torch.stack([(sg * pred).sum(-1), sg.sum(-1)], -1)
        mom = 0.9 * mom + 0.1 * g
        vel = 0.999 * vel + 0.001 * g * g
        mhat = mom / float(1 - b1 ** np.float32(step))
        vhat = vel / float(1 - b2 ** np.float32(step))
        st = st - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return st[..., 0], st[..., 1]


def lad_align_irls(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                   max_iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same L1 objective as `lad2_align` by `max_iters` closed-form 2x2
    weighted normal-equation solves with weights 1 / max(|residual|, 1e-6),
    seeded from s = median(gt) / median(pred), t = 0."""
    m = mask.to(pred.dtype)
    s = _median_ratio(pred, gt, mask)
    t = torch.zeros_like(s)
    for _ in range(max_iters):
        r = s[..., None] * pred + t[..., None] - gt
        w = m / torch.clamp(torch.abs(r), min=1e-6)
        sw, sx, sy = w.sum(-1), (w * pred).sum(-1), (w * gt).sum(-1)
        sxx, sxy = (w * pred * pred).sum(-1), (w * pred * gt).sum(-1)
        det = sw * sxx - sx * sx
        ok = torch.abs(det) > 1e-12
        s, t = (torch.where(ok, (sw * sxy - sx * sy) / det, s),
                torch.where(ok, (sxx * sy - sx * sxy) / det, t))
    return s, t


def lstsq_align(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares (s, t) on the masked entries."""
    m = mask.to(pred.dtype)
    n = m.sum(-1)
    sx, sy = (pred * m).sum(-1), (gt * m).sum(-1)
    sxx, sxy = (pred * pred * m).sum(-1), (pred * gt * m).sum(-1)
    s = (n * sxy - sx * sy) / torch.clamp(n * sxx - sx * sx, min=1e-12)
    return s, (sy - s * sx) / torch.clamp(n, min=1.0)


def scale_only_irls(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                    num_iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weiszfeld scale-only alignment from the ratio of masked means; t = 0."""
    m = mask.to(pred.dtype)
    nan = torch.full_like(pred, float("nan"))
    s = (torch.nanmean(torch.where(mask, gt, nan), -1)
         / torch.clamp(torch.nanmean(torch.where(mask, pred, nan), -1), min=1e-12))
    for _ in range(num_iters):
        w = m / (torch.abs(s[..., None] * pred - gt) + 1e-8)
        s = (w * pred * gt).sum(-1) / torch.clamp((w * pred * pred).sum(-1), min=1e-12)
    return torch.clamp(s, min=1e-3), torch.zeros_like(s)


def depth_metrics(pred_aligned, gt, mask) -> Dict[str, float]:
    """AbsRel / SqRel / RMSE / logRMSE / delta thresholds over the masked
    pixels, numpy on the host. AbsRel, SqRel and RMSE use the raw aligned
    prediction (negative after a shift, possibly); it is clamped to 1e-5
    only before the log and ratio terms."""
    pred = np.asarray(pred_aligned)[np.asarray(mask)]
    g = np.asarray(gt)[np.asarray(mask)]
    abs_rel = float(np.mean(np.abs(pred - g) / g))
    sq_rel = float(np.mean((pred - g) ** 2 / g))
    rmse = float(np.sqrt(np.mean((pred - g) ** 2)))
    pred = np.clip(pred, 1e-5, None)
    log_rmse = float(np.sqrt(np.mean((np.log(pred) - np.log(g)) ** 2)))
    ratio = np.maximum(pred / g, g / pred)
    return {
        "Abs Rel": abs_rel,
        "Sq Rel": sq_rel,
        "RMSE": rmse,
        "Log RMSE": log_rmse,
        "δ < 1.25": float(np.mean(ratio < 1.25)),
        "δ < 1.25^2": float(np.mean(ratio < 1.25**2)),
        "δ < 1.25^3": float(np.mean(ratio < 1.25**3)),
        "valid_pixels": int(mask.sum()),
    }


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def depth_evaluation(pred, gt, max_depth: Optional[float] = 80.0, align: str = "lad2",
                     custom_mask: Optional[np.ndarray] = None,
                     align_mask: Optional[np.ndarray] = None, lr: float = 1e-4,
                     max_iters: int = 1000, post_clip_min: Optional[float] = None,
                     post_clip_max: Optional[float] = None, return_st: bool = False,
                     return_error_map: bool = False, device=None):
    """Evaluation of a depth (or disparity) map against ground truth, both
    flattened. Pixels are valid where gt > 0 (and < max_depth); the metrics
    use valid & custom_mask, the alignment ('lad2' | 'lstsq' | 'scale' |
    'median' | 'none') fits on valid & align_mask, and the aligned
    prediction is clipped to [post_clip_min, post_clip_max] before the
    metrics. With return_error_map also returns |s pred + t - gt| / gt
    (zero outside the valid pixels) in gt's shape.

    The fit runs on `device`: by default the device of `pred` when it is a
    tensor, else the CUDA device (an error where there is none)."""
    if device is None:
        device = pred.device if isinstance(pred, torch.Tensor) else default_device()
    shape = _host(gt).shape
    pred = _host(pred).astype(np.float32).reshape(-1)
    gt = _host(gt).astype(np.float32).reshape(-1)
    valid = gt > 0
    if max_depth is not None:
        valid &= gt < max_depth
    metric_mask = valid if custom_mask is None else (valid & custom_mask.reshape(-1))
    # custom_mask restricts the metrics only: the fit uses every valid
    # pixel unless an align_mask narrows it
    fit_mask = valid if align_mask is None else (valid & align_mask.reshape(-1))

    p, g, m = (torch.from_numpy(a).to(device) for a in (pred, gt, fit_mask))
    if align == "lad2":
        s, t = lad2_align(p, g, m, lr=lr, max_iters=max_iters)
    elif align == "lstsq":
        s, t = lstsq_align(p, g, m)
    elif align == "scale":
        s, t = scale_only_irls(p, g, m)
    elif align == "median":
        s, t = _median_ratio(p, g, m), 0.0
    else:
        s, t = 1.0, 0.0
    s, t = float(s), float(t)

    aligned = s * pred + t
    if post_clip_min is not None:
        aligned = np.clip(aligned, post_clip_min, None)
    if post_clip_max is not None:
        aligned = np.clip(aligned, None, post_clip_max)
    out = depth_metrics(aligned, gt, metric_mask)
    if return_st:
        out["s"] = s
        out["t"] = t
    if return_error_map:
        err = np.zeros_like(gt)
        raw_aligned = s * pred + t
        err[valid] = np.abs(raw_aligned[valid] - gt[valid]) / gt[valid]
        return out, err.reshape(shape)
    return out
