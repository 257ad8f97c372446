"""The group aligner's calibration from geo4d_tpu/evals/depth.py: the
L1-optimal disparity scale and shift by iteratively reweighted least
squares, on the last axis, batched over leading ones, on the device of its
tensors. The evaluation's alignments and metrics are left out of this copy.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the masked entries of the last axis. Index (n - 1) // 2 is
    the LOWER middle element for even counts (torch.median's convention,
    which the reference alignments seed from)."""
    order = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1).values
    n = mask.sum(-1, keepdim=True)
    return torch.take_along_dim(order, torch.clamp((n - 1) // 2, min=0), dim=-1)[..., 0]


def _median_ratio(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _masked_median(gt, mask) / torch.clamp(_masked_median(pred, mask), min=1e-12)


def lad_align_irls(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                   max_iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """The L1-optimal (s, t) by `max_iters` closed-form 2x2
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
