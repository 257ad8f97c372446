"""GroupNorm in plain PyTorch ops (the port's `group_norm_plain`), with
autograd through the ops themselves: the reference has no kernels."""

from __future__ import annotations

import torch


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last axis of channels-last `x` (+ optional SiLU):
    per-channel f32 moments, group combine, one per-channel affine."""
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xf = x.reshape(n, -1, c).float()
    mean_c = xf.mean(dim=1)                                   # (N, C)
    mean2_c = (xf * xf).mean(dim=1)
    mean_g = mean_c.view(n, groups, cg).mean(-1)              # (N, G)
    mean2_g = mean2_c.view(n, groups, cg).mean(-1)
    var_g = torch.clamp(mean2_g - mean_g * mean_g, min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    rstd_c = rstd_g.repeat_interleave(cg, dim=-1)             # (N, C)
    shift_c = (mean_g * rstd_g).repeat_interleave(cg, dim=-1)
    a = rstd_c * gamma.float()[None]
    b = beta.float()[None] - shift_c * gamma.float()[None]
    y = xf * a[:, None] + b[:, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)
