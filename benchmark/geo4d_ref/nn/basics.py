"""Shared NN primitives for the diffusion stack.

Layout: channels-last everywhere, as in the JAX package: (B, H, W, C) frames,
(B, T, H, W, C) clips, (B, N, C) tokens. A contiguous (B, H, W, C) tensor
permuted to (B, C, H, W) is exactly PyTorch's channels_last memory format,
so convolutions run on it without a copy and their output permutes back to
a contiguous channels-last tensor.

Norm parameters are float32 whatever the model's dtype; every other
parameter is created in the dtype passed to its module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from geo4d_ref.ops.group_norm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] ordering. (N,) -> (N, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def num_groups_for(channels: int, num_groups: int = 32) -> int:
    """Largest group count <= num_groups that divides the channel count."""
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics and parameters over channels-last x,
    statistics per x.shape[0] over all middle axes; `silu` fuses the SiLU
    that follows the norm. Runs kernel K1 on CUDA, its plain version on the
    CPU. Returns x's dtype."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 silu: bool = False):
        super().__init__()
        self.groups = num_groups_for(channels, num_groups)
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x.contiguous(), self.weight, self.bias, self.groups,
                          self.eps, self.silu)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32 with float32 parameters; returns float32
    (callers cast, as the JAX modules do)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    """2-D convolution on channels-last (B, H, W, C) tensors; the weight keeps
    PyTorch's (O, I, kh, kw) layout. Default padding is k // 2."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: int | None = None, bias: bool = True, dtype=torch.bfloat16):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=kernel // 2 if padding is None else padding,
                         bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).contiguous()


class TemporalConv(nn.Module):
    """(3, 1, 1) convolution over the T axis of (B, T, H, W, C) clips; the
    weight keeps Conv3d's (O, I, 3, 1, 1) layout and runs as a (3, 1) 2-D
    convolution over (T, H*W)."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 1, 1, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=dtype))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        y = F.conv2d(x.reshape(b, t, h * w, c).permute(0, 3, 1, 2),
                     self.weight[..., 0], self.bias, padding=(1, 0))
        return y.permute(0, 2, 3, 1).reshape(b, t, h, w, -1)


def time_embed_mlp(in_dim: int, out_dim: int, zero_out: bool = False,
                   dtype=torch.bfloat16) -> nn.Sequential:
    """linear -> SiLU -> linear (keys `0.*`, `2.*`); `zero_out` zero-inits the
    second linear, as the fps-embedding tail is."""
    mlp = nn.Sequential(nn.Linear(in_dim, out_dim, dtype=dtype), nn.SiLU(),
                        nn.Linear(out_dim, out_dim, dtype=dtype))
    if zero_out:
        zero_(mlp[2])
    return mlp


def zero_(module: nn.Module) -> nn.Module:
    """Zero-initialise a module's parameters (residual tails)."""
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C) nearest-neighbour."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) 2x2 average pool, stride 2."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
