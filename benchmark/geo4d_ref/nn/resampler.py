"""Perceiver resampler: per-frame CLIP tokens -> 16 conditioning tokens per
frame, port of geo4d_tpu/nn/resampler.py.

The query bank holds num_queries * video_length learned queries; frame k of
a window reads query slice k, so a frame's tokens depend on its position in
the window. Queries attend over [image tokens | queries] jointly.
Parameter names follow the original Geo4D resampler.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geo4d_ref.nn.attention import dot_product_attention
from geo4d_ref.nn.basics import LayerNorm32


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 12, dim_head: int = 64, dtype=torch.bfloat16):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.to_q = nn.Linear(dim, inner, bias=False, dtype=dtype)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, dtype=dtype)
        self.to_out = nn.Linear(inner, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """x: (B, N1, D) image features; latents: (B, N2, D) queries."""
        b, n2, _ = latents.shape
        x = self.norm1(x).to(self.dtype)
        latents = self.norm2(latents).to(self.dtype)
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=1)).chunk(2, dim=-1)

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, self.dim_head)

        out = dot_product_attention(split(q), split(k), split(v))
        return self.to_out(out.reshape(b, n2, -1))


class _FeedForward(nn.Sequential):
    """LayerNorm -> linear -> exact GELU -> linear (keys 0, 1, 3)."""

    def __init__(self, dim: int, mult: int, dtype):
        super().__init__(LayerNorm32(dim), nn.Linear(dim, dim * mult, bias=False, dtype=dtype),
                         nn.GELU(), nn.Linear(dim * mult, dim, bias=False, dtype=dtype))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[3](self[2](self[1](self[0](x).to(self.dtype))))


class Resampler(nn.Module):
    def __init__(self, dim: int = 1024, depth: int = 4, dim_head: int = 64, heads: int = 12,
                 num_queries: int = 16, embedding_dim: int = 1280, output_dim: int = 1024,
                 ff_mult: int = 4, video_length: Optional[int] = 16, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_queries, self.output_dim = dim, num_queries, output_dim
        self.video_length, self.dtype = video_length, dtype
        total_q = num_queries * (video_length or 1)
        self.latents = nn.Parameter(torch.randn(1, total_q, dim) / dim ** 0.5)
        self.proj_in = nn.Linear(embedding_dim, dim, dtype=dtype)
        self.proj_out = nn.Linear(dim, output_dim, dtype=dtype)
        self.norm_out = LayerNorm32(output_dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, heads, dim_head, dtype),
                           _FeedForward(dim, ff_mult, dtype)]) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, L, C) per-frame tokens -> (B, T*num_queries, output_dim)
        float32, or (B, L, C) -> (B, num_queries, output_dim)."""
        latents0 = self.latents.to(self.dtype)
        framewise = x.dim() == 4
        if framewise:
            b, t, l, c = x.shape
            x = x.reshape(b * t, l, c)
            latents = latents0.expand(b, -1, -1).reshape(b * t, self.num_queries, self.dim)
        else:
            b = x.shape[0]
            latents = latents0.expand(b, -1, -1)
        x = self.proj_in(x.to(self.dtype))
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            latents = latents + ff(latents)
        latents = self.norm_out(self.proj_out(latents))
        if framewise:
            latents = latents.reshape(b, t * self.num_queries, self.output_dim)
        return latents.float()
