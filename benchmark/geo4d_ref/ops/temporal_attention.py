"""Temporal attention in plain PyTorch ops (the port's
`temporal_attention_plain`)."""

from __future__ import annotations

import torch


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       n_heads: int) -> torch.Tensor:
    """q/k/v: (P, N, C), C = n_heads * d -> (P, N, C): f32 logits and
    softmax, weights cast to v's dtype."""
    p, n, c = q.shape
    d = c // n_heads

    def split(t):
        return t.reshape(p, n, n_heads, d).float()

    logits = torch.einsum("pqhd,pkhd->phqk", split(q), split(k)) * d ** -0.5
    weights = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("phqk,pkhd->pqhd", weights, split(v))
    return out.reshape(p, n, c).to(v.dtype)
