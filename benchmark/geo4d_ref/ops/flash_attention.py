"""Spatial attention in plain PyTorch ops (the port's
`flash_attention_plain`), with the port's routing gate kept so that the
copied attention modules route as the port's do."""

from __future__ import annotations

import torch

HEAD_DIM = 64
Q_TILE = 64


def fits(nq: int, nk: int, d: int) -> bool:
    """The port's gate for its spatial-attention kernel."""
    return nq >= 512 and nq % Q_TILE == 0 and d == HEAD_DIM and nk <= 4096 and nk % 16 == 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Nq, H, D), k/v: (B, Nk, H, D) -> (B, Nq, H, D): f32 logits and
    softmax, weights cast to v's dtype before the weighted sum."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(v.dtype)
