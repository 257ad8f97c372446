"""Attention stack: cross/self attention, spatial and temporal transformers.

Routing by shape, fixed before launch (as geo4d_tpu/nn/attention.py routes):

  * self-attention over at most 32 tokens (the temporal path, N = 16
    frames) -> kernel K3 on the heads-packed (P, N, C) projections;
  * unmasked attention that passes `flash_attention.fits` (spatial
    self-attention at the two finest levels, and the 16-token image stream)
    -> kernel K2;
  * everything else (text cross-attention with 77 keys, the coarse spatial
    levels, and temporal attention with the causal mask or the relative
    position embeddings) -> `dot_product_attention` or the relative-position
    path, plain PyTorch, where the JAX package used XLA.

Module and parameter names follow the original Geo4D PyTorch code, so its
state dicts (and the tests' weights bridge from the JAX package) load directly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geo4d_ref.nn.basics import GroupNorm32, LayerNorm32, zero_
from geo4d_ref.ops import flash_attention as fa
from geo4d_ref.ops.temporal_attention import temporal_attention

TEXT_CONTEXT_LEN = 77
TEMPORAL_MAX_SEQ = 32


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """Plain multi-head attention over (B, N, H, D): f32 logits and softmax,
    weights cast to v's dtype before the weighted sum, output in v's dtype.
    `causal` masks keys after the query (logits set to the float32 minimum)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(v.dtype)


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) attention: kernel K2 where its gate holds, else plain."""
    if fa.fits(q.shape[1], k.shape[1], q.shape[-1]):
        return fa.flash_attention(q, k, v)
    return dot_product_attention(q, k, v)


class RelativePosition(nn.Module):
    """Learned relative-position embeddings: a (2 max_relative_position + 1,
    num_units) table indexed by the key-query distance, clipped to
    +-max_relative_position."""

    def __init__(self, num_units: int, max_relative_position: int, dtype=torch.bfloat16):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(
            torch.empty(2 * max_relative_position + 1, num_units, dtype=dtype))
        nn.init.xavier_uniform_(self.embeddings_table)

    def forward(self, length_q: int, length_k: int) -> torch.Tensor:
        """(length_q, length_k, num_units) embeddings of the distances k - q."""
        dev = self.embeddings_table.device
        dist = (torch.arange(length_k, device=dev)[None, :]
                - torch.arange(length_q, device=dev)[:, None])
        m = self.max_relative_position
        return self.embeddings_table[dist.clamp(-m, m) + m]


class CrossAttention(nn.Module):
    """Self or cross attention with the optional image stream: with
    `image_cross_attention`, context is [text (77) | image tokens], the image
    tokens get their own K/V projections, and out = text + scale * image.

    Temporal attention may also take a causal mask (`causal`) and learned
    relative-position K and V embeddings (`relative_position`, distances
    clipped to `temporal_length`)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, image_cross_attention: bool = False,
                 image_cross_attention_scale: float = 1.0, causal: bool = False,
                 relative_position: bool = False, temporal_length: Optional[int] = None,
                 dtype=torch.bfloat16):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.causal, self.relative_position = causal, relative_position
        if relative_position:
            if temporal_length is None:
                raise ValueError("relative_position needs temporal_length")
            self.relative_position_k = RelativePosition(dim_head, temporal_length, dtype)
            self.relative_position_v = RelativePosition(dim_head, temporal_length, dtype)
        self.image_cross_attention = image_cross_attention
        self.image_cross_attention_scale = image_cross_attention_scale
        self.to_q = nn.Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim, dtype=dtype))
        if image_cross_attention:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False, dtype=dtype)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(x)
        ctx_img = None
        if context is None:
            ctx = x
        else:
            ctx = context[:, :TEXT_CONTEXT_LEN]
            if self.image_cross_attention:
                ctx_img = context[:, TEXT_CONTEXT_LEN:]
        k = self.to_k(ctx)
        v = self.to_v(ctx)

        # K3 computes unmasked attention without position terms: the causal
        # and relative-position options take the eager paths below, as they
        # take XLA in the JAX package
        if (context is None and n <= TEMPORAL_MAX_SEQ and not self.causal
                and not self.relative_position):
            return self.to_out(temporal_attention(q, k, v, h))

        def split_heads(t):
            return t.view(t.shape[0], t.shape[1], h, d)

        qh = split_heads(q)
        if self.relative_position:
            out = self._relative_attention(qh, split_heads(k), split_heads(v))
        elif self.causal:
            out = dot_product_attention(qh, split_heads(k), split_heads(v), causal=True)
        else:
            out = spatial_attention(qh, split_heads(k), split_heads(v))
        out = out.reshape(b, n, h * d)
        if ctx_img is not None and ctx_img.shape[1] > 0:
            k_ip = split_heads(self.to_k_ip(ctx_img))
            v_ip = split_heads(self.to_v_ip(ctx_img))
            out_ip = spatial_attention(qh, k_ip, v_ip).reshape(b, n, h * d)
            out = out + self.image_cross_attention_scale * out_ip
        return self.to_out(out)

    def _relative_attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                            ) -> torch.Tensor:
        """(B, N, H, D) attention with relative-position K and V embeddings
        (and the causal mask when set): the position terms add q . e_k(j - i)
        to the logits and sum_j w_ij e_v(j - i) to the output. Products in
        float32 on inputs of the projections' dtype, f32 softmax, weights
        cast to each value operand's dtype, output in v's dtype."""
        n, len_k = q.shape[1], k.shape[1]
        scale = self.dim_head ** -0.5
        qf = q.float()
        e_k = self.relative_position_k(n, len_k).to(q.dtype).float()
        logits = (torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
                  + torch.einsum("bqhd,qkd->bhqk", qf, e_k)) * scale
        if self.causal:
            keep = torch.ones(n, len_k, dtype=torch.bool, device=q.device).tril()
            logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1)
        e_v = self.relative_position_v(n, len_k)
        out = (torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
               + torch.einsum("bhqk,qkd->bqhd", weights.to(e_v.dtype).float(), e_v.float()))
        return out.to(v.dtype)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype=torch.bfloat16):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP; `net.1` is the reference's dropout slot."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.bfloat16):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult, dtype), nn.Identity(),
                                 nn.Linear(dim * mult, dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """pre-LN: self-attn -> cross-attn (self-attn without context) -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, image_cross_attention: bool = False,
                 relative_position: bool = False, temporal_length: Optional[int] = None,
                 causal: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        opts = dict(relative_position=relative_position, temporal_length=temporal_length,
                    causal=causal, dtype=dtype)
        self.attn1 = CrossAttention(dim, heads, dim_head, **opts)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim=context_dim,
                                    image_cross_attention=image_cross_attention, **opts)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x).to(self.dtype))
        x = x + self.attn2(self.norm2(x).to(self.dtype), context=context)
        return x + self.ff(self.norm3(x).to(self.dtype))


class SpatialTransformer(nn.Module):
    """Per-frame attention over H*W tokens of (B, H, W, C) frames: GroupNorm,
    linear in/out projections (zero-init out), residual."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, image_cross_attention: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim,
                                  image_cross_attention, dtype=dtype) for _ in range(depth))
        self.proj_out = zero_(nn.Linear(inner, channels, dtype=dtype))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, hgt, wid, c = x.shape
        h = self.proj_in(self.norm(x).reshape(b, hgt * wid, c))
        for block in self.transformer_blocks:
            h = block(h, context=context)
        return x + self.proj_out(h).reshape(b, hgt, wid, c)


class TemporalTransformer(nn.Module):
    """Per-pixel attention over the T frames of (B, T, H, W, C) clips
    (self-attention only, as shipped; optionally causal and with
    relative-position embeddings up to `temporal_length` apart). The
    GroupNorm is per clip.

    proj_in/proj_out are linear; checkpoints that stored them as kernel-1
    Conv1d weights (O, I, 1) load too."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 relative_position: bool = False, causal: bool = False,
                 temporal_length: Optional[int] = None, dtype=torch.bfloat16):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, relative_position=relative_position,
                                  temporal_length=temporal_length, causal=causal, dtype=dtype)
            for _ in range(depth))
        self.proj_out = zero_(nn.Linear(inner, channels, dtype=dtype))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("proj_in.weight", "proj_out.weight"):
            w = state_dict.get(prefix + name)
            if w is not None and w.dim() == 3:
                state_dict[prefix + name] = w[..., 0]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, hgt, wid, c = x.shape
        h = self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * hgt * wid, t, c)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h)
        h = self.proj_out(h).reshape(b, hgt, wid, t, c).permute(0, 3, 1, 2, 4)
        return x + h
