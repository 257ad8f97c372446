"""OpenCLIP ViT-H-14 text and vision towers and the vision preprocessing,
port of geo4d_tpu/nn/clip.py.

`CLIPTextEncoder` turns 77 token ids into the (B, 77, 1024) text context;
the pipeline computes it once per prompt. `CLIPVisionEncoder` returns the
full (B, 257, 1280) token sequence after the transformer: no ln_post,
projection or pooling. Parameter names follow OpenCLIP's state dicts.

`clip_preprocess` resizes to 224 x 224 with the resampling jax.image.resize
does for method "cubic": a Keys cubic kernel (a = -0.5) that is widened by
the inverse scale when downsampling (antialiasing), half-pixel centres,
weights renormalised per output sample. torch's bicubic interpolate uses
a = -0.75 and no antialias, so the separable weights are built here in numpy
and applied as two small matrix products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geo4d_ref.nn.attention import dot_product_attention
from geo4d_ref.nn.basics import LayerNorm32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_SIZE = 224


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = x.dtype.type
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out)


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of the antialiased Keys-cubic
    resize along one axis, computed in float32 step for step as
    jax.image.resize computes its weight matrix."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def clip_preprocess(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] frames (B, H, W, 3) -> (B, 224, 224, 3) CLIP-normalised, f32."""
    _, h, w, _ = frames.shape
    x = frames.float()
    if h != CLIP_SIZE:
        wh = torch.from_numpy(resize_weights(h, CLIP_SIZE)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if w != CLIP_SIZE:
        ww = torch.from_numpy(resize_weights(w, CLIP_SIZE)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class MultiheadSelfAttention(nn.Module):
    """Self-attention with a fused qkv projection (`in_proj_weight/bias`)."""

    def __init__(self, dim: int, heads: int, dtype=torch.bfloat16):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, dtype=dtype))
        self.out_proj = nn.Linear(dim, dim, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)

        def split(t):
            return t.reshape(b, n, self.heads, d // self.heads)

        out = dot_product_attention(split(q), split(k), split(v), causal=causal)
        return self.out_proj(out.reshape(b, n, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm32(dim)
        self.attn = MultiheadSelfAttention(dim, heads, dtype)
        self.ln_2 = LayerNorm32(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(dim, hidden, dtype=dtype),
                                  "c_proj": nn.Linear(hidden, dim, dtype=dtype)})

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x).to(self.dtype), causal=causal)
        h = F.gelu(self.mlp["c_fc"](self.ln_2(x).to(self.dtype)))
        return x + self.mlp["c_proj"](h)


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype=dtype) for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """Causal text transformer -> (B, 77, width) float32 context: the
    penultimate layer's output (23 of 24 blocks; only those are built) and
    ln_final. Token and positional embeddings are float32, cast to the
    compute dtype at use. Parameter names follow OpenCLIP's text tower.

    The attention (77 tokens, 64 per head) is plain PyTorch: it is outside
    kernel K2's gate, and the JAX package ran it through XLA too."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024, heads: int = 16,
                 layers: int = 24, context_length: int = 77, penultimate: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width, dtype=torch.float32)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = _Transformer(width, heads, layers - 1 if penultimate else layers, dtype)
        self.ln_final = LayerNorm32(width)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(token_ids).to(self.dtype) \
            + self.positional_embedding.to(self.dtype)[None]
        for block in self.transformer.resblocks:
            x = block(x, causal=True)
        return self.ln_final(x)


class _VisionTower(nn.Module):
    def __init__(self, width, heads, layers, patch_size, image_size, dtype):
        super().__init__()
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.randn(width) * 0.02)
        self.positional_embedding = nn.Parameter(torch.randn(grid * grid + 1, width) * 0.02)
        self.ln_pre = LayerNorm32(width)
        self.transformer = _Transformer(width, heads, layers, dtype)


class CLIPVisionEncoder(nn.Module):
    """ViT tower -> (B, 1 + grid^2, width) float32 tokens."""

    def __init__(self, width: int = 1280, heads: int = 16, layers: int = 32,
                 patch_size: int = 14, image_size: int = CLIP_SIZE, dtype=torch.bfloat16):
        super().__init__()
        self.width, self.dtype = width, dtype
        self.visual = _VisionTower(width, heads, layers, patch_size, image_size, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, 224, 224, 3) from `clip_preprocess`."""
        vis = self.visual
        b = images.shape[0]
        x = vis.conv1(images.to(self.dtype).permute(0, 3, 1, 2))      # (B, W, g, g)
        x = x.flatten(2).transpose(1, 2)                              # (B, g*g, W)
        cls = vis.class_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + vis.positional_embedding.to(x.dtype)[None]
        x = vis.ln_pre(x).to(self.dtype)
        for block in vis.transformer.resblocks:
            x = block(x)
        return x.float()
