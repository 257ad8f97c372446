"""Per-pixel tiny-sequence self-attention, heads-packed layout: kernel K3.

`temporal_attention(q, k, v, n_heads)` takes q/k/v of shape (P, N, C) with
C = n_heads * d, straight off the QKV projections (no head split), and runs
P * n_heads independent N x N attentions. On a CUDA tensor it launches
csrc/temporal_attention.cu (one warp per pixel and head); on a CPU tensor
it runs `temporal_attention_plain`.
"""

from __future__ import annotations

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

MAX_SEQ = 32
MAX_HEAD_DIM = 128


def temporal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             n_heads: int) -> torch.Tensor:
    """PyTorch ops with the algebra of the JAX XLA path (plain per-pixel
    attention, geo4d_tpu/nn/attention.py::dot_product_attention): f32
    logits and softmax, weights cast to v's dtype."""
    stats.note_plain(q)
    p, n, c = q.shape
    d = c // n_heads

    def split(t):
        return t.reshape(p, n, n_heads, d).float()

    logits = torch.einsum("pqhd,pkhd->phqk", split(q), split(k)) * d ** -0.5
    weights = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("phqk,pkhd->pqhd", weights, split(v))
    return out.reshape(p, n, c).to(v.dtype)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       n_heads: int) -> torch.Tensor:
    """q/k/v: (P, N, C), C = n_heads * d -> (P, N, C)."""
    if not use_kernel(q):
        return temporal_attention_plain(q, k, v, n_heads)
    p, n, c = q.shape
    require(c % n_heads == 0, f"C={c} not divisible by {n_heads} heads")
    d = c // n_heads
    require(1 <= n <= MAX_SEQ and d % 8 == 0 and d <= MAX_HEAD_DIM,
            f"need N <= {MAX_SEQ}, d % 8 == 0, d <= {MAX_HEAD_DIM}; got N={n}, d={d}")
    for t in (q, k, v):
        require(t.shape == (p, n, c) and t.dtype == torch.bfloat16 and t.is_contiguous()
                and t.data_ptr() % 16 == 0 and t.device == q.device,
                "q/k/v must be contiguous, 16-byte aligned bf16 (P, N, C) on one device")
    o = torch.empty_like(q)
    err = kernels().temporal_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       p, n, c, d, d ** -0.5, stream_handle(q))
    check_launch("temporal_attention", err)
    stats.note_launch((p, n, c, n_heads))
    return o
