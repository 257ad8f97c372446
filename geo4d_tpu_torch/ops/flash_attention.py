"""Spatial multi-head attention over (B, N, H, D) tensors: kernel K2.

`flash_attention` computes unmasked softmax(q k^T / sqrt(D)) v. On a CUDA
tensor it launches csrc/flash_attention.cu (128-row q tiles, K/V streamed by
TMA in tiles of `plan`'s BK keys, wgmma products, online softmax); on a CPU
tensor it runs `flash_attention_plain`. `fits` is the shape gate the
attention layer routes by.
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

HEAD_DIM = 64
Q_TILE = 64      # granularity of the gate
BLOCK_Q = 128    # q rows per kernel block (two warpgroups of 64)


def fits(nq: int, nk: int, d: int) -> bool:
    """Shapes the spatial path sends to this kernel (the JAX gate of
    geo4d_tpu/nn/attention.py and ops/flash_attention.py, with the q axis
    tiled by 64 and D fixed at the UNet's 64)."""
    return nq >= 512 and nq % Q_TILE == 0 and d == HEAD_DIM and nk <= 4096 and nk % 16 == 0


def plan(nq: int, nk: int) -> tuple[int, int]:
    """(keys per K/V tile, q tiles) of a launch. BK = 16 for the 16-token
    image stream (one tile), 128 where it divides Nk, else 64 (the last tile
    is masked where Nk is no multiple of it). The last q tile may be ragged:
    its rows past Nq are read as zeros and not stored."""
    bk = 16 if nk <= 16 else (128 if nk % 128 == 0 else 64)
    return bk, -(-nq // BLOCK_Q)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """PyTorch ops with the algebra of the JAX XLA path
    (geo4d_tpu/nn/attention.py::dot_product_attention): f32 logits and
    softmax, weights cast to v's dtype before the weighted sum."""
    stats.note_plain(q)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
    return out.to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Nq, H, D), k/v: (B, Nk, H, D) -> (B, Nq, H, D)."""
    if not use_kernel(q):
        return flash_attention_plain(q, k, v)
    b, nq, h, d = q.shape
    nk = k.shape[1]
    require(k.shape == (b, nk, h, d) and v.shape == k.shape, "k/v must be (B, Nk, H, D)")
    require(nk >= 1 and nq % Q_TILE == 0 and d == HEAD_DIM,
            f"need Nq % {Q_TILE} == 0 and D == {HEAD_DIM}, got Nq={nq}, D={d}")
    for t in (q, k, v):
        require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 32 == 0
                and t.device == q.device, "q/k/v must be contiguous, 32-byte aligned bf16 on one device")
    o = torch.empty_like(q)
    bk, _ = plan(nq, nk)
    err = kernels().flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    b, nq, nk, h, d ** -0.5, bk, stream_handle(q))
    check_launch("flash_attention", err)
    stats.note_launch((b, nq, nk, h))
    return o
