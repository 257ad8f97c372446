"""Spatial multi-head attention over (B, N, H, D) tensors: kernels K2 and
K2b (its backward).

`flash_attention` computes unmasked softmax(q k^T / sqrt(D)) v. On a CUDA
tensor it launches csrc/flash_attention.cu (128-row q tiles, K/V streamed by
TMA in tiles of `plan`'s BK keys, wgmma products, online softmax); on a CPU
tensor it runs `flash_attention_plain`. `fits` is the shape gate the
attention layer routes by.

When autograd records the call, the forward also writes the softmax's
log-sum-exp per (b, h, query) and keeps q, k, v, o and it; the backward
launches K2b (csrc/flash_attention_bwd.cu: dQ per query tile, which also
writes delta = rowsum(dO o), then dK and dV per key tile, or, for the
16-key image stream, per query chunk with a fixed-order fold; no atomics)
or, on the CPU, `flash_attention_backward_plain`, the same algebra in
PyTorch ops. `backward_plan` gives K2b's launch shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geo4d_tpu_torch.ops.dispatch import (
    SM_COUNT,
    KernelStats,
    check_launch,
    kernels,
    require,
    sm_count,
    stream_handle,
    use_kernel,
    wants_grad,
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


IMAGE_KEYS = 16          # the image stream's keys: K2b's chunked dK/dV path
IMAGE_BLOCKS_PER_SM = 4  # query chunks of that path: about this many 4-warp blocks per SM


class BackwardPlan(NamedTuple):
    """What K2b's C entry point takes beyond the shape. On the "image" path
    (Nk == 16) the dK/dV kernel runs `chunks` blocks per (b, h), each over
    `tiles_per_chunk` 64-query tiles, writing `partial_floats` f32 partials
    that a last launch folds in chunk order. On the "wgmma" path all three
    are 0, and the entry point launches one dQ block per 128 queries and one
    dK/dV block per 128 keys."""
    chunks: int
    tiles_per_chunk: int
    partial_floats: int

    @property
    def path(self) -> str:
        return "image" if self.chunks else "wgmma"


def backward_plan(b: int, nq: int, nk: int, h: int, sms: int = SM_COUNT) -> BackwardPlan:
    """K2b's plan at (B, Nq, Nk, H) on a card of `sms` SMs: the 16-key image
    stream cuts each (b, h)'s Nq / 64 query tiles into chunks so that about
    IMAGE_BLOCKS_PER_SM blocks per SM fill the card."""
    if nk != IMAGE_KEYS:
        return BackwardPlan(0, 0, 0)
    q_tiles = nq // Q_TILE
    want = min(q_tiles, -(-IMAGE_BLOCKS_PER_SM * sms // (b * h)))
    per = -(-q_tiles // want)
    chunks = -(-q_tiles // per)
    return BackwardPlan(chunks, per, chunks * b * h * 2 * IMAGE_KEYS * HEAD_DIM)


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


def log_sum_exp_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, Nq) float32 log-sum-exp of the scaled logits, as K2 writes it."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(logits, dim=-1)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor):
    """(dq, dk, dv) of `flash_attention` for the cotangent do, with K2b's
    algebra: P = exp(q k^T s - lse) in f32; dv = bf16(P)^T do (the weights the
    forward multiplied v by; the gradient passes through the cast unchanged);
    dP = do v^T; delta = rowsum(do o); dS = P (dP - delta); dq = dS k s,
    dk = dS^T q s. Results in q's dtype."""
    stats.note_plain(q)
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)        # (B, H, Nq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _checked(q, k, v):
    b, nq, h, d = q.shape
    nk = k.shape[1]
    require(k.shape == (b, nk, h, d) and v.shape == k.shape, "k/v must be (B, Nk, H, D)")
    require(nk >= 1 and nq % Q_TILE == 0 and d == HEAD_DIM,
            f"need Nq % {Q_TILE} == 0 and D == {HEAD_DIM}, got Nq={nq}, D={d}")
    for t in (q, k, v):
        require(t.dtype == torch.bfloat16 and t.is_contiguous() and t.data_ptr() % 32 == 0
                and t.device == q.device, "q/k/v must be contiguous, 32-byte aligned bf16 on one device")
    return b, nq, nk, h, d


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            with_lse: bool):
    """One K2 launch on CUDA tensors: (o, the (B, H, Nq) f32 log-sum-exp that
    K2b reads, or None)."""
    b, nq, nk, h, d = _checked(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    bk, _ = plan(nq, nk)
    err = kernels().flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                    lse.data_ptr() if with_lse else None,
                                    b, nq, nk, h, d ** -0.5, bk, stream_handle(q))
    check_launch("flash_attention", err)
    stats.note_launch((b, nq, nk, h))
    return o, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor):
    """K2b on CUDA tensors: (dq, dk, dv) for the cotangent do, from the
    forward's output o and log-sum-exp, launched as `backward_plan` says:
    one block per (query tile, h, b) accumulating dQ over every key tile
    (and writing delta = rowsum(do o)), then dK and dV per key tile (wgmma)
    or, for the image stream, per query chunk and a fold of the chunks;
    bf16 products with f32 sums. Repeats bit for bit (no atomics)."""
    b, nq, nk, h, d = _checked(q, k, v)
    for t in (o, do):
        require(t.shape == q.shape and t.dtype == torch.bfloat16 and t.is_contiguous()
                and t.data_ptr() % 32 == 0 and t.device == q.device,
                "o/dO must be contiguous, 32-byte aligned bf16 of q's shape")
    require(lse.shape == (b, h, nq) and lse.dtype == torch.float32 and lse.is_contiguous(),
            "lse must be the forward's (B, H, Nq) float32 log-sum-exp")
    pl = backward_plan(b, nq, nk, h, sm_count(q.device.index))
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    part = torch.empty(pl.partial_floats, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = kernels().flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                        part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                        dv.data_ptr(), b, nq, nk, h, d ** -0.5, pl.chunks,
                                        pl.tiles_per_chunk, stream_handle(q))
    check_launch("flash_attention_bwd", err)
    stats.note_backward((b, nq, nk, h))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if use_kernel(q):
            o, lse = flash_attention_forward(q, k, v, with_lse=True)
        else:
            o, lse = flash_attention_plain(q, k, v), log_sum_exp_plain(q, k)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if use_kernel(q):
            return flash_attention_backward(q, k, v, o, do, lse)
        return flash_attention_backward_plain(q, k, v, o, do, lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Nq, H, D), k/v: (B, Nk, H, D) -> (B, Nq, H, D). When autograd
    records the call the result carries K2b (CPU: the plain backward) as its
    gradient; otherwise nothing is saved."""
    if wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v)
    if not use_kernel(q):
        return flash_attention_plain(q, k, v)
    return flash_attention_forward(q, k, v, with_lse=False)[0]
