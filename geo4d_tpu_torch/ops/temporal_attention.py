"""Per-pixel tiny-sequence self-attention, heads-packed layout: kernels K3
and K3b (its backward).

`temporal_attention(q, k, v, n_heads)` takes q/k/v of shape (P, N, C) with
C = n_heads * d, straight off the QKV projections (no head split), and runs
P * n_heads independent N x N attentions ("jobs"). On a CUDA tensor it
launches csrc/temporal_attention.cu (one warp per job, mma.sync products,
each warp's next jobs copied ahead by cp.async into a ring of `stages`
slots) on the launch `plan`; on a CPU tensor it runs
`temporal_attention_plain`.

When autograd records the call, the forward keeps q, k and v (N <= 32, so
the backward recomputes the softmax); the backward launches K3b
(`temporal_attention_bwd` in the same source: K3's warps, rings and
mma.sync products, four tiles a slot, on the launch `backward_plan`; no job
reduces across another) or, on the CPU, `temporal_attention_backward_plain`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from geo4d_tpu_torch.ops.dispatch import (
    SM_COUNT,
    SMEM_PER_BLOCK,
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

MAX_SEQ = 32
MAX_HEAD_DIM = 128
MAX_WARPS = 16   # as csrc/temporal_attention.cu's kMaxWarps
MAX_STAGES = 4   # ... and kMaxStages


class Plan(NamedTuple):
    warps: int            # warps per block, one job each at a time
    stages: int           # job slots in each warp's ring
    smem: int             # dynamic shared memory of a block, bytes
    grid: int             # blocks
    jobs_per_block: int   # most jobs one block takes (blocks differ by at most one)


def row_elems(d: int) -> int:
    """bf16 of one tile row in shared memory: d padded to an odd number of
    16-byte chunks, so the 8 rows of an ldmatrix phase hit 8 bank groups."""
    chunks = d // 8
    return 8 * (chunks if chunks % 2 else chunks + 1)


def job_smem(n: int, d: int, tiles: int = 3) -> int:
    """Bytes of one job slot: `tiles` tiles of 16 * ceil(N / 16) rows (K3:
    q, k and v; K3b: q, k, v and dO)."""
    return tiles * 16 * math.ceil(n / 16) * row_elems(d) * 2


def plan(p: int, n: int, c: int, heads: int, sms: int = SM_COUNT) -> Plan:
    """Launch plan of one call on (P, N, C) with `heads` heads. One block per
    SM at most, each taking a contiguous range of the P * heads jobs; up to
    16 warps, as many as the block has jobs and as leave room for two slots
    each; as many slots per warp (up to 4) as its jobs use and the 227 KB of
    a block's shared memory hold. At N = 16, d = 64 a slot is 6.75 KB: 16
    warps of 2 slots, each with its next job's 6 KB of copies in flight
    while it computes one (faster on the card than 8 warps of 4 slots;
    PERF.md has both)."""
    return _ring_plan(p * heads, job_smem(n, c // heads), sms)


def backward_plan(p: int, n: int, c: int, heads: int, sms: int = SM_COUNT) -> Plan:
    """K3b's launch plan, by `plan`'s rule with slots of four tiles: at
    N = 16, d = 64 a slot is 9 KB, so 12 warps of 2 slots (221 KB), each
    with its next job's 8 KB of copies in flight while it computes one."""
    return _ring_plan(p * heads, job_smem(n, c // heads, tiles=4), sms)


def _ring_plan(jobs: int, slot: int, sms: int) -> Plan:
    grid = min(sms, jobs)
    per_block = math.ceil(jobs / grid)
    warps = max(1, min(MAX_WARPS, per_block, SMEM_PER_BLOCK // (2 * slot)))
    per_warp = math.ceil(per_block / warps)
    stages = max(2, min(MAX_STAGES, per_warp, SMEM_PER_BLOCK // (warps * slot)))
    return Plan(warps, stages, warps * stages * slot, grid, per_block)


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


def temporal_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      do: torch.Tensor, n_heads: int):
    """(dq, dk, dv) of `temporal_attention` for the cotangent do, with K3b's
    algebra: the logits and the f32 softmax P recomputed; dv = bf16(P)^T do
    (the weights the forward multiplied v by); dP = do v^T; dS = P (dP -
    rowsum(dP P)); dq = dS k s, dk = dS^T q s. Results in q's dtype."""
    stats.note_plain(q)
    p, n, c = q.shape
    d = c // n_heads
    scale = d ** -0.5

    def split(t):
        return t.reshape(p, n, n_heads, d).float()

    qf, kf, vf, dof = split(q), split(k), split(v), split(do)
    probs = torch.softmax(torch.einsum("pqhd,pkhd->phqk", qf, kf) * scale, dim=-1)
    dv = torch.einsum("phqk,pqhd->pkhd", probs.to(v.dtype).float(), dof)
    dp = torch.einsum("pqhd,pkhd->phqk", dof, vf)
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    dq = torch.einsum("phqk,pkhd->pqhd", ds, kf) * scale
    dk = torch.einsum("phqk,pqhd->pkhd", ds, qf) * scale
    return tuple(t.reshape(p, n, c).to(q.dtype) for t in (dq, dk, dv))


def _checked(q, k, v, n_heads):
    p, n, c = q.shape
    require(c % n_heads == 0, f"C={c} not divisible by {n_heads} heads")
    d = c // n_heads
    require(p >= 1 and 1 <= n <= MAX_SEQ and d % 8 == 0 and d <= MAX_HEAD_DIM,
            f"need P >= 1, N <= {MAX_SEQ}, d % 8 == 0, d <= {MAX_HEAD_DIM}; "
            f"got P={p}, N={n}, d={d}")
    for t in (q, k, v):
        require(t.shape == (p, n, c) and t.dtype == torch.bfloat16 and t.is_contiguous()
                and t.data_ptr() % 16 == 0 and t.device == q.device,
                "q/k/v must be contiguous, 16-byte aligned bf16 (P, N, C) on one device")
    return p, n, c, d


def _forward_kernel(q, k, v, n_heads):
    p, n, c, d = _checked(q, k, v, n_heads)
    o = torch.empty_like(q)
    pl = plan(p, n, c, n_heads, sm_count(q.device.index))
    err = kernels().temporal_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       p, n, c, d, d ** -0.5, pl.warps, pl.stages, pl.grid,
                                       stream_handle(q))
    check_launch("temporal_attention", err)
    stats.note_launch((p, n, c, n_heads))
    return o


def temporal_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                do: torch.Tensor, n_heads: int):
    """K3b on CUDA tensors: (dq, dk, dv) for the cotangent do, one warp per
    (pixel, head) job recomputing its softmax, on `backward_plan`. Repeats
    bit for bit."""
    p, n, c, d = _checked(q, k, v, n_heads)
    _checked(do, do, do, n_heads)
    require(do.shape == q.shape and do.device == q.device, "dO must have q's shape and device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    pl = backward_plan(p, n, c, n_heads, sm_count(q.device.index))
    err = kernels().temporal_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                           dv.data_ptr(), p, n, c, d, d ** -0.5, pl.warps,
                                           pl.stages, pl.grid, stream_handle(q))
    check_launch("temporal_attention_bwd", err)
    stats.note_backward((p, n, c, n_heads))
    return dq, dk, dv


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_heads):
        if use_kernel(q):
            o = _forward_kernel(q, k, v, n_heads)
        else:
            o = temporal_attention_plain(q, k, v, n_heads)
        ctx.save_for_backward(q, k, v)
        ctx.n_heads = n_heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        do = do.contiguous()
        if use_kernel(q):
            grads = temporal_attention_backward(q, k, v, do, ctx.n_heads)
        else:
            grads = temporal_attention_backward_plain(q, k, v, do, ctx.n_heads)
        return (*grads, None)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       n_heads: int) -> torch.Tensor:
    """q/k/v: (P, N, C), C = n_heads * d -> (P, N, C). When autograd records
    the call the result carries K3b (CPU: the plain backward) as its
    gradient; otherwise nothing is saved."""
    if wants_grad(q, k, v):
        return _TemporalAttention.apply(q, k, v, n_heads)
    if not use_kernel(q):
        return temporal_attention_plain(q, k, v, n_heads)
    return _forward_kernel(q, k, v, n_heads)
