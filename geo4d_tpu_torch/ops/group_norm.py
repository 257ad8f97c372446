"""GroupNorm (+ optional SiLU) on channels-last activations: kernels K1 and
K1b (its backward).

`group_norm` normalises x viewed as (N, S, C), with N = x.shape[0] and S
the product of the middle axes: statistics per (n, group) over S x C/G in
float32, then one affine y = x * a + b (+ silu) in x.dtype. On a CUDA tensor
it launches csrc/group_norm.cu; on a CPU tensor it runs `group_norm_plain`.
`plan` picks the kernel path from (N, S, C): one resident launch (x read
once into shared memory, a grid-wide barrier, y written from shared memory)
where every block's slice fits its shared memory, else two passes (partial
sums per tile, then fold and apply).

When autograd records the call, `group_norm` is a `torch.autograd.Function`:
the forward keeps x, gamma, beta and the per-(n, tile, group) partial sums
the forward kernel wrote (on the CPU: the per-(n, group) mean and rstd),
and the backward launches K1b (`gn_backward` in csrc/group_norm.cu, on the
path `backward_plan` picks: one cooperative launch where the forward is
resident, else two passes; per-(n, tile) partial sums per channel and per
group, fixed-order folds, then dx) or, on the CPU,
`group_norm_backward_plain`, the same algebra in PyTorch ops.
"""

from __future__ import annotations

import math

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

_TARGET_BLOCKS = 1056   # 8 blocks for each of the H100's 132 SMs
_MAX_TILES = 128        # caps the partial-sum fold each apply block reads
_MAX_CHANNELS = 4096


def group_norm_plain_with_stats(x, gamma, beta, groups, eps, silu):
    """`group_norm_plain` and its per-(n, group) mean and rstd, (N, G) f32."""
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    x3 = x.reshape(n, -1, c)
    xf = x3.float()
    mean_c = xf.mean(dim=1)                                   # (N, C)
    mean2_c = (xf * xf).mean(dim=1)
    mean_g = mean_c.view(n, groups, cg).mean(-1)              # (N, G)
    mean2_g = mean2_c.view(n, groups, cg).mean(-1)
    var_g = torch.clamp(mean2_g - mean_g * mean_g, min=0.0)
    rstd_g = torch.rsqrt(var_g + eps)
    rstd_c = rstd_g.repeat_interleave(cg, dim=-1)             # (N, C)
    shift_c = (mean_g * rstd_g).repeat_interleave(cg, dim=-1)
    a = rstd_c * gamma.float()[None]
    b = beta.float()[None] - shift_c * gamma.float()[None]
    y = xf * a[:, None] + b[:, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape), mean_g, rstd_g


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """The same function in PyTorch ops, with the algebra of the JAX XLA path
    (geo4d_tpu/nn/basics.py::_FusedGroupNorm): per-channel f32 moments,
    group combine, one per-channel affine."""
    stats.note_plain(x)
    return group_norm_plain_with_stats(x, gamma, beta, groups, eps, silu)[0]


def group_norm_backward_plain(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                              groups: int, silu: bool = False):
    """(dx, dgamma, dbeta) of `group_norm` at x for the cotangent dy, from the
    per-(n, group) mean and rstd (N, G), with K1b's algebra: xhat = (x - mean)
    * rstd and z = xhat * gamma + beta recomputed; dz = dy (times the SiLU's
    derivative sigma(z) (1 + z (1 - sigma(z))) with `silu`); per channel the
    sums of dz (dbeta) and dz * xhat (dgamma); per group the means c1 of
    dz * gamma * xhat and c2 of dz * gamma; dx = rstd (dz gamma - c2 - xhat c1).
    dx in x's dtype, dgamma and dbeta float32."""
    stats.note_plain(x)
    n, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xf = x.reshape(n, -1, c).float()
    dyf = dy.reshape(n, -1, c).float()
    g, b = gamma.float(), beta.float()

    def per_channel(t):                                       # (N, G) -> (N, 1, C)
        return t.repeat_interleave(cg, dim=-1)[:, None]

    rstd_c = per_channel(rstd)
    xhat = (xf - per_channel(mean)) * rstd_c
    dz = dyf
    if silu:
        z = xhat * g + b
        sig = torch.sigmoid(z)
        dz = dyf * sig * (1.0 + z * (1.0 - sig))
    sum_dz = dz.sum(dim=1)                                    # (N, C)
    sum_dzx = (dz * xhat).sum(dim=1)
    count = xf.shape[1] * cg
    c1 = (sum_dzx * g).view(n, groups, cg).sum(-1) / count    # (N, G)
    c2 = (sum_dz * g).view(n, groups, cg).sum(-1) / count
    dx = rstd_c * (dz * g - per_channel(c2) - xhat * per_channel(c1))
    return dx.to(x.dtype).reshape(x.shape), sum_dzx.sum(0), sum_dz.sum(0)


def tiling(n: int, s: int, c: int) -> tuple[int, int]:
    """(tiles per n, rows per tile) for the two kernel passes."""
    vecs = c // 8
    rows_in_flight = 4 * (512 // vecs)   # 4 = the kernels' row unroll
    t = max(1, min(_MAX_TILES, math.ceil(_TARGET_BLOCKS / n),
                   math.ceil(s / rows_in_flight)))
    rows = math.ceil(s / t)
    return math.ceil(s / rows), rows


def block_threads(c: int) -> int:
    """Threads of a block: C / 8 channel vectors times as many rows as fit 512."""
    vecs = c // 8
    return vecs * (512 // vecs)


def resident_smem(rows: int, c: int, groups: int) -> int:
    """Shared memory of a resident block (as csrc/group_norm.cu sizes it): the
    slice in bf16, the row reduction in f32, mean and rstd per group."""
    return rows * c * 2 + (block_threads(c) // (c // 8)) * 2 * c * 4 + 2 * groups * 4


def max_resident_rows(c: int, groups: int) -> int:
    """Most rows of C channels one resident block can hold."""
    return (SMEM_PER_BLOCK - resident_smem(0, c, groups)) // (2 * c)


def plan(n: int, s: int, c: int, groups: int, sms: int = SM_COUNT) -> tuple[str, int, int]:
    """(path, tiles per n, rows per tile). "resident" when the N x tiles
    blocks fit one per SM and each block's slice fits its shared memory, else
    "two_pass" with `tiling`'s tiles."""
    if n <= sms:
        rows = math.ceil(s / (sms // n))
        if rows <= max_resident_rows(c, groups):
            return "resident", math.ceil(s / rows), rows
    return ("two_pass", *tiling(n, s, c))


def backward_plan(n: int, s: int, c: int, groups: int,
                  sms: int = SM_COUNT) -> tuple[str, int, int]:
    """(path, tiles per n, rows per tile) of K1b. "coop" (one cooperative
    launch, x held in shared memory across a grid-wide barrier) on the
    tiling of `plan`'s "resident" path, with the same shared memory per
    block; else "two_pass" (two launches) on one wave of blocks: about one
    per SM (a backward block holds ~128 registers a thread, so an SM runs
    one), each streaming its rows, so that no wave waits on another's
    latency."""
    path, t, rows = plan(n, s, c, groups, sms)
    if path == "resident":
        return "coop", t, rows
    rows = math.ceil(s / max(1, sms // n))
    return "two_pass", math.ceil(s / rows), rows


def backward_scratch_floats(n: int, c: int, groups: int, tiles: int) -> int:
    """f32 scratch of one K1b call: per block (n, tile) its sums of dz and dz
    * xhat per channel, and of dz gamma xhat and dz gamma per group."""
    return 2 * n * tiles * (c + groups)


def _checked(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             groups: int) -> tuple[int, int, int]:
    """(N, S, C) of a tensor the kernels take; raises on anything else."""
    n, c = x.shape[0], x.shape[-1]
    require(x.dim() >= 2, f"x must be (N, ..., C), got {tuple(x.shape)}")
    require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
    require(x.is_contiguous() and x.data_ptr() % 16 == 0,
            "x must be contiguous and 16-byte aligned")
    require(c % 8 == 0 and c <= _MAX_CHANNELS and c % groups == 0
            and groups <= block_threads(c),
            f"C={c} must be a multiple of 8, <= {_MAX_CHANNELS}, divisible by G={groups}, "
            f"and G <= {block_threads(c)} (a thread per group folds the partial sums)")
    for p in (gamma, beta):
        require(p.dtype == torch.float32 and p.shape == (c,) and p.is_contiguous()
                and p.device == x.device, "gamma/beta must be contiguous f32 (C,) on x's device")
    s = x.numel() // (n * c)
    require(s > 0, "empty input")
    return n, s, c


def _two_pass(x, gamma, beta, groups, eps, silu, n, s, c, t, rows):
    part = torch.empty((2, n, t, groups), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    lib, stream = kernels(), stream_handle(x)

    def stats_pass():
        check_launch("gn_stats", lib.gn_stats(
            x.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            n, s, c, groups, t, rows, stream))

    def apply_pass():
        check_launch("gn_apply", lib.gn_apply(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), y.data_ptr(), n, s, c, groups, t, rows,
            float(eps), int(silu), stream))

    return stats_pass, apply_pass, y, part


def two_pass_launches(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      groups: int, eps: float, silu: bool = False):
    """The two launches of the two-pass path, each on its own: returns
    (stats_pass, apply_pass, y). `stats_pass()` writes the per-tile partial
    sums, `apply_pass()` folds them and writes y, on buffers allocated here.
    `group_norm` runs the same pair in order; chip_smoke.py times each pass
    alone. A CUDA tensor of a shape `plan` sends to the two-pass path only;
    the launches are not counted in `stats`."""
    require(x.is_cuda, "the passes launch on a CUDA tensor")
    n, s, c = _checked(x, gamma, beta, groups)
    path, t, rows = plan(n, s, c, groups, sm_count(x.device.index))
    require(path == "two_pass", f"(N, S, C) = {(n, s, c)} takes the resident path")
    return _two_pass(x, gamma, beta, groups, eps, silu, n, s, c, t, rows)[:3]


def group_norm_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       groups: int, eps: float, silu: bool = False):
    """One K1 call on a CUDA tensor: (y, the per-(n, tile, group) partial sums
    (2, N, T, G) that K1b folds)."""
    n, s, c = _checked(x, gamma, beta, groups)
    path, t, rows = plan(n, s, c, groups, sm_count(x.device.index))
    if path == "resident":
        part = torch.empty((2, n, t, groups), dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        check_launch("gn_resident", kernels().gn_resident(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), y.data_ptr(), n, s, c, groups, t, rows,
            float(eps), int(silu), stream_handle(x)))
    else:
        stats_pass, apply_pass, y, part = _two_pass(x, gamma, beta, groups, eps, silu,
                                                    n, s, c, t, rows)
        stats_pass()
        apply_pass()
    stats.note_launch((n, s, c, bool(silu)))
    return y, part


def group_norm_backward(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, part: torch.Tensor, groups: int, eps: float,
                        silu: bool = False):
    """K1b on CUDA tensors: (dx, dgamma, dbeta) of `group_norm` at x for the
    cotangent dy, from the forward's partial sums `part` (2, N, T_fwd, G),
    which K1b folds in the forward's fixed order. On `backward_plan`'s path:
    "coop" is one cooperative launch (partial sums per (n, tile), a
    grid-wide barrier, then dx and the dgamma / dbeta folds), "two_pass" two
    launches (partial sums, then folds and dx). Repeats bit for bit (no
    atomics)."""
    n, s, c = _checked(x, gamma, beta, groups)
    require(dy.shape == x.shape and dy.dtype == x.dtype and dy.is_contiguous()
            and dy.data_ptr() % 16 == 0 and dy.device == x.device,
            "dy must be a contiguous, 16-byte aligned tensor of x's shape and dtype")
    require(part.dtype == torch.float32 and part.dim() == 4 and part.shape[:2] == (2, n)
            and part.shape[3] == groups and part.is_contiguous(),
            "part must be the forward's (2, N, T, G) float32 partial sums")
    path, t, rows = backward_plan(n, s, c, groups, sm_count(x.device.index))
    scratch = torch.empty(backward_scratch_floats(n, c, groups, t), dtype=torch.float32,
                          device=x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    check_launch("gn_backward", kernels().gn_backward(
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), scratch.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), n, s, c, groups, part.shape[2], t, rows, float(eps), int(silu),
        int(path == "coop"), stream_handle(x)))
    stats.note_backward((n, s, c, bool(silu)))
    return dx, dgamma, dbeta


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, silu):
        if use_kernel(x):
            y, saved = group_norm_forward(x, gamma, beta, groups, eps, silu)
        else:
            stats.note_plain(x)
            y, mean, rstd = group_norm_plain_with_stats(x, gamma, beta, groups, eps, silu)
            saved = torch.stack([mean, rstd])
        ctx.save_for_backward(x, gamma, beta, saved)
        ctx.options = (groups, eps, silu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, saved = ctx.saved_tensors
        groups, eps, silu = ctx.options
        dy = dy.contiguous()
        if use_kernel(x):
            dx, dgamma, dbeta = group_norm_backward(x, dy, gamma, beta, saved, groups, eps, silu)
        else:
            dx, dgamma, dbeta = group_norm_backward_plain(x, dy, gamma, beta, saved[0],
                                                          saved[1], groups, silu)
        return dx, dgamma, dbeta, None, None, None


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last axis of channels-last `x` (+ optional SiLU).

    gamma/beta: (C,) float32. Returns a tensor of x's shape and dtype. When
    autograd records the call the result carries K1b (CPU: the plain
    backward) as its gradient; otherwise nothing is saved.
    """
    if wants_grad(x, gamma, beta):
        return _GroupNorm.apply(x, gamma, beta, groups, eps, silu)
    if not use_kernel(x):
        return group_norm_plain(x, gamma, beta, groups, eps, silu)
    return group_norm_forward(x, gamma, beta, groups, eps, silu)[0]
