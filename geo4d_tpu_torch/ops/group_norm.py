"""GroupNorm (+ optional SiLU) on channels-last activations: kernel K1.

`group_norm` normalises x viewed as (N, S, C), with N = x.shape[0] and S
the product of the middle axes: statistics per (n, group) over S x C/G in
float32, then one affine y = x * a + b (+ silu) in x.dtype. On a CUDA tensor
it launches csrc/group_norm.cu; on a CPU tensor it runs `group_norm_plain`.
`plan` picks the kernel path from (N, S, C): one resident launch (x read
once into shared memory, a grid-wide barrier, y written from shared memory)
where every block's slice fits its shared memory, else two passes (partial
sums per tile, then fold and apply).
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
)

stats = KernelStats()

_TARGET_BLOCKS = 1056   # 8 blocks for each of the H100's 132 SMs
_MAX_TILES = 128        # caps the partial-sum fold each apply block reads
_MAX_CHANNELS = 4096


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """The same function in PyTorch ops, with the algebra of the JAX XLA path
    (geo4d_tpu/nn/basics.py::_FusedGroupNorm): per-channel f32 moments,
    group combine, one per-channel affine."""
    stats.note_plain(x)
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
    return y.to(x.dtype).reshape(x.shape)


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

    return stats_pass, apply_pass, y


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
    return _two_pass(x, gamma, beta, groups, eps, silu, n, s, c, t, rows)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over the last axis of channels-last `x` (+ optional SiLU).

    gamma/beta: (C,) float32. Returns a tensor of x's shape and dtype.
    """
    if not use_kernel(x):
        return group_norm_plain(x, gamma, beta, groups, eps, silu)
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
        stats_pass, apply_pass, y = _two_pass(x, gamma, beta, groups, eps, silu,
                                              n, s, c, t, rows)
        stats_pass()
        apply_pass()
    stats.note_launch((n, s, c, bool(silu)))
    return y
