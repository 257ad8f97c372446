"""Least time of one kernel call at its shape, the bound of a roofline share.

A frozen copy of chip_smoke.py's `bound_ms` and `bwd_bound_ms`: the larger
of the bytes the function must move (each input read once, each output
written once) over the memory rate, and its operations over the peak rate of
their type. Shape keys are the port's `KernelStats.by_shape` /
`backward_by_shape` keys: GroupNorm (n, s, c, silu), flash attention (b, nq,
nk, heads) at head size 64, temporal attention (p, n, c, heads).

Peaks of one H100 SXM from NVIDIA's data sheet (dense, 700 W).
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
HEAD_DIM = 64


def _bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forward_bound_s(kernel: str, key) -> tuple:
    """(seconds, "bytes" or "operations") of one forward call."""
    if kernel == "group_norm":
        n, s, c, silu = key
        elems = n * s * c
        return _bound(4 * elems + 8 * c, elems * (9 if silu else 5), PEAK_F32)
    if kernel == "flash_attention":
        b, nq, nk, h = key
        return _bound(2 * HEAD_DIM * h * b * (2 * nq + 2 * nk), 4 * b * h * nq * nk * HEAD_DIM,
                      PEAK_BF16)
    if kernel == "temporal_attention":
        p, n, c, heads = key
        return _bound(2 * 4 * p * n * c, 4 * p * n * n * c, PEAK_BF16)
    raise KeyError(kernel)


def backward_bound_s(kernel: str, key) -> tuple:
    """(seconds, "bytes" or "operations") of one backward call: each input
    read once (x and dy; q, k, v, o, dO and the log-sum-exp) and each
    gradient written once; GroupNorm 10 f32 operations an element (21 with
    the SiLU), attention five products (10 Nq Nk d) in bf16."""
    if kernel == "group_norm":
        n, s, c, silu = key
        elems = n * s * c
        return _bound(6 * elems + 16 * c, elems * (21 if silu else 10), PEAK_F32)
    if kernel == "flash_attention":
        b, nq, nk, h = key
        return _bound(2 * HEAD_DIM * h * b * (4 * nq + 4 * nk) + 4 * b * h * nq,
                      10 * b * h * nq * nk * HEAD_DIM, PEAK_BF16)
    if kernel == "temporal_attention":
        p, n, c, heads = key
        return _bound(2 * 7 * p * n * c, 10 * p * n * n * c, PEAK_BF16)
    raise KeyError(kernel)


# the device kernels of each port kernel, by base name (csrc/*.cu)
FORWARD_KERNELS = {
    "group_norm": ("gn_stats_kernel", "gn_apply_kernel", "gn_resident_kernel"),
    "flash_attention": ("flash_attn_kernel",),
    "temporal_attention": ("temporal_attn_kernel",),
}
BACKWARD_KERNELS = {
    "group_norm": ("gn_bwd_coop_kernel", "gn_bwd_partials_kernel", "gn_bwd_dx_kernel"),
    "flash_attention": ("dq_kernel", "dkdv_kernel", "dkdv_image_kernel", "dkdv_fold_kernel"),
    "temporal_attention": ("temporal_attn_bwd_kernel",),
}


def share(record: dict, kernels, backward: bool = False):
    """Percent of the roofline that `kernels` reach in the traced window:
    the sum over their calls of the bound, over the device time of their
    device kernels. None where they did not run."""
    launches = record["backward_launches" if backward else "launches"]
    names = BACKWARD_KERNELS if backward else FORWARD_KERNELS
    bound = backward_bound_s if backward else forward_bound_s
    bound_s = sum(n * bound(k, key)[0] for k in kernels for key, n in launches.get(k, {}).items())
    device_s = sum(record["device_s_by_name"].get(name, 0.0) for k in kernels for name in names[k])
    if bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
