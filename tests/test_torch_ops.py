"""The PyTorch port's kernel modules against the JAX package's CPU path.

On the CPU each wrapper runs its kernel's plain version; these tests hold
that plain version against the XLA path tier-1 runs for the same op:
GroupNorm32 (geo4d_tpu/nn/basics.py), dot_product_attention with the
Pallas kernel off, and the tiny-sequence attention path of CrossAttention.
Tolerance: 1e-5 abs (+1e-5 rel) in float32; the two sides sum in
different orders.

The kernel-against-plain cases need the card: they are marked `gpu` and
skip here. The JAX package's flax modules are imported inside the tests that
use them, so the `gpu` cases also run where flax is not installed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geo4d_tpu_torch.ops import dispatch
from geo4d_tpu_torch.ops import flash_attention as fa
from geo4d_tpu_torch.ops import group_norm as gn
from geo4d_tpu_torch.ops import temporal_attention as ta
from geo4d_tpu_torch.nn.basics import num_groups_for
from _torch_parity import assert_close, cuda_or_skip, to_torch

torch.set_num_threads(1)

F32_ATOL = 1e-5
F32_RTOL = 1e-5


def _jax_group_norm(x, gamma, beta, eps, silu):
    from geo4d_tpu.nn.basics import GroupNorm32 as JaxGroupNorm32

    mod = JaxGroupNorm32(epsilon=eps, silu=silu)
    params = {"params": {"GroupNorm_0": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}}
    return np.asarray(jax.jit(mod.apply)(params, jnp.asarray(x)))


@pytest.mark.parametrize("shape", [
    (2, 6, 8, 320),        # C = 320, cg = 10 (C not a multiple of 128)
    (2, 4, 4, 960),        # C = 960, cg = 30
    (1, 4, 24, 32, 320),   # per-clip row: N = 1, S = 3072
    (3, 5, 7, 32),         # tiny-preset width, cg = 1
])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_plain_matches_jax(shape, silu):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    want = _jax_group_norm(x, gamma, beta, 1e-6, silu)
    got = gn.group_norm(to_torch(x), to_torch(gamma), to_torch(beta),
                        num_groups_for(c), 1e-6, silu)
    assert got.dtype == torch.float32
    assert_close(got, want, F32_ATOL, F32_RTOL, f"group_norm {shape} silu={silu}")


@pytest.mark.parametrize("nq,nk", [(64, 16), (96, 96)])
def test_spatial_attention_plain_matches_jax(nq, nk):
    from geo4d_tpu.nn.attention import dot_product_attention as jax_attention

    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, n, 3, 64)).astype(np.float32) for n in (nq, nk, nk))
    want = np.asarray(jax.jit(lambda *a: jax_attention(*a, use_flash=False))(q, k, v))
    got = fa.flash_attention(to_torch(q), to_torch(k), to_torch(v))
    assert_close(got, want, F32_ATOL, F32_RTOL, f"flash_attention plain nq={nq} nk={nk}")


@pytest.mark.parametrize("n,heads,d", [
    (16, 5, 64), (4, 2, 16),
    (32, 3, 24), (17, 2, 8), (1, 2, 128),   # the edges of the kernel's gate
])
def test_temporal_attention_plain_matches_jax(n, heads, d):
    from geo4d_tpu.nn.attention import dot_product_attention as jax_attention

    rng = np.random.default_rng(2)
    p = 37
    q, k, v = (rng.normal(size=(p, n, heads * d)).astype(np.float32) for _ in range(3))

    def jax_tiny_seq(q, k, v):  # CrossAttention's CPU route for n <= 32
        split = lambda t: t.reshape(p, n, heads, d)
        return jax_attention(split(q), split(k), split(v)).reshape(p, n, heads * d)

    want = np.asarray(jax.jit(jax_tiny_seq)(q, k, v))
    got = ta.temporal_attention(to_torch(q), to_torch(k), to_torch(v), heads)
    assert_close(got, want, F32_ATOL, F32_RTOL, f"temporal_attention plain n={n}")


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(2, 8, 16)
    for s in (gn.stats, fa.stats, ta.stats):
        s.reset()
    gn.group_norm(x, torch.ones(16), torch.zeros(16), 4, 1e-5)
    q = torch.randn(1, 512, 1, 64)
    fa.flash_attention(q, q, q)
    ta.temporal_attention(x, x, x, 2)
    assert (gn.stats.launches, fa.stats.launches, ta.stats.launches) == (0, 0, 0)
    assert (gn.stats.plain_on_cuda, fa.stats.plain_on_cuda, ta.stats.plain_on_cuda) == (0, 0, 0)


def test_other_devices_raise():
    with pytest.raises(RuntimeError, match="no kernel route"):
        dispatch.use_kernel(torch.empty(2, device="meta"))


@pytest.mark.parametrize("n,s,c", [(16, 2304, 320), (1, 36864, 320), (48, 147456, 128),
                                   (2, 48, 32)])
def test_group_norm_tiling_covers_rows(n, s, c):
    t, rows = gn.tiling(n, s, c)
    assert 1 <= t <= 128 and (t - 1) * rows < s <= t * rows


# ---------------- on the card: each kernel against its plain version ----------------

BF16_ATOL = 2 ** -6   # bf16 keeps 8 bits: one or two output ulps, plus the
BF16_RTOL = 2 ** -7   # f32 summation order (and, for K2, the online softmax)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 2304, 320), (1, 36864, 960), (2, 100, 40)])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_kernel_matches_plain(shape, silu):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
    gamma = torch.randn(shape[-1], generator=g, device=dev)
    beta = torch.randn(shape[-1], generator=g, device=dev)
    groups = num_groups_for(shape[-1])
    got = gn.group_norm(x, gamma, beta, groups, 1e-5, silu)
    want = gn.group_norm_plain(x, gamma, beta, groups, 1e-5, silu)
    assert_close(got.float(), want.float().cpu().numpy(), BF16_ATOL, BF16_RTOL, "group_norm kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nk,h", [(2304, 2304, 5), (576, 16, 10)])
def test_flash_attention_kernel_matches_plain(nq, nk, h):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, n, h, 64, generator=g, device=dev).to(torch.bfloat16)
               for n in (nq, nk, nk))
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    assert_close(got.float(), want.float().cpu().numpy(), BF16_ATOL, BF16_RTOL, "flash kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("p,c,heads", [(2304, 320, 5), (144, 1280, 20)])
def test_temporal_attention_kernel_matches_plain(p, c, heads):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(p, 16, c, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    got = ta.temporal_attention(q, k, v, heads)
    want = ta.temporal_attention_plain(q, k, v, heads)
    assert_close(got.float(), want.float().cpu().numpy(), BF16_ATOL, BF16_RTOL, "temporal kernel")
