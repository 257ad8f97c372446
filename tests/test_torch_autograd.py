"""Gradients of the port's kernel ops (K1 GroupNorm(+SiLU), K2 spatial
attention, K3 temporal attention).

On the CPU each op's autograd Function runs its plain forward and, as its
backward, an explicit formula with the backward kernel's algebra
(`*_backward_plain`). These tests hold each formula against
torch.autograd.grad of its plain forward (float32, 2e-6 relative L2: the
same arithmetic in another order) and against jax.grad of the JAX
package's XLA path for the same op (2e-5 relative L2 per gradient: the two
frameworks sum in different orders, and JAX's GroupNorm takes its moments
by another formula).

On the card (`gpu`): each backward kernel against its plain backward at
main-path shapes (bf16; relative L2 within 1e-2, two launches equal bit for
bit), and a gradient through every op reaching a parameter upstream of it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geo4d_tpu_torch.nn.basics import num_groups_for
from geo4d_tpu_torch.ops import flash_attention as fa
from geo4d_tpu_torch.ops import group_norm as gn
from geo4d_tpu_torch.ops import temporal_attention as ta
from _torch_parity import cuda_or_skip, rel_err, to_torch

torch.set_num_threads(1)

AUTOGRAD_REL = 2e-6
JAX_REL = 2e-5
KERNEL_REL = 1e-2      # K2b, K3b: bf16 P and dS
GN_KERNEL_REL = 1e-4   # K1b: f32 sums; dx differs from the plain one by its bf16 rounding

GN_CASES = [((2, 6, 8, 320), False), ((2, 6, 8, 320), True), ((1, 4, 24, 32, 64), True),
            ((3, 5, 7, 32), False)]
FA_CASES = [(64, 16), (128, 64), (64, 80)]       # (Nq, Nk): the image stream's 16 keys
TA_CASES = [(16, 4, 16), (17, 2, 24), (32, 3, 8)]  # (N, heads, d): N = 17 pads a tile


def _gn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    beta = (0.1 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, dy


def _attn_inputs(shapes, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _grads(fn, arrays, cotangent):
    """torch.autograd.grad of sum(fn(*arrays) * cotangent) w.r.t. every array."""
    ts = [to_torch(a).requires_grad_() for a in arrays]
    return [g.numpy() for g in torch.autograd.grad(fn(*ts), ts, to_torch(cotangent))]


def _check(got, want, limit, what):
    for i, (a, b) in enumerate(zip(got, want)):
        err = rel_err(a, b)
        assert err <= limit, f"{what}: gradient {i} relative L2 {err:.3e} > {limit}"


# ---------------- the plain backward formulas against autograd ----------------


@pytest.mark.parametrize("shape,silu", GN_CASES)
def test_group_norm_backward_plain_matches_autograd(shape, silu):
    x, gamma, beta, dy = _gn_inputs(shape)
    g = num_groups_for(shape[-1])
    got = _grads(lambda *a: gn.group_norm(*a, g, 1e-6, silu), (x, gamma, beta), dy)
    want = _grads(lambda *a: gn.group_norm_plain(*a, g, 1e-6, silu), (x, gamma, beta), dy)
    _check(got, want, AUTOGRAD_REL, f"group_norm {shape} silu={silu}")


@pytest.mark.parametrize("nq,nk", FA_CASES)
def test_flash_attention_backward_plain_matches_autograd(nq, nk):
    q, k, v, do = _attn_inputs([(2, nq, 3, 64), (2, nk, 3, 64), (2, nk, 3, 64), (2, nq, 3, 64)])
    got = _grads(fa.flash_attention, (q, k, v), do)
    want = _grads(fa.flash_attention_plain, (q, k, v), do)
    _check(got, want, AUTOGRAD_REL, f"flash_attention nq={nq} nk={nk}")


@pytest.mark.parametrize("n,heads,d", TA_CASES)
def test_temporal_attention_backward_plain_matches_autograd(n, heads, d):
    q, k, v, do = _attn_inputs([(9, n, heads * d)] * 4)
    got = _grads(lambda *a: ta.temporal_attention(*a, heads), (q, k, v), do)
    want = _grads(lambda *a: ta.temporal_attention_plain(*a, heads), (q, k, v), do)
    _check(got, want, AUTOGRAD_REL, f"temporal_attention n={n}")


def test_no_grad_saves_nothing():
    """Without autograd recording the call, the ops return plain tensors
    (no graph, nothing saved)."""
    x = torch.randn(2, 8, 16, requires_grad=True)
    q = torch.randn(1, 64, 1, 64, requires_grad=True)
    with torch.no_grad():
        outs = [gn.group_norm(x, torch.ones(16), torch.zeros(16), 4, 1e-5),
                fa.flash_attention(q, q, q), ta.temporal_attention(x, x, x, 2)]
    assert all(o.grad_fn is None for o in outs)
    assert ta.temporal_attention(x, x, x, 2).grad_fn is not None


# ---------------- against jax.grad of the JAX package's XLA path ----------------


def _jax_vjp(fn, arrays, cotangent):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return [np.asarray(g) for g in jax.jit(vjp)(jnp.asarray(cotangent))]


@pytest.mark.parametrize("shape,silu", GN_CASES)
def test_group_norm_gradient_matches_jax(shape, silu):
    from geo4d_tpu.nn.basics import GroupNorm32 as JaxGroupNorm32

    x, gamma, beta, dy = _gn_inputs(shape, seed=3)
    mod = JaxGroupNorm32(epsilon=1e-6, silu=silu)

    def jax_fn(x, gamma, beta):
        params = {"params": {"GroupNorm_0": {"scale": gamma, "bias": beta}}}
        return mod.apply(params, x)

    want = _jax_vjp(jax_fn, (x, gamma, beta), dy)
    g = num_groups_for(shape[-1])
    got = _grads(lambda *a: gn.group_norm(*a, g, 1e-6, silu), (x, gamma, beta), dy)
    _check(got, want, JAX_REL, f"group_norm {shape} silu={silu} vs jax")


@pytest.mark.parametrize("nq,nk", FA_CASES)
def test_flash_attention_gradient_matches_jax(nq, nk):
    from geo4d_tpu.nn.attention import dot_product_attention as jax_attention

    q, k, v, do = _attn_inputs([(2, nq, 3, 64), (2, nk, 3, 64), (2, nk, 3, 64), (2, nq, 3, 64)],
                               seed=4)
    want = _jax_vjp(lambda *a: jax_attention(*a, use_flash=False), (q, k, v), do)
    got = _grads(fa.flash_attention, (q, k, v), do)
    _check(got, want, JAX_REL, f"flash_attention nq={nq} nk={nk} vs jax")


@pytest.mark.parametrize("n,heads,d", TA_CASES)
def test_temporal_attention_gradient_matches_jax(n, heads, d):
    from geo4d_tpu.nn.attention import dot_product_attention as jax_attention

    p = 9
    q, k, v, do = _attn_inputs([(p, n, heads * d)] * 4, seed=5)

    def jax_fn(q, k, v):
        split = lambda t: t.reshape(p, n, heads, d)  # noqa: E731
        return jax_attention(split(q), split(k), split(v), use_flash=False).reshape(p, n, -1)

    want = _jax_vjp(jax_fn, (q, k, v), do)
    got = _grads(lambda *a: ta.temporal_attention(*a, heads), (q, k, v), do)
    _check(got, want, JAX_REL, f"temporal_attention n={n} vs jax")


# ---------------- on the card: each backward kernel against its plain backward ----------------


def _bf16(g, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)


def _kernel_vs_plain(kernel_grads, plain_grads, tol=KERNEL_REL):
    again = kernel_grads()
    first = kernel_grads()
    for i, (a, b, w) in enumerate(zip(first, again, plain_grads())):
        assert torch.equal(a, b), f"gradient {i}: two launches differ"
        err = rel_err(a.float().cpu().numpy(), w.float().cpu().numpy())
        assert err <= tol, f"gradient {i}: relative L2 {err:.3e} > {tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("shape,silu", [
    ((16, 2304, 320), True), ((16, 36, 2560), True), ((1, 36864, 320), True),   # K1b coop
    ((2, 147456, 128), True), ((1, 36864, 960), False), ((1, 36864, 640), True),  # two-pass
])
def test_group_norm_backward_kernel_matches_plain(shape, silu):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    c = shape[-1]
    groups = num_groups_for(c)
    x = _bf16(g, dev, *shape, scale=2.0).requires_grad_()
    gamma = torch.randn(c, generator=g, device=dev).requires_grad_()
    beta = torch.randn(c, generator=g, device=dev).requires_grad_()
    y = gn.group_norm_plain(x.detach(), gamma.detach(), beta.detach(), groups, 1e-5, silu)
    # a cotangent that follows y: the group means c1, c2 (K1b's cross-tile
    # folds) then carry much of dx, so a wrong fold cannot hide under the limit
    dy = (y.float() + torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)

    def kernel():
        y = gn.group_norm(x, gamma, beta, groups, 1e-5, silu)
        return torch.autograd.grad(y, (x, gamma, beta), dy)

    def plain():
        _, mean, rstd = gn.group_norm_plain_with_stats(x.detach(), gamma.detach(),
                                                       beta.detach(), groups, 1e-5, silu)
        return gn.group_norm_backward_plain(x.detach(), dy, gamma.detach(), beta.detach(),
                                            mean, rstd, groups, silu)

    _kernel_vs_plain(kernel, plain, GN_KERNEL_REL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,nq,nk,h", [
    (16, 2304, 2304, 5), (16, 576, 576, 10), (2, 128, 80, 2),   # K2b wgmma
    (16, 2304, 16, 5), (16, 576, 16, 10),                       # K2b image: query chunks
])
def test_flash_attention_backward_kernel_matches_plain(b, nq, nk, h):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(1)
    q = _bf16(g, dev, b, nq, h, 64).requires_grad_()
    k = _bf16(g, dev, b, nk, h, 64).requires_grad_()
    v = _bf16(g, dev, b, nk, h, 64).requires_grad_()
    do = _bf16(g, dev, b, nq, h, 64)

    def kernel():
        return torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), do)

    def plain():
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        o = fa.flash_attention(qd, kd, vd)
        return fa.flash_attention_backward_plain(qd, kd, vd, o, do, fa.log_sum_exp_plain(qd, kd))

    _kernel_vs_plain(kernel, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,c,heads", [
    (2304, 16, 320, 5), (576, 17, 640, 10), (333, 32, 72, 3),
    (37, 1, 192, 3), (37, 5, 24, 3),            # one frame; five frames at d = 8
    (100, 17, 1280, 10), (37, 32, 384, 3),      # d = 128: a pad row, two full tiles
    (1001, 16, 320, 5),                         # 5005 jobs: blocks of 37 or 38 on 12 warps
])
def test_temporal_attention_backward_kernel_matches_plain(p, n, c, heads):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (_bf16(g, dev, p, n, c).requires_grad_() for _ in range(3))
    do = _bf16(g, dev, p, n, c)

    def kernel():
        return torch.autograd.grad(ta.temporal_attention(q, k, v, heads), (q, k, v), do)

    def plain():
        return ta.temporal_attention_backward_plain(q.detach(), k.detach(), v.detach(), do, heads)

    _kernel_vs_plain(kernel, plain)


@pytest.mark.gpu
def test_gradients_reach_upstream_parameters_on_the_card():
    """A CUDA tensor that requires a gradient gets it through K1b, K2b and
    K3b: a linear layer before each op receives a nonzero gradient, each
    backward kernel launches once, and no plain version runs."""
    dev = cuda_or_skip()
    torch.manual_seed(0)
    lin = torch.nn.Linear(64, 64, dtype=torch.bfloat16, device=dev)
    gamma = torch.ones(64, device=dev, requires_grad=True)
    beta = torch.zeros(64, device=dev, requires_grad=True)
    x = torch.randn(2, 512, 64, device=dev, dtype=torch.bfloat16)
    for s in (gn.stats, fa.stats, ta.stats):
        s.reset()
    h = gn.group_norm(lin(x).contiguous(), gamma, beta, 32, 1e-5, True)
    a = fa.flash_attention(*(h.view(2, 512, 1, 64),) * 3).view(2, 512, 64)
    t = ta.temporal_attention(*(a.reshape(64, 16, 64),) * 3, 4)
    t.float().square().mean().backward()
    assert lin.weight.grad is not None and lin.weight.grad.abs().sum() > 0
    assert gamma.grad.abs().sum() > 0
    assert (gn.stats.backward_launches, fa.stats.backward_launches,
            ta.stats.backward_launches) == (1, 1, 1)
    assert (gn.stats.plain_on_cuda, fa.stats.plain_on_cuda, ta.stats.plain_on_cuda) == (0, 0, 0)
