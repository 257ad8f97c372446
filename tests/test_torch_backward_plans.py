"""The backward kernels' plans and arithmetic, on the CPU; and, marked `gpu`
(skipped here), K1b and K2b at the edges of those plans.

K1b (csrc/group_norm.cu `gn_backward`) and K2b (csrc/flash_attention_bwd.cu)
cannot run here, so what surrounds them is checked in plain Python and
PyTorch: which path each training shape takes and what it asks of a Hopper
block (`group_norm.backward_plan`, `flash_attention.backward_plan`); the
order in which each kernel adds its partial sums, modelled in float32
against the plain backward; and, with a numpy model of one warpgroup, the
register layouts K2b's wgmma products rely on (the index expressions of the
kernel, written out once more).
"""

import math

import numpy as np
import pytest
import torch

from geo4d_tpu_torch.nn.basics import num_groups_for
from geo4d_tpu_torch.ops import dispatch
from geo4d_tpu_torch.ops import flash_attention as fa
from geo4d_tpu_torch.ops import group_norm as gn
from _torch_parity import cuda_or_skip, rel_err

# (N, S, C, silu) of every K1b launch of one flagship training step (16 x 256
# x 576, batch 1) and of the VAE GAN step (flagship RGB VAE, 2 frames at 256
# x 576), with the path each takes, as chip_smoke.py's backward phase listed
# them on the card (132 SMs)
GN_TRAIN = [
    ((1, 576, 1280, False), "coop"), ((1, 576, 1280, True), "coop"),
    ((1, 2304, 1280, False), "coop"), ((1, 2304, 1280, True), "coop"),
    ((1, 9216, 640, False), "coop"), ((1, 9216, 640, True), "coop"),
    ((1, 36864, 320, False), "coop"), ((1, 36864, 320, True), "coop"),
    ((16, 36, 1280, False), "coop"), ((16, 36, 1280, True), "coop"),
    ((16, 36, 2560, True), "coop"), ((16, 144, 640, True), "coop"),
    ((16, 144, 1280, False), "coop"), ((16, 144, 1280, True), "coop"),
    ((16, 144, 1920, True), "coop"), ((16, 144, 2560, True), "coop"),
    ((16, 576, 320, True), "coop"), ((16, 576, 640, False), "coop"),
    ((16, 576, 640, True), "coop"), ((16, 576, 960, True), "coop"),
    ((16, 576, 1280, True), "coop"), ((16, 576, 1920, True), "two_pass"),
    ((16, 2304, 320, False), "coop"), ((16, 2304, 320, True), "coop"),
    ((16, 2304, 640, True), "two_pass"), ((16, 2304, 960, True), "two_pass"),
]
GN_VAE = [
    ((2, 2304, 512, False), "coop"), ((2, 2304, 512, True), "coop"),
    ((2, 9216, 256, True), "coop"), ((2, 9216, 512, True), "coop"),
    ((2, 36864, 128, True), "coop"), ((2, 36864, 256, True), "two_pass"),
    ((2, 36864, 512, True), "two_pass"), ((2, 147456, 128, True), "two_pass"),
    ((2, 147456, 256, True), "two_pass"),
]
# (B, Nq, Nk, H) of every K2b launch of one training step
FA_TRAIN = [(16, 2304, 2304, 5), (16, 576, 576, 10), (16, 2304, 16, 5), (16, 576, 16, 10)]
# relative L2 of a kernel's gradients against its plain backward on the card:
# K1b sums in f32 (dx differs by its bf16 rounding); K2b multiplies bf16 P, dS
GN_KERNEL_REL = 1e-4
FA_KERNEL_REL = 1e-2


# ---------------- K1b's plan ----------------


@pytest.mark.parametrize("key,want", GN_TRAIN + GN_VAE)
def test_group_norm_backward_plan_at_training_shapes(key, want):
    n, s, c, _ = key
    groups = num_groups_for(c)
    path, t, rows = gn.backward_plan(n, s, c, groups)
    fwd_path, fwd_t, fwd_rows = gn.plan(n, s, c, groups)
    assert path == want
    assert (t - 1) * rows < s <= t * rows
    if path == "coop":   # every block resident: one per SM, the forward's shared memory
        assert fwd_path == "resident" and (t, rows) == (fwd_t, fwd_rows)
        assert n * t <= dispatch.SM_COUNT
        assert gn.resident_smem(rows, c, groups) <= dispatch.SMEM_PER_BLOCK
    else:
        # one wave of blocks that fills more than half the card
        assert path == "two_pass" and fwd_path == "two_pass"
        assert dispatch.SM_COUNT // 2 < n * t <= dispatch.SM_COUNT
    assert gn.backward_scratch_floats(n, c, groups, t) == 2 * n * t * (c + groups)


def test_group_norm_backward_plan_follows_the_card():
    """The cooperative grid needs a block per SM: with fewer SMs a shape
    leaves the coop path rather than asking for blocks that cannot all be
    resident."""
    c, groups = 320, num_groups_for(320)
    rows = gn.max_resident_rows(c, groups)
    assert gn.backward_plan(1, 132 * rows, c, groups, sms=132)[0] == "coop"
    assert gn.backward_plan(1, 132 * rows, c, groups, sms=114)[0] == "two_pass"


# ---------------- K2b's plan ----------------


@pytest.mark.parametrize("b,nq,nk,h", FA_TRAIN)
def test_flash_attention_backward_plan(b, nq, nk, h):
    pl = fa.backward_plan(b, nq, nk, h)
    if nk == fa.IMAGE_KEYS:
        q_tiles = nq // fa.Q_TILE
        assert pl.path == "image"
        # every query tile in exactly one chunk, and no chunk empty
        assert (pl.chunks - 1) * pl.tiles_per_chunk < q_tiles <= pl.chunks * pl.tiles_per_chunk
        # the chunks fill the card: at least two 4-warp blocks per SM
        assert pl.chunks * b * h >= 2 * dispatch.SM_COUNT
        assert pl.partial_floats == pl.chunks * b * h * 2 * 16 * 64
    else:
        assert pl.path == "wgmma"
        assert (pl.chunks, pl.tiles_per_chunk, pl.partial_floats) == (0, 0, 0)


@pytest.mark.parametrize("b,nq,h,chunks,per", [
    (16, 2304, 5, 6, 6),    # 36 tiles for 80 (b, h): 480 blocks
    (16, 576, 10, 3, 3),    # 9 tiles for 160 (b, h): 480 blocks
    (2, 576, 10, 9, 1),     # few (b, h): a chunk per tile
    (1, 64, 1, 1, 1),
])
def test_flash_attention_backward_image_chunks(b, nq, h, chunks, per):
    pl = fa.backward_plan(b, nq, 16, h)
    assert (pl.chunks, pl.tiles_per_chunk) == (chunks, per)


# ---------------- the kernels' orders of summation, in float32 ----------------


def _attn(seed, b=2, nq=256, nk=16, h=3, d=64):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, n, h, d)).astype(np.float32))
                   for n in (nq, nk, nk, nq))
    o = fa.flash_attention_plain(q, k, v)
    return q, k, v, o, do, fa.log_sum_exp_plain(q, k)


@pytest.mark.parametrize("nq,chunks_of", [(256, 1), (256, 3), (576, 2)])
def test_chunked_dkdv_fold_matches_the_plain_backward(nq, chunks_of):
    """The image path's dK/dV: per query chunk, per warp (16 queries of each
    64-query tile), per tile: partial sums, the warps added in order 0..3,
    the chunks added in order by the fold; equal to the plain backward."""
    q, k, v, o, do, lse = _attn(0, nq=nq)
    _, dk_want, dv_want = fa.flash_attention_backward_plain(q, k, v, o, do, lse)
    scale = 64 ** -0.5
    delta = (do * o).sum(-1).transpose(1, 2)                   # (B, H, Nq)
    tiles = nq // 64
    chunk_sums = []
    for c0 in range(0, tiles, chunks_of):
        warp_sums = []
        for w in range(4):
            dk_w = torch.zeros(2, 16, 3, 64)
            dv_w = torch.zeros(2, 16, 3, 64)
            for t in range(c0, min(tiles, c0 + chunks_of)):
                rows = slice(64 * t + 16 * w, 64 * t + 16 * w + 16)
                qs, dos = q[:, rows], do[:, rows]
                st = torch.einsum("bkhd,bqhd->bhkq", k, qs) * scale
                p = torch.exp(st - lse[:, :, None, rows])
                dpt = torch.einsum("bkhd,bqhd->bhkq", v, dos)
                ds = p * (dpt - delta[:, :, None, rows])
                dv_w += torch.einsum("bhkq,bqhd->bkhd", p, dos)
                dk_w += torch.einsum("bhkq,bqhd->bkhd", ds, qs)
            warp_sums.append((dk_w, dv_w))
        dk_c, dv_c = warp_sums[0]
        for dk_w, dv_w in warp_sums[1:]:
            dk_c, dv_c = dk_c + dk_w, dv_c + dv_w
        chunk_sums.append((dk_c, dv_c))
    dk, dv = chunk_sums[0]
    for dk_c, dv_c in chunk_sums[1:]:
        dk, dv = dk + dk_c, dv + dv_c
    assert rel_err(dk.numpy() * scale, dk_want.numpy()) <= 1e-6
    assert rel_err(dv.numpy(), dv_want.numpy()) <= 1e-6


def _param_fold(values, warps=15):
    """What fold_param_partials does with the P partials of a column: warp w
    adds p = w, w + W, ... in order, then the W warps' sums are added in
    order (W = 15 for the 480-thread blocks of most channel counts)."""
    per_warp = []
    for w in range(warps):
        s = torch.zeros_like(values[0])
        for p in range(w, len(values), warps):
            s = s + values[p]
        per_warp.append(s)
    total = per_warp[0]
    for s in per_warp[1:]:
        total = total + s
    return total


def _k1b_model(x, dy, gamma, beta, groups, silu, tiles, fault=None):
    """K1b's folds in float32: per (n, tile) block the sums of dz and dz xhat
    per channel and of dz gamma xhat and dz gamma per group; c1, c2 from the
    group partials added over the tiles in order; dgamma, dbeta from the
    per-channel partials of all (n, tile) blocks in the warps' order. `fault`
    breaks the group fold as a wrong kernel could: "drop" skips tile 1,
    "double" adds it twice, "no_c12" leaves c1 and c2 out of dx."""
    n, s, c = x.shape
    _, mean, rstd = gn.group_norm_plain_with_stats(x, gamma, beta, groups, 1e-5, silu)
    cg = c // groups
    mean_c, rstd_c = mean.repeat_interleave(cg, -1)[:, None], rstd.repeat_interleave(cg, -1)[:, None]
    xhat = (x - mean_c) * rstd_c
    dz = dy
    if silu:
        z = xhat * gamma + beta
        sig = torch.sigmoid(z)
        dz = dy * sig * (1 + z * (1 - sig))
    rows = math.ceil(s / tiles)
    per_channel, per_group = [], []          # indexed by block p = n * T + tile
    for i in range(n):
        for t in range(tiles):
            sl = slice(t * rows, min(s, (t + 1) * rows))
            sdz, sdzx = dz[i, sl].sum(0), (dz[i, sl] * xhat[i, sl]).sum(0)
            per_channel.append((sdz, sdzx))
            per_group.append(((sdzx * gamma).view(groups, cg).sum(-1),
                              (sdz * gamma).view(groups, cg).sum(-1)))
    count = s * cg
    adds = {"drop": 0, "double": 2}.get(fault, 1)
    dx = torch.empty_like(x)
    for i in range(n):
        c1, c2 = per_group[i * tiles]
        for t in range(1, tiles):
            for _ in range(adds if t == 1 else 1):
                c1, c2 = c1 + per_group[i * tiles + t][0], c2 + per_group[i * tiles + t][1]
        c1, c2 = (v.repeat_interleave(cg) / count for v in (c1, c2))
        if fault == "no_c12":
            c1, c2 = torch.zeros_like(c1), torch.zeros_like(c2)
        dx[i] = rstd_c[i] * (dz[i] * gamma - c2 - xhat[i] * c1)
    return dx, _param_fold([p[1] for p in per_channel]), _param_fold([p[0] for p in per_channel])


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy((rng.normal(size=shape) * 2 + 0.5).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.1 * rng.normal(size=c)).astype(np.float32))
    beta = torch.from_numpy((0.1 * rng.normal(size=c)).astype(np.float32))
    return rng, x, gamma, beta


@pytest.mark.parametrize("shape,silu", [((2, 150, 64), True), ((3, 97, 320), False)])
@pytest.mark.parametrize("tiles", [1, 4, 40])
def test_group_norm_backward_folds_match_the_plain_backward(shape, silu, tiles):
    """K1b's order of summation gives the plain backward's gradients."""
    rng, x, gamma, beta = _gn_inputs(shape, 1)
    groups = num_groups_for(shape[-1])
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    _, mean, rstd = gn.group_norm_plain_with_stats(x, gamma, beta, groups, 1e-5, silu)
    want = gn.group_norm_backward_plain(x, dy, gamma, beta, mean, rstd, groups, silu)
    got = _k1b_model(x, dy, gamma, beta, groups, silu, tiles)
    for a, w in zip(got, want):
        assert rel_err(a.numpy(), w.numpy()) <= 1e-6


def _cotangent_following(y, noise):
    """The card checks' cotangent for K1b: y plus unit noise, in bf16. It
    follows y, so c1 and c2 (the group means K1b folds across tiles) carry
    much of dx."""
    return (y.float() + noise).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["drop", "double", "no_c12"])
@pytest.mark.parametrize("shape,silu,tiles", [((2, 2304, 320), True, 8),
                                              ((1, 576, 1280), False, 4)])
def test_k1b_card_check_sees_a_wrong_fold(shape, silu, tiles, fault):
    """With the cotangent the card checks use, a fold that drops or doubles
    one tile, or leaves out c1 and c2, moves dx by more than ten times
    GN_KERNEL_REL, the limit K1b is held to against the plain backward."""
    rng, x, gamma, beta = _gn_inputs(shape, 2)
    groups = num_groups_for(shape[-1])
    xb = x.to(torch.bfloat16)
    y, mean, rstd = gn.group_norm_plain_with_stats(xb, gamma, beta, groups, 1e-5, silu)
    dy = _cotangent_following(y, torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
    xf, dyf = xb.float(), dy.float()
    want = gn.group_norm_backward_plain(xf, dyf, gamma, beta, mean, rstd, groups, silu)[0]
    right = _k1b_model(xf, dyf, gamma, beta, groups, silu, tiles)[0]
    wrong = _k1b_model(xf, dyf, gamma, beta, groups, silu, tiles, fault)[0]
    assert rel_err(right.numpy(), want.numpy()) <= 1e-6
    assert rel_err(wrong.numpy(), want.numpy()) > 10 * GN_KERNEL_REL


# ---------------- a numpy model of K2b's wgmma register layouts ----------------
#
# One warpgroup of 128 threads; thread t is lane (g, c) = (lane // 4, lane % 4)
# of warp t // 32. The layouts, from the PTX manual (wgmma, m64nNk16): the
# accumulator of a 64 x N product gives warp w rows 16 w + g and 16 w + g + 8;
# the A operand in registers has the mma.sync m16n8k16 A layout per warp.


def acc_coords(t, i):
    """(row, column) of accumulator register i of thread t (the kernel's
    'element i in row + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 c + (i & 1)')."""
    w, lane = divmod(t, 32)
    g, c = divmod(lane, 4)
    return 16 * w + g + 8 * ((i >> 1) & 1), 8 * (i // 4) + 2 * c + (i & 1)


def a_coords(t, j):
    """(row, first column) of A register j of thread t in the PTX layout:
    per k-step kk, registers a0..a3 hold (g, 2c), (g + 8, 2c), (g, 2c + 8),
    (g + 8, 2c + 8), each two adjacent columns."""
    w, lane = divmod(t, 32)
    g, c = divmod(lane, 4)
    kk, a = divmod(j, 4)
    return 16 * w + g + 8 * (a & 1), 16 * kk + 2 * c + 8 * (a >> 1)


def load_a_frags_coords(t, j):
    """load_a_frags: register j holds row + 8 (j & 1), columns 16 (j >> 2) +
    8 ((j >> 1) & 1) + 2 c and + 1 (row = 16 w + g)."""
    w, lane = divmod(t, 32)
    g, c = divmod(lane, 4)
    return 16 * w + g + 8 * (j & 1), 16 * (j >> 2) + 8 * ((j >> 1) & 1) + 2 * c


def test_wgmma_fragment_maps():
    """Every accumulator element of a 64 x 64 product belongs to one thread;
    pairs (i, i + 1) packed into register i / 2 (as the kernels pack P and
    dS) land where the A layout wants them; load_a_frags reads the A layout;
    store_acc_rows writes each element where the accumulator holds it."""
    seen = set()
    for t in range(128):
        for i in range(32):
            seen.add(acc_coords(t, i))
        for i in range(0, 32, 2):
            r0, c0 = acc_coords(t, i)
            assert acc_coords(t, i + 1) == (r0, c0 + 1)
            assert a_coords(t, i // 2) == (r0, c0)
        for j in range(16):
            assert load_a_frags_coords(t, j) == a_coords(t, j)
        w, lane = divmod(t, 32)
        g, c = divmod(lane, 4)
        for r in range(2):
            for j in range(8):   # store_acc_rows: acc[4 j + 2 r] -> row g + 8 r, column 8 j + 2 c
                assert acc_coords(t, 4 * j + 2 * r) == (16 * w + g + 8 * r, 8 * j + 2 * c)
    assert seen == {(r, c) for r in range(64) for c in range(64)}


def _gather(regs, coords_fn, rows, cols):
    """Assemble the matrix that per-thread registers hold (pairs of columns)."""
    m = np.full((rows, cols), np.nan, np.float32)
    for t in range(128):
        for j, (lo, hi) in enumerate(regs[t]):
            r, c0 = coords_fn(t, j)
            m[r, c0], m[r, c0 + 1] = lo, hi
    return m


def test_dkdv_tile_on_the_register_model():
    """One dK/dV tile of one consumer warpgroup, on the model: S^T = K Q^T and
    dP^T = V dO^T scattered to the accumulator layout, P^T and dS^T with lse
    and delta read by accumulator column, packed into A registers, and the
    products dV += P^T dO and dK += dS^T Q taken from those registers; equal
    to the same tile in plain numpy."""
    rng = np.random.default_rng(2)
    k, v, q, do = (rng.normal(size=(64, 64)).astype(np.float32) for _ in range(4))
    lse = rng.normal(size=64).astype(np.float32) + 4
    delta = rng.normal(size=64).astype(np.float32)
    scale = np.float32(64 ** -0.5)
    st_full, dpt_full = k @ q.T, v @ do.T
    pa, sa = [], []
    for t in range(128):
        st = [st_full[acc_coords(t, i)] for i in range(32)]
        dpt = [dpt_full[acc_coords(t, i)] for i in range(32)]
        w, lane = divmod(t, 32)
        c = lane % 4
        for j in range(8):   # the kernel: columns 8 j + 2 c and + 1 from shared memory
            for e in range(4):
                i = 4 * j + e
                col = 8 * j + 2 * c + (e & 1)
                p = np.exp(st[i] * scale - lse[col])
                st[i], dpt[i] = p, p * (dpt[i] - delta[col])
        pa.append([(st[i], st[i + 1]) for i in range(0, 32, 2)])
        sa.append([(dpt[i], dpt[i + 1]) for i in range(0, 32, 2)])
    pt = _gather(pa, a_coords, 64, 64)
    dst = _gather(sa, a_coords, 64, 64)
    p_want = np.exp(st_full * scale - lse[None, :])
    ds_want = p_want * (dpt_full - delta[None, :])
    np.testing.assert_allclose(pt, p_want, rtol=1e-5)
    np.testing.assert_allclose(dst, ds_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt @ do, p_want @ do, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dst @ q, ds_want @ q, rtol=1e-4, atol=1e-5)


# ---------------- on the card: K1b and K2b at the edges of their plans ----------------


def _grad_check(kernel, plain, tol):
    first, again, want = kernel(), kernel(), plain()
    for i, (a, b, w) in enumerate(zip(first, again, want)):
        assert torch.equal(a, b), f"gradient {i}: two launches differ"
        err = rel_err(a.float().cpu().numpy(), w.float().cpu().numpy())
        assert err <= tol, f"gradient {i}: relative L2 {err:.3e} > {tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("extra_rows", [0, 1])   # the largest coop size, then two-pass
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_backward_at_the_resident_boundary(extra_rows, silu):
    dev = cuda_or_skip()
    c, groups = 320, num_groups_for(320)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = sms * gn.max_resident_rows(c, groups) + extra_rows
    assert gn.backward_plan(1, s, c, groups, sms)[0] == ("two_pass" if extra_rows else "coop")
    g = torch.Generator(device=dev).manual_seed(7)
    x = (torch.randn(1, s, c, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
    gamma = torch.randn(c, generator=g, device=dev)
    beta = torch.randn(c, generator=g, device=dev)
    _, part = gn.group_norm_forward(x, gamma, beta, groups, 1e-5, silu)
    y, mean, rstd = gn.group_norm_plain_with_stats(x, gamma, beta, groups, 1e-5, silu)
    dy = _cotangent_following(y, torch.randn(1, s, c, generator=g, device=dev))
    _grad_check(lambda: gn.group_norm_backward(x, dy, gamma, beta, part, groups, 1e-5, silu),
                lambda: gn.group_norm_backward_plain(x, dy, gamma, beta, mean, rstd, groups, silu),
                GN_KERNEL_REL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,nq,nk,h", [
    (1, 64, 32, 1),      # one query tile: the dQ block's second warpgroup has no rows
    (2, 576, 16, 10),    # image stream, a chunk per query tile
    (3, 192, 48, 2),     # 48 keys: a ragged 64-key dQ tile and 128-key dK/dV block
])
def test_flash_attention_backward_edges(b, nq, nk, h):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (torch.randn(b, n, h, 64, generator=g, device=dev).to(torch.bfloat16)
                   for n in (nq, nk, nk, nq))
    o, lse = fa.flash_attention_forward(q, k, v, with_lse=True)
    _grad_check(lambda: fa.flash_attention_backward(q, k, v, o, do, lse),
                lambda: fa.flash_attention_backward_plain(q, k, v, o, do,
                                                          fa.log_sum_exp_plain(q, k)),
                FA_KERNEL_REL)
