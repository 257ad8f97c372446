"""K3b (csrc/temporal_attention.cu `temporal_attention_bwd`) on the CPU.

The kernel cannot run here, so what it rests on is checked in plain Python:
its launch plan (`temporal_attention.backward_plan`) at every training shape
and at the `gpu` test shapes; and, on a numpy model of one warp, the
register layouts its mma.sync products use (m16n8k16's A, B and C
fragments, ldmatrix and ldmatrix.trans, movmatrix.trans, from the PTX
manual) and one whole job computed through them with the kernel's index
expressions: the copies into a slot, S and dP, the softmax on the quads,
the transposes, the three products staged in the slot and the whole-chunk
stores. In float32 the job equals `temporal_attention_backward_plain`; with
the kernel's bf16 roundings it lands where the card check expects it, and a
misread fragment moves a gradient by more than that check's limit.
"""

import numpy as np
import pytest
import torch

from geo4d_tpu_torch.ops import dispatch
from geo4d_tpu_torch.ops import temporal_attention as ta
from _torch_parity import kernel_jobs, rel_err

# (P, N, C, heads) of every K3b launch of one flagship training step (16 x
# 256 x 576, batch 1), as chip_smoke.py's backward phase listed them on the
# card
TA_TRAIN = [(2304, 16, 320, 5), (576, 16, 640, 10), (144, 16, 1280, 20), (36, 16, 1280, 20),
            (2304, 16, 512, 8)]
# the K3b cases of tests/test_torch_autograd.py's `gpu` test
TA_GPU = [(576, 17, 640, 10), (333, 32, 72, 3), (37, 1, 192, 3), (37, 5, 24, 3),
          (100, 17, 1280, 10), (37, 32, 384, 3), (1001, 16, 320, 5)]
# K3b against its plain backward on the card (chip_smoke BWD_REL_L2, the
# `gpu` tests' KERNEL_REL): bf16 P and dS
KERNEL_REL = 1e-2


# ---------------- the launch plan ----------------


@pytest.mark.parametrize("p,n,c,heads", TA_TRAIN + TA_GPU)
def test_backward_plan(p, n, c, heads):
    """The block fits Hopper's shared memory, blocks differ by at most one
    job, and the kernel's split takes every job exactly once."""
    pl = ta.backward_plan(p, n, c, heads)
    d, jobs = c // heads, p * heads
    assert pl.smem == pl.warps * pl.stages * ta.job_smem(n, d, tiles=4) <= dispatch.SMEM_PER_BLOCK
    assert 1 <= pl.warps <= ta.MAX_WARPS and 2 <= pl.stages <= ta.MAX_STAGES
    assert pl.grid <= dispatch.SM_COUNT
    sizes = [(b + 1) * jobs // pl.grid - b * jobs // pl.grid for b in range(pl.grid)]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) == pl.jobs_per_block
    assert sorted(kernel_jobs(pl, jobs)) == list(range(jobs))


@pytest.mark.parametrize("p,n,c,heads,want", [
    ((2304, 16, 320, 5) + ((12, 2),)),     # 9 KB slots: 12 warps of 2, 221 KB
    ((36, 16, 1280, 20) + ((6, 2),)),      # 6 jobs a block: a warp each
    ((1000, 32, 1280, 10) + ((3, 2),)),   # N = 32, d = 128: 34 KB slots
])
def test_backward_plan_warps_and_slots(p, n, c, heads, want):
    pl = ta.backward_plan(p, n, c, heads)
    assert (pl.warps, pl.stages) == want


# ---------------- a numpy model of one warp ----------------
#
# Lane t = 4 g + c. A b32 register holding two bf16 is a pair (lo, hi); the
# model keeps each register of all 32 lanes as one array: (32, 2) for a
# pair, (32, 4) for an m16n8 f32 accumulator, (32, 4, 2) for ldmatrix.x4.

LANE = np.arange(32)
G, TIG = LANE >> 2, LANE & 3


def a_map(reg, e):
    """(row, column) of a 16 x 16 A fragment held by register `reg` (0-3),
    half e of every lane: a0 (g, 2c), a1 (g + 8, 2c), a2 (g, 2c + 8),
    a3 (g + 8, 2c + 8)."""
    return G + 8 * (reg & 1), 2 * TIG + e + 8 * (reg >> 1)


def b_map(reg, e):
    """(k, n) of a 16 x 8 B fragment: b0 (2c, g), b1 (2c + 8, g)."""
    return 2 * TIG + e + 8 * reg, G


def c_map(i):
    """(row, column) of accumulator element i: (g, 2c + (i & 1)), + 8 rows
    for i >= 2."""
    return G + 8 * (i >> 1), 2 * TIG + (i & 1)


def mma_16816(d, a, b0, b1):
    """d + A B for the fragments a (32, 4, 2), b0, b1 (32, 2), d (32, 4), in
    float32."""
    am, bm, dm = np.zeros((16, 16), np.float32), np.zeros((16, 8), np.float32), \
        np.zeros((16, 8), np.float32)
    for e in range(2):
        for r in range(4):
            am[a_map(r, e)] = a[:, r, e]
        bm[b_map(0, e)], bm[b_map(1, e)] = b0[:, e], b1[:, e]
    for i in range(4):
        dm[c_map(i)] = d[:, i]
    dm = am @ bm + dm
    return np.stack([dm[c_map(i)] for i in range(4)], 1)


def ldsm_x4(smem, addr, trans=False):
    """ldmatrix.x4 (.trans): lanes 8 m .. 8 m + 7 give the element addresses
    of matrix m's 8 rows (16-byte aligned); register m of lane t holds row
    g, columns 2c, 2c + 1 of matrix m, or of its transpose."""
    assert (addr % 8 == 0).all()
    out = np.empty((32, 4, 2), np.float32)
    for m in range(4):
        for e in range(2):
            out[:, m, e] = (smem[addr[8 * m + 2 * TIG + e] + G] if trans
                            else smem[addr[8 * m + G] + 2 * TIG + e])
    return out


def movtrans(x):
    """movmatrix.sync.aligned.m8n8.trans.b16 on the pairs x (32, 2)."""
    m = np.empty((8, 8), np.float32)
    for e in range(2):
        m[G, 2 * TIG + e] = x[:, e]
    return np.stack([m[2 * TIG + e, G] for e in range(2)], 1)


def shfl_xor(x, mask):
    return x[LANE ^ mask]


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def lane_chunks(n, d):
    """The (row, chunk) pairs each lane copies of an N x d tile, in the
    kernel's order: (lane // dc, lane % dc), then +32 chunks at a time."""
    dc = d // 8
    out = []
    for lane in range(32):
        r, c, mine = lane // dc, lane % dc, []
        for _ in range(lane, n * dc, 32):
            mine.append((r, c))
            r, c = r + 32 // dc, c + 32 % dc
            if c >= dc:
                c, r = c - dc, r + 1
        out.append(mine)
    return out


def k3b_job(q, k, v, do, rnd=lambda x: x, fault=None):
    """One job through the warp model, with the kernel's index expressions:
    q, k, v, do (N, d) float32 -> (dq, dk, dv) as the kernel stores them.
    `rnd` is the kernel's rounding to bf16 (identity: float32 throughout).
    `fault` misreads a fragment as a wrong kernel could: "transpose" feeds
    dV one 8 x 8 block of P without its movmatrix, "half" swaps the row
    halves (g and g + 8) of dQ's first A fragment, "rowsum" drops
    rowsum(dP P) from dS."""
    n, d = q.shape
    ks_n = 2 if n > 16 else 1
    dmax = 32 if d <= 32 else 64 if d <= 64 else 128
    rs = ta.row_elems(d)
    tensor = 16 * ks_n * rs
    sq, sk, sv, sdo = 0, tensor, 2 * tensor, 3 * tensor
    smem = np.zeros(4 * tensor, np.float32)         # pad rows stay zero
    chunks = lane_chunks(n, d)
    for t, x in enumerate((q, k, v, do)):          # the cp.async copies
        for mine in chunks:
            for r, c in mine:
                smem[t * tensor + r * rs + 8 * c:][:8] = x[r, 8 * c:8 * c + 8]
    scale = np.float32(d ** -0.5)
    scale_log2 = np.float32(scale * np.float32(1.4426950408889634))
    a_row, a_col = (LANE & 7) + ((LANE >> 3) & 1) * 8, (LANE >> 4) * 8
    b_row, b_col = (LANE & 7) + (LANE >> 4) * 8, ((LANE >> 3) & 1) * 8
    key_tiles = 2 * ks_n

    pp, dsp = {}, {}
    for mt in range(ks_n):
        s = np.zeros((key_tiles, 32, 4), np.float32)
        dp = np.zeros((key_tiles, 32, 4), np.float32)
        for kk in range(dmax // 16):
            if kk * 16 >= d:
                continue
            half = d - kk * 16 == 8
            a_off = (mt * 16 + a_row) * rs + kk * 16 + (0 if half else a_col)
            a, ad = ldsm_x4(smem, sq + a_off), ldsm_x4(smem, sdo + a_off)
            if half:
                a[:, 2:] = ad[:, 2:] = 0
            for nb in range(ks_n):
                b_off = (nb * 16 + b_row) * rs + kk * 16 + (0 if half else b_col)
                b, bv = ldsm_x4(smem, sk + b_off), ldsm_x4(smem, sv + b_off)
                if half:
                    b[:, 1::2] = bv[:, 1::2] = 0
                s[2 * nb] = mma_16816(s[2 * nb], a, b[:, 0], b[:, 1])
                s[2 * nb + 1] = mma_16816(s[2 * nb + 1], a, b[:, 2], b[:, 3])
                dp[2 * nb] = mma_16816(dp[2 * nb], ad, bv[:, 0], bv[:, 1])
                dp[2 * nb + 1] = mma_16816(dp[2 * nb + 1], ad, bv[:, 2], bv[:, 3])
        # softmax of rows g (elements 0, 1) and g + 8 (2, 3) on the quads
        cols = np.arange(key_tiles)[:, None, None] * 8 + TIG[None, :, None] * 2 \
            + np.array([0, 1, 0, 1])[None, None, :]
        s = np.where(cols < n, s * scale_log2, -np.inf).astype(np.float32)
        mx = np.stack([s[:, :, :2].max((0, 2)), s[:, :, 2:].max((0, 2))], 1)   # (32, 2)
        for x in (1, 2):
            mx = np.maximum(mx, shfl_xor(mx, x))
        s = np.exp2(s - np.repeat(mx, 2, 1)[None]).astype(np.float32)
        tot = np.stack([s[:, :, :2].sum((0, 2)), s[:, :, 2:].sum((0, 2))], 1)
        for x in (1, 2):
            tot = tot + shfl_xor(tot, x)
        s = s * np.repeat(np.float32(1) / tot, 2, 1)[None]
        pd = dp * s
        r = np.stack([pd[:, :, :2].sum((0, 2)), pd[:, :, 2:].sum((0, 2))], 1)
        for x in (1, 2):
            r = r + shfl_xor(r, x)
        if fault == "rowsum":
            r = np.zeros_like(r)
        ds = s * (dp - np.repeat(r, 2, 1)[None])
        for nt in range(key_tiles):
            for h in range(2):
                pp[mt, nt, h] = rnd(s[nt][:, 2 * h:2 * h + 2])
                dsp[mt, nt, h] = rnd(ds[nt][:, 2 * h:2 * h + 2])

    t_row, t_col = a_row, a_col

    def product_rows(a, src, dst, m0, mul):
        r0 = m0 + G
        for dpi in range(dmax // 16):
            if dpi * 16 >= d:
                continue
            half = d - dpi * 16 == 8
            acc = np.zeros((2, 32, 4), np.float32)
            for ks in range(ks_n):
                b = ldsm_x4(smem, src + (ks * 16 + t_row) * rs + dpi * 16
                            + (0 if half else t_col), trans=True)
                acc[0] = mma_16816(acc[0], a[ks], b[:, 0], b[:, 1])
                if not half:
                    acc[1] = mma_16816(acc[1], a[ks], b[:, 2], b[:, 3])
            for t in range(1 if half else 2):
                col = dpi * 16 + t * 8 + TIG * 2
                for rows, lo in ((r0, 0), (r0 + 8, 2)):
                    ok = rows < n
                    for e in range(2):
                        smem[dst + rows[ok] * rs + col[ok] + e] = rnd(acc[t][ok, lo + e] * mul)

    def transposed(x, mk, ks):
        return np.stack([movtrans(x[ks, 2 * mk, 0]), movtrans(x[ks, 2 * mk + 1, 0]),
                         movtrans(x[ks, 2 * mk, 1]), movtrans(x[ks, 2 * mk + 1, 1])], 1)

    for mk in range(ks_n):                          # dV = bf16(P)^T dO -> v tile
        a = [transposed(pp, mk, ks) for ks in range(ks_n)]
        if fault == "transpose" and mk == 0:
            a[0][:, 0] = pp[0, 0, 0]
        product_rows(a, sdo, sv, mk * 16, np.float32(1))
    for mt in range(ks_n):                          # dQ = dS K s -> dO tile
        a = [np.stack([dsp[mt, 2 * ks, 0], dsp[mt, 2 * ks, 1], dsp[mt, 2 * ks + 1, 0],
                       dsp[mt, 2 * ks + 1, 1]], 1) for ks in range(ks_n)]
        if fault == "half" and mt == 0:
            a[0] = a[0][:, [1, 0, 3, 2]]
        product_rows(a, sk, sdo, mt * 16, scale)
    for mk in range(ks_n):                          # dK = dS^T Q s -> k tile
        product_rows([transposed(dsp, mk, ks) for ks in range(ks_n)], sq, sk, mk * 16, scale)

    out = []
    for src in (sdo, sk, sv):                       # whole-chunk stores: dq, dk, dv
        x = np.full((n, d), np.nan, np.float32)
        for mine in chunks:
            for r, c in mine:
                x[r, 8 * c:8 * c + 8] = smem[src + r * rs + 8 * c:][:8]
        out.append(x)
    return out


@pytest.mark.parametrize("n,d", [(16, 64), (17, 24), (1, 8), (32, 128)])
def test_lane_chunks_cover_the_tile(n, d):
    seen = sorted(rc for mine in lane_chunks(n, d) for rc in mine)
    assert seen == [(r, c) for r in range(n) for c in range(d // 8)]


@pytest.mark.parametrize("trans", [False, True])
def test_ldmatrix_gives_the_fragments(trans):
    """With the kernel's row addresses, ldmatrix reads a row-major tile as
    the A fragment (Q, dO) and as the B fragment of its transpose (K, V for
    S and dP: n = key); ldmatrix.trans reads it as the B fragment of the tile
    itself (K, dO, Q for dQ, dV, dK: k = row). Two n8 tiles at once."""
    rng = np.random.default_rng(0)
    rs = ta.row_elems(64)
    tile = rng.normal(size=(16, rs)).astype(np.float32)
    smem = tile.reshape(-1)
    a_row, a_col = (LANE & 7) + ((LANE >> 3) & 1) * 8, (LANE >> 4) * 8
    b_row, b_col = (LANE & 7) + (LANE >> 4) * 8, ((LANE >> 3) & 1) * 8
    if not trans:
        a = ldsm_x4(smem, a_row * rs + a_col)
        b = ldsm_x4(smem, b_row * rs + b_col)
        for e in range(2):
            for r in range(4):
                np.testing.assert_array_equal(a[:, r, e], tile[a_map(r, e)])
            for nt in range(2):           # B[k][n] = tile[8 nt + n][k]
                for r in range(2):
                    kk, nn = b_map(r, e)
                    np.testing.assert_array_equal(b[:, 2 * nt + r, e], tile[8 * nt + nn, kk])
    else:
        b = ldsm_x4(smem, a_row * rs + a_col, trans=True)
        for e in range(2):
            for nt in range(2):           # B[k][n] = tile[k][8 nt + n]
                for r in range(2):
                    kk, nn = b_map(r, e)
                    np.testing.assert_array_equal(b[:, 2 * nt + r, e], tile[kk, 8 * nt + nn])


def test_mma_maps_cover_each_element_once():
    for mp, shape, regs in ((a_map, (16, 16), 4), (b_map, (16, 8), 2)):
        seen = [tuple(x) for r in range(regs) for e in range(2) for x in zip(*mp(r, e))]
        assert sorted(seen) == [(i, j) for i in range(shape[0]) for j in range(shape[1])]
    seen = [tuple(x) for i in range(4) for x in zip(*c_map(i))]
    assert sorted(seen) == [(i, j) for i in range(16) for j in range(8)]
    rng = np.random.default_rng(1)
    am, bm = rng.normal(size=(16, 16)).astype(np.float32), rng.normal(size=(16, 8)).astype(np.float32)
    a = np.stack([np.stack([am[a_map(r, e)] for e in range(2)], 1) for r in range(4)], 1)
    b = [np.stack([bm[b_map(r, e)] for e in range(2)], 1) for r in range(2)]
    d = mma_16816(np.zeros((32, 4), np.float32), a, *b)
    np.testing.assert_allclose(np.stack([(am @ bm)[c_map(i)] for i in range(4)], 1), d,
                               rtol=1e-6)


def test_packed_accumulators_and_their_transposes_are_a_fragments():
    """The pairs of two n8 accumulator tiles (rows g / g + 8, keys 2c, 2c+1)
    are, as they stand, the A fragment of the 16-key k-step (dQ = dS K);
    movmatrix of the four 8 x 8 blocks gives the A fragment of the
    transpose (dV = P^T dO, dK = dS^T Q)."""
    rng = np.random.default_rng(2)
    m = rng.normal(size=(16, 16)).astype(np.float32)       # rows: queries, columns: keys
    acc = [np.stack([m[c_map(i)[0], 8 * nt + c_map(i)[1]] for i in range(4)], 1)
           for nt in range(2)]
    pairs = {(nt, h): acc[nt][:, 2 * h:2 * h + 2] for nt in range(2) for h in range(2)}
    a = np.stack([pairs[0, 0], pairs[0, 1], pairs[1, 0], pairs[1, 1]], 1)
    at = np.stack([movtrans(pairs[0, 0]), movtrans(pairs[1, 0]), movtrans(pairs[0, 1]),
                   movtrans(pairs[1, 1])], 1)
    for r in range(4):
        for e in range(2):
            np.testing.assert_array_equal(a[:, r, e], m[a_map(r, e)])
            np.testing.assert_array_equal(at[:, r, e], m.T[a_map(r, e)])


def _job(rng, n, d, card=False):
    """q, k, v, do of one job: unit normals, in bf16 as the card checks
    draw them (chip_smoke's backward phase, the `gpu` tests)."""
    xs = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(4)]
    return [bf16(x) for x in xs] if card else xs


def _plain(q, k, v, do):
    grads = ta.temporal_attention_backward_plain(
        *(torch.from_numpy(x)[None] for x in (q, k, v, do)), 1)
    return [g[0].numpy() for g in grads]


@pytest.mark.parametrize("n,d", [(16, 64), (17, 64), (16, 24), (17, 24), (5, 8), (32, 128)])
def test_one_job_through_the_model_equals_the_plain_backward(n, d):
    """In float32 (no bf16 rounding) the modelled kernel gives the plain
    backward's dq, dk and dv; pad rows (N = 5, 17) give no NaN."""
    q, k, v, do = _job(np.random.default_rng(n * d), n, d)
    for got, want in zip(k3b_job(q, k, v, do), _plain(q, k, v, do)):
        assert np.isfinite(got).all()
        assert rel_err(got, want) <= 1e-5


def _card_model_errors(fault, jobs=6, n=16, d=64):
    """Relative L2 of (dq, dk, dv) of the modelled kernel with its bf16
    roundings against the plain backward, over `jobs` jobs of the card
    check's inputs."""
    rng = np.random.default_rng(3)
    got, want = [[], [], []], [[], [], []]
    for _ in range(jobs):
        job = _job(rng, n, d, card=True)
        for i, (a, b) in enumerate(zip(k3b_job(*job, rnd=bf16, fault=fault), _plain(*job))):
            got[i].append(a)
            want[i].append(b)
    return [rel_err(np.stack(a), np.stack(b)) for a, b in zip(got, want)]


def test_card_model_lands_inside_the_card_check():
    """With bf16 P and dS, as on the card, each gradient stays well inside
    KERNEL_REL (about 3e-3, the 2.7e-3 of K2b's bf16 products)."""
    errs = _card_model_errors(None)
    assert max(errs) <= KERNEL_REL / 2, errs


@pytest.mark.parametrize("fault,grad", [("transpose", 2), ("half", 0), ("rowsum", 0),
                                        ("rowsum", 1)])
def test_k3b_card_check_sees_a_misread_fragment(fault, grad):
    """One 8 x 8 block of P read untransposed, dS's row halves swapped in
    one A fragment, or rowsum(dP P) dropped moves that gradient (0 dq, 1 dk,
    2 dv) by more than KERNEL_REL on the card check's inputs."""
    assert _card_model_errors(fault)[grad] > KERNEL_REL
