"""Host-side planning of the port's kernels, its launch counters and the
aligner's default device, on the CPU; and, marked `gpu` (skipped here),
K1-K3 against their plain versions at the edges of those plans.

The plans are plain Python (ops/flash_attention.py `plan`,
ops/group_norm.py `plan`, ops/temporal_attention.py `plan`), so their shapes
are checked here at every shape the slice's `reconstruct` gives each kernel
(listed from the shapes phase of chip_smoke.py on the card): every row, key
and job is covered exactly once, and a block's shared memory fits one
Hopper block.
"""

import math

import numpy as np
import pytest
import torch

from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
from geo4d_tpu_torch.nn.basics import num_groups_for
from geo4d_tpu_torch.ops import dispatch
from geo4d_tpu_torch.ops import flash_attention as fa
from geo4d_tpu_torch.ops import group_norm as gn
from geo4d_tpu_torch.ops import temporal_attention as ta
from geo4d_tpu_torch.pipeline.inference import align_predictions
from geo4d_tpu_torch.tools.profile_aligner import synthetic_scene
from _torch_parity import assert_close, cuda_or_skip, kernel_jobs

# (N, S, C) of every GroupNorm the slice's reconstruct launches (UNet, VAE)
GN_MAIN_PATH = [
    (1, 576, 1280), (1, 2304, 1280), (1, 9216, 640), (1, 36864, 320), (4, 2304, 512),
    (4, 9216, 256), (4, 9216, 512), (4, 36864, 128), (4, 36864, 256), (4, 147456, 128),
    (16, 36, 1280), (16, 36, 2560), (16, 144, 640), (16, 144, 1280), (16, 144, 1920),
    (16, 144, 2560), (16, 576, 320), (16, 576, 640), (16, 576, 960), (16, 576, 1280),
    (16, 576, 1920), (16, 2304, 320), (16, 2304, 512), (16, 2304, 640), (16, 2304, 960),
    (16, 9216, 256), (16, 9216, 512), (16, 36864, 128), (16, 36864, 256), (16, 36864, 512),
    (16, 147456, 128), (16, 147456, 256), (48, 2304, 512), (48, 9216, 512), (48, 36864, 256),
    (48, 36864, 512), (48, 147456, 128), (48, 147456, 256),
]
# (P, N, C, heads) of every temporal attention the slice's reconstruct launches
TA_MAIN_PATH = [(2304, 16, 320, 5), (576, 16, 640, 10), (144, 16, 1280, 20),
                (2304, 16, 512, 8), (36, 16, 1280, 20)]
# the edges of K3's gate (N <= 32, d % 8 == 0, d <= 128), at 37 pixels x 3 heads
TA_EDGES = [(37, n, 3 * d, 3) for n in (1, 5, 16, 17, 32) for d in (8, 24, 64, 128)]


@pytest.mark.parametrize("nq,nk,bk,q_tiles", [
    (2304, 2304, 128, 18),   # ds1 self-attention
    (576, 576, 64, 5),       # ds2: the last q tile holds 64 of 128 rows
    (2304, 16, 16, 18),      # image stream, one 16-key tile
    (576, 16, 16, 5),
])
def test_flash_attention_plan(nq, nk, bk, q_tiles):
    assert fa.fits(nq, nk, fa.HEAD_DIM)
    assert fa.plan(nq, nk) == (bk, q_tiles)
    assert (q_tiles - 1) * fa.BLOCK_Q < nq <= q_tiles * fa.BLOCK_Q
    assert nk % bk == 0   # no masked keys at the main-path shapes


def test_flash_attention_plan_masks_a_ragged_last_tile():
    bk, _ = fa.plan(576, 80)
    assert bk == 64 and 80 % bk and math.ceil(80 / bk) * bk >= 80


@pytest.mark.parametrize("n,s,c", GN_MAIN_PATH)
def test_group_norm_plan_covers_rows(n, s, c):
    groups = num_groups_for(c)
    path, t, rows = gn.plan(n, s, c, groups)
    assert (t - 1) * rows < s <= t * rows   # tiles [i * rows, (i + 1) * rows) cover S once
    if path == "resident":
        assert n * t <= gn.SM_COUNT
        assert gn.resident_smem(rows, c, groups) <= gn.SMEM_PER_BLOCK
    else:
        assert path == "two_pass" and (t, rows) == gn.tiling(n, s, c)


@pytest.mark.parametrize("n,s,c,path", [
    (16, 2304, 320, "resident"),     # per-frame UNet norm
    (1, 36864, 320, "resident"),     # per-clip UNet norm
    (16, 36, 2560, "resident"),
    (1, 36864, 960, "two_pass"),     # per-clip concat norm: 70.8 MB
    (48, 147456, 128, "two_pass"),   # VAE full resolution
])
def test_group_norm_plan_paths(n, s, c, path):
    assert gn.plan(n, s, c, num_groups_for(c))[0] == path


@pytest.mark.parametrize("c", [320, 640, 1280])
def test_group_norm_plan_boundary(c):
    groups = num_groups_for(c)
    rows = gn.max_resident_rows(c, groups)
    s = gn.SM_COUNT * rows
    assert gn.plan(1, s, c, groups) == ("resident", gn.SM_COUNT, rows)
    assert gn.resident_smem(rows, c, groups) <= gn.SMEM_PER_BLOCK
    assert gn.resident_smem(rows + 1, c, groups) > gn.SMEM_PER_BLOCK
    assert gn.plan(1, s + 1, c, groups)[0] == "two_pass"


@pytest.mark.parametrize("p,n,c,heads", TA_MAIN_PATH + TA_EDGES)
def test_temporal_attention_plan(p, n, c, heads):
    pl = ta.plan(p, n, c, heads)
    d, jobs = c // heads, p * heads
    assert pl.smem == pl.warps * pl.stages * ta.job_smem(n, d) <= dispatch.SMEM_PER_BLOCK
    assert 1 <= pl.warps <= ta.MAX_WARPS and 2 <= pl.stages <= ta.MAX_STAGES
    assert pl.grid <= dispatch.SM_COUNT
    assert pl.grid * (pl.jobs_per_block - 1) < jobs <= pl.grid * pl.jobs_per_block
    assert sorted(kernel_jobs(pl, jobs)) == list(range(jobs))   # every job exactly once


@pytest.mark.parametrize("p,n,c,heads", TA_MAIN_PATH)
def test_temporal_attention_plan_keeps_copies_in_flight(p, n, c, heads):
    """At a main-path shape every block starts with >= 32 KB of q, k, v
    copies in flight (all of its warps' first `stages` jobs), and every SM
    has a block."""
    pl = ta.plan(p, n, c, heads)
    job_bytes = 3 * n * (c // heads) * 2
    per_warp = math.ceil(pl.jobs_per_block / pl.warps)
    assert pl.grid == dispatch.SM_COUNT
    assert pl.warps * min(pl.stages, per_warp) * job_bytes >= 32 * 1024


def test_temporal_attention_plan_at_the_largest_slot():
    pl = ta.plan(1000, 32, 1280, 10)   # N = 32, d = 128: 25.5 KB a slot
    assert (pl.warps, pl.stages) == (4, 2) and pl.smem <= dispatch.SMEM_PER_BLOCK


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_temporal_attention_rows_are_an_odd_number_of_chunks(d):
    r = ta.row_elems(d)
    assert d <= r <= d + 8 and r % 8 == 0 and (r // 8) % 2 == 1


def test_group_norm_passes_need_a_cuda_tensor():
    x = torch.randn(2, 8, 16).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gn.two_pass_launches(x, torch.ones(16), torch.zeros(16), 4, 1e-5)


def test_by_shape_counter_on_the_cpu():
    for st in (gn.stats, fa.stats, ta.stats):
        st.reset()
    x = torch.randn(2, 8, 16)
    gn.group_norm(x, torch.ones(16), torch.zeros(16), 4, 1e-5)
    q = torch.randn(1, 512, 1, 64)
    fa.flash_attention(q, q, q)
    ta.temporal_attention(x, x, x, 2)
    for st in (gn.stats, fa.stats, ta.stats):
        assert st.launches == 0 and not st.by_shape


def test_by_shape_counter_counts_and_resets():
    st = dispatch.KernelStats()
    for key in [(16, 2304, 320, True), (16, 2304, 320, True), (1, 576, 1280, False)]:
        st.note_launch(key)
    assert st.launches == 3 and st.by_shape == {(16, 2304, 320, True): 2, (1, 576, 1280, False): 1}
    st.reset()
    assert st.launches == 0 and not st.by_shape


# ---------------- the aligner's default device ----------------

@pytest.fixture(scope="module")
def small_scene():
    return synthetic_scene(n=6, h=12, w=16, focal=20.0, window=4, stride=2)


def _aligner(sc, **kw):
    p = sc["preds"]
    return GroupAligner(sc["groups"], p["pts3d"], p["conf"], sc["hw"], invdepth=p["inv_depth"],
                        trajs=p["traj"], config=AlignerConfig(n_iter=4), **kw)


def test_numpy_aligner_without_device_needs_cuda(small_scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _aligner(small_scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        align_predictions(small_scene["groups"], small_scene["preds"], small_scene["hw"],
                          AlignerConfig(n_iter=4))


def test_numpy_aligner_runs_on_the_cpu_when_asked(small_scene):
    al = _aligner(small_scene, device="cpu")
    assert al.device.type == "cpu" and al.params["log_depth"].device.type == "cpu"
    al = align_predictions(small_scene["groups"], small_scene["preds"], small_scene["hw"],
                           AlignerConfig(n_iter=4, depth_traj_start_iter=2), device="cpu")
    assert al.params["log_depth"].device.type == "cpu" and np.isfinite(al.final_loss)


# ---------------- on the card: the plans' edges, kernel against plain ----------------

BF16_ATOL = 2 ** -6
BF16_RTOL = 2 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("b,nq,nk,h", [
    (2, 576, 576, 10),   # ragged 128-row q tile (64 rows past Nq)
    (2, 576, 16, 10),    # Nk = 16: one BK = 16 tile
    (2, 576, 80, 2),     # masked keys in a ragged last 64-key tile
])
def test_flash_attention_kernel_edges(b, nq, nk, h):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(b, n, h, 64, generator=g, device=dev).to(torch.bfloat16)
               for n in (nq, nk, nk))
    got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa.flash_attention(q, k, v))
    want = fa.flash_attention_plain(q, k, v)
    assert_close(got.float(), want.float().cpu().numpy(), BF16_ATOL, BF16_RTOL, "flash edge")


@pytest.mark.gpu
@pytest.mark.parametrize("extra_rows", [0, 1])   # the largest resident size, then two-pass
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_kernel_at_the_resident_boundary(extra_rows, silu):
    dev = cuda_or_skip()
    c, groups = 320, num_groups_for(320)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = sms * gn.max_resident_rows(c, groups) + extra_rows
    assert gn.plan(1, s, c, groups, sms)[0] == ("two_pass" if extra_rows else "resident")
    g = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn(1, s, c, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
    gamma = torch.randn(c, generator=g, device=dev)
    beta = torch.randn(c, generator=g, device=dev)
    got = gn.group_norm(x, gamma, beta, groups, 1e-5, silu)
    assert torch.equal(got, gn.group_norm(x, gamma, beta, groups, 1e-5, silu))
    want = gn.group_norm_plain(x, gamma, beta, groups, 1e-5, silu)
    assert_close(got.float(), want.float().cpu().numpy(), BF16_ATOL, BF16_RTOL, "gn boundary")


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,c,heads", TA_EDGES + [
    (1, 16, 320, 5),      # P = 1: five jobs, five warps of one block
    (1, 32, 128, 1),      # one job
    (2305, 16, 320, 5),   # 11525 jobs: blocks of 87 and 88
])
def test_temporal_attention_kernel_edges(p, n, c, heads):
    dev = cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(p, n, c, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    got = ta.temporal_attention(q, k, v, heads)
    assert torch.equal(got, ta.temporal_attention(q, k, v, heads))
    want = ta.temporal_attention_plain(q, k, v, heads)
    assert_close(got.float(), want.float().cpu().numpy(), BF16_ATOL, BF16_RTOL, "temporal edge")


@pytest.mark.gpu
@pytest.mark.parametrize("n,s,c,silu", [(1, 36864, 960, False), (4, 147456, 128, True)])
def test_group_norm_passes_alone_equal_group_norm(n, s, c, silu):
    dev = cuda_or_skip()
    groups = num_groups_for(c)
    g = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn(n, s, c, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
    gamma = torch.randn(c, generator=g, device=dev)
    beta = torch.randn(c, generator=g, device=dev)
    stats_pass, apply_pass, y = gn.two_pass_launches(x, gamma, beta, groups, 1e-5, silu)
    stats_pass()
    apply_pass()
    assert torch.equal(y, gn.group_norm(x, gamma, beta, groups, 1e-5, silu))
