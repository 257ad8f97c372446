"""The aligner's objective op (geo4d_tpu_torch/ops/align_objective.py) on
the CPU, through its plain version: against autograd of the aligner's own
form of the point-map and disparity terms (`GroupAligner.loss_fn` with no
trajectory or smoothing term), in both phases, with a shared, a per-frame
and a frozen focal, with and without the weight clamp, on windows that give
frames 1 to 4 slots; the fixed order of its sums, pinned bit for bit; the
aligner's frame gathers, whose backward sums in index_add's order; the
calibration's gates written in place, where a captured iteration reads
them.

Marked `gpu` (skipped here): the kernel against the plain version and a
second launch of itself; the frame gathers' backward against PyTorch's
deterministic index_add; and `run` with CUDA graphs against a run with
every iteration eager, bit for bit.

Tolerances: loss 1e-6 relative, each gradient 1e-5 relative L2 (float32
summation order; measured ~1e-7 and ~3e-7).
"""

import contextlib

import numpy as np
import pytest
import torch

from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
from geo4d_tpu_torch.geometry.se3 import params_to_pose
from geo4d_tpu_torch.ops import align_objective as objective
from geo4d_tpu_torch.ops import graphs
from geo4d_tpu_torch.tools.profile_aligner import synthetic_scene

torch.set_num_threads(1)
LOSS_REL = 1e-6
GRAD_REL = 1e-5
# windows of 4 at stride 1 over 7 frames: frames 0 and 6 in one window, 1 and
# 5 in two, 2 and 4 in three, 3 in four
SCENE = dict(n=7, h=12, w=16, focal=20.0, window=4, stride=1)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def aligner(conf_optimize=True, shared_focal=True, seed=0, pixel_terms_only=False):
    """An aligner over the analytic scene with perturbed parameters, both
    phase-2 gates set (one window's depth gate off) and weights on both
    sides of the clamp; with `pixel_terms_only`, no trajectory and no
    smoothing term, so that its objective is the op's terms alone."""
    sc = synthetic_scene(**SCENE)
    p = sc["preds"]
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0.5, 15.0, p["conf"].shape).astype(np.float32)
    cfg = AlignerConfig(conf_optimize=conf_optimize, shared_focal=shared_focal,
                        **({"temporal_smoothing_weight": 0.0} if pixel_terms_only else {}))
    al = GroupAligner(sc["groups"], p["pts3d"], conf, sc["hw"], invdepth=p["inv_depth"],
                      trajs=None if pixel_terms_only else p["traj"], config=cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)

    def noise(t, s):
        return s * torch.randn(t.shape, generator=gen)

    with torch.no_grad():
        depth = torch.from_numpy(sc["depths"]).float().reshape(al.N, -1)
        al.params["log_depth"].copy_(torch.log(depth) + noise(depth, 0.01))
        al.params["poses"].add_(noise(al.params["poses"], 0.05))
        al.params["pw_poses"].add_(noise(al.params["pw_poses"], 0.05))
        al.params["traj_align"].add_(noise(al.params["traj_align"], 0.05))
        al.params["focal"].add_(noise(al.params["focal"], 1.0))
        al.params["s_depth"].copy_(0.5 + torch.rand(al.G, generator=gen))
        al.params["t_depth"].copy_(noise(al.params["t_depth"], 0.1))
        al.valid_depth_group.copy_(torch.tensor([1.0, 0.0, 1.0, 1.0]))
        al.valid_traj_group.copy_(torch.tensor([1.0, 1.0, 0.0, 1.0]))
    return al


def data_of(al, device=None):
    """The op's fixed inputs for the aligner's predictions and config."""
    cfg, buf = al.cfg, al.buf

    def on(t):
        return None if t is None else t.to(device or t.device)

    return objective.ObjectiveData(al.groups, on(buf["pred_pts"]), on(buf["weights"]),
                                   on(buf.get("invdepth")), (al.H, al.W),
                                   cfg.conf_clamp if cfg.conf_optimize else None,
                                   cfg.invdepth_valid_thr, cfg.depth_loss_weight)


def op_loss(al, data, params, depth_term):
    """The op's terms at `params`, differentiable in the aligner's leaves."""
    poses = params_to_pose(params["poses"])
    pw = params_to_pose(params["pw_poses"][:, :7])
    sims = pw[:, :3] * al._pw_scale(params)[:, None, None]
    return objective.align_objective(data, params["log_depth"], al._focals(params), poses[:, :3],
                                     sims, params["s_depth"], params["t_depth"],
                                     al.valid_depth_group, depth_term)


def test_scene_gives_frames_one_to_four_slots():
    al = aligner()
    counts = np.bincount(al.groups.reshape(-1), minlength=al.N)
    assert counts.tolist() == [1, 2, 3, 4, 3, 2, 1]


@pytest.mark.parametrize("use_depth_traj", [False, True])
@pytest.mark.parametrize("focal", ["shared", "per_frame", "frozen"])
@pytest.mark.parametrize("conf_optimize", [True, False])
def test_objective_matches_the_aligners_form(use_depth_traj, focal, conf_optimize):
    """The loss and every leaf's gradient (s/t included, as JAX
    differentiates them) against autograd of the aligner's form."""
    al = aligner(conf_optimize=conf_optimize, shared_focal=focal != "per_frame",
                 pixel_terms_only=True)
    if focal == "frozen":
        al.preset_focal([21.0])
    params = {k: p.detach().clone().requires_grad_(k != "focal" or focal != "frozen")
              for k, p in al.params.items()}
    leaves = [p for p in params.values() if p.requires_grad]
    want = al.loss_fn(params, use_depth_traj)
    want_g = torch.autograd.grad(want, leaves, allow_unused=True)
    got = op_loss(al, data_of(al), params, use_depth_traj)
    got_g = torch.autograd.grad(got, leaves, allow_unused=True)
    assert abs(got.item() - want.item()) <= LOSS_REL * abs(want.item())
    for name, a, b in zip([k for k, p in params.items() if p.requires_grad], got_g, want_g):
        if b is None:
            # s/t take no gradient without the depth term, traj_align none
            # without the trajectory term
            assert a is None or not a.any(), name
            continue
        assert rel_l2(a, b) <= GRAD_REL, (name, rel_l2(a, b))


def test_loss_only_variant_gives_the_same_loss():
    al = aligner()
    data = data_of(al)
    with torch.no_grad():
        a = op_loss(al, data, al.params, True)
    params = {k: p.detach().clone().requires_grad_() for k, p in al.params.items()}
    b = op_loss(al, data, params, True)
    assert torch.equal(a, b.detach())


def test_csr_map_lists_each_frames_entries_windows_ascending():
    # entry e = g * S + slot: frame 2 in entry 0, frame 0 in 1 and 2, frame 1 in 3
    groups = np.array([[2, 0], [0, 1]])
    pred = torch.zeros(2, 2, 3, 3)
    data = objective.ObjectiveData(groups, pred, torch.ones(2, 2, 3), None, (1, 3), None,
                                   0.05, 2.0)
    assert data.frame_ptr.tolist() == [0, 2, 3, 4]
    assert data.entries.tolist() == [1, 2, 3, 0]
    assert data.slots.tolist() == [[1, 2], [3, 4], [0, 4]]          # 4 = E pads
    al = aligner()
    data = data_of(al)
    ptr, entries = data.frame_ptr.tolist(), data.entries.tolist()
    flat = al.groups.reshape(-1)
    for n in range(al.N):
        mine = entries[ptr[n]:ptr[n + 1]]
        assert mine == sorted(mine) and all(flat[e] == n for e in mine)
        assert mine == [e for e in range(len(flat)) if flat[e] == n]


def _plain_args(al):
    with torch.no_grad():
        p = al.params
        pw = params_to_pose(p["pw_poses"][:, :7])
        sims = pw[:, :3] * al._pw_scale(p)[:, None, None]
        return (data_of(al), p["log_depth"].detach(), al._focals(p).detach(),
                params_to_pose(p["poses"])[:, :3], sims, p["s_depth"].detach(),
                p["t_depth"].detach(), al.valid_depth_group)


@pytest.mark.parametrize("order", ["windows_ascending", "reversed"])
def test_log_depth_gradient_sums_entries_windows_ascending(order):
    """d log_depth, bit for bit, from a float32 loop over each frame's
    entries in the stated order; the reversed order gives other bits."""
    al = aligner()
    args = _plain_args(al)
    data, ld, f, poses, sims = args[:5]
    _, flat = objective.align_objective_plain(*args, False, True)
    got = data.split(flat)[0].numpy()

    f32 = np.float32
    z = torch.exp(ld).numpy()
    pix = np.arange(data.P)
    u, v = (pix % data.W).astype(f32), (pix // data.W).astype(f32)
    fn = f.numpy()[:, None]
    rel = [z * (u - f32(data.W / 2)) / fn, z * (v - f32(data.H / 2)) / fn, z]
    R = poses.numpy()
    M = sims.numpy()
    pred = data.pred.numpy()
    w = np.minimum(data.weights.numpy(), f32(data.clamp))
    inv_area = f32(1.0 / data.area)
    want = np.zeros_like(got)
    for n in range(data.N):
        proj = [R[n, r, 0] * rel[0][n] + R[n, r, 1] * rel[1][n] + R[n, r, 2] * rel[2][n]
                + R[n, r, 3] for r in range(3)]
        G = [np.zeros(data.P, f32) for _ in range(3)]
        mine = [e for e in range(data.E) if data.entry_frame[e] == n]
        for e in (mine if order == "windows_ascending" else mine[::-1]):
            g = e // data.S
            x, y, w0 = pred[e, :, 0], pred[e, :, 1], pred[e, :, 2]
            d = [proj[r] - (M[g, r, 0] * x + M[g, r, 1] * y + M[g, r, 2] * w0 + M[g, r, 3])
                 for r in range(3)]
            # PyTorch's CPU square root (SLEEF, within 0.5001 ulp), not numpy's
            nrm = torch.sqrt(torch.from_numpy(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                                              + f32(1e-12))).numpy()
            c = w[e] * inv_area / nrm
            G = [G[r] + c * d[r] for r in range(3)]
        a = [R[n, 0, col] * G[0] + R[n, 1, col] * G[1] + R[n, 2, col] * G[2] for col in range(3)]
        want[n] = a[0] * rel[0][n] + a[1] * rel[1][n] + a[2] * rel[2][n]
    if order == "windows_ascending":
        np.testing.assert_array_equal(got, want)
    else:
        assert not np.array_equal(got, want)


def test_plain_version_repeats_bit_for_bit():
    al = aligner()
    args = _plain_args(al)
    l1, g1 = objective.align_objective_plain(*args, True, True)
    l2, g2 = objective.align_objective_plain(*args, True, True)
    assert torch.equal(l1, l2) and torch.equal(g1, g2)


@pytest.mark.parametrize("rows", ["points", "depths", "poses"])
def test_frame_gather_backward_equals_index_selects_bit_for_bit(rows):
    """The aligner's gathers sum each frame's copies in entry order, as
    index_add does on the CPU."""
    al = aligner()
    shape = {"points": (al.N, al.P, 3), "depths": (al.N, al.P), "poses": (al.N, 4, 4)}[rows]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen, requires_grad=True)
    g = torch.randn((al.G * al.S,) + shape[1:], generator=gen)
    y = al._gather(x)
    assert torch.equal(y, x.detach().index_select(0, al.buf["e_all"]))
    (got,) = torch.autograd.grad(y, x, g)
    (want,) = torch.autograd.grad(x.index_select(0, al.buf["e_all"]), x, g)
    assert torch.equal(got, want)


def test_frame_slots_list_entries_ascending_and_skip_absent_frames():
    # entry e = g * S + slot: frame 0 in entry 0, frame 2 in 1 and 2, frame 3
    # in 3, frame 1 in none
    groups = np.array([[0, 2], [2, 3]])
    al = GroupAligner(groups, np.zeros((2, 2, 1, 2, 3), np.float32), np.ones((2, 2, 1, 2)),
                      (1, 2), device="cpu")
    assert al.buf["frame_slots"].tolist() == [[0, 4], [4, 4], [1, 2], [3, 4]]
    x = torch.randn(4, 2, requires_grad=True)
    g = torch.randn(4, 2)
    (got,) = torch.autograd.grad(al._gather(x), x, g)
    assert torch.equal(got, torch.stack([g[0], torch.zeros(2), g[1] + g[2], g[3]]))


def test_calibrate_writes_the_gates_in_place():
    al = aligner()
    ptrs = (al.valid_depth_group.data_ptr(), al.valid_traj_group.data_ptr())
    al.calibrate()
    assert (al.valid_depth_group.data_ptr(), al.valid_traj_group.data_ptr()) == ptrs
    assert al.valid_depth_group.sum() > 0


# ---------------- on the card ----------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [False, True])
def test_kernel_matches_plain_and_repeats(depth):
    dev = _cuda()
    al = aligner()
    al.calibrate()
    cpu_args = _plain_args(al)
    args = (data_of(al, dev),) + tuple(t.to(dev) for t in cpu_args[1:])
    lk, gk = objective.align_objective_forward(*args, depth, True)
    lk2, gk2 = objective.align_objective_forward(*args, depth, True)
    lp, gp = objective.align_objective_plain(*cpu_args, depth, True)
    assert torch.equal(lk, lk2) and torch.equal(gk, gk2)
    assert abs(lk.item() - lp.item()) <= LOSS_REL * abs(lp.item())
    for a, b in zip(args[0].split(gk.cpu()), cpu_args[0].split(gp)):
        if b.any():
            assert rel_l2(a, b) <= GRAD_REL


@pytest.mark.gpu
def test_frame_gather_backward_equals_deterministic_index_select():
    """On the card, at the recon cell's shapes (32 frames of 256x576 in 5
    windows of 16 at stride 4): bit for bit what index_select's backward
    gives with PyTorch's deterministic algorithms (the reference's)."""
    dev = _cuda()
    groups = np.array([np.arange(16) + 4 * g for g in range(5)])
    P = 256 * 576
    al = GroupAligner(groups, torch.zeros(5, 16, P, 3, device=dev),
                      torch.ones(5, 16, P, device=dev), (256, 576))
    gen = torch.Generator(device=dev).manual_seed(2)
    for shape in ((al.N, P, 3), (al.N, P), (al.N, 4, 4)):
        x = torch.randn(shape, generator=gen, device=dev, requires_grad=True)
        g = torch.randn((80,) + shape[1:], generator=gen, device=dev)
        (got,) = torch.autograd.grad(al._gather(x), x, g)
        torch.use_deterministic_algorithms(True)
        try:
            (want,) = torch.autograd.grad(x.index_select(0, al.buf["e_all"]), x, g)
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.equal(got, want), shape


@pytest.mark.gpu
def test_graph_run_equals_eager_run():
    dev = _cuda()
    sc = synthetic_scene(**SCENE)
    preds = {k: torch.from_numpy(v).to(dev) for k, v in sc["preds"].items()}
    runs = []
    for mode in (contextlib.nullcontext, graphs.eager):
        al = GroupAligner(sc["groups"], preds["pts3d"], preds["conf"], sc["hw"],
                          invdepth=preds["inv_depth"], trajs=preds["traj"],
                          config=AlignerConfig(n_iter=12, depth_traj_start_iter=5))
        with mode():
            al.run()
        runs.append(al)
    for k in runs[0].params:
        assert torch.equal(runs[0].params[k], runs[1].params[k]), k
    assert runs[0].final_loss == runs[1].final_loss
