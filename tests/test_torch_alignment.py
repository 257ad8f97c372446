"""The PyTorch port's alignment stack against the JAX package, on the CPU in
float32: geometry codecs, MoGe focal recovery, the IRLS calibration solve,
the pre-PnP init, PnP against OpenCV, the aligner's loss and gradient, its
two-phase run from the same state, and init + run end to end.

Tolerances (relative unless said otherwise):
  * codecs, umeyama_sim3, point_map_to_depth, lad_align_irls: 1e-5;
  * loss value 1e-5, gradient 1e-4 (of each leaf's largest entry), both phases;
  * run() from carried post-init state (40 iterations, calibration at 20):
    equal gates; final loss, poses, focal, depths 1e-3 (relative L2 for
    arrays). Adam turns any gradient into a step of ~lr, so float32
    summation-order noise on residuals near zero grows over the run; the
    predictions carry 0.03 noise, as a model's do, so that no residual sits
    at exactly zero;
  * pre-PnP init against `_init_gather_dev`: 1e-4;
  * PnP against fast_pnp_points (OpenCV): the same focal candidate, rotation
    <= 0.1 deg, translation 1e-3;
  * init + 60 iterations in each package (different PnP): both meet the
    ground-truth bounds of tests/test_alignment.py and their focals agree
    within 2%.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geo4d_tpu.alignment.cleanup import clean_pointcloud as jax_clean_pointcloud
from geo4d_tpu.alignment.init import _init_gather_dev
from geo4d_tpu.alignment.init import init_from_group as jax_init_from_group
from geo4d_tpu.alignment.optimizer import AlignerConfig as JaxAlignerConfig
from geo4d_tpu.alignment.optimizer import GroupAligner as JaxGroupAligner
from geo4d_tpu.evals import depth as jax_depth
from geo4d_tpu.evals.depth import depth_evaluation
from geo4d_tpu.evals.trajectory import Trajectory, eval_metrics
from geo4d_tpu.geometry import moge as jax_moge
from geo4d_tpu.geometry import se3 as jax_se3
from geo4d_tpu.geometry import utils as jax_utils
from geo4d_tpu.geometry.pnp import fast_pnp_points as cv2_fast_pnp_points
from geo4d_tpu_torch.alignment.cleanup import clean_pointcloud
from geo4d_tpu_torch.alignment.init import _init_gather, init_from_group, pnp_subsample
from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
from geo4d_tpu_torch.evals import depth as port_depth
from geo4d_tpu_torch.geometry import moge as port_moge
from geo4d_tpu_torch.geometry import se3 as port_se3
from geo4d_tpu_torch.geometry import utils as port_utils
from geo4d_tpu_torch.geometry.pnp import fast_pnp_points
from _torch_parity import aligner_state_from_jax, load_aligner_state, rel_err, to_torch
from test_alignment import build_synthetic_scene, make_window_preds

torch.set_num_threads(1)
GROUPS = np.array([[0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7]])


def close(got, want, rtol, what=""):
    """|got - want| <= rtol * max|want| (elementwise, relative to the scale)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if want.size else 0.0
    scale = max(float(np.abs(want).max()), 1e-12) if want.size else 1.0
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol:g} x {scale:.3e}"


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(jax_se3.quat_to_rotmat(jnp.asarray(q)))


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("fn", ["quat_to_rotmat", "rotmat_to_quat", "pose_to_params",
                                "params_to_pose", "signed_log1p", "signed_expm1",
                                "sRT_to_mat4", "inv_se3", "geotrf", "depthmap_to_pts3d",
                                "make_intrinsics"])
def test_geometry_functions_match_jax(fn):
    rng = np.random.default_rng(0)
    R = random_rotations(rng, 6)
    T = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(6, 3))
    s = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    args = {
        "quat_to_rotmat": (rng.normal(size=(6, 4)).astype(np.float32),),
        # includes rotations near 180 degrees (w anchor is not the largest)
        "rotmat_to_quat": (np.concatenate([R, np.diag([1.0, -1, -1])[None].astype(np.float32)]),),
        "pose_to_params": (T,),
        "params_to_pose": (rng.normal(size=(6, 7)).astype(np.float32),),
        "signed_log1p": (rng.normal(scale=3, size=(6, 3)).astype(np.float32),),
        "signed_expm1": (rng.normal(size=(6, 3)).astype(np.float32),),
        "sRT_to_mat4": (s[0], R[0], T[0, :3, 3]),
        "inv_se3": (T * np.concatenate([np.broadcast_to(s[:, None, None], (6, 3, 4)),
                                        np.ones((6, 1, 4))], 1).astype(np.float32),),
        "geotrf": (T, rng.normal(size=(6, 5, 3)).astype(np.float32)),
        "depthmap_to_pts3d": (rng.uniform(1, 3, size=(2, 6, 8)).astype(np.float32),
                              np.asarray(jax_utils.make_intrinsics(np.array([7.0, 9.0]), 4.0, 3.0))),
        "make_intrinsics": (rng.uniform(5, 9, size=(3,)).astype(np.float32),),
    }[fn]
    extra = {"make_intrinsics": (4.0, 3.0)}.get(fn, ())
    mod_j = jax_utils if hasattr(jax_utils, fn) and not hasattr(jax_se3, fn) else jax_se3
    mod_p = port_utils if mod_j is jax_utils else port_se3
    want = np.asarray(getattr(mod_j, fn)(*[jnp.asarray(a) for a in args], *extra))
    got = getattr(mod_p, fn)(*[torch.as_tensor(np.array(a)) for a in args], *extra)
    if fn == "rotmat_to_quat":  # q and -q are the same rotation
        got = got * torch.sign((got * torch.tensor(want)).sum(-1, keepdim=True))
    close(got, want, 1e-5, fn)


@pytest.mark.parametrize("weighted", [False, True])
def test_umeyama_sim3_batched_matches_jax(weighted):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(3, 50, 3)).astype(np.float32)
    R = random_rotations(rng, 3)
    dst = 1.7 * src @ R.transpose(0, 2, 1) + rng.normal(size=(3, 1, 3)).astype(np.float32)
    dst = dst + rng.normal(scale=0.05, size=dst.shape).astype(np.float32)
    w = rng.uniform(0, 1, size=(3, 50)).astype(np.float32) if weighted else None
    for g in range(3):
        want = jax_se3.umeyama_sim3(jnp.asarray(src[g]), jnp.asarray(dst[g]),
                                    None if w is None else jnp.asarray(w[g]))
        got = port_se3.umeyama_sim3(to_torch(src), to_torch(dst),
                                    None if w is None else to_torch(w))
        for name, a, b in zip("sRt", got, want):
            close(a[g], np.asarray(b), 1e-5, f"umeyama {name}")


@pytest.mark.parametrize("downsampled", [False, True])
def test_point_map_to_depth_batched_matches_jax(downsampled):
    """Three slanted, shifted point maps (24 x 40) with a mask; `downsampled`
    passes 16 x 16 maps the caller already cut, with `image_size=`."""
    rng = np.random.default_rng(2)
    h, w = 24, 40
    yy, xx = np.mgrid[:h, :w]
    maps = []
    for g in range(3):
        z = 2.0 + 0.3 * g + 1.5 * xx / w + 0.3 * np.sin(yy / 3.0)
        f = 30.0 + 5 * g
        maps.append(np.stack([(xx - w / 2) / f * z, (yy - h / 2) / f * z, z - 1.0 - 0.2 * g], -1))
    pts = np.stack(maps).astype(np.float32)
    mask = rng.uniform(size=(3, h, w)) > 0.2
    kw = dict(downsample_size=(16, 16))
    if downsampled:
        yi, xi = np.arange(16) * h // 16, np.arange(16) * w // 16
        pts, mask = pts[:, yi][:, :, xi], mask[:, yi][:, :, xi]
        kw["image_size"] = (h, w)
    want = jax_moge.point_map_to_depth(jnp.asarray(pts), jnp.asarray(mask), **kw)
    got = port_moge.point_map_to_depth(to_torch(pts), to_torch(mask), **kw)
    for name, a, b in zip(("depth", "fov_x", "fov_y", "shift"), got, want):
        close(a, np.asarray(b), 1e-5, name)


def test_lad_align_irls_batched_matches_jax():
    """A line with 7% outliers: the L1 optimum is sharp. (On noisy data it is
    flat, and float32 IRLS stops at a point that depends on summation order:
    at 0.02 Laplace noise the two packages differ by 5e-4.)"""
    rng = np.random.default_rng(3)
    pred = rng.uniform(0.1, 1.0, size=(4, 300)).astype(np.float32)
    gt = (1.7 * pred + 0.2).astype(np.float32)
    gt[:, :20] += 3.0                                         # outliers
    mask = rng.uniform(size=pred.shape) > 0.3
    mask[3] = rng.uniform(size=300) > 0.5                     # even/odd counts differ
    s_j, t_j = jax_depth.lad_align_irls_batched(jnp.asarray(pred), jnp.asarray(gt),
                                                 jnp.asarray(mask))
    s_p, t_p = port_depth.lad_align_irls(to_torch(pred), to_torch(gt), to_torch(mask))
    close(s_p, np.asarray(s_j), 1e-5, "s")
    close(t_p, np.asarray(t_j), 1e-5, "t")


def test_masked_median_lower_middle():
    x = np.array([[4.0, 1.0, 3.0, 2.0, 9.0], [5.0, 7.0, 6.0, 8.0, 0.0]], np.float32)
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    want = [float(jax_depth._masked_median(jnp.asarray(x[i]), jnp.asarray(mask[i])))
            for i in range(2)]
    assert want == [2.0, 6.0]
    assert port_depth._masked_median(to_torch(x), to_torch(mask)).tolist() == want


# ---------------------------------------------------------------- PnP


def pnp_scene(seed, w=576, h=256, focal_index=20, n=3000, outliers=0.2):
    """Correspondences of a random camera on points with depth 2-8 whose
    focal lies on the sweep grid; `outliers` of the pixels are replaced by
    uniform ones."""
    rng = np.random.default_rng(seed)
    S = max(w, h)
    f = np.geomspace(S / 2, 3 * S, 63)[focal_index]
    px = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1)
    z = rng.uniform(2, 8, n)
    cam = np.stack([(px[:, 0] - w / 2) / f * z, (px[:, 1] - h / 2) / f * z, z], -1)
    c2w = np.eye(4)
    c2w[:3, :3] = random_rotations(rng, 1)[0]
    c2w[:3, 3] = rng.normal(size=3)
    world = cam @ c2w[:3, :3].T + c2w[:3, 3]
    bad = rng.random(n) < outliers
    px[bad] = np.stack([rng.uniform(0, w, bad.sum()), rng.uniform(0, h, bad.sum())], -1)
    return world.astype(np.float32), px, f, (w, h)


def rotation_deg(A, B):
    c = (np.trace(A[:3, :3].T @ B[:3, :3]) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("known_focal", [False, True])
def test_pnp_matches_opencv(seed, known_focal):
    p3, p2, f, size = pnp_scene(seed)
    want = cv2_fast_pnp_points(p3, p2, size, focal=f if known_focal else None)
    got = fast_pnp_points(p3, p2, size, focal=f if known_focal else None)
    assert want is not None and got is not None
    assert got[0] == want[0]                         # the same focal candidate
    assert rotation_deg(got[1], want[1]) <= 0.1
    t_got, t_want = got[1][:3, 3], want[1][:3, 3]
    assert np.linalg.norm(t_got - t_want) <= 1e-3 * np.linalg.norm(t_want)


def test_pnp_degenerate_inputs_fail():
    size = (64, 48)
    pix = np.random.default_rng(0).uniform(0, 48, size=(40, 2))
    assert fast_pnp_points(np.ones((40, 3), np.float32), pix, size) is None    # all equal
    assert fast_pnp_points(np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32),
                           pix[:3], size) is None                              # too few


# ---------------------------------------------------------------- aligner


def scene(noise=0.0):
    pts_world, poses, depths, focal = build_synthetic_scene()
    preds = make_window_preds(pts_world, poses, GROUPS).astype(np.float32)
    if noise:
        preds += np.random.default_rng(3).normal(0, noise, preds.shape).astype(np.float32)
    conf = np.ones(preds.shape[:-1], np.float32)
    G, S = GROUPS.shape
    h, w = depths.shape[1:]
    invd = np.zeros((G, S, h, w), np.float32)
    trajs = np.zeros((G, S, 4, 4), np.float32)
    rng = np.random.default_rng(7)
    for g in range(G):
        sc = rng.uniform(0.5, 2.0)
        for s, i in enumerate(GROUPS[g]):
            invd[g, s] = 1.0 / depths[i] * sc
            trajs[g, s] = poses[i]
    return dict(preds=preds, conf=conf, invd=invd, trajs=trajs, poses=poses, depths=depths,
                focal=focal, hw=(h, w))


def port_config(jax_cfg) -> AlignerConfig:
    """The port's AlignerConfig with the JAX config's values (the JAX
    compile-reuse buckets have no counterpart)."""
    return AlignerConfig(**{f.name: getattr(jax_cfg, f.name)
                            for f in dataclasses.fields(AlignerConfig)})


def test_aligner_config_matches_jax():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxAlignerConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(AlignerConfig)}
    assert set(jax_fields) - set(port_fields) == {"bucket_groups", "bucket_frames"}
    assert port_fields == {k: v for k, v in jax_fields.items() if k in port_fields}


def both_aligners(sc, **cfg):
    jcfg = JaxAlignerConfig(bucket_groups=1, bucket_frames=1, **cfg)
    ja = JaxGroupAligner(GROUPS, sc["preds"], sc["conf"], sc["hw"], invdepth=sc["invd"],
                         trajs=sc["trajs"], config=jcfg)
    jax_init_from_group(ja, jnp.asarray(sc["preds"]), jnp.asarray(sc["conf"]))
    pa = GroupAligner(GROUPS, sc["preds"], sc["conf"], sc["hw"], invdepth=sc["invd"],
                      trajs=sc["trajs"], config=port_config(jcfg), device="cpu")
    return ja, pa


@pytest.fixture(scope="module")
def calibrated():
    """Post-init JAX state with calibrate() run, so both phase-2 gates are on.
    The predictions carry noise: on noise-free data many residuals are ~1e-6,
    where float32 rounding decides the direction of the L1 gradient."""
    ja, pa = both_aligners(scene(noise=0.03), n_iter=40, depth_traj_start_iter=20,
                           temporal_smoothing_weight=0.015)
    ja.calibrate()
    # calibrate aligns each window's first camera exactly, where the pose
    # loss sits at its sqrt(0 + 1e-12) kink; move off it (same values in both)
    ja.params["traj_align"] = ja.params["traj_align"] + jnp.asarray(
        np.random.default_rng(5).normal(0, 0.01, ja.params["traj_align"].shape), jnp.float32)
    load_aligner_state(pa, aligner_state_from_jax(ja))
    assert float(pa.valid_traj_group.sum()) > 0 and float(pa.valid_depth_group.sum()) > 0
    return ja, pa


@pytest.mark.parametrize("use_depth_traj", [False, True])
def test_loss_and_gradient_match_jax(calibrated, use_depth_traj):
    ja, pa = calibrated
    val_j, grad_j = jax.jit(jax.value_and_grad(
        lambda p: ja.loss_fn(p, use_depth_traj)))(ja.params)
    # every leaf, the frozen s/t included (JAX differentiates them all)
    params = {k: p.detach().clone().requires_grad_() for k, p in pa.params.items()}
    val_p = pa.loss_fn(params, use_depth_traj)
    grads = torch.autograd.grad(val_p, list(params.values()), allow_unused=True)
    assert abs(val_p.item() - float(val_j)) <= 1e-5 * abs(float(val_j))
    for (name, p), g in zip(params.items(), grads):
        want = np.asarray(grad_j[name])[: p.shape[0]]
        close(torch.zeros_like(p) if g is None else g, want, 1e-4, f"grad {name}")


def test_run_from_carried_state_matches_jax():
    sc = scene(noise=0.03)
    ja, pa = both_aligners(sc, n_iter=40, depth_traj_start_iter=20, lr=0.005,
                           temporal_smoothing_weight=0.015)
    load_aligner_state(pa, aligner_state_from_jax(ja))
    final_j = ja.run()
    final_p = pa.run()
    np.testing.assert_array_equal(pa.valid_depth_group.numpy(), np.asarray(ja.valid_depth_group))
    np.testing.assert_array_equal(pa.valid_traj_group.numpy(), np.asarray(ja.valid_traj_group))
    assert abs(final_p - final_j) <= 1e-3 * abs(final_j)
    assert rel_err(pa.get_im_poses(), ja.get_im_poses()) <= 1e-3
    assert rel_err(pa.get_focals(), ja.get_focals()) <= 1e-3
    assert rel_err(pa.get_depthmaps(), ja.get_depthmaps()) <= 1e-3


def test_frozen_leaves_stay_out_of_the_optimizer():
    """s/t (set by calibration) and a preset focal take no gradient and no
    Adam step: the focal ends where it was preset, as under the JAX
    package's gradient mask."""
    sc = scene(noise=0.03)
    ja, pa = both_aligners(sc, n_iter=6, depth_traj_start_iter=3)
    load_aligner_state(pa, aligner_state_from_jax(ja))
    pa.preset_focal([sc["focal"]])
    f0 = pa.params["focal"].detach().clone()
    assert pa.focal_frozen
    pa.run()
    assert torch.equal(pa.params["focal"], f0)
    assert not any(pa.params[k].requires_grad for k in ("s_depth", "t_depth", "focal"))
    assert float(pa.params["s_depth"].sub(1).abs().max()) > 0      # calibrate wrote them


def test_pre_pnp_init_matches_jax():
    sc = scene()
    G, S = GROUPS.shape
    h, w = sc["hw"]
    P, N = h * w, int(GROUPS.max()) + 1
    pred = sc["preds"].reshape(G, S, P, 3)
    conf = sc["conf"].reshape(G, S, P)
    sel = pnp_subsample(P)
    want = _init_gather_dev(jnp.asarray(pred), jnp.asarray(conf), jnp.asarray(GROUPS),
                            jnp.asarray(sel), 64, 64, h, w, N)
    got = _init_gather(to_torch(pred), to_torch(conf), GROUPS, torch.from_numpy(sel), h, w, N)
    names = ("fov_x", "fov_y", "sub", "sub_mask", "s_all", "R_all", "t_all", "pts_acc", "conf_acc")
    for name, a, b in zip(names, got, want):
        if name == "sub":                      # the JAX package casts it to f16 for transfer
            continue
        close(a.float(), np.asarray(b, np.float32), 1e-4, name)


def test_init_and_run_meet_ground_truth_bounds():
    sc = scene()
    cfg = dict(n_iter=60, depth_traj_start_iter=60, lr=0.01, temporal_smoothing_weight=0.0)
    ja, pa = both_aligners(sc, **cfg)
    pa_failures = init_from_group(pa, sc["preds"], sc["conf"])
    assert pa_failures == 0
    ref = Trajectory.from_matrices(sc["poses"])
    focals = []
    for al in (ja, pa):
        f = float(al.get_focals()[0])
        assert f == pytest.approx(sc["focal"], rel=0.2)
        ate, _, _ = eval_metrics(Trajectory.from_matrices(al.get_im_poses()), ref)
        assert ate < 0.05
        al.run()
        out = depth_evaluation(al.get_depthmaps().ravel(), sc["depths"].ravel(), align="scale",
                               max_depth=None)
        assert out["Abs Rel"] < 0.05
        focals.append(float(al.get_focals()[0]))
    assert abs(focals[0] - focals[1]) <= 0.02 * focals[0]


def test_cleanup_matches_jax():
    sc = scene()
    ja, pa = both_aligners(sc, n_iter=0)
    load_aligner_state(pa, aligner_state_from_jax(ja))
    rng = np.random.default_rng(4)
    confs = rng.uniform(0.5, 2.0, size=(8,) + sc["hw"]).astype(np.float32)
    depths = ja.get_depthmaps() * rng.uniform(0.9, 1.1, size=confs.shape).astype(np.float32)
    K, c2w = ja.get_intrinsics(), ja.get_im_poses()
    w2c = np.asarray(jax_utils.inv_se3(jnp.asarray(c2w)))
    pts = ja.get_pts3d()
    want = jax_clean_pointcloud(jnp.asarray(confs), jnp.asarray(K), jnp.asarray(w2c),
                                jnp.asarray(depths), jnp.asarray(pts))
    got = clean_pointcloud(to_torch(confs), to_torch(K), to_torch(w2c), to_torch(depths),
                           to_torch(pts))
    assert float((np.asarray(want) != got.numpy()).mean()) <= 1e-3
    assert float((got.numpy() < confs).mean()) > 0          # the filter did something
