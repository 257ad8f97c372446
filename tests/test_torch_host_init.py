"""The port's host init chain (`init_from_group` on numpy inputs) and its
dense PnP against the JAX package's, on the synthetic scenes of
tests/test_torch_alignment.py, on the CPU in float32.

The two packages solve PnP differently (OpenCV against the port's torch
RANSAC), so the chain is compared twice:
  * with the JAX chain's `fast_pnp` replaced by the port's (in this test
    only), every parameter after init agrees to 1e-4 of its scale, and
    run() after it at tests/test_torch_alignment.py's tolerances (final loss,
    poses, focal, depths 1e-3);
  * with each package's own PnP, both meet that file's ground-truth bounds
    and their focals agree within 2%.
Dense PnP against OpenCV's: the same focal candidate, rotation <= 0.1 deg,
translation 1e-3 (as tests/test_torch_alignment.py holds the point form).
"""

import numpy as np
import pytest
import torch

import geo4d_tpu.alignment.init as jax_init
from geo4d_tpu.alignment.optimizer import AlignerConfig as JaxAlignerConfig
from geo4d_tpu.alignment.optimizer import GroupAligner as JaxGroupAligner
from geo4d_tpu.evals.depth import depth_evaluation
from geo4d_tpu.evals.trajectory import Trajectory, eval_metrics
from geo4d_tpu.geometry.pnp import fast_pnp as cv2_fast_pnp
from geo4d_tpu_torch.alignment import init as port_init
from geo4d_tpu_torch.alignment.optimizer import GroupAligner
from geo4d_tpu_torch.geometry.pnp import fast_pnp
from _torch_parity import rel_err
from test_torch_alignment import GROUPS, close, port_config, rotation_deg, scene

torch.set_num_threads(1)
INIT_RTOL = 1e-4
RUN_REL = 1e-3


def aligners(sc, **cfg):
    jcfg = JaxAlignerConfig(bucket_groups=1, bucket_frames=1, **cfg)
    ja = JaxGroupAligner(GROUPS, sc["preds"], sc["conf"], sc["hw"], invdepth=sc["invd"],
                         trajs=sc["trajs"], config=jcfg)
    pa = GroupAligner(GROUPS, sc["preds"], sc["conf"], sc["hw"], invdepth=sc["invd"],
                      trajs=sc["trajs"], config=port_config(jcfg), device="cpu")
    return ja, pa


@pytest.fixture
def shared_pnp(monkeypatch):
    """The JAX host chain with the port's PnP in place of OpenCV's."""
    def port_pnp(pts3d, mask, focal=None, niter=10, **kw):
        return fast_pnp(torch.from_numpy(np.asarray(pts3d, np.float32)),
                        torch.from_numpy(np.asarray(mask)), focal=focal, niter=niter, **kw)

    monkeypatch.setattr(jax_init, "fast_pnp", port_pnp)


@pytest.mark.parametrize("shared_focal", [True, False])
def test_host_init_matches_jax(shared_pnp, shared_focal):
    sc = scene(noise=0.03)
    ja, pa = aligners(sc, n_iter=40, shared_focal=shared_focal)
    jax_init.init_from_group(ja, sc["preds"], sc["conf"])
    assert port_init.init_from_group(pa, sc["preds"], sc["conf"]) == 0
    for name in ("pw_poses", "poses", "focal", "log_depth"):
        want = np.asarray(ja.params[name])[: pa.params[name].shape[0]]
        close(pa.params[name], want, INIT_RTOL, name)


def test_host_init_then_run_matches_jax(shared_pnp):
    sc = scene(noise=0.03)
    ja, pa = aligners(sc, n_iter=40, depth_traj_start_iter=20, lr=0.005,
                      temporal_smoothing_weight=0.015)
    jax_init.init_from_group(ja, sc["preds"], sc["conf"])
    port_init.init_from_group(pa, sc["preds"], sc["conf"])
    final_j, final_p = ja.run(), pa.run()
    np.testing.assert_array_equal(pa.valid_depth_group.numpy(), np.asarray(ja.valid_depth_group))
    np.testing.assert_array_equal(pa.valid_traj_group.numpy(), np.asarray(ja.valid_traj_group))
    assert abs(final_p - final_j) <= RUN_REL * abs(final_j)
    for what in ("get_im_poses", "get_focals", "get_depthmaps"):
        assert rel_err(getattr(pa, what)(), getattr(ja, what)()) <= RUN_REL, what


def test_host_init_meets_ground_truth_bounds():
    """Each package with its own PnP (OpenCV / the port's RANSAC)."""
    sc = scene()
    ja, pa = aligners(sc, n_iter=60, depth_traj_start_iter=60, lr=0.01,
                      temporal_smoothing_weight=0.0)
    jax_init.init_from_group(ja, sc["preds"], sc["conf"])
    assert port_init.init_from_group(pa, sc["preds"], sc["conf"]) == 0
    ref = Trajectory.from_matrices(sc["poses"])
    focals = []
    for al in (ja, pa):
        assert float(al.get_focals()[0]) == pytest.approx(sc["focal"], rel=0.2)
        assert eval_metrics(Trajectory.from_matrices(al.get_im_poses()), ref)[0] < 0.05
        al.run()
        out = depth_evaluation(al.get_depthmaps().ravel(), sc["depths"].ravel(), align="scale",
                               max_depth=None)
        assert out["Abs Rel"] < 0.05
        focals.append(float(al.get_focals()[0]))
    assert abs(focals[0] - focals[1]) <= 0.02 * focals[0]


def test_tensors_take_the_device_path(monkeypatch):
    sc = scene()
    _, pa = aligners(sc, n_iter=0)

    def refuse(*a, **k):
        raise AssertionError("the host chain ran")

    monkeypatch.setattr(port_init, "_init_from_group_host", refuse)
    assert port_init.init_from_group(pa, torch.from_numpy(sc["preds"]),
                                     torch.from_numpy(sc["conf"])) == 0
    with pytest.raises(AssertionError, match="host chain"):
        port_init.init_from_group(pa, sc["preds"], sc["conf"])


@pytest.mark.parametrize("known_focal", [False, True])
def test_dense_pnp_matches_opencv(known_focal):
    """A dense point map (every pixel of a 576 x 256 frame seen at its own
    pixel, 20% of the points moved off as outliers; a focal on the sweep's
    grid) with a mask."""
    w, h = 576, 256
    f = np.geomspace(w / 2, 3 * w, 63)[20]
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:h, :w]
    z = rng.uniform(2, 8, (h, w))
    cam = np.stack([(xx - w / 2) / f * z, (yy - h / 2) / f * z, z], -1)
    c2w = np.eye(4)
    c2w[:3, :3] = [[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1]]
    c2w[:3, 3] = [0.3, -0.2, 0.5]
    world = (cam @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)
    bad = rng.random((h, w)) < 0.2
    world[bad] += rng.normal(0, 2.0, (int(bad.sum()), 3)).astype(np.float32)
    mask = rng.random((h, w)) > 0.1
    want = cv2_fast_pnp(world, mask, focal=f if known_focal else None)
    got = fast_pnp(torch.from_numpy(world), torch.from_numpy(mask),
                   focal=f if known_focal else None)
    assert want is not None and got is not None
    assert got[0] == want[0]
    assert rotation_deg(got[1], want[1]) <= 0.1 and rotation_deg(got[1], c2w) <= 0.1
    t_got, t_want = got[1][:3, 3], want[1][:3, 3]
    assert np.linalg.norm(t_got - t_want) <= 1e-3 * np.linalg.norm(t_want)
    assert fast_pnp(torch.from_numpy(world), torch.zeros(h, w, dtype=torch.bool)) is None
