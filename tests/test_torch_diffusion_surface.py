"""The rest of the PyTorch port's diffusion surface against the JAX package,
on the CPU in float32 with the tiny preset (T = 4, 32 x 64 frames; the same
randomised weights through the weights bridge): every `decode_modality`
layout, the per-channel encode (posterior mean) and confidence decode,
q_sample and get_v, DDIM inversion with a shared stand-in model, the
stochastic encode with the JAX package's own noise, and the aligner's
initialisation from known cameras.

Tolerances:
  * decoders and the per-channel encode: 1e-5 of each output's largest
    magnitude (measured: at most 1.03e-6 with these weights);
  * q_sample, get_v, stochastic_encode, ddim_encode: 1e-5 abs + 1e-5 rel;
  * init_from_known_poses: every parameter 1e-5 of its scale after init;
    after 20 iterations (calibration at 10) the tolerances of
    tests/test_torch_alignment.py: equal gates, final loss, poses and
    depths 1e-3 relative, the frozen focal equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geo4d_tpu.alignment.init import init_from_known_poses as jax_init_from_known_poses
from geo4d_tpu.alignment.optimizer import AlignerConfig as JaxAlignerConfig
from geo4d_tpu.alignment.optimizer import GroupAligner as JaxGroupAligner
from geo4d_tpu.core.schedules import DiffusionSchedule
from geo4d_tpu.models.presets import tiny as jax_tiny
from geo4d_tpu.sampling import ddim as jax_ddim
from geo4d_tpu_torch.alignment.init import init_from_known_poses
from geo4d_tpu_torch.alignment.optimizer import GroupAligner
from geo4d_tpu_torch.core.schedules import DiffusionSchedule as PortDiffusionSchedule
from geo4d_tpu_torch.models.presets import tiny
from geo4d_tpu_torch.sampling import ddim
from _torch_parity import aligner_state_from_jax, assert_close, load_from_jax, randomize, to_torch
from test_torch_alignment import GROUPS, close, port_config, scene

torch.set_num_threads(1)

T, H, W = 4, 32, 64
LAYOUTS = {"pc_ray_cross_depth": 16, "pc_ray": 8, "pc": 4, "multipc": 12, "img_vidpc": 8,
           "rgb": 4}
DECODE_RTOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """The two VAEs only: nothing here runs the other towers."""
    jm = jax_tiny(temporal_length=T)
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    x = jnp.zeros((1, H, W, 3))
    params = randomize({
        "vae": jax.jit(lambda k: jm.vae.init(k, x))(k0),
        "pointmap_vae": jax.jit(lambda k: jm.pointmap_vae.init(
            k, x, method=jm.pointmap_vae.init_all))(k1)}, seed=0)
    pm = tiny(temporal_length=T)
    load_from_jax(pm, params)
    return jm, params, pm


def close_to_scale(got, want, what):
    want = np.asarray(want)
    assert_close(got, want, DECODE_RTOL * float(np.abs(want).max()), 0.0, what)


@pytest.mark.parametrize("modality", list(LAYOUTS))
def test_decode_modality_matches_jax(models, modality):
    jm, params, pm = models
    z = np.random.default_rng(1).normal(size=(1, T, H // 8, W // 8, LAYOUTS[modality]))
    z = z.astype(np.float32)
    want = jax.jit(lambda p, s: jm.decode_modality(p, s, modality))(params, jnp.asarray(z))
    with torch.no_grad():
        got = pm.decode_modality(to_torch(z), modality)
    assert set(got) == set(want)
    for k in want:
        close_to_scale(got[k], want[k], f"{modality} {k}")


def test_decode_modality_unknown_layout_raises(models):
    with pytest.raises(NotImplementedError, match="voxels"):
        models[2].decode_modality(torch.zeros(1, T, 4, 8, 4), "voxels")


def test_perchannel_encode_and_conf_decode_match_jax(models):
    jm, params, pm = models
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(1, T, H, W, 3)).astype(np.float32)
    z = rng.normal(size=(1, T, H // 8, W // 8, 12)).astype(np.float32)
    want_z = jax.jit(jm.encode_first_stage_perchannel)(params, jnp.asarray(x))
    want_d = jax.jit(jm.decode_perchannel_conf)(params, jnp.asarray(z))
    with torch.no_grad():
        got_z = pm.encode_first_stage_perchannel(to_torch(x))
        got_d = pm.decode_perchannel_conf(to_torch(z))
    assert got_z.shape == (1, T, H // 8, W // 8, 12) and got_d.shape == (1, T, H, W, 4)
    close_to_scale(got_z, want_z, "encode_first_stage_perchannel")
    close_to_scale(got_d, want_d, "decode_perchannel_conf")


@pytest.mark.parametrize("fn", ["q_sample", "get_v"])
def test_q_sample_and_get_v_match_jax(models, fn):
    jm, _, pm = models
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, T, 4, 8, 16)).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    t = np.array([5, 900])
    if fn == "q_sample":
        want = jm.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
        got = pm.q_sample(to_torch(x), torch.as_tensor(t), to_torch(noise))
    else:
        want = jm.get_v(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))
        got = pm.get_v(to_torch(x), to_torch(noise), torch.as_tensor(t))
    assert_close(got, np.asarray(want), 1e-5, 1e-5, fn)


def tables(steps=5):
    return (jax_ddim.DDIMTables.from_schedule(DiffusionSchedule.create(), steps),
            ddim.DDIMTables.from_schedule(PortDiffusionSchedule.create(), steps))


def test_stochastic_encode_with_the_jax_noise():
    """The RNGs differ: the JAX package's noise is recovered from its output
    and handed to the port's formula."""
    x0 = np.random.default_rng(4).normal(size=(2, T, 4, 8, 16)).astype(np.float32)
    jt, pt = tables()
    want = np.asarray(jax_ddim.stochastic_encode(jnp.asarray(x0), 3, jt, jax.random.PRNGKey(0)))
    a = np.float32(pt.alphas[3])
    noise = (want - np.sqrt(a) * x0) / np.sqrt(np.float32(1) - a)
    got = ddim.stochastic_encode(to_torch(x0), 3, pt, noise=to_torch(noise))
    assert_close(got, want, 1e-5, 1e-5, "stochastic_encode")
    drawn = ddim.stochastic_encode(to_torch(x0), 3, pt, generator=torch.Generator().manual_seed(0))
    again = ddim.stochastic_encode(to_torch(x0), 3, pt, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == x0.shape and torch.equal(drawn, again)


@pytest.mark.parametrize("parameterization,num_steps", [("v", None), ("v", 3), ("eps", None)])
def test_ddim_encode_matches_jax(parameterization, num_steps):
    x0 = np.random.default_rng(5).normal(size=(2, T, 4, 8, 16)).astype(np.float32)

    def model(x, t, lib):               # the same stand-in model on both sides
        return lib.tanh(0.7 * x) + t / 1000.0

    sched = dict(parameterization=parameterization,
                 rescale_betas_zero_snr=parameterization == "v")
    jt = jax_ddim.DDIMTables.from_schedule(DiffusionSchedule.create(**sched), 5)
    pt = ddim.DDIMTables.from_schedule(PortDiffusionSchedule.create(**sched), 5)
    kw = dict(parameterization=parameterization, num_steps=num_steps)
    want = jax_ddim.ddim_encode(lambda x, t, b: model(x, t, jnp), jnp.asarray(x0), jt, **kw)
    got = ddim.ddim_encode(lambda x, t, b: model(x, t, torch), to_torch(x0), pt, **kw)
    assert_close(got, np.asarray(want), 1e-5, 1e-5, "ddim_encode")


def known_pose_aligners(**cfg):
    sc = scene(noise=0.03)
    jcfg = JaxAlignerConfig(bucket_groups=1, bucket_frames=1, **cfg)
    args = (GROUPS, sc["preds"], sc["conf"], sc["hw"])
    kw = dict(invdepth=sc["invd"], trajs=sc["trajs"])
    ja = JaxGroupAligner(*args, config=jcfg, **kw)
    pa = GroupAligner(*args, config=port_config(jcfg), device="cpu", **kw)
    jax_init_from_known_poses(ja, sc["poses"], sc["focal"], sc["preds"], sc["conf"])
    init_from_known_poses(pa, sc["poses"], sc["focal"], sc["preds"])
    return ja, pa


def test_init_from_known_poses_matches_jax():
    ja, pa = known_pose_aligners(n_iter=20, depth_traj_start_iter=10)
    want = aligner_state_from_jax(ja)
    assert want["focal_frozen"] and pa.focal_frozen
    for k, p in pa.params.items():
        close(p, want[k], 1e-5, k)
    N = int(GROUPS.max()) + 1
    assert torch.isfinite(pa.params["log_depth"]).all() and pa.params["poses"].shape[0] == N


def test_run_after_known_poses_matches_jax():
    ja, pa = known_pose_aligners(n_iter=20, depth_traj_start_iter=10, lr=0.005,
                                 temporal_smoothing_weight=0.015)
    f0 = pa.params["focal"].detach().clone()
    final_j, final_p = ja.run(), pa.run()
    np.testing.assert_array_equal(pa.valid_depth_group.numpy(), np.asarray(ja.valid_depth_group))
    np.testing.assert_array_equal(pa.valid_traj_group.numpy(), np.asarray(ja.valid_traj_group))
    assert abs(final_p - final_j) <= 1e-3 * abs(final_j)
    assert torch.equal(pa.params["focal"], f0)
    np.testing.assert_array_equal(pa.get_focals(), np.asarray(ja.get_focals()))
    for name, got, want in (("poses", pa.get_im_poses(), ja.get_im_poses()),
                            ("depths", pa.get_depthmaps(), ja.get_depthmaps())):
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-3, (name, err)
