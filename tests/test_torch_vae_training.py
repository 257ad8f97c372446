"""The port's VAE GAN fine-tuning (geo4d_tpu_torch/training/vae.py) against
the JAX package's (geo4d_tpu/training/vae.py), on the CPU in float32 with a
small VAE and discriminator, the same randomised weights and the same
posterior noise.

Tolerances: the losses of a generator and a discriminator step 1e-5
relative (float32 in other orders); their gradients, read from Adam's first
moment after the step ((1 - b1) g on both sides), 1e-5 relative L2 over the
tree and 1e-4 per tensor. The updated weights are not compared: Adam's
first update is close to lr * sign(g), and an entry whose gradient is ~0
(exactly 0 for the biases before a GroupNorm of one channel per group) takes
either sign on either side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geo4d_tpu.models.autoencoder import AutoencoderKL as JaxAutoencoderKL
from geo4d_tpu.models.autoencoder import VAEConfig as JaxVAEConfig
from geo4d_tpu.training import vae as jax_vae
from geo4d_tpu_torch.models.autoencoder import AutoencoderKL, VAEConfig
from geo4d_tpu_torch.training import vae
from geo4d_tpu_torch.core.draws import Draws, GivenDraws
from _torch_parity import randomize, rel_err, state_dict_from_jax, to_torch

torch.set_num_threads(1)

LOSS_REL = 1e-5
GRAD_REL = 1e-4
TREE_REL = 1e-5
ZERO_SHARE = 1e-6
CFG_V = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, adaptor_ch=8)


def test_hinge_loss_matches_jax():
    rng = np.random.default_rng(0)
    real, fake = rng.normal(size=(2, 3, 3, 1)).astype(np.float32), rng.normal(
        size=(2, 3, 3, 1)).astype(np.float32)
    want = float(jax_vae.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake)))
    assert abs(float(vae.hinge_d_loss(to_torch(real), to_torch(fake))) / want - 1) <= LOSS_REL
    assert float(vae.hinge_d_loss(torch.tensor([2.0]), torch.tensor([-2.0]))) < float(
        vae.hinge_d_loss(torch.tensor([-2.0]), torch.tensor([2.0])))


def disc_state_dict(params):
    """The JAX discriminator's tree -> the port's state dict."""
    out = {}
    for name, node in params["params"].items():
        if name.startswith("norm"):
            out[f"{name}.weight"] = to_torch(np.asarray(node["scale"]))
            out[f"{name}.bias"] = to_torch(np.asarray(node["bias"]))
        else:
            conv = node["Conv_0"]
            out[f"{name}.weight"] = to_torch(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
            out[f"{name}.bias"] = to_torch(np.asarray(conv["bias"]))
    return out


@pytest.fixture(scope="module")
def setup():
    x = (np.random.default_rng(1).normal(size=(2, 16, 16, 3)) * 0.3).astype(np.float32)
    jv = JaxAutoencoderKL(cfg=JaxVAEConfig(**CFG_V), with_adaptor=False, dtype=jnp.float32)
    params = randomize(jax.jit(lambda k: jv.init(k, x))(jax.random.PRNGKey(0)), seed=2)
    jd = jax_vae.PatchDiscriminator(base_ch=8, n_layers=2, dtype=jnp.float32)
    disc_params = randomize(jax.jit(jd.init)(jax.random.PRNGKey(1), x), seed=3)
    pv = AutoencoderKL(VAEConfig(**CFG_V), with_adaptor=False, dtype=torch.float32)
    pv.load_state_dict(state_dict_from_jax(params, "vae"), strict=True)
    pd = vae.PatchDiscriminator(3, base_ch=8, n_layers=2, dtype=torch.float32)
    pd.load_state_dict(disc_state_dict(disc_params), strict=True)
    return x, jv, params, jd, disc_params, pv, pd


def test_discriminator_matches_jax(setup):
    x, _, _, jd, disc_params, _, pd = setup
    want = np.asarray(jax.jit(jd.apply)(disc_params, x))
    with torch.no_grad():
        got = pd(to_torch(x))
    assert rel_err(got, want) <= LOSS_REL


def test_generator_and_discriminator_steps_match_jax(setup):
    x, jv, params, jd, disc_params, pv, pd = setup
    cfg = jax_vae.VAETrainConfig(learning_rate=1e-3, disc_start=0)
    g_step, d_step, init_state = jax_vae.make_vae_train_steps(
        lambda p, x, key: jv.apply(p, x, rng=key, sample=True), jd, cfg)
    jstate = init_state(params, disc_params)
    kg, kd = jax.random.PRNGKey(10), jax.random.PRNGKey(20)
    jstate1, jgm = jax.jit(g_step)(jstate, x, kg)
    jstate2, jdm = jax.jit(d_step)(jstate1, x, kd)

    # the posterior noise JAX draws from each key
    mean_shape = (2, 8, 8, 4)           # ch_mult (1, 2): one downsampling
    noise_g = np.asarray(jax.random.normal(kg, mean_shape))
    noise_d = np.asarray(jax.random.normal(kd, mean_shape))
    pcfg = vae.VAETrainConfig(learning_rate=1e-3, disc_start=0)

    def vae_apply(x, draws):  # the posterior sample with the given noise
        mean, logvar = pv.encode(x)
        return pv.decode(mean + torch.exp(0.5 * logvar) * draws.normal(mean.shape)), mean, logvar

    pg, pdstep, pinit = vae.make_vae_train_steps(pv, pd, pcfg, vae_apply)
    state = pinit()
    state, gm = pg(state, to_torch(x), GivenDraws([noise_g]))
    g_moment = {n: t.clone() for n, t in state.opt_state["exp_avg"].items()}
    # the discriminator step starts from the same VAE weights on both sides
    # (an entry whose gradient was ~0 may have moved the other way)
    state.params = {n: t.clone() for n, t in state_dict_from_jax(jstate1.params, "vae").items()}
    state, dm = pdstep(state, to_torch(x), GivenDraws([noise_d]))

    for k in ("loss", "rec", "kl", "g_gan"):
        assert abs(float(gm[k]) / float(jgm[k]) - 1) <= LOSS_REL, k
    assert abs(float(dm["d_loss"]) / float(jdm["d_loss"]) - 1) <= LOSS_REL
    assert state.step == int(jstate2.step) == 1

    # Adam's first moment after one update is (1 - b1) g: the gradients
    _check_grads(g_moment, state_dict_from_jax(jstate2.opt_state[0].mu, "vae"), "vae")
    _check_grads(state.disc_opt_state["exp_avg"],
                 disc_state_dict(jstate2.disc_opt_state[0].mu), "discriminator")


def _check_grads(got, want, what):
    """Tree within TREE_REL, each tensor within GRAD_REL, where a tensor
    whose exact gradient is zero (a bias just before a one-channel-per-group
    GroupNorm) is held to ZERO_SHARE of the tree's norm instead."""
    assert got.keys() == want.keys()
    got_all = np.concatenate([got[n].numpy().ravel() for n in want])
    want_all = np.concatenate([want[n].numpy().ravel() for n in want])
    assert rel_err(got_all, want_all) <= TREE_REL, what
    tree = float(np.linalg.norm(want_all))
    for n in want:
        if float(want[n].norm()) <= ZERO_SHARE * tree:
            assert float(got[n].norm()) <= ZERO_SHARE * tree, (what, n)
        else:
            assert rel_err(got[n], want[n]) <= GRAD_REL, (what, n)


def test_vae_training_reduces_reconstruction_loss(setup):
    x, *_ = setup
    torch.manual_seed(0)
    pv = AutoencoderKL(VAEConfig(**CFG_V), with_adaptor=False, dtype=torch.float32)
    pd = vae.PatchDiscriminator(3, base_ch=8, n_layers=2, dtype=torch.float32)
    g_step, d_step, init_state = vae.make_vae_train_steps(
        pv, pd, vae.VAETrainConfig(learning_rate=1e-3, disc_start=0))
    state = init_state()
    rec, d_losses = [], []
    for i in range(6):
        state, gm = g_step(state, to_torch(x), Draws.seeded([10, i], "cpu"))
        state, dm = d_step(state, to_torch(x), Draws.seeded([20, i], "cpu"))
        rec.append(float(gm["rec"]))
        d_losses.append(float(dm["d_loss"]))
    assert np.isfinite(rec).all() and np.isfinite(d_losses).all()
    assert rec[-1] < rec[0]
    assert state.step == 6 and state.disc_opt_state["count"] == 6
