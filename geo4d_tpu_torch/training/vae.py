"""VAE fine-tuning: reconstruction + KL + adversarial losses, port of
geo4d_tpu/training/vae.py.

The reference's autoencoder training steps (lvdm/models/autoencoder.py
:161-205) alternate a generator and a discriminator step of SD's
LPIPSWithDiscriminator. Here, as in the JAX package: L1 reconstruction +
KL, plus a PatchGAN discriminator with the hinge loss; the LPIPS term needs
pretrained VGG weights and is an optional callable (weight 0 without it).

The state holds float32 master weights and Adam moments for the VAE and
the discriminator (b1 0.5, b2 0.9, as the JAX steps' optax.adam); each step
copies the master weights into the module, takes the gradient with
`torch.autograd.grad` (GroupNorm through K1b on the card) and updates the
state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from geo4d_tpu_torch.nn.basics import Conv2d
from geo4d_tpu_torch.training.step import adam_update_, load_params_


class PatchDiscriminator(nn.Module):
    """70x70 PatchGAN (the discriminator family SD's VAE loss uses) on
    channels-last (B, H, W, C) images: 4x4 convolutions (stride 2 but the
    last), float32 GroupNorm (plain nn.GroupNorm, as JAX's flax GroupNorm;
    no kernel) and leaky ReLU."""

    def __init__(self, in_channels: int = 3, base_ch: int = 64, n_layers: int = 3,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        self.conv0 = Conv2d(in_channels, base_ch, 4, stride=2, dtype=dtype)
        ch_in = base_ch
        for i in range(1, n_layers + 1):
            ch = min(base_ch * 2 ** i, 512)
            setattr(self, f"conv{i}", Conv2d(ch_in, ch, 4, stride=2 if i < n_layers else 1,
                                             dtype=dtype))
            setattr(self, f"norm{i}", nn.GroupNorm(min(32, ch), ch, eps=1e-6,
                                                   dtype=torch.float32))
            ch_in = ch
        self.out = Conv2d(ch_in, 1, 4, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x.to(self.dtype)), 0.2)
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{i}")(h.to(self.dtype))
            h = getattr(self, f"norm{i}")(h.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            h = F.leaky_relu(h, 0.2)
        return self.out(h.to(self.dtype))


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    learning_rate: float = 4.5e-6
    kl_weight: float = 1e-6
    disc_weight: float = 0.5
    disc_start: int = 50001       # the generator sees the GAN loss from this step on
    perceptual_weight: float = 0.0  # needs external LPIPS assets


@dataclasses.dataclass
class VAETrainState:
    """float32 master weights and Adam moments (exp_avg, exp_avg_sq, count)
    of the VAE and the discriminator, and the generator steps taken."""

    params: Dict[str, torch.Tensor]
    disc_params: Dict[str, torch.Tensor]
    opt_state: Dict[str, object]
    disc_opt_state: Dict[str, object]
    step: int = 0


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - real_logits)) + torch.mean(F.relu(1.0 + fake_logits)))


def _adam_state(params: Dict[str, torch.Tensor]) -> Dict[str, object]:
    return {"exp_avg": {n: torch.zeros_like(p) for n, p in params.items()},
            "exp_avg_sq": {n: torch.zeros_like(p) for n, p in params.items()},
            "count": 0}


def _adam_(params: Dict[str, torch.Tensor], names, grads, opt: Dict[str, object],
           cfg: VAETrainConfig) -> None:
    opt["count"] += 1
    adam_update_([params[n] for n in names], grads, [opt["exp_avg"][n] for n in names],
                 [opt["exp_avg_sq"][n] for n in names], opt["count"], cfg.learning_rate,
                 b1=0.5, b2=0.9)


def _grads(loss, weights):
    grads = torch.autograd.grad(loss, weights, allow_unused=True)
    return [torch.zeros_like(w) if g is None else g for g, w in zip(grads, weights)]


def make_vae_train_steps(vae: nn.Module, disc: PatchDiscriminator, cfg: VAETrainConfig,
                         vae_apply: Optional[Callable] = None,
                         perceptual_fn: Optional[Callable] = None):
    """Returns (generator_step, discriminator_step, init_state).

    `vae_apply(x, draws) -> (recon, mean, logvar)` runs the VAE module with
    the state's weights loaded (default: `vae(x, draws.generator,
    sample=True)`, a posterior sample). Each step takes (state, x, draws)
    and returns (state, metrics); the discriminator step recomputes the
    reconstruction without a gradient, as JAX's stop_gradient."""
    if vae_apply is None:
        def vae_apply(x, draws):
            return vae(x, draws.generator, sample=True)

    vae_names = [n for n, _ in vae.named_parameters()]
    vae_weights = [p for _, p in vae.named_parameters()]
    disc_names = [n for n, _ in disc.named_parameters()]
    disc_weights = [p for _, p in disc.named_parameters()]

    def generator_step(state: VAETrainState, x: torch.Tensor, draws):
        load_params_(vae, state.params)
        load_params_(disc, state.disc_params)
        recon, mean, logvar = vae_apply(x, draws)
        rec = torch.mean(torch.abs(recon - x))
        if perceptual_fn is not None and cfg.perceptual_weight > 0:
            rec = rec + cfg.perceptual_weight * perceptual_fn(recon, x)
        kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
        g_gan = -torch.mean(disc(recon).float())
        gan_on = float(state.step >= cfg.disc_start)
        loss = rec + cfg.kl_weight * kl + gan_on * cfg.disc_weight * g_gan
        grads = _grads(loss, vae_weights)
        _adam_(state.params, vae_names, grads, state.opt_state, cfg)
        state.step += 1
        return state, {"loss": loss.detach(), "rec": rec.detach(), "kl": kl.detach(),
                       "g_gan": g_gan.detach()}

    def discriminator_step(state: VAETrainState, x: torch.Tensor, draws):
        load_params_(vae, state.params)
        load_params_(disc, state.disc_params)
        with torch.no_grad():
            recon = vae_apply(x, draws)[0]
        loss = hinge_d_loss(disc(x).float(), disc(recon).float())
        grads = _grads(loss, disc_weights)
        _adam_(state.disc_params, disc_names, grads, state.disc_opt_state, cfg)
        return state, {"d_loss": loss.detach()}

    def init_state() -> VAETrainState:
        params = {n: p.detach().float().clone() for n, p in vae.named_parameters()}
        disc_params = {n: p.detach().float().clone() for n, p in disc.named_parameters()}
        return VAETrainState(params=params, disc_params=disc_params,
                             opt_state=_adam_state(params), disc_opt_state=_adam_state(disc_params),
                             step=0)

    return generator_step, discriminator_step, init_state
