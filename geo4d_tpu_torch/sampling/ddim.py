"""DDIM sampler, port of geo4d_tpu/sampling/ddim.py (a Python loop over the
steps where the JAX package runs a `lax.scan`).

Per-step constants come from the numpy schedule tables
(geo4d_tpu_torch/core/schedules.py). Classifier-free guidance batches the cond,
uncond (and, for multi-cond CFG, image-uncond) branches along the batch
axis in one model call. v-parameterization:
  e_t     = sqrt(abar_t) * v + sqrt(1 - abar_t) * x_t
  pred_x0 = sqrt(abar_t) * x_t - sqrt(1 - abar_t) * v
then the dynamic rescale multiplies pred_x0 by scale_prev / scale.
`stochastic_encode` and `ddim_encode` run the forward direction (noising,
deterministic inversion).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from geo4d_tpu_torch.core.timing import stage


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    """Per-step float32 constants, ordered ascending by timestep."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    scale: np.ndarray
    scale_prev: np.ndarray

    @staticmethod
    def from_schedule(schedule, num_steps: int, method: str = "uniform_trailing",
                      eta: float = 0.0) -> "DDIMTables":
        t = schedule.ddim_step_tables(num_steps, method, eta)
        ones = np.ones_like(t["alphas"])
        return DDIMTables(
            timesteps=t["timesteps"], alphas=t["alphas"], alphas_prev=t["alphas_prev"],
            sigmas=t["sigmas"], sqrt_one_minus_alphas=t["sqrt_one_minus_alphas"],
            scale=t.get("scale", ones), scale_prev=t.get("scale_prev", ones))


def _rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                       guidance_rescale: float) -> torch.Tensor:
    """Renormalise the CFG output's std to the cond branch's."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / torch.clamp(std_cfg, min=1e-12))
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def _normal(generator, shape, device) -> torch.Tensor:
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return generator.normal(shape)


def ddim_sample(model_fn: Callable[[torch.Tensor, int, int], torch.Tensor], shape: tuple,
                tables: DDIMTables, *, device: torch.device,
                generator: Optional[torch.Generator] = None, parameterization: str = "v",
                cfg_scale: float = 1.0, cfg_img: Optional[float] = None,
                guidance_rescale: float = 0.0, x_T: Optional[torch.Tensor] = None,
                temperature: float = 1.0, timer=None) -> torch.Tensor:
    """Run the DDIM reverse process and return the final x_0 latents.

    model_fn(x, t, branches) gets x stacked `branches` times along the batch
    ([cond | uncond] or [cond | uncond | uncond_img]) and returns the same
    stacking. Noise (x_T when not given, and eta > 0 step noise) is drawn
    from `generator`: a torch.Generator, or draws (core/draws.py) whose
    `normal(shape)` gives it, such as a rank's `RankDraws`, which draws for
    the whole batch and keeps the rank's rows; `temperature` scales the step
    noise. `timer(name)`, if given, is a context manager wrapped around each
    step.
    """
    use_cfg = cfg_scale != 1.0
    multicond = use_cfg and cfg_img is not None and cfg_img != 1.0
    branches = 3 if multicond else (2 if use_cfg else 1)
    f32 = np.float32
    if x_T is not None:
        x = x_T.to(device=device, dtype=torch.float32)
    else:
        x = _normal(generator, shape, device)

    for step, i in enumerate(reversed(range(len(tables.timesteps)))):
        with stage(timer, f"ddim_step_{step}"):
            a_t = f32(tables.alphas[i])
            a_prev = f32(tables.alphas_prev[i])
            sigma_t = f32(tables.sigmas[i])
            sqrt_1ma = float(tables.sqrt_one_minus_alphas[i])
            rescale = float(f32(tables.scale_prev[i]) / f32(tables.scale[i]))

            x_in = torch.cat([x] * branches, dim=0) if branches > 1 else x
            out = model_fn(x_in, int(tables.timesteps[i]), branches)
            if multicond:
                e_c, e_uc, e_uc_img = out.chunk(3, dim=0)
                model_output = e_uc + cfg_img * (e_uc_img - e_uc) + cfg_scale * (e_c - e_uc_img)
                cond_out = e_c
            elif use_cfg:
                e_c, e_uc = out.chunk(2, dim=0)
                model_output = e_uc + cfg_scale * (e_c - e_uc)
                cond_out = e_c
            else:
                model_output = cond_out = out
            if use_cfg and guidance_rescale > 0.0:
                model_output = _rescale_noise_cfg(model_output, cond_out, guidance_rescale)

            sqrt_at = float(np.sqrt(a_t))
            if parameterization == "v":
                e_t = sqrt_at * model_output + sqrt_1ma * x
                pred_x0 = sqrt_at * x - sqrt_1ma * model_output
            else:  # eps
                e_t = model_output
                pred_x0 = (x - sqrt_1ma * e_t) / sqrt_at
            pred_x0 = pred_x0 * rescale
            dir_coef = float(np.sqrt(np.maximum(f32(1.0) - a_prev - sigma_t * sigma_t, f32(0.0))))
            x = float(np.sqrt(a_prev)) * pred_x0 + dir_coef * e_t
            if sigma_t != 0.0:
                x = x + float(sigma_t) * _normal(generator, x.shape, device) * temperature
    return x


def stochastic_encode(x0: torch.Tensor, step_index: int, tables: DDIMTables,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noise x0 to DDIM step `step_index`: sqrt(abar) x0 + sqrt(1 - abar) eps,
    eps drawn from `generator` unless `noise` is given."""
    a = np.float32(tables.alphas[step_index])
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    return float(np.sqrt(a)) * x0 + float(np.sqrt(np.float32(1.0) - a)) * noise


def ddim_encode(model_fn: Callable[[torch.Tensor, int, int], torch.Tensor], x0: torch.Tensor,
                tables: DDIMTables, *, parameterization: str = "v",
                num_steps: Optional[int] = None) -> torch.Tensor:
    """Deterministic DDIM inversion x0 -> x_T (eta 0): the first `num_steps`
    (all by default) steps of the table in ascending order, each predicting
    x0 and the noise at the lower timestep and stepping up to the higher."""
    f32 = np.float32
    x = x0
    for i in range(num_steps or len(tables.timesteps)):
        a_next, a_cur = f32(tables.alphas[i]), f32(tables.alphas_prev[i])
        sa, sb = float(np.sqrt(a_cur)), float(np.sqrt(f32(1.0) - a_cur))
        out = model_fn(x, int(tables.timesteps[i]), 1)
        if parameterization == "v":
            e_t = sa * out + sb * x
            pred_x0 = sa * x - sb * out
        else:
            e_t = out
            pred_x0 = (x - sb * e_t) / sa
        x = float(np.sqrt(a_next)) * pred_x0 + float(np.sqrt(f32(1.0) - a_next)) * e_t
    return x
