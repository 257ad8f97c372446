"""Diffusion noise-schedule tables, built on the host in float64 numpy and
frozen to float32 (port of geo4d_tpu/core/schedules.py, kept here so that
the port's runtime path imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses

import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedules. Mirrors reference lvdm/models/utils_diffusion.py:31-53."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas for zero terminal SNR (arXiv 2305.08891, Alg. 1).

    Mirrors reference lvdm/models/utils_diffusion.py:112-144.
    """
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    abar_sqrt = np.sqrt(alphas_cumprod)

    abar_sqrt_0 = abar_sqrt[0].copy()
    abar_sqrt_T = abar_sqrt[-1].copy()
    # shift so last timestep hits exactly zero, rescale so the first is unchanged
    abar_sqrt = abar_sqrt - abar_sqrt_T
    abar_sqrt = abar_sqrt * abar_sqrt_0 / (abar_sqrt_0 - abar_sqrt_T)

    abar = abar_sqrt**2
    alphas = abar[1:] / abar[:-1]
    alphas = np.concatenate([abar[0:1], alphas])
    return 1.0 - alphas


def make_ddim_timesteps(
    method: str, num_ddim_steps: int, num_ddpm_steps: int
) -> np.ndarray:
    """DDIM timestep tables. Mirrors reference utils_diffusion.py:56-76.

    `uniform_trailing` (the eval default) places the last step at T-1.
    """
    if method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        steps = np.asarray(list(range(0, num_ddpm_steps, c))) + 1
    elif method == "uniform_trailing":
        c = num_ddpm_steps / num_ddim_steps
        steps = np.flip(np.round(np.arange(num_ddpm_steps, 0, -c))).astype(np.int64) - 1
    elif method == "quad":
        steps = (
            np.linspace(0, np.sqrt(num_ddpm_steps * 0.8), num_ddim_steps) ** 2
        ).astype(int) + 1
    else:
        raise NotImplementedError(f"unknown ddim discretization {method!r}")
    return steps


def make_ddim_sampling_parameters(
    alphas_cumprod: np.ndarray, ddim_timesteps: np.ndarray, eta: float
):
    """Per-DDIM-step (sigma, alpha, alpha_prev). Reference utils_diffusion.py:79-91."""
    alphas = alphas_cumprod[ddim_timesteps]
    alphas_prev = np.asarray(
        [alphas_cumprod[0]] + alphas_cumprod[ddim_timesteps[:-1]].tolist()
    )
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev)
    )
    return sigmas, alphas, alphas_prev


def make_dynamic_rescale_array(
    num_timesteps: int, base_scale: float = 0.7, turning_step: int = 400
) -> np.ndarray:
    """Dynamic latent rescale array: linspace(1, base, turning) ++ const(base).

    Mirrors reference lvdm/models/ddpm3d.py:585-590. Only the first
    `num_timesteps` entries are ever indexed.
    """
    arr1 = np.linspace(1.0, base_scale, turning_step)
    arr2 = np.full(num_timesteps, base_scale)
    return np.concatenate([arr1, arr2])


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Frozen f32 schedule constants (reference ddpm3d.py:162-225 buffers)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    scale_arr: np.ndarray | None  # dynamic rescale, or None
    num_timesteps: int
    parameterization: str  # "v" | "eps" | "x0"

    @staticmethod
    def create(
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 0.00085,
        linear_end: float = 0.012,
        cosine_s: float = 8e-3,
        rescale_betas_zero_snr: bool = True,
        v_posterior: float = 0.0,
        parameterization: str = "v",
        use_dynamic_rescale: bool = True,
        base_scale: float = 0.7,
        turning_step: int = 400,
        given_betas: np.ndarray | None = None,
    ) -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(
                beta_schedule, timesteps, linear_start, linear_end, cosine_s
            )
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)

        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

        posterior_variance = (1 - v_posterior) * betas * (
            1.0 - alphas_cumprod_prev
        ) / (1.0 - alphas_cumprod) + v_posterior * betas

        f32 = lambda x: np.asarray(x, dtype=np.float32)
        scale_arr = (
            f32(make_dynamic_rescale_array(timesteps, base_scale, turning_step))
            if use_dynamic_rescale
            else None
        )
        return DiffusionSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(
                np.log(np.maximum(posterior_variance, 1e-20))
            ),
            posterior_mean_coef1=f32(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            scale_arr=scale_arr,
            num_timesteps=int(timesteps),
            parameterization=parameterization,
        )

    # --- v-parameterization helpers (reference ddpm3d.py:278-290,344-366) ---
    # These take *arrays already gathered at t* so the jitted sampler can bake
    # them in as scalars per step.

    def ddim_step_tables(
        self, num_steps: int, method: str = "uniform_trailing", eta: float = 0.0
    ):
        """Everything the DDIM scan needs, as per-step f32 arrays.

        Returns dict of np arrays each of length num_steps, ordered by
        ascending timestep (the sampler scans them reversed).
        """
        ts = make_ddim_timesteps(method, num_steps, self.num_timesteps)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            np.asarray(self.alphas_cumprod, dtype=np.float64), ts, eta
        )
        out = {
            "timesteps": ts.astype(np.int32),
            "sigmas": sigmas.astype(np.float32),
            "alphas": alphas.astype(np.float32),
            "alphas_prev": alphas_prev.astype(np.float32),
            "sqrt_one_minus_alphas": np.sqrt(1.0 - alphas).astype(np.float32),
            # per-t gathers used by v-parameterization conversion
            "sqrt_abar_t": self.sqrt_alphas_cumprod[ts],
            "sqrt_one_minus_abar_t": self.sqrt_one_minus_alphas_cumprod[ts],
        }
        if self.scale_arr is not None:
            scale = self.scale_arr[ts]
            scale_prev = np.concatenate([scale[0:1], scale[:-1]])
            out["scale"] = scale.astype(np.float32)
            out["scale_prev"] = scale_prev.astype(np.float32)
        return out
