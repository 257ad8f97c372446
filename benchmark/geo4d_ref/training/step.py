"""Frozen single-device copy of the port's training/step.py: the
v-parameterization diffusion loss, AdamW on float32 lists and the EMA. The
rank-sharing paths and `make_train_step` are left out: the benchmark's
reference drives these functions itself."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from geo4d_ref.core.schedules import DiffusionSchedule


def geometry_condition_patterns(temporal_length: int) -> np.ndarray:
    """The reference's per-frame patterns (ddpm3d.py:109-140): 1 = noised,
    0 = a clean conditioning frame; one row is drawn per batch element."""
    T = temporal_length
    pats = [[1] * T for _ in range(18)]
    pats += [
        [0 if i == 0 else 1 for i in range(T)],
        [0 if i in (0, 2) else 1 for i in range(T)],
        [0 if i in (0, 3) else 1 for i in range(T)],
        [0 if i % 2 == 0 else 1 for i in range(T)],
        [0 if i % 3 == 0 else 1 for i in range(T)],
        [0 if i % 5 == 0 else 1 for i in range(T)],
        [0 if i <= 3 else 1 for i in range(T)],
        [0 if i <= 7 else 1 for i in range(T)],
        [0 if i <= 11 else 1 for i in range(T)],
    ]
    return np.asarray(pats, np.int32)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    ema_decay: float = 0.9999
    ema_warmup: bool = True          # LitEma: decay = min(d, (1+s)/(10+s))
    geometry_condition: bool = False
    low_timesteps: int = 0
    temporal_length: int = 16
    remat: bool = False              # recompute each UNet block's activations in the backward


@dataclasses.dataclass
class TrainState:
    """float32 master weights, AdamW moments and EMA, keyed by the UNet's
    parameter names, and the number of steps taken. Under a ShardLayout a
    sharded parameter's four tensors are this rank's slices."""

    params: Dict[str, torch.Tensor]
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    step: int = 0

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)


def create_train_state(unet: torch.nn.Module) -> TrainState:
    """The state of a run starting from `unet`'s weights (every parameter
    trains, as the JAX launcher trains all of params['unet']); with a
    `layout`, this rank's slices of the sharded parameters."""
    params = {}
    for n, p in unet.named_parameters():
        full = p.detach().float().clone()
        params[n] = full
    return TrainState(
        params=params,
        exp_avg={n: torch.zeros_like(p) for n, p in params.items()},
        exp_avg_sq={n: torch.zeros_like(p) for n, p in params.items()},
        ema={n: p.clone() for n, p in params.items()},
        step=0,
    )


def _as_tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def diffusion_loss(unet: torch.nn.Module, schedule: DiffusionSchedule,
                   batch: Dict[str, torch.Tensor], draws, cfg: TrainConfig):
    """v-param MSE on a latent batch: z0 (B, T, h, w, C) target latents,
    c_concat (B, T, h, w, 4), context (B, L, D), fs (B,), optional task (B,).
    Draws, in order: timesteps (B,), noise like z0, and with
    `geometry_condition` a pattern index (B,) and the conditioning frames'
    low timesteps (B,). Returns (loss, metrics)."""
    z0 = batch["z0"]
    b = z0.shape[0]
    dev = z0.device
    # noised-frame timesteps are always U[0, num_timesteps) (ddpm3d.py:978)
    ts = draws.randint(schedule.num_timesteps, (b,))
    noise = draws.normal(z0.shape)
    sa = _as_tensor(schedule.sqrt_alphas_cumprod, dev)
    sb = _as_tensor(schedule.sqrt_one_minus_alphas_cumprod, dev)
    scale_arr = None if schedule.scale_arr is None else _as_tensor(schedule.scale_arr, dev)

    if cfg.geometry_condition:
        # conditioning frames (pattern 0) get a low timestep t_low ~
        # U[0, low_timesteps) (ddpm3d.py:984-987)
        pats = _as_tensor(geometry_condition_patterns(cfg.temporal_length), dev).long()
        frame_on = pats[draws.randint(pats.shape[0], (b,))]        # (B, T) 1 = noised
        t_low = draws.randint(max(cfg.low_timesteps, 1), (b,))
        timesteps = ts[:, None] * frame_on + t_low[:, None] * (1 - frame_on)
        sa_t, sb_t = sa[timesteps][..., None, None, None], sb[timesteps][..., None, None, None]
        if scale_arr is not None:
            # dynamic rescale of x_start, per frame (ddpm3d.py:987-988)
            z0 = z0 * scale_arr[timesteps][..., None, None, None]
    else:
        timesteps = ts
        sa_t, sb_t = sa[ts][:, None, None, None, None], sb[ts][:, None, None, None, None]
        if scale_arr is not None:
            # dynamic rescale of x_start (ddpm3d.py:991-993)
            z0 = z0 * scale_arr[ts][:, None, None, None, None]

    x_noisy = sa_t * z0 + sb_t * noise
    v_target = sa_t * noise - sb_t * z0
    x_in = torch.cat([x_noisy, batch["c_concat"]], dim=-1)
    # pc_task routes its task ids to the UNet's task embedding
    pred = unet(x_in, timesteps, batch["context"], batch["fs"], task=batch.get("task"))
    loss = torch.mean((pred - v_target) ** 2)
    return loss, {"loss_simple": loss.detach(), "t_mean": ts.float().mean()}


# parameters per multi-tensor update: bounds the float32 copies of the
# gradients alive at once
_CHUNK = 64


def adam_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                 exp_avg: List[torch.Tensor], exp_avg_sq: List[torch.Tensor], count: int,
                 lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> None:
    """optax.adam (weight_decay 0) or optax.adamw on float32 lists, in place:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, u = (m / (1 - b1^count)) /
    (sqrt(v / (1 - b2^count)) + eps) + weight_decay p, p = p - lr u, with
    `count` the update's number (1 for the first). Gradients of any float
    dtype are upcast a chunk at a time."""
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    for i in range(0, len(params), _CHUNK):
        p, m, v = params[i:i + _CHUNK], exp_avg[i:i + _CHUNK], exp_avg_sq[i:i + _CHUNK]
        g = [t.float() for t in grads[i:i + _CHUNK]]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        if weight_decay:
            torch._foreach_add_(upd, p, alpha=weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)


def ema_update_(ema: List[torch.Tensor], params: List[torch.Tensor], step_no: int,
                cfg: TrainConfig) -> float:
    """ema = ema * d + p * (1 - d) in place, d = min(ema_decay, (1 + s) /
    (10 + s)) with warm-up (float32, as the JAX step computes it); returns d."""
    decay = np.float32(cfg.ema_decay)
    if cfg.ema_warmup:
        decay = min(decay, np.float32(1.0 + step_no) / np.float32(10.0 + step_no))
    for i in range(0, len(ema), _CHUNK):
        e = ema[i:i + _CHUNK]
        torch._foreach_mul_(e, float(decay))
        torch._foreach_add_(e, params[i:i + _CHUNK], alpha=float(np.float32(1.0) - decay))
    return float(decay)


def load_params_(module: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy float32 weights into the module's parameters (in its dtype)."""
    names = [n for n, _ in module.named_parameters()]
    with torch.no_grad():
        torch._foreach_copy_([p for _, p in module.named_parameters()],
                             [params[n] for n in names])
