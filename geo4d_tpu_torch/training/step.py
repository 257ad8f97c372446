"""Training step: v-parameterization diffusion loss + AdamW + EMA, port of
geo4d_tpu/training/step.py.

The reference is lvdm/models/ddpm3d.py `p_losses` (q_sample -> apply_model
-> v-target MSE), `configure_optimizers` (AdamW) and `LitEma` (warm-up
decay), with per-frame geometry-condition timestep patterns through 2-D
(B, T) timesteps.

The train state holds float32 master weights, the AdamW moments and the
EMA, as the JAX package's does (flax keeps f32 parameters), while the UNet
module computes in its own dtype (bf16 on the card): each step copies the
master weights into the module, differentiates the loss with respect to the
module's parameters (through K1b-K3b on the card), upcasts the gradients
and updates the state with multi-tensor (`torch._foreach_*`) ops, a chunk
of parameters at a time. The port updates the state in place where the JAX
step returns a new one.

Random draws come from a `Draws` (a torch.Generator on the device) or, in
tests, a `GivenDraws` that hands out arrays drawn elsewhere (core/draws.py).

Across ranks (`make_train_step(..., mesh=)`), each rank holds batch rows
[r b, (r + 1) b) of a global batch of world x b: it draws the global batch's
random numbers and keeps its rows (`RankDraws`), averages the gradients over
the ranks (the JAX step's psum over the sharded batch) and applies the same
update. With a `ShardLayout` (`--fsdp`) a sharded parameter's master weight,
moments and EMA are held as the rank's slice: the slices are gathered into
the module before the forward, and the gradients reduce-scattered to slices
after the backward.

On one CUDA device (no mesh) the weights' load, the loss and its gradient
replay as one CUDA graph per batch shape (ops/graphs.py). The draws stay
eager, in the same order, copied with the batch into the graph's inputs;
AdamW and the EMA stay eager.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import numpy as np
import torch

from geo4d_tpu_torch.core.draws import GivenDraws, RankDraws
from geo4d_tpu_torch.core.schedules import DiffusionSchedule
from geo4d_tpu_torch.core.timing import count, span, stage
from geo4d_tpu_torch.ops import graphs
from geo4d_tpu_torch.parallel.mesh import Mesh
from geo4d_tpu_torch.parallel.sharding import (ShardLayout, all_gather_full, all_reduce_mean,
                                               reduce_scatter_mean)


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


def create_train_state(unet: torch.nn.Module, layout: ShardLayout = None) -> TrainState:
    """The state of a run starting from `unet`'s weights (every parameter
    trains, as the JAX launcher trains all of params['unet']); with a
    `layout`, this rank's slices of the sharded parameters."""
    params = {}
    for n, p in unet.named_parameters():
        full = p.detach().float().clone()
        params[n] = full if layout is None else layout.local(n, full)
    return TrainState(
        params=params,
        exp_avg={n: torch.zeros_like(p) for n, p in params.items()},
        exp_avg_sq={n: torch.zeros_like(p) for n, p in params.items()},
        ema={n: p.clone() for n, p in params.items()},
        step=0,
    )


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


# the batch entries the loss reads
BATCH_KEYS = ("z0", "c_concat", "context", "fs", "task")


@functools.cache
def _patterns_on(temporal_length: int, device: torch.device) -> torch.Tensor:
    """`geometry_condition_patterns` on `device`, copied there once."""
    return _as_tensor(geometry_condition_patterns(temporal_length), device).long()


def schedule_on(schedule: DiffusionSchedule, device) -> DiffusionSchedule:
    """`schedule` with the arrays the loss reads as tensors on `device`, so
    that `diffusion_loss` makes no host-to-device copy."""
    return dataclasses.replace(
        schedule, sqrt_alphas_cumprod=_as_tensor(schedule.sqrt_alphas_cumprod, device),
        sqrt_one_minus_alphas_cumprod=_as_tensor(schedule.sqrt_one_minus_alphas_cumprod, device),
        scale_arr=None if schedule.scale_arr is None else _as_tensor(schedule.scale_arr, device))


def draw_loss_inputs(draws, shape, num_timesteps: int, cfg: TrainConfig) -> List[torch.Tensor]:
    """The loss's draws for latents of `shape` (B, T, h, w, C), in order:
    timesteps (B,), noise of `shape`, and with `geometry_condition` a
    pattern index (B,) and the conditioning frames' low timesteps (B,)."""
    b = shape[0]
    # noised-frame timesteps are always U[0, num_timesteps) (ddpm3d.py:978)
    out = [draws.randint(num_timesteps, (b,)), draws.normal(shape)]
    if cfg.geometry_condition:
        # conditioning frames (pattern 0) get a low timestep t_low ~
        # U[0, low_timesteps) (ddpm3d.py:984-987)
        out += [draws.randint(len(geometry_condition_patterns(cfg.temporal_length)), (b,)),
                draws.randint(max(cfg.low_timesteps, 1), (b,))]
    return out


def diffusion_loss(unet: torch.nn.Module, schedule: DiffusionSchedule,
                   batch: Dict[str, torch.Tensor], draws, cfg: TrainConfig):
    """v-param MSE on a latent batch: z0 (B, T, h, w, C) target latents,
    c_concat (B, T, h, w, 4), context (B, L, D), fs (B,), optional task (B,).
    Draws, in order: timesteps (B,), noise like z0, and with
    `geometry_condition` a pattern index (B,) and the conditioning frames'
    low timesteps (B,). Returns (loss, metrics). With a `schedule_on` the
    batch's device, it copies nothing from the host."""
    z0 = batch["z0"]
    dev = z0.device
    ts, noise, *conditioning = draw_loss_inputs(draws, z0.shape, schedule.num_timesteps, cfg)
    sa = _as_tensor(schedule.sqrt_alphas_cumprod, dev)
    sb = _as_tensor(schedule.sqrt_one_minus_alphas_cumprod, dev)
    scale_arr = None if schedule.scale_arr is None else _as_tensor(schedule.scale_arr, dev)

    if cfg.geometry_condition:
        pattern, t_low = conditioning
        frame_on = _patterns_on(cfg.temporal_length, dev)[pattern]     # (B, T) 1 = noised
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


def _mesh_parts(names: List[str], mesh: Mesh, layout: ShardLayout):
    """(replicated indices, sharded indices, sharded dims) of `names`."""
    layout = layout or ShardLayout.replicated(names, mesh)
    if (layout.world, layout.rank) != (mesh.world_size, mesh.rank):
        raise ValueError(f"layout for rank {layout.rank} of {layout.world}, mesh rank "
                         f"{mesh.rank} of {mesh.world_size}")
    rep = [i for i, n in enumerate(names) if layout.dims[n] is None]
    shd = [i for i, n in enumerate(names) if layout.dims[n] is not None]
    return rep, shd, [layout.dims[names[i]] for i in shd]


def make_train_step(unet: torch.nn.Module, schedule: DiffusionSchedule, cfg: TrainConfig,
                    mesh: Mesh = None, layout: ShardLayout = None):
    """Returns step(state, batch, draws, timer=None) -> (state, metrics): the
    loss and its gradient with respect to the UNet's weights at the state's
    master weights (stage "forward_backward" of an optional StageTimer),
    then AdamW (optax.adamw(lr, weight_decay): b1 0.9, b2 0.999, eps 1e-8,
    decay on every parameter) and the EMA (stage "optimizer"). `state` is
    updated in place and returned. Spans (`core.timing`): "loss" and
    "backward" inside "forward_backward", "adam" and "ema" inside
    "optimizer".

    On CUDA without a mesh (with or without `remat`), the forward and backward
    follow `ops/graphs.py`'s rule keyed by the batch's shapes: a shape's
    first step is eager, its second captures (span "train_capture", inside
    "forward_backward"), and it and every later one replay, until the shape
    or the state's master-weight tensors change. Counters
    "train_eager_steps" and "train_graph_replays" count both kinds of step.

    With a `mesh`, `batch` holds this rank's rows of the global batch and
    `draws` gives the global batch's draws (the step keeps its rows). The
    gradients are averaged over the ranks in float32 buckets (stage
    "reduce") and the metrics are the global batch's. With a `layout`
    (state from `create_train_state(unet, layout)`), the sharded master
    weights are gathered into the module before the forward (stage
    "gather") and their gradients reduce-scattered to this rank's slices."""
    unet.remat = cfg.remat
    names = [n for n, _ in unet.named_parameters()]
    weights = [p for _, p in unet.named_parameters()]
    device = weights[0].device
    schedule = schedule_on(schedule, device)
    if mesh is not None:
        rep, shd, dims = _mesh_parts(names, mesh, layout)

    def gather_params_(state: TrainState):
        with torch.no_grad():
            if rep:
                torch._foreach_copy_([weights[i] for i in rep],
                                     [state.params[names[i]] for i in rep])
            for j, full in all_gather_full([state.params[names[i]] for i in shd], dims, mesh,
                                           [weights[i].dtype for i in shd]):
                weights[shd[j]].copy_(full)

    def reduce_grads(grads):
        out = [None] * len(grads)
        for i, g in zip(rep, all_reduce_mean([grads[i] for i in rep], mesh)):
            out[i] = g
        for i, g in zip(shd, reduce_scatter_mean([grads[i] for i in shd], dims, mesh)):
            out[i] = g
        return out

    def loss_and_grads(state: TrainState, keys, *xs):
        """(metrics, gradients) at the state's master weights; `xs` are the
        batch's entries under `keys`, then the loss's draws."""
        if mesh is None:
            load_params_(unet, state.params)
        with span("loss"):
            loss, metrics = diffusion_loss(unet, schedule, dict(zip(keys, xs)),
                                           GivenDraws(xs[len(keys):]), cfg)
        with span("backward"):
            grads = torch.autograd.grad(loss, weights, allow_unused=True)
        # an unused parameter's gradient is zero; weight decay still applies
        return metrics, [torch.zeros_like(w) if g is None else g for g, w in zip(grads, weights)]

    # a capture first frees the allocator's unused cached blocks for its pool;
    # with `remat` it holds the blocks' (non-reentrant) recomputation too
    replay = graphs.GraphReplay(device, "train_capture", release=torch.cuda.empty_cache)

    def forward_backward(state: TrainState, batch, draws):
        keys = [k for k in BATCH_KEYS if batch.get(k) is not None]
        # the draws, in the loss's order, are inputs of the graph like the batch
        inputs = [batch[k] for k in keys] + draw_loss_inputs(
            draws, batch["z0"].shape, schedule.num_timesteps, cfg)
        fn = functools.partial(loss_and_grads, state, keys)
        if mesh is not None:
            count("train_eager_steps")
            return fn(*inputs)
        shapes = tuple((k, tuple(x.shape), x.dtype) for k, x in zip(keys, inputs))
        (metrics, grads), replayed = replay(shapes, fn, inputs,
                                            reads=[state.params[n] for n in names])
        count("train_graph_replays" if replayed else "train_eager_steps")
        # fresh metrics: the next replay overwrites the graph's outputs
        return {k: v.clone() for k, v in metrics.items()}, list(grads)

    def step(state: TrainState, batch, draws, timer=None):
        if mesh is not None:
            draws = RankDraws(draws, mesh.world_size, mesh.rank)
            with stage(timer, "gather"):
                gather_params_(state)
        with stage(timer, "forward_backward"):
            metrics, grads = forward_backward(state, batch, draws)
        if mesh is not None:
            with stage(timer, "reduce"):
                grads = reduce_grads(grads)
                keys = sorted(metrics)
                means = torch.stack([metrics[k].float() for k in keys])
                mesh.all_reduce_sum_(means).div_(mesh.world_size)
                metrics = dict(zip(keys, means.unbind()))
        with stage(timer, "optimizer"):
            p = [state.params[n] for n in names]
            with span("adam"):
                adam_update_(p, grads, [state.exp_avg[n] for n in names],
                             [state.exp_avg_sq[n] for n in names], state.step + 1,
                             cfg.learning_rate, weight_decay=cfg.weight_decay)
            del grads
            state.step += 1
            with span("ema"):
                ema_update_([state.ema[n] for n in names], p, state.step, cfg)
        return state, metrics

    return step
