"""Multi-process dry runs of the parallel layer: the port's counterpart of
`dryrun_multichip` in the JAX package's __graft_entry__.py (the run recorded
in MULTICHIP_r05.json). n ranks, each a process, run at the JAX dry runs'
tiny sizes:

  1. a data-parallel train step with a global batch of n (one row a rank);
  2. a ZeRO-style (FSDP) train step with min_size 1, at least one
     parameter really held as slices;
  3. window-parallel `predict_windows` over n windows with the tiny preset.

    python -m geo4d_tpu_torch.parallel.dryrun --n 2 --platform cpu
    python -m geo4d_tpu_torch.parallel.dryrun --n 2 --platform cuda --backend gloo

The ranks are spawned processes joined through a file store in a temporary
directory. The platform has no default: 'cpu' runs gloo on CPU tensors (the
JAX dry run's virtual CPU devices); 'cuda' runs NCCL, one card a rank, or
gloo with --backend gloo, the ranks sharing the cards (bf16, the hand-written
kernels, which are built once before the ranks start). Rank 0
prints each dry run's line and `dryrun_multiprocess(n): ok`; a failing rank
makes the whole run raise.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from geo4d_tpu_torch.parallel.mesh import Mesh, init_distributed, rank_rows, shutdown_distributed

# nothing of these may be loaded in a rank
FOREIGN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "geo4d_tpu", "PIL")

T_TRAIN, H_TRAIN, W_TRAIN = 2, 8, 8
T_INFER, H_INFER, W_INFER = 4, 32, 32


def foreign_modules() -> list:
    return sorted(m for m, mod in sys.modules.items()
                  if mod is not None and m.split(".")[0] in FOREIGN_ROOTS)


def _dtype(mesh: Mesh) -> torch.dtype:
    return torch.bfloat16 if mesh.device.type == "cuda" else torch.float32


def _train_setup(mesh: Mesh):
    """The JAX dry runs' single-level UNet, seeded random-normal weights (the
    same on every rank), and this rank's row of a global zero batch of n."""
    from geo4d_tpu_torch.core.schedules import DiffusionSchedule
    from geo4d_tpu_torch.models.presets import init_random_
    from geo4d_tpu_torch.models.unet3d import UNet3D

    n, t, h, w = mesh.world_size, T_TRAIN, H_TRAIN, W_TRAIN
    with torch.device("meta"):
        unet = UNet3D(model_channels=16, num_res_blocks=1, attention_resolutions=(1,),
                      channel_mult=(1,), num_head_channels=8, context_dim=16, temporal_length=t,
                      addition_attention=False, temporal_conv=False, dtype=_dtype(mesh))
    init_random_(unet, mesh.device, seed=0)
    rows = rank_rows(n, n, mesh.rank)
    dev = mesh.device
    batch = {"z0": torch.zeros((n, t, h, w, 16), device=dev),
             "c_concat": torch.zeros((n, t, h, w, 4), device=dev),
             "context": torch.zeros((n, 77 + t * 16, 16), device=dev),
             "fs": torch.full((n,), 24, dtype=torch.int32, device=dev)}
    return unet, DiffusionSchedule.create(), {k: v[rows] for k, v in batch.items()}


def dp_train(mesh: Mesh) -> float:
    from geo4d_tpu_torch.core.draws import Draws
    from geo4d_tpu_torch.training.step import TrainConfig, create_train_state, make_train_step

    unet, schedule, batch = _train_setup(mesh)
    step = make_train_step(unet, schedule, TrainConfig(temporal_length=T_TRAIN), mesh)
    _, metrics = step(create_train_state(unet), batch, Draws.seeded([1], mesh.device))
    loss = float(metrics["loss_simple"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


def fsdp_train(mesh: Mesh):
    from geo4d_tpu_torch.parallel.sharding import ShardLayout
    from geo4d_tpu_torch.core.draws import Draws
    from geo4d_tpu_torch.training.step import TrainConfig, create_train_state, make_train_step

    unet, schedule, batch = _train_setup(mesh)
    full = {n: p.shape for n, p in unet.named_parameters()}
    # min_size 1: at this scale every divisible parameter shards
    layout = ShardLayout.build(full, mesh, min_size=1)
    state = create_train_state(unet, layout)
    step = make_train_step(unet, schedule, TrainConfig(temporal_length=T_TRAIN), mesh, layout)
    state, metrics = step(state, batch, Draws.seeded([1], mesh.device))
    n_sharded = sum(1 for n, p in state.params.items() if p.shape != full[n])
    if n_sharded == 0:
        raise AssertionError("no parameter actually sharded")
    loss = float(metrics["loss_simple"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return n_sharded, loss


def window_parallel(mesh: Mesh) -> None:
    from geo4d_tpu_torch.models.presets import init_random_, tiny
    from geo4d_tpu_torch.pipeline.inference import InferenceConfig, WindowPredictor

    n, t, h, w = mesh.world_size, T_INFER, H_INFER, W_INFER
    model = init_random_(tiny(temporal_length=t, dtype=_dtype(mesh), device="meta"),
                         mesh.device, seed=0).eval()
    predictor = WindowPredictor(model, InferenceConfig(window=t, ddim_steps=2),
                                device=mesh.device, mesh=mesh)
    frames = np.zeros((n, t, h, w, 3), np.float32)
    preds = predictor.predict_windows(frames, np.zeros((1, 77, 64), np.float32), fps=24)
    if preds["pts3d"].shape != (n, t, h, w, 3):
        raise AssertionError(f"pts3d shape {preds['pts3d'].shape}")
    if not (np.isfinite(preds["pts3d"]).all() and np.isfinite(preds["traj"]).all()):
        raise AssertionError("non-finite window predictions")


def _rank(rank: int, n: int, platform: str, backend, init_method: str) -> None:
    if platform == "cpu":
        torch.set_num_threads(1)
    mesh = init_distributed(platform, n, rank=rank, world_size=n, local_rank=rank,
                            init_method=init_method, backend=backend)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        say(f"  dp train step({n}): ok, loss={dp_train(mesh):.5f}", flush=True)
        n_sharded, loss = fsdp_train(mesh)
        say(f"  fsdp train step({n}): ok, {n_sharded} sharded leaves, loss={loss:.5f}",
            flush=True)
        window_parallel(mesh)
        say(f"  window-parallel inference({n} windows): ok", flush=True)
        if foreign_modules():
            raise AssertionError(f"rank {rank} loaded {foreign_modules()[:5]}")
        mesh.barrier()
        say(f"dryrun_multiprocess({n}): ok", flush=True)
    finally:
        shutdown_distributed()


def dryrun_multiprocess(n: int, platform: str, backend=None) -> None:
    """Spawn n ranks that run the three dry runs; raises if a rank fails."""
    if platform == "cuda":
        from geo4d_tpu_torch.ops import dispatch

        dispatch.kernels()          # built once here; the ranks only load it
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(n, platform, backend, "file://" + os.path.join(tmp, "store")),
                 nprocs=n, join=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-process dry runs of geo4d_tpu_torch.parallel")
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--platform", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    args = ap.parse_args(argv)
    dryrun_multiprocess(args.n, args.platform, args.backend)


if __name__ == "__main__":
    main()
