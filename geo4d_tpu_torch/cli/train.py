"""Training launcher of the PyTorch port, port of geo4d_tpu/cli/train.py:
modality batch builder -> train step (AdamW + EMA on float32 master
weights) -> checkpoints -> JSONL metrics.

Data contract: a directory of .npz shards, each holding one clip's raw
modality arrays: video (T,H,W,3) in [-1,1], normed_allpts / plucker_raymap /
plucker_cross (T,H,W,3), inverse_depth (T,H,W,1), fps (scalar).

The flags are the JAX launcher's, plus three of the port's own:
  --device        cuda (the default; requires a CUDA device and runs the
                  hand-written kernels and their backward kernels) or cpu
                  (their plain versions);
  --dist_backend  nccl or gloo for the ranks' collectives (default: nccl on
                  cuda, gloo on cpu); gloo on cuda lets several ranks share
                  one card, which NCCL refuses;
  --config        a reference-layout YAML for the model tree (as
                  cli/infer's), e.g. a UNet of reduced depth.

Across ranks: launched by torchrun (or `python -m torch.distributed.run`),
each rank is a process with one device (LOCAL_RANK's card, modulo the cards
present, or the CPU with --mesh_platform cpu) and --batch_size is per rank:
the global batch is world x batch_size, each rank draws the global batch's
random numbers and keeps its rows, and the gradients are averaged over the
ranks. --fsdp holds each large parameter's master weight, moments and EMA
as one slice per rank (`parallel/mesh.py::fsdp_shard_dim`, --fsdp_min_size),
gathered before the forward and reduce-scattered after the backward.
Rank 0 alone writes metrics.jsonl and the checkpoints, which hold the full,
gathered state: a run resumes at any world size. Without torchrun's
environment, --mesh_devices or --mesh_platform, the launcher runs as one
process (--fsdp then has nothing to shard).

Usage:
  python -m geo4d_tpu_torch.cli.train --data_dir shards/ --out_dir runs/exp1 \
      [--ckpt_path base.ckpt] [--steps 10000] [--batch_size 1]
  python -m geo4d_tpu_torch.cli.train --data_dir shards/ --out_dir runs/tiny \
      --tiny --device cpu --height 64 --width 64 --video_length 4 --steps 3
  torchrun --standalone --nproc_per_node 2 -m geo4d_tpu_torch.cli.train \
      --data_dir shards/ --out_dir runs/tiny2 --tiny --mesh_platform cpu \
      --height 64 --width 64 --video_length 4 --steps 3 --fsdp --fsdp_min_size 1

Checkpoints in --out_dir: ckpt_<step> and ckpt_final hold {"unet": EMA
weights}; state_latest the full train state, which --resume restores.
"""

from __future__ import annotations

import argparse
import glob
import os


def get_parser():
    p = argparse.ArgumentParser(description="geo4d_tpu_torch training")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--modality", type=str, default="pc_ray_cross_depth")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=576)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--uncond_prob", type=float, default=0.05)
    p.add_argument("--geometry_condition", action="store_true")
    p.add_argument("--fsdp", action="store_true",
                   help="shard large parameters and their optimizer state over the "
                        "ranks (ZeRO-style; the reference trained with DeepSpeed "
                        "sharding)")
    p.add_argument("--fsdp_min_size", type=int, default=2**18,
                   help="smallest parameter (elements) worth sharding")
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   help="resume from a full train-state checkpoint "
                        "(default: <out_dir>/state_latest)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true",
                   help="miniature model (presets.tiny), random weights")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (hand-written kernels; an absent device is an error) or cpu")
    p.add_argument("--mesh_devices", type=int, default=None,
                   help="mesh size: must equal the number of ranks launched")
    p.add_argument("--mesh_platform", type=str, default=None, choices=("cuda", "cpu"),
                   help="the ranks' device (default: --device)")
    p.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="the ranks' collectives (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--config", type=str, default=None,
                   help="reference-layout YAML for the model tree")
    p.add_argument(
        "--prompt",
        type=str,
        default="Output a video that assigns each 3D location in the world a consistent color.",
    )
    return p


def npz_stream(data_dir: str, batch_size: int, t: int,
               world_size: int = 1, rank: int = 0, start_epoch: int = 0,
               skip_batches: int = 0):
    """Endless stream of stacked clip batches from .npz shards in the
    reference's epoch-seeded, rank-sharded order (data/sampler.py
    epoch_plan / shard_plan): every process derives the same plan from the
    epoch number alone and takes its batch-aligned slice; `skip_batches`
    drops the batches a resumed run already consumed without loading them."""
    import numpy as np

    from geo4d_tpu_torch.data.sampler import epoch_plan, shard_plan

    files = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no .npz shards in {data_dir}")
    keys = ["video", "normed_allpts", "plucker_raymap", "plucker_cross", "inverse_depth"]
    epoch = start_epoch
    while True:
        plan = epoch_plan(len(files), batch_size, pool_size=1, epoch=epoch,
                          world_size=world_size)
        mine = shard_plan(plan, rank, world_size, batch_size)
        if skip_batches:
            mine = mine[skip_batches * batch_size:]
            skip_batches = 0
        batch = {k: [] for k in keys + ["fps"]}
        for fi, _feat in mine:
            with np.load(files[fi]) as z:
                for k in keys:
                    batch[k].append(z[k][:t])
                batch["fps"].append(int(z.get("fps", 24)))
            if len(batch["fps"]) == batch_size:
                yield {k: np.stack(v) if k != "fps" else np.asarray(v, np.int32)
                       for k, v in batch.items()}
                batch = {k: [] for k in keys + ["fps"]}
        epoch += 1


def _mesh(args):
    """The rank's Mesh when the run spans ranks (torchrun's environment, a
    process group already made, --mesh_devices or --mesh_platform), else
    None."""
    import torch.distributed as dist

    from geo4d_tpu_torch.parallel.mesh import init_distributed

    if not (dist.is_initialized() or "WORLD_SIZE" in os.environ
            or args.mesh_devices is not None or args.mesh_platform is not None):
        return None
    return init_distributed(args.mesh_platform or args.device, args.mesh_devices,
                            backend=args.dist_backend)


def main(argv=None):
    """Runs the training loop; returns a summary: per-step losses (of the
    global batch), the host seconds of each step's batch building, UNet
    forward + backward and AdamW + EMA (device synchronised around each),
    across ranks also the parameter gather and the gradient reduction, the
    final timer stats and the state (this rank's slices under --fsdp). With a
    span recorder installed (`core.timing`), each step, its batch building
    included, is one request, "train_step"."""
    args = get_parser().parse_args(argv)
    import torch
    import torch.distributed as dist

    from geo4d_tpu_torch.cli.common import build_model, compute_text_context
    from geo4d_tpu_torch.cli.infer import resolve_device
    from geo4d_tpu_torch.core.draws import Draws, RankDraws
    from geo4d_tpu_torch.core.timing import StageTimer, request
    from geo4d_tpu_torch.data.sampler import round_by
    from geo4d_tpu_torch.models.checkpoint import (restore_train_state, save_ema,
                                                   save_train_state)
    from geo4d_tpu_torch.parallel.sharding import ShardLayout
    from geo4d_tpu_torch.training.callbacks import EpochTimer, MetricLogger
    from geo4d_tpu_torch.training.modalities import build_batch
    from geo4d_tpu_torch.training.step import TrainConfig, create_train_state, make_train_step

    started_group = not dist.is_initialized()
    mesh = _mesh(args)
    started_group = started_group and mesh is not None
    world, rank = (mesh.world_size, mesh.rank) if mesh else (1, 0)
    dev = mesh.device if mesh else resolve_device(args.device)
    model, _ = build_model(args, dev)
    prompt_emb = torch.from_numpy(compute_text_context(model, args.prompt)).to(dev)
    null_emb = torch.from_numpy(compute_text_context(model, "")).to(dev)
    model.text_encoder = None                  # training never uses it again
    model.requires_grad_(False)                # the towers around the UNet stay frozen
    model.unet.requires_grad_(True)
    prompt_emb = prompt_emb.expand(args.batch_size, *prompt_emb.shape[1:])

    cfg = TrainConfig(learning_rate=args.learning_rate,
                      geometry_condition=args.geometry_condition,
                      temporal_length=args.video_length)
    layout = None
    if mesh is not None and args.fsdp:
        layout = ShardLayout.build({n: p.shape for n, p in model.unet.named_parameters()},
                                   mesh, args.fsdp_min_size)
    state = create_train_state(model.unet, layout)
    step_fn = make_train_step(model.unet, model.schedule, cfg, mesh, layout)

    # resume: the full state (master weights, moments, EMA, step), then the
    # data plan fast-forwarded to the same batch
    step0 = 0
    if args.resume is not None:
        path = os.path.join(args.out_dir, "state_latest") if args.resume == "auto" else args.resume
        if os.path.exists(path):
            state = restore_train_state(path, dev, layout)
            step0 = state.step
            print(f"[train] resumed at step {step0} from {path}")
        else:
            print(f"[train] no checkpoint at {path}; starting fresh")

    logger = MetricLogger(args.out_dir, rank=rank)
    timer = EpochTimer()
    timer.start()
    n_shards = len(glob.glob(os.path.join(args.data_dir, "*.npz")))
    global_batch = args.batch_size * world
    bpe = max(round_by(n_shards, global_batch) // global_batch, 1)
    stream = npz_stream(args.data_dir, args.batch_size, args.video_length, world_size=world,
                        rank=rank, start_epoch=step0 // bpe, skip_batches=step0 % bpe)

    stage_names = ("build", "forward_backward", "optimizer") + (
        ("gather", "reduce") if mesh else ())
    summary = {"losses": [], **{f"{k}_s": [] for k in stage_names}}
    for i in range(step0, args.steps):
        raw = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        # each step's draws depend on (seed, step) alone, so a resumed run
        # draws what the uninterrupted run would; each rank keeps its rows
        # of the global batch's draws
        stages = StageTimer(dev)
        with request("train_step"):
            with stages("build"):
                draws = Draws.seeded([args.seed, i, 0], dev)
                batch = build_batch(args.modality, model, raw,
                                    RankDraws(draws, world, rank) if mesh else draws,
                                    prompt_emb, null_emb, args.uncond_prob, True)
            state, metrics = step_fn(state, batch, Draws.seeded([args.seed, i, 1], dev), stages)
        for k in stage_names:
            summary[f"{k}_s"].append(stages.seconds.get(k, 0.0))
        summary["losses"].append(float(metrics["loss_simple"]))
        timer.step(global_batch)
        logger.log(i, metrics)
        if (i + 1) % args.ckpt_every == 0:
            save_ema(os.path.join(args.out_dir, f"ckpt_{i + 1:08d}"), state, mesh, layout)
            save_train_state(os.path.join(args.out_dir, "state_latest"), state, mesh, layout)
    stats = timer.finish()
    logger.log(args.steps, stats)
    save_ema(os.path.join(args.out_dir, "ckpt_final"), state, mesh, layout)
    if rank == 0:
        print("[train] seconds per step: " + " ".join(
            f"{k}={[round(v, 4) for v in summary[f'{k}_s']]}" for k in stage_names))
    print(f"[train] {f'rank {rank} ' if mesh else ''}done: {stats}")
    if started_group:
        dist.destroy_process_group()
    return dict(summary, stats=stats, state=state)


if __name__ == "__main__":
    main()
