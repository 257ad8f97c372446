"""Training launcher of the PyTorch port, port of geo4d_tpu/cli/train.py:
modality batch builder -> train step (AdamW + EMA on float32 master
weights) -> checkpoints -> JSONL metrics.

Data contract: a directory of .npz shards, each holding one clip's raw
modality arrays: video (T,H,W,3) in [-1,1], normed_allpts / plucker_raymap /
plucker_cross (T,H,W,3), inverse_depth (T,H,W,1), fps (scalar).

The flags are the JAX launcher's less its mesh and sharding ones (--fsdp,
--fsdp_min_size, --mesh_devices, --mesh_platform: one device here), plus
--device (cuda by default, which requires a CUDA device and runs the
hand-written kernels and their backward kernels; cpu runs their plain
versions).

Usage:
  python -m geo4d_tpu_torch.cli.train --data_dir shards/ --out_dir runs/exp1 \
      [--ckpt_path base.ckpt] [--steps 10000] [--batch_size 1]
  python -m geo4d_tpu_torch.cli.train --data_dir shards/ --out_dir runs/tiny \
      --tiny --device cpu --height 64 --width 64 --video_length 4 --steps 3

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
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   help="resume from a full train-state checkpoint "
                        "(default: <out_dir>/state_latest)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true",
                   help="miniature model (presets.tiny), random weights")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (hand-written kernels; an absent device is an error) or cpu")
    p.add_argument(
        "--prompt",
        type=str,
        default="Output a video that assigns each 3D location in the world a consistent color.",
    )
    p.set_defaults(config=None)
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


def main(argv=None):
    """Runs the training loop; returns a summary: per-step losses, the host
    seconds of each step's batch building, UNet forward + backward and
    AdamW + EMA (device synchronised around each), the final timer stats and
    the state."""
    args = get_parser().parse_args(argv)
    import torch

    from geo4d_tpu_torch.cli.common import build_model, compute_text_context
    from geo4d_tpu_torch.cli.infer import resolve_device
    from geo4d_tpu_torch.core.timing import StageTimer
    from geo4d_tpu_torch.data.sampler import round_by
    from geo4d_tpu_torch.models.checkpoint import restore_train_state, save_checkpoint
    from geo4d_tpu_torch.training.callbacks import EpochTimer, MetricLogger
    from geo4d_tpu_torch.training.modalities import build_batch
    from geo4d_tpu_torch.training.step import (Draws, TrainConfig, create_train_state,
                                               make_train_step)

    dev = resolve_device(args.device)
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
    state = create_train_state(model.unet)
    step_fn = make_train_step(model.unet, model.schedule, cfg)

    # resume: the full state (master weights, moments, EMA, step), then the
    # data plan fast-forwarded to the same batch
    step0 = 0
    if args.resume is not None:
        path = os.path.join(args.out_dir, "state_latest") if args.resume == "auto" else args.resume
        if os.path.exists(path):
            state = restore_train_state(path, dev)
            step0 = state.step
            print(f"[train] resumed at step {step0} from {path}")
        else:
            print(f"[train] no checkpoint at {path}; starting fresh")

    logger = MetricLogger(args.out_dir)
    timer = EpochTimer()
    timer.start()
    n_shards = len(glob.glob(os.path.join(args.data_dir, "*.npz")))
    bpe = max(round_by(n_shards, args.batch_size) // args.batch_size, 1)
    stream = npz_stream(args.data_dir, args.batch_size, args.video_length,
                        start_epoch=step0 // bpe, skip_batches=step0 % bpe)

    summary = {"losses": [], "build_s": [], "forward_backward_s": [], "optimizer_s": []}
    for i in range(step0, args.steps):
        raw = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        # each step's draws depend on (seed, step) alone, so a resumed run
        # draws what the uninterrupted run would
        stages = StageTimer(dev)
        with stages("build"):
            batch = build_batch(args.modality, model, raw, Draws.seeded([args.seed, i, 0], dev),
                                prompt_emb, null_emb, args.uncond_prob, True)
        state, metrics = step_fn(state, batch, Draws.seeded([args.seed, i, 1], dev), stages)
        for k in ("build", "forward_backward", "optimizer"):
            summary[f"{k}_s"].append(stages.seconds[k])
        summary["losses"].append(float(metrics["loss_simple"]))
        timer.step(args.batch_size)
        logger.log(i, metrics)
        if (i + 1) % args.ckpt_every == 0:
            save_checkpoint(os.path.join(args.out_dir, f"ckpt_{i + 1:08d}"), {"unet": state.ema})
            save_checkpoint(os.path.join(args.out_dir, "state_latest"), state.state_dict())
    stats = timer.finish()
    logger.log(args.steps, stats)
    save_checkpoint(os.path.join(args.out_dir, "ckpt_final"), {"unet": state.ema})
    print(f"[train] done: {stats}")
    return dict(summary, stats=stats, state=state)


if __name__ == "__main__":
    main()
