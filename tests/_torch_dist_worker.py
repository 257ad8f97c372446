"""Rank functions for tests/test_torch_parallel.py: each runs in a process
spawned by `spawn`, joined to the others through a file store, on the CPU
(gloo). This module imports only torch, numpy and the port, so a rank never
loads JAX; every rank checks that before it returns."""

from __future__ import annotations

import os

import torch
import torch.multiprocessing as mp

from geo4d_tpu_torch.parallel.dryrun import foreign_modules
from geo4d_tpu_torch.parallel.mesh import init_distributed, rank_rows, shutdown_distributed

TRAIN_UNET = dict(model_channels=16, num_res_blocks=1, attention_resolutions=(1,),
                  channel_mult=(1,), num_head_channels=8, context_dim=16, temporal_length=2,
                  addition_attention=False, temporal_conv=False, dtype=torch.float32)


def spawn(name: str, world: int, store_dir: str, *args) -> None:
    """Run `name(mesh, *args)` of this module in `world` ranks."""
    mp.spawn(_entry, args=(name, world, "file://" + os.path.join(str(store_dir), "store"), args),
             nprocs=world, join=True)


def _entry(rank, name, world, init_method, args):
    torch.set_num_threads(1)
    mesh = init_distributed("cpu", world, rank=rank, world_size=world, local_rank=rank,
                            init_method=init_method)
    try:
        globals()[name](mesh, *args)
        if foreign_modules():
            raise AssertionError(f"rank {rank} loaded {foreign_modules()[:5]}")
    finally:
        shutdown_distributed()


def _train_steps(mesh, inp):
    """One DP and one FSDP (min_size 1) step from the same state; rank 0
    returns both full states and losses."""
    from geo4d_tpu_torch.core.draws import GivenDraws
    from geo4d_tpu_torch.core.schedules import DiffusionSchedule
    from geo4d_tpu_torch.models.unet3d import UNet3D
    from geo4d_tpu_torch.parallel.sharding import ShardLayout, gather_state_dict
    from geo4d_tpu_torch.training.step import TrainConfig, create_train_state, make_train_step

    unet = UNet3D(**TRAIN_UNET)
    rows = rank_rows(inp["batch"]["z0"].shape[0], mesh.world_size, mesh.rank)
    batch = {k: torch.from_numpy(v[rows]) for k, v in inp["batch"].items()}
    cfg = TrainConfig(temporal_length=TRAIN_UNET["temporal_length"])
    out = {}
    for name in ("dp", "fsdp"):
        unet.load_state_dict(inp["weights"], strict=True)
        layout = None
        if name == "fsdp":
            layout = ShardLayout.build({n: p.shape for n, p in unet.named_parameters()}, mesh,
                                       min_size=1)
            out["fsdp_dims"] = layout.dims
        state = create_train_state(unet, layout)
        step = make_train_step(unet, DiffusionSchedule.create(), cfg, mesh, layout)
        state, metrics = step(state, batch, GivenDraws(inp["draws"]))
        layout = layout or ShardLayout.replicated(list(state.params), mesh)
        full = {k: gather_state_dict(getattr(state, k), layout, mesh)
                for k in ("params", "exp_avg", "exp_avg_sq", "ema")}
        out[name] = dict(full, loss=float(metrics["loss_simple"]), step=state.step)
    return out


def _windows(mesh, inp):
    """predict_windows (given x_T, and drawing it) and predict_video over the
    ranks, and reconstruct's return on each rank."""
    from geo4d_tpu_torch.alignment.optimizer import AlignerConfig
    from geo4d_tpu_torch.models.presets import init_random_, tiny
    from geo4d_tpu_torch.pipeline.inference import InferenceConfig, WindowPredictor, reconstruct

    t = inp["window"]
    model = init_random_(tiny(temporal_length=t, device="meta"), "cpu", seed=0).eval()
    cfg = InferenceConfig(window=t, stride=2, ddim_steps=2, ddim_eta=0.5)
    pred = WindowPredictor(model, cfg, mesh=mesh)
    out = {"x_T": pred.predict_windows(inp["windows"], inp["text"], 24, seed=7, x_T=inp["x_T"]),
           "drawn": pred.predict_windows(inp["windows"], inp["text"], 24, seed=7),
           "video": pred.predict_video(inp["video"], inp["groups"], inp["text"], 24, seed=3)}
    scene, preds, _ = reconstruct(model, inp["video"], inp["text"], fps=24, inference_config=cfg,
                                  aligner_config=AlignerConfig(n_iter=4, depth_traj_start_iter=2),
                                  seed=3, mesh=mesh, device="cpu")
    out["scene"] = None if scene is None else scene.get_depthmaps()
    out["reconstruct_pts3d"] = preds["pts3d"].numpy()
    return out


def steps_and_windows(mesh, inp_path: str, out_dir: str) -> None:
    """Both of the above in one spawn; each rank writes its results."""
    inp = torch.load(inp_path, weights_only=False)
    out = {"train": _train_steps(mesh, inp["train"]), "windows": _windows(mesh, inp["windows"])}
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def train_and_infer_cli(mesh, argv, infer_argv) -> None:
    """cli/train.main, then cli/infer.main under torchrun's environment, in
    this rank (the process group is already joined)."""
    from geo4d_tpu_torch.cli import infer, train

    out = train.main(argv)
    torch.save({"losses": out["losses"], "params_shapes": {
        n: tuple(p.shape) for n, p in out["state"].params.items()}},
        os.path.join(argv[argv.index("--out_dir") + 1], f"rank{mesh.rank}.pt"))
    os.environ.update(WORLD_SIZE=str(mesh.world_size), RANK=str(mesh.rank))
    infer.main(infer_argv)
