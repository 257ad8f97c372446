"""Profile the group aligner on a CUDA card:

    python -m geo4d_tpu_torch.tools.profile_aligner

An analytic scene (`synthetic_scene`: smooth depth maps, a camera that turns
and moves, noisy window predictions) of 20 frames at 256x576 in windows of
16 with stride 4, the shapes of the smoke run's `reconstruct`. The aligner is
initialised, warmed up by one un-timed run, then run again (a fresh aligner
each time; ITERS iterations, START of them in phase 1, calibrate, the rest
in phase 2; as `run` does them on CUDA, each loss structure's first
iteration eager and the rest replays of its CUDA graph of the loss and
gradients, each followed by the eager Adam step):
once timed with the device synchronised, once under torch.profiler. Prints
the init and PnP time of each of the three initialisations, the wall time
per iteration, the replayed and eager iterations, the device time per
iteration (kernels), the launches per iteration (kernel and graph launch
calls from the host, and kernels on the device) and the kernels that take
the most device time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

ITERS = 60
START = 20
TOP_OPS = 12


def synthetic_scene(n=20, h=64, w=144, focal=120.0, noise=0.03, seed=1, window=16, stride=4):
    """Analytic scene: smooth depth maps, a camera that turns and moves,
    window predictions in each window's first camera frame up to a random
    scale (plus `noise`), diffusion disparities up to a per-window scale,
    exact diffusion cameras. Returns groups, preds (float32 numpy, the
    `predict_*` dict), ground-truth poses, depths and focal, and (h, w)."""
    from geo4d_tpu_torch.pipeline.inference import sliding_windows

    yy, xx = np.mgrid[:h, :w]
    depths = np.stack([3.0 + 0.5 * np.sin(xx / 20 + 0.2 * i) + 0.3 * np.cos(yy / 10)
                       for i in range(n)])
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = 0.03 * i
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [0.05 * i, 0.01 * i, 0.025 * i]
    cam = np.stack([(xx - w / 2) / focal * depths, (yy - h / 2) / focal * depths, depths], -1)
    world = np.einsum("nij,nhwj->nhwi", poses[:, :3, :3], cam) + poses[:, None, None, :3, 3]
    groups = sliding_windows(n, window, stride)
    rng = np.random.default_rng(seed)
    G, S = groups.shape
    preds = np.zeros((G, S, h, w, 3))
    invd = np.zeros((G, S, h, w))
    trajs = np.zeros((G, S, 4, 4))
    for g in range(G):
        scale, inv_scale = rng.uniform(0.7, 1.5), rng.uniform(0.5, 2.0)
        R_w2c = poses[groups[g, 0], :3, :3].T
        t_w2c = -R_w2c @ poses[groups[g, 0], :3, 3]
        for k, i in enumerate(groups[g]):
            preds[g, k] = scale * (world[i] @ R_w2c.T + t_w2c)
            invd[g, k] = inv_scale / depths[i]
            trajs[g, k] = poses[i]
    preds += rng.normal(0, noise, preds.shape)
    f32 = np.float32
    return dict(groups=groups, preds={"pts3d": preds.astype(f32),
                                      "conf": np.ones(preds.shape[:-1], f32),
                                      "inv_depth": invd.astype(f32), "traj": trajs.astype(f32)},
                poses=poses, depths=depths, focal=focal, hw=(h, w))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_aligner needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from geo4d_tpu_torch.alignment.init import init_from_group
    from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
    from geo4d_tpu_torch.core.timing import SpanRecorder, StageTimer, recording

    dev = torch.device("cuda", 0)
    sc = synthetic_scene(h=256, w=576, focal=480.0)
    preds = {k: torch.from_numpy(v).to(dev) for k, v in sc["preds"].items()}
    cfg = AlignerConfig(n_iter=ITERS, depth_traj_start_iter=START)

    def aligner():
        al = GroupAligner(sc["groups"], preds["pts3d"], preds["conf"], sc["hw"],
                          invdepth=preds["inv_depth"], trajs=preds["traj"], config=cfg)
        timer = StageTimer(dev)
        init_from_group(al, preds["pts3d"], preds["conf"], timer=timer)
        print("profile_aligner: init " + " ".join(f"{k} {v:.4f} s"
                                                 for k, v in timer.seconds.items()))
        return al

    aligner().run()                                    # warm-up
    al = aligner()
    t0 = time.perf_counter()
    al.run()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / ITERS
    al = aligner()
    rec = SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            recording(rec):
        al.run()
        torch.cuda.synchronize(dev)
    ka = prof.key_averages()
    counts = rec.totals()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    # kernels only: an op's self device time already counts the kernels it launched
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                     "cudaLaunchKernelExC", "cudaGraphLaunch"))
    print(f"profile_aligner: {sc['groups'].shape[0]} windows x {sc['groups'].shape[1]} frames at "
          f"{sc['hw'][0]}x{sc['hw'][1]}, {ITERS} iterations ({START} in phase 1); "
          f"PnP failures {al.pnp_failures}; replayed iterations "
          f"{counts.get('align_graph_replays', 0)}, eager {counts.get('align_eager_iters', 0)}")
    print(f"profile_aligner: wall {wall_ms:.3f} ms per iteration (no profiler); device "
          f"{device_us / 1e3 / ITERS:.3f} ms per iteration; {launches / ITERS:.1f} kernel and "
          f"graph launch calls and {sum(e.count for e in kernels) / ITERS:.1f} device kernels per "
          f"iteration")
    # by kernel: a replayed graph's kernels have no PyTorch op around them
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_OPS]:
        print(f"profile_aligner: {e.key[:40]:40s} calls {e.count:6d} device "
              f"{e.self_device_time_total / 1e3:9.3f} ms "
              f"({100 * e.self_device_time_total / max(device_us, 1e-9):5.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
