"""Long-sequence run at KITTI's evaluation size, port of
scripts/longseq_proof.py:

    python -m geo4d_tpu_torch.tools.longseq [--frames 110] [--out FILE]
    python -m geo4d_tpu_torch.tools.longseq --tiny --device cpu --frames 20

`frames` seeded uint8 frames at 640x192 go through `predict_video` in
`sliding_windows(frames, 16, 4)` windows (25 for 110 frames), five windows a
UNet call, twice: the first run warms up, the second is timed. The group
aligner then runs twice (`n_iter` iterations, a fresh aligner each time) on
`synth_predictions`' self-consistent geometry of the same windows, its
inputs staged on the device before the clock starts; the second run is
timed. The device is synchronised before every clock is read. The timed
runs carry no `core.timing.StageTimer`, whose synchronisations would add to
their times: each part runs once more, as its timed run did, under a timer
for the stage split (PnP is `align_pnp`). Prints one JSON record (and
writes it to `--out` when given): wall seconds of each part, seconds per
frame, the peak memory allocated during the diffusion and during the
aligner, each stage's seconds and the device's name.

The CLI builds the shipped model with seeded random-normal weights
(`init_random_`) on the card. `--tiny --device cpu` takes the test-size
preset on the CPU, where the kernels' plain versions run: the tiny model,
frames of 32x64 and 5 aligner iterations.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from geo4d_tpu_torch.alignment.init import init_from_group
from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
from geo4d_tpu_torch.core.device import default_device
from geo4d_tpu_torch.core.timing import StageTimer
from geo4d_tpu_torch.pipeline.inference import InferenceConfig, WindowPredictor, sliding_windows

KITTI_HW = (192, 640)
TINY_HW, TINY_N_ITER = (32, 64), 5
NOTE = ("random-normal weights; aligner on synthetic self-consistent geometry (inputs staged "
        "on the device before the timer, warm run then timed run); timed runs without a "
        "StageTimer, *_stage_s from one more run of each part under it; align_cold_* = this "
        "call's first aligner run")


def synth_predictions(groups, h, w, seed=0):
    """Self-consistent moving-camera geometry at (h, w) — same construction
    as bench.synth_predictions, parameterized by resolution."""
    import numpy as np

    G, S = groups.shape
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    f = 500.0
    n = int(groups.max()) + 1
    base = rng.uniform(2, 5, (h, w))
    depths = base[None] + rng.uniform(-0.1, 0.1, (n, h, w))
    shifts = np.cumsum(rng.uniform(-0.02, 0.02, (n, 3)), axis=0)
    pts_frames = np.stack([
        np.stack([(x - w / 2) / f * depths[i], (y - h / 2) / f * depths[i],
                  depths[i]], -1) + shifts[i]
        for i in range(n)
    ])
    preds = pts_frames[groups].astype(np.float32)
    conf = rng.uniform(0.3, 1.2, size=(G, S, h, w)).astype(np.float32)
    invd = (1.0 / depths[groups]).astype(np.float32)
    trajs = np.tile(np.eye(4, dtype=np.float32), (G, S, 1, 1))
    trajs[..., :3, 3] = -shifts[groups]
    return preds, conf, invd, trajs


def run_longseq(model, text_ctx: np.ndarray, frames: int = 110,
                hw: Tuple[int, int] = KITTI_HW, window_batch: int = 5, n_iter: int = 500,
                device=None, check: Optional[Callable[[dict], None]] = None) -> dict:
    """The long-sequence protocol on `model` (on `device`, by default the
    model's); text_ctx (1, 77, ctx) is the text context. `check`, when
    given, is called with the timed diffusion run's predictions (device
    tensors) before they are freed. Returns the JSON record."""
    dev = torch.device(device) if device is not None else next(model.parameters()).device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    h, w = hw
    groups = sliding_windows(frames, 16, 4)
    G, S = groups.shape
    predictor = WindowPredictor(model, InferenceConfig(window_batch=window_batch, sky_eps=0.1),
                                device=dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    video = np.random.default_rng(0).integers(0, 256, size=(frames, h, w, 3), dtype=np.uint8)
    sync()
    t0 = time.perf_counter()
    preds = predictor.predict_video(video, groups, text_ctx, 10, seed=123, return_device=True)
    sync()
    diff_warm = time.perf_counter() - t0
    del preds
    video = np.random.default_rng(1).integers(0, 256, size=(frames, h, w, 3), dtype=np.uint8)
    sync()
    t0 = time.perf_counter()
    preds = predictor.predict_video(video, groups, text_ctx, 10, seed=124, return_device=True)
    sync()
    diff_s = time.perf_counter() - t0
    peak_diff = torch.cuda.max_memory_allocated(dev) if cuda else None
    if check is not None:
        check(preds)
    del preds
    # the stage split, from the timed run's inputs once more
    diff_timer = StageTimer(dev)
    predictor.predict_video(video, groups, text_ctx, 10, seed=124, return_device=True,
                            timer=diff_timer)
    # free the predictions before the aligner's buffers
    del predictor, video
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    acfg = AlignerConfig(n_iter=n_iter)

    def align_once(seed, timer=None):
        """Aligner construction + init, then the run, on fresh geometry;
        returns (ctor+init seconds, run seconds, PnP failures, final loss)
        and frees the aligner, so no run's peak holds another's buffers."""
        p, c, invd, trajs = synth_predictions(groups, h, w, seed=seed)
        p_dev = torch.as_tensor(p, device=dev)
        pf = p_dev.reshape(G, S, -1, 3)
        c_dev = torch.as_tensor(c, device=dev)
        cf = c_dev.reshape(G, S, -1)
        iv = torch.as_tensor(invd.reshape(G, S, -1), device=dev)
        tj = torch.as_tensor(trajs, device=dev)
        del p, c, invd, trajs
        sync()
        t0 = time.perf_counter()
        al = GroupAligner(groups, pf, cf, (h, w), invdepth=iv, trajs=tj, config=acfg,
                          device=dev)
        init_from_group(al, p_dev, c_dev, timer=timer)
        sync()
        t_init = time.perf_counter() - t0
        al.run(timer=timer)
        sync()
        t_run = time.perf_counter() - t0 - t_init
        if not np.isfinite(al.final_loss):
            raise RuntimeError(f"aligner final loss {al.final_loss}")
        return t_init, t_run, al.pnp_failures, al.final_loss

    cold_init, cold_run, _, _ = align_once(0)
    t_init, run_s, pnp_failures, final_loss = align_once(1)
    peak_align = torch.cuda.max_memory_allocated(dev) if cuda else None
    align_timer = StageTimer(dev)
    align_once(1, align_timer)
    e2e = diff_s + t_init + run_s
    return {
        "frames": frames, "resolution": f"{w}x{h}", "windows": G,
        "window_batch": window_batch, "n_iter": n_iter,
        "diffusion_s": diff_s,
        "diffusion_warm_s": diff_warm,
        "align_ctor_init_s": t_init,
        "align_run_s": run_s,
        "align_cold_ctor_init_s": cold_init,
        "align_cold_run_s": cold_run,
        "e2e_s": e2e,
        "sec_per_frame": e2e / frames,
        "frames_per_sec": frames / e2e,
        "peak_bytes_diffusion": peak_diff,
        "peak_bytes_align": peak_align,
        "diffusion_stage_s": diff_timer.seconds,
        "align_stage_s": align_timer.seconds,
        "align_pnp_failures": pnp_failures,
        "align_final_loss": final_loss,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "note": NOTE,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Long-sequence run of geo4d_tpu_torch")
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--tiny", action="store_true",
                    help="the test-size preset: tiny model, 32x64 frames, 5 aligner iterations")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the JSON record here")
    args = ap.parse_args(argv)

    from geo4d_tpu_torch.models.presets import flagship, init_random_, tiny

    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = default_device()
    if args.tiny:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        model = tiny(temporal_length=16, dtype=dtype, device="meta")
        hw, n_iter = TINY_HW, TINY_N_ITER
    else:
        model = flagship()
        hw, n_iter = KITTI_HW, 500
    model.text_encoder = None       # the run takes a zero text context
    model = init_random_(model, dev, seed=0).eval()
    text_ctx = np.zeros((1, 77, model.unet.context_dim), np.float32)
    record = run_longseq(model, text_ctx, args.frames, hw, n_iter=n_iter, device=dev)
    line = json.dumps(record)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
