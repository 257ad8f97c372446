"""Benchmark evaluation CLI of the PyTorch port: dataset -> depth and pose
metrics. Port of geo4d_tpu/cli/evaluate.py (the reference's
scripts/evaluation/infer_geo4d.py `run_evaluation`): per sequence,
sliding-window inference and alignment, depth evaluation at the ground
truth's resolution (KITTI: no depth cap, lad2; the others: 70 m cap, lad2 at
lr 1e-2 for 5000 iterations on the cross-window validity mask, clipped at
70), per-frame error maps, ATE/RPE on the Sintel pose subset (every
sequence elsewhere), valid-pixel-weighted means, and the append-mode logs
_error_log_depth.txt, _error_log.txt, _error_log_all.txt and time_cost.txt.
The same arguments as the JAX CLI plus --device.

Usage:
  python -m geo4d_tpu_torch.cli.evaluate --dataset sintel --data_root ./data/sintel \
      --savedir eval_out [--ckpt_path model.ckpt --vae_path vae.ckpt]
  python -m geo4d_tpu_torch.cli.evaluate --dataset sintel --data_root ./data/sintel \
      --savedir eval_out --tiny --device cpu --video_length 4 --stride 2 --n_iter 10

--device cuda (the default) requires a CUDA device and runs the
hand-written kernels; --device cpu runs their plain versions. The
predicted depth and the validity mask are resized to the ground truth's
resolution by bicubic interpolation on the device (a = -0.75, half-pixel
centres, edge pixels repeated: OpenCV's INTER_CUBIC).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from geo4d_tpu_torch.cli.common import build_model, prepare_inference_params
from geo4d_tpu_torch.cli.infer import resolve_device


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="geo4d_tpu_torch benchmark evaluation")
    p.add_argument("--dataset", type=str, required=True,
                   choices=["sintel", "bonn", "kitti", "tum", "scannet", "davis"])
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--config", type=str, default=None,
                   help="reference-layout YAML; drives model + postprocess")
    p.add_argument("--clean_pointcloud", action="store_true")
    p.add_argument("--savedir", type=str, default="eval_results")
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--seq_list", type=str, nargs="*", default=None)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--ddim_steps", type=int, default=5)
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--unconditional_guidance_scale", type=float, default=1.0)
    p.add_argument("--timestep_spacing", type=str, default="uniform_trailing")
    p.add_argument("--guidance_rescale", type=float, default=0.7)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--n_iter", type=int, default=500)
    p.add_argument("--window_batch", type=int, default=1)
    p.add_argument("--max_frames", type=int, default=-1)
    p.add_argument("--use_gt_focal", action="store_true")
    p.add_argument("--full_seq", action="store_true")
    p.add_argument("--perframe_ae", action="store_true")  # accepted and ignored, as in the JAX CLI
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model at 96x64 (pipeline smoke test)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (hand-written kernels; an absent device is an error) or cpu")
    return p


def resize_to_gt(maps: np.ndarray, gt_hw, device) -> np.ndarray:
    """Bicubic resize of (N, h, w) maps to gt_hw (H, W) on `device`, as
    float32. It runs in float64: PyTorch computes the source coordinates in
    the input's precision, and in float32 they drift by up to ~2e-5 pixel
    at 1024 columns, where OpenCV's (computed in double) do not."""
    x = torch.as_tensor(np.asarray(maps, np.float64), device=device)[:, None]
    out = F.interpolate(x, size=tuple(gt_hw), mode="bicubic", align_corners=False,
                        antialias=False)
    return out[:, 0].float().cpu().numpy()


def evaluate(args, model, text_ctx: np.ndarray, uncond_text_ctx: np.ndarray, device,
             postprocess=None) -> dict:
    """The evaluation loop over the sequences of `args` (get_parser's
    arguments) with a built model and its text contexts. Writes the results
    directories and logs under args.savedir and returns {"depth": [metrics
    per sequence], "pose": [(ATE, RPE_t, RPE_r) per sequence, zeros where
    the pose evaluation failed], "pose_failed": [sequences whose pose
    evaluation failed], "stages": {sequence: seconds per stage and the
    lad2 fit's s, t and L1 objective}}."""
    from geo4d_tpu_torch.alignment.optimizer import AlignerConfig
    from geo4d_tpu_torch.cli.common import aligner_config_from_postprocess
    from geo4d_tpu_torch.data.datasets import (DATASET_RESOLUTION, SINTEL_POSE_SEQS,
                                               list_sequences, load_eval_sequence)
    from geo4d_tpu_torch.data.images import write_png
    from geo4d_tpu_torch.evals.depth import depth_evaluation
    from geo4d_tpu_torch.evals.trajectory import Trajectory, eval_metrics
    from geo4d_tpu_torch.pipeline.export import save_results_dir, save_time_cost
    from geo4d_tpu_torch.pipeline.inference import (InferenceConfig, reconstruct,
                                                    sliding_windows)

    w, h = (96, 64) if args.tiny else DATASET_RESOLUTION[args.dataset]
    icfg = InferenceConfig(
        window=args.video_length, stride=args.stride, ddim_steps=args.ddim_steps,
        ddim_eta=args.ddim_eta, cfg_scale=args.unconditional_guidance_scale,
        timestep_spacing=args.timestep_spacing, guidance_rescale=args.guidance_rescale,
        window_batch=args.window_batch,
        sky_eps=0.1,  # the evaluation's mask eps (infer_geo4d.py:479); the demo uses 0.35
    )
    if postprocess is not None:
        acfg = aligner_config_from_postprocess(postprocess, n_iter=args.n_iter)
    else:
        acfg = AlignerConfig(n_iter=args.n_iter)

    seqs = args.seq_list or list_sequences(args.dataset, args.data_root)
    os.makedirs(args.savedir, exist_ok=True)
    depth_log = os.path.join(args.savedir, "_error_log_depth.txt")
    pose_log = os.path.join(args.savedir, "_error_log.txt")

    depth_rows, pose_rows, pose_failed, stages = [], [], [], {}
    total_time = {"diffusion_s": 0.0, "alignment_s": 0.0, "frames": 0.0}

    for seq in seqs:
        t0 = time.perf_counter()
        sample = load_eval_sequence(args.dataset, args.data_root, seq,
                                    max_frames=args.max_frames,
                                    resolution=(w, h) if args.tiny else None)
        st = stages[seq] = {"load_s": time.perf_counter() - t0}
        if sample.frames.shape[0] < args.video_length:
            print(f"[eval] skip {seq}: too short")
            continue
        print(f"[eval] {seq}: {sample.frames.shape[0]} frames")
        intr = sample.intrinsics if args.use_gt_focal else None
        # fs conditioning is 24 whatever the dataset's rate (infer_geo4d.py:439)
        scene, preds, timing = reconstruct(
            model, sample.frames, text_ctx, fps=24, inference_config=icfg, aligner_config=acfg,
            seed=args.seed, intrinsics=intr, uncond_text_ctx=uncond_text_ctx, device=device)
        for k in ("diffusion_s", "alignment_s", "frames"):
            total_time[k] += timing[k]
        st.update(diffusion_s=timing["diffusion_s"], alignment_s=timing["alignment_s"],
                  pnp_failures=scene.pnp_failures)
        if args.clean_pointcloud:
            scene.apply_cleanup()
        seq_dir = os.path.join(args.savedir, seq)
        save_results_dir(seq_dir, scene, rgb_frames=sample.frames, save_glb=False)

        # cross-window validity: AND of every window's sky/far mask at each
        # frame (infer_geo4d.py:422,483)
        n_frames = sample.frames.shape[0]
        groups = sliding_windows(n_frames, args.video_length, args.stride)
        valid_np = preds["valid"].cpu().numpy()
        pnt_valid = np.ones((n_frames,) + valid_np.shape[2:], bool)
        for g, idx in enumerate(groups):
            pnt_valid[idx] &= valid_np[g]

        # ---- depth metrics ----
        if sample.gt_depth is not None:
            n = min(len(sample.gt_depth), scene.N)
            gt_hw = sample.gt_depth.shape[1:]
            gt_d = sample.gt_depth[:n]
            t0 = time.perf_counter()
            pred_d = resize_to_gt(scene.get_depthmaps()[:n], gt_hw, device)
            if args.dataset == "kitti":
                amask, max_depth = None, None
                kw = {}
            else:
                amask = resize_to_gt(pnt_valid[:n], gt_hw, device) > 0.8
                max_depth = 70.0
                kw = dict(lr=1e-2, max_iters=5000, post_clip_max=70.0)
            st["resize_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res, err_map = depth_evaluation(pred_d, gt_d, max_depth=max_depth, align="lad2",
                                            align_mask=amask, return_st=True,
                                            return_error_map=True, device=device, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            st["depth_eval_s"] = time.perf_counter() - t0
            st["s"], st["t"] = res.pop("s"), res.pop("t")
            fit = (gt_d > 0) if max_depth is None else (gt_d > 0) & (gt_d < max_depth)
            if amask is not None:
                fit &= amask
            st["l1"] = float(np.abs(st["s"] * pred_d + st["t"] - gt_d)[fit].sum(dtype=np.float64))
            for i in range(err_map.shape[0]):
                write_png(os.path.join(seq_dir, f"error_{i}.png"),
                          np.clip(err_map[i] * 255, 0, 255).astype(np.uint8))
            depth_rows.append(res)
            with open(depth_log, "a") as f:
                f.write(f"{seq}: {res}\n")
            print(f"[eval] {seq} AbsRel {res['Abs Rel']:.4f} δ<1.25 {res['δ < 1.25']:.4f}")

        # ---- pose metrics ----
        if sample.gt_traj is not None and (args.dataset != "sintel" or seq in SINTEL_POSE_SEQS):
            try:
                pred_traj = Trajectory.from_tum(scene.get_tum_poses())
                gt = Trajectory.from_tum(sample.gt_traj[: scene.N])
                n = min(len(pred_traj.positions), len(gt.positions))
                pred_traj = Trajectory(pred_traj.positions[:n], pred_traj.rotations[:n],
                                       pred_traj.timestamps[:n])
                gt = Trajectory(gt.positions[:n], gt.rotations[:n], gt.timestamps[:n])
                ate, rpe_t, rpe_r = eval_metrics(pred_traj, gt)
                try:
                    from geo4d_tpu_torch.evals.plots import plot_trajectory

                    plot_trajectory(os.path.join(args.savedir, f"{seq}.png"), pred_traj, gt,
                                    title=seq)
                except Exception as e:  # the plot is for viewing only
                    print(f"[eval] trajectory plot failed for {seq}: {e}")
                pose_rows.append((ate, rpe_t, rpe_r))
                with open(pose_log, "a") as f:
                    f.write(f"{seq}: ATE {ate:.5f} RPE_t {rpe_t:.5f} RPE_r {rpe_r:.5f}\n")
                print(f"[eval] {seq} ATE {ate:.4f} RPE_t {rpe_t:.4f} RPE_r {rpe_r:.4f}")
            except Exception as e:  # one bad sequence must not end the run
                # zeros, left out of the nonzero mean (infer_geo4d.py:592-596,627-634)
                pose_rows.append((0.0, 0.0, 0.0))
                pose_failed.append(seq)
                print(f"[eval] pose eval failed for {seq}: {e}")

    # ---- aggregate (valid-pixel-weighted means, infer_geo4d.py:614-625) ----
    with open(os.path.join(args.savedir, "_error_log_all.txt"), "w") as f:
        if depth_rows:
            weights = np.asarray([r["valid_pixels"] for r in depth_rows], np.float64)
            weights /= weights.sum()
            for key in ("Abs Rel", "Sq Rel", "RMSE", "Log RMSE",
                        "δ < 1.25", "δ < 1.25^2", "δ < 1.25^3"):
                val = float(sum(w * r[key] for w, r in zip(weights, depth_rows)))
                f.write(f"{key}: {val:.5f}\n")
                print(f"[eval] weighted {key}: {val:.5f}")
        if pose_rows:
            arr = np.asarray(pose_rows)
            for i, name in enumerate(["ATE", "RPE_trans", "RPE_rot"]):
                nz = arr[:, i][np.nonzero(arr[:, i])]
                val = float(nz.mean()) if nz.size else 0.0
                f.write(f"{name}: {val:.5f}\n")
                print(f"[eval] mean {name}: {val:.5f}")
    if total_time["frames"]:
        total_time["sec_per_frame"] = (
            total_time["diffusion_s"] + total_time["alignment_s"]) / total_time["frames"]
        save_time_cost(os.path.join(args.savedir, "time_cost.txt"), total_time)
        print(f"[eval] {total_time['sec_per_frame']:.3f} sec/frame")
    return {"depth": depth_rows, "pose": pose_rows, "pose_failed": pose_failed,
            "stages": stages}


def main(argv=None) -> dict:
    from geo4d_tpu_torch.data.datasets import DEFAULT_PROMPT

    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    model, postprocess = build_model(args, device)
    text_ctx, uncond_text_ctx = prepare_inference_params(model, DEFAULT_PROMPT, args.bpe_path)
    return evaluate(args, model, text_ctx, uncond_text_ctx, device, postprocess)


if __name__ == "__main__":
    main()
