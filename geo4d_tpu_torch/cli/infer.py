"""Demo inference CLI of the PyTorch port: video file (or image directory)
-> 4D reconstruction results directory (pred_traj.txt, pred_focal.txt,
pred_intrinsics.txt, frame_*.npy, conf_*.npy, ...). Port of
geo4d_tpu/cli/infer.py: the same arguments plus --device, less the three
that the reference accepts and ignores (--perframe_ae, --bs, and
--text_input, which cannot be turned off); argparse rejects those.

Usage:
  python -m geo4d_tpu_torch.cli.infer --video_path video.mp4 --savedir results \
      [--ckpt_path model.ckpt --vae_path vae.ckpt --bpe_path bpe.txt.gz]
  python -m geo4d_tpu_torch.cli.infer --video_path frames_dir --tiny --device cpu \
      --height 64 --width 64 --video_length 4 --stride 2 --n_iter 20

--device cuda (the default) requires a CUDA device and runs the
hand-written kernels; --device cpu runs their plain versions.
Under torchrun (`torchrun --standalone --nproc_per_node N -m
geo4d_tpu_torch.cli.infer ...`) the ranks share the windows, one card a
rank over NCCL (or the CPU over gloo with --device cpu); rank 0 aligns the
gathered predictions and writes the results directory.
A video file is decoded by the repo's FFmpeg decoder (native/, built on
first use; where FFmpeg's development libraries are missing that is an
error); a directory of PNG or JPEG frames needs nothing more.
"""

from __future__ import annotations

import argparse
import os


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="geo4d_tpu_torch video -> 4D inference")
    p.add_argument("--video_path", type=str, required=True)
    p.add_argument("--savedir", type=str, default="results")
    p.add_argument("--config", type=str, default=None,
                   help="reference-layout YAML (configs/inference_geo4d.yaml); "
                        "drives model tree + postprocess knobs")
    p.add_argument("--clean_pointcloud", action="store_true",
                   help="cross-view consistency confidence filter")
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--vae_path", type=str, default=None)
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--ddim_steps", type=int, default=5)
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--unconditional_guidance_scale", type=float, default=1.0)
    p.add_argument("--cfg_img", type=float, default=None)
    p.add_argument("--multiple_cond_cfg", action="store_true")
    p.add_argument("--timestep_spacing", type=str, default="uniform_trailing")
    p.add_argument("--guidance_rescale", type=float, default=0.7)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--frame_sampling_stride", type=int, default=1)
    p.add_argument("--max_video_frames", type=int, default=-1)
    p.add_argument("--n_iter", type=int, default=500, help="alignment iters")
    p.add_argument("--window_batch", type=int, default=1)
    p.add_argument(
        "--prompt",
        type=str,
        default="Output a video that assigns each 3D location in the world a consistent color.",
    )
    p.add_argument("--tiny", action="store_true",
                   help="smoke-test with a miniature model (random weights)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (hand-written kernels; an absent device is an error) or cpu")
    return p


def resolve_device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return dev


def main(argv=None):
    args = get_parser().parse_args(argv)
    from geo4d_tpu_torch.alignment.optimizer import AlignerConfig
    from geo4d_tpu_torch.cli.common import (aligner_config_from_postprocess, build_model,
                                            prepare_inference_params)
    from geo4d_tpu_torch.core.timing import StageTimer
    from geo4d_tpu_torch.data.video import load_image_dir, load_video
    from geo4d_tpu_torch.pipeline.export import save_results_dir, save_time_cost
    from geo4d_tpu_torch.pipeline.inference import InferenceConfig, reconstruct

    mesh = None
    if "WORLD_SIZE" in os.environ:
        from geo4d_tpu_torch.parallel.mesh import init_distributed

        mesh = init_distributed(args.device)
    dev = mesh.device if mesh else resolve_device(args.device)
    seq = os.path.splitext(os.path.basename(args.video_path.rstrip("/")))[0]
    out_dir = os.path.join(args.savedir, seq, seq)

    if os.path.isdir(args.video_path):
        frames, _names = load_image_dir(args.video_path, (args.width, args.height),
                                        max_frames=args.max_video_frames)
        frames = frames[:: args.frame_sampling_stride]
        fps = 24 // args.frame_sampling_stride
    else:
        frames, fps = load_video(args.video_path, frame_stride=args.frame_sampling_stride,
                                 video_size=(args.height, args.width),
                                 max_frames=args.max_video_frames)
    print(f"[infer] {frames.shape[0]} frames @ {fps} fps, {frames.shape[1:3]} on {dev}")

    model, postprocess = build_model(args, dev)
    if args.ckpt_path is None:
        print("[infer] WARNING: no checkpoint given — random weights")
    text_ctx, uncond_text_ctx = prepare_inference_params(model, args.prompt, args.bpe_path)

    icfg = InferenceConfig(
        window=args.video_length,
        stride=args.stride,
        ddim_steps=args.ddim_steps,
        ddim_eta=args.ddim_eta,
        cfg_scale=args.unconditional_guidance_scale,
        cfg_img=args.cfg_img if args.multiple_cond_cfg else None,
        timestep_spacing=args.timestep_spacing,
        guidance_rescale=args.guidance_rescale,
        window_batch=args.window_batch,
    )
    if postprocess is not None:
        acfg = aligner_config_from_postprocess(postprocess, n_iter=args.n_iter)
    else:
        acfg = AlignerConfig(n_iter=args.n_iter)
    timer = StageTimer(dev)
    scene, _preds, timing = reconstruct(
        model, frames, text_ctx, fps=fps, inference_config=icfg, aligner_config=acfg,
        seed=args.seed, mesh=mesh, verbose=True, uncond_text_ctx=uncond_text_ctx, timer=timer)
    if scene is None:           # a rank other than 0: rank 0 aligns and writes
        return
    print(f"[infer] PnP failures {scene.pnp_failures}; stage seconds "
          + " ".join(f"{k}={v:.3f}" for k, v in timer.seconds.items()))
    if args.clean_pointcloud:
        scene.apply_cleanup()
    save_results_dir(out_dir, scene, rgb_frames=frames)
    save_time_cost(os.path.join(args.savedir, seq, "time_cost.txt"), timing)
    print(f"[infer] results -> {out_dir} ({timing['sec_per_frame']:.2f}s/frame)")


if __name__ == "__main__":
    main()
