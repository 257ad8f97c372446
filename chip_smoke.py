#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (geo4d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code and without
the final `ok` line):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and the float32 matmul/conv precision chosen.
2. build: compiles geo4d_tpu_torch/csrc/*.cu with nvcc for sm_90a into
   build/geo4d_tpu_torch/ and loads the library.
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, in bf16, at the shapes the main path gives it, and against a
   second launch of itself (bit for bit); prints max abs and rel error, the
   median device time of both (CUDA events, after warm-up, host work hidden
   behind a device sleep; `median_ms`), the same with a cold L2 (`cold_ms`:
   an untimed L2-clearing write before each call), the time of one call as
   the host issues it (`call_ms`), the bound and the library call's device
   time.
4. slice: the shipped model at full width (random-normal weights, seed 0)
   computes its text context with its CLIP text tower and the port's
   tokenizer, then runs `reconstruct` over a seeded 20-frame 256x576 video
   (2 sliding windows, 5-step DDIM, the group aligner with the default 500
   iterations) and exports the results directory to a temporary directory;
   checks output shapes and finiteness, the results files, that every kernel
   launched during that run and that no plain version ran on a CUDA tensor;
   prints PnP failures, per-stage wall times and peak memory.
5. shapes: every (kernel, shape) that the slice's reconstruct launched,
   checked as in phase 3 and timed beside its bound and its library call
   (one PyTorch call computing the same function, a yardstick the port
   never calls); GroupNorm's two-pass shapes also time each pass alone
   beside its own bound; prints launches x ms per shape and each kernel's
   totals (GroupNorm's split by path and pass).
6. reference: the tiny preset in bf16 on the card (kernels) against the
   same weights in float32 on the CPU (plain versions), on a small input.
7. align_reference: the group aligner on an analytic 20-frame 64x144 scene
   (windows of 16, stride 4), float32 on the card against float32 on the
   CPU, and both against the scene's ground truth.
8. evaluate (run right after phase 4, with its model and text context): the
   port's evaluation entry point (geo4d_tpu_torch.cli.evaluate) on a
   synthetic Sintel sequence `alley_2` written to a temporary directory (20
   PNG frames, .dpt depths and .cam cameras at 1024x436) at Sintel's 576x256
   with the CLI's defaults (5-step DDIM, 500 aligner iterations, lad2 at
   lr 1e-2 for 5000 steps); checks every output file, finite AbsRel and
   delta < 1.25, that the pose evaluation did not take its failure branch,
   that every kernel launched and no plain version ran on a CUDA tensor;
   prints the stage times.
   The sequence also gets .flo optical flow (the rigid flow of its depth
   and cameras, plus a moving patch): `sintel_get_dynamics` labels it on the
   host, `compute_dynamic_masks` on the card; both must find the patch, and
   `save_results_dir(..., dynamic_masks=...)` with the slice's scene must
   write enlarged_dynamic_mask_<i>.png with the masks' pixels.
9. resolutions: one window of `predict_windows` (1 DDIM step, full width)
   at Bonn's 512x384 and KITTI's 640x192, and `predict_video` over 30
   frames at 640x192: five windows of 16 (the last a tail window) as one
   80-frame UNet call (window_batch 5) and a 14-frame last encoder chunk, as
   the benchmark's recon.kitti110; every (kernel, shape) they launched
   is checked against its plain version and a second launch (not timed);
   then every `decode_modality` layout once on a 16-frame window of random
   latents at 576x256.
10. attention_options (with the slice's model): one 1-step 16-frame window
   at 576x256 with the plain UNet, then with relative-position temporal
   attention, then with causal temporal attention (each UNet carries the
   plain one's weights; the relative-position tables are seeded); outputs
   finite and unlike the plain ones; K1 and K2 launched, K3 not at all (its
   gate excludes both options); the UNet step of each timed.
11. inputs: probes pkg-config for FFmpeg and g++; decodes the committed
   JPEG fixtures (tests/fixtures/torch_inputs) with data/jpeg.py, bit for
   bit against the committed Pillow pixels, and times the decode; decodes
   every file of tests/fixtures/torch_formats (progressive, block-smoothed,
   arithmetic-coded, 4:1:1, CMYK, YCCK and lossless JPEG; palette, 1- to
   4-bit, Adam7 and 16-bit PNG) in its three views (Pillow's raw array,
   Pillow's RGB, OpenCV's RGB) against the committed pixels or their
   hashes, checks that the 12-bit file raises, and times each decode beside
   a baseline file of the same pixels and size (data/jpeg.py's encoder, or
   a non-interlaced 8-bit RGB PNG with the same row filters); runs `cli/infer.main` at 576x256 (flagship, random
   weights, --n_iter 50) on a 20-file directory drawn from both fixture
   directories (INFER_FRAMES: baseline JPEG and every family of the new
   modes, each with its own extension) and checks its results directory
   and that K1-K3 launched. Where FFmpeg is found: decodes the
   committed clip at its own size against the committed decode (at most
   VIDEO_LSB apart) and runs `cli/infer.main` on it the same way; where it
   is not, `load_video` must raise the error that names frame directories.
   The reference phase (6) also runs with each attention option on, and
   align_reference (7) also runs the host init chain (numpy inputs) and the
   aligner with its rigid-flow term (weight 0.1, target flows from the
   ground truth), each on the card against the CPU.
12. train: the training CLI (geo4d_tpu_torch.cli.train.main) at full width
   (flagship, random-normal weights) on two seeded 16x256x576 .npz shards
   written to a temporary directory: 3 steps of pc_ray_cross_depth at batch
   1, the CLI's defaults otherwise. Losses finite, metrics.jsonl has a row
   per step, ckpt_final loads into a UNet; K1-K3 and their backward kernels
   K1b-K3b launched, no plain version on a CUDA tensor; prints the free
   disk, the first and steady step times, batch building against the train
   step, and peak memory; the checkpoints are deleted. From here on cuDNN
   runs its deterministic algorithms.
13. vae_train: one generator and one discriminator step of the flagship RGB
   VAE and a PatchGAN on 2 frames at 256x576 (disc_start 0): K1b at the
   two-pass shapes of K1.
14. backward: every (backward kernel, shape) of phases 12-13 against its
   plain backward on a seeded cotangent (relative L2 of each gradient at
   most BWD_REL_L2: 1e-4 for K1b, whose cotangent follows y, 1e-2 for K2b
   and K3b) and a second launch (bit for bit), timed warm and cold
   beside its bound and the library call's backward (F.group_norm, SDPA
   through torch.autograd), with its launches per training step and the
   path its plan takes (K1b coop / two_pass, K2b wgmma / image, K3b's ring
   of warps and slots); first, K3b's six instances in the built library
   (cuobjdump): registers, no spills, mma.sync and movmatrix in the SASS.
15. train_repeat: one full-width training step run twice from the same
   state and batch (the second, a new state of a shape already run, is the
   step's captured CUDA graph): loss and state repeat bit for bit.
15b. train_graph: the training step's CUDA graph (training/step.py) at the
   train.b1 shape (flagship, one 16 x 256 x 576 pc_ray_cross_depth batch):
   3 steps of make_train_step as it runs (eager, then capture and replay)
   against 3 steps with `capture` off, from one state with the same draws:
   each step's loss and every gradient bit for bit (else the largest
   relative L2 gap), the states after the 3 steps, each step's kernel
   launches per shape (KernelStats), the counters and the capture span;
   forward_backward ms per step, max_memory_allocated and
   max_memory_reserved of each side. Then the same with `remat` on (the
   capture holds the checkpointed blocks' recomputation). Prints one line
   prefixed `train_graph` per setting.
16. train_reference: one tiny-preset step, bf16 on the card against float32
   on the CPU (loss and gradient), and the tiny CLI's 2 + resumed 1 steps
   against 3 uninterrupted steps (the same step-3 loss).

17. parallel (geo4d_tpu_torch.parallel; NCCL refuses two ranks on one GPU,
   so the card runs NCCL at world size 1 and two gloo ranks sharing cuda:0,
   gloo taking the CUDA tensors; no speed claim):
   (a) parallel_dryrun: `dryrun_multiprocess(2, "cpu")`, two gloo ranks on
   the CPU, and `dryrun_multiprocess(2, "cuda", "gloo")`, two gloo ranks
   sharing cuda:0 in bf16 through the kernels; (b) parallel_infer: two spawned ranks each build the flagship
   (random-normal weights, seed 0) and run the slice's reconstruct with a
   mesh (one window a rank, predictions gathered, rank 0 aligns with 500
   iterations and writes and checks the results directory); K1-K3 must
   launch in each rank, no plain version on a CUDA tensor; rank 0 compares
   the gathered predictions with one process at window_batch 2 (relative
   L2 at most PAR_INFER_REL_L2); (c)(i) the train_repeat step through the
   DP and the FSDP path over NCCL at world size 1, each bit for bit equal
   to the plain step; (ii) two spawned gloo ranks at the flagship's widths
   and PAR_NUM_RES_BLOCKS, batch 1 a rank: a DP and an FSDP step from the
   same state (bit for bit equal, K1b-K3b launched in each rank), against
   one process at batch 2 (loss, the averaged gradient read from AdamW's
   first moment, and the updated master weights); (iii)
   cli/train.py under torch.distributed.run, two gloo ranks, --fsdp, 2
   steps: rank 0 writes metrics.jsonl and ckpt_final, which loads into a
   one-process UNet. Prints each sub-phase's wall, each rank's peak memory
   and the seconds of collectives a step.

18. longseq (run right after phase 9, with the slice's model): the
   long-sequence run of geo4d_tpu_torch.tools.longseq at full size, 110
   seeded frames at KITTI's 640x192 in 25 windows of 16 (stride 4), five
   windows a UNet call, 500 aligner iterations on synthetic self-consistent
   geometry, the diffusion and the aligner each run twice (warm, then
   timed) and once more under a StageTimer for the stage split; the timed
   run's pts3d, conf and inv_depth must be finite and of
   shape (25, 16, 192, 640, .), K1-K3 must launch and no plain version run
   on a CUDA tensor; every (kernel, shape) it launched that phases 5 and 9
   do not check is checked against its plain version and a second launch;
   prints the record (times, seconds per frame, the peak memory of the
   diffusion and of the aligner, stage seconds) on one line prefixed
   `longseq`.

19. offline (run right after phase 11, on the host of the card, where there
   is no OpenCV, Pillow or h5py): (a) every offline tool of the port
   (geo4d_tpu_torch/tools/offline_check.py: the training-set preparers of
   BlendedMVS, StaticThings3D, CO3D, WildRGB-D, ARKitScenes, Waymo (crop and
   pairs) and ScanNet++ (a fisheye DSLR and two radial-tangential iPhone
   frames), habitat's preprocess_metadata with a seeded render_fn, the .sens
   export and the mesh rasteriser) on seeded raw files written with the
   port's own encoders, each output tree held to the JAX package's outputs
   committed in tests/fixtures/torch_offline (PNG pixels, JPEG and EXR bytes,
   arrays within 1e-9 relative); prepare_megadepth and prepare_nyuv2 must
   raise the JAX package's h5py errors; (b) once at published sizes, timed
   on the host clock: ScanNet++'s undistort of a 1752x1168 fisheye and a
   1920x1440 iPhone frame, render_mesh_depth of a seeded ~1e6-triangle room
   at 1752x1168, a 10-frame .sens export of 1296x968 colour with 640x480
   depth (as it is and resized to 640x480), a habitat crop at 512x512 from a
   1024x2048 envmap; the raster library against its numpy version on a small
   mesh; (c) the viewer over the slice's results directory (kept from phase
   4; `--offline-only` writes a seeded one of the same size):
   load_results_dir, export_html, and a ViewerServer on 127.0.0.1 whose
   meta message and every frame a stdlib websocket client fetches; frame and
   point counts must equal load_results_dir's. Prints the record on one line
   prefixed `offline`.

20. aligner (run right after phase 7): the aligner's objective kernel
   (ops/align_objective.py, not yet on the aligner's path) against its plain
   version on the card, on initialised and calibrated aligners over the
   analytic scene (20 frames at 64x144 with a shared and with a per-frame
   focal, and 32 frames at 256x576 in 5 windows of 16, the shape of the
   benchmark's recon.sintel32), without and with the depth term: relative L2
   of the loss and of each gradient at most ALIGN_KERNEL_REL, a second launch
   bit for bit, the loss-only variant equal to the loss; its device time
   beside its byte bound (at least ALIGN_ROOFLINE_MIN of it at 256x576).
   Then 500 iterations at 256x576 as `run` does them (CUDA graphs), again,
   with every iteration eager, and eagerly with PyTorch's deterministic
   algorithms, over the same predictions: the four runs equal bit for bit
   (the objective, depth and pose gaps printed); every iteration but one per
   loss structure replayed, no memory left allocated after the second graph
   run (the graphs and their pool released); ms per iteration, peak memory
   and the memory left after each run. The same at 64x144 with the
   rigid-flow term (three loss structures).

The second-to-last line is a JSON object with one entry per kernel (the
backward kernels from phases 12 and 14); the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --shapes-to FILE      # also save phase 5's shapes
    python3 chip_smoke.py --shapes-only FILE    # phases 1-2 and 5 only
    python3 chip_smoke.py --train-only          # phases 1-2 and 12-16 only
    python3 chip_smoke.py --parallel-only       # phases 1-2, 15 and 17 only
    python3 chip_smoke.py --longseq-only        # phases 1-2 and 18 only
    python3 chip_smoke.py --resolutions-only    # phases 1-2 and 9 only
    python3 chip_smoke.py --offline-only        # phases 1-2 and 19 only
    python3 chip_smoke.py --aligner-only        # phases 1-2 and 20 only

`--shapes-only` times the saved (kernel, shape, launches) list through the
`geo4d_tpu_torch` beside this script; a copy of the script in an unpacked
older checkout times that checkout's kernels by the same method, so two
versions can be compared in one call.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

# (name, source, TPU kernel it replaces)
KERNELS = {
    "group_norm": ("geo4d_tpu_torch/csrc/group_norm.cu",
                   "geo4d_tpu/ops/group_norm.py:101 _gn_kernel, :140 _gn_stats_kernel, "
                   ":168 _gn_apply_kernel"),
    "flash_attention": ("geo4d_tpu_torch/csrc/flash_attention.cu",
                        "geo4d_tpu/ops/flash_attention.py:70"),
    "temporal_attention": ("geo4d_tpu_torch/csrc/temporal_attention.cu",
                           "geo4d_tpu/ops/temporal_attention.py:85"),
}
# bf16 keeps 8 significant bits: allow about two output ulps plus the
# float32 summation order (and, for flash attention, the online softmax)
BF16_ATOL = 2 ** -6
BF16_RTOL = 2 ** -7
# tiny preset, bf16 on the card vs float32 on the CPU: relative L2 error
REF_REL_L2 = 1e-2
# aligner, float32 card vs float32 CPU after 500 Adam steps: poses compared
# relative to frame 0 (the world frame is a free gauge of the objective)
ALIGN_ROT_DEG = 0.1
ALIGN_REL = 1e-3
# with the rigid-flow term on: the term (exact target flows at the true focal)
# and the point-map term (noisy predictions) pull the focal apart, 114 against
# 123 px, and float32 rounding moves the run along that valley (measured card
# vs CPU: focal 1.0e-2, depth 1.1e-2); the term itself, value and gradient at
# the same parameters, is held at FLOW_TERM_REL in float64 (in float32 its
# pose and focal gradients, sums over ~175k pixels that cancel, came out
# 1.2e-4 apart: the order of the sums)
ALIGN_FLOW_REL = 2e-2
FLOW_TERM_REL = 1e-9
# the committed clip decoded by this machine's FFmpeg against the decode committed
# beside it (FFmpeg versions may round the colour conversion differently)
VIDEO_LSB = 2
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "torch_inputs")
FORMATS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "torch_formats")
# the 20 frames of the inputs phase's cli/infer run: two baseline JPEG fixtures
# and a file of every family of the modes in FORMATS (the Sintel-size
# progressive file among them), each with its own extension
INFER_FRAMES = ([os.path.join(FIXTURES, f) for f in ("frame_0_444_q95.jpg", "frame_4_gray_q90.jpg")]
                + [os.path.join(FORMATS, f) for f in (
                    "prog_420_q85.jpg", "prog_1024x436.jpg", "smooth_420.jpg",
                    "smooth_dc_gray.jpg", "arith_420_rst5.jpg", "arith_prog_420.jpg",
                    "h411_97x61.jpg", "cmyk.jpg", "ycck.jpg", "lossless_rgb_p6_rows1.jpg",
                    "lossless_420_p1.jpg", "palette_trns.png", "mode1.png", "gray4.png",
                    "adam7_rgb.png", "rgb16.png", "gray16.png", "la16.png")])
# nothing of these may be loaded by the end of the run (the offline tools
# import h5py only where it is needed, and the card has none); Pillow is also
# made unimportable before the port is imported
FOREIGN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "geo4d_tpu", "PIL", "h5py")
PROMPT = "Output a video that assigns each 3D location in the world a consistent color."


# about 1 ms of device time on an H100: longer than the host takes to
# enqueue any function timed here
SLEEP_CYCLES = 2_000_000
# the H100's L2 holds 50 MB; a cold timing first writes this much, then
# reads as much again
SCRUB_BYTES = 64 << 20


def scrub_l2():
    """Clear the L2 before a cold timing (not timed): a 64 MB write evicts
    the timed function's inputs and outputs, then a 64 MB read of another
    buffer evicts the write's dirty lines, so that none is written back
    inside the timed window. The buffer goes back to PyTorch's cache after
    each use, so it holds no memory during the slice."""
    half = SCRUB_BYTES // 4
    buf = torch.empty(2 * half, dtype=torch.int32, device="cuda")
    buf[:half].fill_(1)
    buf[half:].sum()


def median_ms(fn, reps: int = 20, warmup: int = 3, hide_host: bool = True,
              cold: bool = False) -> float:
    """Median of `reps` times of one call of `fn` between two CUDA events.
    With `hide_host` the device first sleeps, so the host has enqueued the
    events and the whole call before the device reaches them: the time is
    the device's own (kernels and the gaps between them). Without it the
    device waits on the host's work inside the call. With `cold` the L2 is
    cleared before each call (`scrub_l2`), outside the events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SLEEP_CYCLES)
        if cold:
            scrub_l2()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-3)).max())
    ok = bool((err <= BF16_ATOL + BF16_RTOL * want.abs()).all())
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs {max_abs:.3e}, max rel {max_rel:.3e})")
    return max_abs, max_rel


# published peaks of one H100 SXM (dense) and its memory rate, for the bounds
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def _bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(name, key):
    """Least time the card could take for one call at shape `key`: the larger
    of the bytes the function must move (each input read once, each output
    written once) over the memory rate and its operations over the peak rate
    of their type. Returns (ms, "bytes" or "operations")."""
    if name == "group_norm":
        n, s, c, silu = key
        elems = n * s * c
        return _bound(4 * elems + 8 * c, elems * (9 if silu else 5), PEAK_F32)
    if name == "flash_attention":
        b, nq, nk, h = key
        return _bound(2 * 64 * h * b * (2 * nq + 2 * nk), 4 * b * h * nq * nk * 64, PEAK_BF16)
    p, n, c, heads = key
    return _bound(2 * 4 * p * n * c, 4 * p * n * n * c, PEAK_BF16)


def pass_bound_ms(which, key, tiles, groups):
    """The bound of one GroupNorm pass alone: stats reads x (2 bytes per
    element, 3 f32 operations) and writes the N x tiles x G partial sums;
    apply reads x, the partial sums, gamma and beta and writes y (4 bytes
    per element; 2 operations, 6 with the SiLU)."""
    n, s, c, silu = key
    elems, part = n * s * c, 2 * n * tiles * groups * 4
    if which == "stats":
        return _bound(2 * elems + part, 3 * elems, PEAK_F32)
    return _bound(4 * elems + part + 8 * c, elems * (6 if silu else 2), PEAK_F32)


def make_args(name, key, g, dev):
    """Seeded bf16 inputs of one (kernel, shape key) as the wrapper takes them."""
    from geo4d_tpu_torch.nn.basics import num_groups_for

    def bf16(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(torch.bfloat16)

    if name == "group_norm":
        n, s, c, silu = key
        gamma = torch.randn(c, generator=g, device=dev)
        beta = torch.randn(c, generator=g, device=dev)
        return (bf16(n, s, c, scale=2.0, shift=0.5), gamma, beta, num_groups_for(c), 1e-5, silu)
    if name == "flash_attention":
        b, nq, nk, h = key
        return (bf16(b, nq, h, 64), bf16(b, nk, h, 64), bf16(b, nk, h, 64))
    p, n, c, heads = key
    return (bf16(p, n, c), bf16(p, n, c), bf16(p, n, c), heads)


def calls(name, args):
    """(kernel, plain version, library call or None) on the same inputs. The
    library call is one PyTorch call computing the same function, timed here
    as a yardstick and used nowhere in the port: F.group_norm (through
    PyTorch's copy to NCHW; no single call adds the SiLU), or
    scaled_dot_product_attention (run under the flash backend)."""
    import torch.nn.functional as F
    from geo4d_tpu_torch.ops import flash_attention as fa
    from geo4d_tpu_torch.ops import group_norm as gn
    from geo4d_tpu_torch.ops import temporal_attention as ta

    if name == "group_norm":
        x, gamma, beta, groups, eps, silu = args
        lib = None
        if not silu:
            g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
            lib = lambda: F.group_norm(x.permute(0, 2, 1), groups, g16, b16, eps)  # noqa: E731
        return lambda: gn.group_norm(*args), lambda: gn.group_norm_plain(*args), lib
    if name == "flash_attention":
        heads_first = [t.transpose(1, 2) for t in args]
        return (lambda: fa.flash_attention(*args), lambda: fa.flash_attention_plain(*args),
                lambda: F.scaled_dot_product_attention(*heads_first))
    q, k, v, heads = args
    p, n, c = q.shape
    heads_first = [t.view(p, n, heads, c // heads).transpose(1, 2) for t in (q, k, v)]
    return (lambda: ta.temporal_attention(*args), lambda: ta.temporal_attention_plain(*args),
            lambda: F.scaled_dot_product_attention(*heads_first))


def label(name, key):
    if name == "group_norm":
        return f"{key[:3]} silu={key[3]}"
    if name == "flash_attention":
        return "B={} Nq={} Nk={} H={} D=64".format(*key)
    return "P={} N={} C={} heads={}".format(*key)


def check_kernel(name, key, g, dev):
    """The kernel against its plain version and a second launch of itself at
    one shape. Returns (args, kernel, plain, library call, max abs error,
    max rel error)."""
    args = make_args(name, key, g, dev)
    kernel, plain, lib = calls(name, args)
    got = kernel()
    repeat = torch.equal(got, kernel())     # a second launch on the same inputs
    want = plain()
    torch.cuda.synchronize()
    max_abs, max_rel = compare(f"{name} {label(name, key)}", got, want)
    if not repeat:
        raise AssertionError(f"{name} {label(name, key)}: two launches on the same input differ")
    return args, kernel, plain, lib, max_abs, max_rel


def check_case(name, key, g, dev, time_plain):
    """`check_kernel`, then the kernel's time, its bound and its library
    call's time."""
    args, kernel, plain, lib, max_abs, max_rel = check_kernel(name, key, g, dev)
    row = {"max_abs_err": max_abs, "max_rel_err": max_rel, "bound": bound_ms(name, key)}
    if time_plain:
        ms_plain1 = median_ms(plain)
        row["ms"] = median_ms(kernel)
        row["plain_ms"] = min(ms_plain1, median_ms(plain))
    else:
        row["ms"], row["plain_ms"] = median_ms(kernel), None
    row["cold_ms"] = median_ms(kernel, cold=True)
    row["call_ms"] = median_ms(kernel, hide_host=False)
    row["library_ms"] = median_ms(lib) if lib is not None else None
    del args, kernel, plain, lib
    torch.cuda.empty_cache()
    return row


def fmt(v):
    return "null" if v is None else f"{v:.4f}"


def kernel_phase(dev):
    """Each kernel against its plain version at representative main-path
    shapes, and K3 at the edges of its gate and plan (N = 17: two 16-row
    tiles with masked keys; N = 32 with d = 24: a half k-step, and 999 jobs
    that no block count divides; P = 1); the first case of each kernel is
    the one the summary line reports."""
    cases = [("group_norm", (*shape, silu)) for shape in
             [(16, 2304, 320), (1, 36864, 320), (1, 36864, 960), (48, 147456, 128)]
             for silu in (False, True)]
    cases += [("flash_attention", key) for key in
              [(16, 2304, 2304, 5), (16, 576, 576, 10), (16, 2304, 16, 5), (16, 576, 16, 10)]]
    cases += [("temporal_attention", key) for key in
              [(2304, 16, 320, 5), (2304, 16, 512, 8), (144, 16, 1280, 20),
               (576, 17, 640, 10), (333, 32, 72, 3), (1, 16, 320, 5)]]
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, key in cases:
        row = check_case(name, key, g, dev, time_plain=True)
        b, kind = row["bound"]
        print(f"kernel {name:18s} {label(name, key):40s} max_abs={row['max_abs_err']:.3e} "
              f"max_rel={row['max_rel_err']:.3e} ms={row['ms']:.4f} cold_ms={row['cold_ms']:.4f} "
              f"call_ms={row['call_ms']:.4f} plain_ms={row['plain_ms']:.4f} bound_ms={b:.4f} "
              f"({kind}) library_ms={fmt(row['library_ms'])} repeat_equal=True", flush=True)
        r = results.setdefault(name, dict(row, shape=label(name, key)))
        r["max_abs_err"] = max(r["max_abs_err"], row["max_abs_err"])
    return results


def pass_rows(key, g, dev):
    """(path, passes) of a GroupNorm shape. At a two-pass shape `passes`
    holds each pass alone (`two_pass_launches`), the pair checked bit for
    bit against group_norm, each timed warm and cold beside its own bound;
    else None (also where an older checkout, timed with --shapes-only, has
    no per-pass launcher)."""
    from geo4d_tpu_torch.ops import group_norm as gn

    n, s, c, silu = key
    args = make_args("group_norm", key, g, dev)
    groups = args[3]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    path, tiles, _ = gn.plan(n, s, c, groups, sms)
    launcher = getattr(gn, "two_pass_launches", None)
    if path != "two_pass" or launcher is None:
        return path, None
    stats_pass, apply_pass, y = launcher(*args)
    stats_pass()
    apply_pass()
    if not torch.equal(y, gn.group_norm(*args)):
        raise AssertionError(f"group_norm {label('group_norm', key)}: the passes launched "
                             "alone differ from group_norm")
    passes = {which: {"ms": median_ms(fn), "cold_ms": median_ms(fn, cold=True),
                      "bound": pass_bound_ms(which, key, tiles, groups)}
              for which, fn in (("stats", stats_pass), ("apply", apply_pass))}
    del args, y, stats_pass, apply_pass
    torch.cuda.empty_cache()
    return path, passes


def new_totals(kernel=True):
    """Zeroed totals; `kernel` adds the call and library times a pass alone
    does not have."""
    keys = ["total_ms", "total_cold_ms", "total_bound_ms"]
    if kernel:
        keys += ["total_call_ms", "total_library_ms", "total_ms_with_library"]
    return {"launches": 0, **dict.fromkeys(keys, 0.0)}


def add(t, n, row):
    """Adds n launches of a shape's row to the totals t."""
    t["launches"] += n
    t["total_bound_ms"] += n * row["bound"][0]
    for k in ("ms", "cold_ms", "call_ms"):
        if f"total_{k}" in t:
            t[f"total_{k}"] += n * row[k]
    if "total_library_ms" in t and row["library_ms"] is not None:
        t["total_library_ms"] += n * row["library_ms"]
        t["total_ms_with_library"] += n * row["ms"]


def print_totals(what, t):
    call = f", x call_ms {t['total_call_ms']:.3f}" if "total_call_ms" in t else ""
    lib = (f"x library_ms {t['total_library_ms']:.3f} (kernel over the same shapes "
           f"{t['total_ms_with_library']:.3f})" if "total_library_ms" in t else "library none")
    print(f"shapes {what}: launches {t['launches']}, sum launches x ms {t['total_ms']:.3f} "
          f"(x cold_ms {t['total_cold_ms']:.3f}{call}), x bound_ms {t['total_bound_ms']:.3f}, "
          f"{lib}", flush=True)


def shapes_phase(dev, by_shape):
    """Every (kernel, shape) the slice's reconstruct launched: checked against
    the plain version and a second launch, timed (warm and cold L2) beside
    its bound and its library call; GroupNorm's two-pass shapes also time
    each pass alone. Returns each kernel's main-path totals (ms summed over
    the launches of one reconstruct; GroupNorm's also split by path and
    pass)."""
    g = torch.Generator(device=dev).manual_seed(1)
    totals = {}
    for name, counts in by_shape.items():
        t = totals.setdefault(name, new_totals())
        for key, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            row = check_case(name, key, g, dev, time_plain=False)
            b, kind = row["bound"]
            add(t, n, row)
            print(f"shape {name:18s} {label(name, key):40s} launches={n} ms={row['ms']:.4f} "
                  f"cold_ms={row['cold_ms']:.4f} call_ms={row['call_ms']:.4f} "
                  f"bound_ms={b:.4f} ({kind}) share={b / row['ms']:.3f} "
                  f"share_cold={b / row['cold_ms']:.3f} library_ms={fmt(row['library_ms'])} "
                  f"launches_x_ms={n * row['ms']:.3f} max_abs={row['max_abs_err']:.3e}", flush=True)
            if name != "group_norm":
                continue
            path, passes = pass_rows(key, g, dev)
            add(t.setdefault(path, new_totals()), n, row)
            for which, prow in (passes or {}).items():
                pb, pkind = prow["bound"]
                add(t.setdefault(which, new_totals(kernel=False)), n, prow)
                print(f"shape group_norm.{which:7s} {label(name, key):40s} launches={n} "
                      f"ms={prow['ms']:.4f} cold_ms={prow['cold_ms']:.4f} bound_ms={pb:.4f} "
                      f"({pkind}) share={pb / prow['ms']:.3f} "
                      f"share_cold={pb / prow['cold_ms']:.3f} library_ms=none", flush=True)
        print_totals(name, t)
        for part in ("resident", "two_pass", "stats", "apply"):
            if part in t:
                print_totals(f"{name}.{part}", t[part])
    return totals


def slice_phase(dev, results_dir):
    from geo4d_tpu_torch.cli.common import prepare_inference_params
    from geo4d_tpu_torch.core.timing import StageTimer
    from geo4d_tpu_torch.models.presets import flagship, init_random_
    from geo4d_tpu_torch.pipeline.inference import (InferenceConfig, WindowPredictor,
                                                    reconstruct, sliding_windows)

    t0 = time.perf_counter()
    model = init_random_(flagship(), dev, seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"slice: flagship built, {n_params} parameters, {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    text_ctx, uncond_text_ctx = prepare_inference_params(model, PROMPT)
    if text_ctx.shape != (1, 77, 1024) or not np.isfinite(text_ctx).all():
        raise AssertionError(f"text context: shape {text_ctx.shape} or non-finite values")
    print(f"slice: text context from the CLIP text tower {time.perf_counter() - t0:.3f} s, "
          f"sum {float(text_ctx.astype(np.float64).sum())!r} "
          f"(tower dropped; {sum(p.numel() for p in model.parameters())} parameters left)",
          flush=True)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(20, 256, 576, 3), dtype=np.uint8)
    groups = sliding_windows(20, 16, 4)
    predictor = WindowPredictor(model, InferenceConfig(), device=dev)

    t0 = time.perf_counter()
    warm = predictor.predict_video(frames, groups, text_ctx, fps=24, seed=123,
                                   return_device=True)
    torch.cuda.synchronize()
    print(f"slice: warm-up predict_video {time.perf_counter() - t0:.3f} s", flush=True)
    # checksums, to tell whether the same seed gives the same predictions
    warm_sums = {k: float(v.double().sum()) for k, v in warm.items()}
    del warm

    stats = kernel_stats()
    timer = StageTimer(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for s in stats.values():
        s.reset()
    t0 = time.perf_counter()
    scene, out, timing = reconstruct(model, frames, text_ctx, fps=24, seed=123,
                                     uncond_text_ctx=uncond_text_ctx, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_path_launches("slice", stats)
    by_shape = {k: dict(s.by_shape) for k, s in stats.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    g, t, h, w = groups.shape[0], 16, 256, 576
    want = {"pts3d": (g, t, h, w, 3), "conf": (g, t, h, w), "valid": (g, t, h, w),
            "inv_depth": (g, t, h, w), "traj": (g, t, 4, 4)}
    for k, shape in want.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k}: shape {tuple(out[k].shape)} != {shape}")
        if out[k].device.type != "cuda":
            raise AssertionError(f"{k}: left the device ({out[k].device})")
        if k != "valid" and not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k}: non-finite values")
    if scene.params["log_depth"].device.type != "cuda":
        raise AssertionError("the aligner did not run on the card")
    if not np.isfinite(scene.final_loss):
        raise AssertionError(f"aligner final loss {scene.final_loss}")

    traj, K, export_s = export_and_check(scene, frames, results_dir)

    sec = timer.seconds
    align_iters = scene.cfg.n_iter
    per_iter = (sec.get("align_phase1", 0.0) + sec.get("align_phase2", 0.0)) / align_iters
    print(f"slice: reconstruct 20 frames 256x576 (2 windows x 16, {align_iters} aligner "
          f"iterations): wall {wall:.4f} s; diffusion_s {timing['diffusion_s']:.4f} "
          f"alignment_s {timing['alignment_s']:.4f} sec_per_frame {timing['sec_per_frame']:.4f} "
          f"(device synchronised around each stage)")
    print("slice: stage seconds " + json.dumps({k: round(v, 5) for k, v in sec.items()}))
    print(f"slice: aligner {per_iter * 1e3:.3f} ms per iteration; PnP failures "
          f"{scene.pnp_failures} of 20 frames (identity pose); final loss {scene.final_loss!r}; "
          f"focal {float(scene.get_focals()[0]):.3f}")
    print(f"slice: results directory written and checked in {export_s:.2f} s "
          f"(pred_traj {traj.shape}, pred_intrinsics {K.shape}, 20 depth and conf maps; kept "
          "for the offline phase's viewer)")
    print(f"slice: peak memory allocated {peak} bytes")
    print(f"slice: valid fraction {float(out['valid'].float().mean()):.4f}", flush=True)
    sums = {k: float(v.double().sum()) for k, v in out.items()}
    print(f"slice: prediction sums {json.dumps(sums)}; the warm-up's (same seed) "
          f"{'equal' if sums == warm_sums else json.dumps(warm_sums)}", flush=True)
    return launches, by_shape, model, text_ctx, uncond_text_ctx, scene


def export_and_check(scene, frames, out_dir=None):
    """Write the results directory of a 20-frame scene to `out_dir` (kept)
    or to a temporary directory and check its files (shapes, finite values);
    returns the trajectory and intrinsics arrays and the seconds taken."""
    from geo4d_tpu_torch.pipeline.export import save_results_dir

    n, h, w = frames.shape[:3]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = out_dir or os.path.join(tmp, "smoke")
        save_results_dir(out_dir, scene, rgb_frames=frames)
        traj = np.loadtxt(os.path.join(out_dir, "pred_traj.txt"))
        K = np.loadtxt(os.path.join(out_dir, "pred_intrinsics.txt"))
        depths = np.stack([np.load(os.path.join(out_dir, f"frame_{i:04d}.npy")) for i in range(n)])
        confs = [os.path.exists(os.path.join(out_dir, f"conf_{i:04d}.npy")) for i in range(n)]
    if traj.shape != (n, 8) or K.shape != (n, 9) or depths.shape != (n, h, w) or not all(confs):
        raise AssertionError(f"results files: traj {traj.shape}, intrinsics {K.shape}, "
                             f"depths {depths.shape}, conf files {sum(confs)}")
    if not (np.isfinite(traj).all() and np.isfinite(K).all() and np.isfinite(depths).all()):
        raise AssertionError("results files hold non-finite values")
    return traj, K, time.perf_counter() - t0


def kernel_stats():
    from geo4d_tpu_torch.ops import flash_attention as fa
    from geo4d_tpu_torch.ops import group_norm as gn
    from geo4d_tpu_torch.ops import temporal_attention as ta

    return {"group_norm": gn.stats, "flash_attention": fa.stats, "temporal_attention": ta.stats}


def check_path_launches(what, stats, need=KERNELS):
    """Fails unless every kernel in `need` launched since the counts were
    reset and no plain version ran on a CUDA tensor; returns the launches."""
    launches = {k: s.launches for k, s in stats.items()}
    plain_on_cuda = {k: s.plain_on_cuda for k, s in stats.items()}
    print(f"{what}: launches {json.dumps(launches)} plain_on_cuda {json.dumps(plain_on_cuda)}",
          flush=True)
    for k in need:
        if launches[k] == 0:
            raise AssertionError(f"{what}: kernel {k} was not launched")
    if any(plain_on_cuda.values()):
        raise AssertionError(f"{what}: a plain version ran on a CUDA tensor: {plain_on_cuda}")
    return launches


TAG = 202021.25     # the Sintel .dpt / .cam file tag
SINTEL_HW = (436, 1024)
# (W, H) of the evaluation datasets whose shapes the slice does not reach
RESOLUTIONS = {"bonn": (512, 384), "kitti": (640, 192)}
# the resolutions phase's batched KITTI case: 30 frames make 5 windows (the
# last a tail window) in one 80-frame UNet call at window_batch 5, and end
# the VAE encoder's and CLIP's 16-frame chunks with a 14-frame chunk, as the
# benchmark's recon.kitti110 (110 frames) does
KITTI_BATCH, KITTI_BATCH_FRAMES = 5, 30
# decode_modality runs at the slice's resolution
DECODE_HW = (256, 576)


# the moving patch of the synthetic Sintel flow: rows, columns, added flow (px)
PATCH = (slice(150, 250), slice(300, 500), 20.0)


def write_sintel(root, n=20, seq="alley_2"):
    """A Sintel sequence in the dataset's layout: n PNG frames (a textured
    image panning sideways), .dpt depth maps (a slanted plane with 5% noise),
    .cam files (fixed intrinsics; the camera moves along x and turns
    slowly) and n - 1 .flo optical flows (the rigid flow of each frame's
    depth and cameras, computed in float64, with PATCH moved by 20 px more
    in x and y), all at the dataset's 1024x436."""
    from geo4d_tpu_torch.data.images import write_png
    from geo4d_tpu_torch.geometry.warp import depth_based_flow

    h, w = SINTEL_HW
    dirs = [os.path.join(root, "training", d, seq)
            for d in ("final", "depth", "camdata_left", "flow")]
    for d in dirs:
        os.makedirs(d)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:h, :w]
    texture = rng.integers(0, 256, (h // 4, w // 4 + n * 4, 3), dtype=np.uint8)
    texture = np.repeat(np.repeat(texture, 4, 0), 4, 1)
    K = np.array([[600.0, 0, w / 2], [0, 600.0, h / 2], [0, 0, 1]])
    depths, poses = [], []
    for i in range(n):
        write_png(os.path.join(dirs[0], f"frame_{i + 1:04d}.png"),
                  np.ascontiguousarray(texture[:, 8 * i:8 * i + w]))
        depth = (3 + 4 * xx / w + 2 * yy / h) * rng.uniform(0.95, 1.05, (h, w))
        with open(os.path.join(dirs[1], f"frame_{i + 1:04d}.dpt"), "wb") as f:
            f.write(struct.pack("<fii", TAG, w, h))
            depth.astype(np.float32).tofile(f)
        depths.append(depth.astype(np.float32))
        a = 0.01 * i
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = [0.1 * i, 0.0, 0.02 * i]
        with open(os.path.join(dirs[2], f"frame_{i + 1:04d}.cam"), "wb") as f:
            f.write(struct.pack("<f", TAG))
            K.astype(np.float64).tofile(f)
            np.linalg.inv(c2w)[:3].astype(np.float64).tofile(f)
        poses.append(c2w)
    rows, cols, shift = PATCH
    for i in range(n - 1):
        flow, _ = depth_based_flow(torch.from_numpy(depths[i]).double(),
                                   torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                                   torch.from_numpy(K))
        flow = flow.numpy()
        flow[rows, cols] += shift
        with open(os.path.join(dirs[3], f"frame_{i + 1:04d}.flo"), "wb") as f:
            f.write(struct.pack("<fii", TAG, w, h))
            flow.astype(np.float32).tofile(f)


def dynamic_masks_check(dev, root, scene, n):
    """Sintel's dynamic labels of the synthetic sequence (host,
    `sintel_get_dynamics`) and the dynamic masks of its GT depth, cameras and
    flow on the card (`compute_dynamic_masks`): both must find the moving
    patch. The card's masks, cut to the slice's 256x576 (nearest) and the
    last frame given the last pair's mask, go through
    `save_results_dir(..., dynamic_masks=)` with the slice's scene."""
    from geo4d_tpu_torch.data.datasets import read_dpt, read_sintel_cam
    from geo4d_tpu_torch.data.images import read_png
    from geo4d_tpu_torch.data.preprocess import compute_dynamic_masks, read_flo, \
        sintel_get_dynamics
    from geo4d_tpu_torch.pipeline.export import save_results_dir

    base, seq = os.path.join(root, "training"), "alley_2"
    t0 = time.perf_counter()
    labels = sintel_get_dynamics(base, seq)
    labels_s = time.perf_counter() - t0
    rows, cols, _ = PATCH
    inside = np.zeros(SINTEL_HW, bool)
    inside[rows, cols] = True

    def fractions(mask):
        return float(mask[..., inside].mean()), float(mask[..., ~inside].mean())

    lab = np.stack([read_png(p) > 0 for p in labels])
    names = sorted(f for f in os.listdir(os.path.join(base, "depth", seq)))
    depths = np.stack([read_dpt(os.path.join(base, "depth", seq, f)) for f in names])
    cams = [read_sintel_cam(os.path.join(base, "camdata_left", seq, f.replace(".dpt", ".cam")))
            for f in names]
    poses = np.stack([np.linalg.inv(np.vstack([E, [0, 0, 0, 1]])) for _, E in cams])
    flows = np.stack([read_flo(os.path.join(base, "flow", seq, f.replace(".dpt", ".flo")))
                      for f in names[:-1]])
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in (flows, depths, poses, cams[0][0])]
    compute_dynamic_masks(*args)                                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = compute_dynamic_masks(*args)
    torch.cuda.synchronize()
    masks_ms = (time.perf_counter() - t0) * 1e3
    masks = masks.cpu().numpy()
    f_lab, f_mask = fractions(lab), fractions(masks)
    print(f"evaluate: sintel_get_dynamics {len(labels)} labels at 1024x436 in {labels_s:.3f} s "
          f"(host, float64): dynamic share inside the moving patch {f_lab[0]:.4f}, outside "
          f"{f_lab[1]:.6f}; compute_dynamic_masks on the card {masks_ms:.3f} ms for "
          f"{len(masks)} pairs: inside {f_mask[0]:.4f}, outside {f_mask[1]:.6f}", flush=True)
    if len(labels) != n - 1 or not (f_lab[0] > 0.99 and f_lab[1] < 0.01
                                    and f_mask[0] > 0.99 and f_mask[1] < 0.01):
        raise AssertionError("evaluate: the dynamic labels or masks miss the moving patch")
    h, w = scene.H, scene.W
    yi = np.arange(h) * SINTEL_HW[0] // h
    xi = np.arange(w) * SINTEL_HW[1] // w
    small = masks[:, yi][:, :, xi]
    small = np.concatenate([small, small[-1:]])
    with tempfile.TemporaryDirectory() as tmp:
        save_results_dir(tmp, scene, save_glb=False, dynamic_masks=small)
        for i in range(n):
            png = read_png(os.path.join(tmp, f"enlarged_dynamic_mask_{i}.png"))
            if not np.array_equal(png, small[i].astype(np.uint8) * 255):
                raise AssertionError(f"evaluate: enlarged_dynamic_mask_{i}.png differs from "
                                     "its mask")
    print(f"evaluate: {n} enlarged_dynamic_mask_<i>.png files written with the slice's scene "
          f"at {h}x{w} and read back equal", flush=True)


def evaluate_phase(dev, model, text_ctx, uncond_text_ctx, scene):
    """The evaluation entry point on a synthetic Sintel sequence with the
    flagship model of the slice phase, at Sintel's 576x256 and the CLI's
    defaults; then the sequence's dynamic masks (`dynamic_masks_check`)."""
    from geo4d_tpu_torch.cli import evaluate as ev
    from geo4d_tpu_torch.data.datasets import DATASET_RESOLUTION, DATASETS, read_gt_depths
    from geo4d_tpu_torch.data.images import read_png
    from geo4d_tpu_torch.data.video import load_image_dir
    from geo4d_tpu_torch.evals.depth import lad2_align

    n = 20
    with tempfile.TemporaryDirectory() as tmp:
        root, out = os.path.join(tmp, "sintel"), os.path.join(tmp, "eval")
        t0 = time.perf_counter()
        write_sintel(root, n)
        print(f"evaluate: wrote a 20-frame 1024x436 Sintel sequence in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        t0 = time.perf_counter()
        frames, _ = load_image_dir(os.path.join(root, "training", "final", "alley_2"),
                                   DATASET_RESOLUTION["sintel"])
        print(f"evaluate: PNG decode + Lanczos 1024x436 -> 576x256 of {n} frames "
              f"{time.perf_counter() - t0:.3f} s (host)", flush=True)
        args = ev.get_parser().parse_args(["--dataset", "sintel", "--data_root", root,
                                           "--savedir", out, "--seq_list", "alley_2"])
        stats = kernel_stats()
        for st in stats.values():
            st.reset()
        t0 = time.perf_counter()
        res = ev.evaluate(args, model, text_ctx, uncond_text_ctx, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_path_launches("evaluate", stats)
        seq_dir = os.path.join(out, "alley_2")
        files = ["_error_log_depth.txt", "_error_log.txt", "_error_log_all.txt",
                 "time_cost.txt", "alley_2/pred_traj.txt", "alley_2/pred_focal.txt",
                 "alley_2/pred_intrinsics.txt"]
        files += [f"alley_2/{f}_{i:04d}.{e}" for i in range(n)
                  for f, e in (("frame", "npy"), ("conf", "npy"), ("init_conf", "npy"),
                               ("frame", "png"))]
        files += [f"alley_2/error_{i}.png" for i in range(n)]
        missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
        if missing:
            raise AssertionError(f"evaluate: missing output files {missing[:5]}")
        err = read_png(os.path.join(seq_dir, "error_0.png"))
        traj = np.loadtxt(os.path.join(seq_dir, "pred_traj.txt"))
        if err.shape != SINTEL_HW or traj.shape != (n, 8) or not np.isfinite(traj).all():
            raise AssertionError(f"evaluate: error map {err.shape}, trajectory {traj.shape}")
        with open(os.path.join(out, "_error_log_all.txt")) as f:
            summary = f.read()
        # lad2 alone at the evaluation's settings, on this sequence's depths
        # at the ground truth's resolution (all valid pixels as the mask)
        gt = read_gt_depths(DATASETS["sintel"], root, "alley_2")
        pred = ev.resize_to_gt(np.stack([np.load(os.path.join(seq_dir, f"frame_{i:04d}.npy"))
                                         for i in range(n)]), gt.shape[1:], dev)
        p, g = (torch.from_numpy(a.reshape(-1)).to(dev) for a in (pred, gt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_fit, t_fit = lad2_align(p, g, (g > 0) & (g < 70), lr=1e-2, max_iters=5000)
        torch.cuda.synchronize()
        lad2_s = time.perf_counter() - t0
        del p, g
        dynamic_masks_check(dev, root, scene, n)
    depth = res["depth"][0]
    if not (np.isfinite(depth["Abs Rel"]) and np.isfinite(depth["δ < 1.25"])):
        raise AssertionError(f"evaluate: AbsRel {depth['Abs Rel']}, delta {depth['δ < 1.25']}")
    if res["pose_failed"] or len(res["pose"]) != 1:
        raise AssertionError(f"evaluate: the pose evaluation failed for {res['pose_failed']}")
    ate, rpe_t, rpe_r = res["pose"][0]
    st = res["stages"]["alley_2"]
    print(f"evaluate: wall {wall:.4f} s; alley_2 at 576x256: load_s {st['load_s']:.4f} "
          f"(frames: PNG decode + Lanczos; depths, cameras) diffusion_s {st['diffusion_s']:.4f} "
          f"alignment_s {st['alignment_s']:.4f} resize_s {st['resize_s']:.4f} (bicubic to "
          f"436x1024, depth and mask) depth_eval_s {st['depth_eval_s']:.4f} (lad2, 5000 Adam "
          f"steps on {depth['valid_pixels']} valid pixels, then the metrics)", flush=True)
    print(f"evaluate: lad2 alone (5000 Adam steps on the card, {gt.size} pixels) "
          f"{lad2_s:.4f} s, s {float(s_fit)!r} t {float(t_fit)!r}", flush=True)
    print(f"evaluate: lad2 s {st['s']!r} t {st['t']!r} L1 objective {st['l1']!r}; AbsRel "
          f"{depth['Abs Rel']!r} delta<1.25 {depth['δ < 1.25']!r}; ATE {ate!r} RPE_t {rpe_t!r} "
          f"RPE_r {rpe_r!r}; PnP failures {st['pnp_failures']} of {n}", flush=True)
    print("evaluate: _error_log_all.txt " + summary.strip().replace("\n", "; "), flush=True)


def resolutions_phase(dev, model, text_ctx):
    """One window of predict_windows at Bonn's and KITTI's resolutions, and
    predict_video over KITTI_BATCH_FRAMES frames at KITTI's resolution
    (KITTI_BATCH windows in one UNet call, as the benchmark's recon.kitti110
    runs them), every (kernel, shape) each launched checked against its plain
    version; then every decode_modality layout on random latents at
    576x256. Returns the (kernel, shape) pairs checked."""
    from geo4d_tpu_torch.pipeline.inference import (InferenceConfig, WindowPredictor,
                                                    sliding_windows)

    checked = set()
    stats = kernel_stats()
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    cases = [(name, hw, 1) for name, hw in RESOLUTIONS.items()]
    cases.append(("kitti_batch", RESOLUTIONS["kitti"], KITTI_BATCH))
    for name, (w, h), batch in cases:
        predictor = WindowPredictor(model, InferenceConfig(ddim_steps=1, window_batch=batch),
                                    device=dev)
        for st in stats.values():
            st.reset()
        t0 = time.perf_counter()
        if batch == 1:
            what = "predict_windows (1 window, 1 DDIM step)"
            out = predictor.predict_windows(
                rng.integers(0, 256, size=(1, 16, h, w, 3), dtype=np.uint8), text_ctx, 24, seed=0)
        else:
            what = f"predict_video ({batch} windows in one UNet call, 1 DDIM step)"
            n = KITTI_BATCH_FRAMES
            out = predictor.predict_video(
                rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8),
                sliding_windows(n, 16, 4), text_ctx, 10, seed=0)
        wall = time.perf_counter() - t0
        check_path_launches(f"resolutions {name} {w}x{h}", stats)
        for k in ("pts3d", "conf", "inv_depth"):
            if out[k].shape[:4] != (batch, 16, h, w) or not np.isfinite(out[k]).all():
                raise AssertionError(f"resolutions {name}: {k} {out[k].shape} or non-finite")
        by_shape = {k: dict(st.by_shape) for k, st in stats.items()}
        print(f"resolutions {name} {w}x{h}: {what} {wall:.3f} s", flush=True)
        with torch.no_grad():
            for kernel, counts in by_shape.items():
                for key, n in sorted(counts.items(), key=lambda kv: -kv[1]):
                    max_abs, max_rel = check_kernel(kernel, key, g, dev)[4:]
                    checked.add((kernel, key))
                    print(f"resolutions {name} {kernel:18s} {label(kernel, key):40s} "
                          f"launches={n} max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
                          f"repeat_equal=True", flush=True)
                    torch.cuda.empty_cache()
    z_gen = torch.Generator(device=dev).manual_seed(3)
    for modality, c in (("pc_ray_cross_depth", 16), ("pc_ray", 8), ("pc", 4), ("multipc", 12),
                        ("img_vidpc", 8), ("rgb", 4)):
        z = torch.randn((1, 16, DECODE_HW[0] // 8, DECODE_HW[1] // 8, c), generator=z_gen,
                        device=dev)
        stats["group_norm"].reset()
        with torch.no_grad():
            dec = model.decode_modality(z, modality)
        torch.cuda.synchronize()
        for k, v in dec.items():
            if v.shape[:4] != (1, 16, *DECODE_HW) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"decode_modality {modality}: {k} {tuple(v.shape)} "
                                     "or non-finite")
        if stats["group_norm"].launches == 0:
            raise AssertionError(f"decode_modality {modality}: GroupNorm kernel not launched")
        print(f"resolutions decode_modality {modality}: "
              + ", ".join(f"{k} {tuple(v.shape)}" for k, v in dec.items())
              + f"; group_norm launches {stats['group_norm'].launches}", flush=True)
        del dec
    return checked


def longseq_phase(dev, model, checked=frozenset()):
    """The long-sequence run (geo4d_tpu_torch.tools.longseq.run_longseq) at
    full size: 110 frames at KITTI's 640x192 in 25 windows, five a UNet
    call, 500 aligner iterations, diffusion and aligner each warm, timed,
    then once more under a StageTimer. The timed run's predictions must be finite and of the windows'
    shape, K1-K3 must launch and no plain version run on a CUDA tensor;
    then every (kernel, shape) the run launched that is not in `checked`
    is checked against its plain version and a second launch (not timed).
    Prints the record on one line, prefixed `longseq`; when `checked` is
    not empty, earlier phases ran the aligner and the record's note says
    that its align_cold_* figures are not cold."""
    from geo4d_tpu_torch.nn.basics import num_groups_for
    from geo4d_tpu_torch.ops import group_norm as gn
    from geo4d_tpu_torch.pipeline.inference import sliding_windows
    from geo4d_tpu_torch.tools.longseq import KITTI_HW, run_longseq

    frames, (h, w) = 110, KITTI_HW
    n_win = sliding_windows(frames, 16, 4).shape[0]             # 25

    def check(preds):
        for k, tail in (("pts3d", (3,)), ("conf", ()), ("inv_depth", ())):
            v = preds[k]
            if tuple(v.shape) != (n_win, 16, h, w, *tail) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"longseq: {k} {tuple(v.shape)} or non-finite values")
        print(f"longseq: predictions pts3d {tuple(preds['pts3d'].shape)}, conf, inv_depth "
              f"finite; valid fraction {float(preds['valid'].float().mean()):.4f}", flush=True)

    stats = kernel_stats()
    for st in stats.values():
        st.reset()
    text_ctx = np.zeros((1, 77, model.unet.context_dim), np.float32)
    t0 = time.perf_counter()
    record = run_longseq(model, text_ctx, frames, (h, w), device=dev, check=check)
    wall = time.perf_counter() - t0
    check_path_launches("longseq", stats)
    if checked:
        record["note"] += ("; earlier phases of this process ran the aligner, so align_cold_* "
                           "is the first aligner run of this phase, not a cold one")
    by_shape = {k: dict(st.by_shape) for k, st in stats.items()}
    print(f"longseq: run_longseq {wall:.2f} s of wall (three diffusion runs, three aligner runs)",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_new = 0
    with torch.no_grad():
        for kernel, counts in by_shape.items():
            for key, n in sorted(counts.items(), key=lambda kv: -kv[1]):
                if (kernel, key) in checked:
                    continue
                max_abs, max_rel = check_kernel(kernel, key, g, dev)[4:]
                n_new += 1
                path = ""
                if kernel == "group_norm":
                    path = " path=" + gn.plan(*key[:3], num_groups_for(key[2]), sms)[0]
                print(f"longseq {kernel:18s} {label(kernel, key):40s} launches={n}{path} "
                      f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} repeat_equal=True",
                      flush=True)
                torch.cuda.empty_cache()
    print(f"longseq: {n_new} new (kernel, shape) pairs checked, "
          f"{sum(len(c) for c in by_shape.values()) - n_new} checked by earlier phases",
          flush=True)
    print("longseq " + json.dumps(record), flush=True)
    return record


ATTENTION_OPTIONS = {"plain": {}, "relative_position": dict(use_relative_position=True),
                     "causal": dict(use_causal_attention=True)}


def attention_options_phase(dev, model, text_ctx):
    """One 1-step 16-frame window at 576x256 through the slice's model with
    the plain UNet and with each temporal-attention option (a UNet of that
    option carrying the plain one's weights; the relative-position tables
    seeded); then the UNet step of each, timed."""
    from geo4d_tpu_torch.models.unet3d import UNet3D
    from geo4d_tpu_torch.pipeline.inference import InferenceConfig, WindowPredictor

    stats = kernel_stats()
    plain_unet = model.unet
    state = plain_unet.state_dict()
    frames = np.random.default_rng(4).integers(0, 256, size=(1, 16, 256, 576, 3), dtype=np.uint8)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1, 16, 32, 72, 20), generator=g, device=dev)
    ctx = torch.randn((1, 77 + 16 * 16, 1024), generator=g, device=dev).to(torch.bfloat16)
    ts, fs = torch.tensor([500], device=dev), torch.tensor([24], device=dev)
    outs, step_ms = {}, {}
    for name, opts in ATTENTION_OPTIONS.items():
        if opts:
            with torch.device("meta"):
                unet = UNet3D(dtype=torch.bfloat16, **opts)
            unet.to_empty(device=dev)
            missing, unexpected = unet.load_state_dict(state, strict=False)
            if unexpected or any(not k.endswith("embeddings_table") for k in missing) \
                    or bool(missing) != ("use_relative_position" in opts):
                raise AssertionError(f"attention_options {name}: the plain UNet's weights do not "
                                     f"fit ({len(missing)} missing, {len(unexpected)} unexpected)")
            for k in missing:
                unet.get_parameter(k).normal_(0.0, 0.02, generator=g)
            model.unet = unet.eval()
        for st in stats.values():
            st.reset()
        t0 = time.perf_counter()
        outs[name] = WindowPredictor(model, InferenceConfig(ddim_steps=1), device=dev
                                     ).predict_windows(frames, text_ctx, 24, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_path_launches(f"attention_options {name}", stats,
                                       need=KERNELS if not opts else
                                       ("group_norm", "flash_attention"))
        if opts and launches["temporal_attention"]:
            raise AssertionError(f"attention_options {name}: K3 launched "
                                 f"{launches['temporal_attention']} times; its gate excludes "
                                 "the option")
        for k in ("pts3d", "conf", "inv_depth"):
            if not np.isfinite(outs[name][k]).all():
                raise AssertionError(f"attention_options {name}: non-finite {k}")
        step_ms[name] = median_ms(lambda: model.unet(x, ts, ctx, fs), reps=5, warmup=2)
        print(f"attention_options {name}: 1-step window {wall:.3f} s (first call); UNet step "
              f"(1 x 16 frames at 32x72 latents) {step_ms[name]:.3f} ms; K3 launches "
              f"{launches['temporal_attention']}", flush=True)
        model.unet = plain_unet
    for name in ("relative_position", "causal"):
        if all(np.array_equal(outs[name][k], outs["plain"][k]) for k in ("pts3d", "inv_depth")):
            raise AssertionError(f"attention_options {name}: the outputs equal the plain ones")
        rel = float(np.linalg.norm(outs[name]["pts3d"] - outs["plain"]["pts3d"])
                    / np.linalg.norm(outs["plain"]["pts3d"]))
        print(f"attention_options {name}: pts3d relative L2 from the plain UNet's {rel:.3e}; "
              f"step {step_ms[name] / step_ms['plain']:.3f}x the plain one", flush=True)


def ffmpeg_probe():
    """Prints what pkg-config finds of FFmpeg and g++'s version; returns
    whether FFmpeg's development libraries are there."""
    from geo4d_tpu_torch.data.video import FFMPEG_LIBS

    try:
        p = subprocess.run(["pkg-config", "--modversion", *FFMPEG_LIBS], capture_output=True,
                           text=True)
        found = p.returncode == 0
        ffmpeg = ("found, versions " + " ".join(p.stdout.split()) if found
                  else f"not found (rc {p.returncode}: {p.stderr.strip()[:300]})")
    except FileNotFoundError:
        found, ffmpeg = False, "not found (pkg-config is not installed)"
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    print(f"inputs: probe: pkg-config {' '.join(FFMPEG_LIBS)}: {ffmpeg}; g++: "
          f"{gxx.stdout.splitlines()[0] if gxx.returncode == 0 else 'absent'}", flush=True)
    return found


def check_results_dir(out_dir, n, h, w, what):
    traj = np.loadtxt(os.path.join(out_dir, "pred_traj.txt"))
    K = np.loadtxt(os.path.join(out_dir, "pred_intrinsics.txt"))
    depths = np.stack([np.load(os.path.join(out_dir, f"frame_{i:04d}.npy")) for i in range(n)])
    missing = [f for i in range(n) for f in (f"conf_{i:04d}.npy", f"frame_{i:04d}.png")
               if not os.path.exists(os.path.join(out_dir, f))]
    if traj.shape != (n, 8) or K.shape != (n, 9) or depths.shape != (n, h, w) or missing:
        raise AssertionError(f"{what}: results files: traj {traj.shape}, intrinsics {K.shape}, "
                             f"depths {depths.shape}, missing {missing[:3]}")
    if not (np.isfinite(traj).all() and np.isfinite(K).all() and np.isfinite(depths).all()):
        raise AssertionError(f"{what}: results files hold non-finite values")


def infer_cli(dev, video_path, savedir, what):
    """`cli/infer.main` at 576x256 on the flagship with random weights and 50
    aligner iterations; checks the results directory of its 20 frames and
    that K1-K3 launched. Returns the wall seconds."""
    from geo4d_tpu_torch.cli import infer

    stats = kernel_stats()
    for st in stats.values():
        st.reset()
    t0 = time.perf_counter()
    infer.main(["--video_path", video_path, "--savedir", savedir, "--height", "256",
                "--width", "576", "--n_iter", "50"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_path_launches(what, stats)
    seq = os.path.splitext(os.path.basename(video_path.rstrip("/")))[0]
    check_results_dir(os.path.join(savedir, seq, seq), 20, 256, 576, what)
    print(f"{what}: cli/infer.main wall {wall:.3f} s (model build with random weights, text "
          "context, frame load, reconstruct, results directory)", flush=True)
    return wall


def _host_ms(fn, budget_s=0.05):
    """Host milliseconds per call of fn(): the median of three runs of
    enough calls to fill about `budget_s` seconds each."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    reps = max(3, min(200, int(budget_s / max(first, 1e-6))))
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(runs)


def formats_check():
    """Every file of tests/fixtures/torch_formats in its three views against
    the committed pixels (arrays, or SHA-256 and shape), the 12-bit file
    refused, and each decode timed beside a baseline file of the same
    pixels and size: baseline JPEG (data/jpeg.py's encoder, quality 85,
    grayscale for a grayscale file, else RGB 4:2:0) or
    a non-interlaced 8-bit RGB PNG with the fixtures' filters (make_fixtures
    .png_bytes). Returns {file: (ms, baseline ms)}."""
    import hashlib

    from geo4d_tpu_torch.data import images, jpeg

    import importlib.util

    pixels = dict(np.load(os.path.join(FORMATS, "pixels.npz")))
    spec = importlib.util.spec_from_file_location("make_fixtures",
                                                  os.path.join(FORMATS, "make_fixtures.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)

    def same(name, key, got):
        if name + key in pixels and pixels[name + key].dtype.kind != "U":
            want = pixels[name + key]
            return got.shape == want.shape and got.dtype == want.dtype and np.array_equal(
                got, want)
        digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
        return (tuple(pixels[f"{name}{key}:shape"]) == got.shape
                and str(pixels[name + key]) == digest)

    times = {}
    for name in sorted(os.listdir(FORMATS)):
        path = os.path.join(FORMATS, name)
        if name.startswith("refused_"):
            try:
                jpeg.read_jpeg(path)
            except ValueError as e:
                print(f"inputs: {name} is refused: {e}", flush=True)
                continue
            raise AssertionError(f"inputs: {name} decoded, but Pillow refuses it")
        if not name.endswith((".jpg", ".png")):
            continue
        rgb_key = ":rgb" if name + ":rgb" in pixels else ""
        views = [("raw", images.read_pillow(path), ""),
                 ("pillow rgb", images.read_rgb(path, "pillow"), rgb_key)]
        if name + ":cv2_refuses" in pixels:
            try:
                images.read_rgb(path, "opencv")
                raise AssertionError(f"inputs: {name}: OpenCV refuses it, the port decoded it")
            except ValueError:
                pass
        else:
            views.append(("opencv rgb", images.read_rgb(path, "opencv"),
                          ":cv2" if name + ":cv2" in pixels else rgb_key))
        for what, got, key in views:
            if (key or name in pixels) and not same(name, key, got):
                raise AssertionError(f"inputs: {name} ({what}) decodes unlike the committed "
                                     "pixels")
        with open(path, "rb") as f:
            data = f.read()
        rgb = views[1][1]
        if name.endswith(".jpg"):
            raw = views[0][1]
            base = jpeg.encode_jpeg(raw if raw.ndim == 2 else rgb, 85)   # gray stays gray
            ms = _host_ms(lambda: jpeg.decode_jpeg(data, name))
            base_ms = _host_ms(lambda: jpeg.decode_jpeg(base))
            kind = f"SOF{jpeg.frame_marker(data) - 0xC0}"
        else:
            base = writer.png_bytes(rgb, 2, 8)   # 8-bit RGB, the fixtures' cycle of filters
            ms = _host_ms(lambda: images.decode_png(data, name))
            base_ms = _host_ms(lambda: images.decode_png(base))
            w, h, depth, ctype, interlace = images.png_header(data)
            kind = f"PNG type {ctype} depth {depth}{' Adam7' if interlace else ''}"
        times[name] = (ms, base_ms)
        print(f"inputs: {name} ({kind}, {rgb.shape[1]}x{rgb.shape[0]}) equals the committed "
              f"pixels in {len(views)} views; decode {ms:.4f} ms per frame (host), baseline "
              f"of the same pixels and size {base_ms:.4f} ms ({ms / base_ms:.2f}x)",
              flush=True)
    return times


def inputs_phase(dev):
    """Frame and video input on the card: the FFmpeg probe, the JPEG fixtures
    against Pillow's committed pixels, every frame-file format against the
    committed pixels (formats_check), cli/infer on a directory that mixes
    them, and on the committed clip where FFmpeg is present."""
    from geo4d_tpu_torch.data import jpeg
    from geo4d_tpu_torch.data.video import load_video

    have_ffmpeg = ffmpeg_probe()
    t0 = time.perf_counter()
    jpeg.build()
    print(f"inputs: JPEG decoder built with g++ in {time.perf_counter() - t0:.2f} s", flush=True)
    pixels = np.load(os.path.join(FIXTURES, "jpeg_pixels.npz"))
    for name in pixels.files:
        path = os.path.join(FIXTURES, name)
        got = jpeg.read_jpeg(path)
        if not np.array_equal(got, pixels[name]):
            raise AssertionError(f"inputs: {name} decodes unlike Pillow's committed pixels")
        with open(path, "rb") as f:
            data = f.read()
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            jpeg.decode_jpeg(data)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"inputs: {name} ({got.shape}) equals Pillow's pixels; decode {ms:.4f} ms per "
              "frame (host)", flush=True)
    formats_check()
    with tempfile.TemporaryDirectory() as tmp:
        clip_dir = os.path.join(tmp, "mixed_clip")
        os.makedirs(clip_dir)
        for i, path in enumerate(INFER_FRAMES):
            shutil.copy(path, os.path.join(clip_dir, f"{i:05d}{os.path.splitext(path)[1]}"))
        infer_cli(dev, clip_dir, os.path.join(tmp, "out"), "inputs mixed formats")
        clip = os.path.join(FIXTURES, "clip.mp4")
        if not have_ffmpeg:
            try:
                load_video(clip, 1, (128, 288))
            except RuntimeError as e:
                if "PNG or JPEG" not in str(e):
                    raise AssertionError(f"inputs: the error of a missing FFmpeg does not name "
                                         f"frame directories: {e}") from e
                print(f"inputs: the card has no FFmpeg; load_video raises: {e}", flush=True)
                return
            raise AssertionError("inputs: pkg-config finds no FFmpeg, yet load_video decoded")
        ref = np.load(os.path.join(FIXTURES, "clip_decode.npz"))
        t0 = time.perf_counter()
        frames, fps = load_video(clip, 1, (128, 288))
        decode_s = time.perf_counter() - t0
        diff = np.abs(frames[ref["index"]].astype(int) - ref["frames"].astype(int))
        print(f"inputs: clip.mp4 decoded ({frames.shape}, {fps} fps) in {decode_s:.3f} s "
              f"(native decoder built at first use): frames {ref['index'].tolist()} against "
              f"the committed decode: max {int(diff.max())} LSB, {float((diff > 0).mean()):.4%} "
              f"of values differ (limit {VIDEO_LSB} LSB)", flush=True)
        if frames.shape != (20, 128, 288, 3) or diff.max() > VIDEO_LSB:
            raise AssertionError("inputs: the clip decodes unlike the committed decode")
        shutil.copy(clip, os.path.join(tmp, "clip.mp4"))
        infer_cli(dev, os.path.join(tmp, "clip.mp4"), os.path.join(tmp, "out"), "inputs video")


def reference_phase(dev, name="plain", **unet_options):
    """Tiny preset, same weights and noise: bf16 on the card (kernels) vs
    float32 on the CPU (plain versions); `unet_options` go to its UNet."""
    from geo4d_tpu_torch.models.presets import tiny
    from geo4d_tpu_torch.pipeline.inference import InferenceConfig, WindowPredictor

    cfg = InferenceConfig(window=4, stride=2, ddim_steps=2, sample_posterior=False)
    ref = tiny(temporal_length=4, dtype=torch.float32, device="cpu", **unet_options)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    card = tiny(temporal_length=4, dtype=torch.bfloat16, device="meta", **unet_options)
    card.to_empty(device=dev)
    card.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, size=(2, 4, 64, 128, 3), dtype=np.uint8)
    text_ctx = rng.normal(size=(1, 77, 64)).astype(np.float32)
    x_T = rng.normal(size=(2, 4, 8, 16, 16)).astype(np.float32)
    want = WindowPredictor(ref, cfg).predict_windows(frames, text_ctx, 24, x_T=x_T)
    got = WindowPredictor(card, cfg, device=dev).predict_windows(frames, text_ctx, 24, x_T=x_T)
    again = WindowPredictor(card, cfg, device=dev).predict_windows(frames, text_ctx, 24, x_T=x_T)
    print(f"reference {name}: a second card run equals the first: "
          f"{all(np.array_equal(got[k], again[k]) for k in got)}")
    for k in ("pts3d", "conf", "inv_depth"):
        rel = float(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-12))
        print(f"reference {name}: {k} relative L2 error {rel:.3e} (limit {REF_REL_L2})")
        if not rel <= REF_REL_L2:
            raise AssertionError(f"reference {name}: {k} relative L2 error {rel:.3e} > "
                                 f"{REF_REL_L2}")
    agree = float((got["valid"] == want["valid"]).mean())
    print(f"reference {name}: valid masks agree on {agree:.4f} of points", flush=True)


def compare_card_cpu(what, card, cpu, limit=ALIGN_REL):
    """Card against CPU after the same aligner run: rotations (relative to
    frame 0), focal and depth maps at ALIGN_ROT_DEG / `limit`."""
    def rel_to_first(P):
        return np.linalg.inv(P[0])[None] @ P

    Pa = rel_to_first(card.get_im_poses().astype(np.float64))
    Pb = rel_to_first(cpu.get_im_poses().astype(np.float64))
    # angle between two rotations from their chord, ||Ra - Rb||_F = 2 sqrt(2) sin(a / 2)
    # (arccos of the trace cannot resolve float32 rotations below ~0.03 deg)
    chord = np.linalg.norm(Pa[:, :3, :3] - Pb[:, :3, :3], axis=(1, 2))
    rot = float(np.degrees(2 * np.arcsin(np.clip(chord / (2 * np.sqrt(2)), 0, 1))).max())
    focal_rel = abs(float(card.get_focals()[0]) / float(cpu.get_focals()[0]) - 1)
    da, db = card.get_depthmaps(), cpu.get_depthmaps()
    depth_rel = float(np.linalg.norm(da - db) / np.linalg.norm(db))
    print(f"{what}: card vs CPU: rotation {rot:.4f} deg (limit {ALIGN_ROT_DEG}), "
          f"focal {focal_rel:.3e}, depth relative L2 {depth_rel:.3e} (limit {limit})")
    if not (rot <= ALIGN_ROT_DEG and focal_rel <= limit and depth_rel <= limit):
        raise AssertionError(f"{what}: the card's aligner disagrees with the CPU's")


def check_ground_truth(what, runs, sc):
    from geo4d_tpu_torch.evals.trajectory import Trajectory, eval_metrics

    for name, al in runs.items():
        ate = eval_metrics(Trajectory.from_matrices(al.get_im_poses()),
                           Trajectory.from_matrices(sc["poses"]))[0]
        d = al.get_depthmaps()
        s = np.median(sc["depths"]) / np.median(d)
        abs_rel = float(np.mean(np.abs(s * d - sc["depths"]) / sc["depths"]))
        f = float(al.get_focals()[0])
        print(f"{what}: {name} vs ground truth: focal {f:.3f} (true {sc['focal']}), "
              f"ATE {ate:.5f}, depth AbsRel {abs_rel:.5f}", flush=True)
        if not (abs(f / sc["focal"] - 1) < 0.2 and ate < 0.05 and abs_rel < 0.05):
            raise AssertionError(f"{what}: {name} misses the ground-truth bounds")


def align_reference_phase(dev):
    """The aligner (default config: 500 iterations, calibration at 150) on
    the card and on the CPU, both float32, same inputs and seeds: as the
    pipeline runs it (device init path), from numpy inputs through the host
    init chain, and with the rigid-flow term on (weight 0.1, target flows
    from the ground truth)."""
    from geo4d_tpu_torch.alignment.init import init_from_group
    from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
    from geo4d_tpu_torch.core.timing import StageTimer
    from geo4d_tpu_torch.geometry.warp import depth_based_flow
    from geo4d_tpu_torch.pipeline.inference import align_predictions
    from geo4d_tpu_torch.tools.profile_aligner import synthetic_scene

    sc = synthetic_scene()
    cpu_dev = torch.device("cpu")
    devices = (("cuda", dev), ("cpu", cpu_dev))

    def per_iter_ms(timer, al):
        sec = timer.seconds
        return (sec.get("align_phase1", 0.0) + sec.get("align_phase2", 0.0)) * 1e3 / al.cfg.n_iter

    runs, card_ms = {}, {}
    for name, device in devices:
        preds = {k: torch.from_numpy(v).to(device) for k, v in sc["preds"].items()}
        timer = StageTimer(device)
        t0 = time.perf_counter()
        al = align_predictions(sc["groups"], preds, sc["hw"], AlignerConfig(), timer=timer)
        if device.type == "cuda":
            torch.cuda.synchronize()
            card_ms["plain"] = per_iter_ms(timer, al)
        print(f"align_reference: {name} {time.perf_counter() - t0:.3f} s, final loss "
              f"{al.final_loss:.6f}, PnP failures {al.pnp_failures}", flush=True)
        runs[name] = al
    compare_card_cpu("align_reference", runs["cuda"], runs["cpu"])
    check_ground_truth("align_reference", runs, sc)

    # numpy inputs: the host init chain, on the aligner's device
    p = sc["preds"]
    runs = {}
    for name, device in devices:
        timer = StageTimer(device)
        t0 = time.perf_counter()
        al = GroupAligner(sc["groups"], p["pts3d"], p["conf"], sc["hw"], invdepth=p["inv_depth"],
                          trajs=p["traj"], config=AlignerConfig(), device=device)
        init_from_group(al, p["pts3d"], p["conf"], timer=timer)
        init_s = time.perf_counter() - t0
        al.run(timer=timer)
        print(f"align_reference host init: {name} {time.perf_counter() - t0:.3f} s (init "
              f"{init_s:.3f} s: align_init {timer.seconds.get('align_init', 0.0):.3f}, align_pnp "
              f"{timer.seconds.get('align_pnp', 0.0):.3f}), final loss {al.final_loss:.6f}, "
              f"PnP failures {al.pnp_failures}", flush=True)
        runs[name] = al
    compare_card_cpu("align_reference host init", runs["cuda"], runs["cpu"])
    check_ground_truth("align_reference host init", runs, sc)

    # the rigid-flow term, target flows from the ground truth
    h, w = sc["hw"]
    K = torch.tensor([[sc["focal"], 0, w / 2], [0, sc["focal"], h / 2], [0, 0, 1]])
    depths = torch.from_numpy(sc["depths"]).float()
    poses = torch.from_numpy(sc["poses"]).float()
    flows, _ = depth_based_flow(depths[:-1], poses[:-1], poses[1:], K)
    cfg = AlignerConfig(flow_loss_weight=0.1)
    runs, inits = {}, {}
    for name, device in devices:
        preds = {k: torch.from_numpy(v).to(device) for k, v in p.items()}
        timer = StageTimer(device)
        al = GroupAligner(sc["groups"], preds["pts3d"], preds["conf"], sc["hw"],
                          invdepth=preds["inv_depth"], trajs=preds["traj"], config=cfg,
                          target_flows=flows.to(device), device=device)
        init_from_group(al, preds["pts3d"], preds["conf"])
        inits[name] = {k: v.detach().cpu().clone() for k, v in al.params.items()}
        with torch.no_grad():
            before = float(al._flow_term(al.params))
        t0 = time.perf_counter()
        al.run(timer=timer)
        with torch.no_grad():
            after = float(al._flow_term(al.params))
        if device.type == "cuda":
            card_ms["flow"] = per_iter_ms(timer, al)
        print(f"align_reference flow: {name} run {time.perf_counter() - t0:.3f} s, final loss "
              f"{al.final_loss:.6f}; flow term (mean px error) {before:.5f} after init -> "
              f"{after:.5f} after the run", flush=True)
        if not after < before:
            raise AssertionError(f"align_reference flow: {name}: the flow term did not fall")
        runs[name] = al
    def term_and_grads(al):
        params = {k: v.to(al.device, torch.float64).requires_grad_()
                  for k, v in inits["cpu"].items()}
        term = al._flow_term(params)
        grads = torch.autograd.grad(term, [params[k] for k in ("log_depth", "poses", "focal")])
        return [term.item()] + [g.cpu() for g in grads]

    (va, *ga), (vb, *gb) = term_and_grads(runs["cuda"]), term_and_grads(runs["cpu"])
    term_rel = max([abs(va / vb - 1)] + [float((a - b).norm() / b.norm()) for a, b in zip(ga, gb)])
    print(f"align_reference flow: the term at the CPU's post-init parameters in float64, card vs "
          f"CPU: value and gradient (depth, poses, focal; relative L2) within {term_rel:.3e} "
          f"(limit {FLOW_TERM_REL})", flush=True)
    if not term_rel <= FLOW_TERM_REL:
        raise AssertionError("align_reference flow: the card's flow term disagrees with the CPU's")
    compare_card_cpu("align_reference flow", runs["cuda"], runs["cpu"], ALIGN_FLOW_REL)
    check_ground_truth("align_reference flow", runs, sc)
    print(f"align_reference: card ms per aligner iteration {card_ms['plain']:.3f} without the "
          f"flow term, {card_ms['flow']:.3f} with it (+{card_ms['flow'] - card_ms['plain']:.3f})",
          flush=True)


# ---------------- the aligner's objective kernel and graphs (phase 20) ----------------

ALIGN_KERNEL_REL = 1e-5      # kernel against its plain version, relative L2
ALIGN_ROOFLINE_MIN = 0.4     # the kernel's byte bound over its device time, at 256x576


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def _aligner_on_scene(dev, sc, **cfg):
    from geo4d_tpu_torch.alignment.init import init_from_group
    from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner

    preds = {k: torch.from_numpy(v).to(dev) for k, v in sc["preds"].items()}
    al = GroupAligner(sc["groups"], preds["pts3d"], preds["conf"], sc["hw"],
                      invdepth=preds["inv_depth"], trajs=preds["traj"],
                      config=AlignerConfig(**cfg), **({"target_flows": sc["flows"].to(dev)}
                                                     if "flows" in sc else {}))
    init_from_group(al, preds["pts3d"], preds["conf"])
    return al


def _objective_args(al):
    """The objective op's inputs at the aligner's parameters."""
    from geo4d_tpu_torch.geometry.se3 import params_to_pose
    from geo4d_tpu_torch.ops import align_objective as objective

    cfg, p = al.cfg, al.params
    data = objective.ObjectiveData(al.groups, al.buf["pred_pts"], al.buf["weights"],
                                   al.buf.get("invdepth"), (al.H, al.W),
                                   cfg.conf_clamp if cfg.conf_optimize else None,
                                   cfg.invdepth_valid_thr, cfg.depth_loss_weight)
    with torch.no_grad():
        pw = params_to_pose(p["pw_poses"][:, :7])
        sims = pw[:, :3] * al._pw_scale(p)[:, None, None]
        return (data, p["log_depth"].detach(), al._focals(p).detach(),
                params_to_pose(p["poses"])[:, :3], sims, p["s_depth"].detach(),
                p["t_depth"].detach(), al.valid_depth_group)


def objective_kernel_check(what, al, timed):
    """The kernel against its plain version at the aligner's parameters,
    without and with the depth term; returns the timings."""
    from geo4d_tpu_torch.ops import align_objective as objective

    args = _objective_args(al)
    data = args[0]
    names = ("log_depth", "focal", "poses", "sims", "s_depth", "t_depth")
    out = {}
    for depth in (False, True):
        with torch.no_grad():
            lk, fk = objective.align_objective_forward(*args, depth, True)
            lk2, fk2 = objective.align_objective_forward(*args, depth, True)
            ln, _ = objective.align_objective_forward(*args, depth, False)
            lp, fp = objective.align_objective_plain(*args, depth, True)
        torch.cuda.synchronize()
        errs = {"loss": _rel_l2(lk, lp)}
        errs.update({n: _rel_l2(a, b) for n, a, b in zip(names, data.split(fk), data.split(fp))
                     if depth or n not in ("s_depth", "t_depth")})
        repeat = torch.equal(lk, lk2) and torch.equal(fk, fk2) and torch.equal(ln, lk)
        nbytes = 4 * (2 * data.N * data.P + data.E * data.P * (4 + int(depth)))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"loss": float(lk), "worst_rel_l2": max(errs.values()), "repeat": repeat,
               "bytes": nbytes, "bound_ms": bound}
        if timed:
            row["ms"] = median_ms(lambda: objective.align_objective_forward(*args, depth, True))
            row["loss_only_ms"] = median_ms(
                lambda: objective.align_objective_forward(*args, depth, False))
            row["plain_ms"] = median_ms(
                lambda: objective.align_objective_plain(*args, depth, True), reps=5, warmup=1)
            row["roofline"] = bound / row["ms"]
        print(f"aligner objective {what} depth={depth}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + " (relative L2, limit "
            f"{ALIGN_KERNEL_REL}); " + json.dumps(row), flush=True)
        if not max(errs.values()) <= ALIGN_KERNEL_REL:
            raise AssertionError(f"aligner objective {what}: the kernel disagrees with its plain "
                                 f"version")
        if not repeat:
            raise AssertionError(f"aligner objective {what}: a second launch differs")
        out[f"depth={depth}"] = row
    return out


def _aligner_run(al, graphs):
    """One `run` of the aligner, with CUDA graphs or every iteration eager:
    ms per iteration (the benchmark's align_iter_ms: both phases and the
    calibration), peak memory, memory left after it and counters."""
    from geo4d_tpu_torch.core import timing
    from geo4d_tpu_torch.ops import graphs as graph_replay

    rec, timer = timing.SpanRecorder(), timing.StageTimer(al.device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with timing.recording(rec), contextlib.nullcontext() if graphs else graph_replay.eager():
        al.run(timer=timer)
    torch.cuda.synchronize()
    sec = timer.seconds
    return {"ms_per_iter": (sec["align_phase1"] + sec["calibrate"] + sec["align_phase2"]) * 1e3
            / al.cfg.n_iter, "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2 ** 30,
            "left_mib": (torch.cuda.memory_allocated() - before) / 2 ** 20, **rec.totals(),
            "final_loss": al.final_loss}


def graph_against_eager(what, dev, sc, structures, **cfg):
    """`run` with CUDA graphs twice, with every iteration eager, and eagerly
    with PyTorch's deterministic algorithms (as the benchmark's reference
    aligner runs) over the same predictions: all four equal bit for bit;
    counters, memory."""
    runs, info = {}, {}
    for name, graphs, fixed in (("graph", True, False), ("eager", False, False),
                                ("graph_again", True, False), ("eager_deterministic", False, True)):
        al = _aligner_on_scene(dev, sc, **cfg)
        torch.use_deterministic_algorithms(fixed, warn_only=True)
        try:
            info[name] = _aligner_run(al, graphs)
        finally:
            torch.use_deterministic_algorithms(False)
        runs[name] = al
    n_iter = runs["graph"].cfg.n_iter
    with torch.no_grad():
        obj = {k: float(al.loss_fn(al.params, True)) for k, al in runs.items()}

    def gaps(a, b):
        ra, rb = runs[a], runs[b]
        return {"objective": abs(obj[a] - obj[b]) / abs(obj[b]),
                "depth": _rel_l2(torch.from_numpy(ra.get_depthmaps()),
                                 torch.from_numpy(rb.get_depthmaps())),
                "poses": _rel_l2(torch.from_numpy(ra.get_im_poses()),
                                 torch.from_numpy(rb.get_im_poses())),
                "equal": all(torch.equal(ra.params[k], rb.params[k]) for k in rb.params)}

    out = {"graph_vs_eager": gaps("graph", "eager"),
           "graph_again_vs_graph": gaps("graph_again", "graph"),
           "eager_vs_deterministic": gaps("eager", "eager_deterministic")}
    print(f"aligner graphs {what}: over the same predictions: " + "; ".join(
        f"{k} " + ", ".join(f"{n} {v:.3e}" if n != "equal" else f"bit for bit {v}"
                            for n, v in g.items()) for k, g in out.items())
          + "; " + json.dumps(info), flush=True)
    if not all(g["equal"] for g in out.values()):
        raise AssertionError(f"aligner graphs {what}: the runs differ")
    for name in ("graph", "graph_again"):
        if not (info[name].get("align_eager_iters") == structures
                and info[name].get("align_graph_replays") == n_iter - structures):
            raise AssertionError(f"aligner graphs {what}: {name}: counters off")
    for name in ("eager", "eager_deterministic"):
        if not (info[name].get("align_eager_iters") == n_iter
                and not info[name].get("align_graph_replays")):
            raise AssertionError(f"aligner graphs {what}: {name}: counters off")
    # a run after the first: one-time allocations of the process are done
    if not info["graph_again"]["left_mib"] < 1:
        raise AssertionError(f"aligner graphs {what}: {info['graph_again']['left_mib']:.1f} MiB "
                             f"left after a run")
    return {"gaps": out, **info}


def aligner_phase(dev):
    """Phase 20: the objective kernel and the aligner's CUDA graphs."""
    from geo4d_tpu_torch.geometry.warp import depth_based_flow
    from geo4d_tpu_torch.tools.profile_aligner import synthetic_scene

    small = synthetic_scene()
    big = synthetic_scene(n=32, h=256, w=576, focal=480.0)
    out = {"kernel": {}}
    for what, sc, cfg, timed in (("64x144", small, {}, False),
                                 ("64x144 per-frame focal", small, {"shared_focal": False}, False),
                                 ("256x576", big, {}, True)):
        al = _aligner_on_scene(dev, sc, **cfg)
        al.calibrate()
        out["kernel"][what] = objective_kernel_check(what, al, timed)
    for row in out["kernel"]["256x576"].values():
        if not row["roofline"] >= ALIGN_ROOFLINE_MIN:
            raise AssertionError(f"aligner objective: {row['roofline']:.2f} of the byte bound "
                                 f"(at least {ALIGN_ROOFLINE_MIN})")
    out["graphs"] = graph_against_eager("256x576", dev, big, 2)
    h, w = small["hw"]
    K = torch.tensor([[small["focal"], 0, w / 2], [0, small["focal"], h / 2], [0, 0, 1]])
    poses = torch.from_numpy(small["poses"]).float()
    flows, _ = depth_based_flow(torch.from_numpy(small["depths"]).float()[:-1], poses[:-1],
                                poses[1:], K)
    out["graphs_flow"] = graph_against_eager("64x144 flow", dev, dict(small, flows=flows), 3,
                                             flow_loss_weight=0.1)
    print("aligner " + json.dumps(out), flush=True)
    return out


# ---------------- training (phases 12-16) ----------------

# (name in the kernels line, source, TPU kernel whose backward it is)
BWD_KERNELS = {
    "group_norm": ("group_norm_backward", "geo4d_tpu_torch/csrc/group_norm.cu",
                   "geo4d_tpu/ops/group_norm.py:101, :140, :168 (backward; the JAX package "
                   "differentiates its XLA path, no TPU backward kernel)"),
    "flash_attention": ("flash_attention_backward", "geo4d_tpu_torch/csrc/flash_attention_bwd.cu",
                        "geo4d_tpu/ops/flash_attention.py:70 (backward; the JAX package "
                        "differentiates its XLA path, no TPU backward kernel)"),
    "temporal_attention": ("temporal_attention_backward",
                           "geo4d_tpu_torch/csrc/temporal_attention.cu",
                           "geo4d_tpu/ops/temporal_attention.py:85 (backward; the JAX package "
                           "differentiates its XLA path, no TPU backward kernel)"),
}
# a backward kernel against its plain backward in float32 on the same inputs:
# relative L2 of each gradient. K1b sums in f32 throughout (its dx differs
# from the plain one by rounding to bf16); K2b and K3b multiply in bf16
# (P and dS), which sets their floor.
BWD_REL_L2 = {"group_norm": 1e-4, "flash_attention": 1e-2, "temporal_attention": 1e-2}
# one training step of the tiny preset, bf16 on the card against float32 on
# the CPU with the same weights, batch and draws: the loss (relative) and the
# whole gradient (relative L2)
TRAIN_REF_LOSS_REL = 1e-2
TRAIN_REF_GRAD_REL = 1e-2
TRAIN_T, TRAIN_HW = 16, (256, 576)


def check_backward_launches(what, stats, need=KERNELS):
    """Fails unless every backward kernel in `need` launched since the
    counts were reset; returns the backward launches."""
    launches = {k: s.backward_launches for k, s in stats.items()}
    print(f"{what}: backward launches {json.dumps(launches)}", flush=True)
    for k in need:
        if launches[k] == 0:
            raise AssertionError(f"{what}: backward kernel of {k} was not launched")
    return launches


def write_shards(root, n, t, hw, seed):
    """n seeded .npz clips in cli/train.py's data layout (float32)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        shape = (t, *hw)
        np.savez(os.path.join(root, f"clip_{i}.npz"),
                 video=rng.uniform(-1, 1, (*shape, 3)).astype(np.float32),
                 normed_allpts=rng.normal(0, 0.5, (*shape, 3)).astype(np.float32),
                 plucker_raymap=rng.normal(0, 0.5, (*shape, 3)).astype(np.float32),
                 plucker_cross=rng.normal(0, 0.5, (*shape, 3)).astype(np.float32),
                 inverse_depth=rng.uniform(0, 1, (*shape, 1)).astype(np.float32), fps=24)


def train_phase(dev):
    """cli/train.main at full width (flagship, random-normal weights) on two
    seeded 16 x 256 x 576 shards: 3 steps of pc_ray_cross_depth at batch 1,
    the CLI's defaults otherwise. Returns the forward and backward launches
    per (kernel, shape) of the run and its step count."""
    from geo4d_tpu_torch.cli import train
    from geo4d_tpu_torch.models.checkpoint import load_unet_weights
    from geo4d_tpu_torch.models.unet3d import UNet3D

    stats = kernel_stats()
    steps = 3
    with tempfile.TemporaryDirectory() as tmp:
        du = shutil.disk_usage(tmp)
        print(f"train: free disk {du.free} bytes of {du.total} (the f32 EMA checkpoint is "
              f"~5.8 GB)", flush=True)
        data, run = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        t0 = time.perf_counter()
        write_shards(data, 2, TRAIN_T, TRAIN_HW, seed=0)
        print(f"train: two shards of {TRAIN_T}x{TRAIN_HW[0]}x{TRAIN_HW[1]} written "
              f"({os.path.getsize(os.path.join(data, 'clip_0.npz'))} bytes each) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for st in stats.values():
            st.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train.main(["--data_dir", data, "--out_dir", run, "--steps", str(steps),
                          "--batch_size", "1", "--modality", "pc_ray_cross_depth"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        del out["state"]
        check_path_launches("train", stats)
        check_backward_launches("train", stats)
        fwd = {k: dict(st.by_shape) for k, st in stats.items()}
        bwd = {k: dict(st.backward_by_shape) for k, st in stats.items()}
        if not (len(out["losses"]) == steps and np.isfinite(out["losses"]).all()):
            raise AssertionError(f"train: losses {out['losses']}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if [r["step"] for r in rows if "loss_simple" in r] != list(range(steps)):
            raise AssertionError(f"train: metrics.jsonl rows {rows}")
        t1 = time.perf_counter()
        with torch.device("meta"):
            unet = UNet3D(dtype=torch.bfloat16)
        unet.to_empty(device=dev)
        load_unet_weights(unet, os.path.join(run, "ckpt_final"))
        if not all(bool(torch.isfinite(p).all()) for p in unet.parameters()):
            raise AssertionError("train: ckpt_final holds non-finite weights")
        ckpt_bytes = os.path.getsize(os.path.join(run, "ckpt_final"))
        del unet
        load_s = time.perf_counter() - t1
    torch.cuda.empty_cache()
    step_s = [sum(t) for t in zip(out["build_s"], out["forward_backward_s"], out["optimizer_s"])]
    print(f"train: losses {out['losses']}; wall {wall:.3f} s (model build, text context, "
          f"{steps} steps, checkpoint); per step (device synchronised around each stage): "
          f"first {step_s[0]:.4f} s, steady {statistics.mean(step_s[1:]):.4f} s; batch build "
          f"{out['build_s']} s against UNet forward + backward {out['forward_backward_s']} s "
          f"(AdamW + EMA {out['optimizer_s']} s); peak memory allocated {peak} bytes; "
          f"ckpt_final {ckpt_bytes} bytes loaded into a UNet in {load_s:.2f} s (checkpoints "
          f"deleted)", flush=True)
    return fwd, bwd, steps


def vae_train_phase(dev):
    """One generator step and one discriminator step of the flagship RGB VAE
    (random-normal weights) and a PatchGAN on 2 frames at 256x576 with
    disc_start=0. Returns the backward launches per (kernel, shape)."""
    from geo4d_tpu_torch.models.autoencoder import AutoencoderKL
    from geo4d_tpu_torch.models.presets import init_random_
    from geo4d_tpu_torch.ops import group_norm as gn
    from geo4d_tpu_torch.core.draws import Draws
    from geo4d_tpu_torch.training.vae import (PatchDiscriminator, VAETrainConfig,
                                              make_vae_train_steps)

    with torch.device("meta"):
        vae = AutoencoderKL(with_adaptor=False, dtype=torch.bfloat16)
        disc = PatchDiscriminator(3, dtype=torch.bfloat16)
    init_random_(vae, dev, seed=7)
    init_random_(disc, dev, seed=8)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand((2, *TRAIN_HW, 3), generator=g, device=dev) * 2 - 1
    g_step, d_step, init_state = make_vae_train_steps(vae, disc, VAETrainConfig(disc_start=0))
    state = init_state()
    stats = kernel_stats()
    for st in stats.values():
        st.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, gm = g_step(state, x, Draws.seeded([0, 0], dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, dm = d_step(state, x, Draws.seeded([0, 1], dev))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_path_launches("vae_train", stats, need=("group_norm",))
    check_backward_launches("vae_train", stats, need=("group_norm",))
    metrics = {k: float(v) for k, v in {**gm, **dm}.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"vae_train: non-finite metrics {metrics}")
    bwd = dict(stats["group_norm"].backward_by_shape)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    two_pass = [k for k in bwd if gn.plan(k[0], k[1], k[2], 32, sms)[0] == "two_pass"]
    if not two_pass:
        raise AssertionError("vae_train: K1b ran at no shape of K1's two-pass path")
    print(f"vae_train: generator step {t1 - t0:.4f} s, discriminator step {t2 - t1:.4f} s "
          f"(first calls); metrics {json.dumps(metrics)}; K1b shapes {len(bwd)}, of K1's "
          f"two-pass path {len(two_pass)} (e.g. {two_pass[0]}); peak memory allocated "
          f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    del vae, disc, state, x
    torch.cuda.empty_cache()
    return {"group_norm": bwd}


def bwd_bound_ms(name, key):
    """Least time of one backward call at shape `key`: each input read once
    (x and dy, or q, k, v, o, dO and the log-sum-exp) and each gradient
    written once, against the operations the backward needs: GroupNorm 10
    f32 operations per element (21 with the SiLU); attention five products
    (S, dP, dV, dQ, dK: 10 N_q N_k d) in bf16 on the tensor cores. For K3b
    the bytes bound every training shape (at N = 16 its products would take
    a twentieth of the memory's time even at the f32 peak), so its sum of
    bounds is the same as when it multiplied on the f32 pipes."""
    if name == "group_norm":
        n, s, c, silu = key
        elems = n * s * c
        return _bound(6 * elems + 16 * c, elems * (21 if silu else 10), PEAK_F32)
    if name == "flash_attention":
        b, nq, nk, h = key
        return _bound(2 * 64 * h * b * (4 * nq + 4 * nk) + 4 * b * h * nq,
                      10 * b * h * nq * nk * 64, PEAK_BF16)
    p, n, c, heads = key
    return _bound(2 * 7 * p * n * c, 10 * p * n * n * c, PEAK_BF16)


def bwd_calls(name, key, g, dev):
    """(kernel, plain backward, library backward or None) on seeded inputs
    and a seeded cotangent at one shape. The library backward is one PyTorch
    call's backward through torch.autograd (F.group_norm without the SiLU;
    scaled_dot_product_attention under the flash backend), its forward run
    once outside the timing."""
    import torch.nn.functional as F
    from geo4d_tpu_torch.ops import flash_attention as fa
    from geo4d_tpu_torch.ops import group_norm as gn
    from geo4d_tpu_torch.ops import temporal_attention as ta

    args = make_args(name, key, g, dev)
    if name == "group_norm":
        x, gamma, beta, groups, eps, silu = args
        _, part = gn.group_norm_forward(x, gamma, beta, groups, eps, silu)
        y, mean, rstd = gn.group_norm_plain_with_stats(x, gamma, beta, groups, eps, silu)
        # a cotangent that follows y, so that the group means c1 and c2 (K1b's
        # cross-tile folds) carry much of dx: a fold that drops, doubles or
        # misreads a tile moves dx by far more than BWD_REL_L2
        dy = (y.float() + torch.randn(x.shape, generator=g, device=dev)).to(torch.bfloat16)
        lib = None
        if not silu:
            xl = x.permute(0, 2, 1).detach().requires_grad_()
            g16, b16 = (t.to(x.dtype).requires_grad_() for t in (gamma, beta))
            yl = F.group_norm(xl, groups, g16, b16, eps)
            dyl = dy.permute(0, 2, 1)

            def lib():
                return torch.autograd.grad(yl, (xl, g16, b16), dyl, retain_graph=True)
        return (lambda: gn.group_norm_backward(x, dy, gamma, beta, part, groups, eps, silu),
                lambda: gn.group_norm_backward_plain(x, dy, gamma, beta, mean, rstd, groups, silu),
                lib)
    if name == "flash_attention":
        q, k, v = args
        o, lse = fa.flash_attention_forward(q, k, v, with_lse=True)
        do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
        hq, hk, hv = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(hq, hk, hv)
        dol = do.transpose(1, 2)
        return (lambda: fa.flash_attention_backward(q, k, v, o, do, lse),
                lambda: fa.flash_attention_backward_plain(q, k, v, o, do,
                                                          fa.log_sum_exp_plain(q, k)),
                lambda: torch.autograd.grad(ol, (hq, hk, hv), dol, retain_graph=True))
    q, k, v, heads = args
    p, n, c = q.shape
    do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    hq, hk, hv = (t.view(p, n, heads, c // heads).transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ol = F.scaled_dot_product_attention(hq, hk, hv)
    dol = do.view(p, n, heads, c // heads).transpose(1, 2)
    return (lambda: ta.temporal_attention_backward(q, k, v, do, heads),
            lambda: ta.temporal_attention_backward_plain(q, k, v, do, heads),
            lambda: torch.autograd.grad(ol, (hq, hk, hv), dol, retain_graph=True))


def bwd_path(name, key, dev):
    """The path of a backward kernel's plan at shape `key`; for K3b, which
    has one path, its ring: warps x slots per warp, blocks and shared
    memory per block."""
    from geo4d_tpu_torch.nn.basics import num_groups_for
    from geo4d_tpu_torch.ops import flash_attention as fa
    from geo4d_tpu_torch.ops import group_norm as gn
    from geo4d_tpu_torch.ops import temporal_attention as ta

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if name == "group_norm":
        n, s, c, _ = key
        return gn.backward_plan(n, s, c, num_groups_for(c), sms)[0]
    if name == "flash_attention":
        return fa.backward_plan(*key, sms).path
    pl = ta.backward_plan(*key, sms)
    return f"ring:{pl.warps}x{pl.stages},grid={pl.grid},smem={pl.smem}"


def check_k3b_build():
    """Every instance of K3b in the built library, read back with the
    toolkit's cuobjdump: registers, no spills (STACK and LOCAL 0), and
    mma.sync (HMMA) and movmatrix (MOVM) in its SASS."""
    from geo4d_tpu_torch.ops import dispatch

    tool = os.path.join(os.path.dirname(dispatch._nvcc()), "cuobjdump")
    lib = str(dispatch.library_path())
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True,
                           check=True).stdout
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    found = 0
    lines = usage.splitlines()
    for i, line in enumerate(lines):
        if "Function" in line and "temporal_attn_bwd_kernel" in line:
            fields = dict(t.split(":", 1) for t in lines[i + 1].split() if ":" in t)
            name = line.split("Function", 1)[1].strip(" :")
            body = sass.split(f"Function : {name}", 1)[1].split("Function : ", 1)[0]
            found += 1
            print(f"backward temporal_attention build: {name} REG {fields['REG']} STACK "
                  f"{fields['STACK']} LOCAL {fields['LOCAL']} HMMA.16816 "
                  f"{body.count('HMMA.16816')} MOVM {body.count('MOVM')}", flush=True)
            if (int(fields["STACK"]) or int(fields["LOCAL"]) or "HMMA.16816" not in body
                    or "MOVM" not in body):
                raise AssertionError(f"K3b instance {name}: spills or no mma.sync / movmatrix")
    if found != 6:
        raise AssertionError(f"K3b: {found} instances in {lib}, expected 6")


def backward_phase(dev, train_shapes, steps, vae_shapes):
    """Every (backward kernel, shape) that the training steps of `train`
    (launches per step: the run's count / steps) and the VAE GAN step of
    `vae_train` launched: checked against its plain backward on a seeded
    cotangent (relative L2 of each gradient <= BWD_REL_L2[name]) and a second launch
    (bit for bit), timed warm and cold beside its bound and the library
    call's backward; K3b's instances first read back from the library
    (`check_k3b_build`). Returns each kernel's summary row and per-step
    totals."""
    check_k3b_build()
    g = torch.Generator(device=dev).manual_seed(11)
    results, totals = {}, {}
    for name in KERNELS:
        rows = [(key, n / steps, "train") for key, n in train_shapes.get(name, {}).items()]
        rows += [(key, n, "vae") for key, n in vae_shapes.get(name, {}).items()
                 if key not in train_shapes.get(name, {})]
        rows.sort(key=lambda r: -r[1])
        t = totals.setdefault(name, {"launches_per_step": 0.0, "total_ms": 0.0,
                                     "total_cold_ms": 0.0, "total_bound_ms": 0.0,
                                     "total_library_ms": 0.0, "total_ms_with_library": 0.0})
        for i, (key, per_step, source) in enumerate(rows):
            kernel, plain, lib = bwd_calls(name, key, g, dev)
            got = kernel()
            repeat = all(torch.equal(a, b) for a, b in zip(got, kernel()))
            want = plain()
            torch.cuda.synchronize()
            errs = [float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
                    for a, b in zip(got, want)]
            max_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            del got, want
            if not repeat:
                raise AssertionError(f"backward {name} {label(name, key)}: two launches differ")
            if not max(errs) <= BWD_REL_L2[name]:
                raise AssertionError(f"backward {name} {label(name, key)}: relative L2 "
                                     f"{errs} > {BWD_REL_L2[name]}")
            row = {"max_abs_err": max_abs, "rel_l2": max(errs), "bound": bwd_bound_ms(name, key),
                   "ms": median_ms(kernel), "cold_ms": median_ms(kernel, cold=True),
                   "library_ms": median_ms(lib) if lib is not None else None,
                   "plain_ms": median_ms(plain, reps=5, warmup=1) if i == 0 else None}
            b, kind = row["bound"]
            if source == "train":
                t["launches_per_step"] += per_step
                t["total_ms"] += per_step * row["ms"]
                t["total_cold_ms"] += per_step * row["cold_ms"]
                t["total_bound_ms"] += per_step * b
                if row["library_ms"] is not None:
                    t["total_library_ms"] += per_step * row["library_ms"]
                    t["total_ms_with_library"] += per_step * row["ms"]
            print(f"backward {name:18s} {label(name, key):40s} {source} "
                  f"path={bwd_path(name, key, dev)} launches_per_step="
                  f"{per_step:g} ms={row['ms']:.4f} cold_ms={row['cold_ms']:.4f} "
                  f"bound_ms={b:.4f} ({kind}) share_cold={b / row['cold_ms']:.3f} "
                  f"library_ms={fmt(row['library_ms'])} plain_ms={fmt(row['plain_ms'])} "
                  f"rel_l2={row['rel_l2']:.3e} max_abs={max_abs:.3e} repeat_equal=True", flush=True)
            r = results.setdefault(name, dict(row, shape=label(name, key)))
            r["max_abs_err"] = max(r["max_abs_err"], max_abs)
            del kernel, plain, lib
            torch.cuda.empty_cache()
        print(f"backward {name}: per training step {t['launches_per_step']:g} launches, "
              f"sum launches x ms {t['total_ms']:.3f} (x cold_ms {t['total_cold_ms']:.3f}), "
              f"x bound_ms {t['total_bound_ms']:.3f}, x library_ms {t['total_library_ms']:.3f} "
              f"(kernel over the same shapes {t['total_ms_with_library']:.3f})", flush=True)
    return results, totals


def state_fingerprint(state):
    """Integer sums of the bit patterns of every tensor of a TrainState."""
    return [sum(int(t.view(torch.int32).sum(dtype=torch.int64)) for t in part.values())
            for part in (state.params, state.exp_avg, state.exp_avg_sq, state.ema)]


def flagship_train_setup(dev):
    """The flagship (random-normal weights) with its towers frozen, and one
    seeded 16 x 256 x 576 pc_ray_cross_depth batch built from it."""
    from geo4d_tpu_torch.models.presets import flagship, init_random_
    from geo4d_tpu_torch.training.modalities import build_batch
    from geo4d_tpu_torch.core.draws import Draws

    model = init_random_(flagship(), dev, seed=0).eval()
    model.text_encoder = None
    model.requires_grad_(False)
    model.unet.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(12)
    shape = (1, TRAIN_T, *TRAIN_HW)
    raw = {k: torch.rand((*shape, c), generator=g, device=dev) * 2 - 1 for k, c in
           (("video", 3), ("normed_allpts", 3), ("plucker_raymap", 3), ("plucker_cross", 3),
            ("inverse_depth", 1))}
    raw["fps"] = torch.tensor([24], dtype=torch.int32, device=dev)
    prompt = torch.randn((1, 77, 1024), generator=g, device=dev)
    batch = build_batch("pc_ray_cross_depth", model, raw, Draws.seeded([1, 0], dev), prompt,
                        torch.zeros_like(prompt))
    return model, batch


def train_repeat_phase(dev):
    """One full-width training step (flagship, random-normal weights, one
    16 x 256 x 576 pc_ray_cross_depth batch), run twice from the same state
    and batch: the loss and every tensor of the state must repeat bit for
    bit. Returns the step's (loss, state fingerprint)."""
    from geo4d_tpu_torch.core.draws import Draws
    from geo4d_tpu_torch.training.step import TrainConfig, create_train_state, make_train_step

    model, batch = flagship_train_setup(dev)
    step_fn = make_train_step(model.unet, model.schedule, TrainConfig())
    runs = []
    for _ in range(2):
        state = create_train_state(model.unet)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, Draws.seeded([1, 1], dev))
        torch.cuda.synchronize()
        runs.append((float(m["loss_simple"]), state_fingerprint(state),
                     time.perf_counter() - t0))
        del state
    print(f"train_repeat: loss {runs[0][0]!r} and {runs[1][0]!r}; state fingerprints "
          f"{runs[0][1]} and {runs[1][1]}; step {runs[0][2]:.4f} s and {runs[1][2]:.4f} s",
          flush=True)
    if runs[0][:2] != runs[1][:2]:
        raise AssertionError("train_repeat: the two steps from the same state differ")
    del model, batch
    torch.cuda.empty_cache()
    return runs[0][:2]


def _graph_side(model, batch, dev, cfg, capture, eager_grads=None):
    """Three steps of make_train_step(model.unet, ..., cfg) from the state of
    the module's weights, every step eager unless `capture`, with the draws
    of train_repeat. Without `eager_grads`, each step's gradients are kept
    on the host; with them (the other side's), each gradient is compared
    there. Returns the record and the host gradients."""
    from geo4d_tpu_torch.core.draws import Draws
    from geo4d_tpu_torch.core.timing import SpanRecorder, StageTimer, recording
    from geo4d_tpu_torch.ops import graphs as graph_replay
    from geo4d_tpu_torch.training import step as train_step

    names = [n for n, _ in model.unet.named_parameters()]
    stats = kernel_stats()
    state = train_step.create_train_state(model.unet)
    fn = train_step.make_train_step(model.unet, model.schedule, cfg)
    grads_seen, gaps, equal = [], [], []
    adam = train_step.adam_update_

    def recording_adam(params, grads, *a, **k):
        i = len(gaps) if eager_grads is not None else len(grads_seen)
        if eager_grads is None:
            grads_seen.append([g.detach().cpu() for g in grads])
        else:
            worst, same = 0.0, True
            for g, h in zip(grads, eager_grads[i]):
                want = h.to(dev)
                if not torch.equal(g, want):
                    same = False
                    worst = max(worst, float((g.double() - want.double()).norm()
                                             / want.double().norm().clamp_min(1e-30)))
            gaps.append(worst)
            equal.append(same)
        return adam(params, grads, *a, **k)

    rec = SpanRecorder()
    losses, launches, fwd_bwd_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    train_step.adam_update_ = recording_adam
    try:
        with recording(rec), contextlib.nullcontext() if capture else graph_replay.eager():
            for i in range(3):
                before = {k: (dict(s.by_shape), dict(s.backward_by_shape))
                          for k, s in stats.items()}
                timer = StageTimer(dev)
                state, m = fn(state, batch, Draws.seeded([1, 1 + i], dev), timer)
                losses.append(float(m["loss_simple"]))
                fwd_bwd_ms.append(timer.seconds["forward_backward"] * 1e3)
                launches.append({k: ({str(sh): n - before[k][0].get(sh, 0)
                                      for sh, n in s.by_shape.items()
                                      if n != before[k][0].get(sh, 0)},
                                     {str(sh): n - before[k][1].get(sh, 0)
                                      for sh, n in s.backward_by_shape.items()
                                      if n != before[k][1].get(sh, 0)})
                                 for k, s in stats.items()})
    finally:
        train_step.adam_update_ = adam
    torch.cuda.synchronize()
    out = {"capture": capture, "losses": losses, "fingerprint":
           state_fingerprint(state), "launches": launches, "fwd_bwd_ms": fwd_bwd_ms,
           "counters": rec.totals(),
           "captures": sum(s.name == "train_capture" for s in rec.spans),
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
           "gaps": gaps, "grads_equal": equal, "leaves": len(names)}
    del state, fn, m
    torch.cuda.empty_cache()
    return out, grads_seen


def train_graph_phase(dev):
    """Phase 15b: the step's CUDA graph against its eager steps, with remat
    off and on (the step takes the graph in both). Returns the two
    records."""
    from geo4d_tpu_torch.training.step import TrainConfig

    model, batch = flagship_train_setup(dev)
    weights0 = {n: p.detach().clone() for n, p in model.unet.named_parameters()}
    records = {}
    for remat in (False, True):
        cfg = TrainConfig(remat=remat)
        sides = {}
        for capture in (False, True):
            with torch.no_grad():
                for n, p in model.unet.named_parameters():
                    p.copy_(weights0[n])
            if capture:
                sides["graph"], _ = _graph_side(model, batch, dev, cfg, True, eager)
            else:
                sides["eager"], eager = _graph_side(model, batch, dev, cfg, False)
        del eager
        e, g = sides["eager"], sides["graph"]
        rec = {"remat": remat, "eager": e, "graph": g,
               "losses_equal": e["losses"] == g["losses"],
               "grads_equal": all(g["grads_equal"]), "grad_gap_max": max(g["gaps"]),
               "states_equal": e["fingerprint"] == g["fingerprint"],
               "launches_equal": e["launches"] == g["launches"]}
        # launches as totals per kernel and step (forward, backward)
        brief = {k: ({**v, "launches": [{n: [sum(f.values()), sum(b.values())]
                                         for n, (f, b) in step.items()}
                                        for step in v["launches"]]}
                     if isinstance(v, dict) and "launches" in v else v)
                 for k, v in rec.items()}
        print("train_graph " + json.dumps(brief), flush=True)
        records[remat] = rec
    del model, batch, weights0
    torch.cuda.empty_cache()
    for remat, rec in records.items():
        what = f"train_graph (remat {remat})"
        g, e = rec["graph"], rec["eager"]
        if not (rec["losses_equal"] and rec["grads_equal"] and rec["states_equal"]):
            raise AssertionError(f"{what}: the graph's steps differ from the eager ones "
                                 f"(largest gradient gap {rec['grad_gap_max']})")
        if not rec["launches_equal"]:
            raise AssertionError(f"{what}: the graph's steps count other kernel launches")
        if (g["counters"] != {"train_eager_steps": 1, "train_graph_replays": 2}
                or g["captures"] != 1):
            raise AssertionError(f"{what}: counters {g['counters']}, {g['captures']} captures")
        if e["counters"] != {"train_eager_steps": 3} or e["captures"]:
            raise AssertionError(f"{what}: eager counters {e['counters']}")
    return records


def train_reference_phase(dev):
    """The tiny preset: one step's loss and gradient in bf16 on the card
    (kernels) against float32 on the CPU (plain versions), same weights,
    batch and draws; then cli/train.main --tiny on the card for 3 steps,
    against 2 steps, a checkpoint and a resumed third."""
    from geo4d_tpu_torch.cli import train
    from geo4d_tpu_torch.models.presets import tiny
    from geo4d_tpu_torch.core.draws import GivenDraws
    from geo4d_tpu_torch.training.step import TrainConfig, diffusion_loss

    ref = tiny(temporal_length=4, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    card = tiny(temporal_length=4, dtype=torch.bfloat16, device="meta")
    card.to_empty(device=dev)
    card.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(13)
    batch = {"z0": rng.normal(size=(2, 4, 4, 8, 16)), "c_concat": rng.normal(size=(2, 4, 4, 8, 4)),
             "context": rng.normal(size=(2, 77 + 64, 64))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    draws = [np.array([100, 700]), rng.normal(size=(2, 4, 4, 8, 16)).astype(np.float32)]
    out = {}
    stats = kernel_stats()
    for st in stats.values():
        st.reset()
    for name, model, device in (("cpu", ref, torch.device("cpu")), ("card", card, dev)):
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        tb["fs"] = torch.tensor([24, 8], device=device)
        loss, _ = diffusion_loss(model.unet, model.schedule, tb, GivenDraws(draws, device),
                                 TrainConfig(temporal_length=4))
        grads = torch.autograd.grad(loss, list(model.unet.parameters()), allow_unused=True)
        out[name] = (float(loss.detach()), torch.cat([(torch.zeros(p.numel()) if gr is None else
                                              gr.float().cpu().flatten())
                                             for gr, p in zip(grads, model.unet.parameters())]))
    check_backward_launches("train_reference", stats, need=("group_norm", "temporal_attention"))
    loss_rel = abs(out["card"][0] / out["cpu"][0] - 1)
    grad_rel = float((out["card"][1] - out["cpu"][1]).norm() / out["cpu"][1].norm())
    print(f"train_reference: tiny step, card bf16 vs CPU f32: loss {out['card'][0]:.6f} vs "
          f"{out['cpu'][0]:.6f} (relative {loss_rel:.3e}, limit {TRAIN_REF_LOSS_REL}); gradient "
          f"relative L2 {grad_rel:.3e} (limit {TRAIN_REF_GRAD_REL})", flush=True)
    if not (loss_rel <= TRAIN_REF_LOSS_REL and grad_rel <= TRAIN_REF_GRAD_REL):
        raise AssertionError("train_reference: the card's step disagrees with the CPU's")

    with tempfile.TemporaryDirectory() as tmp:
        write_shards(os.path.join(tmp, "data"), 2, 4, (64, 64), seed=1)
        common = ["--data_dir", os.path.join(tmp, "data"), "--tiny", "--height", "64",
                  "--width", "64", "--video_length", "4", "--ckpt_every", "2"]
        full = train.main(common + ["--out_dir", os.path.join(tmp, "a"), "--steps", "3"])
        train.main(common + ["--out_dir", os.path.join(tmp, "b"), "--steps", "2"])
        resumed = train.main(common + ["--out_dir", os.path.join(tmp, "b"), "--steps", "3",
                                       "--resume"])
    print(f"train_reference: tiny CLI on the card, 3 steps {full['losses']}; 2 + resumed 1: "
          f"{resumed['losses']}", flush=True)
    if resumed["losses"] != full["losses"][2:]:
        raise AssertionError("train_reference: the resumed step-3 loss differs from the "
                             "uninterrupted run's")


# The parallel phase. NCCL refuses two ranks on one GPU ("Duplicate GPU
# detected"), so its card runs are NCCL at world size 1 (the communicator
# and collectives on CUDA tensors) and two gloo ranks sharing cuda:0 (the
# cross-rank arithmetic with the kernels; gloo takes the CUDA tensors and
# copies them through the host itself).
# Neither is a speed claim.
PAR_WORLD = 2
# two ranks' windows (one each) against one process at window_batch 2:
# relative L2 of each output
PAR_INFER_REL_L2 = 1e-3
# two training ranks keep the flagship's widths (model channels, channel
# multipliers, heads) at this depth: two full-depth ranks need ~50 GB each
PAR_NUM_RES_BLOCKS = 1
# a 2-rank step at batch 1 a rank against one process at batch 2 (bf16 on
# the card): the loss (relative) and the updated master weights (relative
# L2 over the tree; an AdamW step moves a weight by ~lr sign(g), and a
# gradient within bf16 rounding of zero may flip its sign). Measured on an
# H100: 1.7e-7 and 2.4e-6.
PAR_TRAIN_LOSS_REL = 1e-5
PAR_TRAIN_PARAM_REL = 1e-4
# ... and the averaged gradient, read from AdamW's first moment after the
# step (0.1 g; relative L2 over the tree). The loss and the weights cannot
# see the gradient's scale; this can: a reduction that forgot to divide by
# the world size lands at 1.0, one that divided twice at 0.5.
PAR_TRAIN_GRAD_REL = 1e-2
STATE_PARTS = ("params", "exp_avg", "exp_avg_sq", "ema")


def _rank_setup(rank, store):
    """A spawned rank of the parallel phase: gloo on cuda:0, Pillow
    unimportable, the parent's float32 precision."""
    from geo4d_tpu_torch.parallel.mesh import init_distributed

    sys.modules["PIL"] = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return init_distributed("cuda", PAR_WORLD, rank=rank, world_size=PAR_WORLD, local_rank=rank,
                            init_method="file://" + store, backend="gloo")


def _rank_done(mesh, out_dir, result):
    """Check what the rank loaded, write its result, leave the group."""
    from geo4d_tpu_torch.parallel.dryrun import foreign_modules
    from geo4d_tpu_torch.parallel.mesh import shutdown_distributed

    if foreign_modules():
        raise AssertionError(f"rank {mesh.rank} loaded {foreign_modules()[:5]}")
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(result, f)
    mesh.barrier()
    shutdown_distributed()


def _spawn(fn, tmp):
    """Run fn(rank, store, tmp) in PAR_WORLD processes; a failed rank
    raises here. Returns the ranks' results and the wall time."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.spawn(fn, args=(os.path.join(tmp, "store"), tmp), nprocs=PAR_WORLD, join=True)
    wall = time.perf_counter() - t0
    results = []
    for r in range(PAR_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, wall


def _compare(got, want):
    a, b = got.double(), want.double()
    return {"rel_l2": float((a - b).norm() / b.norm().clamp_min(1e-30)),
            "max_abs": float((a - b).abs().max()), "equal": bool(torch.equal(got, want))}


def _infer_rank(rank, store, out_dir):
    """The slice phase's reconstruct at full width, the windows shared by
    the ranks; rank 0 aligns, exports and compares the gathered predictions
    with one process at window_batch 2."""
    from geo4d_tpu_torch.cli.common import prepare_inference_params
    from geo4d_tpu_torch.core.timing import StageTimer
    from geo4d_tpu_torch.models.presets import flagship, init_random_
    from geo4d_tpu_torch.pipeline.inference import (InferenceConfig, WindowPredictor,
                                                    reconstruct, sliding_windows)

    mesh = _rank_setup(rank, store)
    dev = mesh.device
    model = init_random_(flagship(), dev, seed=0).eval()
    text_ctx, uncond_text_ctx = prepare_inference_params(model, PROMPT)
    frames = np.random.default_rng(0).integers(0, 256, size=(20, 256, 576, 3), dtype=np.uint8)
    stats = kernel_stats()
    for st in stats.values():
        st.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = StageTimer(dev)
    t0 = time.perf_counter()
    scene, preds, timing = reconstruct(model, frames, text_ctx, fps=24, seed=123,
                                       uncond_text_ctx=uncond_text_ctx, mesh=mesh, timer=timer)
    torch.cuda.synchronize()
    result = {"wall_s": time.perf_counter() - t0, "timing": timing, "stages": timer.seconds,
              "peak_bytes": torch.cuda.max_memory_allocated(dev),
              "launches": check_path_launches(f"parallel_infer rank {rank}", stats)}
    if rank != 0:
        if scene is not None:
            raise AssertionError(f"parallel_infer: rank {rank} aligned")
        return _rank_done(mesh, out_dir, result)
    if scene is None or not np.isfinite(scene.final_loss):
        raise AssertionError("parallel_infer: rank 0 did not align")
    result["final_loss"] = scene.final_loss
    result["export_s"] = export_and_check(scene, frames)[2]
    one = WindowPredictor(model, InferenceConfig(window_batch=PAR_WORLD), device=dev).predict_video(
        frames, sliding_windows(20, 16, 4), text_ctx, fps=24, seed=123,
        uncond_text_ctx=uncond_text_ctx, return_device=True)
    result["vs_one_process"] = {k: _compare(preds[k], one[k]) for k in one}
    _rank_done(mesh, out_dir, result)


def _par_train_batch(dev):
    """A seeded latent batch of two 16 x 256 x 576 clips (the UNet's
    inputs: 32 x 72 latents) and its text + image context."""
    g = torch.Generator(device=dev).manual_seed(14)
    h, w = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    return {"z0": torch.randn((PAR_WORLD, TRAIN_T, h, w, 16), generator=g, device=dev),
            "c_concat": torch.randn((PAR_WORLD, TRAIN_T, h, w, 4), generator=g, device=dev),
            "context": torch.randn((PAR_WORLD, 77 + TRAIN_T * 16, 1024), generator=g, device=dev),
            "fs": torch.full((PAR_WORLD,), 24, dtype=torch.int32, device=dev)}


def _train_rank(rank, store, out_dir):
    """A DP step and an FSDP step from the same state (the flagship's widths
    at PAR_NUM_RES_BLOCKS, batch 1 a rank); each rank checks that its FSDP
    slices equal its DP state's bit for bit; rank 0 then runs one process
    at batch 2 and compares."""
    from geo4d_tpu_torch.core.schedules import DiffusionSchedule
    from geo4d_tpu_torch.core.timing import StageTimer
    from geo4d_tpu_torch.models.presets import init_random_
    from geo4d_tpu_torch.models.unet3d import UNet3D
    from geo4d_tpu_torch.parallel.mesh import rank_rows
    from geo4d_tpu_torch.parallel.sharding import ShardLayout, gather_state_dict
    from geo4d_tpu_torch.core.draws import Draws
    from geo4d_tpu_torch.training.step import TrainConfig, create_train_state, make_train_step

    mesh = _rank_setup(rank, store)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = mesh.device
    with torch.device("meta"):
        unet = UNet3D(num_res_blocks=PAR_NUM_RES_BLOCKS)
    init_random_(unet, dev, seed=0)
    schedule, cfg = DiffusionSchedule.create(), TrainConfig(remat=True)
    batch = _par_train_batch(dev)
    mine = {k: v[rank_rows(PAR_WORLD, PAR_WORLD, rank)] for k, v in batch.items()}
    layout = ShardLayout.build({n: p.shape for n, p in unet.named_parameters()}, mesh)
    stats = kernel_stats()
    result = {"parameters": sum(p.numel() for p in unet.parameters()),
              "sharded_leaves": len(layout.sharded)}
    for name, lay in (("dp", None), ("fsdp", layout)):
        for st in stats.values():
            st.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        state = create_train_state(unet, lay)
        step = make_train_step(unet, schedule, cfg, mesh, lay)
        timer = StageTimer(dev)
        t0 = time.perf_counter()
        state, m = step(state, mine, Draws.seeded([1, 1], dev), timer)
        torch.cuda.synchronize()
        result[name] = {"loss": float(m["loss_simple"]), "step_s": time.perf_counter() - t0,
                        "stages": timer.seconds,
                        "collective_s": timer.seconds["gather"] + timer.seconds["reduce"],
                        "peak_bytes": torch.cuda.max_memory_allocated(dev),
                        "backward_launches": check_backward_launches(
                            f"parallel_train {name} rank {rank}", stats)}
        if name == "dp":
            dp = {k: {n: layout.local(n, t).cpu() for n, t in getattr(state, k).items()}
                  for k in STATE_PARTS}
        else:
            result["fsdp_equals_dp"] = result["fsdp"]["loss"] == result["dp"]["loss"] and all(
                torch.equal(t.cpu(), dp[k][n]) for k in STATE_PARTS
                for n, t in getattr(state, k).items())
            full = {k: gather_state_dict(getattr(state, k), layout, mesh, keep=rank == 0)
                    for k in ("params", "exp_avg")}
        del state
        torch.cuda.empty_cache()
    del dp
    if rank == 0:
        state = create_train_state(unet)
        state, m = make_train_step(unet, schedule, cfg)(state, batch, Draws.seeded([1, 1], dev))
        rel = {}
        for k in ("params", "exp_avg"):
            num = den = 0.0
            for n, t in getattr(state, k).items():
                want = t.cpu().double()
                num += float((full[k][n].double() - want).pow(2).sum())
                den += float(want.pow(2).sum())
            rel[k] = (num / den) ** 0.5
        loss = float(m["loss_simple"])
        result["vs_one_process"] = {"loss": loss, "loss_rel": abs(result["fsdp"]["loss"] / loss - 1),
                                    "params_rel_l2": rel["params"], "grad_rel_l2": rel["exp_avg"]}
        del state
    _rank_done(mesh, out_dir, result)


def _nccl_world1(dev, plain):
    """(c)(i): the train_repeat step through the distributed DP and FSDP
    paths over NCCL at world size 1; both must equal the plain step (loss
    and state fingerprint) bit for bit."""
    from geo4d_tpu_torch.core.timing import StageTimer
    from geo4d_tpu_torch.parallel.mesh import init_distributed, shutdown_distributed
    from geo4d_tpu_torch.parallel.sharding import ShardLayout
    from geo4d_tpu_torch.core.draws import Draws
    from geo4d_tpu_torch.training.step import TrainConfig, create_train_state, make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_distributed("cuda", 1, rank=0, world_size=1, local_rank=0,
                                init_method="file://" + os.path.join(tmp, "store"))
        try:
            model, batch = flagship_train_setup(dev)
            layout = ShardLayout.build({n: p.shape for n, p in model.unet.named_parameters()},
                                       mesh)
            for name, lay in (("dp", None), ("fsdp", layout)):
                state = create_train_state(model.unet, lay)
                step = make_train_step(model.unet, model.schedule, TrainConfig(), mesh, lay)
                timer = StageTimer(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                state, m = step(state, batch, Draws.seeded([1, 1], dev), timer)
                run = (float(m["loss_simple"]), state_fingerprint(state))
                print(f"parallel_train nccl world 1 {name} ({mesh.backend}"
                      f"{', %d sharded leaves' % len(layout.sharded) if lay else ''}): loss "
                      f"{run[0]!r}, fingerprint {run[1]}, {'equal' if run == plain else 'UNLIKE'} "
                      f"the plain step; stage seconds "
                      f"{json.dumps({k: round(v, 4) for k, v in timer.seconds.items()})}, "
                      f"collectives {timer.seconds['gather'] + timer.seconds['reduce']:.4f} s; "
                      f"peak {torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
                if run != plain:
                    raise AssertionError(f"parallel_train: the NCCL world-1 {name} step differs "
                                         f"from the plain step")
                del state
                torch.cuda.empty_cache()
        finally:
            shutdown_distributed()
    del model, batch
    torch.cuda.empty_cache()


def _cli_two_ranks(dev):
    """(c)(iii): cli/train.py under torch.distributed.run, two gloo ranks on
    cuda:0 at PAR_NUM_RES_BLOCKS, --fsdp, 2 steps on the train phase's
    shards; rank 0 writes metrics.jsonl and ckpt_final, which loads into a
    one-process UNet."""
    import yaml

    from geo4d_tpu_torch.models.checkpoint import load_unet_weights
    from geo4d_tpu_torch.models.unet3d import UNet3D

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(repo, "configs", "inference_geo4d.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["model"]["params"]["unet_config"]["params"]["num_res_blocks"] = PAR_NUM_RES_BLOCKS
        with open(os.path.join(tmp, "reduced.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
        data, run = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        write_shards(data, 2, TRAIN_T, TRAIN_HW, seed=0)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               str(PAR_WORLD), "-m", "geo4d_tpu_torch.cli.train", "--data_dir", data,
               "--out_dir", run, "--steps", "2", "--batch_size", "1", "--config",
               os.path.join(tmp, "reduced.yaml"), "--fsdp", "--dist_backend", "gloo"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            if line.startswith("[train]"):
                print(f"parallel_train cli: {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr)
            raise AssertionError(f"parallel_train: the 2-rank CLI exited {proc.returncode}")
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if [r["step"] for r in rows if "loss_simple" in r] != [0, 1]:
            raise AssertionError(f"parallel_train: metrics.jsonl rows {rows}")
        with torch.device("meta"):
            unet = UNet3D(num_res_blocks=PAR_NUM_RES_BLOCKS)
        unet.to_empty(device=dev)
        load_unet_weights(unet, os.path.join(run, "ckpt_final"))
        if not all(bool(torch.isfinite(p).all()) for p in unet.parameters()):
            raise AssertionError("parallel_train: the 2-rank ckpt_final holds non-finite weights")
        ckpt_bytes = os.path.getsize(os.path.join(run, "ckpt_final"))
        del unet
    torch.cuda.empty_cache()
    print(f"parallel_train cli: torch.distributed.run, 2 gloo ranks on cuda:0, --fsdp, 2 steps: "
          f"wall {wall:.3f} s (rank start, model build, steps, checkpoint); losses "
          f"{[r['loss_simple'] for r in rows if 'loss_simple' in r]}; ckpt_final {ckpt_bytes} "
          f"bytes loaded into a one-process UNet", flush=True)


def parallel_phase(dev, plain_run):
    """Phase 17: the parallel layer (see the constants above). Returns the
    sub-phases' wall times."""
    from geo4d_tpu_torch.parallel.dryrun import dryrun_multiprocess

    walls = {}
    for platform, backend, where in (("cpu", None, "on the CPU"),
                                     ("cuda", "gloo", "sharing cuda:0 (bf16, the kernels)")):
        t0 = time.perf_counter()
        dryrun_multiprocess(PAR_WORLD, platform, backend)
        walls[f"parallel_dryrun_{platform}"] = time.perf_counter() - t0
        print(f"parallel_dryrun: {PAR_WORLD} gloo ranks {where} in "
              f"{walls[f'parallel_dryrun_{platform}']:.3f} s", flush=True)

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks, walls["parallel_infer"] = _spawn(_infer_rank, tmp)
    for r, res in enumerate(ranks):
        print(f"parallel_infer rank {r}: reconstruct wall {res['wall_s']:.4f} s, diffusion_s "
              f"{res['timing']['diffusion_s']:.4f}, alignment_s {res['timing']['alignment_s']:.4f}"
              f"; peak {res['peak_bytes']} bytes; launches {json.dumps(res['launches'])}",
              flush=True)
    cmp = ranks[0]["vs_one_process"]
    print(f"parallel_infer: gathered predictions against one process at window_batch "
          f"{PAR_WORLD}: {json.dumps(cmp)}; aligner final loss {ranks[0]['final_loss']!r}; "
          f"results directory {ranks[0]['export_s']:.2f} s; phase wall "
          f"{walls['parallel_infer']:.3f} s", flush=True)
    if any(v["rel_l2"] > PAR_INFER_REL_L2 for v in cmp.values()):
        raise AssertionError(f"parallel_infer: the ranks' predictions differ from one process "
                             f"(limit {PAR_INFER_REL_L2})")

    t0 = time.perf_counter()
    _nccl_world1(dev, plain_run)
    walls["parallel_train_nccl"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        ranks, walls["parallel_train_gloo"] = _spawn(_train_rank, tmp)
    for r, res in enumerate(ranks):
        for name in ("dp", "fsdp"):
            x = res[name]
            print(f"parallel_train gloo rank {r} {name}: loss {x['loss']!r}; step {x['step_s']:.4f}"
                  f" s, collectives {x['collective_s']:.4f} s, stages "
                  f"{json.dumps({k: round(v, 4) for k, v in x['stages'].items()})}; peak "
                  f"{x['peak_bytes']} bytes; backward launches "
                  f"{json.dumps(x['backward_launches'])}", flush=True)
        print(f"parallel_train gloo rank {r}: FSDP state equal to DP bit for bit: "
              f"{res['fsdp_equals_dp']}", flush=True)
    one = ranks[0]["vs_one_process"]
    print(f"parallel_train gloo: UNet of {ranks[0]['parameters']} parameters "
          f"(num_res_blocks {PAR_NUM_RES_BLOCKS}), {ranks[0]['sharded_leaves']} sharded leaves; "
          f"against one process at batch {PAR_WORLD}: loss {one['loss']!r} (relative "
          f"{one['loss_rel']:.3e}, limit {PAR_TRAIN_LOSS_REL}), averaged gradient (AdamW's first "
          f"moment) relative L2 {one['grad_rel_l2']:.3e} (limit {PAR_TRAIN_GRAD_REL}), updated "
          f"master weights relative L2 {one['params_rel_l2']:.3e} (limit {PAR_TRAIN_PARAM_REL}); "
          f"phase wall {walls['parallel_train_gloo']:.3f} s", flush=True)
    if not all(res["fsdp_equals_dp"] for res in ranks):
        raise AssertionError("parallel_train: the FSDP step differs from the DP step")
    if not (one["loss_rel"] <= PAR_TRAIN_LOSS_REL and one["grad_rel_l2"] <= PAR_TRAIN_GRAD_REL
            and one["params_rel_l2"] <= PAR_TRAIN_PARAM_REL):
        raise AssertionError("parallel_train: the 2-rank step differs from one process at batch 2")

    t0 = time.perf_counter()
    _cli_two_ranks(dev)
    walls["parallel_train_cli"] = time.perf_counter() - t0
    print(f"parallel: sub-phase walls {json.dumps({k: round(v, 3) for k, v in walls.items()})}",
          flush=True)
    return walls


def training_phases(dev):
    """Phases 12-16 (15b included); cuDNN is held to its deterministic algorithms, so that
    a training step repeats bit for bit. Returns the backward kernels' rows
    and totals and their launches in the train phase."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _, train_bwd, steps = train_phase(dev)
    launches = {k: sum(v.values()) for k, v in train_bwd.items()}
    vae_bwd = vae_train_phase(dev)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        results, totals = backward_phase(dev, train_bwd, steps, vae_bwd)
    plain_run = train_repeat_phase(dev)
    train_graph_phase(dev)
    train_reference_phase(dev)
    return results, totals, launches, plain_run

OFFLINE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                                "torch_offline", "expected")
OFFLINE_SEED = 0
# phase 19(b): the published sizes the offline tools run at
DSLR_WH = (1752, 1168)          # ScanNet++ DSLR (OPENCV_FISHEYE)
IPHONE_WH = (1920, 1440)        # ScanNet++ iPhone (OPENCV)
RASTER_TRIANGLES = 1_000_000
SENS_COLOR_WH, SENS_DEPTH_WH, SENS_FRAMES = (1296, 968), (640, 480), 10
HABITAT_ENV_HW, HABITAT_CROP_WH = (1024, 2048), (512, 512)


def write_results_dir(out_dir, n=20, hw=(256, 576), seed=0):
    """A results directory in save_results_dir's layout (pred_traj.txt,
    pred_intrinsics.txt, frame_*.npy / .png, conf_*.npy) of a seeded scene
    at the slice's size, for `--offline-only` runs that have no slice."""
    from geo4d_tpu_torch.data.images import write_png
    from geo4d_tpu_torch.evals.trajectory import Trajectory

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(out_dir)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = np.arange(n) * 0.05
    np.savetxt(os.path.join(out_dir, "pred_traj.txt"), Trajectory.from_matrices(poses).to_tum())
    np.savetxt(os.path.join(out_dir, "pred_intrinsics.txt"),
               np.tile([300.0, 0, w / 2, 0, 300.0, h / 2, 0, 0, 1], (n, 1)))
    for i in range(n):
        np.save(os.path.join(out_dir, f"frame_{i:04d}.npy"),
                rng.uniform(1, 5, (h, w)).astype(np.float32))
        np.save(os.path.join(out_dir, f"conf_{i:04d}.npy"),
                rng.uniform(0, 1, (h, w)).astype(np.float32))
        write_png(os.path.join(out_dir, f"frame_{i:04d}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return out_dir


def tessellated_room(rng, n_triangles):
    """A box room of half-size 3, each face a grid of quads, plus small
    random triangles inside: about n_triangles in all (half each)."""
    k = int(np.sqrt(n_triangles / 2 / 6 / 2))
    g = np.linspace(-3, 3, k + 1)
    u, v = np.meshgrid(g, g)
    a = (np.arange(k)[:, None] * (k + 1) + np.arange(k)[None]).ravel()   # quads' corners
    tri = np.concatenate([np.stack([a, a + 1, a + k + 2], -1),
                          np.stack([a, a + k + 2, a + k + 1], -1)])
    verts, faces = [], []
    for axis in range(3):
        for side in (-3.0, 3.0):
            p = np.zeros(((k + 1) ** 2, 3))
            p[:, axis] = side
            p[:, (axis + 1) % 3], p[:, (axis + 2) % 3] = u.ravel(), v.ravel()
            faces.append(tri + sum(len(x) for x in verts))
            verts.append(p)
    n_extra = n_triangles - sum(len(f) for f in faces)
    extra = rng.uniform(-2.5, 2.5, (n_extra, 1, 3)) + rng.normal(0, 0.02, (n_extra, 3, 3))
    faces.append(sum(len(x) for x in verts) + np.arange(3 * n_extra).reshape(-1, 3))
    verts.append(extra.reshape(-1, 3))
    return np.concatenate(verts).astype(np.float32), np.concatenate(faces).astype(np.int32)


def offline_phase(results_dir, work):
    """Phase 19: the offline tools and the viewer on the card's host, without
    OpenCV, Pillow, h5py or JAX. (a) every tool on the seeded raw data of
    tools/offline_check.py against the JAX package's committed outputs, and
    the HDF5 readers' errors; (b) each tool once at its published size, timed
    on the host clock, and the raster library against its numpy version;
    (c) the viewer over the slice's results directory through a stdlib
    websocket client."""
    import importlib.util

    from geo4d_tpu_torch.data import habitat_prep, jpeg, preprocess, preprocess_train
    from geo4d_tpu_torch.data import sens_reader
    from geo4d_tpu_torch.geometry import raster
    from geo4d_tpu_torch.tools import offline_check as oc
    from geo4d_tpu_torch.viz.server import ViewerServer
    from geo4d_tpu_torch.viz.visualizer import export_html, load_results_dir

    record = {}
    t0 = time.perf_counter()
    jpeg.build(jpeg.ENCODER_SOURCE)
    record["jpeg_encoder_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raster.build()
    record["raster_build_s"] = time.perf_counter() - t0

    # (a) parity with the committed JAX outputs
    raw, out = os.path.join(work, "offline_raw"), os.path.join(work, "offline_out")
    man = oc.write_raw(raw, OFFLINE_SEED)
    record["parity_s"] = {}
    for case in oc.CASES:
        record["parity_s"][case] = oc.run_case(case, raw, out, man, seed=OFFLINE_SEED)
        stats = oc.compare_trees(os.path.join(out, case), os.path.join(OFFLINE_FIXTURES, case))
        print(f"offline: {case}: the port's outputs equal the JAX package's committed ones "
              f"({json.dumps(stats)}; PNG pixels, JPEG/EXR bytes, arrays within "
              f"{oc.RTOL} rel + {oc.ATOL})", flush=True)
    had_h5py = importlib.util.find_spec("h5py") is not None
    saved = sys.modules.get("h5py")
    if had_h5py:                    # the check is of the error, so h5py is hidden
        sys.modules["h5py"] = None
    try:
        try:
            preprocess_train.megadepth_process_view(raw, "a.jpg", None, None, work)
            raise AssertionError("offline: MegaDepth ran without h5py")
        except RuntimeError as e:
            if str(e) != "megadepth depth maps need h5py":
                raise
            megadepth_err = str(e)
        try:
            preprocess.prepare_nyuv2(os.path.join(work, "nyu"))
            raise AssertionError("offline: prepare_nyuv2 ran without h5py")
        except ImportError as e:
            if "h5py" not in str(e):
                raise
            nyu_err = f"{type(e).__name__}: {e}"
    finally:
        if had_h5py:
            sys.modules.pop("h5py")
            if saved is not None:
                sys.modules["h5py"] = saved
    print(f"offline: h5py {'present (hidden for the check)' if had_h5py else 'absent'}; "
          f"prepare_megadepth raises RuntimeError: {megadepth_err}; prepare_nyuv2 raises "
          f"{nyu_err}", flush=True)

    # (b) published sizes
    rng = np.random.default_rng(OFFLINE_SEED)
    for name, model, (w, h), params in (
            ("dslr_fisheye", "OPENCV_FISHEYE", DSLR_WH,
             [789.6, 790.1, 876.3, 583.7, 0.025, -0.011, 0.002, -0.0005]),
            ("iphone", "OPENCV", IPHONE_WH, [1440.2, 1441.0, 960.4, 719.8, 0.05, -0.07,
                                             0.0003, -0.0002])):
        rgb = oc.smooth_image(rng, h, w)
        mask = np.full((h, w), 255, np.uint8)
        mask[100:300, 200:500] = 0
        t0 = time.perf_counter()
        _, _, new_K, rgb_u, mask_u = preprocess_train.scannetpp_undistort(
            [model, w, h, *params], rgb, mask)
        record[f"undistort_{name}_s"] = time.perf_counter() - t0
        if rgb_u.shape != (h, w, 3) or mask_u.shape != (h, w) or not (mask_u == 255).any():
            raise AssertionError(f"offline: undistort {name}: {rgb_u.shape} {mask_u.shape}")
    verts, faces = tessellated_room(rng, RASTER_TRIANGLES)
    K = np.array([[789.6, 0, DSLR_WH[0] / 2], [0, 790.1, DSLR_WH[1] / 2], [0, 0, 1]])
    t0 = time.perf_counter()
    depth = raster.render_mesh_depth(verts, faces, K, np.eye(4), DSLR_WH[::-1])
    record["raster_1m_s"] = time.perf_counter() - t0
    record["raster_covered"] = float((depth > 0).mean())
    if depth.shape != DSLR_WH[::-1] or record["raster_covered"] < 0.5:
        raise AssertionError(f"offline: raster at {DSLR_WH}: covered {record['raster_covered']}")
    small_v, small_f = oc.room_mesh(np.random.default_rng(OFFLINE_SEED))
    worst = 0.0
    for R, t in oc.raster_cameras(OFFLINE_SEED):
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        lib = raster.render_mesh_depth(small_v, small_f, oc.RASTER_K, c2w, oc.RASTER_HW)
        plain = raster.raster_depth_plain(small_v, small_f, oc.RASTER_K, c2w, oc.RASTER_HW)
        edge = float(((lib > 0) != (plain > 0)).mean())
        both = (lib > 0) & (plain > 0)
        rel = float((np.abs(lib[both] - plain[both]) / plain[both]).max())
        worst = max(worst, rel)
        if edge > oc.RASTER_EDGE_SHARE or rel > oc.RASTER_REL:
            raise AssertionError(f"offline: raster library vs numpy: edge share {edge}, "
                                 f"rel {rel}")
    record["raster_vs_plain_rel"] = worst
    sens_path = os.path.join(work, "big.sens")
    oc.write_sens(sens_path, rng, n=SENS_FRAMES, color_hw=SENS_COLOR_WH[::-1],
                  depth_hw=SENS_DEPTH_WH[::-1])
    for tag, size in (("sens_full", None), ("sens_640x480", SENS_DEPTH_WH[::-1])):
        t0 = time.perf_counter()
        n = sens_reader.export_scene(sens_path, os.path.join(work, tag), image_size=size)
        record[f"{tag}_s_per_frame"] = (time.perf_counter() - t0) / n
    env_color = oc.smooth_image(rng, *HABITAT_ENV_HW)
    env_dist = rng.uniform(1, 8, HABITAT_ENV_HW).astype(np.float32)
    cw, ch = HABITAT_CROP_WH
    f_px = cw / 2 / np.tan(np.radians(60.0) / 2)
    view = {"camera_intrinsics": [[f_px, 0, cw / 2 - 0.5], [0, f_px, ch / 2 - 0.5], [0, 0, 1]],
            "size": [cw, ch], "R_cam2world": np.eye(3).tolist(), "t_cam2world": [0.0, 0, 0]}
    meta = os.path.join(work, "habitat_metadata.json")
    with open(meta, "w") as f:
        json.dump({"view_batches": {"b0": {"v0": view}}}, f)
    t0 = time.perf_counter()
    habitat_prep.preprocess_metadata(meta, lambda pos: (env_color, env_dist),
                                     os.path.join(work, "habitat"), crop_resolution=(cw, ch))
    record["habitat_crop_512_s"] = time.perf_counter() - t0

    # (c) the viewer over the results directory
    t0 = time.perf_counter()
    clouds, _ = load_results_dir(results_dir, downsample=2, conf_thr=1e-3)
    record["viewer_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    html = export_html(results_dir, os.path.join(work, "viewer.html"))
    record["viewer_html_s"] = time.perf_counter() - t0
    record["viewer_html_bytes"] = os.path.getsize(html)
    t0 = time.perf_counter()
    srv = ViewerServer(results_dir, port=0).start()
    try:
        record["viewer_server_start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        meta_msg, frames = oc.fetch_viewer(srv.port)
        record["viewer_fetch_s"] = time.perf_counter() - t0
    finally:
        srv.stop()
    n_frames = json.loads(meta_msg)["n_frames"]
    counts = [struct.unpack("<II", frames[i][:8])[1] for i in range(n_frames)]
    want = [min(len(p), srv.store.max_points) for p, _ in clouds]
    if n_frames != len(clouds) or counts != want:
        raise AssertionError(f"offline: the viewer sent {n_frames} frames of {counts} points, "
                             f"load_results_dir gives {len(clouds)} of {want}")
    record["viewer_frames"], record["viewer_points"] = n_frames, sum(counts)
    print("offline " + json.dumps(record), flush=True)
    return record



def check_foreign():
    foreign = sorted(m for m, mod in sys.modules.items()
                     if mod is not None and m.split(".")[0] in FOREIGN_ROOTS)
    if foreign:
        raise AssertionError(f"the port imported JAX, OpenCV, Pillow, h5py or the JAX package: "
                             f"{foreign[:5]}")


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of geo4d_tpu_torch on one GPU")
    ap.add_argument("--shapes-to", help="write the slice's launches per (kernel, shape) here")
    ap.add_argument("--shapes-only", help="time only the (kernel, shape) list in this file")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 1-2 and the training phases 12-16 only")
    ap.add_argument("--longseq-only", action="store_true",
                    help="phases 1-2 and the long-sequence phase (18) only")
    ap.add_argument("--parallel-only", action="store_true",
                    help="phases 1-2, train_repeat (15) and the parallel phase (17) only")
    ap.add_argument("--offline-only", action="store_true",
                    help="phases 1-2 and the offline tools' phase (19) only")
    ap.add_argument("--aligner-only", action="store_true",
                    help="phases 1-2 and the aligner's objective kernel and graphs (20) only")
    ap.add_argument("--resolutions-only", action="store_true",
                    help="phases 1-2 and the resolutions phase (9) only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.modules["PIL"] = None       # import PIL now raises: the port must not need Pillow
    dev = torch.device("cuda", 0)
    torch.zeros((), device=dev)     # the allocator's memory statistics exist from here on
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    # full float32 for the plain float32 products (attention logits and the
    # CLIP resize); the model's own matmuls and convolutions run in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    from geo4d_tpu_torch.ops import dispatch

    t0 = time.perf_counter()
    dispatch.kernels()
    print(f"build: {dispatch.library_path()} in {time.perf_counter() - t0:.2f} s", flush=True)

    if args.shapes_only:
        with open(args.shapes_only) as f:
            saved = json.load(f)
        by_shape = {name: {tuple(key): n for key, n in rows} for name, rows in saved.items()}
        with torch.no_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            totals = shapes_phase(dev, by_shape)
        print(json.dumps({"totals": totals}))
        return 0
    if args.parallel_only:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        parallel_phase(dev, train_repeat_phase(dev))
        return 0
    if args.aligner_only:
        aligner_phase(dev)
        check_foreign()
        return 0
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, work, True)
    if args.offline_only:
        offline_phase(write_results_dir(os.path.join(work, "results")), work)
        check_foreign()
        return 0
    if args.longseq_only or args.resolutions_only:
        from geo4d_tpu_torch.cli.common import prepare_inference_params
        from geo4d_tpu_torch.models.presets import flagship, init_random_

        model = init_random_(flagship(), dev, seed=0).eval()
        text_ctx, _ = prepare_inference_params(model, PROMPT)
        if args.resolutions_only:
            resolutions_phase(dev, model, text_ctx)
        else:
            longseq_phase(dev, model)
        check_foreign()
        return 0
    if args.train_only:
        results, totals, launches, _ = training_phases(dev)
        print(json.dumps({"backward": {k: dict(results[k], **totals[k], launches=launches[k])
                                       for k in results}}))
        return 0
    with torch.no_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        results = kernel_phase(dev)
    results_dir = os.path.join(work, "slice_results")
    launches, by_shape, model, text_ctx, uncond_text_ctx, scene = slice_phase(dev, results_dir)
    evaluate_phase(dev, model, text_ctx, uncond_text_ctx, scene)
    del scene
    checked = resolutions_phase(dev, model, text_ctx)
    # the slice's shapes are checked (and timed) by the shapes phase
    checked |= {(k, key) for k, rows in by_shape.items() for key in rows}
    longseq_phase(dev, model, checked)
    torch.cuda.empty_cache()
    with torch.no_grad():
        attention_options_phase(dev, model, text_ctx)
    del model
    torch.cuda.empty_cache()
    inputs_phase(dev)
    offline_phase(results_dir, work)
    torch.cuda.empty_cache()
    if args.shapes_to:
        with open(args.shapes_to, "w") as f:
            json.dump({name: [[list(key), n] for key, n in rows.items()]
                       for name, rows in by_shape.items()}, f)
    with torch.no_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        totals = shapes_phase(dev, by_shape)
    with torch.no_grad():
        for name, opts in ATTENTION_OPTIONS.items():
            reference_phase(dev, name, **opts)
    align_reference_phase(dev)
    aligner_phase(dev)
    bwd_results, bwd_totals, bwd_launches, plain_run = training_phases(dev)
    parallel_phase(dev, plain_run)

    check_foreign()

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "shape": results[name]["shape"], "ms": results[name]["ms"],
         "cold_ms": results[name]["cold_ms"], "call_ms": results[name]["call_ms"],
         "plain_ms": results[name]["plain_ms"], "bound_ms": results[name]["bound"][0],
         "bound_by": results[name]["bound"][1], "library_ms": results[name]["library_ms"],
         **totals[name]}
        for name, (src, tpu) in KERNELS.items()] + [
        {"name": bname, "route": "cuda", "source": src, "replaces": tpu,
         "launches": bwd_launches[name], "max_abs_err": bwd_results[name]["max_abs_err"],
         "shape": bwd_results[name]["shape"], "ms": bwd_results[name]["ms"],
         "cold_ms": bwd_results[name]["cold_ms"], "plain_ms": bwd_results[name]["plain_ms"],
         "bound_ms": bwd_results[name]["bound"][0], "bound_by": bwd_results[name]["bound"][1],
         "library_ms": bwd_results[name]["library_ms"], **bwd_totals[name]}
        for name, (bname, src, tpu) in BWD_KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
