"""End-to-end video -> 4D pipeline, port of geo4d_tpu/pipeline/inference.py:
sliding 16-frame windows, conditioned DDIM sampling, the 4-head geometry
decode, masking, denormalisation and Plücker cameras (WindowPredictor), then
group alignment (`align_predictions`); `reconstruct` runs both.

`predict_video` runs the CLIP tower and the VAE encoder once per unique
frame and gathers the results into windows; the resampler runs per window
because its query bank depends on the frame's position in the window. Its
outputs stay on the device into the aligner.

Across ranks (`mesh=`, from `parallel.mesh.init_distributed`), windows run
in chunks of max(window_batch, world) rounded up to a multiple of the world
size; each rank runs its rows of every chunk (`rank_rows`) and the outputs
are gathered to every rank in window order, as the JAX package shards each
chunk's windows over its mesh. Every rank draws each chunk's random numbers
for all of the chunk's rows from the same seeded generator and keeps its
own (`core.draws.RankDraws`), so n ranks draw what one process draws at
window_batch = n. What
precedes the UNet is computed for all rows on every rank: `predict_video`'s
CLIP tokens and VAE latents of every frame, `predict_windows`' conditioning
of the whole chunk (the JAX package replicates the video).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from geo4d_tpu_torch.alignment.init import init_from_group
from geo4d_tpu_torch.alignment.optimizer import AlignerConfig, GroupAligner
from geo4d_tpu_torch.core.draws import Draws, RankDraws
from geo4d_tpu_torch.core.timing import count, request, stage
from geo4d_tpu_torch.geometry.normalize import (
    denormalize_inverse_depth,
    denormalize_pointcloud_bbox2,
    far_mask,
    sky_mask,
)
from geo4d_tpu_torch.geometry.rays import cameras_from_plucker
from geo4d_tpu_torch.models.diffusion import GeoDiffusion
from geo4d_tpu_torch.parallel.mesh import Mesh, rank_rows


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Eval preset (the JAX package's InferenceConfig)."""

    window: int = 16
    stride: int = 4
    ddim_steps: int = 5
    ddim_eta: float = 0.0
    cfg_scale: float = 1.0
    cfg_img: Optional[float] = None
    timestep_spacing: str = "uniform_trailing"
    guidance_rescale: float = 0.7
    sky_value: float = 1.05
    sky_eps: float = 0.35
    far_value: float = 1.99
    denorm_alpha: float = 2.0
    denorm_beta: float = 2.0
    invalid_conf: float = 999.0
    window_batch: int = 1          # windows per UNet call
    sample_posterior: bool = True  # False: VAE posterior mode (deterministic)


def sliding_windows(n_frames: int, window: int = 16, stride: int = 4) -> np.ndarray:
    """(G, window) frame indices: starts every `stride` frames plus a forced
    tail window covering the last `window` frames."""
    if n_frames < window:
        raise ValueError(f"need >= {window} frames, got {n_frames}")
    starts = list(range(0, n_frames - window + 1, stride))
    if starts[-1] != n_frames - window:
        starts.append(n_frames - window)
    return np.stack([np.arange(s, s + window) for s in starts])


def _to_unit_range(frames: torch.Tensor) -> torch.Tensor:
    """uint8 0..255 -> [-1, 1] float32 (the host expression of the JAX
    package); float frames pass through."""
    if frames.dtype == torch.uint8:
        return (frames.float() / 255.0 - 0.5) * 2.0
    return frames.float()


class WindowPredictor:
    """Runs the diffusion stage for batches of windows on one device, or on
    each rank of a `mesh` its rows of every chunk of windows."""

    def __init__(self, model: GeoDiffusion, config: InferenceConfig = InferenceConfig(),
                 device=None, mesh: Optional[Mesh] = None):
        self.model = model
        self.cfg = config
        self.mesh = mesh
        self.device = torch.device(device) if device is not None else next(model.parameters()).device

    @torch.no_grad()
    def _tail(self, ctx, uncond, z_video, fs, generator, x_T, timer):
        cfg = self.cfg
        samples = self.model.sample_window(
            ctx, z_video, fs, generator=generator, uncond_context=uncond[0],
            uncond_img_context=uncond[1], num_steps=cfg.ddim_steps,
            timestep_spacing=cfg.timestep_spacing, eta=cfg.ddim_eta, cfg_scale=cfg.cfg_scale,
            cfg_img=cfg.cfg_img, guidance_rescale=cfg.guidance_rescale, x_T=x_T, timer=timer)
        with stage(timer, "decode"):
            dec = self.model.decode_geometry(samples)
        with stage(timer, "postprocess"):
            return self._postprocess(dec)

    def _uncond(self, text_ctx, uncond_text_ctx, img_ctx, g, t, frame_shape):
        """CFG branches: uncond = empty-prompt text + zero-image tokens (the
        multi-cond image-uncond branch is [empty text | real image])."""
        cfg = self.cfg
        if cfg.cfg_scale == 1.0:
            return None, None
        zeros = torch.zeros((1, t) + tuple(frame_shape), device=self.device)
        zero_img = self.model.embed_frames(zeros).expand(g, -1, -1)
        uncond = torch.cat([uncond_text_ctx.expand(g, -1, -1), zero_img], dim=1)
        uncond_img = None
        if cfg.cfg_img is not None and cfg.cfg_img != 1.0:
            uncond_img = torch.cat([uncond_text_ctx.expand(g, -1, -1), img_ctx], dim=1)
        return uncond, uncond_img

    def _postprocess(self, dec: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        pc = dec["pointmap_conf"]
        pts, conf_raw = pc[..., :3], pc[..., 3]
        conf = F.softplus(conf_raw)
        invalid = sky_mask(pts, cfg.sky_value, cfg.sky_eps) | far_mask(pts, cfg.far_value)
        conf = torch.where(invalid, torch.full_like(conf, cfg.invalid_conf), conf)
        inv_conf = torch.where(invalid, torch.zeros_like(conf), 1.0 / conf)
        pts = denormalize_pointcloud_bbox2(pts, cfg.denorm_alpha, cfg.denorm_beta)
        inv_depth = denormalize_inverse_depth(dec["inv_depth"][..., 0])
        traj = torch.stack([cameras_from_plucker(r, m)[0]
                            for r, m in zip(dec["raymap"], dec["crossmap"])])
        # finite guards: degenerate samples must not poison the aligner
        return {
            "pts3d": torch.clamp(torch.nan_to_num(pts, nan=0.0, posinf=1e4, neginf=-1e4),
                                 -1e4, 1e4),
            "conf": torch.clamp(torch.nan_to_num(inv_conf, nan=0.0), 0.0, 1e6),
            "valid": ~invalid,
            "inv_depth": torch.nan_to_num(inv_depth, nan=0.0),
            "traj": torch.nan_to_num(traj, nan=0.0),
        }

    def _chunks(self, g_total: int):
        """(start, windows, rows) of each UNet call over `g_total` windows;
        counts each call ("window_chunks") and the rows it runs beyond its
        windows ("window_rows_padded"), `core.timing`."""
        bs = self.cfg.window_batch
        if self.mesh is not None:
            world = self.mesh.world_size
            bs = -(-max(bs, world) // world) * world
        for start in range(0, g_total, bs):
            n = min(bs, g_total - start)
            count("window_chunks")
            count("window_rows_padded", bs - n)
            yield start, n, bs

    def _rows(self, bs: int) -> slice:
        """The rows of a bs-row chunk that this rank runs."""
        if self.mesh is None:
            return slice(0, bs)
        return rank_rows(bs, self.mesh.world_size, self.mesh.rank)

    def _sampler_draws(self, gen: torch.Generator):
        """The sampler's noise: a rank draws it for the whole chunk and keeps
        its rows, so that it consumes `gen` as one process does."""
        if self.mesh is None:
            return gen
        return RankDraws(Draws(gen), self.mesh.world_size, self.mesh.rank)

    def _gather(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            return out
        return {k: self.mesh.gather_rows(v) for k, v in out.items()}

    @staticmethod
    def _pad(x: torch.Tensor, pad: int) -> torch.Tensor:
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x

    @staticmethod
    def _take(uncond, rows: slice):
        return tuple(None if u is None else u[rows] for u in uncond)

    @torch.no_grad()
    def predict_windows(self, frames_windows: np.ndarray, text_ctx: np.ndarray, fps: int,
                        seed: int = 123, uncond_text_ctx: Optional[np.ndarray] = None,
                        x_T: Optional[np.ndarray] = None, timer=None) -> Dict[str, np.ndarray]:
        """Diffusion for (G, T, H, W, 3) window stacks (uint8 or [-1, 1]).
        `x_T` (G, T, h, w, 16) fixes each window's initial noise."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        sampler_draws = self._sampler_draws(gen)
        text = torch.as_tensor(text_ctx, dtype=torch.float32, device=dev)
        uncond_text = text if uncond_text_ctx is None else torch.as_tensor(
            uncond_text_ctx, dtype=torch.float32, device=dev)
        outs: List[Dict[str, np.ndarray]] = []
        for start, n, bs in self._chunks(frames_windows.shape[0]):
            frames = self._pad(_to_unit_range(torch.as_tensor(
                frames_windows[start:start + n], device=dev)), bs - n)
            g, t = frames.shape[:2]
            rows = self._rows(bs)
            with stage(timer, "conditioning"):
                img_ctx = self.model.embed_frames(frames)
                ctx = torch.cat([text.expand(g, -1, -1), img_ctx], dim=1)
                enc_gen = gen if self.cfg.sample_posterior else None
                z_video = self.model.encode_first_stage(frames, enc_gen)
                uncond = self._uncond(text, uncond_text, img_ctx, g, t, frames.shape[2:])
            xt = None
            if x_T is not None:
                xt = self._pad(torch.as_tensor(x_T[start:start + n], dtype=torch.float32,
                                               device=dev), bs - n)[rows]
            fs = torch.full((rows.stop - rows.start,), fps, dtype=torch.int32, device=dev)
            out = self._tail(ctx[rows], self._take(uncond, rows), z_video[rows], fs,
                             sampler_draws, xt, timer)
            outs.append({k: v[:n].cpu().numpy() for k, v in self._gather(out).items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    @torch.no_grad()
    def predict_video(self, frames: np.ndarray, groups: np.ndarray, text_ctx: np.ndarray,
                      fps: int, seed: int = 123, uncond_text_ctx: Optional[np.ndarray] = None,
                      return_device: bool = False, timer=None) -> Dict[str, object]:
        """Diffusion over sliding windows of a (N, H, W, 3) video (uint8 or
        [-1, 1]); `groups` (G, T) holds each window's frame indices. With
        `return_device` the outputs stay torch tensors on the device."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        sampler_draws = self._sampler_draws(gen)
        text = torch.as_tensor(text_ctx, dtype=torch.float32, device=dev)
        uncond_text = text if uncond_text_ctx is None else torch.as_tensor(
            uncond_text_ctx, dtype=torch.float32, device=dev)
        video = _to_unit_range(torch.as_tensor(frames, device=dev))
        with stage(timer, "clip"):
            tokens = self.model.clip_tokens_chunked(video)               # (N, 257, width)
        with stage(timer, "vae_encode"):
            enc_gen = gen if self.cfg.sample_posterior else None
            z_frames = self.model.encode_frames_chunked(video, enc_gen)  # (N, h, w, 4)
        gidx_all = torch.as_tensor(np.asarray(groups), dtype=torch.long, device=dev)
        outs: List[Dict[str, torch.Tensor]] = []
        for start, n, bs in self._chunks(gidx_all.shape[0]):
            rows = self._rows(bs)
            gidx = self._pad(gidx_all[start:start + n], bs - n)[rows]
            g, t = gidx.shape
            with stage(timer, "resampler"):
                img_ctx = self.model.resample_tokens(tokens[gidx])      # (G, T*16, ctx)
                ctx = torch.cat([text.expand(g, -1, -1), img_ctx], dim=1)
                uncond = self._uncond(text, uncond_text, img_ctx, g, t, video.shape[1:])
            fs = torch.full((g,), fps, dtype=torch.int32, device=dev)
            out = self._tail(ctx, uncond, z_frames[gidx], fs, sampler_draws, None, timer)
            outs.append({k: v[:n] for k, v in self._gather(out).items()})
        merged = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        if return_device:
            return merged
        return {k: v.cpu().numpy() for k, v in merged.items()}


def align_predictions(groups: np.ndarray, preds: Dict[str, object], imshape,
                      aligner_config: AlignerConfig = AlignerConfig(),
                      intrinsics: Optional[np.ndarray] = None, verbose: bool = False,
                      timer=None, device=None) -> GroupAligner:
    """Group alignment of window predictions (the `predict_*` dict: pts3d,
    conf, inv_depth, traj; tensors or numpy) into one scene: build the
    aligner, preset known focals, initialise, run both phases. Runs on
    `device`; by default on the predictions' device when they are tensors,
    else on the CUDA device (an error where there is none). The
    initialisation takes the device-resident path whatever the inputs, as
    `reconstruct` does in the JAX package."""
    aligner = GroupAligner(groups, preds["pts3d"], preds["conf"], imshape,
                           invdepth=preds["inv_depth"], trajs=preds["traj"],
                           config=aligner_config, device=device)
    if intrinsics is not None:
        aligner.preset_focal([(K[0, 0] + K[1, 1]) / 2 for K in intrinsics])
    init_from_group(aligner, aligner.buf["pred_pts"], aligner.buf["weights"], verbose=verbose,
                    timer=timer)
    aligner.run(verbose=verbose, timer=timer)
    return aligner


def reconstruct(model: GeoDiffusion, frames: np.ndarray, text_ctx: np.ndarray, fps: int = 24,
                inference_config: InferenceConfig = InferenceConfig(),
                aligner_config: AlignerConfig = AlignerConfig(), seed: int = 123,
                intrinsics: Optional[np.ndarray] = None, mesh: Optional[Mesh] = None,
                verbose: bool = False, uncond_text_ctx: Optional[np.ndarray] = None,
                timer=None, device=None):
    """Full pipeline: windows -> diffusion -> group alignment, on the
    model's device. frames (T, H, W, 3): uint8 0..255 or float [-1, 1];
    text_ctx (1, 77, ctx) the precomputed text context.

    The JAX package's signature without `params`: the module carries its
    weights. Returns (scene aligner, raw window predictions as device
    tensors, timing dict with diffusion_s, alignment_s, frames and
    sec_per_frame). With a `mesh`, the ranks share the windows
    (WindowPredictor) and every rank gets all the predictions; rank 0 alone
    aligns them (the JAX package's single controller aligns once) and the
    other ranks return (None, predictions, timing) with alignment_s 0. With a
    span recorder installed (`core.timing`), the call is one request,
    `reconstruct`."""
    t_total, h, w = frames.shape[:3]
    groups = sliding_windows(t_total, inference_config.window, inference_config.stride)
    predictor = WindowPredictor(model, inference_config, device=device, mesh=mesh)
    dev = predictor.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with request("reconstruct"):
        sync()
        t0 = time.perf_counter()
        preds = predictor.predict_video(frames, groups, text_ctx, fps, seed,
                                        uncond_text_ctx=uncond_text_ctx, return_device=True,
                                        timer=timer)
        sync()
        t_diffusion = time.perf_counter() - t0
        aligner, t_align = None, 0.0
        if mesh is None or mesh.rank == 0:
            t0 = time.perf_counter()
            aligner = align_predictions(groups, preds, (h, w), aligner_config, intrinsics,
                                        verbose=verbose, timer=timer)
            sync()
            t_align = time.perf_counter() - t0
    timing = {
        "diffusion_s": t_diffusion,
        "alignment_s": t_align,
        "frames": float(t_total),
        "sec_per_frame": (t_diffusion + t_align) / t_total,
    }
    return aligner, preds, timing
