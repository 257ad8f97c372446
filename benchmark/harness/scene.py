"""Seeded inputs: a textured scene under a moving camera for the
reconstruct cells (uint8 frames on the host, as a frame directory gives
them), and training clips of every modality's maps (made on the device).
Every draw is keyed by (seed, index), so a seed gives the same inputs in
every run and every input of a run differs."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def words(seed: int, *more: int) -> list:
    """Seed words of a draw: the run's seed (any integer) and indices."""
    s = int(seed) % 2**64
    return [s & 0xFFFFFFFF, s >> 32, *map(int, more)]


def torch_seed(seed: int, *more: int, bits: int = 63) -> int:
    """A torch generator seed drawn from the words."""
    state = np.random.SeedSequence(words(seed, *more)).generate_state(1, np.uint64)[0]
    return int(state) >> (64 - bits)


def video(seed: int, index: int, frames: int, hw, pan_px, zoom: float,
          octaves) -> np.ndarray:
    """(frames, H, W, 3) uint8: a texture of a few octaves of smooth colour
    noise, seen by a camera that pans by `pan_px` (x, y) pixels a frame and
    zooms in by `zoom` a frame, in a direction drawn from the seed."""
    rng = np.random.default_rng(words(seed, index))
    h, w = hw
    margin = 1.0 + zoom * frames
    ch = int(np.ceil(h * margin + abs(pan_px[1]) * frames)) + 2
    cw = int(np.ceil(w * margin + abs(pan_px[0]) * frames)) + 2
    tex = torch.zeros((1, 3, ch, cw))
    for cells in octaves:
        g = torch.from_numpy(rng.standard_normal((1, 3, max(ch // cells, 2),
                                                  max(cw // cells, 2))).astype(np.float32))
        tex += F.interpolate(g, size=(ch, cw), mode="bicubic", align_corners=False)
    tex = torch.sigmoid(tex / np.sqrt(len(octaves)))
    sx, sy = rng.choice([-1.0, 1.0], size=2)
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        scale = margin - zoom * t
        bh, bw = h * scale, w * scale
        y0 = (ch - bh) / 2 + sy * pan_px[1] * (t - frames / 2)
        x0 = (cw - bw) / 2 + sx * pan_px[0] * (t - frames / 2)
        ys = torch.linspace(y0, y0 + bh - 1, h) / (ch - 1) * 2 - 1
        xs = torch.linspace(x0, x0 + bw - 1, w) / (cw - 1) * 2 - 1
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)[None]
        img = F.grid_sample(tex, grid, mode="bilinear", align_corners=True)[0]
        out[t] = (img.permute(1, 2, 0).clamp(0, 1) * 255.0 + 0.5).numpy().astype(np.uint8)
    return out


def clip(seed: int, index: int, batch: int, frames: int, hw, fields: dict, cells: int,
         fps: int, device) -> dict:
    """A training batch of raw maps: each field (B, T, H, W, C) in [-1, 1],
    smooth random fields drawn on the device at 1/`cells` of the
    resolution and upsampled; `fps` (B,)."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, index))
    h, w = hw
    out = {}
    for name, c in fields.items():
        low = torch.randn((batch * frames, c, max(h // cells, 2), max(w // cells, 2)),
                          generator=gen, device=device)
        x = torch.tanh(F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False))
        out[name] = x.permute(0, 2, 3, 1).reshape(batch, frames, h, w, c).contiguous()
    out["fps"] = torch.full((batch,), fps, dtype=torch.int32, device=device)
    return out
