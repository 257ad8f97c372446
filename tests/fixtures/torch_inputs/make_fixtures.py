"""Writes the input fixtures of the port's frame and video loaders (needs
Pillow, OpenCV and the FFmpeg development libraries; run from the repo root):

    python tests/fixtures/torch_inputs/make_fixtures.py

  frame_<k>_<mode>.jpg  five 288x128 frames of a synthetic scene (a sky
                        gradient, a floor of soft bands in perspective, moving
                        discs), each saved by Pillow with its own settings
                        (JPEG_SETTINGS: sampling, quality, restart interval,
                        grayscale, optimised Huffman tables)
  jpeg_pixels.npz       Pillow's decode of each, keyed by file name
  clip.mp4              20 frames of the scene at 288x128, 24 fps, written by
                        OpenCV (MPEG-4 part 2)
  clip_decode.npz       frames 0, 9 and 19 of the clip as the repo's native
                        FFmpeg decoder gives them at the clip's own size
                        (`frames`, with `index`)
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 128, 288
N_CLIP = 20
CLIP_FRAMES = (0, 9, 19)
# file mode -> Pillow save settings
JPEG_SETTINGS = {
    "444_q95": dict(quality=95, subsampling=0),
    "422_q50_rst2": dict(quality=50, subsampling=1, restart_marker_blocks=2),
    "420_q95_rst5": dict(quality=95, subsampling=2, restart_marker_blocks=5, optimize=True),
    "420_q75_rows1": dict(quality=75, subsampling=2, restart_marker_rows=1),
    "gray_q90": dict(quality=90, gray=True),
}


def scene(t: int) -> np.ndarray:
    """Frame t (uint8 (H, W, 3)) of the synthetic scene."""
    yy, xx = np.mgrid[:H, :W].astype(np.float64)
    horizon = 50
    sky = np.stack([90 + 60 * yy / horizon, 140 + 50 * yy / horizon,
                    235 - 20 * yy / horizon], -1)
    # floor: soft bands at depth z = k / (y - horizon), moving towards the camera
    dy = np.maximum(yy - horizon, 1.0)
    band = 0.5 + 0.5 * np.sin(400.0 / dy * 0.6 + 0.4 * t)[..., None]
    shade = np.clip(0.4 + dy / 90.0, 0.4, 1.0)[..., None]
    floor = (band * np.array([200.0, 185.0, 160.0]) + (1 - band) * np.array([80.0, 100.0, 70.0]))
    img = np.where((yy < horizon)[..., None], sky, floor * shade)
    for cx, cy, r, col in ((60 + 6 * t, 80, 18, (220, 40, 40)), (200 - 4 * t, 60, 12, (30, 40, 200)),
                           (150, 95 - t, 9, (240, 220, 30))):
        edge = np.clip(r + 0.5 - np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2), 0.0, 1.0)[..., None]
        img = edge * np.array(col, np.float64) + (1 - edge) * img
    return img.clip(0, 255).astype(np.uint8)


def main() -> int:
    import cv2
    from PIL import Image

    pixels = {}
    for k, (mode, kw) in enumerate(JPEG_SETTINGS.items()):
        kw = dict(kw)
        gray = kw.pop("gray", False)
        img = Image.fromarray(scene(4 * k))
        name = f"frame_{k}_{mode}.jpg"
        (img.convert("L") if gray else img).save(os.path.join(HERE, name), "JPEG", **kw)
        with Image.open(os.path.join(HERE, name)) as im:
            pixels[name] = np.asarray(im)
    np.savez_compressed(os.path.join(HERE, "jpeg_pixels.npz"), **pixels)

    clip = os.path.join(HERE, "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 24, (W, H))
    for t in range(N_CLIP):
        writer.write(scene(t)[..., ::-1].copy())
    writer.release()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from geo4d_tpu_torch.data.video import load_video

    frames, fps = load_video(clip, 1, (H, W))
    assert frames.shape == (N_CLIP, H, W, 3) and fps == 24, (frames.shape, fps)
    np.savez_compressed(os.path.join(HERE, "clip_decode.npz"),
                        frames=frames[list(CLIP_FRAMES)], index=np.asarray(CLIP_FRAMES))
    for f in sorted(os.listdir(HERE)):
        print(f"{f}: {os.path.getsize(os.path.join(HERE, f))} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
