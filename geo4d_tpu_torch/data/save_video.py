"""Video grids, port of geo4d_tpu/data/save_video.py (the reference's
utils/save_video.py `save_video_grid`, which the training sample logger
calls). The JAX package encodes mp4 through OpenCV; the port writes an
uncompressed RGB24 AVI with the standard library alone: a RIFF header, one
top-down BGR frame a chunk (a negative DIB height; rows padded to 4
bytes), and an idx1 index.
The frames are stored exactly.
"""

from __future__ import annotations

import os
import struct
from typing import Sequence

import numpy as np

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) % 2)


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def encode_avi(frames: np.ndarray, fps: int = 8) -> bytes:
    """AVI bytes of (T, H, W, 3) uint8 RGB frames, uncompressed 24-bit
    (BI_RGB) at `fps` frames a second."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"encode_avi takes uint8 (T, H, W, 3) frames, got {frames.dtype} "
                         f"{frames.shape}")
    t, h, w, _ = frames.shape
    stride = (w * 3 + 3) // 4 * 4
    size = stride * h
    avih = struct.pack("<14I", 1_000_000 // fps, size * fps, 0, AVIF_HASINDEX, t, 0, 1, size,
                       w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"DIB " + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, 1, fps, 0, t, size, -1, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    rows = np.zeros((h, stride), np.uint8)
    movi, index, offset = [], [], 4          # offsets count from the "movi" fourcc
    for f in frames:
        rows[:, :w * 3] = f[:, :, ::-1].reshape(h, w * 3)       # top-down BGR
        movi.append(_chunk(b"00db", rows.tobytes()))
        index.append(b"00db" + struct.pack("<III", AVIIF_KEYFRAME, offset, size))
        offset += len(movi[-1])
    body = hdrl + _list(b"movi", b"".join(movi)) + _chunk(b"idx1", b"".join(index))
    return _chunk(b"RIFF", b"AVI " + body)


def frames_to_avi(path: str, frames: np.ndarray, fps: int = 8) -> str:
    """(T, H, W, 3) float in [-1, 1] or uint8 -> an uncompressed AVI at `path`."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = ((np.clip(frames, -1, 1) + 1) / 2 * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_avi(frames, fps))
    return path


def save_video_grid(path: str, videos: Sequence[np.ndarray], fps: int = 8, ncols: int = 4):
    """Tile a batch of (T, H, W, 3) videos into one grid video (`ncols`
    columns, row by row, the first video's length and dtype) at `path`."""
    videos = [np.asarray(v) for v in videos]
    t, h, w = videos[0].shape[:3]
    n = len(videos)
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.zeros((t, nrows * h, ncols * w, 3), videos[0].dtype)
    for i, v in enumerate(videos):
        r, c = divmod(i, ncols)
        grid[:, r * h:(r + 1) * h, c * w:(c + 1) * w] = v[:t]
    return frames_to_avi(path, grid, fps)
