"""Frame loading for the port's CLI, as uint8 (the pipeline normalises on the
device): the port's copy of geo4d_tpu/data/video.py's image-directory loader
and native video decode, without OpenCV.

A frame file is read as Pillow's Image.open(f).convert("RGB") reads it,
without Pillow: every PNG mode by data/images.py (palette, 1- to 16-bit,
Adam7; 16-bit samples keep their high byte, 16-bit grayscale clips to 255)
and every JPEG that Pillow decodes by data/jpeg.py (progressive,
arithmetic-coded, lossless, 4:1:1, CMYK with Pillow's conversion); then it
is Lanczos-resized by data/images.py (Pillow's resize, bit for bit).

Video files go through the repo's C++ FFmpeg decoder (native/video_decoder.cpp,
built on first use, loaded with ctypes), which resizes at decode time.
Where FFmpeg's development libraries are missing, a video file is an error
that says so: pass a directory of PNG or JPEG frames instead.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
from typing import List, Sequence, Tuple

import numpy as np

from geo4d_tpu_torch.data.images import lanczos_resize, read_rgb

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_NATIVE_LIB = os.path.join(_NATIVE_DIR, "libgeo4d_video.so")
FFMPEG_LIBS = ["libavformat", "libavcodec", "libavutil", "libswscale"]


def _native_decoder():
    """The decoder library, built from native/ if it is not there yet (with
    native/build.sh's flags, into a temporary file renamed into place, so a
    concurrent build or load never sees a partial library)."""
    if not os.path.exists(_NATIVE_LIB):
        try:
            probe = subprocess.run(["pkg-config", "--cflags", "--libs", *FFMPEG_LIBS],
                                   capture_output=True, text=True, timeout=60)
        except FileNotFoundError as e:
            raise RuntimeError("video files need the FFmpeg development libraries, found "
                               "through pkg-config, which is not installed; pass a "
                               "directory of PNG or JPEG frames instead") from e
        if probe.returncode != 0:
            raise RuntimeError(f"video files need the FFmpeg development libraries "
                               f"({', '.join(FFMPEG_LIBS)}), which pkg-config does not find "
                               "here; pass a directory of PNG or JPEG frames instead. "
                               f"pkg-config said: {probe.stderr.strip()[-2000:]}")
        tmp = f"{_NATIVE_LIB}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                               "video_decoder.cpp", "-o", tmp, *probe.stdout.split()],
                              cwd=_NATIVE_DIR, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError("the native video decoder could not be built against FFmpeg; "
                               "pass a directory of PNG or JPEG frames instead. g++ said:\n"
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, _NATIVE_LIB)
    lib = ctypes.CDLL(_NATIVE_LIB)
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.vd_fps.restype = ctypes.c_double
    lib.vd_fps.argtypes = [ctypes.c_void_p]
    lib.vd_read_frames.restype = ctypes.c_int
    lib.vd_read_frames.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_int, ctypes.c_int]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    return lib


def load_video(path: str, frame_stride: int, video_size: Tuple[int, int],
               max_frames: int = -1) -> Tuple[np.ndarray, int]:
    """Decode every `frame_stride`-th frame at video_size (H, W) -> ((T, H,
    W, 3) uint8, effective fps). With max_frames > 0 a short video is padded
    by repeating its last frame."""
    lib = _native_decoder()
    h, w = video_size
    handle = lib.vd_open(path.encode(), w, h)
    if not handle:
        raise FileNotFoundError(f"the native decoder cannot open {path}")
    try:
        fps = lib.vd_fps(handle)
        cap = max_frames if max_frames > 0 else 100000
        buf = np.empty((cap, h, w, 3), np.uint8)
        n = lib.vd_read_frames(handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               cap, frame_stride)
    finally:
        lib.vd_close(handle)
    if n == 0:
        raise ValueError(f"no frames decoded from {path}")
    # copy an under-filled buffer so the full-capacity one is freed
    frames = buf[:n] if n == cap else buf[:n].copy()
    if max_frames > 0 and n < max_frames:
        frames = np.concatenate([frames, np.repeat(frames[-1:], max_frames - n, axis=0)])
    return frames, int(fps / frame_stride)


def load_image_dir(dir_path: str, video_size: Tuple[int, int], max_frames: int = -1,
                   exts: Sequence[str] = (".png", ".jpg", ".jpeg")
                   ) -> Tuple[np.ndarray, List[str]]:
    """The files of a directory with an extension in `exts` (PNG or JPEG),
    in name order, each read as Pillow's Image.open(f).convert("RGB") reads
    it and resized to video_size (W, H) with Lanczos -> ((T, H, W, 3)
    uint8, file names)."""
    files = sorted(f for f in glob.glob(os.path.join(dir_path, "*"))
                   if os.path.splitext(f)[1].lower() in exts)
    if max_frames > 0:
        files = files[:max_frames]
    if not files:
        raise FileNotFoundError(f"no images in {dir_path}")
    return np.stack([lanczos_resize(read_rgb(f, "pillow"), video_size) for f in files]), files
