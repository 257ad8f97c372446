"""JPEG files without Pillow: a decoder and an encoder in host C++
(csrc/jpeg_decode.cpp, csrc/jpeg_encode.cpp), built with g++ at first use
into build/geo4d_tpu_torch/ and loaded with ctypes.

The decoder computes what Pillow's libjpeg-turbo 3 computes by default, so
`read_jpeg(path)` equals `np.asarray(Image.open(path))` pixel for pixel:
baseline, extended, progressive (with libjpeg-turbo's block smoothing where
a scan script leaves coefficient bits unsent) and lossless Huffman files,
sequential and progressive arithmetic-coded files, every integral chroma
sampling ratio (4:4:4 to 4:1:1), grayscale, RGB, YCbCr, and CMYK or YCCK
(returned as Pillow shows CMYK: (H, W, 4), every sample inverted). What
Pillow refuses raises a ValueError that names the file and the mode:
12- and 16-bit samples, hierarchical files (SOF5-7, SOF13-15), lossless
arithmetic coding (SOF11), fractional sampling ratios and a height given in
a DNL marker.

The encoder writes libjpeg-turbo's baseline defaults (JFIF 1.01, the Annex K
tables scaled by quality, 4:2:0, islow FDCT, the standard Huffman tables),
so `encode_jpeg(rgb, q)` equals the bytes of Pillow's `Image.save(...,
quality=q)` and of OpenCV's `imwrite` at IMWRITE_JPEG_QUALITY q (95 when
OpenCV is given none). A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from geo4d_tpu_torch.core import hostlib

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "jpeg_decode.cpp"
ENCODER_SOURCE = CSRC / "jpeg_encode.cpp"
BUILD_DIR = hostlib.BUILD_DIR
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_ERR_LEN = 512
# Pillow's quality when none is given (libjpeg's default)
DEFAULT_QUALITY = 75


_LIBRARIES = {SOURCE: ("libjpeg_decode", "the JPEG decoder"),
              ENCODER_SOURCE: ("libjpeg_encode", "the JPEG encoder")}


def build(source: Path = SOURCE) -> Path:
    """Compile the decoder (or, given ENCODER_SOURCE, the encoder) with g++
    unless a library of the same source and flags exists; raises with the
    compiler's output if it fails."""
    stem, what = _LIBRARIES[source]
    return hostlib.build(source, stem, CXX_FLAGS, BUILD_DIR, what)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, size, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.jd_info.argtypes = [p, size, ip, ip, ip, ctypes.c_char_p, i]
    lib.jd_decode.argtypes = [p, size, p, ctypes.c_char_p, i]
    lib.jd_info.restype = lib.jd_decode.restype = i
    return lib


@functools.cache
def _encoder() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(ENCODER_SOURCE)))
    i = ctypes.c_int
    lib.je_encode.argtypes = [ctypes.c_void_p, i, i, i, i, ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_char_p, i]
    lib.je_encode.restype = ctypes.c_int64
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a JPEG file's bytes: (H, W) uint8 for grayscale, (H, W,
    3) RGB, or (H, W, 4) inverted CMYK (Pillow's view); `name` is used in
    errors."""
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jd_info(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
                   err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    if lib.jd_decode(data, len(data), out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out[..., 0] if ch.value == 1 else out


def frame_marker(data: bytes) -> int:
    """The frame header's marker (0xC0-0xCF: SOF0 baseline, SOF2
    progressive, SOF3 lossless, ...) of a JPEG file's bytes, 0 if none."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker
        if marker == 0xFF or marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 1 if marker == 0xFF else 2
            continue
        pos += 2 + (data[pos + 2] << 8 | data[pos + 3])
    return 0


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def encode_jpeg(img: np.ndarray, quality: int = DEFAULT_QUALITY) -> bytes:
    """Baseline JPEG bytes of a uint8 RGB (H, W, 3) or grayscale (H, W)
    image, as Pillow writes them at this quality."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    lib = _encoder()
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = 4096 + img.size        # most files fit; a larger one is asked for again
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.je_encode(img.ctypes.data, w, h, ch, int(quality), out.ctypes.data, cap,
                          err, _ERR_LEN)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def write_jpeg(path: str, img: np.ndarray, quality: int = DEFAULT_QUALITY) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
