"""JPEG frames without Pillow: csrc/jpeg_decode.cpp (a baseline and
extended-sequential Huffman decoder in host C++), built with g++ at first
use into build/geo4d_tpu_torch/ and loaded with ctypes.

It computes what Pillow's libjpeg-turbo computes by default (the integer
islow IDCT, fancy chroma upsampling, libjpeg's fixed-point YCbCr -> RGB), so
`read_jpeg(path)` equals `np.asarray(Image.open(path))` pixel for pixel.
Progressive, lossless and arithmetic-coded files raise a ValueError that
names the file and the mode. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "jpeg_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "geo4d_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_ERR_LEN = 512


def library_path() -> Path:
    """The library's path, named by a hash of the source and the flags (an
    edited source builds anew)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libjpeg_decode_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder with g++ unless a library of the same source and
    flags exists; raises with the compiler's output if it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"the JPEG decoder could not be built (g++ {proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    os.replace(tmp, out)          # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, size, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.jd_info.argtypes = [p, size, ip, ip, ip, ctypes.c_char_p, i]
    lib.jd_decode.argtypes = [p, size, p, ctypes.c_char_p, i]
    lib.jd_info.restype = lib.jd_decode.restype = i
    return lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a JPEG file's bytes: (H, W) uint8 for grayscale, else
    (H, W, 3) RGB; `name` is used in errors."""
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


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
