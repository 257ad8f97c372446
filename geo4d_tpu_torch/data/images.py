"""Image files without Pillow or OpenCV: PNG read and write, and the
Lanczos resize of 8-bit RGB frames, in numpy and the standard library's
zlib.

  read_png / decode_png   non-interlaced 8- and 16-bit grayscale, gray +
                          alpha, RGB and RGBA; every row filter (none, sub,
                          up, average, Paeth) undone; 16-bit samples are
                          big-endian in the file. Returns (H, W) for
                          grayscale, else (H, W, C), as uint8 or uint16.
  write_png / encode_png  8-bit grayscale (H, W) or RGB (H, W, 3), filter 0,
                          one IDAT chunk.
  write_gif / encode_gif  an animated GIF89a of palette-index frames with one
                          global 256-colour palette, looping; lossless (the
                          LZW stream holds every pixel as a literal code).
  lanczos_resize          uint8 (H, W, 3) -> (h, w, 3), bit for bit Pillow's
                          Image.resize(..., Image.LANCZOS): libImaging's
                          Resample.c coefficients (support 3 x max(scale, 1),
                          normalised per output pixel, then 22-bit fixed
                          point rounded half away from zero), a horizontal
                          pass, clipped to uint8, then a vertical pass.
  bicubic_resize          the same scheme with Pillow's BICUBIC filter (the
                          cubic convolution kernel with a = -0.5, support 2
                          x max(scale, 1)), bit for bit Image.BICUBIC.
Both also take a grayscale (H, W) image (Pillow's mode L).
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (3, palette, is not read)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# Pillow's fixed point for 8-bit images: 32 bits less 8 of data and 2 of headroom
PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0
BICUBIC_SUPPORT = 2.0
BICUBIC_A = -0.5


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a PNG file's bytes; `name` is used in errors."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} (palette) is not supported")
    if depth not in (8, 16):
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported (8 or 16)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * bpp + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = raw[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{name}: unknown PNG row filter {int(ftype.max())}")
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), ftype)
    if depth == 16:
        px = px.reshape(h, w * bpp).view(">u2").astype(np.uint16)
    px = px.reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters of (H, W, bpp) filtered bytes. A byte depends on
    the byte bpp to its left, the one above and the one above-left, so the
    pixels of one anti-diagonal (row r, pixel s - r) are independent: each
    step decodes one anti-diagonal across all rows, whatever their filters."""
    if not ftype.any():
        return raw
    h, w, bpp = raw.shape
    out = np.zeros((h + 1, w + 1, bpp), np.int32)    # row 0 and column 0: the zero border
    raw = raw.astype(np.int32)
    ft = ftype.astype(np.int32)
    for s in range(h + w - 1):
        r = np.arange(max(0, s - w + 1), min(h, s + 1))
        i = s - r
        a, b, c = out[r + 1, i], out[r, i + 1], out[r, i]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, i + 1] = (raw[r, i] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of an 8-bit grayscale (H, W) or RGB (H, W, 3) image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)     # filter byte 0 on every row
    rows[:, 1:] = img.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# a clear code after this many literals keeps the LZW code table below 512
# entries, so every code stays 9 bits wide
GIF_LITERALS_PER_CLEAR = 250


def _gif_lzw(indices: np.ndarray) -> bytes:
    """The image data of one frame of 8-bit palette indices: minimum code
    size 8, then 9-bit codes packed LSB first in sub-blocks of at most 255
    bytes: a clear code (256) before every GIF_LITERALS_PER_CLEAR literals,
    the end code (257) last."""
    px = indices.reshape(-1).astype(np.uint16)
    k = GIF_LITERALS_PER_CLEAR
    n_runs = -(-px.size // k)
    codes = np.full(px.size + n_runs + 1, 256, np.uint16)
    at = np.arange(px.size)
    codes[at + at // k + 1] = px
    codes[-1] = 257
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return b"\x08" + blocks + b"\x00"


def encode_gif(frames: np.ndarray, palette: np.ndarray, duration_ms: int) -> bytes:
    """GIF89a bytes of (T, H, W) uint8 palette indices with a (256, 3) uint8
    global palette, `duration_ms` a frame (stored in hundredths of a
    second), looping forever."""
    frames = np.asarray(frames)
    palette = np.asarray(palette, np.uint8)
    if frames.dtype != np.uint8 or frames.ndim != 3 or palette.shape != (256, 3):
        raise ValueError(f"encode_gif takes uint8 (T, H, W) indices and a (256, 3) palette, "
                         f"got {frames.dtype} {frames.shape} and {palette.shape}")
    t, h, w = frames.shape
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", duration_ms // 10) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_gif_lzw(f))
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames: np.ndarray, palette: np.ndarray, duration_ms: int) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, palette, duration_ms))


def _coeffs(in_size: int, out_size: int, support: float, weights) -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c `precompute_coeffs` + `normalize_coeffs_8bpc` for one
    axis and a filter of `support` whose values `weights` gives for an array
    of positions: (tap source indices (out, ksize), int64 coefficients (out,
    ksize)); taps past an output pixel's window carry coefficient 0."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C casts truncate toward zero, as int() does
    xmin = np.array([max(int(c - support + 0.5), 0) for c in center])
    xmax = np.array([min(int(c + support + 0.5), in_size) for c in center]) - xmin
    taps = np.arange(ksize)
    live = taps[None] < xmax[:, None]
    x = (taps[None] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)
    w = np.where(live, weights(x), 0.0)
    ww = np.zeros(out_size)
    for t in taps:                        # summed in the C loop's order
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + taps[None], in_size - 1)
    return idx, k


def _lanczos_weights(x: np.ndarray) -> np.ndarray:
    """The truncated sinc sinc(x) sinc(x / 3) on [-3, 3), with libm's sin."""
    flat = x.ravel()
    return np.fromiter((_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0 for v in flat),
                       np.float64, flat.size).reshape(x.shape)


def _bicubic_weights(x: np.ndarray) -> np.ndarray:
    """Resample.c `bicubic_filter`, in its operation order."""
    a = BICUBIC_A
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _resample(img: np.ndarray, size: Tuple[int, int], support: float, weights) -> np.ndarray:
    out_w, out_h = size
    h, w = img.shape[:2]
    x = np.asarray(img, np.uint8)
    gray = x.ndim == 2
    if gray:
        x = x[..., None]
    half = 1 << (PRECISION_BITS - 1)
    if out_w != w:
        idx, k = _coeffs(w, out_w, support, weights)
        acc = np.full((h, out_w, x.shape[2]), half, np.int64)
        for t in range(k.shape[1]):
            acc += x[:, idx[:, t]].astype(np.int64) * k[None, :, t, None]
        x = _clip8(acc)
    if out_h != h:
        idx, k = _coeffs(h, out_h, support, weights)
        acc = np.full((out_h,) + x.shape[1:], half, np.int64)
        for t in range(k.shape[1]):
            acc += x[idx[:, t]].astype(np.int64) * k[:, t, None, None]
        x = _clip8(acc)
    x = x[..., 0] if gray else x
    return x.copy() if np.shares_memory(x, img) else x


def lanczos_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize uint8 (H, W, 3) or (H, W) to size (W, H) with Pillow's LANCZOS
    filter, bit for bit."""
    return _resample(img, size, LANCZOS_SUPPORT, _lanczos_weights)


def bicubic_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize uint8 (H, W, 3) or (H, W) to size (W, H) with Pillow's BICUBIC
    filter, bit for bit."""
    return _resample(img, size, BICUBIC_SUPPORT, _bicubic_weights)
