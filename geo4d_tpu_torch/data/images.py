"""Image files without Pillow or OpenCV: PNG read and write, and the
Lanczos resize of 8-bit RGB frames, in numpy and the standard library's
zlib.

  read_png / decode_png   non-interlaced 8- and 16-bit grayscale, gray +
                          alpha, RGB and RGBA; every row filter (none, sub,
                          up, average, Paeth) undone; 16-bit samples are
                          big-endian in the file. Returns (H, W) for
                          grayscale, else (H, W, C), as uint8 or uint16.
  write_png / encode_png  8-bit grayscale (H, W), gray + alpha (H, W, 2), RGB
                          (H, W, 3) or RGBA (H, W, 4), or 16-bit grayscale
                          (H, W) (big-endian samples); filter 0, one IDAT
                          chunk. Pillow and OpenCV read back the same pixels.
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
  remap                   OpenCV's cv2.remap with float32 maps: bilinear or
                          nearest (half to even), uint8 or float32 images,
                          borders REFLECT_101, CONSTANT and WRAP, computed as
                          OpenCV 5 computes them (float32 lerps with fused
                          multiply-adds, no 1/32-pixel grid).
  resize_area             cv2.resize(..., INTER_AREA) of uint8 images when
                          shrinking: OpenCV's float32 area weights, summed in
                          its order, rounded half to even.
  resize_nearest          cv2.resize(..., INTER_NEAREST): source index
                          floor(x * (in / out)), clamped.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Tuple

import numpy as np

from geo4d_tpu_torch.data.jpeg import decode_jpeg, frame_marker

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (3: palette indices), and its bit depths
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# Pillow's fixed point for 8-bit images: 32 bits less 8 of data and 2 of headroom
PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0
BICUBIC_SUPPORT = 2.0
BICUBIC_A = -0.5


def png_header(data: bytes, name: str = "<bytes>") -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) of a PNG file's bytes."""
    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{name}: not a PNG file")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, ctype, interlace


def decode_png(data: bytes, name: str = "<bytes>", palette_indices: bool = False) -> np.ndarray:
    """The pixels of a PNG file's bytes; `name` is used in errors. A palette
    image is expanded to RGB, or to RGBA where it has a tRNS chunk, unless
    `palette_indices`, which returns its (H, W) uint8 indices."""
    w, h, depth, ctype, interlace = png_header(data, name)
    pos, plte, trns, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if not idat:
        raise ValueError(f"{name}: PNG without IDAT")
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or interlace > 1:
        raise ValueError(f"{name}: PNG colour type {ctype} at bit depth {depth} (interlace "
                         f"{interlace}) is not a valid PNG mode")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                px[y0::dy, x0::dx], pos = _decode_pass(raw, pos, pw, ph, ch, depth, name)
    else:
        px, _ = _decode_pass(raw, 0, w, h, ch, depth, name)
    if ctype == 3:
        if palette_indices:
            return px[..., 0]
        colours = np.zeros((256, 4), np.uint8)     # missing entries are black, opaque
        colours[:, 3] = 255
        entries = np.frombuffer(plte, np.uint8)[:768].reshape(-1, 3)
        colours[:len(entries), :3] = entries
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            colours[:len(alpha), 3] = alpha
        return colours[px[..., 0], :4 if trns is not None else 3]
    if depth < 8:                                  # grayscale: 0/255, x85 or x17
        px = px * np.uint8(255 // ((1 << depth) - 1))
    return px[..., 0] if ch == 1 else px


def _decode_pass(raw: np.ndarray, pos: int, w: int, h: int, ch: int, depth: int,
                 name: str) -> Tuple[np.ndarray, int]:
    """One (sub)image of w x h pixels from the decompressed stream at `pos`:
    (H, W, ch) samples (uint16 at depth 16, else uint8, unscaled), and the
    position after it."""
    bits = ch * depth
    bpp = max(1, bits // 8)                        # the filters' byte distance
    row = -(-w * bits // 8)
    end = pos + h * (row + 1)
    if raw.size < end:
        raise ValueError(f"{name}: truncated PNG image data")
    rows = raw[pos:end].reshape(h, row + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{name}: unknown PNG row filter {int(ftype.max())}")
    px = _unfilter(rows[:, 1:].reshape(h, row // bpp, bpp), ftype).reshape(h, row)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    elif depth < 8:                                # packed samples, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((px[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    return px.reshape(h, w, ch), end


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


def read_png(path: str, palette_indices: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path, palette_indices)


# the library whose decode a reader reproduces: Pillow's Image.open(path)
# .convert("RGB"), or OpenCV's cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
CONVENTIONS = ("pillow", "opencv")


def _check_convention(convention: str) -> None:
    if convention not in CONVENTIONS:
        raise ValueError(f"convention must be one of {CONVENTIONS}, got {convention!r}")


def cmyk_to_rgb(cmyk: np.ndarray, convention: str) -> np.ndarray:
    """(H, W, 4) CMYK as Pillow shows a CMYK JPEG (decode_jpeg's output) ->
    (H, W, 3) uint8 RGB: Pillow's convert("RGB") (255 - K less C scaled by
    255 - K, its MULDIV255 rounding) or OpenCV's imread (on libjpeg's inverted
    samples c, k: k - ((255 - c) * k >> 8)). The two differ by an LSB."""
    _check_convention(convention)
    v = cmyk.astype(np.int32)
    if convention == "pillow":
        nk = 255 - v[..., 3:]
        t = v[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    raw = 255 - v
    k = raw[..., 3:]
    return (k - (((255 - raw[..., :3]) * k) >> 8)).astype(np.uint8)


def _png_rgb(img: np.ndarray, depth: int, ctype: int, convention: str) -> np.ndarray:
    """read_png's output -> (H, W, 3) uint8: 16-bit samples keep their high
    byte, except Pillow's 16-bit grayscale (mode I;16), which it clips to
    255; grayscale repeated, alpha dropped."""
    if depth == 16:
        img = (np.minimum(img, 255) if convention == "pillow" and ctype == 0
               else img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    return np.ascontiguousarray(np.repeat(img[..., :1], 3, -1) if img.shape[2] < 3
                                else img[..., :3])


def read_rgb(path: str, convention: str = "pillow") -> np.ndarray:
    """A PNG or JPEG file (by its extension) as (H, W, 3) uint8 RGB, bit for
    bit what `convention`'s library gives: every PNG mode (palette, 1-16 bit,
    Adam7) and every JPEG that data/jpeg.py decodes. The conventions differ
    on CMYK JPEG and 16-bit grayscale PNG."""
    _check_convention(convention)
    with open(path, "rb") as f:
        data = f.read()
    if not path.lower().endswith(".png"):
        return jpeg_rgb(decode_jpeg(data, path), convention, path, frame_marker(data))
    _, _, depth, ctype, _ = png_header(data, path)
    return _png_rgb(decode_png(data, path), depth, ctype, convention)


def jpeg_rgb(img: np.ndarray, convention: str, name: str, marker: int) -> np.ndarray:
    """decode_jpeg's output (frame header `marker`) -> (H, W, 3) uint8 RGB
    as `convention`'s library gives it: grayscale repeated, CMYK converted.
    OpenCV refuses a grayscale lossless file (libjpeg-turbo 3 will not
    expand it to colour): so does this."""
    _check_convention(convention)
    if img.ndim == 2:
        if convention == "opencv" and marker == 0xC3:
            raise ValueError(f"{name}: OpenCV's imread refuses grayscale lossless JPEG (SOF3)")
        return np.ascontiguousarray(np.repeat(img[..., None], 3, -1))
    return cmyk_to_rgb(img, convention) if img.shape[2] == 4 else img


def read_pillow(path: str) -> np.ndarray:
    """A PNG or JPEG file as `np.asarray(Image.open(path))` gives it: JPEG
    grayscale (H, W), RGB, or inverted CMYK (H, W, 4); PNG palette indices,
    mode "1" as bool, 16-bit grayscale as uint16 (mode I;16), other 16-bit
    modes as their high bytes (grayscale + alpha as RGBA: L, L, L, A)."""
    with open(path, "rb") as f:
        data = f.read()
    if not path.lower().endswith(".png"):
        return decode_jpeg(data, path)
    _, _, depth, ctype, _ = png_header(data, path)
    img = decode_png(data, path, palette_indices=True)
    if depth == 1 and ctype == 0:
        return img > 0
    if depth == 16 and ctype != 0:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:
            img = img[..., [0, 0, 0, 1]]
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 (H, W), (H, W, 2), (H, W, 3) or (H, W, 4) image
    (gray, gray + alpha, RGB, RGBA) or a uint16 (H, W) grayscale one."""
    img = np.ascontiguousarray(img)
    ch = 1 if img.ndim == 2 else img.shape[2] if img.ndim == 3 else 0
    if not ((img.dtype == np.uint8 and ch in _COLOUR_TYPE)
            or (img.dtype == np.uint16 and img.ndim == 2)):
        raise ValueError(f"encode_png takes uint8 (H, W[, 2|3|4]) or uint16 (H, W), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    data = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img
    rows = np.zeros((h, 1 + data[0].size), np.uint8)     # filter byte 0 on every row
    rows[:, 1:] = data.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.itemsize, _COLOUR_TYPE[ch], 0, 0, 0)
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


BORDERS = ("reflect101", "constant", "wrap")


def _border_index(i: np.ndarray, n: int, border: str) -> np.ndarray:
    """Source indices of an axis of n pixels under OpenCV's border rule;
    for "constant", out-of-range indices are left as they are."""
    if border == "wrap":
        return np.mod(i, n)
    if border == "reflect101":
        if n == 1:
            return np.zeros_like(i)
        i = np.mod(i, 2 * (n - 1))
        return np.where(i >= n, 2 * (n - 1) - i, i)
    return i


def _fetch(img: np.ndarray, yi: np.ndarray, xi: np.ndarray, border: str,
           border_value: float) -> np.ndarray:
    h, w = img.shape[:2]
    yb, xb = _border_index(yi, h, border), _border_index(xi, w, border)
    if border != "constant":
        return img[yb, xb].astype(np.float32)
    inside = (yb >= 0) & (yb < h) & (xb >= 0) & (xb < w)
    v = img[np.clip(yb, 0, h - 1), np.clip(xb, 0, w - 1)].astype(np.float32)
    v[~inside] = border_value
    return v


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          interpolation: str = "linear", border: str = "constant",
          border_value: float = 0.0) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR | INTER_NEAREST,
    borderMode=BORDER_REFLECT_101 | BORDER_CONSTANT | BORDER_WRAP,
    borderValue=border_value) for a uint8 or float32 (H, W) or (H, W, C)
    image and float32 (h, w) maps. Bilinear: x0 = floor(x), a = x - x0, the
    four taps fetched under the border rule (a tap out of range takes
    border_value under "constant"), then a + ax (b - a) along x and along y
    in float32 with fused multiply-adds; uint8 rounds half to even and
    saturates. Nearest: the tap at x rounded half to even."""
    if interpolation not in ("linear", "nearest") or border not in BORDERS:
        raise ValueError(f"remap: interpolation {interpolation!r}, border {border!r}")
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"remap takes uint8 or float32 images, got {img.dtype}")
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    if interpolation == "nearest":
        out = _fetch(img, np.rint(my).astype(np.int64), np.rint(mx).astype(np.int64), border,
                     border_value)
    else:
        fx, fy = np.floor(mx), np.floor(my)
        x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
        ax, ay = mx - fx, my - fy
        if img.ndim == 3:
            ax, ay = ax[..., None], ay[..., None]
        v00, v01 = _fetch(img, y0, x0, border, border_value), _fetch(img, y0, x0 + 1, border,
                                                                     border_value)
        v10, v11 = _fetch(img, y0 + 1, x0, border, border_value), _fetch(img, y0 + 1, x0 + 1,
                                                                         border, border_value)
        top, bottom = _fma(ax, v01 - v00, v00), _fma(ax, v11 - v10, v10)
        out = _fma(ay, bottom - top, top)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def _area_weights(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's computeResizeAreaTab: the (output, source, float32 weight)
    entries of one axis, in its order (a partial first cell, whole cells,
    a partial last cell, per output pixel)."""
    scale = 1.0 / (n_out / n_in)
    dst, src, wgt = [], [], []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            dst.append(d), src.append(s1 - 1), wgt.append((s1 - f1) / cell)
        for s in range(s1, s2):
            dst.append(d), src.append(s), wgt.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            dst.append(d), src.append(s2), wgt.append(min(min(f2 - s2, 1.0), cell) / cell)
    return np.array(dst), np.array(src), np.array(wgt, np.float32)


def _area_sum(x: np.ndarray, n_out: int, axis: int, first_product: bool) -> np.ndarray:
    """Sum weighted source lines into n_out output lines along `axis` in
    float32, each output's terms added in table order."""
    dst, src, wgt = _area_weights(x.shape[axis], n_out)
    x = np.moveaxis(x, axis, 0)
    out = np.zeros((n_out,) + x.shape[1:], np.float32)
    rank = np.arange(len(dst)) - np.searchsorted(dst, dst)   # position within its output
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        term = x[src[sel]] * wgt[sel].reshape((-1,) + (1,) * (x.ndim - 1))
        out[dst[sel]] = term if (r == 0 and first_product) else out[dst[sel]] + term
    return np.moveaxis(out, 0, axis)


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size (W, H), interpolation=INTER_AREA) of a uint8
    (H, W) or (H, W, C) image to a smaller or equal size. Integer factors
    average each cell ((sum + 2) >> 2 at 2x2, else the float32 mean rounded
    half to even); other factors weight each source pixel by its overlap
    with the output cell, rows summed first, as OpenCV does."""
    out_w, out_h = (int(v) for v in size)
    h, w = img.shape[:2]
    if img.dtype != np.uint8 or out_w > w or out_h > h or out_w < 1 or out_h < 1:
        raise ValueError(f"resize_area shrinks uint8 images, got {img.dtype} {img.shape} -> "
                         f"({out_h}, {out_w}); INTER_AREA enlarging is not supported")
    sx, sy = w / out_w, h / out_h
    if sx == int(sx) and sy == int(sy):
        ix, iy = int(sx), int(sy)
        cells = img.astype(np.int64).reshape((out_h, iy, out_w, ix) + img.shape[2:])
        total = cells.sum(axis=(1, 3))
        if ix == 2 and iy == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        mean = total.astype(np.float32) * np.float32(1.0 / (ix * iy))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    rows = _area_sum(img.astype(np.float32), out_w, 1, first_product=False)
    out = _area_sum(rows, out_h, 0, first_product=True)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size (W, H), interpolation=INTER_NEAREST): output
    pixel x takes source floor(x * (1 / (out_w / in_w))), clamped."""
    h, w = img.shape[:2]
    out_w, out_h = (int(v) for v in size)
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
    return img[ys][:, xs]
