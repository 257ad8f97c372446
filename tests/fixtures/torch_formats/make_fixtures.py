"""Writes the frame-file fixtures of the port's decoders: every JPEG and PNG
mode that the JAX package reads through Pillow or OpenCV. Needs Pillow,
OpenCV, g++ and the libjpeg-turbo development headers (jpeglib.h, with
arithmetic coding) of the machine that runs it; the lossless and 12-bit
files use Pillow's bundled libjpeg-turbo 3 (pillow.libs/libjpeg-*.so). Run
from the repo root:

    python tests/fixtures/torch_formats/make_fixtures.py

Files (96x64 unless the name says otherwise; `scene` draws them):

  prog_*.jpg        progressive Huffman (SOF2), written by Pillow (4:2:0,
                    4:4:4 with restarts, 4:2:2 with a restart every row, gray)
                    and OpenCV; prog_1024x436.jpg is the Sintel-size one
  smooth_*.jpg      progressive files whose scan script leaves coefficient
                    bits unsent, so libjpeg smooths the blocks (jpeg_writer)
  arith_*.jpg       arithmetic-coded sequential (SOF9) and progressive
                    (SOF10) files (jpeg_writer)
  h411_*.jpg        4:1:1 (luma 4x1) by jpeg_writer and by OpenCV
  cmyk.jpg          CMYK (Adobe transform 0), written by Pillow
  ycck.jpg          YCCK (Adobe transform 2), jpeg_writer
  lossless_*.jpg    lossless (SOF3), jpeg_writer with libjpeg-turbo 3
  palette*.png      palette PNG (8-bit, 8-bit with tRNS, 4-bit), by Pillow
  mode1.png         1-bit grayscale (Pillow mode "1")
  gray2.png, gray4.png, la16.png, adam7_*.png
                    2- and 4-bit grayscale, 16-bit gray + alpha and Adam7
                    interlaced files, written here (png_bytes)
  rgb16.png, rgba16.png, gray16.png
                    16-bit PNG, written by OpenCV
  refused_bits12.jpg
                    12-bit JPEG (SOF1), which Pillow refuses
  pixels.npz        per file NAME: NAME (np.asarray(Image.open(NAME)), but
                    for the large file), NAME:rgb (Pillow's convert("RGB"),
                    where it differs, and for the large file) and NAME:cv2
                    (OpenCV's imread as RGB, where it differs from Pillow's
                    RGB), these two as the SHA-256 of their bytes beside
                    NAME:rgb:shape and NAME:cv2:shape; NAME:cv2_refuses where
                    OpenCV refuses the file
"""

from __future__ import annotations

import glob
import hashlib
import os
import struct
import subprocess
import tempfile
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 64, 96
BIG = (436, 1024)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# jpeg_writer fixtures: file -> (mode, (h, w), channels, needs libjpeg-turbo 3)
WRITER = {
    "smooth_420.jpg": ("smooth", (H, W), 3, False),
    "smooth_dc_gray.jpg": ("smooth_dc", (H, W), 1, False),
    "smooth_dc_gray_17x9.jpg": ("smooth_dc", (9, 17), 1, False),
    "arith_420_rst5.jpg": ("arith_420_rst", (H, W), 3, False),
    "arith_prog_420.jpg": ("arith_prog", (H, W), 3, False),
    "arith_prog_gray_rows1.jpg": ("arith_prog_gray", (61, 97), 1, False),
    "h411_97x61.jpg": ("h411", (61, 97), 3, False),
    "ycck.jpg": ("ycck", (H, W), 4, False),
    "lossless_rgb_p6_rows1.jpg": ("lossless_rgb", (H, W), 3, True),
    "lossless_gray_p7_pt2.jpg": ("lossless_gray", (H, W), 1, True),
    "lossless_420_p1.jpg": ("lossless_420", (61, 97), 3, True),
    "refused_bits12.jpg": ("bits12", (16, 16), 3, True),
}
# Pillow-written progressive JPEGs: file -> ((h, w), gray, save settings)
PILLOW_PROGRESSIVE = {
    "prog_420_q85.jpg": ((H, W), False, dict(quality=85, subsampling=2)),
    "prog_444_rst3.jpg": ((H, W), False, dict(quality=90, subsampling=0,
                                               restart_marker_blocks=3)),
    "prog_422_rows1_95x61.jpg": ((61, 95), False, dict(quality=75, subsampling=1,
                                                        restart_marker_rows=1)),
    "prog_gray_97x63.jpg": ((63, 97), True, dict(quality=90)),
    "prog_1024x436.jpg": (BIG, False, dict(quality=90, subsampling=2)),
}


def scene(h: int, w: int, seed: int = 0, texture: bool = True) -> np.ndarray:
    """A (h, w, 3) uint8 picture: a sky gradient, a floor of bands, discs
    and, with `texture`, a fine pattern (so that a JPEG codes high
    frequencies)."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    horizon = 0.4 * h
    sky = np.stack([90 + 60 * yy / horizon, 140 + 50 * yy / horizon,
                    235 - 20 * yy / horizon], -1)
    dy = np.maximum(yy - horizon, 1.0)
    band = (0.5 + 0.5 * np.sin(0.35 * w / dy + 0.7 * seed))[..., None]
    floor = band * np.array([200.0, 185.0, 160.0]) + (1 - band) * np.array([80.0, 100.0, 70.0])
    img = np.where((yy < horizon)[..., None], sky, floor)
    img = img + 8 * texture * np.sin(xx * 1.3 + yy * 0.7 + seed)[..., None] * np.array([1.0, -0.6, 0.4])
    for cx, cy, r, col in ((0.3, 0.6, 0.18, (220, 40, 40)), (0.7, 0.45, 0.12, (30, 40, 200)),
                           (0.55, 0.8, 0.09, (240, 220, 30))):
        d = np.sqrt((xx - cx * w) ** 2 + (yy - cy * h) ** 2)
        edge = np.clip(r * min(h, w) + 0.5 - d, 0.0, 1.0)[..., None]
        img = edge * np.array(col, np.float64) + (1 - edge) * img
    return img.clip(0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(rows: np.ndarray, bpp: int, first_filter: int) -> bytes:
    """Each row with a PNG filter byte, the filters cycling none, sub, up,
    average, Paeth from `first_filter`."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for i, r in enumerate(rows.astype(np.int32)):
        f = (first_filter + i) % 5
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([f]) + ((r - pred) & 255).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * ch) samples -> (h, row bytes) at this bit depth."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, interlace: bool = False,
              plte: bytes = b"", trns: bytes = b"") -> bytes:
    """A PNG of (h, w, ch) samples (palette indices for colour type 3), every
    row filter in turn, Adam7 passes when `interlace`."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for k, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filter_rows(_pack(sub.reshape(sub.shape[0], -1), depth), bpp, k)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + (_chunk(b"PLTE", plte) if plte else b"")
            + (_chunk(b"tRNS", trns) if trns else b"") + _chunk(b"IDAT", zlib.compress(data, 9))
            + _chunk(b"IEND", b""))


def _build_writer(tmp: str, turbo3: bool) -> str:
    exe = os.path.join(tmp, "jpeg_writer3" if turbo3 else "jpeg_writer")
    cmd = ["g++", "-O2", os.path.join(HERE, "jpeg_writer.cpp"), "-o", exe]
    if turbo3:
        import PIL
        lib = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                     "libjpeg-*.so*"))[0]
        cmd += ["-DWITH_TURBO3", lib, f"-Wl,-rpath,{os.path.dirname(lib)}"]
    else:
        cmd += ["-ljpeg"]
    subprocess.run(cmd, check=True)
    return exe


def _write_with_writer(exe: str, mode: str, img: np.ndarray, path: str, tmp: str) -> None:
    raw = os.path.join(tmp, "in.raw")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    with open(raw, "wb") as f:
        f.write(f"{w} {h} {ch}\n".encode() + img.tobytes())
    subprocess.run([exe, mode, raw, path], check=True)


def write_files() -> None:
    import cv2
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        exes = {t: _build_writer(tmp, t) for t in (False, True)}
        for k, (name, (mode, (h, w), ch, turbo3)) in enumerate(sorted(WRITER.items())):
            img = scene(h, w, k)
            if ch == 1:
                img = img[..., 1]
            elif ch == 4:
                img = np.concatenate([img, img[..., :1] // 2 + 60], -1)
            _write_with_writer(exes[turbo3], mode, img, os.path.join(HERE, name), tmp)
    for k, (name, ((h, w), gray, kw)) in enumerate(sorted(PILLOW_PROGRESSIVE.items())):
        img = Image.fromarray(scene(h, w, 20 + k))
        (img.convert("L") if gray else img).save(os.path.join(HERE, name), "JPEG",
                                                   progressive=True, **kw)
    rgb = scene(H, W, 40)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    cv2.imwrite(os.path.join(HERE, "prog_cv2.jpg"), bgr, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cv2.imwrite(os.path.join(HERE, "h411_cv2.jpg"), bgr,
                [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    cmyk = np.concatenate([255 - rgb, np.minimum(255 - rgb.max(-1, keepdims=True), 90)], -1)
    Image.fromarray(cmyk, "CMYK").save(os.path.join(HERE, "cmyk.jpg"), "JPEG", quality=90)

    pal = Image.fromarray(scene(H, W, 41, False)).quantize(64)
    pal.save(os.path.join(HERE, "palette.png"))
    alpha = bytes(int(v) for v in np.linspace(0, 255, 64).astype(np.uint8))
    pal.save(os.path.join(HERE, "palette_trns.png"), transparency=alpha)
    Image.fromarray(scene(H, W, 42, False)).quantize(16).save(os.path.join(HERE, "palette_4bit.png"),
                                                       bits=4)
    Image.fromarray(scene(H, W, 43, False)[..., 0] > 128).save(os.path.join(HERE, "mode1.png"))
    gray = scene(H, W, 44, False)[..., 1].astype(np.int32)
    for depth in (2, 4):
        with open(os.path.join(HERE, f"gray{depth}.png"), "wb") as f:
            f.write(png_bytes((gray >> (8 - depth))[..., None], 0, depth))
    wide = scene(H, W, 45, False).astype(np.uint16) * 257 + np.arange(W, dtype=np.uint16)[:, None]
    la = np.stack([wide[..., 0], wide[..., 2]], -1)
    with open(os.path.join(HERE, "la16.png"), "wb") as f:
        f.write(png_bytes(la, 4, 16))
    cv2.imwrite(os.path.join(HERE, "rgb16.png"), np.ascontiguousarray(wide[..., ::-1]))
    cv2.imwrite(os.path.join(HERE, "rgba16.png"),
                np.concatenate([wide[..., ::-1], wide[..., :1]], -1))
    cv2.imwrite(os.path.join(HERE, "gray16.png"), wide[..., 1])
    # Adam7: 8-bit RGB, 16-bit gray and a 2-bit palette at an odd size
    with open(os.path.join(HERE, "adam7_rgb.png"), "wb") as f:
        f.write(png_bytes(scene(H, W, 46, False), 2, 8, interlace=True))
    with open(os.path.join(HERE, "adam7_gray16.png"), "wb") as f:
        f.write(png_bytes(wide[..., 1:2], 0, 16, interlace=True))
    idx = (scene(37, 53, 47, False)[..., 0] >> 6)[..., None]
    plte = bytes([10, 20, 30, 200, 40, 40, 40, 200, 40, 250, 250, 250])
    with open(os.path.join(HERE, "adam7_palette2_53x37.png"), "wb") as f:
        f.write(png_bytes(idx, 3, 2, interlace=True, plte=plte, trns=b"\x00\x80"))


def expected() -> dict:
    """The pixels each library decodes, keyed as the module docstring says."""
    import cv2
    from PIL import Image

    out = {}
    for name in sorted(os.listdir(HERE)):
        if not name.endswith((".jpg", ".png")) or name.startswith("refused_"):
            continue
        path = os.path.join(HERE, name)
        with Image.open(path) as im:
            raw, rgb = np.asarray(im), np.asarray(im.convert("RGB"))
        cv = cv2.imread(path, cv2.IMREAD_COLOR)
        if cv is None:                 # OpenCV refuses grayscale lossless JPEG
            out[f"{name}:cv2_refuses"] = np.array(True)
            cv = rgb
        else:
            cv = cv[..., ::-1]
        views = {"": raw, ":rgb": rgb, ":cv2": cv}
        if raw.size > 500000:
            assert np.array_equal(raw, rgb) and np.array_equal(rgb, cv), name
            views = {":rgb": rgb}
        elif raw.shape == rgb.shape and np.array_equal(raw, rgb):
            del views[":rgb"]
        if np.array_equal(rgb, cv):
            views.pop(":cv2", None)
        for key, img in views.items():
            if key:                    # the derived views by hash and shape
                out[f"{name}{key}"] = np.array(hashlib.sha256(img.tobytes()).hexdigest())
                out[f"{name}{key}:shape"] = np.array(img.shape)
            else:
                out[name] = img
    return out


def main() -> int:
    write_files()
    np.savez_compressed(os.path.join(HERE, "pixels.npz"), **expected())
    total = 0
    for f in sorted(os.listdir(HERE)):
        size = os.path.getsize(os.path.join(HERE, f))
        total += size
        print(f"{f}: {size} bytes")
    print(f"total {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
