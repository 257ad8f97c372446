"""ScanNet `.sens` stream reader + frame exporter: the port's copy of
geo4d_tpu/data/sens_reader.py, without OpenCV. Colour frames decode with
data/jpeg.py (OpenCV's and Pillow's pixels), shrink with
data/images.py::resize_area (OpenCV's INTER_AREA, bit for bit) and are
written at OpenCV's default quality 95 (the same bytes); depth frames shrink
with resize_nearest and are written as 16-bit PNG. Frames are held in RGB
where the JAX package holds OpenCV's BGR; the files are the same.

    python -m geo4d_tpu_torch.data.sens_reader --filename scene.sens \
        --output_path out/ [--frame_skip N] [--height H --width W]

Counterpart of the reference's
`datasets_preprocess/scannet_sens_reader.py` (SensorData v4 binary format).
Unlike the reference — which materializes every compressed frame in RAM
before exporting — this parser streams the file frame-by-frame (a .sens can
exceed 2 GB; the scannetv2 training download is 100 scenes), decoding and
writing each frame as it is read.

Format (little-endian, version 4):
  u32 version, u64 strlen, bytes sensor_name,
  4x f32[16] (color/depth intrinsic+extrinsic, row-major 4x4),
  i32 color_compression, i32 depth_compression,
  u32 color_w, u32 color_h, u32 depth_w, u32 depth_h,
  f32 depth_shift, u64 num_frames,
  then per frame: f32[16] camera_to_world, u64 ts_color, u64 ts_depth,
  u64 color_nbytes, u64 depth_nbytes, color bytes (jpeg), depth bytes
  (zlib'd u16).
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from geo4d_tpu_torch.data.images import jpeg_rgb, resize_area, resize_nearest, write_png
from geo4d_tpu_torch.data.jpeg import decode_jpeg, frame_marker, write_jpeg


@dataclass
class SensHeader:
    sensor_name: str
    intrinsic_color: np.ndarray   # (4,4) f32
    extrinsic_color: np.ndarray
    intrinsic_depth: np.ndarray
    extrinsic_depth: np.ndarray
    color_compression: int        # 2 == jpeg (the only one ScanNet ships)
    depth_compression: int        # 1 == zlib_ushort
    color_size: Tuple[int, int]   # (w, h)
    depth_size: Tuple[int, int]
    depth_shift: float            # depth[u16] / shift == meters
    num_frames: int


@dataclass
class SensFrame:
    index: int
    camera_to_world: np.ndarray   # (4,4) f32
    color_jpeg: bytes             # raw jpeg stream
    depth: np.ndarray             # (h, w) u16, millimeters (shift=1000)


def _read_mat4(f: io.BufferedReader) -> np.ndarray:
    return np.frombuffer(f.read(64), dtype="<f4").reshape(4, 4).copy()


def read_header(f: io.BufferedReader) -> SensHeader:
    (version,) = struct.unpack("<I", f.read(4))
    if version != 4:
        raise ValueError(f".sens version {version} unsupported (want 4)")
    (strlen,) = struct.unpack("<Q", f.read(8))
    name = f.read(strlen).decode("ascii", "replace")
    ic, ec, idp, edp = (_read_mat4(f) for _ in range(4))
    color_comp, depth_comp = struct.unpack("<ii", f.read(8))
    cw, ch, dw, dh = struct.unpack("<IIII", f.read(16))
    (shift,) = struct.unpack("<f", f.read(4))
    (n,) = struct.unpack("<Q", f.read(8))
    return SensHeader(name, ic, ec, idp, edp, color_comp, depth_comp,
                      (cw, ch), (dw, dh), shift, n)


def iter_frames(
    path: str, frame_skip: int = 1
) -> Iterator[Tuple[SensHeader, SensFrame]]:
    """Stream (header, frame) pairs, decoding only every `frame_skip`-th
    frame (skipped frames are seeked over without decompression)."""
    with open(path, "rb") as f:
        hdr = read_header(f)
        dw, dh = hdr.depth_size
        for i in range(hdr.num_frames):
            c2w = _read_mat4(f)
            f.read(16)  # the two u64 timestamps (unused downstream)
            c_n, d_n = struct.unpack("<QQ", f.read(16))
            if i % frame_skip:
                f.seek(c_n + d_n, os.SEEK_CUR)
                continue
            color = f.read(c_n)
            if hdr.depth_compression == 1:          # zlib_ushort
                depth_raw = zlib.decompress(f.read(d_n))
            elif hdr.depth_compression == 0:        # raw_ushort
                depth_raw = f.read(d_n)
            else:
                raise ValueError(
                    f"depth compression {hdr.depth_compression} unsupported"
                )
            depth = np.frombuffer(depth_raw, dtype="<u2").reshape(dh, dw)
            yield hdr, SensFrame(i, c2w, color, depth)


def export_scene(
    sens_path: str,
    output_dir: str,
    frame_skip: int = 1,
    image_size: Optional[Tuple[int, int]] = None,  # (h, w) resize for both
) -> int:
    """Export color/, depth/, pose/ and intrinsic/ in the reference
    scannet_sens_reader layout. Returns the number of frames written."""
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)

    n_written = 0
    hdr = None
    for hdr, fr in iter_frames(sens_path, frame_skip):
        if n_written == 0:
            for tag, mat in (
                ("intrinsic_color", hdr.intrinsic_color),
                ("extrinsic_color", hdr.extrinsic_color),
                ("intrinsic_depth", hdr.intrinsic_depth),
                ("extrinsic_depth", hdr.extrinsic_depth),
            ):
                np.savetxt(
                    os.path.join(output_dir, "intrinsic", f"{tag}.txt"), mat
                )
        rgb = decode_rgb(fr.color_jpeg, f"{sens_path} frame {fr.index}")
        depth = fr.depth
        if image_size is not None:
            h, w = image_size
            rgb = resize_area(rgb, (w, h))
            depth = resize_nearest(depth, (w, h))
        write_jpeg(os.path.join(output_dir, "color", f"{fr.index}.jpg"), rgb, 95)
        write_png(os.path.join(output_dir, "depth", f"{fr.index}.png"), depth)
        np.savetxt(
            os.path.join(output_dir, "pose", f"{fr.index}.txt"),
            fr.camera_to_world,
        )
        n_written += 1
    return n_written


def decode_rgb(data: bytes, name: str) -> np.ndarray:
    """A frame's JPEG as (H, W, 3) RGB, as OpenCV's IMREAD_COLOR decodes it
    (a grayscale frame repeated, CMYK converted as OpenCV converts it)."""
    return jpeg_rgb(decode_jpeg(data, name), "opencv", name, frame_marker(data))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="ScanNet .sens frame exporter")
    ap.add_argument("--filename", required=True)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--frame_skip", type=int, default=1)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)
    size = (args.height, args.width) if args.height and args.width else None
    n = export_scene(args.filename, args.output_path, args.frame_skip, size)
    print(f"exported {n} frames -> {args.output_path}")


if __name__ == "__main__":
    main()
