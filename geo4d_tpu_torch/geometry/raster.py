"""Mesh -> depth rendering on the host: the port's copy of
geo4d_tpu/geometry/raster.py (ScanNet++'s ground-truth depth, rasterised
from the laser-scan mesh at each camera).

`render_mesh_depth` calls the repo's C++ z-buffer rasteriser
(native/mesh_raster.cpp: perspective-correct 1/z interpolation, pixel
centres at integer coordinates, an edge tolerance of 1e-5), compiled with
native/build.sh's flags by g++ at first use into build/geo4d_tpu_torch/ and
loaded with ctypes. A failed build raises with g++'s output: there is no
fallback. `raster_depth_plain` is the same computation in numpy, one
triangle at a time, for tests and the card's comparison.

`load_ply_mesh` reads the binary-little-endian (or ASCII) triangle PLY that
ScanNet++ ships.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np

from geo4d_tpu_torch.core import hostlib

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "mesh_raster.cpp"
BUILD_DIR = hostlib.BUILD_DIR
# native/build.sh's release flags
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def build() -> Path:
    """Compile the rasteriser unless a library of the same source and flags
    exists; raises with g++'s output if it fails."""
    return hostlib.build(SOURCE, "libgeo4d_raster", CXX_FLAGS, BUILD_DIR,
                         "the mesh rasteriser")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fp, i64, i32, f = (ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_float)
    lib.raster_depth.argtypes = [fp, i64, ctypes.POINTER(ctypes.c_int32), i64, fp, f, f, f, f,
                                 i32, i32, f, f, fp]
    lib.raster_depth.restype = None
    return lib


def _camera(verts, faces, K, cam2world):
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    w2c = np.ascontiguousarray(np.linalg.inv(cam2world), np.float32)
    return verts, faces, w2c, (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))


def render_mesh_depth(
    verts: np.ndarray,      # (V, 3) world-space float
    faces: np.ndarray,      # (F, 3) int
    K: np.ndarray,          # (3, 3)
    cam2world: np.ndarray,  # (4, 4) OpenCV convention (+z forward)
    size_hw: Tuple[int, int],
    znear: float = 0.05,
    zfar: float = 20.0,
) -> np.ndarray:
    """Depth map (H, W) float32 of the mesh seen from the camera; 0 where
    no geometry lies in [znear, zfar]."""
    H, W = size_hw
    verts, faces, w2c, (fx, fy, cx, cy) = _camera(verts, faces, K, cam2world)
    fp = ctypes.POINTER(ctypes.c_float)
    out = np.zeros((H, W), np.float32)
    _library().raster_depth(
        verts.ctypes.data_as(fp), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        w2c.ctypes.data_as(fp), fx, fy, cx, cy, W, H, znear, zfar, out.ctypes.data_as(fp))
    return out


def raster_depth_plain(verts, faces, K, cam2world, size_hw, znear: float = 0.05,
                       zfar: float = 20.0) -> np.ndarray:
    """render_mesh_depth in numpy, one triangle at a time (small meshes):
    the plain version the library is held to."""
    H, W = size_hw
    verts, faces, w2c, (fx, fy, cx, cy) = _camera(verts, faces, K, cam2world)
    cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    valid = z > 1e-9
    iz = np.where(valid, 1.0 / np.maximum(z, 1e-9), -1.0)
    sx = fx * cam[:, 0] * iz + cx
    sy = fy * cam[:, 1] * iz + cy
    zbuf = np.full((H, W), np.inf, np.float32)
    for a, b, c in faces:
        if not (valid[a] and valid[b] and valid[c]):
            continue
        xs = np.array([sx[a], sx[b], sx[c]])
        ys = np.array([sy[a], sy[b], sy[c]])
        izs = np.array([iz[a], iz[b], iz[c]])
        ix0, ix1 = max(0, int(np.floor(xs.min()))), min(W - 1, int(np.ceil(xs.max())))
        iy0, iy1 = max(0, int(np.floor(ys.min()))), min(H - 1, int(np.ceil(ys.max())))
        if ix0 > ix1 or iy0 > iy1:
            continue
        area = (xs[1] - xs[0]) * (ys[2] - ys[0]) - (xs[2] - xs[0]) * (ys[1] - ys[0])
        if abs(area) < 1e-12:
            continue
        gx, gy = np.meshgrid(np.arange(ix0, ix1 + 1), np.arange(iy0, iy1 + 1))
        w0 = ((xs[1] - gx) * (ys[2] - gy) - (xs[2] - gx) * (ys[1] - gy)) / area
        w1 = ((xs[2] - gx) * (ys[0] - gy) - (xs[0] - gx) * (ys[2] - gy)) / area
        w2 = 1.0 - w0 - w1
        eps = -1e-5      # an edge through a pixel centre covers it
        inside = (w0 >= eps) & (w1 >= eps) & (w2 >= eps)
        inv_z = w0 * izs[0] + w1 * izs[1] + w2 * izs[2]
        with np.errstate(divide="ignore"):
            zpix = np.where(inv_z > 0, 1.0 / inv_z, np.inf)
        zpix = np.where(inside & (zpix >= znear) & (zpix <= zfar), zpix, np.inf)
        patch = zbuf[iy0:iy1 + 1, ix0:ix1 + 1]
        np.minimum(patch, zpix, out=patch)
    return np.where(np.isinf(zbuf), 0.0, zbuf).astype(np.float32)


_PLY_TYPES = {b"float": "<f4", b"float32": "<f4", b"double": "<f8", b"uchar": "u1",
              b"uint8": "u1", b"int": "<i4", b"uint": "<u4", b"short": "<i2",
              b"ushort": "<u2"}


def load_ply_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Triangle PLY (binary_little_endian or ascii; float x/y/z among any
    vertex properties, uchar-count int face indices) -> (verts (V, 3)
    float32, faces (F, 3) int32)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt, n_verts, n_faces, props, in_vertex = None, 0, 0, [], False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header without end_header")
            tok = line.split()
            if not tok:
                continue
            if tok[0] == b"end_header":
                break
            if tok[0] == b"format":
                fmt = tok[1]
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    n_verts = int(tok[2])
                elif tok[1] == b"face":
                    n_faces = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                props.append((tok[2].decode(), _PLY_TYPES[tok[1]]))
        if fmt == b"ascii":
            verts = np.loadtxt([f.readline() for _ in range(n_verts)],
                               dtype=np.float64, ndmin=2)[:, :3]
            faces = [[int(v) for v in f.readline().split()[1:4]] for _ in range(n_faces)]
            return verts.astype(np.float32), np.asarray(faces, np.int32).reshape(-1, 3)
        if fmt != b"binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        vdt = np.dtype(props)
        raw = np.frombuffer(f.read(n_verts * vdt.itemsize), dtype=vdt, count=n_verts)
        verts = np.stack([raw["x"], raw["y"], raw["z"]], -1).astype(np.float32)
        fdata = f.read()
    face_dt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
    faces = np.frombuffer(fdata, dtype=face_dt, count=n_faces)
    if not (faces["n"] == 3).all():
        raise ValueError(f"{path}: PLY faces that are not triangles")
    return verts, np.ascontiguousarray(faces["idx"], np.int32)
