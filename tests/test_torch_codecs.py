"""The port's host codecs, resampling and camera models against Pillow,
OpenCV and the JAX package, on the CPU.

Tolerances (each case states its own):
  encode_jpeg           Pillow's and OpenCV's bytes exactly, at q80, q90,
                        q95 and sizes that are not multiples of 16
  encode_png            pixels exactly, read back by OpenCV and Pillow
  write_depth_exr       the JAX package's bytes exactly
  remap                 cv2.remap exactly, uint8 and float32, every
                        interpolation x border the offline tools use
  resize_area, resize_nearest    cv2.resize exactly
  camera models         matrices within 1e-12 relative of OpenCV (the
                        issue's limit is 1e-9), maps exactly (limit 1e-4 px)
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from geo4d_tpu.data import preprocess_train as jax_pt
from geo4d_tpu_torch.data import images, jpeg
from geo4d_tpu_torch.data import preprocess_train as port_pt
from geo4d_tpu_torch.geometry import distortion

QUALITIES = (80, 90, 95)
SIZES = [(1, 1), (37, 53), (17, 33), (480, 640)]
MATRIX_REL = 1e-12


def picture(h, w, seed=0, gray=False):
    """Smooth gradients under noise: the DCT sees both low and high
    frequencies, and values reach both ends of the range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    a = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx * 7 + yy * 3) % 256], -1)
    a = (a + rng.normal(0, 30, a.shape)).clip(0, 255).astype(np.uint8)
    return a[..., 1] if gray else a


def pillow_bytes(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_encode_jpeg_writes_pillows_and_opencvs_bytes(size, quality):
    for gray in (False, True):
        img = picture(*size, seed=quality, gray=gray)
        got = jpeg.encode_jpeg(img, quality)
        assert got == pillow_bytes(img, quality), (size, quality, gray)
        bgr = img if gray else img[..., ::-1]
        ok, enc = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok and enc.tobytes() == got, (size, quality, gray)


def test_encode_jpeg_defaults_and_decode():
    """Pillow's default quality is 75, OpenCV's 95; the decoder reads the
    encoder's bytes as Pillow does; other inputs are refused."""
    img = picture(29, 41, seed=3)
    assert jpeg.encode_jpeg(img) == pillow_bytes(img, 75)
    assert cv2.imencode(".jpg", img[..., ::-1])[1].tobytes() == jpeg.encode_jpeg(img, 95)
    data = jpeg.encode_jpeg(img, 90)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data))))
    with pytest.raises(ValueError, match="encode_jpeg takes uint8"):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))


def test_encoder_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg, "CXX_FLAGS", jpeg.CXX_FLAGS + ["-include", "no_such_header.h"])
    jpeg._encoder.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="the JPEG encoder could not be built"):
            jpeg.encode_jpeg(picture(8, 8))
    finally:
        jpeg._encoder.cache_clear()


PNG_CASES = {
    "gray16": lambda rng: rng.integers(0, 65536, (13, 17), dtype=np.uint16),
    "gray8": lambda rng: rng.integers(0, 256, (13, 17), dtype=np.uint8),
    "gray_alpha": lambda rng: rng.integers(0, 256, (13, 17, 2), dtype=np.uint8),
    "rgb": lambda rng: rng.integers(0, 256, (13, 17, 3), dtype=np.uint8),
    "rgba": lambda rng: rng.integers(0, 256, (13, 17, 4), dtype=np.uint8),
}


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_png_reads_back_in_opencv_and_pillow(case):
    img = PNG_CASES[case](np.random.default_rng(1))
    data = images.encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    np.testing.assert_array_equal(images.decode_png(data), img)
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if case == "gray_alpha":          # OpenCV expands gray + alpha to BGRA
        got = got[..., [0, 3]]
    elif img.ndim == 3:
        got = got[..., [2, 1, 0, 3][:img.shape[2]]]
    np.testing.assert_array_equal(got, img)


def test_exr_writes_the_jax_writers_bytes(tmp_path):
    """This OpenCV has no EXR codec, so the JAX package writes its own
    uncompressed layout; the port writes the same bytes and reads both."""
    depth = np.random.default_rng(0).uniform(0.1, 80, (7, 11)).astype(np.float32)
    jax_pt.write_depth_exr(str(tmp_path / "jax.exr"), depth)
    port_pt.write_depth_exr(str(tmp_path / "port.exr"), depth)
    assert (tmp_path / "jax.exr").read_bytes() == (tmp_path / "port.exr").read_bytes()
    np.testing.assert_array_equal(port_pt.read_depth_exr(str(tmp_path / "jax.exr")), depth)
    np.testing.assert_array_equal(jax_pt.read_depth_exr(str(tmp_path / "port.exr")), depth)


def test_exr_reader_names_a_compressed_file(tmp_path):
    path = tmp_path / "zip.exr"
    port_pt.write_depth_exr(str(path), np.ones((3, 4), np.float32))
    data = bytearray(path.read_bytes())
    at = data.index(b"compression\x00compression\x00") + len("compression\x00compression\x00") + 4
    data[at] = 3                                   # ZIP_COMPRESSION
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"zip\.exr: EXR compression 'zip'"):
        port_pt.read_depth_exr(str(path))


BORDERS = {"reflect101": cv2.BORDER_REFLECT_101, "constant": cv2.BORDER_CONSTANT,
           "wrap": cv2.BORDER_WRAP}
INTERP = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("interp", list(INTERP))
def test_remap_equals_opencv(interp, border, dtype):
    """Random maps reaching 5 px past every edge, plus the half-pixel
    positions where nearest rounds half to even; 1, 3 and 4 channels."""
    rng = np.random.default_rng(2)
    for shape in ((40, 50), (40, 50, 3), (23, 31, 4)):
        src = rng.integers(0, 256, shape).astype(dtype)
        if dtype == "float32":
            src = src * np.float32(1.37) - np.float32(20.5)
        mx = rng.uniform(-5, shape[1] + 5, (60, 70)).astype(np.float32)
        my = rng.uniform(-5, shape[0] + 5, (60, 70)).astype(np.float32)
        mx[0, :6] = [2.5, 3.5, -0.5, 1.5, 0.5, 1.01]
        want = cv2.remap(src, mx, my, INTERP[interp], borderMode=BORDERS[border],
                         borderValue=(255, 255, 255, 255))
        got = images.remap(src, mx, my, interp, border, 255)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=str(shape))


@pytest.mark.parametrize("sizes", [((968, 1296), (480, 640)), ((96, 128), (48, 64)),
                                   ((90, 120), (30, 40)), ((97, 131), (40, 55))],
                         ids=["sens_1296x968", "2x", "3x", "odd"])
def test_resize_area_and_nearest_equal_opencv(sizes):
    (H, W), (h, w) = sizes
    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                rng.integers(0, 256, (H, W), dtype=np.uint8)):
        np.testing.assert_array_equal(images.resize_area(img, (w, h)),
                                      cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))
    depth = rng.integers(0, 65535, (h, w), dtype=np.uint16)
    for size in ((W, H), (w // 2 + 1, h // 3 + 1)):          # up and down
        np.testing.assert_array_equal(images.resize_nearest(depth, size),
                                      cv2.resize(depth, size, interpolation=cv2.INTER_NEAREST))
    with pytest.raises(ValueError, match="enlarging"):
        images.resize_area(np.zeros((4, 4), np.uint8), (8, 8))


K_DSLR = np.array([[1200.0, 0, 875.3], [0, 1190.0, 583.1], [0, 0, 1]])
DISTS = {"k4": [-0.2, 0.05, 0.001, -0.002], "k5": [-0.2, 0.05, 0.001, -0.002, 0.01],
         "k8": [0.1, -0.05, 0.001, 0.002, 0.01, 0.05, -0.02, 0.01], "none": [0.0] * 4,
         "megadepth": [-0.05, 0, 0, 0]}


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dist", list(DISTS))
def test_radial_tangential_model_equals_opencv(dist):
    """getOptimalNewCameraMatrix (alpha 0 and 1, centred, same and other
    size) and initUndistortRectifyMap at ScanNet++'s DSLR size 1752x1168."""
    size = (1752, 1168)
    d = np.asarray(DISTS[dist])
    for alpha in (0, 1):
        for new in (size, (800, 533)):
            want = cv2.getOptimalNewCameraMatrix(K_DSLR, d, size, alpha, new, True)[0]
            got = distortion.optimal_new_camera_matrix(K_DSLR, d, size, alpha, new)
            assert _rel(got, want) <= MATRIX_REL, (alpha, new)
    new_K = cv2.getOptimalNewCameraMatrix(K_DSLR, d, size, 1, size, True)[0]
    want = cv2.initUndistortRectifyMap(K_DSLR, d, np.eye(3), new_K, size, cv2.CV_32FC1)
    got = distortion.init_undistort_rectify_map(K_DSLR, d, new_K, size)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("dist", [[0.01, -0.02, 0.003, -0.001], [-0.03, 0.01, 0.0, 0.0]])
def test_fisheye_model_equals_opencv(dist):
    size = (1752, 1168)
    K = np.array([[600.0, 0, 876.1], [0, 601.0, 583.9], [0, 0, 1]])
    d = np.asarray(dist)
    want = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, d, size, np.eye(3),
                                                                  balance=0.0)
    got = distortion.fisheye_estimate_new_camera_matrix(K, d, size, 0.0)
    assert _rel(got, want) <= MATRIX_REL
    want[0, 2], want[1, 2] = size[0] / 2, size[1] / 2
    m = cv2.fisheye.initUndistortRectifyMap(K, d, np.eye(3), want, size, cv2.CV_32FC1)
    g = distortion.fisheye_init_undistort_rectify_map(K, d, want, size)
    np.testing.assert_array_equal(g[0], m[0])
    np.testing.assert_array_equal(g[1], m[1])
