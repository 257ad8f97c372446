"""The port's JPEG decoder (data/jpeg.py over csrc/jpeg_decode.cpp) against
Pillow, and the frame and video loaders that use it, on the CPU.

Tolerance: exact. Every file below decodes to Pillow's pixels bit for bit:
a grid of chroma sampling (4:4:4, 4:2:2, 4:2:0) x restart interval (none,
every 2 MCUs, every MCU row) x quality (50, 95) over odd sizes, grayscale,
4:4:0 and 16-bit quantisation tables (extended sequential, SOF1), and the
committed fixtures (tests/fixtures/torch_inputs, written by its
make_fixtures.py). A mode that Pillow refuses (here a 12-bit progressive
file) raises a ValueError naming the file and the mode; a failed build
raises. The other modes (progressive, arithmetic, lossless, 4:1:1, CMYK)
are held to Pillow and OpenCV in test_torch_formats.py.
"""

import io
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from geo4d_tpu.data import video as jax_video
from geo4d_tpu_torch.data import jpeg
from geo4d_tpu_torch.data import video as port_video

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_inputs")
SIZES = [(128, 288), (37, 53), (17, 2), (1, 1), (130, 287)]


def picture(h, w, seed=0):
    """Gradients, noise and a flat block: smooth and busy regions, values at
    both ends of the range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    a = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx * 7 + yy * 3) % 256], -1)
    a = a + rng.normal(0, 45, a.shape)
    a[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = [255, 0, 30]
    return a.clip(0, 255).astype(np.uint8)


def save(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_pillow_equal(data, what):
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = jpeg.decode_jpeg(data, what)
    assert got.shape == want.shape, what
    diff = np.abs(got.astype(int) - want.astype(int))
    assert not diff.any(), f"{what}: {int(diff.max())} LSB at {float((diff > 0).mean()):.2%}"


RESTARTS = {"none": {}, "blocks2": dict(restart_marker_blocks=2),
            "rows1": dict(restart_marker_rows=1)}


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("restart", sorted(RESTARTS))
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_decode_equals_pillow(subsampling, restart, quality):
    for h, w in SIZES:
        for optimize in (False, True):
            data = save(picture(h, w), quality=quality, subsampling=subsampling,
                        optimize=optimize, **RESTARTS[restart])
            assert_pillow_equal(data, f"{h}x{w} sampling {subsampling} {restart} q{quality} "
                                      f"optimize={optimize}")


@pytest.mark.parametrize("restart", sorted(RESTARTS))
def test_grayscale_equals_pillow(restart):
    for h, w in SIZES:
        for q in (50, 95):
            data = save(picture(h, w)[..., 1], quality=q, **RESTARTS[restart])
            assert_pillow_equal(data, f"gray {h}x{w} {restart} q{q}")


def test_440_and_extended_sequential_equal_pillow():
    cv2 = pytest.importorskip("cv2")
    img = picture(101, 203, seed=1)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    assert ok
    assert_pillow_equal(enc.tobytes(), "4:4:0")
    # quantisation steps above 255 take 16-bit tables and an SOF1 frame
    data = save(img, qtables=[list(range(300, 364))] * 2)
    assert b"\xff\xc1" in data
    assert_pillow_equal(data, "SOF1")


def test_progressive_raises_naming_file_and_mode(tmp_path):
    """Progressive files decode (test_torch_formats.py); one at 12-bit
    precision, which Pillow refuses, raises naming the file and the mode."""
    data = bytearray(save(picture(32, 48), progressive=True))
    sof = data.index(b"\xff\xc2")
    data[sof + 4] = 12                         # the frame header's sample precision
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(data))).load()
    path = tmp_path / "progressive.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"progressive\.jpg: 12-bit JPEG \(SOF2\)"):
        jpeg.read_jpeg(str(path))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG....", "x.png")


def test_fixtures_equal_committed_pillow_pixels():
    pixels = np.load(os.path.join(FIXTURES, "jpeg_pixels.npz"))
    assert len(pixels.files) == 5
    for name in pixels.files:
        path = os.path.join(FIXTURES, name)
        np.testing.assert_array_equal(jpeg.read_jpeg(path), pixels[name], name)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), pixels[name], name)


def test_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg, "CXX_FLAGS", jpeg.CXX_FLAGS + ["-DJD_NO_SUCH", "-include",
                                                            "no_such_header.h"])
    jpeg._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="could not be built"):
            jpeg.decode_jpeg(save(picture(8, 8)))
    finally:
        jpeg._library.cache_clear()


def test_jpeg_dir_loads_as_jax_loads_it(tmp_path):
    """A directory of the JPEG fixtures through both loaders (Lanczos to
    576x256, the main path's size): the same frames."""
    for name in sorted(os.listdir(FIXTURES)):
        if name.endswith(".jpg"):
            shutil.copy(os.path.join(FIXTURES, name), tmp_path / name)
    got, names = port_video.load_image_dir(str(tmp_path), (576, 256))
    want, want_names = jax_video.load_image_dir(str(tmp_path), (576, 256), raw_uint8=True)
    assert got.shape == (5, 256, 576, 3) and names == want_names
    np.testing.assert_array_equal(got, want)


def test_fixture_clip_decode_equals_committed():
    """The committed clip at its own size through the native decoder: the
    frames committed from this decode, exactly (the card compares them with
    a tolerance, its FFmpeg may differ)."""
    ref = np.load(os.path.join(FIXTURES, "clip_decode.npz"))
    frames, fps = port_video.load_video(os.path.join(FIXTURES, "clip.mp4"), 1, (128, 288))
    assert frames.shape == (20, 128, 288, 3) and fps == 24
    np.testing.assert_array_equal(frames[ref["index"]], ref["frames"])


def test_missing_ffmpeg_names_frame_directories(tmp_path, monkeypatch):
    monkeypatch.setattr(port_video, "_NATIVE_LIB", str(tmp_path / "libgeo4d_video.so"))
    monkeypatch.setattr(port_video, "FFMPEG_LIBS", ["libgeo4d_no_such_library"])
    with pytest.raises(RuntimeError, match="directory of PNG or JPEG frames") as e:
        port_video.load_video(os.path.join(FIXTURES, "clip.mp4"), 1, (128, 288))
    assert "libgeo4d_no_such_library" in str(e.value)      # the cause is kept
