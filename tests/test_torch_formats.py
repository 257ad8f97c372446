"""Every frame file the JAX package reads, through the port's decoders
(data/jpeg.py over csrc/jpeg_decode.cpp, data/images.py) on the CPU.

Tolerance: exact (0 LSB), everywhere:

  * each file of tests/fixtures/torch_formats (written by its
    make_fixtures.py: progressive, block-smoothed, arithmetic-coded, 4:1:1,
    CMYK, YCCK and lossless JPEG; palette, 1- to 4-bit, Adam7 and 16-bit PNG)
    against its committed pixels, and against live Pillow and OpenCV: the
    raw view (np.asarray(Image.open(f))), Pillow's convert("RGB") and
    OpenCV's imread;
  * a seeded grid of Pillow-written progressive files (sampling x restart x
    quality over odd sizes);
  * the JAX package's load_image_dir against the port's on a directory that
    mixes every format;
  * the preprocessors' readers against the library their JAX counterparts
    call, through the preparers themselves on raw layouts that hold CMYK
    JPEG and 16-bit grayscale PNG (where Pillow and OpenCV differ), and the
    ScanNet reader against cv2.imdecode;
  * each mode that Pillow refuses (12-bit, hierarchical, lossless
    arithmetic, fractional sampling, DNL height) raises a ValueError naming
    the file and the mode, as Pillow refuses it.
"""

import glob
import hashlib
import io
import os
import shutil
import types

import numpy as np
import pytest
from PIL import Image

from geo4d_tpu.data import video as jax_video
from geo4d_tpu_torch.data import images, jpeg, preprocess_train, sens_reader
from geo4d_tpu_torch.data import video as port_video

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                        "torch_formats")
FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith((".jpg", ".png"))
               and not f.startswith("refused_"))
PIXELS = dict(np.load(os.path.join(FIXTURES, "pixels.npz")))
SIZES = [(64, 96), (37, 53), (17, 2), (1, 1), (130, 287)]


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def assert_committed(name: str, key: str, got: np.ndarray) -> None:
    """`got` equals the committed view `key` ("", ":rgb" or ":cv2") of
    fixture `name`: the array, or its hash and shape."""
    if name + key in PIXELS and PIXELS[name + key].dtype.kind != "U":
        want = PIXELS[name + key]
        assert got.shape == want.shape and got.dtype == want.dtype, (name + key, got.shape)
        diff = got.astype(int) != want.astype(int)
        assert not diff.any(), f"{name}{key}: {int(diff.sum())} samples differ"
    else:
        assert tuple(PIXELS[f"{name}{key}:shape"]) == got.shape, name + key
        assert str(PIXELS[name + key]) == sha(got), f"{name}{key}: the pixels differ"


def committed_rgb(name: str, key: str) -> str:
    """The key of the committed view that `key` falls back to."""
    if name + key in PIXELS:
        return key
    return ":rgb" if key == ":cv2" and name + ":rgb" in PIXELS else ""


@pytest.mark.parametrize("name", FILES)
def test_fixture_equals_committed_and_libraries(name):
    path = os.path.join(FIXTURES, name)
    raw = images.read_pillow(path)
    rgb = images.read_rgb(path, "pillow")
    if name in PIXELS:                          # all but the large file
        assert_committed(name, "", raw)
    assert_committed(name, committed_rgb(name, ":rgb"), rgb)
    with Image.open(path) as im:
        want_raw, want_rgb = np.asarray(im), np.asarray(im.convert("RGB"))
    assert raw.dtype == want_raw.dtype and np.array_equal(raw, want_raw), name
    np.testing.assert_array_equal(rgb, want_rgb, name)
    cv2 = pytest.importorskip("cv2")
    if name + ":cv2_refuses" in PIXELS:
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=f"{name}: OpenCV's imread refuses"):
            images.read_rgb(path, "opencv")
        return
    cv = images.read_rgb(path, "opencv")
    assert_committed(name, committed_rgb(name, ":cv2"), cv)
    np.testing.assert_array_equal(cv, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], name)


def test_palette_with_trns_expands_to_rgba_as_both_libraries():
    """read_png expands a palette with tRNS to RGBA: Pillow's convert("RGBA")
    and OpenCV's IMREAD_UNCHANGED (BGRA)."""
    cv2 = pytest.importorskip("cv2")
    for name in ("palette_trns.png", "adam7_palette2_53x37.png"):
        path = os.path.join(FIXTURES, name)
        got = images.read_png(path)
        assert got.shape[2] == 4
        with Image.open(path) as im:
            np.testing.assert_array_equal(got, np.asarray(im.convert("RGBA")), name)
        bgra = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, bgra[..., [2, 1, 0, 3]], name)


def picture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    a = np.stack([xx * 255.0 / w, yy * 255.0 / h, (xx * 7 + yy * 3) % 256], -1)
    a = a + rng.normal(0, 45, a.shape)
    a[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = [255, 0, 30]
    return a.clip(0, 255).astype(np.uint8)


RESTARTS = {"none": {}, "blocks3": dict(restart_marker_blocks=3),
            "rows1": dict(restart_marker_rows=1)}


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("restart", sorted(RESTARTS))
@pytest.mark.parametrize("sampling", [0, 1, 2, "gray"])
def test_progressive_grid_equals_pillow(sampling, restart, quality):
    for k, (h, w) in enumerate(SIZES):
        img = picture(h, w, seed=k)
        buf = io.BytesIO()
        if sampling == "gray":
            Image.fromarray(img[..., 1]).save(buf, "JPEG", progressive=True, quality=quality,
                                              **RESTARTS[restart])
        else:
            Image.fromarray(img).save(buf, "JPEG", progressive=True, quality=quality,
                                      subsampling=sampling, **RESTARTS[restart])
        data = buf.getvalue()
        assert b"\xff\xc2" in data
        got = jpeg.decode_jpeg(data)
        want = np.asarray(Image.open(io.BytesIO(data)))
        assert got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int))
        assert not diff.any(), (f"{h}x{w} {sampling} {restart} q{quality}: {int(diff.max())} "
                                f"LSB at {float((diff > 0).mean()):.2%}")


def test_mixed_dir_loads_as_jax_loads_it(tmp_path):
    """Every fixture (and one file of the baseline fixtures) in one
    directory, through both packages' load_image_dir at 96x64: the same
    frames."""
    for name in FILES + [os.path.join("..", "torch_inputs", "frame_1_422_q50_rst2.jpg")]:
        shutil.copy(os.path.join(FIXTURES, name), tmp_path / os.path.basename(name))
    got, names = port_video.load_image_dir(str(tmp_path), (96, 64))
    want, want_names = jax_video.load_image_dir(str(tmp_path), (96, 64), raw_uint8=True)
    assert got.shape == (len(FILES) + 1, 64, 96, 3) and names == want_names
    for i, name in enumerate(names):
        np.testing.assert_array_equal(got[i], want[i], os.path.basename(name))


def _cmyk_jpeg(path: str) -> None:
    """Replace a JPEG with a CMYK one of its picture (Pillow, Adobe marker)."""
    rgb = np.asarray(Image.open(path).convert("RGB"))
    k = np.minimum(255 - rgb.max(-1, keepdims=True), 80)
    Image.fromarray(np.concatenate([255 - rgb, k], -1), "CMYK").save(path, "JPEG", quality=90)


def _gray16_png(path: str) -> None:
    """Replace an RGB PNG with a 16-bit grayscale one whose samples reach
    past 255 (Pillow clips them, OpenCV keeps the high byte)."""
    rgb = np.asarray(Image.open(path).convert("RGB")).astype(np.uint16)
    images.write_png(path, rgb[..., 0] * 200 + rgb[..., 1])


# case -> (glob of its colour images under the raw root, their rewrite)
CONVENTION_CASES = {
    "blendedmvs": ("blendedmvs/**/blended_images/*.jpg", _cmyk_jpeg),
    "co3d": ("co3d/**/images/*.jpg", _cmyk_jpeg),
    "waymo": ("waymo/**/*.jpg", _cmyk_jpeg),
    "staticthings3d": ("staticthings3d/**/frames_*/**/*.png", _gray16_png),
    "wildrgbd": ("wildrgbd/**/rgb/*.png", _gray16_png),
}


@pytest.mark.parametrize("case", sorted(CONVENTION_CASES))
def test_preparer_reads_as_its_jax_counterpart(tmp_path, case):
    """A preparer over a raw layout whose colour images are CMYK JPEG or
    16-bit grayscale PNG, in both packages: the same outputs, so each reads
    with the convention of the library that its JAX counterpart calls."""
    from geo4d_tpu.data import preprocess_train as jax_pt
    from geo4d_tpu_torch.tools import offline_check as oc

    pattern, rewrite = CONVENTION_CASES[case]
    mods = {"jax": types.SimpleNamespace(preprocess_train=jax_pt), "port": oc.port_modules()}
    outs = {}
    for who, m in mods.items():
        raw, out = str(tmp_path / who / "raw"), str(tmp_path / who / "out")
        man = oc.write_raw(raw, seed=0)
        files = glob.glob(os.path.join(raw, pattern), recursive=True)
        assert files, pattern
        for f in files:
            rewrite(f)
        oc.run_case(case, raw, out, man, m, seed=0)
        outs[who] = os.path.join(out, case)
    assert oc.compare_trees(outs["port"], outs["jax"])["files"] > 0


# port preparer -> the library its JAX counterpart reads colour images with
READERS = {"blendedmvs_process_view": "opencv", "staticthings3d_process_view": "opencv",
           "megadepth_process_view": "opencv", "waymo_crop_sequence": "opencv",
           "prepare_co3d_category": "pillow", "prepare_wildrgbd_sequence": "pillow"}


@pytest.mark.parametrize("fn", sorted(READERS))
def test_preparer_passes_its_jax_counterparts_convention(fn):
    """Each read_rgb caller passes the convention of the call its JAX
    counterpart makes: Image.open(...).convert("RGB") -> "pillow",
    cv2.cvtColor(cv2.imread(...), cv2.COLOR_BGR2RGB) -> "opencv"."""
    import inspect

    from geo4d_tpu.data import preprocess_train as jax_pt

    jax_src = inspect.getsource(getattr(jax_pt, fn))
    port_src = inspect.getsource(getattr(preprocess_train, fn))
    pillow = '.convert("RGB")' in jax_src
    assert pillow != ("cv2.COLOR_BGR2RGB" in jax_src), fn
    assert READERS[fn] == ("pillow" if pillow else "opencv"), fn
    assert f'"{READERS[fn]}")' in port_src and "read_rgb(" in port_src, fn


def test_sens_reader_decodes_as_opencv():
    """The ScanNet reader's frames follow cv2.imdecode(IMREAD_COLOR), CMYK
    included (where Pillow's conversion differs)."""
    cv2 = pytest.importorskip("cv2")
    for name in ("cmyk.jpg", "ycck.jpg", "prog_420_q85.jpg", "arith_prog_gray_rows1.jpg"):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(sens_reader.decode_rgb(data, name), want, name)


def test_read_image_is_pillows_raw_view():
    for name in ("palette.png", "mode1.png", "gray16.png", "la16.png", "cmyk.jpg"):
        path = os.path.join(FIXTURES, name)
        got = preprocess_train.read_image(path)
        want = np.asarray(Image.open(path))
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def _patched(data: bytes, what: str) -> bytes:
    """A baseline file made into a mode that Pillow refuses."""
    d = bytearray(data)
    sof = d.index(b"\xff\xc0")
    if what == "hierarchical":
        d[sof + 1] = 0xC5
    elif what == "lossless arithmetic":
        d[sof + 1] = 0xCB
    elif what == "dnl height":
        d[sof + 5:sof + 7] = b"\x00\x00"
    elif what == "fractional sampling":
        d[sof + 11], d[sof + 14], d[sof + 17] = 0x32, 0x21, 0x11
    return bytes(d)


REFUSED = {"12-bit": r"12-bit JPEG \(SOF1\)",
           "hierarchical": r"hierarchical JPEG \(SOF5\)",
           "lossless arithmetic": r"lossless arithmetic-coded JPEG \(SOF11\)",
           "dnl height": r"JPEG with its height in a DNL marker",
           "fractional sampling": r"fractional sampling factors 2x1 of 3x2"}


@pytest.mark.parametrize("mode", sorted(REFUSED))
def test_refused_mode_raises_naming_file_and_mode(tmp_path, mode):
    if mode == "12-bit":
        with open(os.path.join(FIXTURES, "refused_bits12.jpg"), "rb") as f:
            data = f.read()
    else:
        buf = io.BytesIO()
        Image.fromarray(picture(32, 48)).save(buf, "JPEG", quality=90)
        data = _patched(buf.getvalue(), mode)
    with pytest.raises(OSError):                 # Pillow refuses it too
        Image.open(io.BytesIO(data)).load()
    path = tmp_path / "refused.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"refused\\.jpg: {REFUSED[mode]}"):
        jpeg.read_jpeg(str(path))
    with pytest.raises(ValueError, match=f"refused\\.jpg: {REFUSED[mode]}"):
        port_video.load_image_dir(str(tmp_path), (32, 16))
