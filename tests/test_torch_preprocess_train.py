"""The port's offline tools against the JAX package on the same raw files:
the training-set preparers (data/preprocess_train.py), habitat crops
(data/habitat_prep.py), the .sens export (data/sens_reader.py), NYUv2's
preparation (data/preprocess.py::prepare_nyuv2) and the mesh rasteriser
(geometry/raster.py), on the CPU. The JAX package runs with its real
OpenCV and Pillow.

Every case of tests/test_preprocess_train.py and tests/test_habitat_prep.py
is re-run here through both packages; every preparer also runs on the
seeded raw layouts of geo4d_tpu_torch/tools/offline_check.py.

Tolerances: the output trees have the same file lists; JPEG and EXR files
are equal byte for byte; PNGs equal in pixels; .npz, .npy, .json and .txt
contents equal, floats within 1e-9 relative + 1e-12 (offline_check.RTOL,
ATOL; measured: exactly equal). The rasteriser's library against its numpy
version: the same covered pixels except at most 1% along triangle edges,
depths within 1e-4 relative where both cover (float32 against float64
barycentrics; measured 2.3e-5).
"""

import json
import os
import os.path as osp
import shutil
import struct
import types

import numpy as np
import pytest

from geo4d_tpu.data import cropping as jax_cropping
from geo4d_tpu.data import habitat_prep as jax_habitat
from geo4d_tpu.data import preprocess as jax_preprocess
from geo4d_tpu.data import preprocess_train as jax_pt
from geo4d_tpu.data import sens_reader as jax_sens
from geo4d_tpu.geometry import raster as jax_raster
from geo4d_tpu_torch.data import cropping as port_cropping
from geo4d_tpu_torch.data import habitat_prep as port_habitat
from geo4d_tpu_torch.data import preprocess_train as port_pt
from geo4d_tpu_torch.data.images import write_png
from geo4d_tpu_torch.data.jpeg import write_jpeg
from geo4d_tpu_torch.geometry import raster as port_raster
from geo4d_tpu_torch.tools import offline_check as oc

FIXTURES = osp.join(osp.dirname(osp.abspath(__file__)), "fixtures", "torch_offline", "expected")
JAX_MODULES = types.SimpleNamespace(preprocess_train=jax_pt, habitat_prep=jax_habitat,
                                    sens_reader=jax_sens, raster=jax_raster,
                                    preprocess=jax_preprocess)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The seeded raw layouts written twice (each package reads its own
    copy) and each case run through both packages."""
    root = tmp_path_factory.mktemp("offline")
    runs = {}
    for who, mods in (("jax", JAX_MODULES), ("port", oc.port_modules())):
        raw, out = str(root / who / "raw"), str(root / who / "out")
        man = oc.write_raw(raw, seed=0, h5=True)
        for case in oc.CASES + oc.H5_CASES:
            oc.run_case(case, raw, out, man, mods, seed=0)
        runs[who] = out
    return runs


@pytest.mark.parametrize("case", oc.CASES + oc.H5_CASES)
def test_preparer_matches_jax_on_seeded_raw_data(both, case):
    stats = oc.compare_trees(osp.join(both["port"], case), osp.join(both["jax"], case))
    assert stats["files"] > 0


@pytest.mark.parametrize("case", oc.CASES)
def test_port_matches_the_committed_jax_outputs(both, case):
    """The fixtures the card is held to (tests/fixtures/torch_offline,
    written by its make_fixtures.py) are the JAX package's outputs of this
    seed."""
    oc.compare_trees(osp.join(both["port"], case), osp.join(FIXTURES, case))


def _K(f, cx, cy):
    K = np.eye(3)
    K[0, 0] = K[1, 1] = f
    K[0, 2], K[1, 2] = cx, cy
    return K


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------- cropping (tests/test_preprocess_train.py) ----------------


def test_colmap_opencv_roundtrip():
    K = _K(100, 31.5, 23.5)
    for f in ("colmap_to_opencv_intrinsics", "opencv_to_colmap_intrinsics"):
        np.testing.assert_array_equal(getattr(port_cropping, f)(K), getattr(jax_cropping, f)(K))


def test_rescale_image_depthmap_covers_and_scales_K():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    depth = rng.uniform(1, 5, (48, 64)).astype(np.float32)
    K = _K(80, 32, 24)
    for out in ((32, 24), (100, 70)):
        _same(port_cropping.rescale_image_depthmap(img, depth, K, out),
              jax_cropping.rescale_image_depthmap(img, depth, K, out))


def test_crop_shifts_principal_point():
    img = np.arange(40 * 60 * 3, dtype=np.uint8).reshape(40, 60, 3)
    depth = np.ones((40, 60), np.float32)
    K = _K(50, 30, 20)
    _same(port_cropping.crop_image_depthmap(img, depth, K, (10, 5, 50, 35)),
          jax_cropping.crop_image_depthmap(img, depth, K, (10, 5, 50, 35)))
    _same(port_cropping.center_crop_image_depthmap(img, depth, K, 0.5),
          jax_cropping.center_crop_image_depthmap(img, depth, K, 0.5))


def test_crop_resize_to_exact_resolution():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (100, 150, 3), dtype=np.uint8)
    depth = rng.uniform(1, 4, (100, 150)).astype(np.float32)
    K = _K(120, 75, 50)
    _same(port_cropping.crop_resize_to(img, depth, K, (64, 48)),
          jax_cropping.crop_resize_to(img, depth, K, (64, 48)))


# ---------------- readers / converters ----------------


def test_pfm_and_float3_roundtrip(tmp_path):
    depth = np.random.default_rng(0).uniform(1, 9, (6, 8)).astype(np.float32)
    with open(tmp_path / "d.pfm", "wb") as f:
        f.write(b"Pf\n8 6\n-1.0\n")
        depth[::-1].astype("<f").tofile(f)
    with open(tmp_path / "c.pfm", "wb") as f:
        f.write(b"PF\n8 6\n1.0\n")
        np.repeat(depth[..., None], 3, -1).astype(">f").tofile(f)
    for name in ("d.pfm", "c.pfm"):
        np.testing.assert_array_equal(port_pt.load_pfm(str(tmp_path / name)),
                                      jax_pt.load_pfm(str(tmp_path / name)))
    arr = np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)
    with open(tmp_path / "d.float3", "wb") as f:
        f.write(b"float\n2\n5\n4\n")
        arr.tofile(f)
    np.testing.assert_array_equal(port_pt.read_float3(str(tmp_path / "d.float3")),
                                  jax_pt.read_float3(str(tmp_path / "d.float3")))


def test_colmap_pose_is_rigid():
    for q in ((0.9, 0.1, -0.2, 0.3, 1.0, -2.0, 0.5), (1, 0, 0, 0, 0, 0, 0)):
        np.testing.assert_array_equal(port_pt.colmap_qt_to_w2c(*q), jax_pt.colmap_qt_to_w2c(*q))


def test_ndc_to_pinhole_and_pt3d_pose():
    for args in (([2.0, 2.0], [0.0, 0.0], (128, 128)), ([1.7, 1.9], [0.1, -0.05], (60, 80))):
        np.testing.assert_array_equal(port_pt.ndc_to_pinhole_intrinsics(*args),
                                      jax_pt.ndc_to_pinhole_intrinsics(*args))
    R = np.random.default_rng(2).normal(size=(3, 3))
    np.testing.assert_array_equal(port_pt.pytorch3d_camera_to_opencv_pose(R, [1.0, 2, 3]),
                                  jax_pt.pytorch3d_camera_to_opencv_pose(R, [1.0, 2, 3]))


def test_object_centric_crop_centers_principal_point():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
    dm = rng.uniform(1, 5, (60, 80, 2)).astype(np.float32)
    for size in (40, 96):                          # shrinking and growing
        _same(port_pt.object_centric_crop(img, dm, _K(70, 50, 25), img_size=size),
              jax_pt.object_centric_crop(img, dm, _K(70, 50, 25), img_size=size))


# ---------------- per-dataset drives on synthetic layouts ----------------


def _write_blendedmvs(root, seed=0):
    """tests/test_preprocess_train.py's BlendedMVS view (768x576), in a
    24-character sequence directory, with a second view."""
    seq = root / "5a3ca9cb270f55008b0aa0b2"
    for sub in ("cams", "blended_images", "rendered_depth_maps"):
        (seq / sub).mkdir(parents=True)
    (seq / "cams" / "pair.txt").write_text("2\n")
    rng = np.random.default_rng(seed)
    for v in range(2):
        K = _K(600 + v, 384, 288)
        w2c = np.eye(4)
        w2c[:3, 3] = [0.5, 0, 1 + v]
        with open(seq / "cams" / f"{v:08d}_cam.txt", "w") as f:
            f.write("extrinsic\n" + "".join(" ".join(map(str, r)) + "\n" for r in w2c))
            f.write("\nintrinsic\n" + "".join(" ".join(map(str, r)) + "\n" for r in K))
        write_jpeg(str(seq / "blended_images" / f"{v:08d}.jpg"),
                   oc.smooth_image(rng, 576, 768), 95)
        with open(seq / "rendered_depth_maps" / f"{v:08d}.pfm", "wb") as f:
            f.write(b"Pf\n768 576\n-1.0\n")
            rng.uniform(1, 9, (576, 768)).astype("<f")[::-1].tofile(f)


def test_blendedmvs_view(tmp_path):
    """prepare_blendedmvs at its own 512x384 through both packages."""
    _write_blendedmvs(tmp_path / "raw")
    jax_pt.prepare_blendedmvs(str(tmp_path / "raw"), str(tmp_path / "jax"))
    port_pt.prepare_blendedmvs(str(tmp_path / "raw"), str(tmp_path / "port"))
    stats = oc.compare_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert stats["jpg"] == stats["exr"] == stats["npz"] == 2
    np.testing.assert_array_equal(
        port_pt.load_blendedmvs_cam(str(tmp_path / "raw" / "5a3ca9cb270f55008b0aa0b2" / "cams" /
                                        "00000000_cam.txt"))[2], [-0.5, 0, -1])


def test_staticthings3d_view(tmp_path):
    """tests/test_preprocess_train.py's 960x540 view, with textured frames,
    through both packages at the default 512x384."""
    seq_rel = osp.join("TRAIN", "A", "0000")
    rng = np.random.default_rng(0)
    for sub in ("poses", "depths", "frames_cleanpass", "frames_finalpass"):
        os.makedirs(tmp_path / "raw" / sub / seq_rel / "left")
    os.makedirs(tmp_path / "raw" / "intrinsics" / seq_rel)
    oc._write_float3(tmp_path / "raw" / "intrinsics" / seq_rel / "0006.float3",
                     _K(1050, 480, 270))
    oc._write_float3(tmp_path / "raw" / "poses" / seq_rel / "left" / "0006.float3", np.eye(4))
    oc._write_float3(tmp_path / "raw" / "depths" / seq_rel / "left" / "0006.float3",
                     rng.uniform(1, 9, (540, 960)))
    for sub in ("frames_cleanpass", "frames_finalpass"):
        write_png(str(tmp_path / "raw" / sub / seq_rel / "left" / "0006.png"),
                  oc.smooth_image(rng, 540, 960))
    for who, mod in (("jax", jax_pt), ("port", port_pt)):
        mod.staticthings3d_process_view(str(tmp_path / "raw"), seq_rel, "left", "0006",
                                        str(tmp_path / who))
    stats = oc.compare_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert stats["jpg"] == 2 and stats["exr"] == 1


def test_arkit_scene_orientation_up_and_down():
    n = 4
    poses = np.tile(np.eye(4), (n, 1, 1))
    Rx = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64)
    for R in (Rx, Rx @ np.diag([-1.0, -1.0, 1.0]), np.array([[0.0, 1, 0], [0, 0, 1], [1, 0, 0]]),
              np.array([[0.0, -1, 0], [0, 0, -1], [1, 0, 0]])):
        poses[:, :3, :3] = R
        got, want = port_pt.arkit_scene_orientation(poses), jax_pt.arkit_scene_orientation(poses)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_waymo_make_video_pairs(tmp_path):
    frames = []
    for seq in ("seqA.tfrecord", "seqB.tfrecord"):
        os.makedirs(tmp_path / seq)
        for cam in "12":
            for i in range(4):
                name = f"{i:05d}_{cam}"
                (tmp_path / seq / f"{name}.jpg").write_bytes(b"x")
                frames.append(name)
    frames = sorted(set(frames))
    for strides in ((1, 2), range(1, 10)):
        _same(port_pt.waymo_make_video_pairs(str(tmp_path), frames, strides=strides),
              jax_pt.waymo_make_video_pairs(str(tmp_path), frames, strides=strides))


def test_depth_exr_roundtrip(tmp_path):
    depth = np.random.default_rng(0).uniform(0.1, 80, (7, 11)).astype(np.float32)
    port_pt.write_depth_exr(str(tmp_path / "p.exr"), depth)
    jax_pt.write_depth_exr(str(tmp_path / "j.exr"), depth)
    assert (tmp_path / "p.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    np.testing.assert_array_equal(port_pt.read_depth_exr(str(tmp_path / "p.exr")), depth)
    assert (tmp_path / "p.exr").read_bytes()[:4] == b"\x76\x2f\x31\x01"


def _square_ply(path):
    verts = np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n")
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(b"element face 2\nproperty list uchar int vertex_indices\nend_header\n")
        verts.astype("<f4").tofile(f)
        for face in faces:
            f.write(struct.pack("<B3i", 3, *face))
    return verts, faces


def test_ply_roundtrip_and_raster(tmp_path):
    """tests/test_preprocess_train.py's square, moved camera and occlusion,
    through the port's library, its numpy version and JAX's renderer."""
    verts, faces = _square_ply(tmp_path / "mesh.ply")
    v2, f2 = port_raster.load_ply_mesh(str(tmp_path / "mesh.ply"))
    jv, jf = jax_raster.load_ply_mesh(str(tmp_path / "mesh.ply"))
    np.testing.assert_array_equal(v2, jv)
    np.testing.assert_array_equal(f2, jf)
    K = np.array([[20, 0, 16], [0, 20, 12], [0, 0, 1]], np.float64)
    c2w = np.eye(4)
    c2w[2, 3] = -1.0
    verts3 = np.concatenate([verts, verts * np.array([1, 1, 0.5])], 0)
    faces3 = np.concatenate([faces, faces + 4], 0).astype(np.int32)
    for v, f, pose in ((v2, f2, np.eye(4)), (v2, f2, c2w), (verts3, faces3, np.eye(4))):
        got = port_raster.render_mesh_depth(v, f, K, pose, (24, 32))
        np.testing.assert_array_equal(got, jax_raster.render_mesh_depth(v, f, K, pose, (24, 32)))
        np.testing.assert_array_equal(port_raster.raster_depth_plain(v, f, K, pose, (24, 32)),
                                      jax_raster._raster_depth_numpy(
                                          *_jax_plain_args(v, f, K, pose, (24, 32))))
    assert got[12, 16] == pytest.approx(1.0)


def _jax_plain_args(verts, faces, K, c2w, hw):
    w2c = np.ascontiguousarray(np.linalg.inv(c2w), np.float32)
    return (np.ascontiguousarray(verts, np.float32), np.ascontiguousarray(faces, np.int32), w2c,
            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), hw[1], hw[0],
            0.05, 20.0)


def test_raster_library_matches_its_numpy_version():
    """The seeded 200-triangle room of offline_check at 48x64, two cameras:
    coverage equal but for edge pixels (<= 1%), depths within 1e-4."""
    rng = np.random.default_rng(0)
    verts, faces = oc.room_mesh(rng)
    for R, t in oc.raster_cameras(0):
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        lib = port_raster.render_mesh_depth(verts, faces, oc.RASTER_K, c2w, oc.RASTER_HW)
        plain = port_raster.raster_depth_plain(verts, faces, oc.RASTER_K, c2w, oc.RASTER_HW)
        assert ((lib > 0) != (plain > 0)).mean() <= oc.RASTER_EDGE_SHARE
        both = (lib > 0) & (plain > 0)
        assert both.mean() > 0.5
        np.testing.assert_allclose(lib[both], plain[both], rtol=oc.RASTER_REL)


def test_raster_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a library that does not build is an error with g++'s
    output."""
    monkeypatch.setattr(port_raster, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_raster, "CXX_FLAGS", port_raster.CXX_FLAGS + ["-include",
                                                                          "no_such_header.h"])
    port_raster._library.cache_clear()
    try:
        with pytest.raises(RuntimeError,
                           match="(?s)mesh rasteriser could not be built.*no_such_header"):
            port_raster.render_mesh_depth(np.zeros((3, 3)), np.zeros((1, 3), np.int32),
                                          np.eye(3), np.eye(4), (4, 4))
    finally:
        port_raster._library.cache_clear()


def test_scannetpp_scene(tmp_path):
    """tests/test_preprocess_train.py's pinhole iPhone scene (a quad at
    z = 2) through both packages, then the concatenated metadata."""
    data = tmp_path / "data" / "scene0"
    for sub in ("scans", "iphone/colmap", "iphone/rgb", "iphone/rgb_masks", "dslr/colmap"):
        (data / sub).mkdir(parents=True)
    verts = np.array([[-4, -3, 2], [4, -3, 2], [4, 3, 2], [-4, 3, 2]], np.float32)
    oc._write_ply(str(data / "scans" / "mesh_aligned_0.05.ply"), verts,
                  np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    W, H = 128, 96
    for cam in ("iphone", "dslr"):
        with open(data / cam / "colmap" / "cameras.txt", "w") as f:
            f.write("# cameras\n# ...\n# ...\n")
            if cam == "iphone":
                f.write(f"1 PINHOLE {W} {H} 60 60 {W/2} {H/2} 0 0 0 0\n")
        with open(data / cam / "colmap" / "images.txt", "w") as f:
            f.write("# images\n")
            if cam == "iphone":
                f.write("7 1 0 0 0 0 0 0 1 frame_000001.jpg\n\n")
    rng = np.random.default_rng(0)
    write_jpeg(str(data / "iphone" / "rgb" / "frame_000001.jpg"),
               rng.integers(0, 255, (H, W, 3), dtype=np.uint8), 75)
    write_png(str(data / "iphone" / "rgb_masks" / "frame_000001.png"),
              np.full((H, W), 255, np.uint8))
    pairs = np.array([[0, 0, 1.0]])
    for who, mod in (("jax", jax_pt), ("port", port_pt)):
        mod.prepare_scannetpp_scene(str(data), str(tmp_path / who / "scene0"), ["frame_000001"],
                                    pairs, target_resolution=64)
        mod.scannetpp_concat_metadata(str(tmp_path / who), ["scene0"])
    stats = oc.compare_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert stats["png"] == stats["jpg"] == 1 and stats["npz"] == 2


def test_megadepth_and_nyuv2_without_h5py_raise_jax_errors(tmp_path, monkeypatch):
    """With h5py unimportable both packages raise the same error (the card
    has no h5py)."""
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    errors = []
    for mods in (JAX_MODULES, oc.port_modules()):
        got = []
        for case in ("megadepth", "nyuv2"):
            with pytest.raises((RuntimeError, ImportError)) as e:
                _megadepth_or_nyuv2(mods, case, tmp_path)
            got.append((type(e.value), str(e.value)))
        errors.append(got)
    assert errors[0] == errors[1]
    assert errors[1][0] == (RuntimeError, "megadepth depth maps need h5py")


def _megadepth_or_nyuv2(mods, case, tmp_path):
    if case == "nyuv2":
        return mods.preprocess.prepare_nyuv2(str(tmp_path / "nyu"))
    root = tmp_path / "md"
    sub = root / "0001" / "sparse" / "manhattan" / "0"
    sub.mkdir(parents=True, exist_ok=True)
    (sub / "cameras.txt").write_text("#\n#\n#\n1 SIMPLE_RADIAL 96 64 80.0 48 32 -0.05\n")
    (sub / "images.txt").write_text("#\n#\n#\n#\n1 1 0 0 0 0 0 0 1 a.jpg\n\n")
    np.savez(root / "pairs.npz", scenes=np.array(["0001 0"], object),
             images=np.array(["a.jpg"], object), pairs=np.array([(0, 0, 0, 0.5)], object))
    return mods.preprocess_train.prepare_megadepth(str(root), str(root / "pairs.npz"),
                                                   str(tmp_path / "md_out"))


def test_waymo_extraction_needs_tensorflow(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for mod in (jax_pt, port_pt):
        with pytest.raises(RuntimeError, match="tensorflow"):
            mod.waymo_extract_frames("x", "y")


# ---------------- habitat (tests/test_habitat_prep.py) ----------------


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


def test_equirect_roundtrip():
    h, w = 64, 128
    for mod in (port_habitat, jax_habitat):
        gu, gv = mod.pixel_grid(h, w)
        rays = mod.equirect_unproject(gu, gv, h, w)
        _same(mod.equirect_project(rays, h, w), jax_habitat.equirect_project(rays, h, w))
    _same([port_habitat.equirect_unproject(gu, gv, h, w)],
          [jax_habitat.equirect_unproject(gu, gv, h, w)])


def test_perspective_roundtrip_and_intrinsics():
    K = port_habitat.camera_intrinsics_from_hfov(48, 64, 90.0)
    np.testing.assert_array_equal(K, jax_habitat.camera_intrinsics_from_hfov(48, 64, 90.0))
    gu, gv = port_habitat.pixel_grid(48, 64)
    rays = port_habitat.perspective_unproject(gu, gv, K)
    np.testing.assert_array_equal(rays, jax_habitat.perspective_unproject(gu, gv, K))
    _same(port_habitat.perspective_project(rays, K), jax_habitat.perspective_project(rays, K))
    for f in ("colmap_to_opencv_intrinsics", "opencv_to_colmap_intrinsics"):
        np.testing.assert_array_equal(getattr(port_habitat, f)(K), getattr(jax_habitat, f)(K))


def _ray_colored_envmap(h, w):
    gu, gv = jax_habitat.pixel_grid(h, w)
    rays = jax_habitat.equirect_unproject(gu, gv, h, w)
    return ((rays + 1) / 2 * 255).astype(np.uint8)


def _cam(mod, h, w, hfov, rot, pos):
    return mod.PerspectiveCamera(K=mod.camera_intrinsics_from_hfov(h, w, hfov),
                                 R_cam2world=_rot_y(rot), position=np.asarray(pos, float),
                                 height=h, width=w)


@pytest.mark.parametrize("jitter", [0, 5])
def test_extract_crop_color_matches_ray_direction(jitter):
    """The crop of tests/test_habitat_prep.py, without and with the
    jittered anti-aliasing remaps: colour, depth and points equal."""
    color_env = _ray_colored_envmap(512, 1024)
    dist_env = np.full((512, 1024), 2.0, np.float32)
    got = port_habitat.extract_crop(_cam(port_habitat, 64, 64, 60.0, 0.8, [0, 0, 0]), color_env,
                                    dist_env, jitter_iterations=jitter)
    want = jax_habitat.extract_crop(_cam(jax_habitat, 64, 64, 60.0, 0.8, [0, 0, 0]), color_env,
                                    dist_env, jitter_iterations=jitter)
    _same(got, want)


def test_crop_depth_and_pointmap_consistency():
    pos = np.array([1.0, -2.0, 0.5])
    color_env = _ray_colored_envmap(256, 512)
    dist_env = np.random.default_rng(0).uniform(1, 4, (256, 512)).astype(np.float32)
    pm = port_habitat.envmap_pointmap(dist_env, pos)
    np.testing.assert_array_equal(pm, jax_habitat.envmap_pointmap(dist_env, pos))
    got = port_habitat.extract_crop(_cam(port_habitat, 32, 48, 75.0, -1.1, pos), color_env,
                                    dist_env, pm, jitter_iterations=0)
    want = jax_habitat.extract_crop(_cam(jax_habitat, 32, 48, 75.0, -1.1, pos), color_env,
                                    dist_env, pm, jitter_iterations=0)
    _same(got, want)


def test_camera_params_dict_roundtrip():
    d = _cam(port_habitat, 240, 320, 58.0, 0.3, [0.1, 0.2, 0.3]).to_dict()
    assert d == _cam(jax_habitat, 240, 320, 58.0, 0.3, [0.1, 0.2, 0.3]).to_dict()
    a = port_habitat.PerspectiveCamera.from_dict(json.loads(json.dumps(d)))
    b = jax_habitat.PerspectiveCamera.from_dict(json.loads(json.dumps(d)))
    for k in ("K", "R_cam2world", "position", "height", "width"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_preprocess_metadata_driver(tmp_path):
    """tests/test_habitat_prep.py's driver (two 32x32 views, one position)
    through both packages: equal trees, one render."""
    color_env = _ray_colored_envmap(128, 256)
    calls = []

    def render_fn(position):
        calls.append(tuple(position))
        return color_env, np.full((128, 256), 2.5, np.float32)

    views = {}
    for i, ang in enumerate([0.0, 1.0]):
        cam = _cam(jax_habitat, 32, 32, 60.0, ang, [0, 0, 0])
        views[f"view{i}"] = {**cam.to_dict(), "size": [32, 32]}
    (tmp_path / "metadata.json").write_text(json.dumps({"view_batches": {"batch0": views}}))
    for who, mod in (("jax", jax_habitat), ("port", port_habitat)):
        assert mod.preprocess_metadata(str(tmp_path / "metadata.json"), render_fn,
                                       str(tmp_path / who), crop_resolution=(32, 32)) == 2
    assert len(calls) == 2                      # once per package
    stats = oc.compare_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert stats["jpeg"] == stats["exr"] == 2


def test_habitat_render_fn_without_habitat_sim():
    for mod in (jax_habitat, port_habitat):
        with pytest.raises(NotImplementedError, match="habitat-sim is not installed"):
            mod.make_habitat_render_fn("scene.glb")


def test_sens_reader_cli(tmp_path):
    """`main` with JAX's flags: the same exported tree as JAX's main."""
    from geo4d_tpu_torch.data import sens_reader as port_sens

    oc.write_sens(str(tmp_path / "s.sens"), np.random.default_rng(4))
    for who, mod in (("jax", jax_sens), ("port", port_sens)):
        mod.main(["--filename", str(tmp_path / "s.sens"), "--output_path", str(tmp_path / who),
                  "--frame_skip", "1", "--height", "36", "--width", "48"])
    stats = oc.compare_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert stats["jpg"] == stats["png"] == 3
    shutil.rmtree(tmp_path / "port")
