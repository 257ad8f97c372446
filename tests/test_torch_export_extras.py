"""The public functions the port adds beside its main path, each against
its JAX counterpart on the same numpy-seeded inputs (the JAX side jitted,
float32):

  geometry   normalize_pointcloud_bbox2, normalize_inverse_depth_bbox2
             (with return_st; the quantile index rule), plucker_from_pose,
             focal_px_from_fov, estimate_focal_weiszfeld,
             intersect_skew_lines(weights), cameras_from_plucker(ref_raydirs),
             xy_grid(homogeneous), recover_group_focals(outlier_rel_err):
             within REL of the output's scale (float32; the Weiszfeld focal
             and the ray intersection sum over every pixel, in another order)
  trajectory save_tum / load_tum (the same file bytes), correct_scale and
             delta on umeyama_align, ape_translation_rmse and rpe,
             from_matrices(timestamps), transformed(scale): exact
  plots      plot_trajectory(correct_scale): the same pixels
  export     write_pointcloud_glb, pointmap_to_mesh, write_mesh_glb: the same
             BIN chunk byte for byte and JSON chunk that parses equal;
             save_depth_visualizations: the PNGs equal JAX's pixel for pixel
             (the jet table equal to matplotlib's), the GIF's frames (decoded
             by Pillow) equal to the PNGs
  video      save_video_grid and SampleLogger: the AVI's frames (decoded by
             OpenCV) equal to the grid the JAX package tiles (its mp4 writer
             replaced by a recorder in the test)
  sampling   ddim_sample(temperature) with eta > 0 and the JAX package's step
             noise handed in: within 1e-5
  profiling  trace(log_dir): a Chrome trace naming the ops run inside it
  frames     load_image_dir(exts): the same frames and names
"""

import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from geo4d_tpu.alignment import init as jax_init
from geo4d_tpu.core.schedules import DiffusionSchedule
from geo4d_tpu.data import save_video as jax_save_video
from geo4d_tpu.data.video import load_image_dir as jax_load_image_dir
from geo4d_tpu.evals import plots as jax_plots
from geo4d_tpu.evals import trajectory as jax_traj
from geo4d_tpu.geometry import moge as jax_moge
from geo4d_tpu.geometry import normalize as jax_norm
from geo4d_tpu.geometry import rays as jax_rays
from geo4d_tpu.geometry.utils import xy_grid as jax_xy_grid
from geo4d_tpu.pipeline import export as jax_export
from geo4d_tpu.sampling.ddim import DDIMTables as JaxDDIMTables, ddim_sample as jax_ddim_sample
from geo4d_tpu.training.callbacks import SampleLogger as JaxSampleLogger
from geo4d_tpu_torch.alignment import init as port_init
from geo4d_tpu_torch.core.draws import GivenDraws
from geo4d_tpu_torch.core.profiling import trace
from geo4d_tpu_torch.core.schedules import DiffusionSchedule as PortDiffusionSchedule
from geo4d_tpu_torch.data.images import read_png
from geo4d_tpu_torch.data.save_video import save_video_grid
from geo4d_tpu_torch.data.video import load_image_dir
from geo4d_tpu_torch.evals import plots as port_plots
from geo4d_tpu_torch.evals import trajectory as port_traj
from geo4d_tpu_torch.geometry import moge as port_moge
from geo4d_tpu_torch.geometry import normalize as port_norm
from geo4d_tpu_torch.geometry import rays as port_rays
from geo4d_tpu_torch.geometry.utils import xy_grid
from geo4d_tpu_torch.pipeline import export as port_export
from geo4d_tpu_torch.sampling.ddim import DDIMTables, ddim_sample
from geo4d_tpu_torch.training.callbacks import SampleLogger

torch.set_num_threads(1)
REL = 1e-5


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def rel_close(got, want, rel=REL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if want.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


# ---- geometry ---------------------------------------------------------------

@pytest.mark.parametrize("shape,density,seed", [((2, 8, 8), 1.0, 0), ((3, 17, 23), 0.63, 1),
                                                ((1, 5, 7), 0.3, 2)])
def test_bbox2_normalisations_match_jax(shape, density, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.5, 10, size=shape + (3,)).astype(np.float32)
    depth = rng.uniform(0.5, 20, size=shape).astype(np.float32)
    valid = rng.random(shape) < density
    pc = jax.jit(lambda p, v: jax_norm.normalize_pointcloud_bbox2(p, v, return_st=True))
    dp = jax.jit(lambda d, v: jax_norm.normalize_inverse_depth_bbox2(d, v, return_st=True))
    for got, want in ((port_norm.normalize_pointcloud_bbox2(t32(pts), torch.from_numpy(valid),
                                                            return_st=True),
                       pc(jnp.asarray(pts), jnp.asarray(valid))),
                      (port_norm.normalize_inverse_depth_bbox2(t32(depth),
                                                               torch.from_numpy(valid),
                                                               return_st=True),
                       dp(jnp.asarray(depth), jnp.asarray(valid)))):
        for g, w, what in zip(got, want, ("out", "s", "t")):
            rel_close(g, np.asarray(w), what=what)
    # the default call returns the map alone
    assert port_norm.normalize_pointcloud_bbox2(t32(pts), torch.from_numpy(valid)).shape == \
        pts.shape


def test_quantile_index_truncates_like_jax():
    """n_valid * ratio with a fractional part: both take the truncated index."""
    values = np.arange(149, dtype=np.float32)[::-1].copy()
    valid = np.ones(149, bool)
    want = jax.jit(lambda v, m: jax_norm._quantile_bounds(v, m, 0.02, 0.98))(
        jnp.asarray(values), jnp.asarray(valid))
    got = port_norm._quantile_bounds(t32(values), torch.from_numpy(valid), 0.02, 0.98)
    assert [float(g) for g in got] == [float(w) for w in want] == [2.0, 146.0]


def test_plucker_and_ray_options_match_jax():
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    center = rng.normal(size=3).astype(np.float32)
    dirs = rng.normal(size=(6, 9, 3)).astype(np.float32)
    got = port_rays.plucker_from_pose(t32(R), t32(center), t32(dirs))
    want = jax.jit(jax_rays.plucker_from_pose)(R, center, dirs)
    for g, w in zip(got, want):
        rel_close(g, np.asarray(w))

    origins = rng.normal(size=(40, 3)).astype(np.float32)
    ray_dirs = rng.normal(size=(40, 3)).astype(np.float32)
    weights = rng.uniform(0.1, 2.0, size=40).astype(np.float32)
    rel_close(port_rays.intersect_skew_lines(t32(origins), t32(ray_dirs), t32(weights)),
              np.asarray(jax.jit(jax_rays.intersect_skew_lines)(origins, ray_dirs, weights)))

    raydirs = rng.normal(size=(3, 8, 10, 3)).astype(np.float32)
    moments = rng.normal(size=(3, 8, 10, 3)).astype(np.float32)
    ref = rng.normal(size=(8, 8, 3)).astype(np.float32)
    got = port_rays.cameras_from_plucker(t32(raydirs), t32(moments), t32(ref))
    want = jax.jit(jax_rays.cameras_from_plucker)(raydirs, moments, ref)
    for g, w in zip(got, want):
        rel_close(g, np.asarray(w))

    for hom in (False, True):
        np.testing.assert_array_equal(xy_grid(5, 3, homogeneous=hom).numpy(),
                                      np.asarray(jax_xy_grid(5, 3, hom)))


def test_focal_helpers_match_jax():
    rng = np.random.default_rng(4)
    fov = rng.uniform(0.5, 1.5, size=7).astype(np.float32)
    rel_close(port_moge.focal_px_from_fov(t32(fov), 640),
              np.asarray(jax.jit(lambda f: jax_moge.focal_px_from_fov(f, 640))(fov)))
    h, w, f = 24, 32, 30.0
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    depth = rng.uniform(2, 6, size=(h, w)).astype(np.float32)
    pts = np.stack([(xx - (w - 1) / 2) / f * depth, (yy - (h - 1) / 2) / f * depth, depth], -1)
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    got = port_moge.estimate_focal_weiszfeld(t32(pts))
    want = jax.jit(jax_moge.estimate_focal_weiszfeld)(jnp.asarray(pts))
    rel_close(got, np.asarray(want))
    assert float(got) == pytest.approx(f, rel=1e-2)


@pytest.mark.parametrize("outlier_rel_err", [0.6, 0.2])
def test_recover_group_focals_outlier_option_matches_jax(outlier_rel_err):
    """Four windows' first frames at focals 100, 100, 110 and 300 px: at 0.6
    only the last is clamped to the mean, at 0.2 all are."""
    rng = np.random.default_rng(5)
    h, w = 48, 64
    yy, xx = np.mgrid[:h, :w]
    maps = []
    for f in (100.0, 100.0, 110.0, 300.0):
        z = rng.uniform(2, 4, size=(h, w))
        maps.append(np.stack([(xx - w / 2) / f * z, (yy - h / 2) / f * z, z], -1))
    maps = np.stack(maps).astype(np.float32)
    conf = np.ones(maps.shape[:3], np.float32)
    got = port_init.recover_group_focals(t32(maps), t32(conf), outlier_rel_err)
    want = jax_init.recover_group_focals(maps, conf, outlier_rel_err)
    rel_close(got, want)
    assert (np.unique(np.round(got, 3)).size == 1) == (outlier_rel_err == 0.2)


# ---- trajectories and plots -------------------------------------------------

def poses(rng, n):
    q = rng.normal(size=(n, 4))
    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :3] = jax_traj.quat_wxyz_to_rotmat(q)
    P[:, :3, 3] = rng.normal(size=(n, 3))
    return P


def test_tum_files_and_trajectory_options_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    est, ref, T = poses(rng, 11), poses(rng, 11), poses(rng, 1)[0]
    ts = np.linspace(0.5, 3.0, 11)
    pe, je = (m.Trajectory.from_matrices(est, ts) for m in (port_traj, jax_traj))
    pr, jr = (m.Trajectory.from_matrices(ref) for m in (port_traj, jax_traj))
    np.testing.assert_array_equal(pe.timestamps, je.timestamps)
    port_traj.save_tum(str(tmp_path / "port.txt"), pe)
    jax_traj.save_tum(str(tmp_path / "jax.txt"), je)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    back = port_traj.load_tum(str(tmp_path / "jax.txt"))
    want = jax_traj.load_tum(str(tmp_path / "jax.txt"))
    np.testing.assert_array_equal(back.matrices(), want.matrices())
    np.testing.assert_array_equal(back.timestamps, want.timestamps)
    np.testing.assert_array_equal(pe.transformed(T, 1.7).matrices(),
                                  je.transformed(T, 1.7).matrices())
    for cs in (True, False):
        got, want = port_traj.umeyama_align(pe, pr, cs), jax_traj.umeyama_align(je, jr, cs)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert port_traj.ape_translation_rmse(pe, pr, correct_scale=cs) == \
            jax_traj.ape_translation_rmse(je, jr, correct_scale=cs)
        for delta in (1, 3):
            for align in (True, False):
                assert port_traj.rpe(pe, pr, delta, align, cs) == \
                    jax_traj.rpe(je, jr, delta, align, cs)


@pytest.mark.parametrize("correct_scale", [True, False])
def test_plot_trajectory_matches_jax(tmp_path, correct_scale):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(7)
    est, ref = poses(rng, 9), poses(rng, 9)
    port_plots.plot_trajectory(str(tmp_path / "port.png"),
                               port_traj.Trajectory.from_matrices(est),
                               port_traj.Trajectory.from_matrices(ref), "t",
                               correct_scale=correct_scale)
    jax_plots.plot_trajectory(str(tmp_path / "jax.png"), jax_traj.Trajectory.from_matrices(est),
                              jax_traj.Trajectory.from_matrices(ref), "t",
                              correct_scale=correct_scale)
    np.testing.assert_array_equal(read_png(str(tmp_path / "port.png")),
                                  read_png(str(tmp_path / "jax.png")))


# ---- glTF, depth visualisations ----------------------------------------------

def glb_chunks(path):
    data = open(path, "rb").read()
    magic, version, total = struct.unpack("<III", data[:12])
    assert (magic, version, total) == (0x46546C67, 2, len(data))
    n_json = struct.unpack("<I", data[12:16])[0]
    n_bin = struct.unpack("<I", data[20 + n_json:24 + n_json])[0]
    return json.loads(data[20:20 + n_json]), data[28 + n_json:28 + n_json + n_bin]


def assert_same_glb(a, b):
    (ja, ba), (jb, bb) = glb_chunks(a), glb_chunks(b)
    assert ja == jb
    assert ba == bb


@pytest.mark.parametrize("n", [0, 1, 37])
def test_pointcloud_glb_matches_jax(tmp_path, n):
    rng = np.random.default_rng(8)
    pts, cols = rng.normal(size=(n, 3)), rng.uniform(size=(n, 3))
    port_export.write_pointcloud_glb(str(tmp_path / "p.glb"), pts, cols)
    jax_export.write_pointcloud_glb(str(tmp_path / "j.glb"), pts, cols)
    assert_same_glb(tmp_path / "p.glb", tmp_path / "j.glb")


@pytest.mark.parametrize("masked", [False, True])
def test_mesh_matches_jax(tmp_path, masked):
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(6, 8, 3)).astype(np.float32)
    cols = rng.uniform(size=(6, 8, 3)).astype(np.float32)
    mask = rng.random((6, 8)) > 0.2 if masked else None
    got, want = port_export.pointmap_to_mesh(pts, cols, mask), jax_export.pointmap_to_mesh(
        pts, cols, mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    port_export.write_mesh_glb(str(tmp_path / "p.glb"), *got)
    jax_export.write_mesh_glb(str(tmp_path / "j.glb"), *want)
    assert_same_glb(tmp_path / "p.glb", tmp_path / "j.glb")


def test_jet_table_equals_matplotlib():
    mpl_cm = pytest.importorskip("matplotlib.cm")
    jet = mpl_cm.jet
    jet._init()
    np.testing.assert_array_equal(port_export.jet_lut(), jet._lut[:256, :3])
    x = np.linspace(0, 1, 1001, dtype=np.float32)
    np.testing.assert_array_equal(port_export.jet_lut()[port_export.jet_indices(x)],
                                  jet(x)[:, :3])


@pytest.mark.parametrize("n,fps", [(3, 8), (1, 10)])
def test_depth_visualizations_match_jax(tmp_path, n, fps):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(10)
    depths = rng.uniform(0.5, 10, size=(n, 20, 30)).astype(np.float32)
    depths[0, :3] = 1e3     # a far patch beyond the 98th percentile
    port_export.save_depth_visualizations(str(tmp_path / "port"), depths, fps)
    jax_export.save_depth_visualizations(str(tmp_path / "jax"), depths, fps)
    gif = Image.open(tmp_path / "port" / "depth.gif")
    assert gif.n_frames == n and gif.info["duration"] == (1000 // fps) // 10 * 10
    for i in range(n):
        png = read_png(str(tmp_path / "port" / f"depth_{i:04d}.png"))
        np.testing.assert_array_equal(png, np.asarray(Image.open(
            tmp_path / "jax" / f"depth_{i:04d}.png")))
        gif.seek(i)
        np.testing.assert_array_equal(np.asarray(gif.convert("RGB")), png)


# ---- video grids ------------------------------------------------------------

def read_avi(path):
    cv2 = pytest.importorskip("cv2")
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return np.stack(frames)


@pytest.fixture
def jax_grids(monkeypatch):
    """The grids the JAX package hands its mp4 writer, as that writer would
    quantise them."""
    seen = []

    def record(path, frames, fps=8):
        if frames.dtype != np.uint8:
            frames = ((np.clip(frames, -1, 1) + 1) / 2 * 255).astype(np.uint8)
        seen.append((frames, fps))
        return path

    monkeypatch.setattr(jax_save_video, "frames_to_mp4", record)
    return seen


@pytest.mark.parametrize("n,ncols,w,dtype", [(3, 2, 16, np.float32), (5, 4, 13, np.uint8),
                                             (1, 4, 7, np.float32)])
def test_save_video_grid_matches_jax(tmp_path, jax_grids, n, ncols, w, dtype):
    rng = np.random.default_rng(11)
    if dtype == np.uint8:
        videos = [rng.integers(0, 256, size=(4, 6, w, 3), dtype=np.uint8) for _ in range(n)]
    else:
        videos = [rng.uniform(-1.2, 1.2, size=(4, 6, w, 3)).astype(np.float32)
                  for _ in range(n)]
    path = save_video_grid(str(tmp_path / "grid.avi"), videos, fps=10, ncols=ncols)
    jax_save_video.save_video_grid(str(tmp_path / "grid.mp4"), videos, fps=10, ncols=ncols)
    (want, fps), = jax_grids
    assert fps == 10
    np.testing.assert_array_equal(read_avi(path), want)


def test_sample_logger_matches_jax(tmp_path, jax_grids):
    rng = np.random.default_rng(12)
    videos = [rng.uniform(-1, 1, size=(3, 8, 12, 3)).astype(np.float32) for _ in range(2)]
    port, ref = SampleLogger(str(tmp_path / "port"), every=5), JaxSampleLogger(
        str(tmp_path / "jax"), every=5)
    assert port.maybe_log(3, videos) is None and ref.maybe_log(3, videos) is None
    path = port.maybe_log(10, videos)
    ref.maybe_log(10, videos)
    assert path == os.path.join(str(tmp_path / "port"), "samples", "step_00000010.avi")
    (want, _), = jax_grids
    np.testing.assert_array_equal(read_avi(path), want)


# ---- sampling, profiling, frames -------------------------------------------

def test_ddim_temperature_matches_jax():
    """eta 0.5: every step but the last adds sigma_t * noise * temperature;
    the port is handed the JAX package's step noise."""
    shape, steps, temp = (2, 3, 4, 5, 6), 5, 0.37
    x_T = np.random.default_rng(13).normal(size=shape).astype(np.float32)
    sched = dict(parameterization="v", rescale_betas_zero_snr=True)
    jt = JaxDDIMTables.from_schedule(DiffusionSchedule.create(**sched), steps, eta=0.5)
    pt = DDIMTables.from_schedule(PortDiffusionSchedule.create(**sched), steps, eta=0.5)

    def model(x, t, b, lib):
        return lib.tanh(x) + t / 1000.0

    key = jax.random.PRNGKey(0)
    noise_keys = jax.random.split(jax.random.split(key)[0], steps)
    sigmas = np.asarray(pt.sigmas)[::-1]
    assert (sigmas[:-1] > 0).all()
    draws = [np.array(jax.random.normal(k, shape))
             for k, s in zip(noise_keys, sigmas) if s != 0]
    want = jax_ddim_sample(lambda x, t, b: model(x, t, b, jnp), shape, jt, key,
                           x_T=jnp.asarray(x_T), temperature=temp)
    got = ddim_sample(lambda x, t, b: model(x, t, b, torch), shape, pt,
                      device=torch.device("cpu"), generator=GivenDraws(draws),
                      x_T=t32(x_T), temperature=temp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    events = json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_load_image_dir_exts_match_jax(tmp_path):
    rng = np.random.default_rng(14)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, size=(20, 30, 3), dtype=np.uint8)).save(
            tmp_path / f"{i:03d}.png")
    Image.fromarray(rng.integers(0, 256, size=(20, 30, 3), dtype=np.uint8)).save(
        tmp_path / "003.jpg", quality=90)
    for exts in ((".png",), (".png", ".jpg")):
        got, names = load_image_dir(str(tmp_path), (24, 16), exts=exts)
        want, want_names = jax_load_image_dir(str(tmp_path), (24, 16), exts, raw_uint8=True)
        assert names == want_names and len(names) == len(exts) + 2
        np.testing.assert_array_equal(got, want)
