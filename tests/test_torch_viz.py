"""The port's 4D viewer (geo4d_tpu_torch/viz/) against the JAX package's on
the same results directory, on the CPU: `load_results_dir` returns equal
arrays (exactly), `export_html` writes equal bytes, and the two websocket
servers send the same page, meta message, frame payloads and live updates
(exactly). The CLIs take the same flags."""

import json
import os

import numpy as np
import pytest

from geo4d_tpu.evals.trajectory import Trajectory
from geo4d_tpu.viz import server as jax_server
from geo4d_tpu.viz import visualizer as jax_vis
from geo4d_tpu_torch.data.images import write_png
from geo4d_tpu_torch.tools.offline_check import fetch_viewer, ViewerClient
from geo4d_tpu_torch.viz import server as port_server
from geo4d_tpu_torch.viz import visualizer as port_vis


def write_results(path, n=3, h=8, w=10, pngs=True, seed=0):
    """tests/test_viz.py's results directory, with frame PNGs."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = np.arange(n) * 0.1
    poses[:, 2, 3] = rng.normal(0, 0.1, n)
    np.savetxt(path / "pred_traj.txt", Trajectory.from_matrices(poses).to_tum())
    K = np.tile(np.eye(3), (n, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 12.0
    K[:, 0, 2], K[:, 1, 2] = w / 2, h / 2
    np.savetxt(path / "pred_intrinsics.txt", K.reshape(n, 9))
    for i in range(n):
        np.save(path / f"frame_{i:04d}.npy", rng.uniform(2, 5, (h, w)).astype(np.float32))
        conf = rng.uniform(0, 1, (h, w)).astype(np.float32)
        conf[0] = 0.0
        np.save(path / f"conf_{i:04d}.npy", conf)
        if pngs:
            write_png(str(path / f"frame_{i:04d}.png"),
                      rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(path)


@pytest.fixture
def results_dir(tmp_path):
    return write_results(tmp_path)


@pytest.mark.parametrize("pngs,downsample,stride", [(True, 1, 1), (True, 2, 1), (False, 1, 2)])
def test_load_results_dir_matches_jax(tmp_path, pngs, downsample, stride):
    d = write_results(tmp_path, pngs=pngs)
    got = port_vis.load_results_dir(d, stride=stride, downsample=downsample)
    want = jax_vis.load_results_dir(d, stride=stride, downsample=downsample)
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) == len(want[0])
    for (p, c), (pw, cw) in zip(got[0], want[0]):
        assert p.dtype == pw.dtype and c.dtype == cw.dtype
        np.testing.assert_array_equal(p, pw)
        np.testing.assert_array_equal(c, cw)


@pytest.mark.parametrize("max_points", [60000, 20])
def test_export_html_writes_jax_bytes(results_dir, tmp_path, max_points):
    a = port_vis.export_html(results_dir, str(tmp_path / "port.html"), max_points=max_points)
    b = jax_vis.export_html(results_dir, str(tmp_path / "jax.html"), max_points=max_points)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_visualizer_cli_matches_jax(results_dir, tmp_path):
    for who, mod in (("port", port_vis), ("jax", jax_vis)):
        mod.main(["--data", results_dir, "--out", str(tmp_path / f"{who}.html"), "--stride", "2",
                  "--downsample", "1"])
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


def test_servers_send_the_same_messages(results_dir):
    """The player page, the meta message, every frame payload and a live
    update, from both servers over one results directory."""
    import urllib.request

    servers = [mod.ViewerServer(results_dir, port=0).start() for mod in (port_server, jax_server)]
    try:
        pages = [urllib.request.urlopen(f"http://127.0.0.1:{s.port}/", timeout=10).read()
                 for s in servers]
        assert pages[0] == pages[1]
        got, want = (fetch_viewer(s.port) for s in servers)
        assert got[0] == want[0] and json.loads(got[0])["n_frames"] == 3
        assert got[1] == want[1] and len(got[1]) == 3
        clients = [ViewerClient(s.port) for s in servers]
        for c in clients:
            c.recv()
        d = np.load(os.path.join(results_dir, "frame_0000.npy"))
        np.save(os.path.join(results_dir, "frame_0003.npy"), d)
        traj = np.loadtxt(os.path.join(results_dir, "pred_traj.txt"))
        np.savetxt(os.path.join(results_dir, "pred_traj.txt"),
                   np.vstack([traj, [3, 0, 0, 0, 0, 0, 0, 1]]))
        K = np.loadtxt(os.path.join(results_dir, "pred_intrinsics.txt"))
        np.savetxt(os.path.join(results_dir, "pred_intrinsics.txt"), np.vstack([K, K[-1:]]))
        updates = []
        for s, c in zip(servers, clients):
            s.store.reload()
            s._broadcast({"type": "update", "n_frames": s.store.meta()["n_frames"]})
            updates.append(c.recv())
            c.send_text(json.dumps({"type": "get", "i": 3}))
            updates.append(c.recv())
            c.close()
        assert updates[0] == updates[2] and json.loads(updates[0][1])["n_frames"] == 4
        assert updates[1] == updates[3] and updates[1][0] == 0x2
    finally:
        for s in servers:
            s.stop()


def test_server_cli_takes_jax_flags(monkeypatch, results_dir):
    seen = []

    class Recorder:
        def __init__(self, data, **kw):
            seen.append((data, kw))

        def serve_forever(self):
            pass

    argv = ["--data", results_dir, "--port", "0", "--downsample", "3", "--live"]
    for mod in (port_server, jax_server):
        monkeypatch.setattr(mod, "ViewerServer", Recorder)
        mod.main(argv)
    assert seen[0] == seen[1] == (results_dir, {"port": 0, "live": True, "downsample": 3})


# geo4d_tpu/__init__.py's lazy API (init_params is a deliberate removal)
JAX_API = ("GeoDiffusion", "UNet3D", "AutoencoderKL", "DiffusionSchedule", "GroupAligner",
           "AlignerConfig", "InferenceConfig", "reconstruct", "build_from_yaml", "flagship",
           "tiny", "init_params", "WindowPredictor", "save_results_dir", "DataModule",
           "ViewerServer", "init_from_group")


def test_top_level_api():
    """Every name of the JAX package's lazy API resolves in the port to the
    port's counterpart, but init_params, whose error names init_random_."""
    import geo4d_tpu_torch
    from geo4d_tpu_torch.alignment.optimizer import GroupAligner
    from geo4d_tpu_torch.pipeline.inference import reconstruct

    for name in JAX_API:
        if name != "init_params":
            assert getattr(geo4d_tpu_torch, name).__module__.startswith("geo4d_tpu_torch."), name
    assert geo4d_tpu_torch.ViewerServer is port_server.ViewerServer
    assert geo4d_tpu_torch.reconstruct is reconstruct
    assert geo4d_tpu_torch.GroupAligner is GroupAligner
    with pytest.raises(AttributeError, match="init_random_"):
        geo4d_tpu_torch.init_params
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        geo4d_tpu_torch.nope
