"""The rigid-flow surface of the port against the JAX package, on the CPU in
float32: geometry/warp.py, the aligner's flow term, data/preprocess.py
(read_flo, sintel_get_dynamics, compute_dynamic_masks, the prepare_*
subsets) and the exporter's dynamic masks and confidence threshold.

Tolerances:
  * the warp functions: 1e-5 relative (to each output's largest entry);
    occlusion masks equal except where the consistency test sits within
    1e-5 (relative) of its bound, counted;
  * the aligner's loss with the flow term on: value 1e-5 relative; the
    term's gradient 5e-5 relative L2 per leaf (measured up to 2.6e-5: in
    float32 each package's gradient is up to ~2e-5 from a float64
    evaluation of the same term, whose pixel sums cancel);
  * dynamic masks: equal except at pixels within 1e-5 (relative) of the
    threshold, counted;
  * read_flo, sintel_get_dynamics and the exporter: exact (PNG pixels
    equal to the Pillow-written ones; other files byte for byte).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from geo4d_tpu.alignment.init import init_from_group as jax_init_from_group
from geo4d_tpu.alignment.optimizer import AlignerConfig as JaxAlignerConfig
from geo4d_tpu.alignment.optimizer import GroupAligner as JaxGroupAligner
from geo4d_tpu.data import preprocess as jax_pre
from geo4d_tpu.geometry import warp as jax_warp
from geo4d_tpu.pipeline.export import save_results_dir as jax_save_results_dir
from geo4d_tpu_torch.alignment.optimizer import GroupAligner
from geo4d_tpu_torch.data import preprocess as port_pre
from geo4d_tpu_torch.data.images import read_png
from geo4d_tpu_torch.geometry import warp as port_warp
from geo4d_tpu_torch.pipeline.export import save_results_dir
from _torch_parity import aligner_state_from_jax, load_aligner_state, rel_err, to_torch
from test_torch_alignment import GROUPS, close, port_config, scene

torch.set_num_threads(1)
RTOL = 1e-5
GRAD_REL = 5e-5
TAG = 202021.25


def jnp_args(*arrays):
    return [jnp.asarray(a) for a in arrays]


def camera_pair(rng, n):
    """n c2w poses: small turns about y and moves, float32."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = 0.04 * i + rng.normal(0, 0.01)
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [0.1 * i, 0.02 * i, 0.05 * i] + rng.normal(0, 0.01, 3)
    return poses


def flow_inputs(seed=0, n=4, h=24, w=40):
    rng = np.random.default_rng(seed)
    depths = rng.uniform(2.0, 6.0, (n, h, w)).astype(np.float32)
    poses = camera_pair(rng, n)
    K = np.array([[30.0, 0, w / 2], [0, 32.0, h / 2], [0, 0, 1]], np.float32)
    flows = rng.normal(0, 3.0, (n - 1, h, w, 2)).astype(np.float32)
    masks = (rng.uniform(size=(n - 1, h, w)) > 0.3).astype(np.float32)
    return depths, poses, K, flows, masks


def test_bilinear_sample_and_warp_image():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 12, 20, 3)).astype(np.float32)
    coords = rng.uniform(-3, 23, size=(2, 9, 11, 2)).astype(np.float32)   # some off the image
    flow = rng.normal(0, 4, size=(2, 12, 20, 2)).astype(np.float32)
    got = port_warp.bilinear_sample(to_torch(img), to_torch(coords))
    want = jax.vmap(jax_warp.bilinear_sample)(*jnp_args(img, coords))
    close(got, np.asarray(want), RTOL, "bilinear_sample")
    got = port_warp.warp_image(to_torch(img), to_torch(flow))
    want = jax.vmap(jax_warp.warp_image)(*jnp_args(img, flow))
    close(got, np.asarray(want), RTOL, "warp_image")
    # one image, coordinates of any shape (the JAX signature)
    got = port_warp.bilinear_sample(to_torch(img[0]), to_torch(coords[0, :4, 0]))
    close(got, np.asarray(jax_warp.bilinear_sample(*jnp_args(img[0], coords[0, :4, 0]))),
          RTOL, "bilinear_sample (H, W, C)")


def test_depth_based_flow():
    depths, poses, K, _, _ = flow_inputs()
    flow, valid = port_warp.depth_based_flow(to_torch(depths[:-1]), to_torch(poses[:-1]),
                                             to_torch(poses[1:]), to_torch(K))
    want_flow, want_valid = jax.vmap(jax_warp.depth_based_flow, (0, 0, 0, None))(
        *jnp_args(depths[:-1], poses[:-1], poses[1:], K))
    close(flow, np.asarray(want_flow), RTOL, "flow")
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def test_occlusion_mask():
    depths, poses, K, _, _ = flow_inputs(2)
    fwd, _ = port_warp.depth_based_flow(to_torch(depths[:-1]), to_torch(poses[:-1]),
                                        to_torch(poses[1:]), to_torch(K))
    bwd, _ = port_warp.depth_based_flow(to_torch(depths[1:]), to_torch(poses[1:]),
                                        to_torch(poses[:-1]), to_torch(K))
    bwd = bwd + torch.from_numpy(np.random.default_rng(3).normal(0, 0.6, bwd.shape)
                                 .astype(np.float32))
    got = port_warp.occlusion_mask(fwd, bwd).numpy()
    want = np.asarray(jax.vmap(jax_warp.occlusion_mask)(*jnp_args(fwd.numpy(), bwd.numpy())))
    assert 0 < want.mean() < 1                              # both outcomes occur
    # the test's margin, from the JAX package's inputs
    f, b = fwd.numpy().astype(np.float64), bwd.numpy().astype(np.float64)
    b_at = np.asarray(jax.vmap(jax_warp.bilinear_sample)(*jnp_args(
        b.astype(np.float32), (f + np.stack(np.meshgrid(np.arange(40), np.arange(24)), -1))
        .astype(np.float32)))).astype(np.float64)
    diff = ((f + b_at) ** 2).sum(-1)
    bound = 0.01 * ((f ** 2).sum(-1) + (b_at ** 2).sum(-1)) + 0.5
    near = np.abs(diff - bound) <= RTOL * bound
    assert not ((got != want) & ~near).any()
    print(f"occlusion_mask: {int(near.sum())} pixels within 1e-5 of the bound")


@pytest.mark.parametrize("fn", ["l1", "l2"])
def test_flow_loss(fn):
    depths, poses, K, flows, masks = flow_inputs(4)
    got = port_warp.flow_loss(*map(to_torch, (depths, poses, K, flows, masks)), fn=fn)
    want = jax_warp.flow_loss(*jnp_args(depths, poses, K, flows, masks), fn=fn)
    assert abs(got.item() - float(want)) <= RTOL * abs(float(want))


# ---------------- the aligner's flow term ----------------

def flow_scene():
    """tests/test_torch_alignment.py's scene with target flows from its
    ground truth (depth_based_flow at the true focal), 0.3 px of noise, and
    random flow masks."""
    sc = scene(noise=0.03)
    h, w = sc["hw"]
    f = sc["focal"]
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    depths = sc["depths"].astype(np.float32)
    poses = sc["poses"].astype(np.float32)
    flows, _ = jax.vmap(jax_warp.depth_based_flow, (0, 0, 0, None))(
        *jnp_args(depths[:-1], poses[:-1], poses[1:], K))
    rng = np.random.default_rng(11)
    sc["flows"] = (np.asarray(flows) + rng.normal(0, 0.3, flows.shape)).astype(np.float32)
    sc["flow_masks"] = (rng.uniform(size=flows.shape[:-1]) > 0.2).astype(np.float32)
    return sc


@pytest.mark.parametrize("fn", ["l1", "l2"])
def test_aligner_flow_term_matches_jax(fn):
    sc = flow_scene()
    cfg = dict(n_iter=40, flow_loss_weight=0.1, flow_loss_fn=fn, flow_loss_start_frac=0.1)
    jcfg = JaxAlignerConfig(bucket_groups=1, bucket_frames=1, **cfg)
    ja = JaxGroupAligner(GROUPS, sc["preds"], sc["conf"], sc["hw"], config=jcfg,
                         target_flows=sc["flows"], flow_masks=sc["flow_masks"])
    jax_init_from_group(ja, jnp.asarray(sc["preds"]), jnp.asarray(sc["conf"]))
    pa = GroupAligner(GROUPS, sc["preds"], sc["conf"], sc["hw"], config=port_config(jcfg),
                      target_flows=sc["flows"], flow_masks=sc["flow_masks"], device="cpu")
    load_aligner_state(pa, aligner_state_from_jax(ja))
    assert pa.has_flow
    for frac in (0.05, 0.5):                   # before and after the term starts
        val_j = ja.loss_fn(ja.params, False, frac)
        assert abs(pa.loss_fn(pa.params, False, frac).item() - float(val_j)) \
            <= RTOL * abs(float(val_j)), frac
    # the term alone: the JAX loss with it on less the loss before it starts
    # (the point-map term's gradient is held at 1e-4 in
    # tests/test_torch_alignment.py: its L1 residuals near zero take float32
    # summation order into the sign)
    val_j, grad_j = jax.value_and_grad(
        lambda p: ja.loss_fn(p, False, 0.5) - ja.loss_fn(p, False, 0.05))(ja.params)
    params = {k: p.detach().clone().requires_grad_() for k, p in pa.params.items()}
    val_p = 0.1 * pa._flow_term(params)
    grads = torch.autograd.grad(val_p, list(params.values()), allow_unused=True)
    assert abs(val_p.item() - float(val_j)) <= RTOL * abs(float(val_j))
    for (name, p), g in zip(params.items(), grads):
        want = np.asarray(grad_j[name])[: p.shape[0]]
        if np.abs(want).max() == 0:
            assert g is None or not g.any(), name
            continue
        assert rel_err(g.numpy(), want) <= GRAD_REL, (name, rel_err(g.numpy(), want))
    flow_off = GroupAligner(GROUPS, sc["preds"], sc["conf"], sc["hw"], config=port_config(jcfg),
                            device="cpu")
    load_aligner_state(flow_off, aligner_state_from_jax(ja))
    on, off = pa.loss_fn(pa.params, False, 0.5).item(), flow_off.loss_fn(pa.params, False).item()
    assert on > off and pa.loss_fn(pa.params, False, 0.05).item() == off


# ---------------- data/preprocess.py ----------------

def test_compute_dynamic_masks():
    depths, poses, K, _, _ = flow_inputs(5, n=5)
    rigid, _ = jax.vmap(jax_warp.depth_based_flow, (0, 0, 0, None))(
        *jnp_args(depths[:-1], poses[:-1], poses[1:], K))
    rng = np.random.default_rng(6)
    obs = np.asarray(rigid) + rng.normal(0, 1.0, rigid.shape).astype(np.float32)
    obs[:, 5:12, 8:20] += 8.0                           # a moving object
    obs = obs.astype(np.float32)
    got = port_pre.compute_dynamic_masks(*map(to_torch, (obs, depths, poses, K))).numpy()
    want = np.asarray(jax_pre.compute_dynamic_masks(*jnp_args(obs, obs, depths, poses, K)))
    assert got.shape == (4, 24, 40) and 0.05 < want.mean() < 0.95
    f = np.asarray(rigid, np.float64)
    ratio = np.linalg.norm(obs - f, axis=-1) / (np.linalg.norm(obs, axis=-1) + 1.0)
    near = np.abs(ratio - 0.35) <= RTOL * 0.35
    assert not ((got != want) & ~near).any()
    print(f"compute_dynamic_masks: {int(near.sum())} pixels within 1e-5 of the threshold")


def write_flo(path, flow):
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def write_sintel_flow_sequence(base, seq="alley_2", n=4, h=20, w=36):
    """Sintel's depth/, camdata_left/ and flow/ of a short sequence: random
    depths, moving cameras, and GT flow = the rigid flow plus a moving patch."""
    rng = np.random.default_rng(7)
    dirs = {d: os.path.join(base, d, seq) for d in ("depth", "camdata_left", "flow")}
    for d in dirs.values():
        os.makedirs(d)
    poses = camera_pair(rng, n).astype(np.float64)
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    depths = rng.uniform(2, 6, (n, h, w)).astype(np.float32)
    for i in range(n):
        name = f"frame_{i + 1:04d}"
        with open(os.path.join(dirs["depth"], name + ".dpt"), "wb") as f:
            np.array([TAG], np.float32).tofile(f)
            np.array([w, h], np.int32).tofile(f)
            depths[i].tofile(f)
        with open(os.path.join(dirs["camdata_left"], name + ".cam"), "wb") as f:
            np.array([TAG], np.float32).tofile(f)
            K.tofile(f)
            np.linalg.inv(poses[i])[:3].tofile(f)
    rigid, _ = jax.vmap(jax_warp.depth_based_flow, (0, 0, 0, None))(
        *jnp_args(depths[:-1], poses[:-1].astype(np.float32), poses[1:].astype(np.float32),
                  K.astype(np.float32)))
    for i in range(n - 1):
        flow = np.asarray(rigid[i]) + rng.normal(0, 2, (h, w, 2))
        flow[4:12, 6:20] += 25.0
        write_flo(os.path.join(dirs["flow"], f"frame_{i + 1:04d}.flo"), flow)
    return seq


def test_read_flo_exact(tmp_path):
    flow = np.random.default_rng(8).normal(size=(7, 11, 2)).astype(np.float32)
    write_flo(tmp_path / "a.flo", flow)
    got = port_pre.read_flo(str(tmp_path / "a.flo"))
    np.testing.assert_array_equal(got, jax_pre.read_flo(str(tmp_path / "a.flo")))
    np.testing.assert_array_equal(got, flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="tag"):
        port_pre.read_flo(str(tmp_path / "bad.flo"))


@pytest.mark.parametrize("continuous", [False, True])
def test_sintel_get_dynamics_exact(tmp_path, continuous):
    seq = write_sintel_flow_sequence(str(tmp_path))
    got = port_pre.sintel_get_dynamics(str(tmp_path), seq, continuous=continuous, save_dir="port")
    want = jax_pre.sintel_get_dynamics(str(tmp_path), seq, continuous=continuous, save_dir="jax")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3
    for a, b in zip(got, want):
        pa, pb = read_png(a), np.asarray(Image.open(b))
        np.testing.assert_array_equal(pa, pb)
    if not continuous:
        assert 0 < (read_png(got[0]) > 0).mean() < 1


def test_prepare_subsets_match_jax(tmp_path):
    """The prepare_* file operations on a small tree give the same files."""
    for side in ("port", "jax"):
        root = tmp_path / side
        bonn = root / "bonn" / "rgbd_bonn_balloon2"
        tum = root / "tum" / "seqA"
        scan = root / "scannet" / "scene0000"
        kitti = root / "kitti"
        for d in (bonn / "rgb", bonn / "depth", tum / "rgb", scan / "color", scan / "depth",
                  scan / "pose", kitti / "image", kitti / "groundtruth_depth"):
            d.mkdir(parents=True)
        for i in range(12):
            for d in (bonn / "rgb", bonn / "depth", tum / "rgb"):
                (d / f"{i:05d}.png").write_bytes(bytes([i]))
            (scan / "color" / f"{i}.jpg").write_bytes(bytes([i]))
            (scan / "depth" / f"{i}.png").write_bytes(bytes([i]))
            np.savetxt(scan / "pose" / f"{i}.txt", np.eye(4) * (i + 1))
        for f in (bonn / "groundtruth.txt", tum / "groundtruth.txt"):
            f.write_text("# header\n" + "".join(f"{i} 0 0 0 0 0 0 1\n" for i in range(12)))
        for name in ("2011_09_26_drive_0002_sync_image_0000000005_image_02.png",
                     "2011_09_26_drive_0009_sync_image_0000000010_image_03.png"):
            (kitti / "image" / name).write_bytes(b"x")
            (kitti / "groundtruth_depth" / name).write_bytes(b"y")
        mod = port_pre if side == "port" else jax_pre
        mod.prepare_bonn(str(root / "bonn"), ["balloon2"], n_frames=5)
        mod.prepare_tum(str(root / "tum"), n_frames=3, stride=3)
        mod.prepare_scannet(str(root / "scannet"), n_frames=3, stride=3)
        mod.prepare_kitti(str(kitti))

    def tree(root):
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
        return out

    port_tree, jax_tree = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert port_tree == jax_tree
    assert "scannet/scene0000/pose_3.txt" in port_tree
    assert "kitti/image_gathered/2011_09_26_drive_0009_sync/" \
           "2011_09_26_drive_0009_sync_image_0000000010_image_03.png" in port_tree


# ---------------- the exporter ----------------

def test_export_dynamic_masks_and_conf_threshold_match_jax(tmp_path):
    sc = scene()
    conf = np.random.default_rng(9).uniform(0.2, 3.0, sc["conf"].shape).astype(np.float32)
    jcfg = JaxAlignerConfig(bucket_groups=1, bucket_frames=1, n_iter=0)
    ja = JaxGroupAligner(GROUPS, sc["preds"], conf, sc["hw"], config=jcfg)
    jax_init_from_group(ja, jnp.asarray(sc["preds"]), jnp.asarray(conf))
    pa = GroupAligner(GROUPS, sc["preds"], conf, sc["hw"], config=port_config(jcfg),
                      device="cpu")
    load_aligner_state(pa, aligner_state_from_jax(ja))
    n = pa.N
    masks = np.random.default_rng(10).uniform(size=(n,) + sc["hw"]) > 0.7
    frames = np.random.default_rng(11).integers(0, 256, (n,) + sc["hw"] + (3,), dtype=np.uint8)
    kw = dict(rgb_frames=frames, conf_threshold=1.5, dynamic_masks=masks)
    save_results_dir(str(tmp_path / "port"), pa, **kw)
    jax_save_results_dir(str(tmp_path / "jax"), pa, **kw)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert f"enlarged_dynamic_mask_{n - 1}.png" in names and "scene.glb" in names
    for fname in names:
        a, b = tmp_path / "port" / fname, tmp_path / "jax" / fname
        if fname.endswith(".png"):
            np.testing.assert_array_equal(read_png(str(a)), np.asarray(Image.open(b)), fname)
        else:
            assert a.read_bytes() == b.read_bytes(), fname
    np.testing.assert_array_equal(read_png(str(tmp_path / "port" / "enlarged_dynamic_mask_0.png")),
                                  masks[0].astype(np.uint8) * 255)
    # the threshold takes points out of the cloud
    save_results_dir(str(tmp_path / "all"), pa, rgb_frames=frames)
    assert (tmp_path / "all" / "scene.glb").stat().st_size > (tmp_path / "port" /
                                                                "scene.glb").stat().st_size
