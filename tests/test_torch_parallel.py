"""The port's parallel layer (geo4d_tpu_torch/parallel/, the mesh paths of
training/step.py, pipeline/inference.py, models/checkpoint.py and
cli/train.py) on the CPU: ranks are processes spawned with gloo and a
`file://` store under tmp_path (three spawns of two ranks), their functions
in tests/_torch_dist_worker.py, which loads no JAX.

  * `fsdp_shard_dim` against JAX's `shard_params_fsdp` on the tiny preset's
    UNet (the same parameters sharded, into the same shard sizes);
  * a 2-rank data-parallel step and a 2-rank FSDP step on the JAX dry runs'
    tiny UNet (float32) against the JAX step on a 2-device mesh, JAX's
    draws handed in: the loss within 1e-5, the averaged gradient (AdamW's
    first moment is 0.1 g) within test_torch_training.py's gradient limits,
    the updated master weights and EMA within UPDATE_REL; DP and FSDP bit
    for bit equal;
  * 2-rank `predict_windows` (x_T given, and drawn) and `predict_video`
    against one process at window_batch = 2, within 5e-4 as
    tests/test_parallel.py holds JAX's sharded run;
  * a 2-rank `--fsdp` CLI run of 2 steps resumed in one process for a third,
    against 3 one-process steps at batch 2, and the inference CLI on the
    same two ranks (rank 0 writes the results directory);
  * the dry run; `init_distributed` refusing a mesh larger than the world.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from geo4d_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from geo4d_tpu.models.presets import tiny as jax_tiny
from geo4d_tpu.models.unet3d import UNet3D as JaxUNet3D
from geo4d_tpu.parallel.mesh import make_mesh, replicated, shard_batch, shard_params_fsdp
from geo4d_tpu.training import step as jax_step
from geo4d_tpu_torch.data.images import write_png
from geo4d_tpu_torch.models.presets import init_random_, tiny
from geo4d_tpu_torch.parallel.mesh import fsdp_shard_dim, init_distributed, rank_rows
from geo4d_tpu_torch.pipeline.inference import InferenceConfig, WindowPredictor
from geo4d_tpu_torch.core.draws import Draws, RankDraws
from _torch_parity import KEY_FNS, _leaves, randomize, rel_err, state_dict_from_jax, torch_key
import _torch_dist_worker as worker

torch.set_num_threads(1)

LOSS_REL = 1e-5
GRAD_REL = 1e-4        # per tensor, as tests/test_torch_training.py
TREE_REL = 1e-5        # over the whole tree, as there
ZERO_SHARE = 1e-6
# one AdamW step moves a weight by ~lr sign(g) (+ decay): a gradient within
# rounding of zero may flip its update's sign, so the updated weights and
# the EMA are held in relative L2 over the tree
UPDATE_REL = 1e-6
WINDOW_ATOL = 5e-4     # tests/test_parallel.py's limit for JAX's sharded windows
WORLD = 2

# flax kernel layout -> the port's: port dim d is flax dim PERM[ndim][d]
PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


# ---------------- the FSDP layout rule ----------------


@pytest.fixture(scope="module")
def tiny_unet_shapes():
    jm = jax_tiny(temporal_length=4).unet
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 4, 4, 4, jm.in_channels)), jnp.array([0]),
        jnp.zeros((1, 77 + 64, jm.context_dim)), jnp.array([24])), jax.random.PRNGKey(0))
    port = {n: tuple(p.shape) for n, p in
            tiny(temporal_length=4, device="meta").unet.named_parameters()}
    return shapes, port


@pytest.mark.parametrize("n,min_size", [(2, 1), (2, 2 ** 18), (4, 1), (4, 2 ** 18)])
def test_fsdp_shard_dim_matches_jax(tiny_unet_shapes, n, min_size):
    shapes, port = tiny_unet_shapes
    specs = shard_params_fsdp(make_mesh(n, platform="cpu"), shapes, min_size=min_size)
    sharded = 0
    for (path, leaf), (_, spec) in zip(_leaves(shapes), _leaves(specs)):
        name = torch_key(KEY_FNS["unet"], path)
        jax_dim = next((d for d, a in enumerate(spec.spec) if a == "data"), None)
        dim = fsdp_shard_dim(port[name], n, min_size)
        assert (dim is None) == (jax_dim is None), name
        if dim is None:
            continue
        sharded += 1
        # the same shard size; the same logical axis unless two dims tie
        assert port[name][dim] == leaf.shape[jax_dim], name
        ndim = len(port[name])
        perm = PERM[ndim] if path[-1] == "kernel" and ndim in PERM else tuple(range(ndim))
        if perm[dim] != jax_dim:
            assert leaf.shape[perm[dim]] == leaf.shape[jax_dim], name     # a tie
    if min_size == 1:
        assert sharded > 0


def test_fsdp_shard_dim_rule():
    # the cases of tests/test_parallel.py::test_fsdp_sharding_layout
    assert fsdp_shard_dim((1024, 512), 8, 1024) == 0
    assert fsdp_shard_dim((16,), 8, 1024) is None
    assert fsdp_shard_dim((17, 33), 8, 1) is None
    assert fsdp_shard_dim((), 8, 1) is None
    assert fsdp_shard_dim((6, 8, 8), 4, 1) == 1            # a tie goes to the earlier dim
    assert fsdp_shard_dim((6, 10), 4, 1) is None


def test_rank_rows_and_rank_draws():
    assert [rank_rows(6, 3, r) for r in range(3)] == [slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError, match="split"):
        rank_rows(5, 2, 0)
    whole = Draws.seeded([4, 2], "cpu")
    ranks = [RankDraws(Draws.seeded([4, 2], "cpu"), 2, r) for r in range(2)]
    for shape, fn in (((3, 4), "normal"), ((3,), "uniform")):
        got = torch.cat([getattr(d, fn)(shape) for d in ranks])
        assert torch.equal(got, getattr(whole, fn)((6, *shape[1:])))
    got = torch.cat([d.randint(1000, (3,)) for d in ranks])
    assert torch.equal(got, whole.randint(1000, (6,)))


def test_init_distributed_refuses_a_mesh_larger_than_the_world(tmp_path):
    with pytest.raises(ValueError, match=r"2-device mesh but the world has 1 process"):
        init_distributed("cpu", 2, rank=0, world_size=1,
                         init_method="file://" + str(tmp_path / "store"))
    assert not torch.distributed.is_initialized()


# ---------------- 2-rank steps and windows (spawn 1) ----------------

B, TT, HH, WW = WORLD, 2, 8, 8
T_WIN, H_WIN, W_WIN = 4, 32, 32


def _train_inputs():
    jm = JaxUNet3D(**{k: v for k, v in worker.TRAIN_UNET.items() if k != "dtype"},
                   dropout=0.0, dtype=jnp.float32)
    params = randomize(jax.jit(lambda k: jm.init(
        k, jnp.zeros((B, TT, HH, WW, 20)), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B, 77 + TT * 16, 16)), jnp.zeros((B,), jnp.int32)))(jax.random.PRNGKey(0)),
        seed=0)
    rng = np.random.default_rng(3)
    batch = {"z0": rng.normal(size=(B, TT, HH, WW, 16)).astype(np.float32),
             "c_concat": rng.normal(size=(B, TT, HH, WW, 4)).astype(np.float32),
             "context": rng.normal(size=(B, 77 + TT * 16, 16)).astype(np.float32),
             "fs": np.full((B,), 24, np.int32)}
    return jm, params, batch


def _jax_mesh_step(jm, params, batch, key):
    """The JAX step with the batch sharded over a 2-device CPU mesh."""
    cfg = jax_step.TrainConfig(temporal_length=TT)
    step = jax_step.make_train_step(lambda p, *a: jm.apply(p, *a), JaxSchedule.create(), cfg)
    mesh = make_mesh(WORLD, platform="cpu")
    state = jax.device_put(jax_step.create_train_state(params, cfg), replicated(mesh))
    batch = {k: jax.device_put(jnp.asarray(v), shard_batch(mesh)) for k, v in batch.items()}
    with mesh:
        new, metrics = jax.jit(step)(state, batch, key)
    return new, float(metrics["loss_simple"])


def _jax_draws(key):
    key_t, key_n, _, _ = jax.random.split(key, 4)
    return [np.asarray(jax.random.randint(key_t, (B,), 0, 1000)),
            np.asarray(jax.random.normal(key_n, (B, TT, HH, WW, 16), jnp.float32))]


def _window_inputs():
    rng = np.random.default_rng(5)
    return {"window": T_WIN,
            "windows": rng.uniform(-1, 1, (2, T_WIN, H_WIN, W_WIN, 3)).astype(np.float32),
            "x_T": rng.standard_normal((2, T_WIN, H_WIN // 8, W_WIN // 8, 16)).astype(np.float32),
            "text": rng.normal(size=(1, 77, 64)).astype(np.float32),
            "video": rng.integers(0, 256, (6, H_WIN, W_WIN, 3), dtype=np.uint8),
            "groups": np.array([[0, 1, 2, 3], [2, 3, 4, 5]])}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Runs the ranks once; returns (the ranks' outputs, the JAX step, the
    inputs)."""
    tmp = tmp_path_factory.mktemp("ranks")
    jm, params, batch = _train_inputs()
    key = jax.random.PRNGKey(11)
    inp = {"train": {"weights": state_dict_from_jax(params, "unet"), "batch": batch,
                     "draws": _jax_draws(key)},
           "windows": _window_inputs()}
    torch.save(inp, str(tmp / "inputs.pt"))
    worker.spawn("steps_and_windows", WORLD, tmp, str(tmp / "inputs.pt"), str(tmp))
    ranks = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return ranks, _jax_mesh_step(jm, params, batch, key), inp


def _tree(jax_tree):
    return {n: t.numpy() for n, t in state_dict_from_jax(jax_tree, "unet").items()}


def test_dp_step_matches_the_jax_mesh_step(spawned):
    ranks, (new, want_loss), _ = spawned
    got = ranks[0]["train"]["dp"]
    assert abs(got["loss"] / want_loss - 1) <= LOSS_REL
    assert got["step"] == 1
    # AdamW's first moment after one step is (1 - b1) g: the averaged gradient
    mu = _tree(new.opt_state[0].mu)
    assert got["exp_avg"].keys() == mu.keys()
    got_all = np.concatenate([got["exp_avg"][n].numpy().ravel() for n in mu])
    want_all = np.concatenate([mu[n].ravel() for n in mu])
    assert rel_err(got_all, want_all) <= TREE_REL
    # 16 channels in 32-group norms make every group one channel, so what
    # adds a per-channel constant before a norm (biases, the timestep and fps
    # embeddings) has an exact zero gradient: rounding noise on both sides,
    # held in absolute terms
    tree = float(np.linalg.norm(want_all))
    zero = {n for n in mu if float(np.linalg.norm(mu[n])) <= ZERO_SHARE * tree}
    assert len(zero) < len(mu) // 5
    for n in zero:
        assert float(np.linalg.norm(got["exp_avg"][n])) <= ZERO_SHARE * tree, n
    worst = max((rel_err(got["exp_avg"][n], mu[n]), n) for n in mu if n not in zero)
    assert worst[0] <= GRAD_REL, worst
    for part, want in (("params", _tree(new.params)), ("ema", _tree(new.ema_params))):
        g = np.concatenate([got[part][n].numpy().ravel() for n in want])
        w = np.concatenate([want[n].ravel() for n in want])
        assert rel_err(g, w) <= UPDATE_REL, part


def test_fsdp_step_equals_dp_step_bit_for_bit(spawned):
    ranks = spawned[0]
    for out in ranks:
        dp, fsdp = out["train"]["dp"], out["train"]["fsdp"]
        assert fsdp["loss"] == dp["loss"]
        for part in ("params", "exp_avg", "exp_avg_sq", "ema"):
            for n, t in dp[part].items():
                assert torch.equal(fsdp[part][n], t), (part, n)


def test_fsdp_layout_shards_dim_0_and_other_dims(spawned):
    dims = spawned[0][0]["train"]["fsdp_dims"]
    used = {d for d in dims.values() if d is not None}
    assert 0 in used and used - {0}
    assert dims == spawned[0][1]["train"]["fsdp_dims"]


@pytest.fixture(scope="module")
def one_process_windows(spawned):
    inp = spawned[2]["windows"]
    model = init_random_(tiny(temporal_length=T_WIN, device="meta"), "cpu", seed=0).eval()
    cfg = InferenceConfig(window=T_WIN, stride=2, ddim_steps=2, ddim_eta=0.5, window_batch=2)
    pred = WindowPredictor(model, cfg)
    return {"x_T": pred.predict_windows(inp["windows"], inp["text"], 24, seed=7, x_T=inp["x_T"]),
            "drawn": pred.predict_windows(inp["windows"], inp["text"], 24, seed=7),
            "video": pred.predict_video(inp["video"], inp["groups"], inp["text"], 24, seed=3)}


@pytest.mark.parametrize("run", ["x_T", "drawn", "video"])
def test_window_parallel_equals_one_process(spawned, one_process_windows, run):
    want = one_process_windows[run]
    assert np.std(want["pts3d"]) > 1e-4
    for out in spawned[0]:
        got = out["windows"][run]
        for k in ("pts3d", "conf", "inv_depth", "traj"):
            assert got[k].shape == want[k].shape
            d = float(np.max(np.abs(got[k] - want[k])))
            assert d < WINDOW_ATOL, f"{run} {k}: {d}"
        np.testing.assert_array_equal(got["valid"], want["valid"])


def test_reconstruct_aligns_on_rank_0_only(spawned):
    r0, r1 = (out["windows"] for out in spawned[0])
    assert r0["scene"].shape == (6, H_WIN, W_WIN) and np.isfinite(r0["scene"]).all()
    assert r1["scene"] is None
    np.testing.assert_array_equal(r0["reconstruct_pts3d"], r1["reconstruct_pts3d"])


# ---------------- the 2-rank --fsdp CLI, resumed in one process (spawn 2) ----------------

CLI_T, CLI_HW = 4, 32
# the 2-rank steps split each batch's convolutions and sum the gradient in
# another order than one process at batch 2 does: float32 rounding, carried
# through three AdamW steps of lr 1e-5 into the third loss
CLI_LOSS_REL = 1e-5


def test_fsdp_cli_resumes_in_one_process_and_infer_cli_on_ranks(tmp_path):
    from geo4d_tpu_torch.cli import train

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(9)
    for i in range(2):   # one global batch of 2 an epoch: both runs see the same clips
        np.savez(str(data / f"clip{i}.npz"), fps=24, **{
            k: rng.uniform(-1, 1, (CLI_T, CLI_HW, CLI_HW, c)).astype(np.float32)
            for k, c in (("video", 3), ("normed_allpts", 3), ("plucker_raymap", 3),
                         ("plucker_cross", 3), ("inverse_depth", 1))})
    common = ["--data_dir", str(data), "--tiny", "--device", "cpu", "--height", str(CLI_HW),
              "--width", str(CLI_HW), "--video_length", str(CLI_T), "--ckpt_every", "2"]
    run = tmp_path / "two"
    frames = tmp_path / "clip"
    frames.mkdir()
    for i, f in enumerate(np.random.default_rng(4).integers(0, 256, (6, 32, 32, 3), np.uint8)):
        write_png(str(frames / f"{i:03d}.png"), f)
    infer_argv = ["--video_path", str(frames), "--savedir", str(tmp_path / "infer"), "--tiny",
                  "--device", "cpu", "--height", "32", "--width", "32", "--video_length", "4",
                  "--stride", "2", "--ddim_steps", "1", "--n_iter", "4"]
    worker.spawn("train_and_infer_cli", WORLD, tmp_path,
                 common + ["--out_dir", str(run), "--steps", "2", "--batch_size", "1",
                           "--fsdp", "--fsdp_min_size", "1"], infer_argv)
    ranks = [torch.load(str(run / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    full = {n: tuple(p.shape) for n, p in
            tiny(temporal_length=CLI_T, device="meta").unet.named_parameters()}
    assert any(ranks[0]["params_shapes"][n] != s for n, s in full.items())  # slices held
    with open(run / "metrics.jsonl") as f:
        assert sum('"loss_simple"' in line for line in f) == 2         # rank 0 alone writes
    assert sorted(p for p in os.listdir(run) if not p.startswith("rank")) == [
        "ckpt_00000002", "ckpt_final", "metrics.jsonl", "state_latest"]
    # the inference CLI under the same two ranks: rank 0 writes the results
    out = tmp_path / "infer" / "clip" / "clip"
    assert np.loadtxt(out / "pred_traj.txt").shape == (6, 8)
    assert np.isfinite(np.load(out / "frame_0005.npy")).all()

    resumed = train.main(common + ["--out_dir", str(run), "--steps", "3", "--batch_size", "2",
                                   "--resume"])
    straight = train.main(common + ["--out_dir", str(tmp_path / "one"), "--steps", "3",
                                    "--batch_size", "2"])
    assert resumed["state"].step == 3
    got = ranks[0]["losses"] + resumed["losses"]
    for g, w in zip(got, straight["losses"]):
        assert abs(g / w - 1) <= CLI_LOSS_REL, (got, straight["losses"])


# ---------------- the dry run (spawn 3) ----------------


def test_dryrun_multiprocess(capfd):
    from geo4d_tpu_torch.parallel.dryrun import dryrun_multiprocess

    dryrun_multiprocess(WORLD, "cpu")
    out = capfd.readouterr().out
    for line in ("dp train step(2): ok, loss=", "fsdp train step(2): ok, ",
                 "window-parallel inference(2 windows): ok", "dryrun_multiprocess(2): ok"):
        assert line in out, out
