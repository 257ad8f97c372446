"""The port's training (geo4d_tpu_torch/training/, cli/train.py,
models/checkpoint.py) against the JAX package's, on the CPU in float32 with
the tiny preset (T = 4, 32 x 64 frames).

Both sides get the same randomised weights (the weights bridge), the same
inputs, and the same random draws: the JAX functions draw from their keys,
the tests compute those draws with the same key splits and hand them to the
port through `GivenDraws`.

Tolerances (the issue of this slice asked for these):
  * diffusion loss: 1e-5 relative; its UNet gradient: 1e-4 relative L2 per
    tensor and 1e-5 over the whole tree (float32 sums in other orders
    through ~15 layers of backward);
  * AdamW + EMA on the same gradients: 1e-6 relative L2 against optax;
  * the ten batch builders: 1e-4 (abs + rel) on every output;
  * the task-conditioned UNet: 1e-4, as the other towers.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geo4d_tpu.models.presets import init_params, tiny as jax_tiny
from geo4d_tpu.training import modalities as jax_modalities
from geo4d_tpu.training import step as jax_step
from geo4d_tpu_torch.core.draws import Draws, GivenDraws
from geo4d_tpu_torch.models.presets import tiny
from geo4d_tpu_torch.ops import graphs
from geo4d_tpu_torch.training import modalities, step
from test_torch_graphs import ReplayingGraph
from _torch_parity import (assert_close, load_from_jax, randomize, rel_err,
                           state_dict_from_jax, to_torch)

torch.set_num_threads(1)

T, H, W = 4, 32, 64
h, w = H // 8, W // 8
B = 2
LOSS_REL = 1e-5
GRAD_REL = 1e-4
TREE_REL = 1e-5
ZERO_SHARE = 1e-6
OPT_REL = 1e-6
BUILD_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jax_tiny(temporal_length=T)
    params = randomize(init_params(jm, jax.random.PRNGKey(0), (H, W), temporal_length=T,
                                   with_text=False), seed=0)
    pm = tiny(temporal_length=T)
    load_from_jax(pm, params)
    return jm, params, pm


def _latent_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"z0": rng.normal(size=(B, T, h, w, 16)).astype(np.float32),
            "c_concat": rng.normal(size=(B, T, h, w, 4)).astype(np.float32),
            "context": rng.normal(size=(B, 77 + T * 16, 64)).astype(np.float32),
            "fs": np.array([24, 12], np.int32)}


def _loss_draws(key, cfg, num_timesteps=1000, n_patterns=27):
    """The draws of JAX's diffusion_loss for `key`, in the port's order."""
    key_t, key_n, key_p, key_l = jax.random.split(key, 4)
    draws = [jax.random.randint(key_t, (B,), 0, num_timesteps),
             jax.random.normal(key_n, (B, T, h, w, 16), jnp.float32)]
    if cfg.geometry_condition:
        draws += [jax.random.randint(key_p, (B,), 0, n_patterns),
                  jax.random.randint(key_l, (B,), 0, max(cfg.low_timesteps, 1))]
    return [np.asarray(d) for d in draws]


def _port_loss_and_grads(pm, batch, draws, cfg):
    names = [n for n, _ in pm.unet.named_parameters()]
    weights = [p for _, p in pm.unet.named_parameters()]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = step.diffusion_loss(pm.unet, pm.schedule, tb, GivenDraws(draws), cfg)
    grads = torch.autograd.grad(loss, weights, allow_unused=True)
    return float(loss.detach()), metrics, {n: (torch.zeros_like(p) if g is None else g)
                                  for n, g, p in zip(names, grads, weights)}


@pytest.mark.parametrize("geometry_condition", [False, True])
def test_diffusion_loss_and_gradient_match_jax(models, geometry_condition):
    jm, params, pm = models
    cfg = jax_step.TrainConfig(geometry_condition=geometry_condition, low_timesteps=50,
                               temporal_length=T)
    batch = _latent_batch()
    key = jax.random.PRNGKey(3)

    def jax_loss(p):
        return jax_step.diffusion_loss(lambda q, *a, **k: jm.unet.apply(q, *a, **k), p,
                                       jm.schedule, {k: jnp.asarray(v) for k, v in batch.items()},
                                       key, cfg)

    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params["unet"])
    want_grads = state_dict_from_jax(want_grads, "unet")
    port_cfg = step.TrainConfig(geometry_condition=geometry_condition, low_timesteps=50,
                                temporal_length=T)
    loss, metrics, grads = _port_loss_and_grads(pm, batch, _loss_draws(key, cfg), port_cfg)

    assert abs(loss / float(want_loss) - 1) <= LOSS_REL
    assert float(metrics["t_mean"]) == float(want_metrics["t_mean"])
    assert grads.keys() == want_grads.keys()
    got_all = np.concatenate([g.numpy().ravel() for g in grads.values()])
    want_all = np.concatenate([want_grads[n].numpy().ravel() for n in grads])
    assert rel_err(got_all, want_all) <= TREE_REL
    # the tiny UNet's GroupNorms have one channel per group, so the biases
    # just before one have an exact zero gradient: both sides give rounding
    # noise there (~1e-9 of the tree's norm, against >= 2e-4 for the rest),
    # which is held in absolute terms
    tree = float(np.linalg.norm(want_all))
    zero = {n for n in grads if float(want_grads[n].norm()) <= ZERO_SHARE * tree}
    assert len(zero) < len(grads) // 10
    for n in zero:
        assert float(grads[n].norm()) <= ZERO_SHARE * tree, n
    worst = max((rel_err(grads[n], want_grads[n]), n) for n in grads if n not in zero)
    assert worst[0] <= GRAD_REL, worst


def test_remat_gives_the_same_loss_and_gradient(models):
    _, _, pm = models
    batch, cfg = _latent_batch(1), step.TrainConfig(temporal_length=T)
    draws = _loss_draws(jax.random.PRNGKey(4), cfg)
    off = _port_loss_and_grads(pm, batch, list(draws), cfg)
    pm.unet.remat = True
    try:
        on = _port_loss_and_grads(pm, batch, list(draws), cfg)
    finally:
        pm.unet.remat = False
    assert on[0] == off[0]
    for n in off[2]:
        torch.testing.assert_close(on[2][n], off[2][n], rtol=0, atol=0)


def test_adamw_and_ema_match_optax():
    """Three AdamW + EMA updates on shared gradients (the port's
    multi-tensor path) against optax.adamw and the JAX step's EMA."""
    import optax

    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg = step.TrainConfig(learning_rate=1e-3, weight_decay=1e-2)

    opt = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate, jema = opt.init(jp), dict(jp)
    for i, g in enumerate(grads, start=1):
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        decay = jnp.minimum(cfg.ema_decay, (1.0 + jnp.int32(i)) / (10.0 + jnp.int32(i)))
        jema = {k: jema[k] * decay + jp[k] * (1.0 - decay) for k in jp}

    names = list(shapes)
    p = [to_torch(params[k]).clone() for k in names]
    m, v = [torch.zeros_like(t) for t in p], [torch.zeros_like(t) for t in p]
    ema = [t.clone() for t in p]
    for i, g in enumerate(grads, start=1):
        step.adam_update_(p, [to_torch(g[k]) for k in names], m, v, i, cfg.learning_rate,
                          weight_decay=cfg.weight_decay)
        step.ema_update_(ema, p, i, cfg)
    for k, pt, et in zip(names, p, ema):
        assert rel_err(pt, np.asarray(jp[k])) <= OPT_REL, k
        assert rel_err(et, np.asarray(jema[k])) <= OPT_REL, k


def test_train_step_updates_state_in_place(models):
    """make_train_step: the state's master weights move, the EMA follows with
    the warm-up decay, the step counts, and the module holds the weights the
    step started from (a bf16 module would hold their rounding)."""
    _, _, pm = models
    cfg = step.TrainConfig(learning_rate=1e-3, temporal_length=T)
    state = step.create_train_state(pm.unet)
    before = {n: t.clone() for n, t in state.params.items()}
    fn = step.make_train_step(pm.unet, pm.schedule, cfg)
    tb = {k: torch.from_numpy(v) for k, v in _latent_batch(2).items()}
    state, metrics = fn(state, tb, Draws.seeded([0, 0], "cpu"))
    assert state.step == 1 and np.isfinite(float(metrics["loss_simple"]))
    moved = [n for n in before if not torch.equal(before[n], state.params[n])]
    assert len(moved) == len(before)                  # AdamW's decay moves every weight
    d = 2.0 / 11.0                                    # min(0.9999, (1 + 1) / (10 + 1))
    n0 = moved[0]
    torch.testing.assert_close(state.ema[n0], before[n0] * d + state.params[n0] * (1 - d))
    torch.testing.assert_close(dict(pm.unet.named_parameters())[n0].detach(), before[n0])


# ---------------- the ten modality builders ----------------

V = 2   # views of the multi-view builders


def _raw_batches(seed=6):
    rng = np.random.default_rng(seed)

    def frames(n=T, c=3):
        return rng.uniform(-1, 1, size=(B, n, H, W, c)).astype(np.float32)

    fps = np.array([24, 8], np.int32)
    base = {"normed_allpts": frames(), "plucker_raymap": frames(), "plucker_cross": frames(),
            "inverse_depth": frames(c=1), "video": frames(), "fps": fps}
    multi = {"normed_allpts": frames(V * T), "video": frames(V * T), "fps": fps}
    return {
        "pc_ray_cross_depth": base,
        "pc_ray": base,
        "pc": base,
        "pc_task": dict(base, task=np.array([0, 3], np.int32)),
        "rgb": base,
        "multipc": dict(base, normed_allpts_1=frames()),
        "img_vidpc": base,
        "multimodality": dict(base, normalmap=frames(), opticalflow=frames(),
                              objectcooridnate=frames()),
        "novelview": dict(multi, plucker_raymap_all=rng.normal(
            size=(B, V * T, h, w, 7)).astype(np.float32)),
        "multipc_dynamic": dict(multi, dynamic_mask=frames(V * T)),
    }


# per builder: (keys split, frames of each encode, key index of the dropout)
DRAW_PLAN = {
    "pc_ray_cross_depth": (6, [T] * 5, 5),
    "pc_ray": (4, [T] * 3, 3),
    "pc": (3, [T] * 2, 2),
    "pc_task": (3, [T] * 2, 2),
    "rgb": (2, [T], 1),
    "multipc": (5, [T] * 3, 3),
    "img_vidpc": (4, [T] * 2, 2),
    "multimodality": (6, [T] * 5, 5),
    "novelview": (3, [V * T] * 2, 2),
    "multipc_dynamic": (4, [V * T] * 3, 3),
}


def _builder_draws(modality, key):
    n_keys, encodes, cond = DRAW_PLAN[modality]
    keys = jax.random.split(key, n_keys)
    draws = [jax.random.normal(keys[i], (B * n, h, w, 4), jnp.float32)
             for i, n in enumerate(encodes)]
    draws.append(jax.random.uniform(keys[cond], (B,)))
    return [np.asarray(d) for d in draws]


@pytest.mark.parametrize("modality", sorted(DRAW_PLAN))
def test_builders_match_jax(models, modality):
    jm, params, pm = models
    raw = _raw_batches()[modality]
    rng = np.random.default_rng(7)
    prompt = rng.normal(size=(B, 77, 64)).astype(np.float32)
    null = rng.normal(size=(1, 77, 64)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    extra = {"temporal_length": T} if modality in ("novelview", "multipc_dynamic") else {}
    # p = 0.3: u < 0.6 drops the text, 0.3 <= u < 0.9 the image
    want = jax.jit(lambda p, b, k: jax_modalities.build_batch(
        modality, jm, p, b, k, jnp.asarray(prompt), jnp.asarray(null), 0.3, True, **extra))(
        params, {k: jnp.asarray(v) for k, v in raw.items()}, key)
    got = modalities.build_batch(modality, pm, {k: torch.from_numpy(v) for k, v in raw.items()},
                                 GivenDraws(_builder_draws(modality, key)), to_torch(prompt),
                                 to_torch(null), 0.3, True, **extra)
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], np.asarray(want[k]), BUILD_TOL, BUILD_TOL, f"{modality} {k}")


def test_task_condition_unet_matches_jax(models):
    from geo4d_tpu_torch.models.unet3d import UNet3D

    jax_models, params, _ = models
    jm = jax_models.unet.clone(task_condition=True)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, T, h, w, 20)).astype(np.float32)
    ctx = rng.normal(size=(B, 77 + T * 16, 64)).astype(np.float32)
    ts, fs, task = np.array([10, 900], np.int32), np.array([24, 8], np.int32), np.array([0, 3])
    # the fixture's weights plus a task embedding shaped as the fps one
    tree = dict(params["unet"]["params"])
    tree["task_embedding"] = randomize(tree["fps_embedding"], seed=1)
    p = {"params": tree}
    want = jax.jit(lambda q, *a: jm.apply(q, *a, task=jnp.asarray(task)))(p, x, ts, ctx, fs)
    pm = tiny(temporal_length=T, task_condition=True).unet
    assert isinstance(pm, UNet3D) and pm.task_condition
    pm.load_state_dict(state_dict_from_jax(p, "unet"), strict=True)
    with torch.no_grad():
        got = pm(to_torch(x), torch.from_numpy(ts), to_torch(ctx), torch.from_numpy(fs),
                 task=torch.from_numpy(task))
        without = pm(to_torch(x), torch.from_numpy(ts), to_torch(ctx), torch.from_numpy(fs),
                     task=torch.zeros(B, dtype=torch.long))
    assert_close(got, np.asarray(want), BUILD_TOL, BUILD_TOL, "task UNet")
    assert not torch.allclose(got, without)          # the task ids change the output
    with pytest.raises(ValueError, match="task ids"):
        pm(to_torch(x), torch.from_numpy(ts), to_torch(ctx), torch.from_numpy(fs))


# ---------------- checkpoints, data stream, CLI ----------------


def test_train_state_checkpoint_round_trip(models, tmp_path):
    from geo4d_tpu_torch.models.checkpoint import (load_unet_weights, restore_train_state,
                                                   save_checkpoint)

    _, _, pm = models
    cfg = step.TrainConfig(learning_rate=1e-3, temporal_length=T)
    state = step.create_train_state(pm.unet)
    fn = step.make_train_step(pm.unet, pm.schedule, cfg)
    tb = {k: torch.from_numpy(v) for k, v in _latent_batch(3).items()}
    state, _ = fn(state, tb, Draws.seeded([1], "cpu"))
    save_checkpoint(str(tmp_path / "state"), state.state_dict())
    save_checkpoint(str(tmp_path / "ema"), {"unet": state.ema})
    back = restore_train_state(str(tmp_path / "state"))
    assert back.step == state.step == 1
    for field in ("params", "exp_avg", "exp_avg_sq", "ema"):
        got, want = getattr(back, field), getattr(state, field)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[n], want[n]) for n in want)
    unet = tiny(temporal_length=T).unet
    load_unet_weights(unet, str(tmp_path / "ema"))
    assert all(torch.equal(p, state.ema[n]) for n, p in unet.named_parameters())


def _write_shards(root, n=7, t=2, hw=4):
    for i in range(n):
        np.savez(os.path.join(root, f"clip_{i}.npz"),
                 video=np.full((t, hw, hw, 3), i, np.float32),
                 normed_allpts=np.full((t, hw, hw, 3), -i, np.float32),
                 plucker_raymap=np.zeros((t, hw, hw, 3), np.float32),
                 plucker_cross=np.zeros((t, hw, hw, 3), np.float32),
                 inverse_depth=np.zeros((t, hw, hw, 1), np.float32), fps=24 - i)


def test_npz_stream_matches_jax_and_resumes(tmp_path):
    from geo4d_tpu.cli.train import npz_stream as jax_npz_stream
    from geo4d_tpu_torch.cli.train import npz_stream
    from geo4d_tpu_torch.data.sampler import round_by

    _write_shards(str(tmp_path))
    bs, t = 2, 2
    full, ref = npz_stream(str(tmp_path), bs, t), jax_npz_stream(str(tmp_path), bs, t)
    batches = [next(full) for _ in range(7)]
    for got in batches:
        want = next(ref)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    bpe = round_by(7, bs) // bs
    step0 = 4
    resumed = npz_stream(str(tmp_path), bs, t, start_epoch=step0 // bpe,
                         skip_batches=step0 % bpe)
    for want in batches[step0:]:
        np.testing.assert_array_equal(next(resumed)["video"], want["video"])


def _write_clips(root, n=2):
    rng = np.random.default_rng(9)
    for i in range(n):
        np.savez(os.path.join(root, f"clip{i}.npz"),
                 video=rng.uniform(-1, 1, (T, H, W, 3)).astype(np.float32),
                 normed_allpts=rng.normal(size=(T, H, W, 3)).astype(np.float32),
                 plucker_raymap=rng.normal(size=(T, H, W, 3)).astype(np.float32),
                 plucker_cross=rng.normal(size=(T, H, W, 3)).astype(np.float32),
                 inverse_depth=rng.uniform(0, 1, (T, H, W, 1)).astype(np.float32), fps=24)


def test_train_cli_runs_and_resumes(tmp_path):
    """cli/train.main --tiny --device cpu: 3 steps with a checkpoint at step
    2; a run stopped at 2 and resumed gives the same step-3 loss and final
    EMA as the uninterrupted run."""
    from geo4d_tpu_torch.cli import train
    from geo4d_tpu_torch.models.checkpoint import load_unet_weights

    data = tmp_path / "data"
    data.mkdir()
    _write_clips(str(data))
    common = ["--data_dir", str(data), "--tiny", "--device", "cpu", "--height", str(H),
              "--width", str(W), "--video_length", str(T), "--ckpt_every", "2"]
    full = train.main(common + ["--out_dir", str(tmp_path / "a"), "--steps", "3"])
    assert len(full["losses"]) == 3 and np.isfinite(full["losses"]).all()
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        rows = [line for line in f if '"loss_simple"' in line]
    assert len(rows) == 3
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt_00000002", "ckpt_final", "metrics.jsonl",
                                                  "state_latest"]
    train.main(common + ["--out_dir", str(tmp_path / "b"), "--steps", "2"])
    resumed = train.main(common + ["--out_dir", str(tmp_path / "b"), "--steps", "3",
                                   "--resume"])
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["state"].step == 3
    for n, e in full["state"].ema.items():
        assert torch.equal(resumed["state"].ema[n], e)
    unet = tiny(temporal_length=T).unet
    load_unet_weights(unet, str(tmp_path / "b" / "ckpt_final"))


def test_train_cli_needs_cuda_unless_asked_for_cpu(tmp_path):
    from geo4d_tpu_torch.cli import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "o"), "--tiny"])


# ---------------- the step's CUDA graph: eager rule ----------------


def _step_before_graphs(pm, state, batch, draws, cfg):
    """The training step as it ran before the graph path: the draws and the
    schedule's host copies inside the loss, in that order, then autograd,
    AdamW and the EMA."""
    unet, schedule = pm.unet, pm.schedule
    names = [n for n, _ in unet.named_parameters()]
    weights = [p for _, p in unet.named_parameters()]
    step.load_params_(unet, state.params)
    z0 = batch["z0"]
    b, dev = z0.shape[0], z0.device
    ts = draws.randint(schedule.num_timesteps, (b,))
    noise = draws.normal(z0.shape)
    sa = torch.as_tensor(np.asarray(schedule.sqrt_alphas_cumprod), device=dev)
    sb = torch.as_tensor(np.asarray(schedule.sqrt_one_minus_alphas_cumprod), device=dev)
    scale_arr = (None if schedule.scale_arr is None
                 else torch.as_tensor(np.asarray(schedule.scale_arr), device=dev))
    if cfg.geometry_condition:
        pats = torch.as_tensor(step.geometry_condition_patterns(cfg.temporal_length),
                               device=dev).long()
        frame_on = pats[draws.randint(pats.shape[0], (b,))]
        t_low = draws.randint(max(cfg.low_timesteps, 1), (b,))
        timesteps = ts[:, None] * frame_on + t_low[:, None] * (1 - frame_on)
        sa_t, sb_t = sa[timesteps][..., None, None, None], sb[timesteps][..., None, None, None]
        if scale_arr is not None:
            z0 = z0 * scale_arr[timesteps][..., None, None, None]
    else:
        timesteps = ts
        sa_t, sb_t = sa[ts][:, None, None, None, None], sb[ts][:, None, None, None, None]
        if scale_arr is not None:
            z0 = z0 * scale_arr[ts][:, None, None, None, None]
    x_noisy = sa_t * z0 + sb_t * noise
    v_target = sa_t * noise - sb_t * z0
    x_in = torch.cat([x_noisy, batch["c_concat"]], dim=-1)
    pred = unet(x_in, timesteps, batch["context"], batch["fs"], task=batch.get("task"))
    loss = torch.mean((pred - v_target) ** 2)
    grads = torch.autograd.grad(loss, weights, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g for g, w in zip(grads, weights)]
    p = [state.params[n] for n in names]
    step.adam_update_(p, grads, [state.exp_avg[n] for n in names],
                      [state.exp_avg_sq[n] for n in names], state.step + 1, cfg.learning_rate,
                      weight_decay=cfg.weight_decay)
    state.step += 1
    step.ema_update_([state.ema[n] for n in names], p, state.step, cfg)
    return float(loss.detach()), float(ts.float().mean())


@pytest.mark.parametrize("geometry_condition", [False, True])
def test_cpu_steps_are_eager_and_match_the_step_before_graphs(models, geometry_condition,
                                                             monkeypatch):
    """On the CPU every step is eager (counter "train_eager_steps", no
    capture, no graph), and three steps draw in the order the step drew
    before the graph path: the same losses and states, bit for bit."""
    from geo4d_tpu_torch.core.timing import SpanRecorder, recording

    _, _, pm = models
    cfg = step.TrainConfig(learning_rate=1e-3, geometry_condition=geometry_condition,
                           low_timesteps=50, temporal_length=T)
    batches = [{k: torch.from_numpy(v) for k, v in _latent_batch(10 + i).items()}
               for i in range(3)]
    module_weights = {n: p.detach().clone() for n, p in pm.unet.named_parameters()}
    want, got = step.create_train_state(pm.unet), step.create_train_state(pm.unet)

    def no_graph(*a, **k):
        raise AssertionError("a CUDA graph was built on the CPU")

    rec = SpanRecorder()
    fn = step.make_train_step(pm.unet, pm.schedule, cfg)
    monkeypatch.setattr(graphs, "_CudaGraph", no_graph)
    try:
        want_metrics = [_step_before_graphs(pm, want, b, Draws.seeded([7, i], "cpu"), cfg)
                        for i, b in enumerate(batches)]
        with recording(rec):
            got_metrics = []
            for i, b in enumerate(batches):
                got, m = fn(got, b, Draws.seeded([7, i], "cpu"))
                got_metrics.append((float(m["loss_simple"]), float(m["t_mean"])))
    finally:
        step.load_params_(pm.unet, module_weights)
    assert got_metrics == want_metrics
    assert got.step == want.step == 3
    for field in ("params", "exp_avg", "exp_avg_sq", "ema"):
        g, w = getattr(got, field), getattr(want, field)
        assert all(torch.equal(g[n], w[n]) for n in w), field
    assert rec.totals() == {"train_eager_steps": 3}
    assert not any(s.name == "train_capture" for s in rec.spans)
    parents = {s.id: s.name for s in rec.spans}
    assert {parents[sid] for sid, _, name, _ in rec.counts} == {"forward_backward"}


def test_graph_path_replays_the_eager_step(models, monkeypatch):
    """make_train_step's graph path (forced on the CPU, a stand-in graph
    that re-runs the capture on its static inputs): a shape's first step is
    eager, the second captures, every later one replays; the inputs reach
    the graph through its static buffers, so the losses and states equal
    eager steps bit for bit. A new state or batch shape frees the graph; a
    shape seen before captures at once, a new one runs eagerly first."""
    from geo4d_tpu_torch.core.timing import SpanRecorder, recording

    _, _, pm = models
    cfg = step.TrainConfig(learning_rate=1e-3, geometry_condition=True, low_timesteps=50,
                           temporal_length=T)
    module_weights = {n: p.detach().clone() for n, p in pm.unet.named_parameters()}
    monkeypatch.setattr(graphs, "_graph", lambda device: ReplayingGraph)
    ReplayingGraph.built = []
    small = {k: v[:1] for k, v in _latent_batch(20).items()}
    batches = [_latent_batch(20 + i) for i in range(3)] + [small, _latent_batch(24)]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    states = {}
    try:
        for capture in (False, True):
            step.load_params_(pm.unet, module_weights)
            state = step.create_train_state(pm.unet)
            fn = step.make_train_step(pm.unet, pm.schedule, cfg)
            rec, losses = SpanRecorder(), []
            with recording(rec), contextlib.nullcontext() if capture else graphs.eager():
                for i, b in enumerate(batches):
                    state, m = fn(state, b, Draws.seeded([9, i], "cpu"))
                    losses.append(float(m["loss_simple"]))
                # a new state of a warm shape captures at once
                fresh = step.create_train_state(pm.unet)
                fresh, m = fn(fresh, batches[0], Draws.seeded([9, 0], "cpu"))
                losses.append(float(m["loss_simple"]))
            states[capture] = (losses, state, rec)
    finally:
        step.load_params_(pm.unet, module_weights)
    (want, eager_state, eager_rec), (got, graph_state, graph_rec) = states[False], states[True]
    assert got == want
    for field in ("params", "exp_avg", "exp_avg_sq", "ema"):
        got_t, want_t = getattr(graph_state, field), getattr(eager_state, field)
        assert all(torch.equal(got_t[n], want_t[n]) for n in want_t), field
    assert eager_rec.totals() == {"train_eager_steps": 6}
    # steps: eager; capture + replay; replay; the small shape frees the graph
    # and runs eagerly; the first shape again: capture + replay; the fresh
    # state frees that graph: capture + replay
    assert graph_rec.totals() == {"train_eager_steps": 2, "train_graph_replays": 4}
    assert sum(s.name == "train_capture" for s in graph_rec.spans) == 3
    assert [name for _, _, name, _ in graph_rec.counts] == [
        "train_eager_steps", "train_graph_replays", "train_graph_replays", "train_eager_steps",
        "train_graph_replays", "train_graph_replays"]
    assert len(ReplayingGraph.built) == 3
