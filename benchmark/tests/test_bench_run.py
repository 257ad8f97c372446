"""A whole run at the tiny preset's sizes on the CPU (the harness's look
for a chip skipped): the result line's schema, `correct` on sound runs and
false with the timed path broken underneath, and the command's refusal
without a CUDA device."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bench_paths  # noqa: F401
import bench_tiny
from bench_paths import ROOT
from harness import runner

SEED = 2**31 + 977


def run(cell, traced=False, seed=SEED):
    return runner.run(bench_tiny.cell(cell), seed, 0.2, traced, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", ["recon.sintel32", "train.b1"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(cell, traced):
    out = run(cell, traced)
    r = out["result"]
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[:5] == keys and list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = bench_tiny.cell(cell)
    wanted = {m["name"]: m["unit"] for m in c["per_layer" if traced else "end_to_end"]}
    assert set(r["metrics"]) <= set(wanted) and r["metrics"]
    for name, m in r["metrics"].items():
        assert m["unit"] == wanted[name] and np.isfinite(m["value"])
    if traced:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(r["check"]) == set(c["limits"])
    json.dumps(r)


def _shift_first_window(pred):
    """An answer altered where it is produced: window 0's points doubled."""
    orig = pred._postprocess

    def post(dec):
        out = orig(dec)
        out["pts3d"] = out["pts3d"].clone()
        out["pts3d"][0] *= 2.0
        return out
    return post


def test_recon_answer_altered_is_not_correct(monkeypatch):
    from geo4d_tpu_torch.pipeline import inference

    orig_init = inference.WindowPredictor.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        self._postprocess = _shift_first_window(self)
    monkeypatch.setattr(inference.WindowPredictor, "__init__", init)
    r = run("recon.sintel32")["result"]
    assert r["correct"] is False and r["failed"] == 1
    assert r["check"]["window_pts3d"]["value"] > r["check"]["window_pts3d"]["limit"]


def test_recon_sampler_state_unchanged_is_not_correct(monkeypatch):
    """A DDIM loop that returns its state unchanged: the initial noise."""
    from geo4d_tpu_torch.models import diffusion
    from geo4d_tpu_torch.sampling import ddim

    def unchanged(model_fn, shape, tables, *, device, generator=None, x_T=None, **kw):
        return ddim._normal(generator, shape, device) if x_T is None else x_T
    monkeypatch.setattr(diffusion, "ddim_sample", unchanged)
    r = run("recon.sintel32")["result"]
    assert r["correct"] is False


def test_recon_aligner_state_unchanged_is_not_correct(monkeypatch):
    """An aligner whose optimisation returns its state as it found it."""
    from geo4d_tpu_torch.alignment import optimizer

    monkeypatch.setattr(optimizer.GroupAligner, "run", lambda self, verbose=False, timer=None: 0.0)
    r = run("recon.sintel32")["result"]
    assert r["correct"] is False
    assert all(c["value"] <= c["limit"] for n, c in r["check"].items() if n.startswith("window"))


def test_recon_aligner_poses_altered_is_not_correct(monkeypatch):
    """An answer altered where it is produced: the aligner's cameras moved."""
    from geo4d_tpu_torch.alignment import optimizer

    orig = optimizer.GroupAligner.get_im_poses

    def moved(self):
        poses = orig(self)
        poses[:, :3, 3] += 0.05 * abs(poses[:, :3, 3]).max()
        return poses
    monkeypatch.setattr(optimizer.GroupAligner, "get_im_poses", moved)
    r = run("recon.sintel32")["result"]
    assert r["correct"] is False


def test_train_state_unchanged_is_not_correct(monkeypatch):
    from geo4d_tpu_torch.training import step

    monkeypatch.setattr(step, "adam_update_", lambda *a, **k: None)
    r = run("train.b1")["result"]
    assert r["correct"] is False
    assert r["check"]["change_norm_median"]["value"] == pytest.approx(1.0)


def test_train_ema_unchanged_is_not_correct(monkeypatch):
    from geo4d_tpu_torch.training import step

    monkeypatch.setattr(step, "ema_update_", lambda *a, **k: None)
    r = run("train.b1")["result"]
    assert r["correct"] is False
    assert r["check"]["ema_median_first_step"]["value"] == pytest.approx(1.0, abs=0.05)


def test_train_adam_count_off_by_one_is_not_correct(monkeypatch):
    """AdamW's bias corrections taken one step late."""
    from geo4d_tpu_torch.training import step

    orig = step.adam_update_

    def late(params, grads, exp_avg, exp_avg_sq, count, *a, **k):
        return orig(params, grads, exp_avg, exp_avg_sq, count + 1, *a, **k)
    monkeypatch.setattr(step, "adam_update_", late)
    r = run("train.b1")["result"]
    assert r["correct"] is False
    c = r["check"]["change_median_first_step"]
    assert c["value"] > c["limit"]


def test_train_half_the_frames_left_out_is_not_correct(monkeypatch):
    from geo4d_tpu_torch.training import step

    orig = step.diffusion_loss

    def half(unet, schedule, batch, draws, cfg):
        t = batch["z0"].shape[1] // 2

        def unet_half(x, ts, ctx, fs, task=None):
            out = unet(x, ts, ctx, fs, task=task)
            return torch.cat([out[:, :t], out[:, t:].detach()], dim=1)
        return orig(unet_half, schedule, batch, draws, cfg)
    monkeypatch.setattr(step, "diffusion_loss", half)
    r = run("train.b1")["result"]
    assert r["correct"] is False


def test_run_without_cuda_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "recon.sintel32",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
