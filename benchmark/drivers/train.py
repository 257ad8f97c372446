"""Closed loop of fine-tuning steps, as `cli/train.py` drives them: per step
a fresh seeded clip of every modality's maps (made on the device),
`build_batch` (VAE encodes and CLIP under no_grad, stage "build"), then the
step from `make_train_step` (UNet forward and backward, AdamW, EMA).

Set-up builds the one train state the window uses and drives it through
the first `check_steps` steps with the window's own call and feed; those
steps are what the reference follows.

Traffic keys: batch, frames, height, width, fps, fields (map name ->
channels), cells (the maps' smoothness), check_steps, trace_units.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import compare, models, scene

ADAM_B1 = 0.9          # the port's and the reference's AdamW first-moment decay
STEP_KEYS = ("learning_rate", "weight_decay", "ema_decay", "ema_warmup", "geometry_condition",
             "low_timesteps", "temporal_length", "remat")


def weight_seed(seed: int) -> int:
    return scene.torch_seed(seed, 0, 13)


def _leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    return {n: float(t.double().norm()) * scale for n, t in tensors.items()}


def _state_norms(params: dict, ema: dict, p0: dict) -> dict:
    """Each leaf's norm of its change from p0, and of its EMA's."""
    return {"change": {n: float((params[n].detach() - p0[n]).double().norm()) for n in p0},
            "ema": {n: float((ema[n] - p0[n]).double().norm()) for n in p0}}


class Driver:
    unit = "steps"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.dtype = models.dtype_of(config["dtype"])
        self.hw = (traffic["height"], traffic["width"])
        self.tcfg = config["training"]
        self.losses = []

    def _raw(self, index: int) -> dict:
        t = self.traffic
        return scene.clip(self.seed, index, t["batch"], t["frames"], self.hw, t["fields"],
                          t["cells"], t["fps"], self.device)

    def _draw_words(self, index: int, stream: int) -> list:
        return scene.words(self.seed, index, stream)

    def _context(self, model):
        with torch.no_grad():
            emb = model.embed_text(models.empty_prompt_ids(self.device))
        model.text_encoder = None
        return emb.expand(self.traffic["batch"], *emb.shape[1:]), emb

    # ------------------------------------------------------------ program
    def setup(self):
        from geo4d_tpu_torch.core.draws import Draws
        from geo4d_tpu_torch.training.modalities import build_batch
        from geo4d_tpu_torch.training.step import (TrainConfig, create_train_state,
                                                   make_train_step)

        t0 = time.perf_counter()
        self._draws, self._build = Draws, build_batch
        m = models.build("geo4d_tpu_torch", self.cfg["model"], self.dtype)
        models.fill_weights_(m, weight_seed(self.seed), self.cfg["init"], m, self.device)
        self.model = m.eval()
        self.prompt, self.null = self._context(m)
        m.requires_grad_(False)
        m.unet.requires_grad_(True)
        step_cfg = TrainConfig(**{k: self.tcfg[k] for k in STEP_KEYS})
        self.state = create_train_state(m.unet)
        self.step_fn = make_train_step(m.unet, m.schedule, step_cfg)
        t1 = time.perf_counter()
        # the first steps, through the window's own call; the reference
        # follows them. After step 1 (both sides on the same weights): the
        # first gradient as AdamW holds it (m = (1 - b1) g), the second
        # moment, each leaf's change and its EMA's; after the last, each
        # leaf's change and its EMA's.
        p0 = {n: p.clone() for n, p in self.state.params.items()}
        for i in range(self.traffic["check_steps"]):
            self.run_unit(None)
            if i == 0:
                self.first = _state_norms(self.state.params, self.state.ema, p0)
                self.first["grad"] = _leaf_norms(self.state.exp_avg, 1.0 / (1.0 - ADAM_B1))
                self.first["second_moment"] = _leaf_norms(self.state.exp_avg_sq)
        self.last = _state_norms(self.state.params, self.state.ema, p0)
        del p0
        self.setup_losses = list(self.losses)
        self.setup_split = {"build_s": t1 - t0, "warm_s": time.perf_counter() - t1}

    def run_unit(self, timer) -> dict:
        """The next step; returns the work it did."""
        from geo4d_tpu_torch.core.timing import stage

        index = len(self.losses)
        raw = self._raw(index)
        with stage(timer, "build"):
            draws = self._draws.seeded(self._draw_words(index, 0), self.device)
            batch = self._build(self.tcfg["modality"], self.model, raw, draws, self.prompt,
                                self.null, self.tcfg["uncond_prob"], self.tcfg["random_uncond"])
        self.state, metrics = self.step_fn(
            self.state, batch, self._draws.seeded(self._draw_words(index, 1), self.device), timer)
        self.losses.append(float(metrics["loss_simple"]))
        return {"steps": 1, "clips": self.traffic["batch"]}

    def release(self):
        self.model = self.state = self.step_fn = None
        models.free(self.device)

    def flops_per_work(self) -> dict:
        from harness import flops

        t = self.traffic
        per = flops.train_step_flops(self.cfg["model"], t["batch"], t["frames"], self.hw,
                                     len(t["fields"]))
        return {"steps": per["build"] + per["fwd_bwd"]}

    # ---------------------------------------------------------- reference
    def reference(self, control: bool = False, loss_fn=None, adam_count=0, ema=True) -> dict:
        """The reference's readings of the first steps (as the program's in
        set-up): float32, TF32 off, the UNet recomputing each block in the
        backward so that it fits (the same arithmetic). `control` makes it
        compute in fp8. Planted faults: `loss_fn` stands in for the loss,
        `adam_count` is added to AdamW's step count, and without `ema` the
        EMA is left unchanged."""
        m = models.build("geo4d_ref", self.cfg["model"], torch.float32)
        served = models.build("geo4d_ref", self.cfg["model"], self.dtype)
        models.fill_weights_(m, weight_seed(self.seed), self.cfg["init"], served, self.device)
        m.eval()
        with compare.fp8() if control else contextlib.nullcontext():
            return self._reference(m, loss_fn, adam_count, ema)

    def _reference(self, m, loss_fn, adam_count, ema) -> dict:
        from geo4d_ref.core.draws import Draws
        from geo4d_ref.training import modalities, step

        prompt, null = self._context(m)
        m.requires_grad_(False)
        m.unet.requires_grad_(True)
        m.unet.remat = True
        cfg = step.TrainConfig(**{k: self.tcfg[k] for k in STEP_KEYS})
        names = [n for n, _ in m.unet.named_parameters()]
        params = [p for _, p in m.unet.named_parameters()]
        p0 = {n: p.detach().clone() for n, p in zip(names, params)}
        averages = [p.detach().clone() for p in params]
        exp_avg = [torch.zeros_like(p) for p in params]
        exp_avg_sq = [torch.zeros_like(p) for p in params]
        loss_fn = loss_fn or step.diffusion_loss
        losses, first = [], None
        for i in range(self.traffic["check_steps"]):
            raw = self._raw(i)
            batch = modalities.build_batch(
                self.tcfg["modality"], m, raw, Draws.seeded(self._draw_words(i, 0), self.device),
                prompt, null, self.tcfg["uncond_prob"], self.tcfg["random_uncond"])
            loss, _ = loss_fn(m.unet, m.schedule, batch,
                              Draws.seeded(self._draw_words(i, 1), self.device), cfg)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            with torch.no_grad():
                step.adam_update_(params, grads, exp_avg, exp_avg_sq, i + 1 + adam_count,
                                  cfg.learning_rate, weight_decay=cfg.weight_decay)
                if ema:
                    step.ema_update_(averages, params, i + 1, cfg)
            if i == 0:
                first = _state_norms(dict(zip(names, params)), dict(zip(names, averages)), p0)
                first["grad"] = {n: float(g.double().norm()) for n, g in zip(names, grads)}
                first["second_moment"] = _leaf_norms(dict(zip(names, exp_avg_sq)))
            losses.append(float(loss.detach()))
            del grads, batch, loss
        last = _state_norms(dict(zip(names, params)), dict(zip(names, averages)), p0)
        return {"losses": losses, "first": first, "last": last}

    @staticmethod
    def numbers(got: dict, ref: dict) -> dict:
        """After step 1, where both sides ran the same weights: the loss gap;
        the worst leaf's gap of the gradient's norm (as AdamW's first moment
        holds it) and of the second moment's; the median leaf's gap of the
        change's norm and of the EMA's change. After the last step: the
        median leaf's gap of the change's norm and of the EMA's change.
        The worst leaf's change is not compared: in leaves whose gradient
        elements lie near AdamW's eps (1e-8) the update is not sign-like and
        its size follows the gradient's rounding. Later steps' losses are
        not compared: the program's forward reads its master weights rounded
        to bf16, whose rounding (about 1e-4 of a weight of 0.03) is larger
        than an AdamW step (1e-5), so from step 2 the two sides run
        different weights (see PERF.md). A leaf whose reference gradient is
        under a thousandth of the median leaf's moves under AdamW by
        rounding alone and is left out of the changes."""
        g = ref["first"]["grad"]
        median = float(np.median(list(g.values())))
        moved = [n for n, v in g.items() if v >= 1e-3 * median]

        def worst(when, what, names):
            return max(compare.leaf_norm_gaps(got[when][what], ref[when][what], names))

        def middle(when, what):
            return float(np.median(compare.leaf_norm_gaps(got[when][what], ref[when][what],
                                                          moved)))

        return {"loss_first_step": abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
                "first_grad_norm": worst("first", "grad", list(g)),
                "second_moment_first_step": worst("first", "second_moment", list(g)),
                "change_median_first_step": middle("first", "change"),
                "ema_median_first_step": middle("first", "ema"),
                "change_norm_median": middle("last", "change"),
                "ema_change_median": middle("last", "ema")}

    def program_readings(self) -> dict:
        return {"losses": self.setup_losses, "first": self.first, "last": self.last}

    def check(self) -> tuple:
        """(numbers, answers compared): the set-up's steps against the
        reference's."""
        with compare.tf32(False):
            ref = self.reference()
        return self.numbers(self.program_readings(), ref), self.traffic["check_steps"]
