"""Closed loop of `reconstruct` calls with one client: each call gets a fresh
seeded video (made before the window) and the next starts when the last
one's results are on the host, as a user fetching them would have them.

Traffic keys: frames, height, width, fps, window_batch, videos (made before
the window), warm_iters (aligner iterations of the set-up's warm-up call),
pan_px, zoom, octaves (the scene), trace_units (calls the profiler covers).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from harness import compare, models, scene

OUTPUT_KEYS = ("pts3d", "conf", "inv_depth", "traj")
# the aligner's parameters besides its answers (depth maps, poses, focal),
# which the reference's objective reads at the program's result
ALIGN_PARAMS = ("pw_poses", "traj_align", "s_depth", "t_depth")
# the states the reference records, with whether the objective there has its
# phase-2 terms; and the short run's length and phase switch: both phases,
# the calibration and, on CUDA, each structure's eager iteration, capture and
# replays
STATES = (("init", False), ("calibrated", True), ("end", True))
SHORT_RUN = {"n_iter": 20, "depth_traj_start_iter": 10}


WARM_INDEX = 1 << 30   # the set-up call's video and draws, apart from the window's


def call_seed(seed: int, index: int) -> int:
    """The diffusion seed of the index-th call (`reconstruct` takes 31 bits)."""
    return scene.torch_seed(seed, index, 7, bits=31)


def weight_seed(seed: int) -> int:
    return scene.torch_seed(seed, 0, 11)


def scene_of(aligner) -> dict:
    """An aligner's results on the host: per-frame depth, camera-to-world
    poses and focal, and its other parameters."""
    return {"depth": aligner.get_depthmaps(), "poses": aligner.get_im_poses(),
            "focals": aligner.get_focals(),
            "align": {k: aligner.params[k].detach().cpu().numpy() for k in ALIGN_PARAMS}}


class Driver:
    unit = "frames"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.dtype = models.dtype_of(config["dtype"])
        self.hw = (traffic["height"], traffic["width"])
        self.outputs = []

    # ------------------------------------------------------------ program
    def _configs(self, package: str, n_iter=None):
        from importlib import import_module

        inf = import_module(f"{package}.pipeline.inference")
        opt = import_module(f"{package}.alignment.optimizer")
        icfg = inf.InferenceConfig(**self.cfg["inference"],
                                   window_batch=self.traffic["window_batch"])
        acfg = opt.AlignerConfig(**self.cfg["aligner"])
        if n_iter is not None:
            acfg = dataclasses.replace(acfg, n_iter=n_iter)
        return inf, icfg, acfg

    def _video(self, index: int) -> np.ndarray:
        t = self.traffic
        return scene.video(self.seed, index, t["frames"], self.hw, t["pan_px"], t["zoom"],
                           t["octaves"])

    def setup(self):
        t0 = time.perf_counter()
        self.build()
        t1 = time.perf_counter()
        # the cell's own shapes: one call with a short aligner run that
        # passes through both phases and the calibration
        _, icfg, acfg = self._configs("geo4d_tpu_torch", self.traffic["warm_iters"])
        self._reconstruct(self.model, self._video(WARM_INDEX), self.text_ctx,
                          self.traffic["fps"], icfg, acfg, seed=call_seed(self.seed, WARM_INDEX))
        self.setup_split = {"build_s": t1 - t0, "warm_s": time.perf_counter() - t1}

    @torch.no_grad()
    def build(self):
        """The program's model with the seed's weights, the text context and
        the window's videos."""
        from geo4d_tpu_torch.pipeline.inference import reconstruct

        self._reconstruct = reconstruct
        m = models.build("geo4d_tpu_torch", self.cfg["model"], self.dtype)
        models.fill_weights_(m, weight_seed(self.seed), self.cfg["init"], m, self.device)
        self.model = m.eval()
        ids = models.empty_prompt_ids(self.device)
        self.text_ctx = self.model.embed_text(ids).cpu().numpy()
        self.model.text_encoder = None
        self.videos = [self._video(i) for i in range(self.traffic["videos"])]

    def run_unit(self, timer) -> dict:
        """The next call; returns the work it did."""
        index = len(self.outputs)
        _, icfg, acfg = self._configs("geo4d_tpu_torch")
        frames = self.videos[index % len(self.videos)]
        aligner, preds, _ = self._reconstruct(self.model, frames, self.text_ctx,
                                              self.traffic["fps"], icfg, acfg,
                                              seed=call_seed(self.seed, index), timer=timer)
        out = {k: preds[k].cpu().numpy() for k in OUTPUT_KEYS}
        out.update(scene_of(aligner))               # the scene's results on the host
        self.outputs.append(out)
        groups = preds["pts3d"].shape[0]
        return {"frames": frames.shape[0], "windows": groups, "reconstructs": 1,
                "ddim_steps": icfg.ddim_steps * groups, "align_iters": acfg.n_iter}

    def release(self):
        self.model = None
        models.free(self.device)

    def flops_per_work(self) -> dict:
        from harness import flops

        inf, icfg, _ = self._configs("geo4d_ref")
        t = self.traffic
        windows = len(inf.sliding_windows(t["frames"], icfg.window, icfg.stride))
        per = flops.reconstruct_flops(self.cfg["model"], t["frames"], self.hw, windows,
                                      icfg.window, icfg.ddim_steps)
        return {"reconstructs": per["towers"] + per["unet"] + per["decode"]}

    # ---------------------------------------------------------- reference
    def reference_model(self):
        m = models.build("geo4d_ref", self.cfg["model"], torch.float32)
        served = models.build("geo4d_ref", self.cfg["model"], self.dtype)
        models.fill_weights_(m, weight_seed(self.seed), self.cfg["init"], served, self.device)
        return m.eval()

    @torch.no_grad()
    def reference_windows(self, model, index: int, control: bool = False) -> dict:
        """The reference's window predictions for the index-th call (in fp8
        with `control`)."""
        with compare.fp8() if control else contextlib.nullcontext():
            return self._reference_windows(model, index)

    def _reference_windows(self, model, index: int) -> dict:
        inf, icfg, _ = self._configs("geo4d_ref")
        text = model.embed_text(models.empty_prompt_ids(self.device)).cpu().numpy()
        frames = self.videos[index % len(self.videos)]
        groups = inf.sliding_windows(frames.shape[0], icfg.window, icfg.stride)
        pred = inf.WindowPredictor(model, icfg, device=self.device).predict_video(
            frames, groups, text, self.traffic["fps"], call_seed(self.seed, index))
        return {k: pred[k] for k in OUTPUT_KEYS}

    def on_device(self, got: dict) -> dict:
        """A call's window predictions as device tensors."""
        return {k: torch.as_tensor(got[k], device=self.device) for k in OUTPUT_KEYS}

    def side(self, package: str, preds: dict, config=None, **kw) -> "Side":
        """One side of the aligner comparison over the window predictions:
        `package`'s aligner (geo4d_tpu_torch, the program; geo4d_ref, the
        reference) with the cell's configuration or `config`."""
        inf, icfg, acfg = self._configs(package)
        groups = inf.sliding_windows(self.traffic["frames"], icfg.window, icfg.stride)
        return Side(package, preds, groups, self.hw, config or acfg, **kw)

    @staticmethod
    def window_numbers(got: dict, ref_windows: dict) -> dict:
        """Relative L2 gaps of the window outputs. The confidence is compared
        as its inverse, the softplus of the decoded logit, on the pixels both
        sides keep (the others read 0): inverting it magnifies the rounding
        of the most confident pixels, and the gap of conf itself does not
        separate bf16 from fp8. The cameras are compared by the median
        camera's gap: a few cameras whose rays meet at a shallow angle take
        most of the whole-array gap, and it does not separate either."""
        out = {f"window_{k}": compare.rel_gap(got[k], ref_windows[k])
               for k in ("pts3d", "inv_depth")}
        kept = (np.asarray(got["conf"]) > 0) & (np.asarray(ref_windows["conf"]) > 0)
        out["window_inv_conf"] = compare.rel_gap(1.0 / np.asarray(got["conf"])[kept],
                                                 1.0 / np.asarray(ref_windows["conf"])[kept])
        out["window_traj_median"] = compare.median_row_gap(got["traj"], ref_windows["traj"])
        return out

    def align_numbers(self, scene: dict, program: "Side", reference: "Side", ref) -> tuple:
        """(numbers, each trained leaf's largest gradient gap over the three
        states): the program's aligner against the reference's over the same
        window predictions. `ref` is the reference's whole run, with its
        states recorded ("init", "calibrated", "end"); `scene` the program's
        answers (`scene_of`). Each number is a gap of float32 readings taken
        in float64, the reference's TF32 off and its algorithms
        deterministic:

          align_init_gap: the reference's phase-1 objective at the program's
            initialisation against the objective at the reference's;
          align_state_loss_gap, align_state_grad_gap: the program's
            objective and gradient (every trained leaf in PARAM_NAMES order,
            relative L2) against the reference's at each recorded state
            (parameters and gates written into both sides' aligners), the
            largest of the three;
          align_short_run_gap: both sides run SHORT_RUN's iterations from
            the reference's post-init state; the reference's objective at
            the program's end state against the objective at its own;
          align_endpoint_excess: the reference's objective at the program's
            answers (depth maps, poses, focal; its other parameters beside
            them) less the objective at its own end state, signed: a lower
            objective reads negative.

        Every gap is relative to the reference's reading."""
        from geo4d_ref.alignment.optimizer import PARAM_NAMES

        states = ref.states
        trained = [k for k in PARAM_NAMES if ref.params[k].requires_grad]

        def objective(params, use_depth_traj, aligner=ref):
            with torch.no_grad(), reference.settings():
                return float(aligner.loss_fn(params, use_depth_traj))

        out = {}
        at_init = objective(states["init"]["params"], False)
        init = program.initialised()
        out["align_init_gap"] = abs(objective(init.params, False) - at_init) / abs(at_init)
        del init

        gaps = {"loss": [], "grad": [], **{k: [] for k in trained}}
        for name, use_depth_traj in STATES:
            lp, gp = _loss_and_grad(program, states[name], use_depth_traj)
            lr, gr = _loss_and_grad(reference, states[name], use_depth_traj)
            gaps["loss"].append(abs(lp - lr) / abs(lr))
            gaps["grad"].append(_rel(torch.cat([gp[k] for k in trained]),
                                     torch.cat([gr[k] for k in trained])))
            for k in trained:
                gaps[k].append(_rel(gp[k], gr[k]))
        # np.max keeps a NaN, which the judge then fails
        worst = {k: float(np.max(v)) for k, v in gaps.items()}
        out["align_state_loss_gap"] = worst.pop("loss")
        out["align_state_grad_gap"] = worst.pop("grad")

        ends = []
        for side in (program, reference):
            al = side.at(states["init"], dataclasses.replace(side.config, **SHORT_RUN))
            with side.settings():
                al.run()
            ends.append(al)
        at_short = objective(ends[1].params, True, ends[1])
        out["align_short_run_gap"] = (abs(objective(ends[0].params, True, ends[1]) - at_short)
                                      / abs(at_short))
        del ends

        at_end = objective(ref.params, True)
        out["align_endpoint_excess"] = ((objective(self._answers(scene, ref), True) - at_end)
                                        / abs(at_end))
        return out, worst

    def _answers(self, scene: dict, ref) -> dict:
        """The program's answers as the reference's parameters."""
        from geo4d_ref.geometry.se3 import pose_to_params

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        params = {k: dev(v) for k, v in scene["align"].items()}
        params["log_depth"] = torch.log(dev(scene["depth"]).reshape(ref.N, ref.P))
        params["poses"] = pose_to_params(dev(scene["poses"]))
        focals = dev(scene["focals"])[:len(ref.params["focal"])]
        params["focal"] = ref.cfg.focal_break * torch.log(focals)
        return params

    def check(self) -> tuple:
        """(numbers, answers compared): the sampled call, drawn from the seed
        among those the window finished, against the reference's window
        predictions from the same video and draws, and its aligner against
        the reference aligner over the program's window predictions."""
        k = int(np.random.default_rng(scene.words(self.seed, 3)).integers(len(self.outputs)))
        got = self.outputs[k]
        with compare.tf32(False):
            ref_windows = self.reference_windows(self.reference_model(), k)
        models.free(self.device)
        preds = self.on_device(got)
        reference = self.side("geo4d_ref", preds)
        ref = reference.align(record=True)
        aligner, _ = self.align_numbers(got, self.side("geo4d_tpu_torch", preds), reference, ref)
        return {**self.window_numbers(got, ref_windows), **aligner}, 1


class Side:
    """One side of the aligner comparison: the GroupAligner class (by
    default `package`'s) and init_from_group (by default `package`'s) it
    runs, with its configuration, over window predictions on the device;
    its arithmetic in TF32 with `tf32` (the control), and with
    deterministic algorithms where it is the reference package."""

    def __init__(self, package: str, preds: dict, groups, hw, config, cls=None, init=None,
                 tf32: bool = False):
        from importlib import import_module

        self.cls = cls or import_module(f"{package}.alignment.optimizer").GroupAligner
        self.init = init or import_module(f"{package}.alignment.init").init_from_group
        self.preds, self.groups, self.hw, self.config = preds, groups, hw, config
        self.tf32, self.deterministic = tf32, package == "geo4d_ref"

    @contextlib.contextmanager
    def settings(self):
        with compare.tf32(self.tf32):
            with compare.deterministic() if self.deterministic else contextlib.nullcontext():
                yield

    def aligner(self, config=None):
        """The aligner over the predictions, not initialised."""
        p = self.preds
        return self.cls(self.groups, p["pts3d"], p["conf"], self.hw, invdepth=p["inv_depth"],
                        trajs=p["traj"], config=config or self.config,
                        device=p["pts3d"].device)

    def initialised(self):
        al = self.aligner()
        with self.settings():
            self.init(al, al.buf["pred_pts"], al.buf["weights"])
        return al

    def align(self, record: bool = False):
        """Initialised and run, as `align_predictions` does; with `record`,
        the reference's states recorded."""
        al = self.initialised()
        al.record_states = record
        with self.settings():
            al.run()
        return al

    def at(self, state: dict, config=None):
        """An aligner with a recorded state written into it."""
        al = self.aligner(config)
        with torch.no_grad():
            for k, v in state["params"].items():
                al.params[k].copy_(v)
            al.valid_depth_group.copy_(state["valid_depth_group"])
            al.valid_traj_group.copy_(state["valid_traj_group"])
        return al


def _loss_and_grad(side: Side, state: dict, use_depth_traj: bool) -> tuple:
    """(objective, {leaf: gradient in float64, zeros where it takes none})
    of the side's aligner at a recorded state."""
    al = side.at(state)
    names = [k for k, p in al.params.items() if p.requires_grad]
    with side.settings(), torch.enable_grad():
        loss = al.loss_fn(al.params, use_depth_traj)
        grads = dict(zip(names, torch.autograd.grad(loss, [al.params[k] for k in names],
                                                    allow_unused=True)))
    return float(loss.detach()), {k: (p if (p := grads.get(k)) is not None
                             else torch.zeros_like(al.params[k])).double().flatten()
                         for k in al.params}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))
