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

    def reference_aligner(self, got: dict, tf32: bool = False, config=None):
        """The reference's aligner over the program's window predictions
        (compared on their own by the window numbers): float32 with TF32
        off, or on with `tf32` (the control), and deterministic; `config`
        replaces the aligner's configuration (a planted fault)."""
        inf, icfg, acfg = self._configs("geo4d_ref")
        groups = inf.sliding_windows(self.traffic["frames"], icfg.window, icfg.stride)
        preds = {k: torch.as_tensor(got[k], device=self.device) for k in OUTPUT_KEYS}
        with compare.tf32(tf32), compare.deterministic():
            return inf.align_predictions(groups, preds, self.hw, config or acfg,
                                         device=self.device)

    def numbers(self, got: dict, ref_windows: dict, ref_aligner) -> dict:
        return {**self.window_numbers(got, ref_windows), **self.align_numbers(got, ref_aligner)}

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

    def align_numbers(self, got: dict, ref) -> dict:
        """The aligner's results against the reference aligner's over the
        same window predictions: the gap of the reference's objective at the
        program's answers (depth maps, poses, focal; its other parameters
        beside them) to the objective at its own, over the latter. The
        answers' own gaps do not separate TF32 from sound runs (see
        PERF.md)."""
        from geo4d_ref.geometry.se3 import pose_to_params

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        params = {k: dev(v) for k, v in got["align"].items()}
        params["log_depth"] = torch.log(dev(got["depth"]).reshape(ref.N, ref.P))
        params["poses"] = pose_to_params(dev(got["poses"]))
        focals = dev(got["focals"])[:len(ref.params["focal"])]
        params["focal"] = ref.cfg.focal_break * torch.log(focals)
        with torch.no_grad(), compare.tf32(False):
            at_got = float(ref.loss_fn(params, True))
            at_ref = float(ref.loss_fn(ref.params, True))
        return {"align_objective": abs(at_got - at_ref) / abs(at_ref)}

    def check(self) -> tuple:
        """(numbers, answers compared): the sampled call, drawn from the seed
        among those the window finished, against the reference's window
        predictions from the same video and draws, and its scene against the
        reference aligner's over the program's window predictions."""
        k = int(np.random.default_rng(scene.words(self.seed, 3)).integers(len(self.outputs)))
        got = self.outputs[k]
        with compare.tf32(False):
            ref_windows = self.reference_windows(self.reference_model(), k)
        models.free(self.device)
        return self.numbers(got, ref_windows, self.reference_aligner(got)), 1
