"""Readings that set a cell's limits (`cells/<cell>.json`), on the card at
the cell's own sizes:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--no-windows] [--out FILE]

For each seed the program's outputs (the sampled unit of a run: the first
call of a reconstruct cell, the set-up's steps of a training cell) against
the reference, as a run's check compares them. For each control seed the
control and the planted faults against the reference:

  reconstruct: the reference's windows in fp8 (the bf16 model one precision
    down); the reference aligner in TF32 (the float32 aligner one precision
    down); faults planted in the reference aligner (`recon_faults`): its
    state left unchanged after the initialisation; the second phase left
    out; Adam's step count one too high; a cosine learning-rate schedule in
    place of the linear one; the calibration left out; the last tenth of
    the iterations left out (450 of 500); the disparity term's weight 2.2
    in place of 2.0; the initialisation's depth maps 1% too deep. Each
    seed also reads three sound variants of the program's aligner over the
    same window predictions: `program_again`, the port's aligner run
    again; `fused`, the port's aligner with the fused objective op
    (ops/align_objective.py) in place of the per-pixel terms of its
    objective (`fused_aligner`); `ulp`, the port's aligner over the
    predictions with one point moved by one ulp (`ulp_preds`). Every kind
    reads every aligner number (`Driver.align_numbers`), each trained
    leaf's gradient gap (`grad_gap.<leaf>`) and the answers' own gaps;
  training: the reference in fp8; half the frames left out of the loss;
    AdamW's step count one too high.

`--no-windows` leaves out the window predictions' reference (a reconstruct
cell's aligner numbers only). Prints one JSON line per seed and, last, the
lowest and the highest reading of each number for each kind. Everything
runs in one process, so the card is set up once for the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import compare, models, spec  # noqa: E402

SOUND = ("program", "program_again", "fused", "ulp")


def half_frames_loss(unet, schedule, batch, draws, cfg):
    """The reference's v-loss (no geometry condition) with half of the
    clip's frames left out: the mean over the first half (a planted fault)."""
    z0 = batch["z0"]
    dev = z0.device
    ts = draws.randint(schedule.num_timesteps, (z0.shape[0],))
    noise = draws.normal(z0.shape)

    def at(table):
        return torch.as_tensor(table, device=dev)[ts][:, None, None, None, None].float()

    if schedule.scale_arr is not None:
        z0 = z0 * at(schedule.scale_arr)
    sa, sb = at(schedule.sqrt_alphas_cumprod), at(schedule.sqrt_one_minus_alphas_cumprod)
    pred = unet(torch.cat([sa * z0 + sb * noise, batch["c_concat"]], dim=-1), ts,
                batch["context"], batch["fs"])
    t = z0.shape[1] // 2
    loss = torch.mean((pred[:, :t] - (sa * noise - sb * z0)[:, :t]) ** 2)
    return loss, {"loss_simple": loss.detach()}


def diagnose_train(got: dict, ref: dict) -> dict:
    """What lies behind the training numbers: both sides' losses at every
    step, and the leaves with the widest change gaps after step 1 and after
    the last ([name, gap, program, reference, gradient over the median
    leaf's])."""
    g = ref["first"]["grad"]
    median = float(np.median(list(g.values())))

    def widest(when):
        dp, dr = got[when]["change"], ref[when]["change"]
        cmed = float(np.median(list(dr.values())))
        gaps = sorted(((abs(dp[n] - dr[n]) / max(dr[n], cmed), n) for n in dr
                       if g[n] >= 1e-3 * median), reverse=True)[:3]
        return [[n, gap, dp[n], dr[n], g[n] / median] for gap, n in gaps]

    return {"program_losses": got["losses"], "reference_losses": ref["losses"],
            "worst_change_first_step": widest("first"), "worst_change": widest("last")}


def answer_gaps(scene: dict, ref) -> dict:
    """The aligner's answers' own relative L2 gaps to the reference
    aligner's, which a run does not compare: the depth maps, the poses and
    the focal, and the median frame's depth and median camera."""
    depth, poses = ref.get_depthmaps(), ref.get_im_poses()
    return {"align_depth": compare.rel_gap(scene["depth"], depth),
            "align_depth_median": compare.median_row_gap(scene["depth"], depth),
            "align_poses": compare.rel_gap(scene["poses"], poses),
            "align_poses_median": compare.median_row_gap(scene["poses"], poses),
            "align_focal": compare.rel_gap(scene["focals"], ref.get_focals())}


class _AdamCountAhead(torch.optim.Adam):
    """Adam whose bias corrections count one step ahead: its state starts at
    step 1 with zero moments."""

    def __init__(self, params, **kw):
        super().__init__(params, **kw)
        for group in self.param_groups:
            for p in group["params"]:
                step_device = p.device if group["fused"] or group["capturable"] else "cpu"
                self.state[p] = {"step": torch.ones((), dtype=torch.float32, device=step_device),
                                 "exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}


def fused_aligner():
    """The program's GroupAligner with the objective op
    (geo4d_tpu_torch/ops/align_objective.py) in place of `loss_fn`'s
    point-map and disparity terms, assembled as
    tests/test_torch_align_objective.py's `op_loss` does; its trajectory and
    smoothing terms as `loss_fn` computes them. A sound variant: the same
    objective, summed in another order."""
    from geo4d_tpu_torch.alignment.optimizer import GroupAligner, _rel_pose_loss
    from geo4d_tpu_torch.geometry.se3 import params_to_pose
    from geo4d_tpu_torch.ops import align_objective as objective

    class FusedAligner(GroupAligner):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            cfg, buf = self.cfg, self.buf
            if cfg.depth_regularize_weight or self.has_flow:
                raise ValueError("the fused variant has no depth pull and no flow term")
            self.data = objective.ObjectiveData(
                self.groups, buf["pred_pts"], buf["weights"], buf.get("invdepth"),
                (self.H, self.W), cfg.conf_clamp if cfg.conf_optimize else None,
                cfg.invdepth_valid_thr, cfg.depth_loss_weight)

        def loss_fn(self, params, use_depth_traj, iter_frac=1.0):
            cfg, buf = self.cfg, self.buf
            poses = params_to_pose(params["poses"])
            pw = params_to_pose(params["pw_poses"][:, :7])
            sims = pw[:, :3] * self._pw_scale(params)[:, None, None]
            loss = objective.align_objective(
                self.data, params["log_depth"], self._focals(params), poses[:, :3], sims,
                params["s_depth"], params["t_depth"], self.valid_depth_group,
                use_depth_traj and self.has_depth)
            if use_depth_traj and self.has_traj:
                scale = torch.exp(params["traj_align"][:, 7])
                RT = params_to_pose(params["traj_align"][:, :7])
                traj = buf["trajs"]
                traj = torch.cat([traj[..., :3, :3],
                                  traj[..., :3, 3:] * scale[:, None, None, None]], dim=-1)
                traj = torch.cat([traj, buf["trajs"][..., 3:, :]], dim=-2)
                moved = RT[:, None] @ traj
                per = _rel_pose_loss(moved.reshape(-1, 4, 4), self._gather(poses),
                                     cfg.translation_weight).reshape(self.G, self.S)
                loss = loss + (per * self.valid_traj_group[:, None]).sum() * cfg.traj_loss_weight
            if cfg.temporal_smoothing_weight > 0:
                loss = loss + cfg.temporal_smoothing_weight * _rel_pose_loss(
                    poses[:-1], poses[1:], cfg.translation_weight).sum()
            return loss

    return FusedAligner


def ulp_preds(got: dict, seed: int, device) -> dict:
    """The window predictions with one point, drawn from the seed among
    those whose weight (conf) the initialisation and the objective read
    (over 0.5), moved up by one ulp in each coordinate."""
    from drivers.reconstruct import OUTPUT_KEYS
    from harness import scene

    pts = np.array(got["pts3d"], np.float32)
    flat = pts.reshape(-1, 3)
    read = np.flatnonzero(np.asarray(got["conf"]).reshape(-1) > 0.5)
    i = int(read[np.random.default_rng(scene.words(seed, 5)).integers(read.size)])
    flat[i] = np.nextafter(flat[i], np.float32(np.inf))
    return {k: torch.as_tensor(pts if k == "pts3d" else got[k], device=device)
            for k in OUTPUT_KEYS}


def recon_faults(config) -> dict:
    """The faults planted in the reference aligner (`Side` arguments over
    the reference package), each named by what it breaks."""
    from geo4d_ref.alignment.init import init_from_group
    from geo4d_ref.alignment.optimizer import GroupAligner

    class Unchanged(GroupAligner):
        """The optimisation returns its state as it found it."""

        def run(self, verbose=False, timer=None):
            return 0.0

    class Shortened(GroupAligner):
        """The run stops at `stop(cfg)` iterations, its schedule with it."""

        def run(self, verbose=False, timer=None):
            self.cfg = dataclasses.replace(self.cfg, n_iter=self.stop(self.cfg))
            return super().run(verbose, timer)

    class NoPhase2(Shortened):
        """The second phase left out: the run stops at the switch."""

        @staticmethod
        def stop(cfg):
            return min(cfg.depth_traj_start_iter, cfg.n_iter)

    class NineTenths(Shortened):
        """The last tenth of the iterations left out (450 of 500)."""

        @staticmethod
        def stop(cfg):
            return cfg.n_iter * 9 // 10

    class AdamCount(GroupAligner):
        """Adam's step count one too high."""

        def run(self, verbose=False, timer=None):
            with mock.patch.object(torch.optim, "Adam", _AdamCountAhead):
                return super().run(verbose, timer)

    class NoCalibration(GroupAligner):
        """The calibration left out: disparity scale 1, shift 0, the gates
        as the aligner starts them."""

        def calibrate(self):
            pass

    def init_deep(aligner, pred_pts, conf):
        """The initialisation's depth maps 1% too deep."""
        out = init_from_group(aligner, pred_pts, conf)
        with torch.no_grad():
            aligner.params["log_depth"].add_(float(np.log(1.01)))
        return out

    return {"fault_unchanged": {"cls": Unchanged},
            "fault_no_phase2": {"cls": NoPhase2},
            "fault_adam_count": {"cls": AdamCount},
            "fault_cosine": {"config": dataclasses.replace(config, schedule="cosine")},
            "fault_no_calibration": {"cls": NoCalibration},
            "fault_n_iter_450": {"cls": NineTenths},
            "fault_depth_weight": {"config": dataclasses.replace(config, depth_loss_weight=2.2)},
            "fault_init_deep": {"init": init_deep}}


def recon_readings(driver_cls, cell, seed, sound: bool, control: bool, windows: bool,
                   device="cuda"):
    from drivers.reconstruct import scene_of

    d = driver_cls(cell["config"], cell["traffic"], seed, device)
    d.build()
    d.run_unit(None)
    got = d.outputs[0]
    d.release()
    out = {}
    if windows:
        with compare.tf32(False):
            ref_model = d.reference_model()
            ref_w = d.reference_windows(ref_model, 0)
            if sound:
                out["program"] = d.window_numbers(got, ref_w)
            if control:
                out["control"] = d.window_numbers(d.reference_windows(ref_model, 0, True), ref_w)
            del ref_model
            models.free(d.device)
    preds = d.on_device(got)
    reference = d.side("geo4d_ref", preds)
    ref = reference.align(record=True)

    def numbers(side, scene=None):
        """The aligner numbers of a side, each trained leaf's gradient gap
        and its answers' gaps; `scene` is the side's own whole run unless
        given."""
        scene = scene or scene_of(side.align())
        nums, leaves = d.align_numbers(scene, side, reference, ref)
        return {**nums, **{f"grad_gap.{k}": v for k, v in leaves.items()},
                **answer_gaps(scene, ref)}

    if sound:
        program = d.side("geo4d_tpu_torch", preds)
        out.setdefault("program", {}).update(numbers(program, got))
        out["program_again"] = numbers(program)
        out["fused"] = numbers(d.side("geo4d_tpu_torch", preds, cls=fused_aligner()))
        out["ulp"] = numbers(d.side("geo4d_tpu_torch", ulp_preds(got, seed, d.device)))
    if control:
        out["control_tf32"] = numbers(d.side("geo4d_ref", preds, tf32=True))
        for name, kw in recon_faults(reference.config).items():
            out[name] = numbers(d.side("geo4d_ref", preds, **kw))
    return out


def train_readings(driver_cls, cell, seed, sound: bool, control: bool, windows: bool):
    d = driver_cls(cell["config"], cell["traffic"], seed, "cuda")
    d.setup()
    got = d.program_readings()
    d.release()
    models.free("cuda")
    with compare.tf32(False):
        ref = d.reference()
        out = {"program": d.numbers(got, ref), "diag": diagnose_train(got, ref)}
        if control:
            out["control"] = d.numbers(d.reference(control=True), ref)
            out["fault_half_frames"] = d.numbers(d.reference(loss_fn=half_frames_loss), ref)
            out["fault_adam_count"] = d.numbers(d.reference(adam_count=1), ref)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--no-windows", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.cell(spec.benchmark(BENCH_DIR.parent), args.workload, BENCH_DIR.parent)
    driver_cls = spec.driver(cell["traffic"])
    readings = recon_readings if cell["traffic"]["driver"] == "reconstruct" else train_readings
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines, ranges = [], {}
    for seed in sorted(set(seeds) | controls):
        r = readings(driver_cls, cell, seed, seed in seeds, seed in controls,
                     not args.no_windows)
        if seed not in seeds:
            for kind in SOUND:
                r.pop(kind, None)
        line = {"seed": seed, **r}
        print(json.dumps(line), flush=True)
        lines.append(line)
        for kind, numbers in r.items():
            if kind == "diag":
                continue
            agg = ranges.setdefault(kind, {})
            for k, v in numbers.items():
                lo, hi = agg.get(k, (v, v))
                agg[k] = [min(lo, v), max(hi, v)]
        models.free("cuda")
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
               "range": ranges}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
