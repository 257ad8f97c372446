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
    down); the aligner's state left unchanged after its initialisation; the
    aligner's second phase left out. Each seed also reads the program's
    aligner run again over the same window predictions (its atomic adds
    make it differ now and then);
  training: the reference in fp8; half the frames left out of the loss;
    AdamW's step count one too high.

`--no-windows` leaves out the window predictions' reference (a reconstruct
cell's aligner numbers only). Prints one JSON line per reading and, last,
the largest sound reading and the smallest control and fault reading of
each number. Everything runs in one process, so the card is set up once
for the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import compare, models, spec  # noqa: E402

SOUND = ("program", "program_again")


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


def _unchanged_aligner(d, got):
    """The reference aligner initialised and left unchanged (a planted
    fault: the optimisation returns its state as it found it)."""
    from geo4d_ref.alignment.init import init_from_group
    from geo4d_ref.alignment.optimizer import GroupAligner

    inf, icfg, acfg = d._configs("geo4d_ref")
    groups = inf.sliding_windows(d.traffic["frames"], icfg.window, icfg.stride)
    with compare.deterministic():
        aligner = GroupAligner(groups, got["pts3d"], got["conf"], d.hw,
                               invdepth=got["inv_depth"], trajs=got["traj"], config=acfg,
                               device=d.device)
        init_from_group(aligner, aligner.buf["pred_pts"], aligner.buf["weights"])
    return aligner


def recon_readings(driver_cls, cell, seed, control: bool, windows: bool):
    from drivers.reconstruct import OUTPUT_KEYS, scene_of
    from geo4d_tpu_torch.pipeline import inference as port

    d = driver_cls(cell["config"], cell["traffic"], seed, "cuda")
    d.build()
    d.run_unit(None)
    got = d.outputs[0]
    # the program's aligner again over the same window predictions
    _, icfg, acfg = d._configs("geo4d_tpu_torch")
    groups = port.sliding_windows(d.traffic["frames"], icfg.window, icfg.stride)
    preds = {k: torch.as_tensor(got[k], device=d.device) for k in OUTPUT_KEYS}
    again = scene_of(port.align_predictions(groups, preds, d.hw, acfg))
    del preds
    d.release()
    out = {}
    with compare.tf32(False):
        if windows:
            ref_model = d.reference_model()
            ref_w = d.reference_windows(ref_model, 0)
            out["program"] = d.window_numbers(got, ref_w)
            if control:
                out["control"] = d.window_numbers(d.reference_windows(ref_model, 0, True), ref_w)
            del ref_model
            models.free(d.device)
        ref = d.reference_aligner(got)

        def numbers(scene):
            return {**d.align_numbers(scene, ref), **answer_gaps(scene, ref)}

        out.setdefault("program", {}).update(numbers(got))
        out["program_again"] = numbers(again)
        if control:
            out["control_tf32"] = numbers(scene_of(d.reference_aligner(got, tf32=True)))
            out["fault_unchanged"] = numbers(scene_of(_unchanged_aligner(d, got)))
            _, _, rcfg = d._configs("geo4d_ref")
            phase1 = dataclasses.replace(rcfg, n_iter=rcfg.depth_traj_start_iter)
            out["fault_no_phase2"] = numbers(scene_of(d.reference_aligner(got, config=phase1)))
    return out


def train_readings(driver_cls, cell, seed, control: bool, windows: bool):
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
    lines, worst = [], {}
    for seed in sorted(set(seeds) | controls):
        r = readings(driver_cls, cell, seed, seed in controls, not args.no_windows)
        if seed not in seeds:
            for kind in SOUND:
                r.pop(kind, None)
        line = {"seed": seed, **r}
        print(json.dumps(line), flush=True)
        lines.append(line)
        for kind, numbers in r.items():
            if kind == "diag":
                continue
            agg = worst.setdefault(kind, {})
            pick = max if kind in SOUND else min
            for k, v in numbers.items():
                agg[k] = pick(agg.get(k, v), v)
        models.free("cuda")
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
               "largest": {k: v for k, v in worst.items() if k in SOUND},
               "smallest": {k: v for k, v in worst.items() if k not in SOUND}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
