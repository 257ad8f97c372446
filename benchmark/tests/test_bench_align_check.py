"""The reconstruct cells' aligner numbers at the tiny preset's sizes on the
CPU: the program's aligner and its sound variants pass the limits, the
faults planted in the reference aligner fail them, and recording the
reference's states leaves its run as it was, bit for bit."""

import numpy as np
import pytest
import torch

import bench_paths  # noqa: F401
import bench_tiny
import calibrate
from drivers import reconstruct
from harness import compare

# a seed on which the calibration keeps the disparity term of some window
SEED = 5
FAULTS = ("fault_unchanged", "fault_no_phase2", "fault_adam_count", "fault_cosine",
          "fault_no_calibration", "fault_n_iter_450", "fault_depth_weight", "fault_init_deep")


def align_limits(cell):
    return {k: v for k, v in cell["limits"].items() if k.startswith("align_")}


@pytest.fixture(scope="module")
def call():
    """One reconstruct's window predictions and the reference aligner's
    recorded run over them."""
    cell = bench_tiny.cell("recon.sintel32")
    d = reconstruct.Driver(cell["config"], cell["traffic"], SEED, "cpu")
    d.build()
    d.run_unit(None)
    preds = d.on_device(d.outputs[0])
    reference = d.side("geo4d_ref", preds)
    ref = reference.align(record=True)
    assert ref.valid_depth_group.any()
    return cell, d, preds, reference, ref


def test_program_and_its_sound_variants_pass(call):
    """The program, run again, and over predictions moved by one ulp, on
    every number; the fused objective op in the aligner at the fixed
    states. Over a run, the op's sums in another order move the tiny
    scene's few pixels further than the cell's (PERF.md section 4): its
    short run and endpoint are judged at the cell's size on the card."""
    cell = call[0]
    readings = calibrate.recon_readings(reconstruct.Driver, cell, SEED, True, False, False,
                                        device="cpu")
    assert set(readings) == {"program", "program_again", "fused", "ulp"}
    limits = align_limits(cell)
    for kind in ("program", "program_again", "ulp"):
        correct, check = compare.judge(readings[kind], limits)
        assert correct, (kind, check)
    states = {k: v for k, v in limits.items() if k.startswith(("align_init", "align_state"))}
    correct, check = compare.judge(readings["fused"], states)
    assert correct, check


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(call, fault):
    cell, d, preds, reference, ref = call
    kw = calibrate.recon_faults(reference.config)[fault]
    side = d.side("geo4d_ref", preds, **kw)
    numbers, _ = d.align_numbers(reconstruct.scene_of(side.align()), side, reference, ref)
    assert compare.judge(numbers, align_limits(cell))[0] is False, numbers


def test_recording_states_leaves_the_run_as_it_was(call):
    _, _, _, reference, recorded = call
    plain = reference.align()
    assert plain.states == {} and set(recorded.states) == {"init", "calibrated", "end"}
    for k, p in plain.params.items():
        assert torch.equal(p, recorded.params[k]), k
        assert torch.equal(recorded.states["end"]["params"][k], p), k
    assert torch.equal(plain.valid_depth_group, recorded.states["end"]["valid_depth_group"])


def test_a_nan_objective_fails(call):
    """A program whose objective reads NaN fails the state numbers
    themselves, not only what its run makes of the NaN."""
    from geo4d_tpu_torch.alignment.optimizer import GroupAligner

    class NaNObjective(GroupAligner):
        def loss_fn(self, params, use_depth_traj, iter_frac=1.0):
            return super().loss_fn(params, use_depth_traj, iter_frac) * float("nan")

    cell, d, preds, reference, ref = call
    side = d.side("geo4d_tpu_torch", preds, cls=NaNObjective)
    numbers, _ = d.align_numbers(d.outputs[0], side, reference, ref)
    assert np.isnan(numbers["align_state_loss_gap"]) and np.isnan(numbers["align_state_grad_gap"])
    assert compare.judge(numbers, align_limits(cell))[0] is False
