"""The KITTI evaluation cell, recon.kitti110, at the tiny preset's sizes on
the CPU: a whole run with `correct` true and the metrics the cell reports,
the counted driver's work, and its new reader."""

import copy
import time

import pytest

import bench_paths  # noqa: F401
import bench_tiny
from bench_paths import ROOT
from harness import runner, spec

CELL = "recon.kitti110"
SEED = 2**31 + 1213
RECON_METRICS = {"towers_ms_per_frame.recon", "unet_step_ms_per_window.recon",
                 "decode_ms_per_window.recon", "align_init_s.recon", "align_iter_ms.recon",
                 "k1_roofline.recon", "attn_roofline.recon", "mfu.recon", "device_idle.recon"}
# StageTimer and host-clock readers; the rooflines need the kernels' device time
READ_ON_CPU = {"towers_ms_per_frame.recon", "unet_step_ms_per_window.recon",
               "decode_ms_per_window.recon", "align_init_s.recon", "align_iter_ms.recon",
               "mfu.recon", "align_ns_per_point_iter.recon"}


def tiny_cell() -> dict:
    """The cell with bench_tiny's model in float32, windows of 4 at stride
    2 and 11 frames of 32 x 64: 5 windows (the last a tail window) in one
    UNet call at the cell's window_batch of 5."""
    c = spec.cell(spec.benchmark(ROOT), CELL, ROOT)
    m = c["config"]["model"]
    model = dict(copy.deepcopy(bench_tiny.MODEL), schedule=m["schedule"],
                 scale_factor=m["scale_factor"], modality=m["modality"])
    config = dict(c["config"], model=model, dtype="float32")
    config["inference"] = dict(config["inference"], window=4, stride=2)
    config["aligner"] = dict(config["aligner"], n_iter=8, depth_traj_start_iter=4)
    traffic = dict(c["traffic"], frames=11, height=32, width=64, videos=2, warm_iters=5)
    return dict(c, config=config, traffic=traffic)


def run(traced: bool) -> dict:
    return runner.run(tiny_cell(), SEED, 0.2, traced, "cpu", time.perf_counter())


def test_the_cell_reports_what_it_names():
    c = spec.cell(spec.benchmark(ROOT), CELL, ROOT)
    assert {m["name"] for m in c["end_to_end"]} == {"s_per_frame", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == RECON_METRICS | {"align_ns_per_point_iter.recon"}
    t = c["traffic"]
    assert (t["driver"], t["frames"], t["height"], t["width"], t["fps"], t["window_batch"]) == \
        ("reconstruct_counted", 110, 192, 640, 10, 5)
    assert c["config"]["inference"]["sky_eps"] == 0.1


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_run_is_correct_and_reports_its_metrics(traced):
    out = run(traced)
    r, record = out["result"], out["record"]
    assert r["correct"] is True and r["failed"] == 0
    got = set(r["metrics"])
    if traced:
        assert READ_ON_CPU <= got <= RECON_METRICS | READ_ON_CPU | {"device_idle.recon"}
    else:
        # peak_mem_gib reads the CUDA allocator: left out on the CPU
        assert got == {"s_per_frame", "setup_s"}
    units = record["work"]["units"]
    assert record["work"]["window_chunks"] == units
    assert record["work"]["window_rows_padded"] == 0
    assert record["work"]["align_points"] == units * 5 * 4 * 32 * 64


def test_the_driver_counts_into_an_installed_recorder():
    from geo4d_tpu_torch.core import timing

    cell = tiny_cell()
    d = spec.driver(cell["traffic"])(cell["config"], cell["traffic"], SEED, "cpu")
    d.build()
    rec = timing.SpanRecorder()
    with timing.recording(rec):
        work = d.run_unit(None)
    assert rec.totals()["align_points"] == work["align_points"] == 5 * 4 * 32 * 64
    assert work["window_chunks"] == 1 and timing.current() is None


def test_a_program_without_the_accessor_or_counters_still_runs(monkeypatch):
    """As on a program older than the counters: `timing.current` absent and
    `count` a no-op; the work then holds no counter and the new reader
    reads nothing."""
    from geo4d_tpu_torch.core import timing

    monkeypatch.delattr(timing, "current")
    monkeypatch.setattr(timing.SpanRecorder, "count", lambda self, *a: None)
    cell = tiny_cell()
    d = spec.driver(cell["traffic"])(cell["config"], cell["traffic"], SEED, "cpu")
    d.build()
    work = d.run_unit(None)
    assert work["frames"] == 11 and "align_points" not in work
    record = {"stages": {"align_phase1": 1.0}, "stage_work": dict(work)}
    assert spec.reader("align_ns_per_point_iter.recon")(record) is None


def test_the_reader_divides_by_iterations_and_points_per_call():
    record = {"stages": {"align_phase1": 1.0, "calibrate": 0.5, "align_phase2": 2.5,
                         "decode": 9.0},
              "stage_work": {"align_iters": 1000, "align_points": 2 * 4_000_000,
                             "reconstructs": 2}}
    assert spec.reader("align_ns_per_point_iter.recon")(record) == pytest.approx(1.0)


def test_calibration_reads_the_cell_as_a_reconstruct_cell():
    import calibrate_counted

    cell = calibrate_counted.reconstruct_cell(spec.benchmark(ROOT), CELL, ROOT)
    want = spec.cell(spec.benchmark(ROOT), CELL, ROOT)
    assert cell["traffic"] == dict(want["traffic"], driver="reconstruct")
    assert cell["limits"] == want["limits"] and cell["config"] == want["config"]


def test_tiny_traced_run_with_the_recorder():
    """run_spans.py's run: the cell's span readings are a reconstruct cell's,
    and the driver counts into the recorder that the run installs."""
    from harness import spans

    out = spans.recording_runner(runner.run)(tiny_cell(), SEED, 0.2, True, "cpu",
                                             time.perf_counter())
    r, record = out["result"], out["record"]
    assert r["correct"] is True
    assert list(r["span_metrics"]) == spans.CELL_METRICS["reconstruct"]
    assert record["program_counts"]["align_points"] == 5 * 4 * 32 * 64
    assert record["program_counts"]["window_chunks"] == 1
    assert "align_ns_per_point_iter.recon" in r["metrics"]
