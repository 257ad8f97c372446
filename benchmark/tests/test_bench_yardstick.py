"""The benchmark's own arithmetic: the FLOP counter on the meta device
against a hand count, the frozen roofline bounds against chip_smoke.py's,
and the reference's control failing the limits."""


import pytest
import torch

import bench_paths  # noqa: F401
import bench_tiny
from harness import compare, flops, roofline, trace


def test_flop_counter_matches_a_hand_count():
    from geo4d_ref.nn.basics import Conv2d

    lin = torch.nn.Linear(64, 96, device="meta")
    conv = Conv2d(8, 16, 3, dtype=torch.float32).to_empty(device="meta")
    x = torch.empty((5, 7, 64), device="meta")
    img = torch.empty((2, 12, 20, 8), device="meta")
    assert flops._count(lambda: lin(x)) == 2 * 5 * 7 * 64 * 96
    assert flops._count(lambda: conv(img)) == 2 * 2 * 12 * 20 * 16 * 8 * 9


def test_model_flops_scale_with_the_work():
    model = bench_tiny.MODEL | {"schedule": {}, "scale_factor": 0.18215,
                                "modality": "pc_ray_cross_depth"}
    one = flops.reconstruct_flops(model, 4, (32, 64), 1, 4, 1)
    two = flops.reconstruct_flops(model, 8, (32, 64), 2, 4, 3)
    assert two["unet"] == pytest.approx(6 * one["unet"])
    assert two["decode"] == pytest.approx(2 * one["decode"])
    assert two["vae_encode"] == pytest.approx(2 * one["vae_encode"])
    step = flops.train_step_flops(model, 1, 4, (32, 64), 5)
    fwd = one["unet"]
    # the backward of a product costs two products (less the input
    # gradient of the first layer): about 3x the forward
    assert 2.8 * fwd < step["fwd_bwd"] <= 3 * fwd


SHAPES = {
    "group_norm": [(16, 2304, 320, True), (48, 147456, 128, False), (1, 576, 1280, True)],
    "flash_attention": [(16, 2304, 2304, 5), (16, 2304, 16, 5), (16, 576, 576, 10)],
    "temporal_attention": [(2304, 16, 320, 5), (576, 16, 640, 10)],
}


@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_roofline_bounds_are_chip_smokes(kernel):
    import chip_smoke

    for key in SHAPES[kernel]:
        ms, kind = chip_smoke.bound_ms(kernel, key)
        s, kind2 = roofline.forward_bound_s(kernel, key)
        assert s * 1e3 == pytest.approx(ms, rel=1e-12) and kind == kind2
        ms, kind = chip_smoke.bwd_bound_ms(kernel, key)
        s, kind2 = roofline.backward_bound_s(kernel, key)
        assert s * 1e3 == pytest.approx(ms, rel=1e-12) and kind == kind2


def test_roofline_share_reads_nothing_where_nothing_ran():
    record = {"launches": {"group_norm": {}}, "device_s_by_name": {}}
    assert roofline.share(record, ("group_norm",)) is None
    record = {"launches": {"group_norm": {(16, 2304, 320, True): 10}},
              "device_s_by_name": {"gn_resident_kernel": 1e-3}}
    bound = 10 * roofline.forward_bound_s("group_norm", (16, 2304, 320, True))[0]
    assert roofline.share(record, ("group_norm",)) == pytest.approx(100 * bound / 1e-3)


class _Event:
    def __init__(self, name, start_ns, duration_ns, device=True):
        self._name, self._start, self._dur, self._device = name, start_ns, duration_ns, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_trace_summary_on_the_host_window_and_spans():
    """Device intervals stamped on Unix time; the host window and spans on
    perf_counter, mapped by the offset that holds the device intervals."""
    off = 10**18
    offsets = {"unix": off, "monotonic": 5 * 10**12}
    events = [_Event("void gn_apply_kernel<128>(float*)", off + 1_000, 2_000),
              _Event("Memcpy HtoD", off + 2_500, 500),
              _Event("gn_apply_kernel", off + 9_000, 1_000),
              _Event("aten::add", off, 10**6, device=False)]
    spans = [(0, 6_000, "diffusion"), (6_000, 9_000, "align_iter")]
    out = trace.summarise(_Prof(events), (0, 12_000), spans, offsets)
    assert out["window_s"] == pytest.approx(12e-6)
    assert out["busy_s"] == pytest.approx(3e-6)        # [1000, 3000] and [9000, 10000]
    assert out["device_s_by_name"] == pytest.approx({"gn_apply_kernel": 3e-6, "Memcpy": 5e-7})
    # the gaps by length, each labelled by the span at its middle
    assert out["breakdown"]["idle_gaps"] == [["align_iter", pytest.approx(6e-6)],
                                             ["harness", pytest.approx(2e-6)],
                                             ["diffusion", pytest.approx(1e-6)]]


def test_trace_summary_without_a_matching_clock():
    events = [_Event("k", 10**12 + 100, 100), _Event("k", 10**12 + 400, 100)]
    out = trace.summarise(_Prof(events), (0, 10**6), [(0, 10**6, "build")],
                          {"unix": 0, "monotonic": 0})
    assert out["window_s"] == pytest.approx(400e-9) and out["busy_s"] == pytest.approx(200e-9)
    assert out["breakdown"]["idle_gaps"] == [["unlabelled", pytest.approx(200e-9)]]


def test_control_fails_the_recon_limits():
    """fp8 in place of the program, at the tiny preset's sizes on the CPU."""
    from drivers import reconstruct

    cell = bench_tiny.cell("recon.sintel32")
    d = reconstruct.Driver(cell["config"], cell["traffic"], 5, "cpu")
    d.build()
    model = d.reference_model()
    ref_w = d.reference_windows(model, 0)
    numbers = d.window_numbers(d.reference_windows(model, 0, control=True), ref_w)
    limits = {k: v for k, v in cell["limits"].items() if k in numbers}
    assert compare.judge(numbers, limits)[0] is False


def test_control_fails_the_train_limits():
    from drivers import train

    cell = bench_tiny.cell("train.b1")
    d = train.Driver(cell["config"], cell["traffic"], 5, "cpu")
    numbers = d.numbers(d.reference(control=True), d.reference())
    assert compare.judge(numbers, cell["limits"])[0] is False


@pytest.mark.gpu
def test_control_fails_at_the_cells_size(cuda):
    """The chip readings' control (calibrate.py) at the cells' own sizes."""
    import calibrate

    for cell in ("recon.sintel32", "train.b1"):
        calibrate.main(["--workload", cell, "--seeds", "1", "--control-seeds", "1"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
