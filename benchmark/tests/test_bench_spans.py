"""The join of the program's spans with the device trace (harness/spans.py)
on synthetic profiler events, its readings, and a traced run at the tiny
preset on the CPU with the span recorder installed: the result line keeps
today's metrics, and the readings that need device events are None."""

import time
from types import SimpleNamespace

import pytest
import torch

import bench_paths  # noqa: F401
import bench_tiny
from harness import runner, spans

OFF = 5_000_000_000                      # perf_counter ns -> the profiler's clock
OFFSETS = {"unix": 10**15, "monotonic": OFF}
HOST = (1000, 2000)
# [id, parent, request, name, start, end] on perf_counter ns; 1900-2000 is
# outside every span
SPANS = [[0, None, 0, "unit", 1000, 1900], [1, 0, 0, "build", 1000, 1300],
         [2, 1, 0, "build_encode", 1050, 1200], [3, 0, 0, "forward_backward", 1300, 1800],
         [4, 3, 0, "loss", 1300, 1500], [5, 3, 0, "backward", 1500, 1800]]


class Event:
    """The methods of a kineto event that the join reads."""

    def __init__(self, name, device, start, dur, corr, annotation=False):
        self._name, self._device, self._annotation = name, device, annotation
        self._start, self._dur, self._corr = start + OFF, dur, corr

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


EVENTS = [
    # device: kernels, a copy, a fill, one whose launch is not in the trace,
    # and a copy of a host range that spans kernels but is none
    Event("gn_stats_kernel", True, 1150, 100, 1), Event("elementwise_kernel", True, 1260, 40, 2),
    Event("Memcpy HtoD", True, 1320, 80, 3), Event("sm90_gemm", True, 1600, 100, 4),
    Event("Memset", True, 1950, 10, 5), Event("orphan_kernel", True, 1800, 10, 6),
    Event("unit", True, 1000, 1000, 7, annotation=True),
    # host: the launch calls, and an operator that is none
    Event("cudaLaunchKernel", False, 1100, 5, 1), Event("cudaLaunchKernelExC", False, 1250, 5, 2),
    Event("cudaMemcpyAsync", False, 1310, 5, 3), Event("cuLaunchKernelEx", False, 1550, 5, 4),
    Event("cudaMemsetAsync", False, 1950, 5, 5), Event("aten::add", False, 900, 5, 4),
]
PROF = SimpleNamespace(profiler=SimpleNamespace(
    kineto_results=SimpleNamespace(events=lambda: EVENTS)))
MS = 1e-6


def _join():
    return spans.join(SPANS, *spans.trace_events(PROF), HOST, OFFSETS)


def test_events_and_launches_are_read_by_correlation_id():
    dev, launches = spans.trace_events(PROF)
    assert [c for _, _, c in dev] == [1, 2, 3, 4, 5, 6]
    assert launches == {1: 1100 + OFF, 2: 1250 + OFF, 3: 1310 + OFF, 4: 1550 + OFF,
                        5: 1950 + OFF}


def test_span_table_puts_device_time_and_idle_to_spans():
    out = _join()
    table = out["span_table"]
    want = {  # name: count, host, self, device, launches, idle (ns)
        "unit": (1, 900, 100, 320, 4, 570),
        "build": (1, 300, 150, 140, 2, 160),
        "build_encode": (1, 150, 150, 100, 1, 100),
        "forward_backward": (1, 500, 0, 180, 2, 320),
        "loss": (1, 200, 200, 80, 1, 120),
        "backward": (1, 300, 300, 100, 1, 200),
        spans.OUTSIDE: (0, 100, 100, 10, 1, 90),
    }
    assert set(table) == set(want)
    for name, (n, host, own, dev, launches, idle) in want.items():
        row = table[name]
        assert row["count"] == n and row["launches"] == launches, name
        for key, v in (("host_ms", host), ("self_ms", own), ("device_ms", dev),
                       ("idle_ms", idle)):
            assert row[key] == pytest.approx(v * MS), (name, key)
    # gaps by the innermost span open at their midpoints; the last one lies
    # outside every span
    assert out["idle_by_span"] == pytest.approx(
        {"build_encode": 150 * MS, "build": 10 * MS, "loss": 20 * MS, "backward": 300 * MS,
         "unit": 140 * MS, spans.OUTSIDE: 40 * MS})
    assert out["attribution"] == pytest.approx(
        {"device_ms": 340 * MS, "in_request_ms": 320 * MS, "outside_ms": 10 * MS,
         "unlaunched_ms": 10 * MS, "in_request_share": 320 / 340})


def test_without_a_clock_offset_nothing_is_put_to_spans():
    out = spans.join(SPANS, *spans.trace_events(PROF), HOST, {"unix": 10**15})
    assert out["attribution"] is None and out["idle_by_span"] is None
    assert "device_ms" not in out["span_table"]["unit"]
    assert out["span_table"]["unit"]["host_ms"] == pytest.approx(900 * MS)


def test_spans_starting_together_nest_by_length():
    segs = spans._segments([(0, 10, 20), (1, 10, 15), (2, 20, 25)], 0, 30)
    assert segs == [(0, 10, None), (10, 15, 1), (15, 20, 0), (20, 25, 2), (25, 30, None)]


def test_readings_of_the_span_table():
    record = {"program_spans": SPANS, "program_counts": {}, **_join()}
    got = {m: f(record) for m, f in spans.METRICS.items()}
    assert got["build_device_ms.train"] == pytest.approx(140 * MS)
    assert got["fwd_bwd_device_ms.train"] == pytest.approx(180 * MS)
    assert got["fwd_bwd_idle.train"] == pytest.approx(100 * 320 / 500)
    assert got["align_launches_per_iter.recon"] is None and got["pnp_failed_share.recon"] is None

    table = {"align_iter": {"count": 2, "launches": 10, "device_ms": 4.0},
             "align_phase1": {"host_ms": 4.0, "idle_ms": 1.0},
             "calibrate": {"host_ms": 1.0, "idle_ms": 1.0},
             "align_phase2": {"host_ms": 5.0, "idle_ms": 2.0}}
    record = {"span_table": table, "program_counts": {"pnp_frames": 32, "pnp_failed": 8}}
    assert spans.METRICS["align_launches_per_iter.recon"](record) == 5
    assert spans.METRICS["align_device_ms_per_iter.recon"](record) == 2.0
    assert spans.METRICS["align_idle.recon"](record) == pytest.approx(40.0)
    assert spans.METRICS["pnp_failed_share.recon"](record) == 25.0
    assert all(f({}) is None for f in spans.METRICS.values())


@pytest.mark.parametrize("cell", ["recon.sintel32", "train.b1"])
def test_tiny_traced_run_with_the_recorder(cell):
    seed = 2**31 + 1234
    c = bench_tiny.cell(cell)
    plain = runner.run(c, seed, 0.2, True, "cpu", time.perf_counter())["result"]
    out = spans.recording_runner(runner.run)(c, seed, 0.2, True, "cpu", time.perf_counter())
    r, record = out["result"], out["record"]
    assert set(r["metrics"]) == set(plain["metrics"]) and r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"} and list(r)[-1] == "check"
    names = spans.CELL_METRICS[c["traffic"]["driver"]]
    assert list(r["span_metrics"]) == names
    # on the CPU no device event is recorded: the device readings are None
    assert record["attribution"] is None
    for m in names:
        assert (r["span_metrics"][m] is None) == (m != "pnp_failed_share.recon"), m
    units = [s for s in record["program_spans"] if s[1] is None]
    assert [s[3] for s in units] == ["unit"] * c["traffic"]["trace_units"]
    table = record["span_table"]
    if cell == "recon.sintel32":
        assert table["reconstruct"]["count"] == 1
        assert table["align_iter"]["count"] == c["config"]["aligner"]["n_iter"]
        assert record["program_counts"]["pnp_frames"] == c["traffic"]["frames"]
    else:
        assert table["build_encode"]["count"] == 5 * c["traffic"]["trace_units"]
        assert {"loss", "backward", "adam", "ema"} <= set(table)


def test_untraced_run_installs_nothing():
    out = spans.recording_runner(runner.run)(bench_tiny.cell("train.b1"), 7, 0.1, False, "cpu",
                                             time.perf_counter())
    assert "span_metrics" not in out["result"] and "span_table" not in out["record"]
