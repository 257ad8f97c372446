"""One run of one cell: set-up, the measured window, the check, the
result line.

The window is a closed loop with one client: the next unit of work starts
when the last one ends, and the unit in flight when `seconds` have passed
runs to its end and is counted, so the window's rates are all of its work
over all of its time. With `trace`, the profiler records the device's
activity over the window's first `trace_units` units (the traffic file's),
while the timer notes the host's spans; the port's StageTimer then times
every stage of the units after them, of which there is at least one.
"""

from __future__ import annotations

import collections
import sys
import time

import torch

from harness import compare, spec, trace

FOREIGN_ROOTS = ("jax", "jaxlib", "flax", "geo4d_tpu")


def foreign_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN_ROOTS))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_stats():
    from geo4d_tpu_torch.ops import flash_attention, group_norm, temporal_attention

    return {"group_norm": group_norm.stats, "flash_attention": flash_attention.stats,
            "temporal_attention": temporal_attention.stats}


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        process_start: float) -> dict:
    """Runs the cell once; returns the result line's fields and the record
    the per-layer readers read."""
    device = torch.device(device)
    traffic = cell["traffic"]
    split = {"start_s": time.perf_counter() - process_start}
    if device.type == "cuda":
        from geo4d_tpu_torch.ops import dispatch

        torch.cuda.init()
        split["cuda_init_s"] = time.perf_counter() - process_start - sum(split.values())
        dispatch.kernels()      # built in the checkout's build/ at its first run
        split["kernel_library_s"] = time.perf_counter() - process_start - sum(split.values())
    d = spec.driver(traffic)(cell["config"], traffic, seed, device)
    d.setup()
    _sync(device)
    record = {"setup_s": time.perf_counter() - process_start}
    split.update(d.setup_split)
    record["setup_split"] = split

    from geo4d_tpu_torch.core.timing import StageTimer

    timer = trace.BenchTimer(StageTimer(device)) if traced else None
    stats = _kernel_stats()
    trace_units = traffic["trace_units"] if traced else 0
    # a traced run also runs a unit after the profiled ones, for the stage
    # times and rates beside the trace
    min_units = trace_units + 1 if traced else 1
    work = collections.Counter()
    summary, prof, host, spans, offsets = None, None, None, None, None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    t_untraced, work_traced = t0, collections.Counter()
    unit_s = []
    while True:
        t_unit = time.perf_counter()
        if trace_units and not work["units"]:
            for s in stats.values():
                s.reset()
            prof = torch.profiler.profile(activities=_activities(device))
            prof.__enter__()
            timer.trace_spans()
            offsets = trace.clock_offsets()
            host = [time.perf_counter_ns()]
        work.update(d.run_unit(timer))
        work["units"] += 1
        unit_s.append(time.perf_counter() - t_unit)
        if trace_units and work["units"] == trace_units:
            _sync(device)
            host.append(time.perf_counter_ns())
            spans = timer.end_spans()
            prof.__exit__(None, None, None)
            record["launches"] = {k: dict(s.by_shape) for k, s in stats.items()}
            record["backward_launches"] = {k: dict(s.backward_by_shape) for k, s in stats.items()}
            t_untraced, work_traced = time.perf_counter(), collections.Counter(work)
        if time.perf_counter() - t0 >= seconds and work["units"] >= min_units:
            break
    _sync(device)
    t1 = time.perf_counter()
    record.update(window_wall_s=t1 - t0, work=dict(work), unit_s=unit_s)
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    if traced:
        summary = trace.summarise(prof, tuple(host), spans, offsets)
        untraced = {k: work[k] - work_traced[k] for k in work}
        # the stage seconds are the units' after the profiled ones
        record.update(summary, stages=dict(timer.seconds), stage_work=untraced,
                      untraced_wall_s=t1 - t_untraced, untraced_work=untraced,
                      flops_per_work=d.flops_per_work())
    d.release()
    numbers, compared = d.check()
    correct, check = compare.judge(numbers, cell["limits"])
    metrics = {}
    for m in cell["per_layer" if traced else "end_to_end"]:
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": work["units"],
              "failed": 0 if correct else compared, "metrics": metrics,
              "device": _device(device, cell["entry"]["chips"], record, summary)}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["check"] = check
    return {"result": result, "record": record}


def _activities(device):
    """The device's activity alone: recording the host's operations would
    slow the profiled units (on the CPU, which has no device activity, the
    host's)."""
    if device.type == "cuda":
        return [torch.profiler.ProfilerActivity.CUDA]
    return [torch.profiler.ProfilerActivity.CPU]


def _device(device, chips: int, record: dict, summary) -> dict:
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": record["memory_peak_bytes"]}
    if summary is not None:
        out.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    return out

