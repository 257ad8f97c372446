"""The program's own spans joined to the profiler's device trace, for a
traced run with the port's span recorder installed.

The recorder (`geo4d_tpu_torch.core.timing.SpanRecorder`) notes each span's
host interval on time.perf_counter_ns and never synchronises. With CUDA
activity on, the profiler records each kernel, copy and fill on the device
and, on the host, the runtime or driver call that launched it
(cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...) under the same
correlation id. So:

- each device event is put down to the innermost span open when its launch
  call started, the host's clock mapped onto the profiler's by the offset
  `trace._host_window` chooses;
- each idle gap of the device to the innermost span open at its midpoint
  (`idle_by_span`; "harness" outside every span);
- a name's `idle_ms` is the idle time inside the host intervals of its
  spans, exactly.

`recording_runner(runner.run)` runs a cell as `runner.run` does, with the
recorder installed over the profiled units only and each unit one request,
"unit"; `benchmark/run_spans.py` is its command.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import sys

import torch

from harness import spec, trace

OUTSIDE = trace.OUTSIDE          # host time outside every span
LAUNCH_PREFIXES = ("cuda", "cu")  # runtime and driver API calls
ALIGN_PHASES = ("align_phase1", "calibrate", "align_phase2")


def trace_events(prof) -> tuple:
    """(device, launches): (start_ns, duration_ns, correlation id) of each
    kernel, copy and fill on the device, and correlation id -> start of the
    host call that launched it, both on the profiler's clock."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not trace._annotation(e):
                device.append((trace._start_ns(e), trace._duration_ns(e), e.correlation_id()))
        elif e.name().startswith(LAUNCH_PREFIXES):
            launches.setdefault(e.correlation_id(), trace._start_ns(e))
    return device, launches


def _segments(spans: list, t0: int, t1: int) -> list:
    """[(start, end, span id or None)] covering [t0, t1): the innermost span
    open in each piece. `spans` are (id, start, end) on one clock."""
    marks = []
    for sid, s, e in spans:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            marks.append((s, 1, -e, sid))
            marks.append((e, 0, 0, sid))
    marks.sort()
    segs, stack, closed, prev = [], [], set(), t0
    for t, opens, _, sid in marks + [(t1, 0, 0, None)]:
        if t > prev:
            while stack and stack[-1] in closed:
                stack.pop()
            segs.append((prev, t, stack[-1] if stack else None))
            prev = t
        if opens:
            stack.append(sid)
        else:
            closed.add(sid)
    return segs


def _innermost(segs: list, starts: list, t: int):
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if 0 <= i and t < segs[i][1] else None


def _gaps(dev: list, t0: int, t1: int) -> list:
    merged = trace._merge([(max(s, t0), min(s + d, t1)) for s, d, _ in dev
                           if s + d > t0 and s < t1])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def join(spans: list, dev: list, launches: dict, host: tuple, offsets: dict) -> dict:
    """The span table of a traced window.

    spans: [id, parent, request, name, start_ns, end_ns] (perf_counter ns;
    end None while open); dev, launches: `trace_events`;
    host: the window's (start, end) in perf_counter ns; offsets:
    `trace.clock_offsets()`.

    Returns `span_table` (name -> count, host_ms and self_ms, and, where the
    device's events could be put down, device_ms and launches launched in
    the name's spans, their children's included, and idle_ms inside them),
    `idle_by_span` and `attribution` (device ms in all, in a request, in no
    span, unlaunched; None where there is no device event or no clock
    offset)."""
    off = trace._host_window([(s, s + d) for s, d, _ in dev], host, offsets)
    on_device = bool(dev) and off is not None
    off = off or 0
    t0, t1 = host[0] + off, host[1] + off
    by_id = {s[0]: s for s in spans}
    segs = _segments([(s[0], s[4] + off, (host[1] if s[5] is None else s[5]) + off)
                      for s in spans], t0, t1)
    starts = [a for a, _, _ in segs]

    chains = {}

    def chain(sid):
        """The names of the span and of its ancestors, each once."""
        if sid not in chains:
            s = by_id[sid]
            chains[sid] = {s[3]} | (chain(s[1]) if s[1] in by_id else set())
        return chains[sid]

    host_ns, idle_ns, dev_ns, n_launch = {}, {}, {}, {}
    for a, b, sid in segs:
        host_ns[sid] = host_ns.get(sid, 0) + b - a
    idle_by, attribution = {}, None
    if on_device:
        unlaunched = 0
        for start, dur, corr in dev:
            t = launches.get(corr)
            if t is None:
                unlaunched += dur
                continue
            sid = _innermost(segs, starts, t)
            dev_ns[sid] = dev_ns.get(sid, 0) + dur
            n_launch[sid] = n_launch.get(sid, 0) + 1
        gaps = _gaps(dev, t0, t1)
        for a, b in gaps:
            sid = _innermost(segs, starts, (a + b) // 2)
            name = OUTSIDE if sid is None else by_id[sid][3]
            idle_by[name] = idle_by.get(name, 0.0) + (b - a) * 1e-6
        j = 0                       # exact overlap of the gaps with each piece
        for a, b, sid in segs:
            while j < len(gaps) and gaps[j][1] <= a:
                j += 1
            k, over = j, 0
            while k < len(gaps) and gaps[k][0] < b:
                over += min(b, gaps[k][1]) - max(a, gaps[k][0])
                k += 1
            idle_ns[sid] = idle_ns.get(sid, 0) + over
        total = sum(d for _, d, _ in dev)
        in_request = sum(v for sid, v in dev_ns.items()
                         if sid is not None and by_id[sid][2] is not None)
        attribution = {"device_ms": total * 1e-6, "in_request_ms": in_request * 1e-6,
                       "outside_ms": dev_ns.get(None, 0) * 1e-6,
                       "unlaunched_ms": unlaunched * 1e-6,
                       "in_request_share": in_request / total if total else None}

    table = {}
    for s in spans:
        row = table.setdefault(s[3], {"count": 0, "host_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
    for name, row in table.items():
        ids = [sid for sid in host_ns if sid is not None and name in chain(sid)]
        row["host_ms"] = sum(host_ns[i] for i in ids) * 1e-6
        row["self_ms"] = sum(host_ns[i] for i in ids if by_id[i][3] == name) * 1e-6
        if on_device:
            row["device_ms"] = sum(dev_ns.get(i, 0) for i in ids) * 1e-6
            row["launches"] = sum(n_launch.get(i, 0) for i in ids)
            row["idle_ms"] = sum(idle_ns.get(i, 0) for i in ids) * 1e-6
    outside = {"count": 0, "host_ms": host_ns.get(None, 0) * 1e-6,
               "self_ms": host_ns.get(None, 0) * 1e-6}
    if on_device:
        outside.update(device_ms=dev_ns.get(None, 0) * 1e-6, launches=n_launch.get(None, 0),
                       idle_ms=idle_ns.get(None, 0) * 1e-6)
    table[OUTSIDE] = outside
    return {"span_table": table, "idle_by_span": idle_by if on_device else None,
            "attribution": attribution}


# ---------------- the readings of the span table ----------------

def _row(record: dict, name: str, key: str):
    row = (record.get("span_table") or {}).get(name)
    return None if row is None else row.get(key)


def _units(record: dict) -> int:
    """The profiled units: the requests the recorder opened."""
    return sum(1 for s in record.get("program_spans", ()) if s[1] is None and s[2] is not None)


def _per_span(record: dict, name: str, key: str, scale: float = 1.0):
    v, n = _row(record, name, key), _row(record, name, "count")
    return None if v is None or not n else scale * v / n


def _per_unit(record: dict, name: str, key: str):
    v, n = _row(record, name, key), _units(record)
    return None if v is None or not n else v / n


def _idle_share(record: dict, names):
    idle = [_row(record, n, "idle_ms") for n in names]
    host = [_row(record, n, "host_ms") for n in names]
    pairs = [(i, h) for i, h in zip(idle, host) if i is not None and h is not None]
    total = sum(h for _, h in pairs)
    return 100.0 * sum(i for i, _ in pairs) / total if pairs and total else None


def pnp_failed_share(record: dict):
    counts = record.get("program_counts") or {}
    return (100.0 * counts.get("pnp_failed", 0) / counts["pnp_frames"]
            if counts.get("pnp_frames") else None)


# metric -> reader of the record; device readings are None without device events
METRICS = {
    "align_launches_per_iter.recon": lambda r: _per_span(r, "align_iter", "launches"),
    "align_device_ms_per_iter.recon": lambda r: _per_span(r, "align_iter", "device_ms"),
    "align_idle.recon": lambda r: _idle_share(r, ALIGN_PHASES),
    "pnp_failed_share.recon": pnp_failed_share,
    "build_device_ms.train": lambda r: _per_unit(r, "build", "device_ms"),
    "fwd_bwd_device_ms.train": lambda r: _per_unit(r, "forward_backward", "device_ms"),
    "fwd_bwd_idle.train": lambda r: _idle_share(r, ("forward_backward",)),
}
CELL_METRICS = {"reconstruct": [m for m in METRICS if m.endswith(".recon")],
                "train": [m for m in METRICS if m.endswith(".train")]}


# ---------------- a traced run with the recorder installed ----------------

@contextlib.contextmanager
def _patched(module, name: str, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def recording_runner(run):
    """`runner.run` with, in a traced run, the port's span recorder
    installed from the profiler's start to its end, each unit in
    `request("unit")`, the join added to the record (`program_spans`,
    `program_counts`, `span_table`, `idle_by_span`, `attribution`), the
    cell's readings added to the result line under `span_metrics`, and the
    span table, the idle time by span and the attribution printed to
    standard error. An untraced run is `run` itself."""

    def recorded(cell, seed, seconds, traced, device, process_start):
        if not traced:
            return run(cell, seed, seconds, traced, device, process_start)
        from geo4d_tpu_torch.core import timing

        rec = timing.SpanRecorder()
        scope = timing.recording(rec)
        bench_timer, summarise, driver = trace.BenchTimer, trace.summarise, spec.driver

        class Timer(bench_timer):
            def trace_spans(self):
                super().trace_spans()
                scope.__enter__()

            def end_spans(self):
                scope.__exit__(None, None, None)
                return super().end_spans()

        def summarise_joined(prof, host, bench_spans, offsets, top=10):
            out = summarise(prof, host, bench_spans, offsets, top)
            program = [[s.id, s.parent, s.request, s.name, s.start_ns, s.end_ns]
                       for s in rec.spans]
            out.update(join(program, *trace_events(prof), host, offsets),
                       program_spans=program, program_counts=rec.totals())
            return out

        def unit_requests(traffic):
            base = driver(traffic)

            class Driver(base):
                def run_unit(self, timer):
                    with timing.request("unit"):
                        return super().run_unit(timer)
            return Driver

        with _patched(trace, "BenchTimer", Timer), \
                _patched(trace, "summarise", summarise_joined), \
                _patched(spec, "driver", unit_requests):
            out = run(cell, seed, seconds, traced, device, process_start)
        record, result = out["record"], out["result"]
        names = CELL_METRICS[cell["traffic"]["driver"]]
        result["span_metrics"] = {m: METRICS[m](record) for m in names}
        result["check"] = result.pop("check")
        for label, key in (("span table", "span_table"), ("idle by span", "idle_by_span"),
                           ("span attribution", "attribution")):
            print(f"{label} {json.dumps(record.get(key))}", file=sys.stderr)
        return out

    return recorded
