"""The traced run's readings: the benchmark's own spans, the profiler's
device intervals, and what the per-layer readers take from them.

Spans come from the timer the benchmark hands the port (`timer=`). While
the profiler runs, the timer only notes on the host clock when each stage
starts and ends, with no synchronisation, and the profiler records device
activity alone: the host's own recording would stretch the traced units
and show as device idle time. Once the profiled units are done, the timer
is the port's StageTimer, which synchronises the device at each stage
boundary and adds the stage's seconds: the stage metrics come from those
units only. `SPANS` maps the port's stage names to the benchmark's spans,
by prefix.
"""

from __future__ import annotations

import collections
import contextlib
import re
import time

import torch

# the port's stage names (prefix) -> the benchmark span the host is in
SPANS = (
    ("clip", "diffusion"), ("vae_encode", "diffusion"), ("resampler", "diffusion"),
    ("conditioning", "diffusion"), ("ddim_step", "diffusion"), ("decode", "diffusion"),
    ("postprocess", "diffusion"), ("align_init", "align_init"), ("align_pnp", "align_init"),
    ("align_phase", "align_iter"), ("calibrate", "align_iter"), ("build", "build"),
    ("forward_backward", "fwd_bwd"), ("optimizer", "optimizer"),
)
COPY_PREFIXES = ("Memcpy", "Memset")   # the profiler's names of device copies and fills
OUTSIDE = "harness"                     # the label of host time outside every span


def span_of(stage: str) -> str:
    for prefix, span in SPANS:
        if stage.startswith(prefix):
            return span
    return stage


class BenchTimer:
    """`timer=` for the port. Between `trace_spans()` and `end_spans()` it
    notes each stage's host interval (perf_counter ns) under its benchmark
    span and nothing else; otherwise it is the port's StageTimer (seconds
    per stage, device synchronised around each)."""

    def __init__(self, stage_timer):
        self.stages = stage_timer
        self.spans = None

    @property
    def seconds(self):
        return self.stages.seconds

    def trace_spans(self):
        self.spans = []

    def end_spans(self) -> list:
        spans, self.spans = self.spans, None
        return spans

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.spans is None:
            with self.stages(name):
                yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.perf_counter_ns(), span_of(name)))


def clock_offsets() -> dict:
    """perf_counter ns -> each clock the profiler may stamp its events
    with (Unix time or the monotonic clock), read at one instant."""
    p0 = time.perf_counter_ns()
    wall, mono = time.time_ns(), time.monotonic_ns()
    p1 = time.perf_counter_ns()
    mid = (p0 + p1) // 2
    return {"unix": wall - mid, "monotonic": mono - mid}


def kernel_base_name(name: str) -> str:
    """'void (anonymous namespace)::gn_stats_kernel<128>(...)' ->
    'gn_stats_kernel'; a name without a signature stays whole."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    head = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return head.split("::")[-1] or name


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _duration_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _annotation(e) -> bool:
    """A device-side copy of a host range, which spans kernels but is none."""
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def _host_window(dev, host: tuple, offsets: dict):
    """The profiled units' host interval on the profiler's clock: under the
    offset whose mapping holds the device intervals, or None."""
    if not dev:
        return None
    d0, d1 = min(s for s, _ in dev), max(e for _, e in dev)
    for off in offsets.values():
        h0, h1 = host[0] + off, host[1] + off
        # kernels start after their launch and end by the closing sync
        if h0 - 10**9 <= d0 and d1 <= h1 + 10**9:
            return off
    return None


def summarise(prof, host: tuple, spans: list, offsets: dict, top: int = 10) -> dict:
    """Device time by kernel base name, the union of device intervals, and
    the longest idle gaps labelled by the benchmark span the host was in,
    over the profiled units: from the host's start of the first to the
    synchronised end of the last (`host`, perf_counter ns). Where the
    profiler's clock cannot be matched to the host's, the window is the
    first kernel's start to the last one's end and the gaps are labelled
    "unlabelled"."""
    by_name = collections.Counter()
    dev = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or _annotation(e):
            continue
        name = e.name()
        start, dur = _start_ns(e), _duration_ns(e)
        dev.append((start, start + dur))
        kind = next((p for p in COPY_PREFIXES if name.startswith(p)), None)
        by_name[kind or kernel_base_name(name)] += dur * 1e-9
    off = _host_window(dev, host, offsets)
    if off is not None or not dev:
        off = off or 0
        t0_ns, t1_ns = host[0] + off, host[1] + off
        spans = sorted((s + off, e + off, n) for s, e, n in spans)
    else:
        t0_ns, t1_ns = min(s for s, _ in dev), max(e for _, e in dev)
        spans = None
    merged = _merge([(max(s, t0_ns), min(e, t1_ns)) for s, e in dev if e > t0_ns and s < t1_ns])
    busy_ns = sum(e - s for s, e in merged)
    edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(t):
        if spans is None:
            return "unlabelled"
        inner = [n for s, e, n in spans if s <= t < e]
        return inner[-1] if inner else OUTSIDE

    idle = [[label((s + e) // 2), (e - s) * 1e-9] for s, e in gaps[:top]]
    return {
        "device_s_by_name": dict(by_name),
        "busy_s": busy_ns * 1e-9,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "breakdown": {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                      "idle_gaps": idle},
    }
