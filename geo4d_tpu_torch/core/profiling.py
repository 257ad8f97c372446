"""Device traces, port of geo4d_tpu/core/profiling.py's `trace` (the JAX
package wraps jax.profiler; here torch.profiler). Per-stage wall times are
`core/timing.py`'s StageTimer."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work (the host, and the CUDA device where there
    is one) and write a Chrome trace `<log_dir>/trace.json` (open it in
    chrome://tracing or Perfetto). Yields the profiler, for
    `key_averages()`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
