"""Training observability: metric logging and device stats, port of
geo4d_tpu/training/callbacks.py (the reference's main/callbacks.py
`CUDACallback`: epoch wall time and peak device memory). The JAX package's
`SampleLogger` writes mp4 grids through OpenCV, which the port does not
use; it is not ported yet."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricLogger:
    """Append-only JSONL metrics (`<log_dir>/metrics.jsonl`) + optional
    console echo every `echo_every` steps. Across ranks only rank 0 writes
    (the metrics are the global batch's on every rank)."""

    def __init__(self, log_dir: str, echo_every: int = 50, rank: int = 0):
        self.rank = rank
        if rank == 0:
            os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.echo_every = echo_every
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]):
        if self.rank != 0:
            return
        row = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            row[k] = float(v) if hasattr(v, "__float__") else v
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.echo_every and step % self.echo_every == 0:
            print(f"[train] step {step}: " + " ".join(
                f"{k}={row[k]:.5g}" if isinstance(row[k], float) else f"{k}={row[k]}"
                for k in metrics))


def device_memory_stats() -> Dict[str, float]:
    """Live and peak bytes allocated by PyTorch on each CUDA device
    (`memory_allocated`, `max_memory_allocated`); empty without CUDA."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"dev{i}_bytes_in_use"] = torch.cuda.memory_allocated(i)
            out[f"dev{i}_peak_bytes"] = torch.cuda.max_memory_allocated(i)
    return out


class EpochTimer:
    """Epoch wall time + throughput (CUDACallback parity); `step` takes the
    samples of a step (the global batch across ranks)."""

    def __init__(self):
        self._start: Optional[float] = None
        self._samples = 0

    def start(self):
        self._start = time.time()
        self._samples = 0

    def step(self, batch_size: int):
        self._samples += batch_size

    def finish(self) -> Dict[str, float]:
        dt = time.time() - (self._start or time.time())
        return {
            "epoch_seconds": dt,
            "samples_per_sec": self._samples / dt if dt > 0 else 0.0,
            **device_memory_stats(),
        }
