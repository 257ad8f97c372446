"""Per-stage wall times for the pipeline's optional `timer=` argument."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class StageTimer:
    """Wall time per named stage, synchronising the device around each one.
    Pass it as `timer=`; times accumulate in `seconds`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def stage(timer, name: str):
    """`timer(name)` when a timer is given, else a no-op context."""
    return timer(name) if timer is not None else contextlib.nullcontext()
