"""The numbers that decide `correct`, and the reference's control.

Every number is a gap between what the program produced and what the
reference computes, with a limit of its own (`cells/<cell>.json`); a run is
correct when every number is at most its limit. The control is the
reference put in the program's place one precision lower than the
configuration states: fp8 (e4m3, one scale a tensor) for the bf16 model.
"""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

FP8_MAX = 448.0
FP8_PRODUCTS = (F.linear, F.conv2d)


def rel_gap(got, want) -> float:
    """||got - want|| / ||want|| over the whole array, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def median_row_gap(got, want) -> float:
    """The median over the first axis (frames, cameras) of each row's
    relative L2 gap, in float64."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    gaps = np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-30)
    return float(np.median(gaps))


def leaf_norm_gaps(got: dict, want: dict, names) -> list:
    """Each named leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's (some gradients are all but zero)."""
    median = statistics.median(want[n] for n in names)
    return [abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names]


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a missing or non-finite number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = bool(value is not None and np.isfinite(value) and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale for the tensor; the gradient passes
    straight through the rounding."""
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach()


class _FP8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in FP8_PRODUCTS:
            args = (_fake_fp8(args[0]), _fake_fp8(args[1])) + tuple(args[2:])
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fp8():
    """Inside the block every linear layer and convolution multiplies fp8
    operands: its input and its weight rounded to e4m3, one scale a tensor
    (the control of a bf16 configuration)."""
    with _FP8():
        yield


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block (a warning where
    an operation has none): the backward of `index_select` sums in a fixed
    order, where by default it adds atomically in whatever order the device
    takes."""
    old = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old)


@contextlib.contextmanager
def tf32(on: bool):
    """Float32 matrix products and convolutions inside the block in TF32
    with `on` (the control of a float32 stage), else in full float32 (the
    reference's precision), for cuBLAS and cuDNN."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
