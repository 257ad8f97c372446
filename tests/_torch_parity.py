"""Helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Weights and inputs are made with numpy from a seed and handed to both the
JAX package and the port; outputs come back as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import numpy as np
import torch

from geo4d_tpu.models.convert import inverse_transform, unet_torch_key


def randomize(params: Any, seed: int) -> Any:
    """Replace every leaf of a flax param tree with seeded random values of
    a scale that keeps activations O(1): kernels ~ N(0, 1/fan_in), norm
    scales ~ 1 + N(0, 0.1^2), biases and embeddings ~ N(0, 0.1^2). (The JAX
    init zero-inits the residual tails, which would make most outputs
    trivially equal.)"""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.1, shape)).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)

    return walk(params, "")


def jax_init(module, *args, method=None, seed: int = 0, **static) -> Dict[str, Any]:
    """Jitted init; `static` keyword arguments are closed over, not traced."""
    init = jax.jit(lambda k, *a: module.init(k, *a, method=method, **static))
    return randomize(init(jax.random.PRNGKey(seed), *args), seed)


def jax_apply(module, params, *args, method=None, **static) -> np.ndarray:
    out = jax.jit(lambda p, *a: module.apply(p, *a, method=method, **static))(params, *args)
    return jax.tree_util.tree_map(np.asarray, out)


def sub_state_dict(params: Any, jax_prefix: List[str], torch_prefix: str) -> Dict[str, torch.Tensor]:
    """State dict of a UNet submodule: its JAX paths are mapped as if they
    sat under `jax_prefix` in the UNet, and `torch_prefix` is stripped."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        key = unet_torch_key(["params"] + jax_prefix + path[1:])
        assert key is not None and key.startswith(torch_prefix), (path, key)
        arr = inverse_transform(path[-1], np.asarray(node, np.float32))
        out[key[len(torch_prefix):]] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, [])
    return out


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_close(got: torch.Tensor | np.ndarray, want: np.ndarray, atol: float,
                 rtol: float = 0.0, what: str = "") -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bound = atol + rtol * np.abs(want.astype(np.float64))
    worst = float((err - bound).max()) if err.size else 0.0
    assert worst <= 0.0, (
        f"{what}: max abs err {float(err.max()):.3e} exceeds atol {atol:g} + rtol {rtol:g}")


def cuda_or_skip() -> torch.device:
    """Decide inside a test whether there is a card (never at import)."""
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")

