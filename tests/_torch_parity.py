"""Helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Weights and inputs are made with numpy from a seed and handed to both the
JAX package and the port; outputs come back as numpy arrays.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Tuple

import jax
import numpy as np
import torch

from geo4d_tpu.models.convert import (
    clip_text_torch_key,
    clip_vision_torch_key,
    inverse_transform,
    resampler_torch_key,
    unet_torch_key,
    vae_torch_key,
)
from geo4d_tpu_torch.models.convert import TOWER_MODULES

# weights bridge: the JAX package's key rules name each leaf's PyTorch key
KEY_FNS = {
    "unet": unet_torch_key,
    "vae": vae_torch_key,
    "pointmap_vae": vae_torch_key,
    "clip_text": clip_text_torch_key,
    "clip_img": clip_vision_torch_key,
    "resampler": resampler_torch_key,
}


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


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[List[str], Any]]:
    if isinstance(tree, Mapping):
        out = []
        for k, v in tree.items():
            out.extend(_leaves(v, path + (str(k),)))
        return out
    return [(list(path), tree)]


def torch_key(key_fn, path: List[str]) -> str | None:
    """The PyTorch key of a JAX leaf. The relative-position tables of a
    temporal attention (`<attn>/relative_position_{k,v}/embeddings_table`),
    which the JAX package's key rules do not name, keep the original Geo4D
    name `<attn>.relative_position_{k,v}.embeddings_table`."""
    if path[-1] != "embeddings_table":
        return key_fn(path)
    attn = key_fn(path[:-2] + ["to_q", "kernel"])
    if attn is None:
        return None
    return attn[:-len("to_q.weight")] + f"{path[-2]}.embeddings_table"


def state_dict_from_jax(params: Any, tower: str) -> Dict[str, torch.Tensor]:
    """One tower's JAX param tree ({'params': ...}) -> the state dict of the
    port's matching module, each array in PyTorch's layout. Raises on a leaf
    with no mapping rule."""
    key_fn = KEY_FNS[tower]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        key = torch_key(key_fn, path)
        if key is None:
            raise KeyError(f"{tower}: no torch key for {'/'.join(path)}")
        arr = inverse_transform(path[-1], np.asarray(leaf, dtype=np.float32))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_from_jax(model: torch.nn.Module, params: Dict[str, Any]) -> None:
    """Load every tower present in a JAX `init_params`-style dict into a
    port GeoDiffusion, strictly."""
    for tower, attr in TOWER_MODULES.items():
        module = getattr(model, attr)
        if tower in params and module is not None:
            module.load_state_dict(state_dict_from_jax(params[tower], tower), strict=True)


def sub_state_dict(params: Any, jax_prefix: List[str], torch_prefix: str) -> Dict[str, torch.Tensor]:
    """State dict of a UNet submodule: its JAX paths are mapped as if they
    sat under `jax_prefix` in the UNet, and `torch_prefix` is stripped."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        key = torch_key(unet_torch_key, ["params"] + jax_prefix + path[1:])
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


def aligner_state_from_jax(jax_aligner) -> Dict[str, Any]:
    """A JAX GroupAligner's state as numpy, cut to its real G windows and N
    frames (the JAX aligner pads both for compile reuse): every parameter,
    the two phase-2 window gates and the focal freeze."""
    G, N = jax_aligner.G, jax_aligner.N
    rows = {"log_depth": N, "poses": N, "pw_poses": G, "traj_align": G, "s_depth": G,
            "t_depth": G, "focal": 1 if jax_aligner.cfg.shared_focal else N}
    state = {k: np.asarray(jax_aligner.params[k])[:n] for k, n in rows.items()}
    state["valid_depth_group"] = np.asarray(jax_aligner.valid_depth_group)[:G]
    state["valid_traj_group"] = np.asarray(jax_aligner.valid_traj_group)[:G]
    state["focal_frozen"] = bool(jax_aligner.focal_frozen)
    return state


def load_aligner_state(port_aligner, state: Dict[str, Any]) -> None:
    """Write `aligner_state_from_jax` output into a port GroupAligner."""
    with torch.no_grad():
        for k, p in port_aligner.params.items():
            p.copy_(torch.from_numpy(np.asarray(state[k], np.float32)))
    dev = port_aligner.device
    port_aligner.valid_depth_group = torch.as_tensor(state["valid_depth_group"], device=dev).float()
    port_aligner.valid_traj_group = torch.as_tensor(state["valid_traj_group"], device=dev).float()
    port_aligner.params["focal"].requires_grad_(not state["focal_frozen"])


def rel_err(got, want) -> float:
    """Relative L2 error ||got - want|| / ||want||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def kernel_jobs(plan, jobs: int) -> list:
    """The jobs each warp of each block takes, as csrc/temporal_attention.cu
    splits them for K3 and K3b: block b the range [b * jobs // grid,
    (b + 1) * jobs // grid), warp w every warps-th job of it from the w-th."""
    taken = []
    for b in range(plan.grid):
        start, end = b * jobs // plan.grid, (b + 1) * jobs // plan.grid
        assert end - start <= plan.jobs_per_block
        for w in range(plan.warps):
            taken += range(start + w, end, plan.warps)
    return taken


def cuda_or_skip() -> torch.device:
    """Decide inside a test whether there is a card (never at import)."""
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")

