"""YAML `target:`/`params:` trees instantiated through a registry, the port's
copy of geo4d_tpu/core/config.py's `Registry`, `instantiate` and
`load_config`. A node is `{target: <name>, params: {...}}`; targets resolve
through an explicit name -> constructor map, never through imports, so a
config cannot run code it names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import yaml


class Registry:
    """Name -> constructor map with aliases."""

    def __init__(self):
        self._ctors: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, *aliases: str):
        def deco(fn):
            for key in (name, *aliases):
                if key in self._ctors:
                    raise KeyError(f"duplicate registry key {key!r}")
                self._ctors[key] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._ctors:
            raise KeyError(f"unknown target {name!r}; known: {sorted(self._ctors)}")
        return self._ctors[name]

    def __contains__(self, name: str) -> bool:
        return name in self._ctors


def instantiate(node: Any, registry: Registry, **overrides):
    """Build a `{target, params}` node; `overrides` join its params."""
    if not isinstance(node, dict) or "target" not in node:
        raise ValueError(f"not an instantiable config node: {node!r}")
    params = dict(node.get("params") or {})
    params.update(overrides)
    return registry.get(node["target"])(**params)


def load_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)
