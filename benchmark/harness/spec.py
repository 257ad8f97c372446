"""Finds a cell's files by the names in BENCHMARK.json.

  configs:   the path in the configuration's `file`
  traffic:   traffic/<traffic>.json (`driver` names drivers/<driver>.py)
  limits:    cells/<cell>.json (the limit of each number `correct` compares)
  metrics:   metrics/<metric>.py, each with `read(record)`
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, root: Path) -> dict:
    """Everything one cell needs: its entry, configuration, traffic, limits
    and the metrics it reports with --trace 0 and with --trace 1."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH_DIR / "cells" / f"{name}.json")["limits"]

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"entry": entry, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": reported(bench["end_to_end"]), "per_layer": reported(bench["per_layer"])}


def driver(traffic: dict):
    return importlib.import_module(f"drivers.{traffic['driver']}").Driver


def reader(metric: str):
    """The `read(record)` of metrics/<metric>.py (names may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"metrics_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
