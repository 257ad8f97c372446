"""Runs one cell of the port's benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It loads the cell's configuration, traffic and limits by the names in
BENCHMARK.json, sets up (weights made on the device from the seed, the
cell's shapes warmed), measures a closed loop for `--seconds`, checks the
sampled output against the benchmark's plain reference, and prints one JSON
line last on standard output. With `--trace 1` the metrics are the cell's
per-layer ones, read from the port's stage timer and kernel counters and
from a profiler trace of the window's first units.

Without a CUDA device, or with fewer than the cell asks for, it exits with
an error and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on time.perf_counter's clock (Linux /proc)."""
    now = time.perf_counter()
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


PROCESS_START = _process_start()
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache of the program and of the libraries under it at a fixed path
# inside the checkout, so that only a checkout's first run builds
CACHE = ROOT / "build" / "benchmark_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness import runner, spec

    cell = spec.cell(spec.benchmark(ROOT), args.workload, ROOT)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", PROCESS_START)
    foreign = runner.foreign_modules()
    if foreign:
        print(f"benchmark: the run loaded {', '.join(foreign)}", file=sys.stderr)
        return 3
    result, record = out["result"], out["record"]
    print(f"setup split {json.dumps(record['setup_split'])}", file=sys.stderr)
    print(f"unit seconds {json.dumps(record['unit_s'])}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
