"""Nothing a run imports has the top-level name jax, jaxlib, flax or
geo4d_tpu (compared whole), and the reference imports nothing of the port."""

import subprocess
import sys

import bench_paths  # noqa: F401
from bench_paths import BENCH_DIR, ROOT

BLOCK = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path[:0] = [{tests!r}, {bench!r}, {root!r}]
"""


def _run(blocked, body):
    code = f"BLOCKED = {blocked!r}\n" + BLOCK.format(
        tests=str(BENCH_DIR / "tests"), bench=str(BENCH_DIR), root=str(ROOT)) + body
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax_and_no_jax_package():
    out = _run(("jax", "jaxlib", "flax", "geo4d_tpu"), """
import time
import bench_tiny
from harness import runner
for cell in ("recon.sintel32", "train.b1"):
    r = runner.run(bench_tiny.cell(cell), 11, 0.1, True, "cpu", time.perf_counter())
    assert r["result"]["correct"], r["result"]["check"]
print(runner.foreign_modules())
""")
    assert out.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    _run(("jax", "jaxlib", "flax", "geo4d_tpu", "geo4d_tpu_torch"), """
import pkgutil, importlib
import geo4d_ref
for m in pkgutil.walk_packages(geo4d_ref.__path__, "geo4d_ref."):
    importlib.import_module(m.name)
from harness import compare, flops, models, roofline, scene
flops.reconstruct_flops  # the FLOP count builds the reference only
""")
