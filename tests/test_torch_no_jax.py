"""The PyTorch port never imports JAX: a fresh interpreter imports the
port's runtime path (pipeline, presets), runs a tiny UNet3D forward and
finds neither JAX nor any module of the JAX package loaded; it then imports
every module of the port (the weights bridge shares the numpy-only
geo4d_tpu.models.convert) and still finds no `jax` or `flax`."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import pkgutil, importlib, sys
import torch

def loaded(*roots):
    return sorted(m for m in sys.modules if m.split(".")[0] in roots)

import geo4d_tpu_torch.pipeline.inference
from geo4d_tpu_torch.models.presets import tiny
torch.manual_seed(0)
unet = tiny(temporal_length=4).unet
with torch.no_grad():
    out = unet(torch.randn(1, 4, 4, 8, 20), torch.tensor([500]),
               torch.randn(1, 77 + 4 * 16, 64), torch.tensor([24]))
assert out.shape == (1, 4, 4, 8, 16) and torch.isfinite(out).all()
assert not loaded("jax", "jaxlib", "flax", "geo4d_tpu"), loaded("jax", "flax", "geo4d_tpu")
import geo4d_tpu_torch
for mod in pkgutil.walk_packages(geo4d_tpu_torch.__path__, "geo4d_tpu_torch."):
    importlib.import_module(mod.name)
assert not loaded("jax", "jaxlib", "flax"), loaded("jax", "jaxlib", "flax")
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
