"""Static kernel gate and the build/loader for the CUDA sources in csrc/.

Every kernel wrapper in this package asks `use_kernel(x)` before it runs:

  * a tensor on the CPU takes the kernel's plain PyTorch version (the CPU
    tests run this way);
  * a tensor on a CUDA device takes the kernel; the wrapper then checks
    dtype, shape and contiguity and raises on anything the kernel does not
    take;
  * any other device raises.

Nothing falls back: a failed build or a refused launch raises.

The sources in csrc/ have a plain C interface. At first use each is
compiled with nvcc for sm_90a, all at once in parallel processes, and the
objects are linked into one shared library under build/geo4d_tpu_torch/
(named by a hash of the sources and flags, so an edited source rebuilds),
which is loaded with ctypes.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "geo4d_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

SM_COUNT = 132           # H100 SXM; the wrappers plan with the card's own count
SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may use on Hopper

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argument types. Every function returns the
# cudaError_t of its launch (0 = launched).
_SIGNATURES = {
    "gn_stats": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gn_apply": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "gn_resident": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "gn_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                    _I, _P],
    "flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                            _P],
    "temporal_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "temporal_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                               _P],
    "align_objective": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P],
}


class KernelStats:
    """Per-kernel counters: `launches` counts forward-kernel launches made by
    the wrapper and `by_shape` the same launches keyed by the kernel's shape
    tuple; `backward_launches` and `backward_by_shape` count the backward
    kernel's launches the same way; `plain_on_cuda` counts calls of a plain
    version (forward or backward) with a CUDA tensor (only a comparison
    against the kernel does that). Every instance is listed in `registry`,
    so that a CUDA graph's capture and replays (ops/graphs.py) can charge
    launches that no wrapper call makes."""

    registry: list = []

    def __init__(self):
        self.by_shape: collections.Counter = collections.Counter()
        self.backward_by_shape: collections.Counter = collections.Counter()
        self.reset()
        KernelStats.registry.append(self)

    def reset(self) -> None:
        self.restore((0, {}, 0, {}))
        self.plain_on_cuda = 0

    def note_launch(self, shape: tuple) -> None:
        self.launches += 1
        self.by_shape[shape] += 1

    def note_backward(self, shape: tuple) -> None:
        self.backward_launches += 1
        self.backward_by_shape[shape] += 1

    def note_plain(self, x: torch.Tensor) -> None:
        if x.is_cuda:
            self.plain_on_cuda += 1

    def snapshot(self) -> tuple:
        """The launch counters as they stand: (launches, by_shape,
        backward_launches, backward_by_shape)."""
        return (self.launches, collections.Counter(self.by_shape), self.backward_launches,
                collections.Counter(self.backward_by_shape))

    def restore(self, counts: tuple) -> None:
        """Sets the launch counters to a `snapshot`."""
        self.launches = self.backward_launches = 0
        self.by_shape.clear()
        self.backward_by_shape.clear()
        self.add(counts)

    def add(self, counts: tuple) -> None:
        """Adds launches counted as a `snapshot` counts them."""
        self.launches += counts[0]
        self.by_shape.update(counts[1])
        self.backward_launches += counts[2]
        self.backward_by_shape.update(counts[3])


def use_kernel(x: torch.Tensor) -> bool:
    """True when `x` must go through the hand-written kernel (CUDA), False
    when it takes the plain version (CPU). Raises for other devices."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel route for device {x.device}")


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd records this call: grad mode is on and an input
    requires a gradient. Otherwise a wrapper runs its forward alone and
    saves nothing for a backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require(cond: bool, what: str) -> None:
    """Raise on an input the kernel does not take (no silent fallback)."""
    if not cond:
        raise ValueError(f"kernel input rejected: {what}")


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError {err}")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgeo4d_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands in parallel processes; raise with the failures'
    output once all have ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu (one nvcc process per source, all started at once)
    and link the shared library, unless a library built from the same
    sources and flags exists. Raises if nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        cu = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(objdir, s.stem + ".o") for s in cu]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", o, str(s)]
                  for s, o in zip(cu, objs)])
        tmp = os.path.join(objdir, out.name)
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_handle(x: torch.Tensor) -> int:
    """The raw handle of the current stream on x's device (an int; no Stream
    object is built, which costs microseconds per launch)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)
