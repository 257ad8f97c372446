"""Process mesh and sharding rules in torch.distributed terms, the port's
counterpart of geo4d_tpu/parallel/mesh.py.

The JAX package runs one controller over a `jax.sharding.Mesh`: the batch
(training) or the windows (inference) shard over the mesh's 'data' axis and
XLA inserts the collectives. Here every rank is a process that holds one
device, and the port calls the collectives itself:

  * `init_distributed` joins (or starts) the process group and returns a
    `Mesh` (world size, rank, device, backend);
  * `rank_rows` gives the rows of a batch or of a chunk of windows that a
    rank owns (JAX's `shard_batch` / `shard_windows`);
  * `fsdp_shard_dim` is `shard_params_fsdp`'s rule for one parameter;
  * the `Mesh` methods are the collectives the port uses, on flat buffers.

Backends: NCCL for CUDA tensors, gloo for CPU tensors, and gloo for CUDA
tensors when asked (several ranks sharing one card, which NCCL refuses).
Both take the tensors where they lie: gloo copies CUDA tensors through the
host itself.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# newer torch releases rename the tensor collectives (`*_single`) and warn on
# the old names, which every supported release still has
warnings.filterwarnings("ignore", message=r".*torch\.distributed\.\w+` is deprecated",
                        category=FutureWarning)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a one-axis ('data') process mesh."""

    world_size: int
    rank: int
    device: torch.device
    backend: str

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def all_gather_into(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """out (world * n, ...) = the ranks' `t` (n, ...), in rank order."""
        dist.all_gather_into_tensor(out, t)
        return out

    def reduce_scatter_sum(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """out (n, ...) = this rank's block of the sum over the ranks of
        `t` (world * n, ...)."""
        dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM)
        return out

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped `t` (n, ...) stacked in rank order:
        (world * n, ...). Booleans travel as uint8."""
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        out = torch.empty((self.world_size * t.shape[0], *t.shape[1:]), dtype=src.dtype,
                          device=t.device)
        self.all_gather_into(out, src)
        return out.bool() if t.dtype == torch.bool else out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed(platform: str = "cuda", n_devices: Optional[int] = None, *,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None, init_method: Optional[str] = None,
                     backend: Optional[str] = None) -> Mesh:
    """Join the process group and return this rank's Mesh.

    `rank`, `world_size` and `local_rank` default to torchrun's RANK,
    WORLD_SIZE and LOCAL_RANK (0, 1 and 0 without them); `init_method`
    defaults to torchrun's `env://` (MASTER_ADDR / MASTER_PORT), or, for a
    world of one process without them, an in-process store; tests pass a
    `file://` store. `platform` 'cuda' puts the rank on CUDA device
    LOCAL_RANK modulo the devices present and picks NCCL; 'cpu' picks gloo.
    `backend='gloo'` on 'cuda' lets several ranks share one card. If the
    process group already exists it is joined as it is.

    `n_devices` must equal the world size: a smaller or larger mesh than the
    ranks that run would fake the multi-device semantics (the JAX package's
    `make_mesh` refuses the same)."""
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platform {platform!r}: cuda or cpu")
    if dist.is_initialized():
        world_size, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
        rank = _env_int("RANK", 0) if rank is None else rank
    if n_devices is not None and n_devices != world_size:
        raise ValueError(f"requested a {n_devices}-device mesh but the world has "
                         f"{world_size} process(es); launch {n_devices} ranks "
                         f"(torchrun --nproc_per_node {n_devices})")
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("platform cuda: no CUDA device is available")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend or ("nccl" if platform == "cuda" else "gloo")
    if backend == "nccl" and platform != "cuda":
        raise ValueError("the nccl backend needs platform cuda")
    if not dist.is_initialized():
        if init_method is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
        else:
            dist.init_process_group(backend, init_method=init_method or "env://",
                                    world_size=world_size, rank=rank)
    return Mesh(world_size=world_size, rank=rank, device=device, backend=backend)


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_rows(n: int, world_size: int, rank: int) -> slice:
    """The rows of an n-row batch (or chunk of windows) that `rank` owns:
    equal contiguous blocks in rank order, as a 'data'-sharded array's
    shards lie in JAX."""
    if n % world_size:
        raise ValueError(f"{n} rows do not split over {world_size} ranks")
    per = n // world_size
    return slice(rank * per, (rank + 1) * per)


def fsdp_shard_dim(shape: Sequence[int], n: int, min_size: int = 2 ** 18) -> Optional[int]:
    """The dim along which `shard_params_fsdp` shards a parameter of `shape`
    over n ranks, or None to replicate it: 0-d tensors and tensors of fewer
    than `min_size` elements stay replicated; otherwise the largest dim that
    n divides, ties going to the earlier dim; replicated if none divides.

    The rule sees the port's layout (a Linear weight is (out, in), Flax's
    kernel (in, out)), so on a tie between a weight's dims the two packages
    may pick different logical axes; the shard sizes are the same."""
    numel = 1
    for s in shape:
        numel *= s
    if len(shape) == 0 or numel < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0:
            return d
    return None
