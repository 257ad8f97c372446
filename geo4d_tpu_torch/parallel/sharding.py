"""Bucketed collectives over lists of parameter-shaped tensors: the
data-parallel gradient mean and the ZeRO-style (FSDP) parameter gather and
gradient reduce-scatter that the JAX package leaves to XLA.

A `ShardLayout` names, for every parameter, the dim sharded over the mesh
(`fsdp_shard_dim`) or None (replicated). A sharded parameter's rank slice is
`full.narrow(dim, rank * k, k)` with k = size / world, kept contiguous in the
parameter's own layout. The collectives run on flat buffers of up to
BUCKET_BYTES that concatenate several tensors; a sharded tensor enters a
buffer as its dim moved to the front and split into `world` equal blocks, so
that the buffer is rank-major: block r of every tensor of the bucket, then
block r + 1.

Means are a SUM over the ranks divided by the world size, in float32, in
both the data-parallel and the sharded path, so the two round alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from geo4d_tpu_torch.parallel.mesh import Mesh, fsdp_shard_dim

BUCKET_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Sharded dim (or None) per parameter name, for `world` ranks."""

    dims: Dict[str, Optional[int]]
    world: int
    rank: int

    @classmethod
    def build(cls, shapes: Dict[str, Sequence[int]], mesh: Mesh,
              min_size: int = 2 ** 18) -> "ShardLayout":
        return cls({n: fsdp_shard_dim(tuple(s), mesh.world_size, min_size)
                    for n, s in shapes.items()}, mesh.world_size, mesh.rank)

    @classmethod
    def replicated(cls, names: Sequence[str], mesh: Mesh) -> "ShardLayout":
        return cls({n: None for n in names}, mesh.world_size, mesh.rank)

    @property
    def sharded(self) -> List[str]:
        return [n for n, d in self.dims.items() if d is not None]

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `full` (a copy; the full tensor itself for a
        replicated parameter)."""
        d = self.dims[name]
        if d is None:
            return full
        k = full.shape[d] // self.world
        return full.narrow(d, self.rank * k, k).clone()


def _buckets(dtypes: Sequence[torch.dtype], nbytes: Sequence[int]) -> Iterator[List[int]]:
    """Indices grouped by dtype, in order, each group holding up to
    BUCKET_BYTES (`nbytes[i]` counts tensor i)."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, dt in enumerate(dtypes):
        by_dtype.setdefault(dt, []).append(i)
    for idx in by_dtype.values():
        bucket, size = [], 0
        for i in idx:
            if bucket and size + nbytes[i] > BUCKET_BYTES:
                yield bucket
                bucket, size = [], 0
            bucket.append(i)
            size += nbytes[i]
        if bucket:
            yield bucket


def _f32_buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[int]]:
    """Buckets of tensors that travel as float32 whatever their dtype."""
    return _buckets([torch.float32] * len(tensors), [4 * t.numel() for t in tensors])


def _moved_shape(shape: Sequence[int], d: int, rows: int) -> Tuple[int, ...]:
    """`shape` with dim d moved to the front and given `rows` rows."""
    rest = [s for i, s in enumerate(shape) if i != d]
    return (rows, *rest)


def all_reduce_mean(tensors: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks, in float32 (summed, then divided
    by the world size), one collective per bucket."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for bucket in _f32_buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket]).float()
        mesh.all_reduce_sum_(flat)
        flat.div_(mesh.world_size)
        for i, part in zip(bucket, flat.split([tensors[i].numel() for i in bucket])):
            out[i] = part.view(tensors[i].shape)
    return out


def reduce_scatter_mean(fulls: List[torch.Tensor], dims: List[int],
                        mesh: Mesh) -> List[torch.Tensor]:
    """For full-shape tensors (one per rank, e.g. each rank's gradient),
    this rank's slice along dims[i] of their mean over the ranks, in
    float32 (summed, then divided by the world size)."""
    world = mesh.world_size
    out: List[Optional[torch.Tensor]] = [None] * len(fulls)
    for bucket in _f32_buckets(fulls):
        blocks = [fulls[i].movedim(dims[i], 0).reshape(world, -1) for i in bucket]
        sizes = [b.shape[1] for b in blocks]
        flat = torch.cat(blocks, dim=1).reshape(-1).float()
        mine = torch.empty(sum(sizes), dtype=flat.dtype, device=flat.device)
        mesh.reduce_scatter_sum(mine, flat)
        mine.div_(world)
        for i, part in zip(bucket, mine.split(sizes)):
            shape = fulls[i].shape
            moved = _moved_shape(shape, dims[i], shape[dims[i]] // world)
            out[i] = part.view(moved).movedim(0, dims[i]).contiguous()
    return out


def all_gather_full(slices: List[torch.Tensor], dims: List[int], mesh: Mesh,
                    dtypes: Optional[List[torch.dtype]] = None
                    ) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield (i, full tensor) for each rank slice, rebuilt along dims[i] from
    every rank's slice (cast to dtypes[i] first, if given), one collective
    per bucket; a bucket's full tensors are yielded before the next bucket
    is gathered."""
    world = mesh.world_size
    dtypes = dtypes or [s.dtype for s in slices]
    nbytes = [s.numel() * world * dt.itemsize
              for s, dt in zip(slices, dtypes)]
    for bucket in _buckets(dtypes, nbytes):
        parts = [slices[i].to(dtypes[i]).movedim(dims[i], 0).reshape(-1) for i in bucket]
        sizes = [p.numel() for p in parts]
        flat = torch.cat(parts)
        full = torch.empty(world * flat.numel(), dtype=flat.dtype, device=flat.device)
        mesh.all_gather_into(full, flat)
        cols = full.view(world, -1).split(sizes, dim=1)
        for i, col in zip(bucket, cols):
            shape = slices[i].shape
            moved = _moved_shape(shape, dims[i], shape[dims[i]] * world)
            yield i, col.reshape(moved).movedim(0, dims[i])


def gather_state_dict(tensors: Dict[str, torch.Tensor], layout: ShardLayout, mesh: Mesh,
                      keep: bool = True) -> Optional[Dict[str, torch.Tensor]]:
    """Full tensors on the CPU from each rank's slices (a replicated tensor
    as it is), in the order of `tensors`. Every rank must call it; ranks
    that pass keep=False take part in the collectives and get None."""
    names = list(tensors)
    sharded = [n for n in names if layout.dims[n] is not None]
    out = {n: tensors[n].to("cpu", copy=True) for n in names
           if keep and layout.dims[n] is None}
    for i, full in all_gather_full([tensors[n] for n in sharded],
                                   [layout.dims[n] for n in sharded], mesh):
        if keep:
            out[sharded[i]] = full.to("cpu", copy=True)
    return {n: out[n] for n in names} if keep else None
