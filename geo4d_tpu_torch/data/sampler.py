"""Deterministic epoch-seeded, shard-aware batch sampling: the port's own
copy of geo4d_tpu/data/sampler.py (numpy only; tests/test_torch_copies.py
holds it equal to the original).

Parity target: reference lvdm/data/batched_sampler.py `BatchedRandomSampler`
(:21-69): every batch shares one randomly-chosen "feature" index (e.g. an
aspect-ratio bucket) from a pool; indices are shuffled with an epoch-derived
seed (`epoch + 777`); in distributed mode each rank takes a batch-aligned
slice of the global order, so all ranks agree on the epoch plan without
communication.

TPU-first recast: instead of a stateful torch Sampler iterated per rank,
`epoch_plan` is a pure function (epoch -> the full global index plan) and
`shard_plan` slices it for a data-parallel shard. In single-controller JAX
the "rank" is a dp-shard id (batches are sharded over the mesh by the train
step, not by per-process data loaders), but the same functions serve
multi-process mode with rank = jax.process_index().
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def round_by(total: int, multiple: int, up: bool = False) -> int:
    """Round `total` down (or up) to a multiple (batched_sampler.py:72-75)."""
    if up:
        total = total + multiple - 1
    return (total // multiple) * multiple


def epoch_plan(
    n_samples: int,
    batch_size: int,
    pool_size: int,
    epoch: int,
    world_size: int = 1,
    drop_last: bool = True,
) -> np.ndarray:
    """The global (total_size, 2) plan of (sample_idx, feat_idx) rows for
    one epoch — every consecutive `batch_size` rows share one feat_idx.

    Deterministic in `epoch` with the reference's seed derivation
    (batched_sampler.py:44: seed = epoch + 777). Indices wrap modulo
    n_samples when drop_last=False pads the tail.
    """
    total = round_by(n_samples, batch_size * world_size) if drop_last else n_samples
    assert world_size == 1 or drop_last, "must drop the last batch in distributed mode"
    rng = np.random.default_rng(seed=epoch + 777)

    sample_idxs = np.arange(total) % n_samples
    rng.shuffle(sample_idxs)

    n_batches = (total + batch_size - 1) // batch_size
    feat = rng.integers(pool_size, size=n_batches)
    feat = np.broadcast_to(feat[:, None], (n_batches, batch_size)).ravel()[:total]
    return np.stack([sample_idxs, feat], axis=1)


def shard_plan(
    plan: np.ndarray,
    rank: int,
    world_size: int,
    batch_size: int,
) -> np.ndarray:
    """Batch-aligned contiguous slice of the epoch plan for one shard
    (batched_sampler.py:62-66)."""
    total = len(plan)
    per_proc = batch_size * (
        (total + world_size * batch_size - 1) // (world_size * batch_size)
    )
    return plan[rank * per_proc: (rank + 1) * per_proc]


class BatchedRandomSampler:
    """Iterator facade matching the reference's surface: `set_epoch`,
    `__len__`, `__iter__` yielding (sample_idx, feat_idx) tuples."""

    def __init__(
        self,
        n_samples: int,
        batch_size: int,
        pool_size: int,
        world_size: int = 1,
        rank: int = 0,
        drop_last: bool = True,
    ):
        self.n_samples = n_samples
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.world_size = world_size
        self.rank = rank
        self.drop_last = drop_last
        self.total_size = (
            round_by(n_samples, batch_size * world_size) if drop_last else n_samples
        )
        self.epoch: Optional[int] = None

    def __len__(self) -> int:
        return self.total_size // self.world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        if self.epoch is None:
            assert self.world_size == 1 and self.rank == 0, (
                "use set_epoch() in distributed mode"
            )
            epoch = int(np.random.default_rng().integers(2**31))
        else:
            epoch = self.epoch
        plan = epoch_plan(
            self.n_samples, self.batch_size, self.pool_size, epoch,
            self.world_size, self.drop_last,
        )
        mine = shard_plan(plan, self.rank, self.world_size, self.batch_size)
        yield from (tuple(int(v) for v in row) for row in mine)
