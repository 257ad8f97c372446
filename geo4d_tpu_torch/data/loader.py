"""Data-module + loader layer, the port's own copy of
geo4d_tpu/data/loader.py (reference main/utils_data_eval.py
`DataModuleFromConfig` :43-161 + `worker_init_fn` :14-27): per-split
datasets instantiated from `target/params` configs, train/test loaders
driven by the pool-constrained `BatchedRandomSampler` in multi-resolution
mode, iterable datasets partitioned across workers, `test_max_n_samples`
subsetting.

Host preprocessing overlaps device work through one background prefetch
thread per loader (a bounded queue) instead of worker processes. Rank
sharding (`world_size`, `rank`: one process a rank, as
cli/train.py's ranks) reuses data/sampler.py's epoch-seeded plans, so no
rank talks to another. Config nodes resolve through the port's registry
(core/registry.py's `components`; register a dataset there to name it in a
config). tests/test_torch_data_loader.py holds the batches and their order to
the original's.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from geo4d_tpu_torch.data.sampler import BatchedRandomSampler


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (dicts / tuples / arrays) into one batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            default_collate([s[i] for s in samples]) for i in range(len(first))
        )
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(samples)
    if isinstance(first, str):
        return list(samples)
    return np.stack([np.asarray(s) for s in samples])


class Prefetcher:
    """Background-thread prefetch with a bounded queue: host-side sample
    assembly overlaps device compute (one thread is enough; decode and crop
    are numpy / C++ work that releases the GIL)."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def fill():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # propagate into the consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=fill, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def shard_iterable(dataset, worker_id: int, num_workers: int):
    """Partition an iterable dataset's id space across workers
    (utils_data_eval.py:19-24 semantics): worker w takes the w-th
    contiguous slice of valid_ids."""
    ids = list(getattr(dataset, "valid_ids", range(len(dataset))))
    split = max(len(ids) // max(num_workers, 1), 1)
    lo = worker_id * split
    hi = len(ids) if worker_id == num_workers - 1 else (worker_id + 1) * split
    return ids[lo:hi]


class DataModule:
    """Per-split datasets + loaders.

    Splits are given either as already-built dataset objects (anything
    with __len__/__getitem__) or as `{"target": ..., "params": ...}`
    configs resolved through the registry at `setup()`: the reference's
    instantiate_from_config contract (utils_data_eval.py:92-95)."""

    def __init__(
        self,
        batch_size: int,
        train=None,
        validation=None,
        test=None,
        predict=None,
        num_workers: Optional[int] = None,   # accepted for config parity
        multi_resolution: bool = False,
        multi_task: bool = False,
        test_max_n_samples: Optional[int] = None,
        world_size: int = 1,
        rank: int = 0,
        collate_fn: Callable = default_collate,
        prefetch: int = 2,
    ):
        self.batch_size = batch_size
        self.configs = {
            k: v
            for k, v in dict(train=train, validation=validation, test=test,
                             predict=predict).items()
            if v is not None
        }
        self.multi_resolution = multi_resolution
        self.multi_task = multi_task
        self.test_max_n_samples = test_max_n_samples
        self.world_size = world_size
        self.rank = rank
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.datasets: Dict[str, Any] = {}

    def setup(self):
        from geo4d_tpu_torch.core.config import instantiate
        from geo4d_tpu_torch.core.registry import _register_all, components

        if "geo4d_tpu.UNet3D" not in components:
            _register_all()
        for k, v in self.configs.items():
            if isinstance(v, dict) and "target" in v:
                self.datasets[k] = instantiate(v, components)
            else:
                self.datasets[k] = v
        return self

    def _pool_size(self, split: str) -> int:
        ds = self.datasets[split]
        pool = len(getattr(ds, "_resolutions", [0])) or 1
        if self.multi_task:
            pool *= len(getattr(ds, "_tasks", [0])) or 1
        return max(pool, 1)

    def loader(self, split: str, shuffle: Optional[bool] = None,
               epoch: int = 0) -> Iterator:
        """One epoch of collated batches for a split."""
        if not self.datasets:
            self.setup()
        ds = self.datasets[split]
        if split == "test" and self.test_max_n_samples is not None:
            n = min(len(ds), self.test_max_n_samples)
        else:
            n = len(ds)
        if shuffle is None:
            shuffle = split == "train"

        def gen():
            if self.multi_resolution and split in ("train", "test"):
                sampler = BatchedRandomSampler(
                    n, self.batch_size, self._pool_size(split),
                    world_size=self.world_size, rank=self.rank,
                )
                sampler.set_epoch(epoch)
                batch: list = []
                for sample_idx, feat_idx in sampler:
                    item = ds[(sample_idx, feat_idx)] if getattr(
                        ds, "takes_feat_idx", False
                    ) else ds[sample_idx]
                    batch.append(item)
                    if len(batch) == self.batch_size:
                        yield self.collate_fn(batch)
                        batch = []
            else:
                order = np.arange(n)
                if shuffle:
                    np.random.default_rng(epoch + 777).shuffle(order)
                for start in range(0, n - self.batch_size + 1, self.batch_size):
                    yield self.collate_fn(
                        [ds[int(i)] for i in order[start: start + self.batch_size]]
                    )

        return Prefetcher(gen(), depth=self.prefetch)

    # reference-surface aliases (utils_data_eval.py:66-78)
    def train_dataloader(self, epoch: int = 0):
        return self.loader("train", epoch=epoch)

    def val_dataloader(self, shuffle: bool = False):
        return self.loader("validation", shuffle=shuffle)

    def test_dataloader(self, shuffle: bool = False):
        return self.loader("test", shuffle=shuffle)

    def predict_dataloader(self):
        return self.loader("predict", shuffle=False)
