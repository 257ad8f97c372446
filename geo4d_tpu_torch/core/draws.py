"""Random draws handed to the training step, the batch builders and the
sampler: `Draws` (a torch.Generator on the device, consumed in order),
`GivenDraws` (arrays drawn elsewhere, e.g. by the JAX package in the tests)
and `RankDraws`, the one rule for a rank's share of a batch: draw for the
whole batch, keep the rank's rows, so that n ranks consume the generator as
one process running the n ranks' rows does."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Draws:
    """A step's random numbers, drawn in the order the step asks for them
    from one torch.Generator on `device`."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    @classmethod
    def seeded(cls, words: Sequence[int], device) -> "Draws":
        """A generator seeded from integer words (e.g. seed, step, stream):
        the same words give the same draws on the same device."""
        seed = int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0] >> 1)
        return cls(torch.Generator(device=device).manual_seed(seed))

    def randint(self, high: int, shape) -> torch.Tensor:
        return torch.randint(0, high, tuple(shape), generator=self.generator, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)


class GivenDraws:
    """Draws handed in as arrays, returned one per call in order (the tests
    pass the JAX package's draws; the training step its draws made before a
    CUDA graph, as tensors, used where they are); each must have the shape
    asked for."""

    def __init__(self, arrays, device="cpu"):
        self.arrays = list(arrays)
        self.device = torch.device(device)

    def _next(self, shape) -> torch.Tensor:
        a = self.arrays.pop(0)
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a), device=self.device)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"given draw of shape {tuple(a.shape)}, asked for {tuple(shape)}")
        return a

    def randint(self, high: int, shape) -> torch.Tensor:
        return self._next(shape).long()

    def normal(self, shape) -> torch.Tensor:
        return self._next(shape).float()

    def uniform(self, shape) -> torch.Tensor:
        return self._next(shape).float()


class RankDraws:
    """The draws of a global batch of `world` equal rank blocks, of which
    this rank keeps its own: every draw's leading dim is a batch dim (the
    batch, a chunk of windows, or the batch's frames flattened, B T), so
    the global draw has `world` times the rows and the rank's rows are its
    block. n ranks at batch b then draw what one process draws at batch
    n b."""

    def __init__(self, draws, world: int, rank: int):
        self.draws, self.world, self.rank = draws, world, rank
        self.device = draws.device

    def _rows(self, fn, shape) -> torch.Tensor:
        n = shape[0]
        return fn((n * self.world, *shape[1:]))[self.rank * n:(self.rank + 1) * n]

    def randint(self, high: int, shape) -> torch.Tensor:
        return self._rows(lambda s: self.draws.randint(high, s), shape)

    def normal(self, shape) -> torch.Tensor:
        return self._rows(self.draws.normal, shape)

    def uniform(self, shape) -> torch.Tensor:
        return self._rows(self.draws.uniform, shape)
