"""CUDA-graph replay, the one rule by which the port replays work as a CUDA
graph. `GraphReplay(...)(key, fn, inputs)` runs `fn(*inputs)` eagerly the
first time it sees `key`; later it captures `fn` on static clones of
`inputs` on the device's side stream, unless it holds the key's graph, and
replays the graph on the current stream after copying `inputs` into the
clones. Another key frees the graph: one is held at a time. The launches
the op wrappers note in their KernelStats during a capture (which runs
nothing) are taken back and added again at each replay. Graphs are
captured on CUDA devices only (`_graph`); elsewhere, and inside `eager()`,
every call is eager.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

from geo4d_tpu_torch.core.timing import span
from geo4d_tpu_torch.ops.dispatch import KernelStats

_EAGER = contextvars.ContextVar("graphs_eager", default=False)


@contextlib.contextmanager
def eager():
    """Every GraphReplay call inside the block runs eagerly: the arithmetic
    a replay has to equal (the tests and chip_smoke.py compare the two)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


@functools.cache
def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream graphs are captured on (not the default stream), one per
    device for the process, so that the memory cached for it is reused."""
    return torch.cuda.Stream(device=device)


class _CudaGraph:
    """`fn()` captured in a torch.cuda.CUDAGraph on the side stream;
    `replay` runs it on the current stream and returns its static output."""

    def __init__(self, device: torch.device, fn):
        self.graph = torch.cuda.CUDAGraph()
        side = side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                self.out = fn()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)

    def replay(self):
        self.graph.replay()
        return self.out


def _graph(device: torch.device):
    """What captures on `device`, or None: eager. The CPU tests stand in."""
    return _CudaGraph if device.type == "cuda" else None


class GraphReplay:
    """The replay rule of one caller. `release`, when given, runs at the
    start of each capture, after the last graph was freed."""

    def __init__(self, device, capture_span: str, release=None):
        self.device = torch.device(device)
        self.capture_span, self.release = capture_span, release
        self.warm = set()           # the keys whose eager call has run
        self.free()

    def free(self) -> None:
        """Drops the graph; its pool goes once its outputs are unused."""
        self.key = self.graph = None
        self.static, self.reads, self.launches = [], [], []

    def prepare(self, key, fn, inputs=(), reads=()) -> None:
        """The first half of a call, which frees and captures; called alone,
        it captures outside the caller's own span of the call."""
        make = None if _EAGER.get() else _graph(self.device)
        # the graph holds its reads, so their ids are not reused while it lives
        if self.graph is not None and (make is None or self.key != key
                                       or list(map(id, reads)) != list(map(id, self.reads))):
            self.free()
        if make is None or self.graph is not None or key not in self.warm:
            return
        with span(self.capture_span):
            if self.release is not None:
                self.release()
            static = [x.clone() for x in inputs]
            before = [(s, s.snapshot()) for s in KernelStats.registry]
            try:
                graph = make(self.device, lambda: fn(*static))
            finally:
                launches = [(s, tuple(a - b for a, b in zip(s.snapshot(), counts)))
                            for s, counts in before]
                for s, counts in before:
                    s.restore(counts)
        self.key, self.graph, self.static, self.reads = key, graph, static, list(reads)
        self.launches = launches

    def __call__(self, key, fn, inputs=(), reads=()):
        """(output, replayed): `fn(*inputs)`'s eager output, or the graph's
        static output, which the next replay overwrites. `reads`: tensors
        besides `inputs` that `fn` reads where they are; the graph holds
        them, and a call passing other objects captures anew."""
        self.prepare(key, fn, inputs, reads)
        if self.graph is None:
            self.warm.add(key)
            return fn(*inputs), False
        for s, x in zip(self.static, inputs):
            s.copy_(x)
        out = self.graph.replay()
        for s, counts in self.launches:
            s.add(counts)
        return out, True
