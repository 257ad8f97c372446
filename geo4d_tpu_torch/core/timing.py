"""Per-stage wall times for the pipeline's optional `timer=` argument, and a
span recorder that notes where the host is without touching the device.

`StageTimer` synchronises the device around each stage, so its seconds hold
the stage's device work. `SpanRecorder` never synchronises: a span is the
host's interval, and the device's activity is put down to the span open
when it was launched (the profiler's launch records carry the host time).
The pipeline opens its spans and counters through `stage`, `span`,
`request` and `count`; with no recorder installed each is one global
lookup and a None test. `current` returns the installed recorder.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import torch


class StageTimer:
    """Wall time per named stage, synchronising the device around each one.
    Pass it as `timer=`; times accumulate in `seconds`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class Span:
    """One span: ids are indices into `SpanRecorder.spans`; `request` is the
    id of the request it belongs to (None outside every request); the host
    interval is time.perf_counter_ns(), `end_ns` None while it is open."""

    id: int
    parent: Optional[int]
    request: Optional[int]
    name: str
    start_ns: int
    end_ns: Optional[int] = None


class SpanRecorder:
    """Spans and counters in memory. A span records its id, its parent's id,
    its request's id, its name and its host start and end; a counter
    records (span id, request id, name, n), charged to the innermost open
    span. Only the thread that installed the recorder (`recording`) records:
    spans and counters of other threads are dropped."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: List[tuple] = []
        self.requests = 0
        self._open: List[Span] = []
        self._thread: Optional[int] = None

    def span(self, name: str, request: bool = False) -> "_Scope":
        """A context manager for one span; with `request`, a fresh request
        unless one is open already (then a plain span of it)."""
        return _Scope(self, name, request)

    def count(self, name: str, n: int = 1) -> None:
        if threading.get_ident() != self._thread:
            return
        top = self._open[-1] if self._open else None
        self.counts.append((None, None, name, n) if top is None
                           else (top.id, top.request, name, n))

    def totals(self) -> Dict[str, int]:
        """Each counter summed over every span."""
        out: Dict[str, int] = {}
        for _, _, name, n in self.counts:
            out[name] = out.get(name, 0) + n
        return out

    def _push(self, name: str, request: bool) -> Optional[Span]:
        if threading.get_ident() != self._thread:
            return None
        top = self._open[-1] if self._open else None
        rid = None if top is None else top.request
        if request and rid is None:
            rid = self.requests
            self.requests += 1
        s = Span(len(self.spans), None if top is None else top.id, rid, name,
                 time.perf_counter_ns())
        self.spans.append(s)
        self._open.append(s)
        return s

    def _pop(self, s: Span) -> None:
        s.end_ns = time.perf_counter_ns()
        if self._open and self._open[-1] is s:
            self._open.pop()
        else:
            self._open.remove(s)


class _Scope:
    __slots__ = ("rec", "name", "request", "opened")

    def __init__(self, rec: SpanRecorder, name: str, request: bool):
        self.rec, self.name, self.request, self.opened = rec, name, request, None

    def __enter__(self) -> Optional[Span]:
        self.opened = self.rec._push(self.name, self.request)
        return self.opened

    def __exit__(self, *exc) -> bool:
        if self.opened is not None:
            self.rec._pop(self.opened)
        return False


_NULL = contextlib.nullcontext()
_RECORDER: Optional[SpanRecorder] = None      # the installed recorder


@contextlib.contextmanager
def recording(rec: SpanRecorder):
    """Installs `rec` for the calling thread over a `with` block."""
    global _RECORDER
    prev, prev_thread = _RECORDER, rec._thread
    rec._thread = threading.get_ident()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER, rec._thread = prev, prev_thread


def current() -> Optional[SpanRecorder]:
    """The installed recorder, or None."""
    return _RECORDER


def span(name: str):
    """A span of the installed recorder, else a no-op context."""
    rec = _RECORDER
    if rec is None:
        return _NULL
    return rec.span(name)


def request(name: str):
    """A request's root span (a fresh request id) of the installed recorder;
    inside a request, a plain span of it. Else a no-op context."""
    rec = _RECORDER
    if rec is None:
        return _NULL
    return rec.span(name, request=True)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to a counter of the installed recorder, charged to the
    innermost open span; without a recorder, nothing."""
    rec = _RECORDER
    if rec is not None:
        rec.count(name, n)


@contextlib.contextmanager
def _timed_span(timed, scope):
    with timed, scope:
        yield


def stage(timer, name: str):
    """`timer(name)` when a timer is given, else a no-op context; with a
    recorder installed, also a span of the same name, inside the timer's
    synchronisations."""
    rec = _RECORDER
    if rec is None:
        return timer(name) if timer is not None else _NULL
    if timer is None:
        return rec.span(name)
    return _timed_span(timer(name), rec.span(name))
