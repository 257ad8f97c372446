"""`reconstruct`'s closed loop (drivers/reconstruct.py) with three of the
program's counters (`core.timing.count`) added to each call's work:

  window_chunks        UNet calls of the call's `predict_video`
  window_rows_padded   rows those calls ran beyond the real windows
  align_points         window points the call's aligner held

It counts into the installed span recorder when there is one, else into a
fresh `SpanRecorder` installed for the call. A program without a counter
(or without `timing.current`) leaves it out of the work, and the readers
of that work then read nothing.

Its cells' span readings (run_spans.py) are a reconstruct cell's; its
calibration runs through benchmark/calibrate_counted.py.
"""

from __future__ import annotations

import contextlib

from drivers import reconstruct
from harness import spans

COUNTERS = ("window_chunks", "window_rows_padded", "align_points")
# harness/spans.py picks a cell's span readings by its driver's name
spans.CELL_METRICS.setdefault("reconstruct_counted", spans.CELL_METRICS["reconstruct"])


class Driver(reconstruct.Driver):
    def run_unit(self, timer) -> dict:
        from geo4d_tpu_torch.core import timing

        current = getattr(timing, "current", None)
        rec = current() if current is not None else None
        scope = contextlib.nullcontext()
        if rec is None:
            rec = timing.SpanRecorder()
            scope = timing.recording(rec)
        first = len(rec.counts)
        with scope:
            work = super().run_unit(timer)
        for _, _, name, n in rec.counts[first:]:
            if name in COUNTERS:
                work[name] = work.get(name, 0) + n
        return work
