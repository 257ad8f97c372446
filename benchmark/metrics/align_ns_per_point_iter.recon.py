"""Aligner optimisation (both phases and the calibration): StageTimer ns per
iteration per window point the aligner holds (the program's `align_points`
counter per reconstruct), so that aligners over 5 and over 25 windows
compare."""

from harness import readings


def read(record):
    work = record.get("stage_work", {})
    points, calls = work.get("align_points"), work.get("reconstructs")
    per_iter = readings.per(record, ("align_phase", "calibrate"), "align_iters")
    if not points or not calls or per_iter is None:
        return None
    return 1e9 * per_iter / (points / calls)
