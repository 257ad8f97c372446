"""Aligner optimisation (both phases and the calibration): StageTimer ms
per iteration."""

from harness import readings


def read(record):
    return readings.per(record, ("align_phase", "calibrate"), "align_iters", 1e3)
