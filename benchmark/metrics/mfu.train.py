"""Whole training step: model FLOPs (batch building, UNet forward and
backward) over wall time, percent of the bf16 peak."""

from harness import readings


def read(record):
    return readings.mfu(record, "steps")
