"""Whole reconstruct: model FLOPs (towers, UNet steps, decode) over wall time,
percent of the bf16 peak."""

from harness import readings


def read(record):
    return readings.mfu(record, "reconstructs")
