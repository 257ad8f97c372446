"""Wall seconds of the window per training step (host clock)."""

from harness import readings


def read(record):
    return readings.rate(record, "steps")
