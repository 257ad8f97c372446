"""Wall seconds of the window per reconstructed frame (host clock)."""

from harness import readings


def read(record):
    return readings.rate(record, "frames")
