"""Percent of the traced reconstruct with no kernel or copy on the device."""

from harness import readings


def read(record):
    return readings.idle(record)
