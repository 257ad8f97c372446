"""Batch building (five VAE encodes, CLIP, resampler): StageTimer ms per step."""

from harness import readings


def read(record):
    return readings.per(record, ("build",), "steps", 1e3)
