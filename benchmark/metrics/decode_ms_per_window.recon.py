"""4-head VAE decode and postprocess: StageTimer ms per window."""

from harness import readings


def read(record):
    return readings.per(record, ("decode", "postprocess"), "windows", 1e3)
