"""UNet forward and backward: StageTimer ms per step."""

from harness import readings


def read(record):
    return readings.per(record, ("forward_backward",), "steps", 1e3)
