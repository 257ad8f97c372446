"""UNet: StageTimer ms of the DDIM steps per (step, window)."""

from harness import readings


def read(record):
    return readings.per(record, ("ddim_step_",), "ddim_steps", 1e3)
