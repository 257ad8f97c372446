"""AdamW and the EMA: StageTimer ms per step."""

from harness import readings


def read(record):
    return readings.per(record, ("optimizer",), "steps", 1e3)
