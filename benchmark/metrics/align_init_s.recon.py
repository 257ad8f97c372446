"""Aligner initialisation and PnP: StageTimer s per reconstruct."""

from harness import readings


def read(record):
    return readings.per(record, ("align_init", "align_pnp"), "reconstructs")
