"""CLIP image tower, VAE encoder and resampler: StageTimer ms per frame."""

from harness import readings


def read(record):
    return readings.per(record, ("clip", "vae_encode", "resampler"), "frames", 1e3)
