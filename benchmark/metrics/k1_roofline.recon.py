"""K1 (GroupNorm) forward kernels: percent of their roofline in the traced
reconstruct (bounds from the launch counter, time from the device trace)."""

from harness import roofline


def read(record):
    return roofline.share(record, ("group_norm",)) if "launches" in record else None
