"""K2 and K3 (spatial and temporal attention) forward kernels: percent of
their roofline in the traced reconstruct."""

from harness import roofline


def read(record):
    if "launches" not in record:
        return None
    return roofline.share(record, ("flash_attention", "temporal_attention"))
