"""K1-K3 forward kernels (batch building and the UNet forward): percent of
their roofline in the traced steps."""

from harness import roofline

KERNELS = ("group_norm", "flash_attention", "temporal_attention")


def read(record):
    return roofline.share(record, KERNELS) if "launches" in record else None
