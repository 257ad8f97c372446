"""K1b-K3b backward kernels: percent of their roofline in the traced steps."""

from harness import roofline

KERNELS = ("group_norm", "flash_attention", "temporal_attention")


def read(record):
    return roofline.share(record, KERNELS, backward=True) if "launches" in record else None
