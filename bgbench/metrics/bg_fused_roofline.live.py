"""The temporal fused kernel's share of its roofline (B2): the counted
bound of one frame's temporal step over the device time per frame of the
kernels whose name holds ``bg_fused``."""
from harness.readers import roofline_share


def read(run):
    return roofline_share(run, "pack", ops="bg_fused")
