"""The fused filter kernel's share of its roofline (B1 or B3, whichever the
plan runs): the counted bound of one frame's step over the device time per
frame of the kernels whose name holds ``bg_fused``."""
from harness.readers import roofline_share


def read(run):
    return roofline_share(run, "engine", ops="bg_fused")
