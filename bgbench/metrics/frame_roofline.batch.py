"""The per-frame step's share of its roofline: the counted bound of one
frame's filter step over the device's busy time per frame completed in the
traced window (quantization and stacking included)."""
from harness.readers import roofline_share


def read(run):
    return roofline_share(run, "engine")
