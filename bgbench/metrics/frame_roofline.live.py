"""The temporal step's share of its roofline: the counted bound of one
frame's temporal step, carry read and written, over the device's busy time
per frame completed in the traced window."""
from harness.readers import roofline_share


def read(run):
    return roofline_share(run, "pack")
