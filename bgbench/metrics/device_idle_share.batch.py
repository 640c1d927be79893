"""The device's idle share of the traced window: 1 minus the union of its
kernel, copy and memset intervals over the window's length, in %."""
from harness.readers import idle_share


def read(run):
    return idle_share(run, "engine")
