"""The per-frame step's share of its roofline in a bf16 cell: the same fp32
counted bound as ``frame_roofline.batch`` (the task, whatever storage does
it) over the device's busy time per frame completed in the traced window
(the casts, the kernel and the engine's stack all count)."""
from harness.readers import roofline_share


def read(run):
    return roofline_share(run, "engine")
