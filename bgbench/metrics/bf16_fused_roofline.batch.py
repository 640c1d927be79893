"""The bf16 fused kernel's share of its own roofline (B3-bf16, whichever
fused kernel the plan runs): the counted bound of one frame's step in bf16
storage (``harness/counts.py::fused_work(esize=2)``: a bf16 frame read and
written, the TI fractions; bytes over the HBM rate or operations over the
fp32 rate, the larger) over the device time per frame of the kernels whose
name holds ``bg_fused``."""
from harness.counts import FP32_FLOPS_PER_S, HBM_BYTES_PER_S, fused_work


def read(run):
    if run.trace is None or "engine" not in run.spans or run.completed == 0:
        return None
    seconds = run.trace.op_seconds("bg_fused")
    if seconds <= 0:
        return None
    cfg = run.config
    nbytes, flops = fused_work(1, int(cfg["height"]), int(cfg["width"]), cfg, esize=2)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    return 100.0 * bound / (seconds / run.completed)
