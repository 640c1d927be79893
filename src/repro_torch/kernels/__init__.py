"""Hand-written CUDA kernels for the paper's hot spot, each beside its plain
PyTorch version: the fused GC / GF / TI filter (per frame, temporal and
streamed) and the staged GC, GF and TI kernels."""
from .ops import (
    bg_blur,
    bg_blur_plain,
    bg_create,
    bg_create_plain,
    bg_fused,
    bg_fused_plain,
    bg_slice,
    bg_slice_plain,
    bilateral_grid_filter_pallas,
)

__all__ = [
    "bg_create",
    "bg_create_plain",
    "bg_blur",
    "bg_blur_plain",
    "bg_slice",
    "bg_slice_plain",
    "bg_fused",
    "bg_fused_plain",
    "bilateral_grid_filter_pallas",
    "COUNTERS",
    "launch_counts",
]

# every launch counter of the port: (wrapper, attribute)
COUNTERS = (("bg_fused", "launches"), ("bg_fused", "temporal_launches"),
            ("bg_fused", "streamed_launches"), ("bg_fused", "bf16_launches"),
            ("bg_fused", "bf16_temporal_launches"), ("bg_fused", "bf16_streamed_launches"),
            ("bg_create", "launches"), ("bg_blur", "launches"), ("bg_slice", "launches"))


def launch_counts() -> dict:
    """This process's launch counters, ``{"bg_fused.launches": n, ...}``."""
    wrappers = {"bg_fused": bg_fused, "bg_create": bg_create, "bg_blur": bg_blur,
                "bg_slice": bg_slice}
    return {f"{fn}.{attr}": getattr(wrappers[fn], attr) for fn, attr in COUNTERS}
