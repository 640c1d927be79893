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
]
