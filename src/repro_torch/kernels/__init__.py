"""Hand-written CUDA kernels for the paper's hot spot (fused GC / GF / TI),
each beside its plain PyTorch version."""
from .ops import bg_fused, bg_fused_plain, bilateral_grid_filter_pallas

__all__ = ["bg_fused", "bg_fused_plain", "bilateral_grid_filter_pallas"]
