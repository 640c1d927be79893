"""Core library: the paper's bilateral grid with a variable-sized window."""
from .bilateral_grid import (
    BGConfig,
    bilateral_grid_filter,
    conv3_axis,
    gaussian_taps,
    grid_blur,
    grid_create,
    grid_normalize,
    grid_shape,
    grid_slice,
    grid_slice_homogeneous,
    quantize_intensity,
)
from .bilateral_filter import bilateral_filter, gaussian_blur
from .fixed_point import bilateral_grid_filter_fixed, intensity_luts, pow2_shift
from .metrics import mssim, psnr
from .noise import (
    NOISE_SIGMA_PAPER,
    add_gaussian_noise,
    synthetic_batch,
    synthetic_image,
    synthetic_image_np,
)
from .streaming import bilateral_grid_filter_streaming

__all__ = [
    "BGConfig",
    "conv3_axis",
    "bilateral_grid_filter",
    "bilateral_grid_filter_fixed",
    "bilateral_grid_filter_streaming",
    "bilateral_filter",
    "gaussian_blur",
    "gaussian_taps",
    "grid_blur",
    "grid_create",
    "grid_normalize",
    "grid_shape",
    "grid_slice",
    "grid_slice_homogeneous",
    "quantize_intensity",
    "intensity_luts",
    "pow2_shift",
    "mssim",
    "psnr",
    "synthetic_image",
    "synthetic_image_np",
    "synthetic_batch",
    "add_gaussian_noise",
    "NOISE_SIGMA_PAPER",
]
