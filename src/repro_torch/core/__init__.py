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
from .metrics import mssim, psnr
from .noise import (
    NOISE_SIGMA_PAPER,
    add_gaussian_noise,
    synthetic_batch,
    synthetic_image,
    synthetic_image_np,
)

__all__ = [
    "BGConfig",
    "conv3_axis",
    "bilateral_grid_filter",
    "gaussian_taps",
    "grid_blur",
    "grid_create",
    "grid_normalize",
    "grid_shape",
    "grid_slice",
    "grid_slice_homogeneous",
    "quantize_intensity",
    "mssim",
    "psnr",
    "synthetic_image",
    "synthetic_image_np",
    "synthetic_batch",
    "add_gaussian_noise",
    "NOISE_SIGMA_PAPER",
]
