"""Shared helpers for the bilateral-grid kernels: the port's own copy of the
grid-index arithmetic the JAX kernels use (``repro/kernels/common.py``).

Every grid helper is numpy on the host. The one-hot matrices are kept because
the plain versions and the tests use them to state the column maps; the CUDA
kernel computes the same cells with integer arithmetic instead of a matmul.
The storage helpers name the fused kernels' two storage types (the JAX
package's ``repro/plan.py`` ``PRECISIONS``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bilateral_grid import BGConfig, _taps, conv3_axis, grid_shape

__all__ = [
    "BGConfig",
    "conv3_axis",
    "grid_shape",
    "gc_cells",
    "gc_col_onehot",
    "ti_col_onehots",
    "ti_col_fracs",
    "gc_row_split",
    "taps_np",
    "PRECISIONS",
    "precision_bytes",
    "storage_dtype",
    "round_storage",
    "stores_quantized_exactly",
]

PRECISIONS = ("fp32", "bf16")
_STORAGE = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _check_precision(precision: str) -> str:
    """``precision`` if it is ``"fp32"`` or ``"bf16"``, else ``ValueError``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")
    return precision


def storage_dtype(precision: str) -> torch.dtype:
    """The dtype frames, the carry and the stored grid planes are held in:
    ``torch.float32`` for ``"fp32"``, ``torch.bfloat16`` for ``"bf16"``."""
    return _STORAGE[_check_precision(precision)]


def precision_bytes(precision: str) -> int:
    """Storage element size in bytes for a precision name (JAX
    ``repro/plan.py::precision_bytes``)."""
    return storage_dtype(precision).itemsize


def round_storage(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` (float32) rounded to the storage type and back to float32: to
    nearest even for bf16 (what the kernels' ``__float2bfloat16_rn`` does),
    ``t`` itself for fp32."""
    if _check_precision(precision) == "fp32":
        return t
    return t.to(torch.bfloat16).to(torch.float32)


def taps_np(cfg: BGConfig) -> np.ndarray:
    return np.asarray(_taps(cfg), dtype=np.float32)


def gc_cells(n: int, r: int) -> np.ndarray:
    """Grid cell of each of ``n`` rows (or columns): round-half-up(i / r),
    in integers."""
    return (2 * np.arange(n) + r) // (2 * r)


def gc_col_onehot(w: int, gy: int, r: int) -> np.ndarray:
    """Constant (w, gy) one-hot: column j -> grid cell round(j/r)."""
    oh = np.zeros((w, gy), np.float32)
    oh[np.arange(w), gc_cells(w, r)] = 1.0
    return oh


def ti_col_fracs(w: int, r: int) -> np.ndarray:
    """TI y lerp fraction of each column: j/r - floor(j/r), float32."""
    return (np.arange(w) / r - np.arange(w) // r).astype(np.float32)


def ti_col_onehots(w: int, gy: int, r: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant TI column maps: floor-cell one-hots for dj=0,1 and y fracs."""
    y0 = np.arange(w) // r
    yf = ti_col_fracs(w, r)
    oh0 = np.zeros((w, gy), np.float32)
    oh0[np.arange(w), y0] = 1.0
    oh1 = np.zeros((w, gy), np.float32)
    oh1[np.arange(w), np.minimum(y0 + 1, gy - 1)] = 1.0
    return oh0, oh1, yf


def gc_row_split(r: int) -> int:
    """Rows [0, c) of a stripe land on plane s; rows [c, r) on plane s+1,
    where c = number of i in [0,r) with round(i/r) == 0."""
    return int(np.sum(gc_cells(r, r) == 0))


def stores_quantized_exactly(cfg: BGConfig, precision: str) -> bool:
    """Whether the storage type of ``precision`` holds every value that
    ``quantize_intensity`` gives on the kernels' output in that type,
    upcast. Always in fp32. In bf16 when ``cfg.intensity_max`` (as float32,
    the clamp's bound) is a bf16 value, as 255 is: a bf16 value of
    magnitude 256 or more is an integer already and quantizes to itself, one
    below quantizes to an integer of magnitude at most 256, and both are
    bf16 values, so only the clamp to the top can leave bf16. Where it
    holds, the fused kernels' quantizing store (``bg_fused(quantize=True)``)
    gives the plan's output bit for bit."""
    top = torch.tensor(cfg.intensity_max, dtype=torch.float32)
    return bool(round_storage(top, precision) == top)
