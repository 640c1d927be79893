"""Data-pipeline stages of the port."""
from .pipeline import denoise_batch

__all__ = ["denoise_batch"]
