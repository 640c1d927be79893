"""Data-pipeline stages and synthetic data of the port."""
from .pipeline import denoise_batch
from .synthetic import synthetic_video, synthetic_video_np

__all__ = ["denoise_batch", "synthetic_video", "synthetic_video_np"]
