"""Data-pipeline stages and synthetic data of the port."""
from .pipeline import (
    denoise_batch,
    patchify_embed,
    spectrogram_denoise,
    vlm_preprocess,
)
from .synthetic import (
    TokenStream,
    audio_frames,
    lm_batches,
    synthetic_video,
    synthetic_video_np,
    vision_context,
)

__all__ = [
    "TokenStream",
    "lm_batches",
    "denoise_batch",
    "patchify_embed",
    "vlm_preprocess",
    "spectrogram_denoise",
    "synthetic_video",
    "synthetic_video_np",
    "vision_context",
    "audio_frames",
]
