"""Data pipeline with the paper's BG denoiser as a first-class stage.

This is where the denoiser sits in front of a model: the [vlm] image
frontend and the [audio] spectrogram frontend both run bilateral-grid
denoising before patch/frame embedding. Every stage dispatches through a
:class:`repro_torch.plan.BGPlan` (``plan=``; on the card ``plan_for``'s
plans launch B1 or B3), or through the JAX package's legacy keywords, which
build the equivalent plan: ``cfg=`` alone the ``"reference"`` plan,
``use_kernels=True`` ``"fused"`` (``"fused_streamed"`` with
``stream_input=True``), ``sharded=True`` the fused plan with its batch axis
split over ``mesh`` (default: every card, when the caller wants the card and
more than one is visible; ``repro_torch.sharding``), on ``device`` (the CUDA
card unless ``device="cpu"``). A ``mesh`` without ``sharded=True`` is
ignored, as in the JAX package.

Divergence on purpose from ``repro/data/pipeline.py``:
:func:`patchify_embed`'s default projection is drawn from a CPU
``torch.Generator`` seeded with ``seed`` (the same numbers on every device);
JAX draws it from ``jax.random.normal``, which torch cannot reproduce, so
the same seed gives a different default projection. Pass ``proj=`` (for
example JAX's matrix as a numpy array) to compute what the JAX function
computes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bilateral_grid import BGConfig

__all__ = [
    "denoise_batch",
    "patchify_embed",
    "vlm_preprocess",
    "spectrogram_denoise",
]


def _legacy_plan(cfg: BGConfig, use_kernels: bool, sharded: bool, mesh, stream_input: bool,
                 device):
    """Map the JAX package's legacy keywords onto a plan: reference by
    default, fused with ``use_kernels`` (streamed with ``stream_input``),
    and with ``sharded`` fused over ``mesh``."""
    from repro_torch.plan import BGPlan

    if sharded:
        from repro_torch.sharding.bg_shard import _service_mesh

        backend = "fused_streamed" if stream_input else "fused"
        return BGPlan(cfg=cfg, backend=backend, device=device, mesh=_service_mesh(mesh, device))
    if use_kernels:
        backend = "fused_streamed" if stream_input else "fused"
        return BGPlan(cfg=cfg, backend=backend, device=device)
    return BGPlan(cfg=cfg, backend="reference", device=device)


def denoise_batch(
    images,
    cfg: BGConfig | None = None,
    use_kernels: bool = False,
    sharded: bool = False,
    mesh=None,
    stream_input: bool = False,
    *,
    plan=None,
    device=None,
) -> torch.Tensor:
    """(B, H, W) or color (B, H, W, C) noisy [0,255] -> denoised batch on the
    plan's device.

    Preferred form: ``denoise_batch(images, plan=plan)``; else ``cfg=`` with
    the legacy keywords (module docstring) on ``device``. Color frames are
    denoised per channel: the plan folds the channel axis into the batch
    axis, so each channel gets its own grid."""
    if plan is None:
        if cfg is None:
            raise TypeError("denoise_batch needs cfg= or plan=")
        plan = _legacy_plan(cfg, use_kernels, sharded, mesh, stream_input, device)
    return plan(images)


def patchify_embed(images, patch: int, dim: int, seed: int = 0, *, proj=None,
                   device=None) -> torch.Tensor:
    """(B, H, W) -> (B, n_patches, dim) with a fixed random projection, on
    ``device``: ``proj``, else standard normal numbers from a CPU
    ``torch.Generator`` seeded with ``seed``, scaled by 1/patch (not JAX's
    numbers: module docstring).

    Stands in for the learned patch-embedding of the stubbed vision tower;
    deterministic so tests can assert exact shapes and values.
    """
    images = torch.as_tensor(images, dtype=torch.float32, device=resolve_device(device))
    B, H, W = images.shape
    hp, wp = H // patch, W // patch
    x = images[:, : hp * patch, : wp * patch]
    x = x.reshape(B, hp, patch, wp, patch).permute(0, 1, 3, 2, 4)
    x = x.reshape(B, hp * wp, patch * patch) / 255.0
    if proj is None:
        gen = torch.Generator().manual_seed(seed)
        proj = torch.randn((patch * patch, dim), generator=gen) * (1.0 / np.sqrt(patch * patch))
    proj = torch.as_tensor(proj, dtype=torch.float32, device=images.device)
    return x @ proj


def vlm_preprocess(
    images,
    bg_cfg: BGConfig | None,
    patch: int,
    dim: int,
    denoise: bool = True,
    use_kernels: bool = False,
    sharded: bool = False,
    mesh=None,
    *,
    plan=None,
    proj=None,
    device=None,
) -> torch.Tensor:
    """Full [vlm] frontend stage: BG denoise -> patchify -> project.

    ``plan=`` (or the legacy keywords) picks the denoiser dispatch exactly
    as in :func:`denoise_batch`; the embedding runs on the same device.
    """
    dev = plan.device if plan is not None else resolve_device(device)
    if denoise:
        # the caller's device: "the card" may auto-mesh (sharded=True)
        images = denoise_batch(images, bg_cfg, use_kernels=use_kernels, sharded=sharded,
                               mesh=mesh, plan=plan, device=device)
    return patchify_embed(images, patch, dim, proj=proj, device=dev)


def spectrogram_denoise(
    spec,
    bg_cfg: Optional[BGConfig] = None,
    use_kernels: bool = False,
    sharded: bool = False,
    mesh=None,
    *,
    plan=None,
    device=None,
) -> torch.Tensor:
    """[audio] stage: treat a (B, T, F) spectrogram as images in [0, 255]
    (min-max scaled over the whole batch), denoise, and scale back.

    Forwards ``plan=`` (or the legacy keywords, with the JAX default
    ``BGConfig(r=4, sigma_s=2.0, sigma_r=40.0)``) to :func:`denoise_batch`.
    """
    if plan is None and bg_cfg is None:
        bg_cfg = BGConfig(r=4, sigma_s=2.0, sigma_r=40.0)
    dev = plan.device if plan is not None else resolve_device(device)
    spec = torch.as_tensor(spec, dtype=torch.float32, device=dev)
    lo = torch.min(spec)
    hi = torch.max(spec)
    scaled = (spec - lo) / torch.clamp(hi - lo, min=1e-9) * 255.0
    den = denoise_batch(scaled, bg_cfg, use_kernels=use_kernels, sharded=sharded, mesh=mesh,
                        plan=plan, device=device)
    return den / 255.0 * (hi - lo) + lo
