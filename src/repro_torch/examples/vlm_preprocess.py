"""The paper's technique as an LM-framework feature: BG denoising as the
[vlm] image-frontend preprocessing stage, feeding patch embeddings to the
llama-3.2-vision cross-attention layers. The port's twin of the JAX
package's ``examples/vlm_preprocess.py``: the denoiser is the plan
``plan_for`` picks (on the card the fused kernel B1, or the streamed
kernel B3), the model the port's, on its own seeded parameters.

Run:  PYTHONPATH=src python -m repro_torch.examples.vlm_preprocess
      PYTHONPATH=src python -m repro_torch.examples.vlm_preprocess --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import BGConfig, add_gaussian_noise, mssim, synthetic_batch
from repro_torch.data import denoise_batch, vlm_preprocess
from repro_torch.models import forward, init_params
from repro_torch.plan import plan_for


def main(argv=None, *, proj=None, params=None) -> dict:
    """Runs the example; returns its numbers and tensors. ``proj`` (the
    patch projection, ``(patch**2, d_model)``) and ``params`` (the model's)
    replace the port's seeded ones: the tests carry the JAX package's over."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=126, help="square image side (9x9 patches of 14)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("llama-3.2-vision-11b")
    B, patch, h = 2, 14, args.size

    clean = synthetic_batch(B, h, h, seed=0, device=dev)
    noisy = add_gaussian_noise(clean, 30.0, generator=torch.Generator(device=dev).manual_seed(0))
    bg = BGConfig(r=4, sigma_s=3.0, sigma_r=50.0)

    # the denoiser dispatch is a plan: backend and batch tile from plan_for
    bg_plan = plan_for(bg, h, h, n_frames=B, device=dev)

    ctx_noisy = vlm_preprocess(noisy, bg, patch, cfg.d_model, denoise=False, proj=proj, device=dev)
    ctx_clean = vlm_preprocess(clean, bg, patch, cfg.d_model, denoise=False, proj=proj, device=dev)
    # the frames kept, so that a caller can hold them to another plan's
    denoised = denoise_batch(noisy, plan=bg_plan)
    ctx_denoised = vlm_preprocess(denoised, bg, patch, cfg.d_model, denoise=False, proj=proj, device=dev)
    # denoising must pull patch embeddings toward the clean ones
    d_noisy = float(torch.mean(torch.abs(ctx_noisy - ctx_clean)))
    d_denoised = float(torch.mean(torch.abs(ctx_denoised - ctx_clean)))
    print(f"patch-embedding distance to clean: noisy {d_noisy:.4f} -> BG-denoised {d_denoised:.4f} "
          f"(plan {bg_plan.backend}, on {dev})")
    noisy_mssim = [float(mssim(clean[i], noisy[i])) for i in range(B)]
    for i, m in enumerate(noisy_mssim):
        print(f"  image {i} MSSIM noisy vs clean: {m:.3f}")

    # pad/trim context to the smoke config's cross_attn token count
    n = cfg.cross_attn_tokens
    ctx = ctx_denoised[:, :n]
    if ctx.shape[1] < n:
        ctx = F.pad(ctx, (0, 0, 0, n - ctx.shape[1]))

    params = init_params(0, cfg, device=dev) if params is None else params
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 12))).to(dev)
    logits, _, _ = forward(params, cfg, tokens=tokens, cross_ctx=ctx, mode="train")
    finite = bool(torch.isfinite(logits).all())
    print(f"VLM forward with BG-denoised image context: logits {tuple(logits.shape)}, finite={finite}")
    return {"d_noisy": d_noisy, "d_denoised": d_denoised, "noisy_mssim": noisy_mssim,
            "backend": bg_plan.backend, "bg": bg, "denoised": denoised, "logits_shape": tuple(logits.shape), "finite": finite,
            "noisy": noisy, "ctx": ctx, "tokens": tokens, "logits": logits, "device": str(dev)}


if __name__ == "__main__":
    main()
