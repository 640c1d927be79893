"""Quickstart: denoise an image with the variable-window bilateral grid.

Reproduces the paper's core comparison on a synthetic scene: noisy input ->
BG-denoised vs exact-BF-denoised, MSSIM against the clean original, plus the
shift-only (pow2) arithmetic mode, the fused CUDA kernel (B1) and the plan
``plan_for`` picks; then the window-radius sweep, whose cost should stay
flat. The port's twin of the JAX package's ``examples/quickstart.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu \\
          --height 64 --width 96 --radii 4,8
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core import (
    BGConfig,
    add_gaussian_noise,
    bilateral_filter,
    bilateral_grid_filter,
    bilateral_grid_filter_fixed,
    mssim,
    psnr,
    synthetic_image,
)
from repro_torch.kernels import bilateral_grid_filter_pallas
from repro_torch.plan import plan_for


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--radii", default="4,8,12,16", help="radii of the sweep")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per radius")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    clean = synthetic_image(h, w, device=dev)
    noisy = add_gaussian_noise(clean, 30.0, generator=torch.Generator(device=dev).manual_seed(0))
    cfg = BGConfig(r=7, sigma_s=4.0, sigma_r=50.0)

    # every dispatch decision (backend, batch tile, input streaming) lives in
    # one plan; see repro_torch.plan
    plan = plan_for(cfg, h, w, n_frames=1, device=dev)

    results = {
        "noisy input": noisy,
        "exact BF (paper's baseline)": bilateral_filter(noisy, 7, 4.0, 50.0, device=dev),
        "BG (this paper)": bilateral_grid_filter(noisy, cfg),
        "BG pow2/shift-only": bilateral_grid_filter_fixed(
            noisy, BGConfig(r=7, sigma_s=4.0, sigma_r=50.0, weight_mode="pow2"), device=dev
        ),
        "BG fused kernel (B1)": bilateral_grid_filter_pallas(noisy, cfg, device=dev),
        f"BG plan ({plan.backend}, {plan.provenance})": plan(noisy),
    }
    quality = {name: (float(mssim(clean, img)), float(psnr(clean, img)))
               for name, img in results.items()}
    print(f"on {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'CPU'}):")
    print(f"{'variant':34s} {'MSSIM':>8s} {'PSNR':>8s}")
    for name, (m, p) in quality.items():
        print(f"{name:34s} {m:8.4f} {p:8.2f}")

    # the paper's headline property: per-pixel cost independent of r
    print("\nwindow-radius sweep (cost should stay flat):")
    sweep = {}
    for r in (int(v) for v in args.radii.split(",")):
        c = BGConfig(r=r, sigma_s=8.0, sigma_r=70.0)
        bilateral_grid_filter(noisy, c)  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = bilateral_grid_filter(noisy, c)
        _sync(dev)
        dt = (time.perf_counter() - t0) / args.reps
        sweep[r] = (dt * 1e9 / (h * w), float(mssim(clean, out)))
        print(f"  r={r:2d}: {sweep[r][0]:7.2f} ns/pixel   MSSIM {sweep[r][1]:.4f}")
    return {"device": str(dev), "plan": plan.describe(), "quality": quality, "sweep": sweep}


if __name__ == "__main__":
    main()
