#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the frame-serving path from this checkout's
sources, holds each against its plain PyTorch version at full-HD shapes,
serves full-HD frames through ``repro_torch.serving.FrameDenoiseEngine`` and
shows with the launch counters that the kernels carried that run, then
times the kernels and the plain versions with CUDA events. Prints one JSON
object per phase; the last line is ``{"ok": true, "device": {...}}``. Any
failed check raises and the script exits non-zero. It needs a CUDA card and
fails without one; it imports nothing of JAX.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
TOL_ABS = 5e-3  # fused vs ref_fused in the JAX package's tests/test_kernels.py
TOL_EXACT = 0.995  # quantized outputs: share of exactly equal pixels
TOL_LSB = 1.0  # quantized outputs: largest difference


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def quantized_agreement(a, b):
    d = (a - b).abs()
    return float((d == 0).float().mean()), float(d.max())


def cuda_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bg_fused_bound(b: int, h: int, w: int, cfg, grid_shape):
    """(bound_ms, bound_by, bytes, flops) of the fused filter on b frames:
    each input read once and each output written once, against the
    operations of separable GC / GF / TI (32 FLOP per pixel: 5 in GC, 27 in
    TI; 33 per grid cell in GF and normalization)."""
    gx, gy, gz = grid_shape(h, w, cfg)
    nbytes = b * h * w * 4 * 2 + (w + cfg.r) * 4
    flops = b * (32 * h * w + 33 * gx * gy * gz)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.bg_denoise import FIG12_SWEEPS, PAPER_DEFAULT, SERVE_CONFIG, TABLE1_SWEEP
    from repro_torch.core import add_gaussian_noise, grid_shape, mssim, psnr, quantize_intensity, synthetic_batch
    from repro_torch.kernels import _build, bg_fused, bg_fused_plain
    from repro_torch.launch.serve import serve_frames
    from repro_torch.plan import BGPlan
    from repro_torch.serving import FrameDenoiseEngine, FrameRequest

    # the plain versions are the fp32 yardstick: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- phase 1: device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build_all(["bg_fused"])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log("bg_fused").splitlines() if "ptxas info" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "device_name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    # ---- phase 2: kernel vs plain on the card, full HD, b=4
    clean = synthetic_batch(8, H, W, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x8 = add_gaussian_noise(clean, 30.0, generator=gen).contiguous()
    x4 = x8[:4].contiguous()
    max_err = 0.0
    cfgs = [("TABLE1 r=%d" % wl.bg.r, wl.bg) for wl in TABLE1_SWEEP] + [("serve r=6", SERVE_CONFIG)]
    for label, cfg in cfgs:
        k = bg_fused(x4, cfg)
        k_again = bg_fused(x4, cfg)
        single = bg_fused(x4[2].contiguous(), cfg)
        b1 = bg_fused(x4[2:3].contiguous(), cfg)
        plain = bg_fused_plain(x4, cfg)
        torch.cuda.synchronize()
        err = float((k - plain).abs().max())
        exact, lsb = quantized_agreement(quantize_intensity(k, cfg), quantize_intensity(plain, cfg))
        row = {"phase": "kernel_vs_plain", "config": label, "shape": list(x4.shape),
               "max_abs_err": err, "quantized_exact": exact, "quantized_max_diff": lsb,
               "repeat_bitwise": bool(torch.equal(k, k_again)),
               "b1_bitwise_single": bool(torch.equal(b1[0], single)),
               "batch_row_bitwise_single": bool(torch.equal(k[2], single))}
        emit(row)
        check(k.shape == x4.shape and bool(torch.isfinite(k).all()), f"{label}: shape/finite")
        check(err <= TOL_ABS, f"{label}: max |kernel - plain| {err} > {TOL_ABS}")
        check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"{label}: quantized {exact}, {lsb}")
        check(row["repeat_bitwise"] and row["b1_bitwise_single"] and row["batch_row_bitwise_single"],
              f"{label}: bitwise contracts")
        max_err = max(max_err, err)
    too_big = FIG12_SWEEPS["r"][0]  # r=2 at full HD: the working set exceeds shared memory
    try:
        bg_fused(x4[:1].contiguous(), too_big)
    except ValueError as e:
        check("bytes" in str(e), "r=2 error names the bytes")
        emit({"phase": "kernel_vs_plain", "config": "FIG12 r=2", "raised": str(e)})
    else:
        raise RuntimeError("chip_smoke check failed: r=2 at full HD did not raise")

    # ---- phase 3: the slice, through the engine a user calls
    n_req, max_batch = 19, 8
    cfg = PAPER_DEFAULT.bg
    clean_h = synthetic_batch(n_req, H, W, seed=100, device="cpu")
    noisy_h = add_gaussian_noise(clean_h, 30.0, generator=torch.Generator().manual_seed(2))
    frames = noisy_h.numpy()
    eng = FrameDenoiseEngine(plan=BGPlan(cfg, backend="fused", device="cuda"), max_batch=max_batch)
    bg_fused.launches = 0
    for i in range(n_req):
        eng.submit(FrameRequest(uid=i, frame=frames[i]))
    done, dispatches = [], 0
    while eng.pending():
        done.extend(eng.step())
        dispatches += 1
    torch.cuda.synchronize()
    launches = bg_fused.launches
    check(len(done) == n_req and [r.uid for r in done] == list(range(n_req)), "every request answered in order")
    check(all(r.result.is_cuda and tuple(r.result.shape) == (H, W) for r in done), "results are CUDA (h, w) tensors")
    check(dispatches == 3 and launches == dispatches, f"{launches} launches for {dispatches} dispatches")
    out = torch.stack([r.result for r in done])
    check(bool(torch.isfinite(out).all()), "finite output")
    ref = BGPlan(cfg, backend="reference", device="cuda")(frames)
    exact, lsb = quantized_agreement(out, ref)
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"fused vs reference backend: {exact}, {lsb}")
    clean_d, noisy_d = clean_h.to(dev), noisy_h.to(dev)
    q = {k: sum(float(fn(a, c)) for a, c in zip(src, clean_d)) / n_req
         for k, fn, src in (("psnr_denoised", psnr, out), ("psnr_noisy", psnr, noisy_d),
                            ("mssim_denoised", mssim, out), ("mssim_noisy", mssim, noisy_d))}
    emit({"phase": "slice", "requests": n_req, "max_batch": max_batch, "dispatches": dispatches,
          "bg_fused_launches": launches, "vs_reference_exact": exact, "vs_reference_max_diff": lsb, **q})
    check(q["psnr_denoised"] > q["psnr_noisy"] and q["mssim_denoised"] > q["mssim_noisy"],
          "denoising improves PSNR and MSSIM")

    # ---- phase 4: times at b=8, PAPER_DEFAULT, CUDA events
    k8 = bg_fused(x8, cfg)
    p8 = bg_fused_plain(x8, cfg)
    err8 = float((k8 - p8).abs().max())
    check(err8 <= TOL_ABS, f"b=8: max |kernel - plain| {err8}")
    max_err = max(max_err, err8)
    ms = cuda_ms(torch, lambda: bg_fused(x8, cfg), reps=50)
    plain_ms = cuda_ms(torch, lambda: bg_fused_plain(x8, cfg), reps=5, warmup=1)
    b = x8.shape[0]
    bound_ms, bound_by, nbytes, flops = bg_fused_bound(b, H, W, cfg, grid_shape)
    emit({"kernels": [{
        "name": "bg_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bg_fused.cu",
        "replaces": "src/repro/kernels/bg_fused.py:645",
        "launches": launches, "dispatches": dispatches,
        "launches_per_dispatch": launches / dispatches,
        "max_abs_err": max_err, "tolerance": TOL_ABS,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "ms_per_frame": ms / b, "plain_ms_per_frame": plain_ms / b, "bound_ms_per_frame": bound_ms / b,
        "bytes": nbytes, "flops": flops, "timed_shape": [b, H, W], "config": "PAPER_DEFAULT",
        "card": smi,
    }]})
    # stripes per block: the wrapper's rule against the alternatives
    kmod = importlib.import_module("repro_torch.kernels.bg_fused")
    out8 = torch.empty_like(x8)
    for label, sweep_cfg in (("PAPER_DEFAULT", cfg), ("serve r=6", SERVE_CONFIG)):
        ms_by_band = {
            band: cuda_ms(torch, lambda: kmod._launch(x8, out8, sweep_cfg, band), reps=20) / b
            for band in (1, 2, 4, 8)
        }
        props = torch.cuda.get_device_properties(0)
        rule = kmod.launch_geometry(b, H, W, sweep_cfg, props.multi_processor_count,
                                    kmod._device_limits(0)[1])[0]
        emit({"phase": "band_sweep", "config": label, "batch": b, "default_stripes": rule,
              "ms_per_frame_by_stripes_per_block": ms_by_band, "card": smi})
    stats = serve_frames(32, H, W, micro_batch=max_batch, config="paper-default", device="cuda")
    emit({"phase": "serve", "config": "PAPER_DEFAULT", "frame_hw": [H, W], "card": smi, **stats})

    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
