"""Frame-serving launcher: stream synthetic noisy frames through the
micro-batching frame engine on one device.

    python -m repro_torch.launch.serve --frames 32 --frame-hw 1080x1920 \\
        --micro-batch 8 --config paper-default
    python -m repro_torch.launch.serve --frames 4 --frame-hw 48x64 --device cpu

The JAX launcher's ``--video``, ``--workers`` and LM modes are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

CONFIGS = ("serve", "paper-default")


def serve_frames(
    frames: int,
    height: int,
    width: int,
    micro_batch: int = 8,
    config: str = "serve",
    device=None,
) -> dict:
    """Serve ``frames`` synthetic noisy frames (made on the host, as clients
    would send them) and return ``{"frames", "seconds", "frames_per_s",
    "dispatches", "device"}``. The timed loop starts after one warm-up
    micro-batch and ends when the last result is on hand
    (``torch.cuda.synchronize`` on a card)."""
    from repro_torch.configs.bg_denoise import PAPER_DEFAULT, SERVE_CONFIG
    from repro_torch.core import add_gaussian_noise, synthetic_batch
    from repro_torch.plan import BGPlan
    from repro_torch.serving import FrameDenoiseEngine, FrameRequest

    if config not in CONFIGS:
        raise ValueError(f"config must be one of {CONFIGS}, got {config!r}")
    cfg = PAPER_DEFAULT.bg if config == "paper-default" else SERVE_CONFIG
    plan = BGPlan(cfg=cfg, backend="fused", device=device)
    eng = FrameDenoiseEngine(plan=plan, max_batch=micro_batch)
    clean = synthetic_batch(frames, height, width, seed=0, device="cpu")
    noisy = add_gaussian_noise(
        clean, 30.0, generator=torch.Generator().manual_seed(1)
    ).numpy()

    def sync():
        if plan.device.type == "cuda":
            torch.cuda.synchronize(plan.device)

    for i in range(min(micro_batch, frames)):  # warm-up: kernel build + first launch
        eng.submit(FrameRequest(uid=-1 - i, frame=noisy[i]))
    eng.flush()
    sync()

    t0 = time.perf_counter()
    done, dispatches = [], 0
    for i in range(frames):
        eng.submit(FrameRequest(uid=i, frame=noisy[i]))
        if eng.pending() >= eng.max_batch:
            done.extend(eng.step())
            dispatches += 1
    while eng.pending():
        done.extend(eng.step())
        dispatches += 1
    sync()
    dt = time.perf_counter() - t0
    if len(done) != frames or any(r.result is None for r in done):
        raise RuntimeError(f"served {len(done)} of {frames} frames")
    return {
        "frames": frames,
        "seconds": dt,
        "frames_per_s": frames / dt,
        "dispatches": dispatches,
        "device": str(plan.device),
        "plan": plan.describe(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, required=True, help="frames to serve")
    ap.add_argument("--frame-hw", default="96x128", help="frame size HxW")
    ap.add_argument("--micro-batch", type=int, default=8, help="frames per dispatch")
    ap.add_argument("--config", choices=CONFIGS, default="serve",
                    help="grid config: the JAX launcher's serve grid (r=6) "
                    "or the paper's full-HD default (r=12)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    h, w = (int(x) for x in args.frame_hw.split("x"))
    stats = serve_frames(args.frames, h, w, args.micro_batch, args.config, args.device)
    print(
        f"[serve] {stats['frames']} frames {h}x{w} on {stats['device']} "
        f"in {stats['seconds']:.3f}s ({stats['frames_per_s']:.1f} frames/s, "
        f"{stats['dispatches']} dispatches, plan[{stats['plan']}])"
    )


if __name__ == "__main__":
    main()
