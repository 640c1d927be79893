"""Real-time video denoising: the temporal bilateral grid and async
multi-stream serving. The port's twin of the JAX package's
``examples/denoise_video.py``.

Three acts:

  1. Temporal grid on a static scene: sweep the EMA weight alpha and show
     the denoised-vs-clean PSNR climbing as the grid accumulates history
     across frames (the anti-flicker effect, measurable as noise
     suppression). Every alpha rides the temporal kernel B2 on the card:
     the EMA blends the blurred grid planes inside the fused GC||GF||TI
     pipeline.
  2. alpha == 0 is the per-frame fused path (B1), bit for bit.
  3. Multi-stream async serving: N panning streams submit frames to the
     AsyncFrameEngine (futures, deadline-aware micro-batching, pinned
     host-to-device feeding); per-stream grids are carried in one stacked
     tensor and each pack, warm and cold streams alike, is one launch.

Run:  PYTHONPATH=src python -m repro_torch.examples.denoise_video
      PYTHONPATH=src python -m repro_torch.examples.denoise_video --device cpu \\
          --height 32 --width 48 --frames 3 --streams 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import BGConfig, psnr
from repro_torch.data import synthetic_video_np
from repro_torch.plan import BGPlan, plan_for
from repro_torch.serving import AsyncFrameEngine
from repro_torch.video import MultiStreamPacker, temporal_denoise


def _noisy(frame: np.ndarray, seed: int) -> np.ndarray:
    """``frame`` + N(0, 30^2), rounded and clipped to 8 bits (numpy, so the
    frames are the same on every device)."""
    noise = np.random.default_rng(seed).normal(0.0, 30.0, frame.shape)
    return np.clip(np.floor(frame + noise + 0.5), 0.0, 255.0).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--frames", type=int, default=10, help="frames per stream")
    ap.add_argument("--streams", type=int, default=4, help="streams served in act 3")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    H, W, n_frames, n_streams = args.height, args.width, args.frames, args.streams
    cfg = BGConfig(r=6, sigma_s=4.0, sigma_r=60.0)

    # ---- 1. temporal accumulation on a static scene --------------------
    clean = synthetic_video_np(0, 1, H, W, motion=0.0)[0]
    clean_t = torch.from_numpy(clean).to(dev)
    noisy = [_noisy(clean, t) for t in range(n_frames)]
    print(f"static {H}x{W} scene, sigma=30 noise, {n_frames} frames, on {dev}:")
    print(f"  noisy input:            psnr {float(psnr(clean_t, torch.from_numpy(noisy[-1]).to(dev))):6.2f} dB")
    static_psnr = {}
    for alpha in (0.0, 0.3, 0.6, 0.8):
        packer = MultiStreamPacker(cfg, device=dev)
        packer.open("cam", alpha=alpha)
        for t in range(n_frames):
            out = packer.pack({"cam": noisy[t]})["cam"]
        static_psnr[alpha] = float(psnr(clean_t, out))
        print(f"  alpha={alpha:<4g} last frame:  psnr {static_psnr[alpha]:6.2f} dB")

    # ---- 2. alpha == 0 is the per-frame fused path, bit-identical ------
    out_t, carry = temporal_denoise(noisy[0], cfg, alpha=0.0, device=dev)
    ref = BGPlan(cfg=cfg, backend="fused", device=dev)(noisy[0])
    alpha0_equal = carry is None and bool(torch.equal(out_t, ref))
    print(f"alpha=0 output bit-identical to the per-frame fused path: {alpha0_equal}")

    # ---- 3. async multi-stream serving ---------------------------------
    traffic = []
    for s in range(n_streams):
        vid = synthetic_video_np(s, n_frames, H, W, motion=1.5)
        traffic.append([_noisy(vid[t], 99 * s + t) for t in range(n_frames)])

    # plan-driven dispatch: plan_for picks the batch tile for the pack
    # geometry; the packer asks the plan for its tile
    video_plan = plan_for(cfg, H, W, n_frames=n_streams, temporal=True, device=dev)
    print(f"video plan: backend={video_plan.backend} batch_tile={video_plan.batch_tile}")

    def fresh_packer():
        p = MultiStreamPacker(plan=video_plan)
        for s in range(n_streams):
            p.open(s, alpha=0.6)
        return p

    # warm-up through a throwaway engine so the timed engine's latency
    # telemetry and temporal stream state start clean
    with AsyncFrameEngine(max_batch=n_streams, packer=fresh_packer()) as warm:
        for f in [warm.submit(traffic[s][0], stream_id=s) for s in range(n_streams)]:
            f.result()

    with AsyncFrameEngine(max_batch=n_streams, batch_window_ms=20.0, packer=fresh_packer()) as eng:
        t0 = time.perf_counter()
        futs = [eng.submit(traffic[s][t], stream_id=s, deadline_ms=500.0)
                for t in range(n_frames) for s in range(n_streams)]
        outs = [f.result() for f in futs]
        dt = time.perf_counter() - t0
        st = eng.stats()
    total = len(outs)
    print(f"async: {n_streams} streams, {total} frames in {dt * 1e3:.0f}ms "
          f"({total / dt:.0f} frames/s) p50={st.latency_ms_p50:.1f}ms "
          f"p99={st.latency_ms_p99:.1f}ms mean_batch={st.mean_batch:.1f} "
          f"deadline_misses={st.deadline_misses}")
    return {"device": str(dev), "static_psnr": static_psnr, "alpha0_equal": alpha0_equal,
            "plan": video_plan.describe(), "served": total, "frames_per_s": total / dt,
            "dispatches": st.dispatches, "failed": st.failed}


if __name__ == "__main__":
    main()
