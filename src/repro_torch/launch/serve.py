"""Frame- and video-serving launcher: stream synthetic noisy frames through
the micro-batching frame engine, or synthetic video streams through the
async engine and the multi-stream packer, on one device.

    python -m repro_torch.launch.serve --frames 32 --frame-hw 1080x1920 \\
        --micro-batch 8 --config paper-default
    python -m repro_torch.launch.serve --frames 4 --frame-hw 48x64 --device cpu
    python -m repro_torch.launch.serve --frames 32 --frame-hw 1080x1920 \\
        --config paper-default --stream-input
    python -m repro_torch.launch.serve --video 4 --video-frames 24 \\
        --frame-hw 1080x1920 --alpha 0.6 --config paper-default
    python -m repro_torch.launch.serve --video 2 --video-frames 3 \\
        --frame-hw 36x48 --device cpu

Both modes build their plan with ``plan_for`` (the JAX launcher's route):
the measured-plan cache, else the cost model, picks backend and batch tile
(fp32; ``--stream-input`` pins ``"fused_streamed"``), and the printed
``plan[...]`` names the route it came from (``src=cache``, ``src=model`` or
``src=explicit``). The frame mode asks for a micro-batch of
``--micro-batch`` frames, where the JAX launcher leaves the pack size open.
The JAX launcher's ``--workers`` and LM modes are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

CONFIGS = ("serve", "paper-default")


def serve_frames(
    frames: int,
    height: int,
    width: int,
    micro_batch: int = 8,
    config: str = "serve",
    device=None,
    stream_input: bool | None = None,
) -> dict:
    """Serve ``frames`` synthetic noisy frames (made on the host, as clients
    would send them) through the plan ``plan_for`` gives for micro-batches
    of ``micro_batch`` frames, and return ``{"frames",
    "seconds", "frames_per_s", "dispatches", "backend", "batch_tile",
    "provenance", "bg_fused_launches", "bg_fused_streamed_launches",
    "device", "plan"}``, the launches counted over the timed run.
    ``stream_input`` goes to ``plan_for`` as it is: ``None`` lets the plan
    layer choose, ``True`` (the JAX launcher's ``--stream-input``) pins
    ``"fused_streamed"``, ``False`` pins ``"fused"``. The timed loop starts
    after one warm-up micro-batch and ends when the last result is on hand
    (``torch.cuda.synchronize`` on a card)."""
    from repro_torch.configs.bg_denoise import PAPER_DEFAULT, SERVE_CONFIG
    from repro_torch.core import add_gaussian_noise, synthetic_batch
    from repro_torch.kernels import bg_fused
    from repro_torch.plan import plan_for
    from repro_torch.serving import FrameDenoiseEngine, FrameRequest

    if config not in CONFIGS:
        raise ValueError(f"config must be one of {CONFIGS}, got {config!r}")
    cfg = PAPER_DEFAULT.bg if config == "paper-default" else SERVE_CONFIG
    plan = plan_for(cfg, height, width, n_frames=micro_batch, stream_input=stream_input, device=device)
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

    b1, b3 = bg_fused.launches, bg_fused.streamed_launches
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
        "backend": plan.backend,
        "batch_tile": plan.batch_tile,
        "provenance": plan.provenance,
        "bg_fused_launches": bg_fused.launches - b1,
        "bg_fused_streamed_launches": bg_fused.streamed_launches - b3,
        "device": str(plan.device),
        "plan": plan.describe(),
    }


def serve_video(
    streams: int,
    frames_per_stream: int,
    height: int,
    width: int,
    alpha: float,
    fps: float = 0.0,
    deadline_ms: float | None = None,
    batch_window_ms: float = 5.0,
    config: str = "serve",
    device=None,
) -> dict:
    """Serve ``streams`` synthetic noisy video streams of
    ``frames_per_stream`` frames each through ``AsyncFrameEngine`` +
    ``MultiStreamPacker`` (the JAX launcher's ``serve_video``), every stream
    at ``alpha``, at ``fps`` frames per second per stream (0: as fast as
    they are taken), each request with a ``deadline_ms`` budget (None: no
    deadline). The traffic is made on the host first, as clients would
    send it; one pack through a throwaway engine warms the kernels up.

    The plan is ``plan_for``'s for packs of ``streams`` temporal frames.
    Returns frames/s, fps per stream, p50/p99 latency (submit to
    completion), dispatches, mean batch, deadline misses, shed and failed
    requests, the engine's retries, fallbacks and watchdog trips, and the
    per-frame (B1) and temporal (B2) kernel launches of the timed run."""
    from repro_torch.configs.bg_denoise import PAPER_DEFAULT, SERVE_CONFIG
    from repro_torch.data import synthetic_video_np
    from repro_torch.kernels import bg_fused
    from repro_torch.plan import plan_for
    from repro_torch.serving import AsyncFrameEngine
    from repro_torch.video import MultiStreamPacker

    if config not in CONFIGS:
        raise ValueError(f"config must be one of {CONFIGS}, got {config!r}")
    cfg = PAPER_DEFAULT.bg if config == "paper-default" else SERVE_CONFIG
    rng = np.random.default_rng(0)
    traffic = []
    for s in range(streams):
        vid = synthetic_video_np(s, frames_per_stream, height, width, motion=1.5)
        noisy = vid + rng.normal(0.0, 30.0, vid.shape)
        traffic.append(np.clip(np.floor(noisy + 0.5), 0.0, 255.0).astype(np.float32))
    plan = plan_for(cfg, height, width, n_frames=streams, temporal=True, device=device)

    def engine():
        packer = MultiStreamPacker(plan=plan)
        for s in range(streams):
            packer.open(s, alpha=alpha)
        return AsyncFrameEngine(max_batch=streams, batch_window_ms=batch_window_ms, packer=packer)

    # warm-up through a throwaway engine: the kernel build and first
    # launches stay out of the timed run's telemetry and stream state
    with engine() as warm:
        for f in [warm.submit(traffic[s][0], stream_id=s) for s in range(streams)]:
            f.result()

    period = 1.0 / fps if fps else 0.0
    b1, b2 = bg_fused.launches, bg_fused.temporal_launches
    with engine() as eng:
        t0 = time.monotonic()
        for t in range(frames_per_stream):
            if period:
                pause = t0 + t * period - time.monotonic()
                if pause > 0:
                    time.sleep(pause)
            for s in range(streams):
                eng.submit(traffic[s][t], stream_id=s, deadline_ms=deadline_ms)
        eng.flush()  # failures are counted in the engine's stats
        dt = time.monotonic() - t0
        st = eng.stats()
    total = streams * frames_per_stream
    return {
        "streams": streams,
        "frames": total,
        "seconds": dt,
        "frames_per_s": total / dt,
        "fps_per_stream": total / dt / streams,
        "latency_ms_p50": st.latency_ms_p50,
        "latency_ms_p99": st.latency_ms_p99,
        "dispatches": st.dispatches,
        "mean_batch": st.mean_batch,
        "deadline_misses": st.deadline_misses,
        "shed": st.shed,
        "failed": st.failed,
        "retries": st.retries,
        "fallbacks": st.fallbacks,
        "watchdog_trips": st.watchdog_trips,
        "bg_fused_launches": bg_fused.launches - b1,
        "bg_fused_temporal_launches": bg_fused.temporal_launches - b2,
        "device": str(plan.device),
        "plan": plan.describe(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--frames", type=int, help="frames to serve")
    mode.add_argument("--video", type=int, help="video streams to serve")
    ap.add_argument("--video-frames", type=int, default=16, help="frames per stream")
    ap.add_argument("--alpha", type=float, default=0.6, help="temporal EMA weight per stream")
    ap.add_argument("--fps", type=float, default=0.0, help="frames/s per stream (0: max)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="latency budget per video frame (0: none)")
    ap.add_argument("--batch-window-ms", type=float, default=5.0, help="video batch window")
    ap.add_argument("--frame-hw", default="96x128", help="frame size HxW")
    ap.add_argument("--micro-batch", type=int, default=8, help="frames per dispatch")
    ap.add_argument("--stream-input", action="store_true",
                    help="serve frames through the streamed fused kernel (each "
                    "frame read once through a ring of rows in shared memory)")
    ap.add_argument("--config", choices=CONFIGS, default="serve",
                    help="grid config: the JAX launcher's serve grid (r=6) "
                    "or the paper's full-HD default (r=12)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    h, w = (int(x) for x in args.frame_hw.split("x"))
    if args.video is not None:
        st = serve_video(
            args.video, args.video_frames, h, w, args.alpha, args.fps,
            args.deadline_ms or None, args.batch_window_ms, args.config, args.device,
        )
        print(
            f"[serve] video: {st['frames']} frames ({st['streams']} streams) {h}x{w} "
            f"on {st['device']} in {st['seconds']:.3f}s ({st['frames_per_s']:.1f} "
            f"frames/s, {st['fps_per_stream']:.1f} fps/stream) "
            f"p50={st['latency_ms_p50']:.1f}ms p99={st['latency_ms_p99']:.1f}ms "
            f"dispatches={st['dispatches']} mean_batch={st['mean_batch']:.1f} "
            f"deadline_misses={st['deadline_misses']} shed={st['shed']} "
            f"failed={st['failed']} retries={st['retries']} fallbacks={st['fallbacks']} "
            f"watchdog_trips={st['watchdog_trips']} launches b1={st['bg_fused_launches']} "
            f"b2={st['bg_fused_temporal_launches']} plan[{st['plan']}]"
        )
        return
    stats = serve_frames(
        args.frames, h, w, args.micro_batch, args.config, args.device,
        True if args.stream_input else None,
    )
    print(
        f"[serve] {stats['frames']} frames {h}x{w} on {stats['device']} "
        f"in {stats['seconds']:.3f}s ({stats['frames_per_s']:.1f} frames/s, "
        f"{stats['dispatches']} dispatches, launches b1={stats['bg_fused_launches']} "
        f"b3={stats['bg_fused_streamed_launches']}, plan[{stats['plan']}])"
    )


if __name__ == "__main__":
    main()
