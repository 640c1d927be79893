"""Serving launcher: stream synthetic noisy frames through the
mesh-divisible micro-batching frame engine, or synthetic video streams
through the async engine and the multi-stream packer, sharded over every
local card (one card: the plain single-device plan); ``--workers N`` fronts
the video streams with a ``repro_torch.fleet.FleetRouter`` over N workers
instead of one bare engine; ``--arch`` serves LM requests through the
continuous-batching ``ServeEngine`` (the JAX launcher's LM mode).

    python -m repro_torch.launch.serve --frames 32 --frame-hw 1080x1920 \\
        --micro-batch 8 --config paper-default
    python -m repro_torch.launch.serve --frames 4 --frame-hw 48x64 --device cpu
    python -m repro_torch.launch.serve --frames 32 --frame-hw 1080x1920 \\
        --config paper-default --stream-input
    python -m repro_torch.launch.serve --video 4 --video-frames 24 \\
        --frame-hw 1080x1920 --alpha 0.6 --config paper-default
    python -m repro_torch.launch.serve --video 2 --video-frames 3 \\
        --frame-hw 36x48 --device cpu
    python -m repro_torch.launch.serve --video 4 --workers 2 \\
        --worker-backend subprocess --frame-hw 1080x1920
    python -m repro_torch.launch.serve --arch yi-6b
    python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu

Both modes build their plan with ``plan_for`` (the JAX launcher's route):
the measured-plan cache, else the cost model, picks backend and batch tile
(fp32; ``--stream-input`` pins ``"fused_streamed"``), and the printed
``plan[...]`` names the route it came from (``src=cache``, ``src=model`` or
``src=explicit``) and its mesh size (``mesh=N``: ``plan_for`` meshes the
batch axis over every card when the device is the card, ``--device cuda``,
and more than one is visible, as the JAX launcher meshes over every local
device). The options the two launchers share have the JAX
launcher's defaults (``--micro-batch 16``, ``--video-frames 24``, ...), so
one command serves the same traffic in both. The frame mode gives
``plan_for`` the pack size, ``n_frames=--micro-batch``, where the JAX
launcher leaves it open.
The fleet mode's plan comes from a ``PlanController`` (``plan_for`` for
each worker's share of the streams), as in the JAX launcher.

The LM mode serves ``--requests`` requests (the JAX launcher's mix: request
i's prompt is ``(7 i + j) mod vocab`` for ``j < 4 + i mod 5``) of
``--max-tokens`` tokens each through ``--slots`` slots of ``--max-len``
tokens, on the port's own seeded parameters, or with ``--ckpt-dir`` on the
parameters of that directory's latest checkpoint (written by either
package's trainer), as the JAX launcher restores them.
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
    micro_batch: int = 16,
    config: str = "serve",
    device=None,
    stream_input: bool | None = None,
) -> dict:
    """Serve ``frames`` synthetic noisy frames (made on the host, as clients
    would send them) through the plan ``plan_for`` gives for micro-batches
    of ``micro_batch`` frames, and return ``{"frames",
    "seconds", "frames_per_s", "dispatches", "backend", "batch_tile",
    "provenance", "n_devices", "micro_batch", "bg_fused_launches",
    "bg_fused_streamed_launches", "device", "plan"}``, the launches counted
    over the timed run (one per shard and tile on a mesh), ``micro_batch``
    the engine's, rounded to a multiple of the mesh's ``n_devices``.
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
    while eng.pending():  # the ragged tail, forced (the mesh pads it)
        done.extend(eng.step(force=True))
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
        "n_devices": eng.n_devices,
        "micro_batch": eng.max_batch,
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
    requests, the engine's retries, fallbacks and watchdog trips, the
    per-frame (B1) and temporal (B2) kernel launches of the timed run, and
    the plan's ``mesh_size``."""
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
        "mesh_size": plan.mesh_size,
        "device": str(plan.device),
        "plan": plan.describe(),
    }


def serve_fleet(
    streams: int,
    frames_per_stream: int,
    height: int,
    width: int,
    alpha: float,
    workers: int,
    worker_backend: str = "local",
    fps: float = 0.0,
    deadline_ms: float | None = None,
    batch_window_ms: float = 5.0,
    config: str = "serve",
    device=None,
) -> dict:
    """Serve the traffic of :func:`serve_video` through a
    ``repro_torch.fleet.FleetRouter`` over ``workers`` workers (the JAX
    launcher's ``serve_fleet``): thread-hosted (``worker_backend="local"``)
    or one child process each (``"subprocess"``, behind the socket codec
    with heartbeats and warm-carry snapshots). One controller-resolved plan
    for the whole fleet (``plan_for`` for each worker's share of the
    streams), sticky stream affinity, fleet-level admission and
    backpressure. The traffic is made on the host first; one frame per
    stream through the router warms the workers up outside the timed
    window (it is in the workers' lifetime stats, as in the JAX launcher).

    Returns frames/s, fps per stream, the p50/p99 latency merged from the
    workers' reservoirs (the JAX launcher's; warm-up included, and a
    child's reservoir ends where its engine resolves, before the wire),
    the client's p50/p99 over the timed window (submit to the router's
    future resolving, the wire included), dispatches, mean batch, the
    deadline-miss rate, the router's shed count, workers alive, the merged
    failed, shed, retries, fallbacks and watchdog trips, and
    ``worker_launches``: each
    worker's lifetime kernel launches by counter (an in-process worker's
    engine threads', a child's process counters over the stats RPC), and
    for subprocess workers ``worker_wire``, each child's result-thread
    seconds (``SubprocessWorker.wire``)."""
    from repro_torch.configs.bg_denoise import PAPER_DEFAULT, SERVE_CONFIG
    from repro_torch.data import synthetic_video_np
    from repro_torch.fleet import FleetRouter, PlanController

    if config not in CONFIGS:
        raise ValueError(f"config must be one of {CONFIGS}, got {config!r}")
    cfg = PAPER_DEFAULT.bg if config == "paper-default" else SERVE_CONFIG
    rng = np.random.default_rng(0)
    traffic = []
    for s in range(streams):
        vid = synthetic_video_np(s, frames_per_stream, height, width, motion=1.5)
        noisy = vid + rng.normal(0.0, 30.0, vid.shape)
        traffic.append(np.clip(np.floor(noisy + 0.5), 0.0, 255.0).astype(np.float32))
    per_worker = max(1, -(-streams // workers))
    controller = PlanController(cfg=cfg, height=height, width=width,
                                streams_per_worker=per_worker, temporal=True, device=device)
    dev = controller.plan.device
    router = FleetRouter(
        controller=controller,
        n_workers=workers,
        worker_backend=worker_backend,
        worker_kwargs=dict(device=str(dev), max_batch=per_worker,
                           batch_window_ms=batch_window_ms),
    )
    period = 1.0 / fps if fps else 0.0
    try:
        for s in range(streams):
            router.open_stream(s, alpha=alpha)
        for f in [router.submit(traffic[s][0], stream_id=s) for s in range(streams)]:
            f.result()
        router.flush()
        t0 = time.monotonic()
        futs, client = [], []

        def on_done(_f, t_sub):
            client.append(time.monotonic() - t_sub)

        for t in range(frames_per_stream):
            if period:
                pause = t0 + t * period - time.monotonic()
                if pause > 0:
                    time.sleep(pause)
            for s in range(streams):
                t_sub = time.monotonic()
                fut = router.submit(traffic[s][t], stream_id=s, deadline_ms=deadline_ms)
                fut.add_done_callback(lambda f, t_sub=t_sub: on_done(f, t_sub))
                futs.append(fut)
        for f in futs:
            try:
                f.result()
            except Exception:
                pass  # failures are counted in the workers' stats
        dt = time.monotonic() - t0
        st = router.stats()
        # a dead child's counters went with it
        alive = [w for w in router.workers if not router.is_dead(w.wid)]
        launches = {w.wid: w.launches() for w in alive}
        wire = {w.wid: w.wire() for w in alive if hasattr(w, "wire")}
    finally:
        router.close()
    total = streams * frames_per_stream
    m = st.merged
    client = sorted(client)

    def pct(q):  # EngineStats' estimator
        return client[min(int(q * len(client)), len(client) - 1)] * 1e3

    return {
        "streams": streams,
        "frames": total,
        "workers": workers,
        "worker_backend": worker_backend,
        "seconds": dt,
        "frames_per_s": total / dt,
        "fps_per_stream": total / dt / streams,
        "latency_ms_p50": m.latency_ms_p50,
        "latency_ms_p99": m.latency_ms_p99,
        "client_latency_ms_p50": pct(0.50),
        "client_latency_ms_p99": pct(0.99),
        "dispatches": m.dispatches,
        "mean_batch": m.mean_batch,
        "deadline_miss_rate": st.deadline_miss_rate,
        "router_shed": st.router_shed,
        "workers_alive": st.workers_alive,
        "failed": m.failed,
        "shed": m.shed,
        "retries": m.retries,
        "fallbacks": m.fallbacks,
        "watchdog_trips": m.watchdog_trips,
        "worker_launches": launches,
        "worker_wire": wire,
        "mesh_size": controller.plan.mesh_size,
        "device": str(dev),
        "plan": controller.plan.describe(),
        "plan_hash": controller.plan_hash,
    }


def serve_lm(
    arch: str,
    smoke: bool = False,
    slots: int = 4,
    max_len: int = 256,
    requests: int = 8,
    max_tokens: int = 16,
    device=None,
    ckpt_dir: str | None = None,
    warmup: int = 0,
) -> dict:
    """Serve ``requests`` LM requests of ``arch`` (its smoke config with
    ``smoke``) through ``ServeEngine`` with ``slots`` slots of ``max_len``
    tokens, on parameters drawn from seed 0 on ``device`` (default: the
    CUDA card), or restored from ``ckpt_dir``'s latest checkpoint (its
    ``params``; the restore's ``like`` tree is built on the meta device), as
    the JAX launcher's LM mode serves them: each loop
    admits what fits (one batch-1 prefill each), then decodes one step.
    ``warmup`` throwaway requests (the first prompt, 2 tokens each) run to
    completion on the same engine before the timed window: a first
    prefill and decode step carry one-time costs (library handles, the
    allocator's first blocks). Their tokens and times are not returned.

    Returns the tokens and seconds of the run (parameter init or restore
    excluded), the restored step (``None`` on seeded parameters),
    tokens/s, the prefill ms of each request (batch 1) and the decode ms of
    each step (the host's clock, each ending where its sampled tokens reach
    the host), the engine steps, ``max_memory_allocated`` on a card (after
    a reset at the start), and each request's prompt and generated tokens.
    """
    from repro_torch._device import resolve_device
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine

    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    restored = None
    if ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager

        like = init_params(0, cfg, device="meta")
        state, meta = CheckpointManager(ckpt_dir).restore({"params": like}, device=dev)
        params, restored = state["params"], meta["step"]
    else:
        params = init_params(0, cfg, device=dev)
    eng = ServeEngine(cfg, params, max_slots=slots, max_len=max_len, device=dev)
    pending = [
        Request(uid=i, prompt=[(7 * i + j) % cfg.vocab_size for j in range(4 + i % 5)],
                max_tokens=max_tokens)
        for i in range(requests)
    ]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for i in range(warmup):
        eng.submit(Request(uid=-1 - i, prompt=list(pending[0].prompt), max_tokens=2))
        eng.run_to_completion()
    sync()
    prefill_ms, decode_ms = [], []
    t0 = time.perf_counter()
    done = 0
    queue = list(pending)
    while done < len(pending):
        while queue:
            t = time.perf_counter()
            if not eng.submit(queue[0]):
                break
            prefill_ms.append((time.perf_counter() - t) * 1e3)
            queue.pop(0)
        t = time.perf_counter()
        decoding = any(eng.active)
        done += len(eng.step())
        if decoding:
            decode_ms.append((time.perf_counter() - t) * 1e3)
    sync()
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in pending)
    return {
        "arch": cfg.name,
        "restored_step": restored,
        "requests": len(pending),
        "tokens": toks,
        "seconds": dt,
        "tokens_per_s": toks / dt,
        "prefill_ms": prefill_ms,
        "decode_ms": decode_ms,
        "steps": len(decode_ms),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "param_count": cfg.param_count(),
        "prompts": [r.prompt for r in pending],
        "generated": [r.generated for r in pending],
        "device": str(dev),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--frames", type=int, default=0, help="frames to serve")
    mode.add_argument("--video", type=int, default=0, help="video streams to serve")
    mode.add_argument("--arch", default=None, help="LM arch to serve (omit with --frames)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--video-frames", type=int, default=24, help="frames per stream")
    ap.add_argument("--alpha", type=float, default=0.6, help="temporal EMA weight per stream")
    ap.add_argument("--fps", type=float, default=0.0, help="frames/s per stream (0: max)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="latency budget per video frame (0: none)")
    ap.add_argument("--batch-window-ms", type=float, default=5.0, help="video batch window")
    ap.add_argument("--frame-hw", default="96x128", help="frame size HxW")
    ap.add_argument("--micro-batch", type=int, default=16, help="frames per dispatch")
    ap.add_argument("--stream-input", action="store_true",
                    help="serve frames through the streamed fused kernel (each "
                    "frame read once through a ring of rows in shared memory)")
    ap.add_argument("--config", choices=CONFIGS, default="serve",
                    help="grid config: the JAX launcher's serve grid (r=6) "
                    "or the paper's full-HD default (r=12)")
    ap.add_argument("--workers", type=int, default=0,
                    help="serve the video streams through a fleet of N workers (0: one engine)")
    ap.add_argument("--worker-backend", choices=("local", "subprocess"), default="local",
                    help="fleet workers: threads in this process, or one child process each")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.arch is not None:
        st = serve_lm(args.arch, args.smoke, args.slots, args.max_len, args.requests,
                      args.max_tokens, args.device, args.ckpt_dir)
        source = ("random params (seed 0)" if st["restored_step"] is None
                  else f"restored step {st['restored_step']}")
        print(f"[serve] {st['arch']} on {st['device']}, {source}: "
              f"{st['requests']} requests, {st['tokens']} tokens in {st['seconds']:.2f}s "
              f"({st['tokens_per_s']:.1f} tok/s)")
        for prompt, gen in list(zip(st["prompts"], st["generated"]))[:4]:
            print(f"  prompt={prompt} -> {gen}")
        return
    h, w = (int(x) for x in args.frame_hw.split("x"))
    if args.frames < 1 and args.video < 1:
        ap.error("--frames or --video needs a positive count")
    if args.workers and not args.video:
        ap.error("--workers serves video streams: pass --video N")
    if args.workers:
        st = serve_fleet(
            args.video, args.video_frames, h, w, args.alpha, args.workers,
            args.worker_backend, args.fps, args.deadline_ms or None, args.batch_window_ms,
            args.config, args.device,
        )
        print(
            f"[serve] fleet: {st['frames']} frames ({st['streams']} streams) {h}x{w} over "
            f"{st['workers_alive']}/{st['workers']} {st['worker_backend']} workers x "
            f"{st['mesh_size']} device(s) on {st['device']} in {st['seconds']:.3f}s ({st['frames_per_s']:.1f} frames/s, "
            f"{st['fps_per_stream']:.1f} fps/stream) p50={st['latency_ms_p50']:.1f}ms "
            f"p99={st['latency_ms_p99']:.1f}ms (merged reservoirs; client "
            f"p50={st['client_latency_ms_p50']:.1f}ms p99={st['client_latency_ms_p99']:.1f}ms) "
            f"dispatches={st['dispatches']} mean_batch={st['mean_batch']:.1f} "
            f"deadline_miss_rate={st['deadline_miss_rate']:.4f} shed={st['router_shed']} "
            f"failed={st['failed']} launches={st['worker_launches']} plan[{st['plan']}] "
            f"hash={st['plan_hash']}"
        )
        return
    if args.video:
        st = serve_video(
            args.video, args.video_frames, h, w, args.alpha, args.fps,
            args.deadline_ms or None, args.batch_window_ms, args.config, args.device,
        )
        print(
            f"[serve] video: {st['frames']} frames ({st['streams']} streams) {h}x{w} "
            f"on {st['device']} x {st['mesh_size']} device(s) in {st['seconds']:.3f}s ({st['frames_per_s']:.1f} "
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
        f"[serve] {stats['frames']} frames {h}x{w} on {stats['device']}, micro-batch "
        f"{stats['micro_batch']} (mesh-divisible by {stats['n_devices']}), "
        f"in {stats['seconds']:.3f}s ({stats['frames_per_s']:.1f} frames/s, "
        f"{stats['dispatches']} dispatches, launches b1={stats['bg_fused_launches']} "
        f"b3={stats['bg_fused_streamed_launches']}, plan[{stats['plan']}])"
    )


if __name__ == "__main__":
    main()
