"""Fleet serving: a multi-worker router in front of N async engines. The
port's twin of the JAX package's ``examples/denoise_fleet.py``.

Three acts:

  1. Plan distribution: a PlanController resolves ONE BGPlan for the
     fleet's workload, serializes it, and every worker rebuilds it from the
     same payload on its device. Workers verify the plan hash on
     construction, so a fleet can never silently mix recipes.
  2. Sticky stream affinity: temporal streams are placed by rendezvous
     hashing and pinned; a warm stream's EMA carry lives on exactly one
     worker, so frames for it are never dispatched elsewhere.
  3. Worker failure: one worker is killed WITHOUT telling the router (the
     watchdog notices, or the next submit does). Its streams are
     quarantined (carries dropped, never copied half-written) and re-pinned
     onto survivors, where they restart cold. Survivor streams keep their
     carries untouched.

Run:  PYTHONPATH=src python -m repro_torch.examples.denoise_fleet
      PYTHONPATH=src python -m repro_torch.examples.denoise_fleet --device cpu \\
          --height 32 --width 48 --frames 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import BGConfig
from repro_torch.data import synthetic_video_np
from repro_torch.fleet import FleetError, FleetRouter, PlanController

ALPHA = 0.6
# submit attempts per frame while a failover re-pin is in progress
_RETRIES = 200


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--streams", type=int, default=6)
    ap.add_argument("--frames", type=int, default=8, help="frames per stream")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.height, args.width
    n_workers, n_streams, n_frames = args.workers, args.streams, args.frames
    cfg = BGConfig(r=6, sigma_s=4.0, sigma_r=60.0)

    # synthetic per-stream traffic: panning scenes + gaussian noise
    traffic = []
    for s in range(n_streams):
        vid = synthetic_video_np(s, n_frames, H, W, motion=1.5)
        rng = np.random.default_rng(97 * s)
        noisy = np.clip(np.floor(vid + rng.normal(0.0, 30.0, vid.shape) + 0.5), 0.0, 255.0)
        traffic.append(noisy.astype(np.float32))

    # ---- 1. one controller-resolved plan for the whole fleet -----------
    ctrl = PlanController(cfg=cfg, height=H, width=W,
                          streams_per_worker=-(-n_streams // n_workers), temporal=True, device=dev)
    print(f"fleet plan: hash={ctrl.plan_hash} backend={ctrl.plan.backend} "
          f"batch_tile={ctrl.plan.batch_tile} ({ctrl.plan.provenance}) on {dev}")

    router = FleetRouter(
        controller=ctrl,
        n_workers=n_workers,
        worker_kwargs=dict(device=str(dev), max_batch=n_streams, batch_window_ms=20.0),
        health_interval_s=0.1,
    )
    try:
        # ---- 2. sticky affinity: open streams, show their pins ---------
        for s in range(n_streams):
            print(f"  stream {s} -> {router.open_stream(s, alpha=ALPHA)}")

        # warm-up: the first dispatch loads the kernels, so it goes
        # deadline-free
        for f in [router.submit(traffic[s][0], stream_id=s) for s in range(n_streams)]:
            f.result()

        half = max(1, n_frames // 2)
        futs = [router.submit(traffic[s][t], stream_id=s, deadline_ms=5000.0)
                for t in range(1, half) for s in range(n_streams)]
        for f in futs:
            f.result()
        st = router.stats()
        print(f"clean: {st.merged.completed} frames across {st.workers_alive} workers "
              f"p50={st.merged.latency_ms_p50:.1f}ms p99={st.merged.latency_ms_p99:.1f}ms "
              f"rebalanced={st.rebalanced_streams}")

        # ---- 3. kill a worker mid-service ------------------------------
        victim = router.stream_worker(0)
        victim_streams = sorted(s for s in range(n_streams) if router.stream_worker(s) == victim)
        print(f"killing {victim} (owns streams {victim_streams}) ...")
        router.kill_worker(victim)  # crash: the router is NOT told

        futs = []
        for t in range(half, n_frames):
            for s in range(n_streams):
                for attempt in range(_RETRIES):
                    try:
                        futs.append(router.submit(traffic[s][t], stream_id=s, deadline_ms=5000.0))
                        break
                    except FleetError:
                        if attempt == _RETRIES - 1:
                            raise
                        time.sleep(0.05)  # failover re-pin in progress
        for f in futs:
            f.result()

        st = router.stats()
        moved = [(s, w) for s, _, w in router.rebalance_log]
        print(f"recovered: workers_alive={st.workers_alive} "
              f"quarantined={st.quarantined_streams} moved={moved}")
        print(f"fleet totals: completed={st.merged.completed} failed={st.merged.failed} "
              f"deadline_miss_rate={st.deadline_miss_rate:.3f} shed={st.router_shed}")
        return {"device": str(dev), "plan_hash": ctrl.plan_hash, "victim": victim,
                "victim_streams": victim_streams, "moved": moved,
                "workers_alive": st.workers_alive, "completed": st.merged.completed,
                "failed": st.merged.failed, "frames": n_streams * n_frames}
    finally:
        router.close()


if __name__ == "__main__":
    main()
