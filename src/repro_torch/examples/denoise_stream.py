"""Batched denoising: a batch of frames in one dispatch of the plan
``plan_for`` picks (on the card the fused kernel B1, or the streamed kernel
B3, which reads each frame once through a ring of rows), every frame held
against the whole-frame reference, and the frames/s against looping the
single-frame kernel. The port's twin of the JAX package's
``examples/denoise_stream.py``: with more than one card it also shards the
batch over every card (``plan_for``'s auto-mesh) and holds the sharded
output to the batched one bit for bit. ``--mesh N`` drives that path with
a mesh naming the device N times instead (``repro_torch.sharding``: the
shards run one after the other, so it shows the path, not a speed-up), as
the JAX example's forced host-device count does.

Run:  PYTHONPATH=src python -m repro_torch.examples.denoise_stream
      PYTHONPATH=src python -m repro_torch.examples.denoise_stream --device cpu \\
          --height 48 --width 64 --frames 2 --mesh 2
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.core import (
    BGConfig,
    add_gaussian_noise,
    bilateral_grid_filter,
    grid_shape,
    mssim,
    synthetic_batch,
)
from repro_torch.kernels import bilateral_grid_filter_pallas
from repro_torch.plan import plan_for
from repro_torch.sharding import BatchMesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over a mesh naming the device N times (0: every card, "
                    "when there are several)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w, n_frames = args.height, args.width, args.frames
    cfg = BGConfig(r=6, sigma_s=4.0, sigma_r=60.0)
    gx, gy, gz = grid_shape(h, w, cfg)
    working = (3 * gy * gz * 2 + 2 * gy * gz + 3 * cfg.r * w) * 4
    print(f"frame {h}x{w}: grid {gx}x{gy}x{gz}, per-frame working set "
          f"~{working/1024:.0f} KiB vs {h*w*4/1024:.0f} KiB per frame")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    clean = synthetic_batch(n_frames, h, w, seed=0, device=dev)
    noisy = add_gaussian_noise(clean, 30.0, generator=torch.Generator(device=dev).manual_seed(100))

    # one plan for the whole run: the plan layer picks the backend and the
    # batch tile from the frame geometry
    plan = plan_for(cfg, h, w, n_frames=n_frames, sharded=False, device=dev)
    print(f"plan: backend={plan.backend} batch_tile={plan.batch_tile} on {dev}")

    # batched: all frames in one dispatch
    out_b = plan(noisy)  # warm-up: kernel build and first launch
    sync()
    t0 = time.perf_counter()
    out_b = plan(noisy)
    sync()
    dt_batch = time.perf_counter() - t0

    # looped single-frame baseline
    for i in range(n_frames):
        bilateral_grid_filter_pallas(noisy[i], cfg, device=dev)
    sync()
    t0 = time.perf_counter()
    out_loop = [bilateral_grid_filter_pallas(noisy[i], cfg, device=dev) for i in range(n_frames)]
    sync()
    dt_loop = time.perf_counter() - t0

    diffs = []
    for i in range(n_frames):
        ref = bilateral_grid_filter(noisy[i], cfg)
        diffs.append(float((out_b[i] - ref).abs().max()))
        print(f"frame {i}: MSSIM {float(mssim(clean[i], out_b[i])):.4f}  "
              f"|batched-whole_frame|max={diffs[-1]:.1e}")
    looped_equal = all(bool(torch.equal(a, b)) for a, b in zip(out_loop, out_b))

    fps_b = n_frames / dt_batch
    fps_l = n_frames / dt_loop
    print(f"batched: {dt_batch*1e3/n_frames:6.1f} ms/frame ({fps_b:.1f} fps)  "
          f"looped: {dt_loop*1e3/n_frames:6.1f} ms/frame ({fps_l:.1f} fps)  "
          f"speedup {fps_b/fps_l:.2f}x on {dev}")

    # sharded service path: batch axis over a 1-D device mesh, no collectives
    nd = torch.cuda.device_count() if dev.type == "cuda" else 1
    sharded = {}
    if args.mesh > 1 or nd > 1:
        mesh = BatchMesh((dev,) * args.mesh) if args.mesh > 1 else None  # None: plan_for auto-meshes
        shard_plan = plan_for(cfg, h, w, n_frames=n_frames, mesh=mesh,
                              device=dev if mesh is not None else args.device)
        out_s = shard_plan(noisy)  # warm-up
        sync()
        t0 = time.perf_counter()
        out_s = shard_plan(noisy)
        sync()
        dt_shard = time.perf_counter() - t0
        same = bool(torch.equal(out_s, out_b))
        sharded = {"mesh_size": shard_plan.mesh_size, "plan": shard_plan.describe(),
                   "fps": n_frames / dt_shard, "bitwise_batched": same}
        print(f"sharded over {shard_plan.mesh_size} devices: {dt_shard*1e3/n_frames:6.1f} ms/frame "
              f"({n_frames/dt_shard:.1f} fps)  bit-identical to batched: {same}")
    else:
        print("single device: sharded path == batched path (run with --mesh 2 to see the "
              "mesh dispatch on one device)")
    return {"device": str(dev), "plan": plan.describe(), "max_diff_vs_reference": diffs,
            "looped_equal_batched": looped_equal, "fps_batched": fps_b, "fps_looped": fps_l,
            "sharded": sharded}


if __name__ == "__main__":
    main()
