#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from this checkout's sources (the
per-frame kernel B1 and the temporal kernel B2, one source; the streamed
kernel B3; the staged kernels B4, B5 and B6), holds each against its plain
PyTorch version at full-HD shapes (B3 against B1, also at r=2, and B5
against B1's blurred grid, bit for bit), holds the bf16 storage form of B1,
B2 and B3 against its bf16 plain version bit for bit (phase
``bf16_vs_plain``) and its quality against fp32's (``bf16_quality``), serves
full-HD frames through ``repro_torch.serving.FrameDenoiseEngine`` on the
fused and the streamed backend, runs the staged backend through
``denoise_batch``, serves full-HD video streams through ``AsyncFrameEngine``
+ ``MultiStreamPacker``, shows with the launch counters that the kernels
carried those runs, then times the kernels at b = 1, 4 and 8 with CUDA
events (``ms``: the mean of back-to-back calls; ``device_ms``: calls
replayed from a CUDA graph, the device alone), their plain versions and
the PyTorch calls that compute the same functions (B4 beside
``index_add_``, the staged route whole beside B1 and B3), sweeps the split
knobs of B1, B3, B4, B5 and B6 (every variant checked bit for bit against
the default),
times the bf16 forms beside fp32 (``bf16_times``), serves full-HD frames
and video on bf16 plans with only the bf16 entry points counted
(``bf16_slice``), sweeps the plan candidates ``plan_for`` ranks, records the
measured winners into a temporary plan cache, reads them back through
``plan_for``, fits the cost model's overhead constants and reads the
model's regret on workloads the fit has not seen (``plan_sweep``), drives
the guarded engine through a failed primary rung (served by the next kernel
rung, or failed where the card's ladder has none), a hung completion and
corrupted input (``guarded_dispatch``), and serves the fp32 paths through
the launcher, whose plans come from ``plan_for`` (as the plan layer
chooses, and pinned on B3 and on B1), and runs the fleet (``fleet``: the
launcher's ``serve_fleet`` over 2 local and 2 subprocess workers, B2 only,
each worker's launches counted; a SIGKILLed subprocess worker's streams
restored from snapshots and held bit for bit to in-process workers; a bf16
snapshot; stateless micro-batches of 8 on B3 and of 1 on B1), and runs
the rest of the image core (``core_paths``: the ``"streaming"`` plan
against the reference plan and B1, fixed point on the card equal to the
CPU's bits, the exact BF beside the BG plan at r = 4, 8, 12, 16, and the
vlm and spectrogram frontends on ``plan_for``'s plans, B3 or B1 counted),
and shards batches over a mesh (``mesh_slice``: ``batch_mesh()`` over the
host's cards, a size-1 mesh on one card being the plain plan; then a mesh
naming the card twice, through which 8 frames go to B1 and B3 in fp32 and
bf16 and a 4-stream pack to B2, cold then warm, each equal to the
single-device plan bit for bit with one launch per shard and timed per
dispatch beside it; the frame and async engines serving 16 host frames
through it; a fleet payload with ``mesh_size=2`` bound to it in a worker),
and serves LMs (``lm_slice``: every arch's smoke config on the card held
to the CPU, ``ServeEngine``'s tokens on the card equal to the CPU's, yi-6b
at full width served through the launcher's LM mode with its tokens/s,
prefill and decode times, peak memory and bytes per decode step, and the
vlm example's images denoised by B1 or B3 (held to the reference plan's
frames) into the vision model's
cross-attention context; plain PyTorch on the LM path, as the JAX package
has no kernel there), and trains LMs (``train_slice``: one train step of
every smoke arch on the card held to the CPU, stablelm-1.6b at full width
through the train launcher's ``train_lm`` with its step times, tokens/s,
6N-FLOP share, peak memory and checkpoint seconds, remat against none,
its checkpoint restored leaf for leaf and served through ``serve_lm``, and
the ``train_lm`` example), and shards LMs (``lm_mesh_slice``: that
full-width checkpoint restored by ``elastic_restore`` onto a world-1
``nccl`` group's (1, 1) ``DeviceMesh``, leaf for leaf, and trained on it
for a few timed steps beside ``train_slice``'s, one profiled; a step on the
mesh equal to the step without one bit for bit at full width and cut
depth; ring attention and GPipe on the card; the train launcher's ``--mesh
1x1 --distributed``; and, as a CPU check of the running host's torch,
every arch's smoke step on a 4-rank ``gloo`` mesh against one device), and
runs the dry-run and roofline tooling (``dryrun_slice``: the dry-run's CLI
on production cells, each counted as rank 0 of a fake group of 256 or 512
ranks over meta tensors on the host; the roofline of the full-width train
and decode steps counted at the H100's peaks against their times measured
above; the plan table rendered from ``plan_sweep``'s rows).
Every served
phase whose engine counts them holds retries, fallbacks and watchdog trips
at 0. Prints one JSON object per
phase; the line before the last is the card's ``nvidia-smi`` name and
power limit, the last ``{"ok": true, "device": {...}}``. Any failed check
raises and the script exits non-zero. It needs a CUDA card and fails
without one; it imports nothing of JAX.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
TOL_ABS = 5e-3  # fused vs ref_fused in the JAX package's tests/test_kernels.py
TOL_EXACT = 0.995  # quantized outputs: share of exactly equal pixels
TOL_LSB = 1.0  # quantized outputs: largest difference
# temporal image and carry vs the staged oracle, the JAX package's
# tests/test_temporal_fused.py:118-123
TOL_CARRY_ABS, TOL_CARRY_REL = 2e-2, 1e-3
# staged kernels vs their plain versions, the JAX package's
# tests/test_kernels.py:43,53,64: GC, GF (rtol and atol), TI. B4 itself is
# held to its plain version bit for bit (torch.equal); TOL_GC is the
# tolerance its library yardstick is flagged against
TOL_GC, TOL_GF, TOL_TI = 1e-4, (1e-4, 1e-2), 1e-3
ALPHAS = (0.0, 0.4, 0.6, 0.8)
# bf16 storage: its quantized output against fp32's, at most 2 LSB apart
# (the JAX package's bf16 tolerance, tests/test_plan.py:685-690: atol 2.0),
# and its MSSIM against the clean scene at least 0.98 of fp32's
TOL_BF16_LSB = 2.0
BF16_MSSIM_RATIO = 0.98
BF16_ALPHAS = (0.0, 0.6, 0.8, 0.3)


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


def graph_ms(torch, fn, reps: int, replays: int = 3) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph (after two warm-up calls on a side stream), replayed once to warm
    up and then ``replays`` times, each timed by CUDA events; the fastest
    replay over ``reps``. No host launch work is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / reps


def kernel_ms(torch, fn, reps: int):
    """(ms, device_ms) of one ``fn`` call: the mean of ``reps`` back-to-back
    calls (``cuda_ms``, the kernels line's ``ms`` since the port began: what
    a caller sees, the host's launch work included where that is the slower
    side), and the device's time alone (``graph_ms``)."""
    return cuda_ms(torch, fn, reps), graph_ms(torch, fn, reps)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the fp32 rate (the cost model's H100 SXM rates,
    ``repro_torch.plan``)."""
    from repro_torch.plan import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bg_fused_bound(b: int, h: int, w: int, cfg, grid_shape, esize: int = 4):
    """(bound_ms, bound_by, bytes, flops) of the fused filter on b frames
    (B1 and B3) of ``esize``-byte pixels (4 fp32, 2 bf16), from the counts
    the cost model uses (``repro_torch.plan.fused_work``: each input read
    once and each output written once)."""
    from repro_torch.plan import fused_work

    nbytes, flops = fused_work(b, h, w, cfg, esize)
    return (*bound(nbytes, flops), nbytes, flops)


def bg_fused_temporal_bound(b: int, h: int, w: int, cfg, grid_shape, esize: int = 4):
    """(bound_ms, bound_by, bytes, flops) of the temporal kernel on b
    frames (``fused_work(temporal=True)``: the per-frame counts plus the
    carry read and written, the alpha and the blend)."""
    from repro_torch.plan import fused_work

    nbytes, flops = fused_work(b, h, w, cfg, esize, temporal=True)
    return (*bound(nbytes, flops), nbytes, flops)


def staged_bounds(b: int, h: int, w: int, cfg, grid_shape) -> dict:
    """{kernel: (bound_ms, bound_by, bytes, flops)} of the staged kernels on
    b frames (``repro_torch.plan.staged_work``)."""
    from repro_torch.plan import staged_work

    return {k: (*bound(nb, fl), nb, fl) for k, (nb, fl) in staged_work(b, h, w, cfg).items()}


def tpu_kernel_bounds(cfg, grid_shape) -> dict:
    """Bytes bound (ms) per 1080x1920 frame of every TPU kernel of the repo,
    each input read once and each output written once, at the H100's HBM
    rate: B1 and B3 image in and out; B2 that plus the carry in and out; B4
    image in, (gx, 2, gz, gy) grid out; B5 grid in and out; B6 image and
    scalar grid in, image out. All are far from the fp32 operation bound."""
    from repro_torch.plan import HBM_BYTES_PER_S

    gx, gy, gz = grid_shape(H, W, cfg)
    img, grid = H * W * 4, gx * gy * gz * 2 * 4
    nbytes = {"B1": 2 * img, "B2": 2 * img + 2 * grid, "B3": 2 * img,
              "B4": img + grid, "B5": 2 * grid, "B6": 2 * img + grid // 2}
    return {k: v / HBM_BYTES_PER_S * 1e3 for k, v in nbytes.items()}


def reliability_zero(st, what: str) -> dict:
    """The reliability counters of an ``EngineStats``; fails unless retries,
    fallbacks and watchdog trips are all 0 (a dispatch served by a lower
    rung must never pass as the kernel's)."""
    counts = {"retries": st.retries, "fallbacks": st.fallbacks, "watchdog_trips": st.watchdog_trips}
    check(not any(counts.values()), f"{what}: {counts}")
    return counts


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def carry_close(torch, a, b) -> bool:
    return bool(torch.allclose(a, b, atol=TOL_CARRY_ABS, rtol=TOL_CARRY_REL))


def temporal_vs_plain(torch, x8, cfgs, bg_fused, bg_fused_plain, quantize_intensity, grid_shape):
    """B2 against its plain version on 4 full-HD frames per config, two
    chained steps (the second on the carry the first returned), with the
    bitwise contracts. Returns the largest image and carry errors."""
    dev = x8.device
    alpha = torch.tensor(ALPHAS, device=dev)
    max_img = max_carry = 0.0
    for label, cfg in cfgs:
        gx, gy, gz = grid_shape(H, W, cfg)
        carry = torch.zeros((4, gx, gy, gz, 2), device=dev)
        p_carry = carry
        row = {"phase": "temporal_vs_plain", "config": label, "shape": [4, H, W], "alpha": list(ALPHAS)}
        for step, x in enumerate((x8[:4].contiguous(), x8[4:].contiguous())):
            out, new = bg_fused(x, cfg, carry=carry, alpha=alpha)
            p_out, p_new = bg_fused_plain(x, cfg, carry=p_carry, alpha=alpha)
            sync(torch, dev)
            img_err = float((out - p_out).abs().max())
            carry_err = float((new - p_new).abs().max())
            exact, lsb = quantized_agreement(quantize_intensity(out, cfg), quantize_intensity(p_out, cfg))
            b1 = bg_fused(x, cfg)
            zero_a = bg_fused(x, cfg, carry=carry, alpha=torch.zeros_like(alpha))[0]
            o1, c1 = bg_fused(x[2:3].contiguous(), cfg, carry=carry[2:3].contiguous(), alpha=alpha[2:3].contiguous())
            again = bg_fused(x, cfg, carry=carry, alpha=alpha)
            drain = float(new[:, gx - 1].abs().max())
            row[f"step{step}"] = {
                "max_abs_err": img_err, "carry_max_abs_err": carry_err,
                "quantized_exact": exact, "quantized_max_diff": lsb,
                "alpha0_row_bitwise_b1": bool(torch.equal(out[0], b1[0])),
                "alpha0_launch_bitwise_b1": bool(torch.equal(zero_a, b1)),
                "b1_bitwise_row": bool(torch.equal(o1[0], out[2]) and torch.equal(c1[0], new[2])),
                "repeat_bitwise": bool(torch.equal(again[0], out) and torch.equal(again[1], new)),
                "drain_plane_max": drain,
                "drain_plane_close": carry_close(torch, new[:, gx - 1], p_new[:, gx - 1]),
            }
            r = row[f"step{step}"]
            check(out.shape == x.shape and new.shape == carry.shape, f"{label}: shapes")
            check(bool(torch.isfinite(out).all() and torch.isfinite(new).all()), f"{label}: finite")
            check(img_err <= TOL_ABS, f"{label} step {step}: image err {img_err} > {TOL_ABS}")
            check(carry_close(torch, new, p_new), f"{label} step {step}: carry err {carry_err}")
            check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"{label} step {step}: quantized {exact}, {lsb}")
            check(r["alpha0_row_bitwise_b1"] and r["alpha0_launch_bitwise_b1"], f"{label}: alpha 0 vs B1")
            check(r["b1_bitwise_row"] and r["repeat_bitwise"], f"{label}: bitwise contracts")
            check(drain > 0.0 and r["drain_plane_close"], f"{label}: drain plane gx-1")
            max_img, max_carry = max(max_img, img_err), max(max_carry, carry_err)
            carry, p_carry = new, p_new
        emit(row)
    return max_img, max_carry


def video_slice(torch, cfg, smi, dev):
    """4 full-HD streams x 8 frames through AsyncFrameEngine +
    MultiStreamPacker on ``dev``, counted and checked against the same
    packs through the staged oracle on ``dev``."""
    import numpy as np

    from repro_torch.core import psnr, quantize_intensity
    from repro_torch.data import synthetic_video_np
    from repro_torch.kernels import bg_fused
    from repro_torch.plan import BGPlan
    from repro_torch.video import MultiStreamPacker

    n_streams, n_frames = 4, 8
    rng = np.random.default_rng(7)
    clean, noisy = [], []
    for s in range(n_streams):
        vid = synthetic_video_np(s, n_frames, H, W, motion=0.0 if s == 3 else 1.5)
        clean.append(vid)
        noisy.append(np.clip(np.floor(vid + rng.normal(0.0, 30.0, vid.shape) + 0.5), 0, 255).astype(np.float32))
    plan = BGPlan(cfg, device=dev)

    def fresh(p=plan, streams=range(n_streams), alphas=ALPHAS):
        packer = MultiStreamPacker(plan=p)
        for s in streams:
            packer.open(s, alpha=alphas[s])
        return packer

    zero_counts()
    outs, packs, packer, st, _ = run_video(torch, plan, noisy, ALPHAS)
    b1_launches, b2_launches = bg_fused.launches, bg_fused.temporal_launches
    counts = kernel_counts()
    cold = sum(1 for _, warm in packs if not warm)
    check_counts(counts, {"bg_fused.launches": cold, "bg_fused.temporal_launches": len(packs) - cold},
                 f"video slice, {len(packs)} packs, {cold} cold")
    check(st.shed == st.failed == st.carry_resets == 0 and packer.carry_resets == 0,
          f"shed {st.shed} failed {st.failed} quarantined {st.carry_resets}")
    reliability = reliability_zero(st, "video slice")
    check(all(o.device == dev and tuple(o.shape) == (H, W) and bool(torch.isfinite(o).all())
              for o in outs.values()), "results are finite (h, w) tensors on the card")

    # the same packs through the staged oracle on the card
    ref = fresh(BGPlan(cfg, backend="reference", device=dev))
    nxt = {s: 0 for s in range(n_streams)}
    worst_exact, worst_lsb = 1.0, 0.0
    for sids, _ in packs:
        res = ref.pack({s: noisy[s][nxt[s]] for s in sids})
        for s in sids:
            exact, lsb = quantized_agreement(outs[(s, nxt[s])], res[s])
            worst_exact, worst_lsb = min(worst_exact, exact), max(worst_lsb, lsb)
            nxt[s] += 1
    check(worst_exact >= TOL_EXACT and worst_lsb <= TOL_LSB, f"vs staged oracle: {worst_exact}, {worst_lsb}")
    carries_ok = all(
        carry_close(torch, packer.sessions[s].carry, ref.sessions[s].carry) for s in range(1, n_streams)
    )
    carry_err = max(float((packer.sessions[s].carry - ref.sessions[s].carry).abs().max())
                    for s in range(1, n_streams))
    check(carries_ok, f"carries vs staged oracle: max err {carry_err}")

    # streams 0 (alpha 0) and 1 (alpha 0.4) alone through a fresh packer
    for s in (0, 1):
        solo = fresh(streams=(s,))
        for t in range(n_frames):
            check(torch.equal(solo.pack({s: noisy[s][t]})[s], outs[(s, t)]), f"stream {s} frame {t} leaks")

    # temporal accumulation on the static stream: alpha 0.8 against 0
    per_frame = fresh(streams=(3,), alphas=(0.0, 0.0, 0.0, 0.0))
    for t in range(n_frames):
        flat = per_frame.pack({3: noisy[3][t]})[3]
    target = torch.as_tensor(clean[3][-1], device=dev)
    psnr_warm = float(psnr(target, outs[(3, n_frames - 1)]))
    psnr_cold = float(psnr(target, flat))
    check(psnr_warm > psnr_cold, f"static stream PSNR {psnr_warm} <= {psnr_cold} at alpha 0")
    row = {"phase": "video_slice", "config": "PAPER_DEFAULT", "streams": n_streams, "frames": n_frames,
           "alphas": list(ALPHAS), "packs": len(packs), "cold_packs": cold, "dispatches": st.dispatches,
           "bg_fused_launches": b1_launches, "bg_fused_temporal_launches": b2_launches,
           "mean_batch": st.mean_batch, "vs_oracle_exact": worst_exact, "vs_oracle_max_diff": worst_lsb,
           "carry_max_abs_err_vs_oracle": carry_err, "psnr_static_alpha08": psnr_warm,
           "psnr_static_alpha0": psnr_cold, "shed": st.shed, "failed": st.failed,
           "quarantined": st.carry_resets, **reliability, "card": smi}
    emit(row)
    return row


def bf16_vs_plain(torch, x8, checks, smi):
    """B1, B2 and B3 in bf16 against their bf16 plain version, bit for bit,
    on full-HD frames of every config in ``checks`` ((label, cfg, width)),
    at b = 1 and 4: B3 equals B1; B2 after one cold pack (alpha 0 on a zero
    carry), then at BF16_ALPHAS on the carry it returned, image and carry,
    its alpha-0 rows equal to B1's output. Returns the number of values
    compared and the largest |kernel - plain| (0 when bit for bit)."""
    from repro_torch.core import grid_shape
    from repro_torch.kernels import bg_fused, bg_fused_plain

    bf, dev = torch.bfloat16, x8.device
    values, worst = 0, 0.0
    for label, cfg, w in checks:
        gx, gy, gz = grid_shape(H, w, cfg)
        for b in (1, 4):
            x = x8[:b, :, :w].contiguous().to(bf)
            x2 = x8[4:4 + b, :, :w].contiguous().to(bf)
            k = bg_fused(x, cfg, precision="bf16")
            s = bg_fused(x, cfg, precision="bf16", stream_input=True)
            p = bg_fused_plain(x, cfg, precision="bf16")
            zero = torch.zeros((b, gx, gy, gz, 2), device=dev, dtype=bf)
            a0 = torch.zeros(b, device=dev)
            o0, c0 = bg_fused(x, cfg, carry=zero, alpha=a0, precision="bf16")
            po0, pc0 = bg_fused_plain(x, cfg, carry=zero, alpha=a0, precision="bf16")
            alpha = torch.tensor(BF16_ALPHAS[:b], device=dev)
            o1, c1 = bg_fused(x2, cfg, carry=c0, alpha=alpha, precision="bf16")
            po1, pc1 = bg_fused_plain(x2, cfg, carry=pc0, alpha=alpha, precision="bf16")
            b1_2 = bg_fused(x2, cfg, precision="bf16")
            sync(torch, dev)
            zero_rows = [i for i in range(b) if BF16_ALPHAS[i] == 0.0]
            err = max(float((u.float() - v.float()).abs().max())
                      for u, v in ((k, p), (o0, po0), (c0, pc0), (o1, po1), (c1, pc1)))
            row = {"phase": "bf16_vs_plain", "config": label, "shape": [b, H, w],
                   "dtypes": sorted({str(t.dtype) for t in (k, s, o1, c1)}),
                   "b1_bitwise_plain": bool(torch.equal(k, p)), "b3_bitwise_b1": bool(torch.equal(s, k)),
                   "b2_cold_bitwise_plain": bool(torch.equal(o0, po0) and torch.equal(c0, pc0)),
                   "b2_cold_bitwise_b1": bool(torch.equal(o0, k)),
                   "b2_bitwise_plain": bool(torch.equal(o1, po1)),
                   "b2_carry_bitwise_plain": bool(torch.equal(c1, pc1)),
                   "b2_alpha0_rows_bitwise_b1": all(torch.equal(o1[i], b1_2[i]) for i in zero_rows),
                   "alpha": list(BF16_ALPHAS[:b]), "max_abs_err": err, "card": smi}
            emit(row)
            check(row["dtypes"] == ["torch.bfloat16"], f"bf16 {label} b={b}: dtypes {row['dtypes']}")
            check(all(v for v in row.values() if isinstance(v, bool)), f"bf16 {label} b={b}: {row}")
            check(bool(torch.isfinite(k.float()).all() and torch.isfinite(c1.float()).all()),
                  f"bf16 {label} b={b}: finite")
            values += sum(t.numel() for t in (k, s, o0, c0, o1, c1))
            worst = max(worst, err)
    return values, worst


def bf16_quality(torch, cfgs, smi, dev):
    """MSSIM(bf16) / MSSIM(fp32) against the clean scenes, on the kernels
    (B1 in both storage types), 4 full-HD frames per config, each output
    quantized; and the share of quantized pixels equal to fp32's and their
    largest difference. Returns the rows."""
    from repro_torch.core import add_gaussian_noise, mssim, quantize_intensity, synthetic_batch
    from repro_torch.kernels import bg_fused

    clean = synthetic_batch(4, H, W, seed=300, device=dev)
    x = add_gaussian_noise(clean, 30.0, generator=torch.Generator(device=dev).manual_seed(3)).contiguous()
    rows = []
    for label, cfg in cfgs:
        q32 = quantize_intensity(bg_fused(x, cfg), cfg)
        q16 = quantize_intensity(bg_fused(x.to(torch.bfloat16), cfg, precision="bf16").float(), cfg)
        m32 = [float(mssim(c, o)) for c, o in zip(clean, q32)]
        m16 = [float(mssim(c, o)) for c, o in zip(clean, q16)]
        exact, lsb = quantized_agreement(q16, q32)
        ratio = min(a / b for a, b in zip(m16, m32))
        row = {"phase": "bf16_quality", "config": label, "shape": list(x.shape),
               "mssim_fp32": sum(m32) / 4, "mssim_bf16": sum(m16) / 4, "mssim_ratio_min": ratio,
               "quantized_exact_vs_fp32": exact, "quantized_max_diff_vs_fp32": lsb,
               "limits": {"mssim_ratio": BF16_MSSIM_RATIO, "lsb": TOL_BF16_LSB}, "card": smi}
        emit(row)
        check(ratio >= BF16_MSSIM_RATIO, f"bf16 quality {label}: MSSIM ratio {ratio}")
        check(lsb <= TOL_BF16_LSB, f"bf16 quality {label}: {lsb} LSB from fp32")
        rows.append(row)
    return rows


def run_video(torch, plan, noisy, alphas):
    """``noisy`` (one (frames, h, w) array per stream) through a fresh
    ``MultiStreamPacker`` on ``plan`` behind an ``AsyncFrameEngine``, stream
    0 (alpha 0) alone first: an all-cold pack, the per-frame kernel. Checks
    that every future resolved, in order per stream, one dispatch per pack.
    Returns (results {(stream, t): frame}, packs [(stream ids, warm)] in
    dispatch order, the packer, engine stats, wall seconds)."""
    from repro_torch.serving import AsyncFrameEngine
    from repro_torch.video import MultiStreamPacker

    n_streams, n_frames = len(noisy), len(noisy[0])
    packer = MultiStreamPacker(plan=plan)
    for s in range(n_streams):
        packer.open(s, alpha=alphas[s])
    packs = []
    real = packer.pack_guarded

    def recording(frames, **kw):
        packs.append((sorted(frames), any(packer.sessions[s].alpha > 0.0 for s in frames)))
        return real(frames, **kw)

    packer.pack_guarded = recording
    eng = AsyncFrameEngine(max_batch=n_streams, batch_window_ms=5.0, packer=packer)
    futs, done = {}, {s: [] for s in range(n_streams)}

    def submit(s, t):
        futs[(s, t)] = eng.submit(noisy[s][t], stream_id=s)
        futs[(s, t)].add_done_callback(lambda _f: done[s].append(t))

    t0 = time.perf_counter()
    submit(0, 0)
    futs[(0, 0)].result()
    for t in range(n_frames):
        for s in range(n_streams):
            if (s, t) not in futs:
                submit(s, t)
    eng.flush()
    sync(torch, plan.device)
    seconds = time.perf_counter() - t0
    st = eng.stats()
    eng.close()
    check(all(f.done() and f.exception() is None for f in futs.values()), "every future resolved")
    check(all(done[s] == sorted(done[s]) and len(done[s]) == n_frames for s in done), f"per-stream order {done}")
    check(st.dispatches == len(packs), f"{st.dispatches} dispatches for {len(packs)} packs")
    return {k: f.result() for k, f in futs.items()}, packs, packer, st, seconds


def bf16_slice(torch, cfg, smi, dev):
    """The bf16 plans through the engines a user calls: 32 full-HD frames
    through ``FrameDenoiseEngine`` on a bf16 ``"fused"`` and a bf16
    ``"fused_streamed"`` plan, then 4 full-HD streams x 8 frames through
    ``AsyncFrameEngine`` + ``MultiStreamPacker`` on a bf16 plan. The launch
    counters are zeroed before each run and must show only bf16 entry
    points after it; each quantized output is held within TOL_BF16_LSB of
    the fp32 engine's on the same frames, whose run right after (warmed up
    alike) gives the fp32 rates beside the bf16 ones. Returns the phase
    rows."""
    import numpy as np

    from repro_torch.core import add_gaussian_noise, synthetic_batch
    from repro_torch.data import synthetic_video_np
    from repro_torch.plan import BGPlan
    from repro_torch.serving import FrameDenoiseEngine, FrameRequest

    n, mb = 32, 8
    frames = add_gaussian_noise(synthetic_batch(n, H, W, seed=400, device="cpu"), 30.0,
                                generator=torch.Generator().manual_seed(4)).numpy()
    rows = {}

    def serve(plan):
        eng = FrameDenoiseEngine(plan=plan, max_batch=mb)
        t0 = time.perf_counter()
        for i in range(n):
            eng.submit(FrameRequest(uid=i, frame=frames[i]))
        done, dispatches = [], 0
        while eng.pending():
            done.extend(eng.step())
            dispatches += 1
        sync(torch, dev)
        seconds = time.perf_counter() - t0
        check([r.uid for r in done] == list(range(n)), "every request answered in order")
        return torch.stack([r.result for r in done]), dispatches, seconds

    for backend, counter in (("fused", "bg_fused.bf16_launches"),
                             ("fused_streamed", "bg_fused.bf16_streamed_launches")):
        plan16 = BGPlan(cfg, backend=backend, precision="bf16", device=dev)
        plan32 = BGPlan(cfg, backend=backend, device=dev)
        serve(plan16)  # warm-up: the shapes' launch structs and first launches
        serve(plan32)
        zero_counts()
        out16, dispatches, seconds = serve(plan16)
        counts = kernel_counts()
        check_counts(counts, {counter: dispatches}, f"bf16 {backend} slice")
        out32, _, seconds32 = serve(plan32)
        exact, lsb = quantized_agreement(out16, out32)
        check(out16.dtype == torch.float32 and bool(torch.isfinite(out16).all()), f"bf16 {backend} output")
        check(lsb <= TOL_BF16_LSB, f"bf16 {backend} slice: {lsb} LSB from the fp32 engine")
        rows[backend] = {"phase": "bf16_slice", "engine": "FrameDenoiseEngine", "backend": backend,
                         "precision": "bf16", "frames": n, "max_batch": mb, "dispatches": dispatches,
                         "seconds": seconds, "frames_per_s": n / seconds, "launches": counts,
                         "fp32_frames_per_s": n / seconds32, "vs_fp32_exact": exact,
                         "vs_fp32_max_diff": lsb, "card": smi}
        emit(rows[backend])

    n_streams, n_frames = 4, 8
    rng = np.random.default_rng(17)
    noisy = []
    for s in range(n_streams):
        vid = synthetic_video_np(s, n_frames, H, W, motion=0.0 if s == 3 else 1.5)
        noisy.append(np.clip(np.floor(vid + rng.normal(0.0, 30.0, vid.shape) + 0.5), 0, 255).astype(np.float32))
    plan16 = BGPlan(cfg, precision="bf16", device=dev)
    zero_counts()
    outs16, packs, _, st, seconds = run_video(torch, plan16, noisy, ALPHAS)
    counts = kernel_counts()
    cold = sum(1 for _, warm in packs if not warm)
    check_counts(counts, {"bg_fused.bf16_launches": cold, "bg_fused.bf16_temporal_launches": len(packs) - cold},
                 f"bf16 video slice, {len(packs)} packs, {cold} cold")
    check(st.shed == st.failed == st.carry_resets == 0, f"bf16 video: shed {st.shed} failed {st.failed}")
    reliability = reliability_zero(st, "bf16 video slice")
    outs32, _, _, st32, seconds32 = run_video(torch, BGPlan(cfg, device=dev), noisy, ALPHAS)
    reliability_zero(st32, "bf16 slice's fp32 video run")
    worst_exact, worst_lsb = 1.0, 0.0
    for key, o in outs16.items():
        exact, lsb = quantized_agreement(o, outs32[key])
        worst_exact, worst_lsb = min(worst_exact, exact), max(worst_lsb, lsb)
    check(worst_lsb <= TOL_BF16_LSB, f"bf16 video: {worst_lsb} LSB from the fp32 engine")
    rows["video"] = {"phase": "bf16_slice", "engine": "AsyncFrameEngine+MultiStreamPacker",
                     "precision": "bf16", "streams": n_streams, "frames": n_streams * n_frames,
                     "alphas": list(ALPHAS), "packs": len(packs), "cold_packs": cold,
                     "dispatches": st.dispatches, "mean_batch": st.mean_batch, "seconds": seconds,
                     "frames_per_s": n_streams * n_frames / seconds,
                     "latency_ms_p50": st.latency_ms_p50, "latency_ms_p99": st.latency_ms_p99,
                     "fp32_frames_per_s": n_streams * n_frames / seconds32,
                     "fp32_latency_ms_p50": st32.latency_ms_p50, "fp32_latency_ms_p99": st32.latency_ms_p99,
                     "launches": counts, "vs_fp32_worst_exact": worst_exact,
                     "vs_fp32_max_diff": worst_lsb, **reliability, "card": smi}
    emit(rows["video"])
    return rows


def bf16_times(torch, x8, cfg, smi):
    """B1, B2 and B3 in bf16 beside fp32 at b = 8, 4 and 1 on the same
    frames (the carry from the frames themselves, alpha mixed), both ways
    (``kernel_ms``), in turns fp32, bf16, bf16, fp32, each the mean of its
    two passes, with each storage type's bytes bound. Returns {batch:
    {"ms": {...}, "device_ms": {...}, "bound_ms": {...}}} per frame."""
    from repro_torch.core import grid_shape
    from repro_torch.kernels import bg_fused

    dev = x8.device
    gx, gy, gz = grid_shape(H, W, cfg)
    out = {}
    for bb in (8, 4, 1):
        alpha = torch.tensor((ALPHAS * 2)[:bb], device=dev)
        calls, bounds = {}, {}
        for prec, esize, sdt, tag in (("fp32", 4, torch.float32, ""), ("bf16", 2, torch.bfloat16, "-bf16")):
            xs = x8[:bb].contiguous().to(sdt)
            zero = torch.zeros((bb, gx, gy, gz, 2), device=dev, dtype=sdt)
            carry = bg_fused(xs, cfg, carry=zero, alpha=torch.zeros_like(alpha), precision=prec)[1]
            calls[tag] = {
                "B1": lambda xs=xs, prec=prec: bg_fused(xs, cfg, precision=prec),
                "B2": lambda xs=xs, c=carry, prec=prec: bg_fused(xs, cfg, carry=c, alpha=alpha, precision=prec),
                "B3": lambda xs=xs, prec=prec: bg_fused(xs, cfg, stream_input=True, precision=prec),
            }
            bounds.update({"B1" + tag: bg_fused_bound(bb, H, W, cfg, grid_shape, esize)[0] / bb,
                           "B2" + tag: bg_fused_temporal_bound(bb, H, W, cfg, grid_shape, esize)[0] / bb,
                           "B3" + tag: bg_fused_bound(bb, H, W, cfg, grid_shape, esize)[0] / bb})
        t, td = {}, {}
        for tag in ("", "-bf16", "-bf16", ""):
            for k, fn in calls[tag].items():
                ms, dms = kernel_ms(torch, fn, reps=50)
                t[k + tag] = t.get(k + tag, 0.0) + ms / bb / 2
                td[k + tag] = td.get(k + tag, 0.0) + dms / bb / 2
        out[bb] = {"ms": t, "device_ms": td, "bound_ms": bounds}
        emit({"phase": "bf16_times", "config": "PAPER_DEFAULT", "batch": bb, "ms_per_frame": t,
              "device_ms_per_frame": td, "bound_ms_per_frame": bounds,
              "bf16_over_fp32": {k: t[k + "-bf16"] / t[k] for k in ("B1", "B2", "B3")},
              "device_bf16_over_fp32": {k: td[k + "-bf16"] / td[k] for k in ("B1", "B2", "B3")},
              "order": "fp32, bf16, bf16, fp32; each the mean of its two passes", "card": smi})
    return out


def plan_sweep(torch, x8, smi, dev):
    """Every candidate ``plan_for(precision="auto")`` ranks, timed by call
    (``plan_cost_measured``: the mean of 50 back-to-back dispatches, the
    quantization included; two passes, forward then backward, the faster
    kept), at full HD: PAPER_DEFAULT for 1, 4 and 8 frames per frame and 4
    temporal, the serve grid for 8; the pinned ``"staged"`` plan beside them
    as information. Per workload: the measured best is recorded into a
    temporary plan cache and read back through ``plan_for`` (it must come
    back with provenance "cache"), and the model's pick (auto and fp32) is
    printed with its predicted and measured times and its regret. Then the
    overhead constants are fitted by least squares over every candidate of
    the five fitting workloads (``measured - (compute + memory) ~ [frames,
    launches, streamed launches]``, no intercept), recorded as the cache's
    calibration and printed beside the constants in ``repro_torch/plan.py``,
    with the regret the fitted constants would give. Three held-out
    workloads, which no fit has seen (PAPER_DEFAULT at 1080x1920 for 2
    frames and at 720x1280 for 4, the serve grid for 4), are swept the same
    way and give the model's regret off its fitting data. Returns the fit
    row, with each workload as a record of ``render_plan_sweep_table``'s
    schema under ``records``."""
    import tempfile

    import numpy as np

    import repro_torch.plan as P
    from repro_torch.configs.bg_denoise import PAPER_DEFAULT, SERVE_CONFIG
    from repro_torch.plan_cache import PlanCache, host_fingerprint, workload_key

    paper, serve = PAPER_DEFAULT.bg, SERVE_CONFIG
    # (label, config, frames, temporal, height, width, held out of the fit)
    workloads = [("PAPER_DEFAULT", paper, 1, False, H, W, False), ("PAPER_DEFAULT", paper, 4, False, H, W, False),
                 ("PAPER_DEFAULT", paper, 8, False, H, W, False), ("PAPER_DEFAULT", paper, 4, True, H, W, False),
                 ("serve r=6", serve, 8, False, H, W, False),
                 ("PAPER_DEFAULT", paper, 2, False, H, W, True), ("serve r=6", serve, 4, False, H, W, True),
                 ("PAPER_DEFAULT", paper, 4, False, H * 2 // 3, W * 2 // 3, True)]
    in_code = {"frame_overhead_s": P.FRAME_OVERHEAD_S, "launch_overhead_s": P.LAUNCH_OVERHEAD_S,
               "stream_launch_overhead_s": P.STREAM_LAUNCH_OVERHEAD_S}
    rows, design, target, records = [], [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(os.path.join(tmp, "plan_cache.json"))
        for label, cfg, n, temporal, hh, ww, held_out in workloads:
            frames = x8[:n, :hh, :ww].contiguous()
            cands = P.candidate_plans(cfg, hh, ww, n_frames=n, temporal=temporal,
                                      backends=("fused",) if temporal else ("fused", "fused_streamed"),
                                      device=dev)
            timed = cands + ([] if temporal else [P.BGPlan(cfg, backend="staged", device=dev)])
            meas = {}
            for order in (timed, timed[::-1]):
                for p in order:
                    t = P.plan_cost_measured(p, hh, ww, n, reps=50, frames=frames)
                    meas[p] = min(meas.get(p, float("inf")), t)
            bd = {p: P.plan_cost_breakdown(p, hh, ww, n) for p in cands}
            for p in cands if not held_out else ():
                design.append([float(n), float(bd[p]["steps"]),
                               float(bd[p]["steps"]) if p.backend == "fused_streamed" else 0.0])
                target.append(meas[p] - bd[p]["compute_s"] - bd[p]["memory_s"])
            best = min(cands, key=lambda p: meas[p])
            best32 = min((p for p in cands if p.precision == "fp32"), key=lambda p: meas[p])
            picks, picked = {}, {}
            for mode, prec, ref in (("auto", "auto", best), ("fp32", None, best32)):
                pick = P.plan_for(cfg, hh, ww, n_frames=n, temporal=temporal, precision=prec, cache=False,
                                  device=dev)
                check(pick in meas, f"{label} n={n}: model pick {pick.describe()} is not a swept candidate")
                picked[mode] = pick
                picks[mode] = {"plan": pick.describe(), "predicted_ms": bd[pick]["total_s"] * 1e3,
                               "measured_ms": meas[pick] * 1e3, "regret": meas[pick] / meas[ref]}
            # the winner's quantized output against the fused route's
            want = P.BGPlan(cfg, backend="fused", temporal=False, device=dev)(frames)
            got = best.as_temporal(False)(frames)
            exact, lsb = quantized_agreement(got, want)
            lsb_limit = TOL_BF16_LSB if best.precision == "bf16" else TOL_LSB
            check(lsb <= lsb_limit and (best.precision == "bf16" or exact >= TOL_EXACT),
                  f"{label} n={n}: winner {best.describe()} vs fused: {exact}, {lsb}")
            key = workload_key(cfg, hh, ww, n, temporal, 1, device=dev)
            cache.record(key, best, measured_us=meas[best] * 1e6, model_us=bd[best]["total_s"] * 1e6,
                         source="chip_smoke plan_sweep")
            back = P.plan_for(cfg, hh, ww, n_frames=n, temporal=temporal, precision="auto", cache=cache,
                              device=dev)
            check(back.provenance == "cache" and back == best and back.plan_hash() == best.plan_hash(),
                  f"{label} n={n}: cache read-back gave {back.describe()}, recorded {best.describe()}")
            row = {"phase": "plan_sweep", "config": label, "frame_hw": [hh, ww], "n_frames": n,
                   "temporal": temporal, "held_out": held_out,
                   "columns": ("backend", "batch_tile", "precision", "measured_ms", "model_ms", "launches"),
                   "candidates": [[p.backend, p.batch_tile, p.precision, meas[p] * 1e3,
                                   bd[p]["total_s"] * 1e3, bd[p]["steps"]] for p in cands],
                   "measured_best": {"plan": best.describe(), "measured_ms": meas[best] * 1e3},
                   "measured_best_fp32": {"plan": best32.describe(), "measured_ms": meas[best32] * 1e3},
                   "model_pick": picks["auto"], "model_pick_fp32": picks["fp32"],
                   "winner_vs_fused": {"exact": exact, "max_diff": lsb},
                   "cache_readback": back.describe(),
                   "staged_pinned_ms": None if temporal else meas[timed[-1]] * 1e3,
                   "card": smi}
            emit(row)
            rows.append((row, cands, meas))
            # the same workload as a record of render_plan_sweep_table's schema
            records.append({"workload": f"{label} {hh}x{ww} n={n}{' temporal' if temporal else ''}",
                            "candidates": [{"plan": p.to_json(), "model_us": bd[p]["total_s"] * 1e6,
                                            "measured_us": meas[p] * 1e6} for p in cands],
                            "model_pick": cands.index(picked["auto"]), "measured_best": cands.index(best),
                            "regret": picks["auto"]["regret"]})
        x, y = np.asarray(design), np.asarray(target)
        coef = np.maximum(np.linalg.lstsq(x, y, rcond=None)[0], 0.0)  # overheads are nonnegative
        rms = float(np.sqrt(np.mean((y - x @ coef) ** 2)))
        fitted = dict(zip(in_code, (float(c) for c in coef)))
        cache.record_calibration(host_fingerprint(dev), {**fitted, "rms_residual_s": rms, "n_rows": len(y)})
        check(cache.calibration(host_fingerprint(dev)) is not None, "calibration recorded")

    def refit_regret(row, cands, meas):
        def cost(p):
            bd = P.plan_cost_breakdown(p, *row["frame_hw"], row["n_frames"])
            return (bd["compute_s"] + bd["memory_s"] + coef[0] * row["n_frames"] + coef[1] * bd["steps"]
                    + (coef[2] * bd["steps"] if p.backend == "fused_streamed" else 0.0))

        pick = min(cands, key=cost)
        return {"plan": pick.describe(), "regret": meas[pick] / min(meas[p] for p in cands)}

    def name(r):
        return (f"{r['config']} {r['frame_hw'][0]}x{r['frame_hw'][1]} n={r['n_frames']}"
                f"{' temporal' if r['temporal'] else ''}")

    fit = {"phase": "plan_sweep_fit", "fitted": fitted, "in_code": in_code, "rms_residual_s": rms,
           "n_rows": len(y),
           "in_code_regret": {name(r): r["model_pick"]["regret"] for r, _, _ in rows if not r["held_out"]},
           "in_code_regret_held_out": {name(r): r["model_pick"]["regret"] for r, _, _ in rows if r["held_out"]},
           "fitted_regret": {name(r): refit_regret(r, c, m) for r, c, m in rows if not r["held_out"]},
           "fitted_regret_held_out": {name(r): refit_regret(r, c, m) for r, c, m in rows if r["held_out"]},
           "card": smi}
    emit(fit)
    fit["records"] = records  # for dryrun_slice's plan table (not emitted twice)
    return fit


def guarded_dispatch(torch, frames, smi, dev):
    """The guarded engine on the card at full HD, PAPER_DEFAULT, on the plans
    ``plan_for`` gives for a micro-batch of 8 and for 4 streams:

      * a ``raise_dispatch`` fault on the primary rung, every time: every
        dispatch of the micro-batch (``fused_streamed``) is served by the
        next rung, B1 (``fallbacks == dispatches``), the launch counters
        show B1 and no launch of B3, and the output holds the quantized
        contract against the fused route; the temporal pack's plan
        (``fused``) has no rung below it on the card (the reference rung
        is the CPU's only), so every pack fails with ``AllBackendsFailed``
        (the injected fault its cause) and no kernel launches;
      * one ``hang_completion`` above ``watchdog_ms``: one watchdog trip, and
        the redispatch serves the frames (no failure, no fallback);
      * a NaN frame refused at submit (``AdmissionError``), a post-admission
        ``corrupt_frame`` and a ``corrupt_carry``: exactly their requests
        fail with ``NonFiniteOutput`` and exactly their streams are
        quarantined.

    Returns the phase rows."""
    import numpy as np

    from repro_torch.configs.bg_denoise import PAPER_DEFAULT
    from repro_torch.plan import BGPlan, plan_for
    from repro_torch.reliability import (AdmissionError, AllBackendsFailed, Fault, FaultInjector, FaultPlan,
                                         InjectedFault, NonFiniteOutput, RetryPolicy)
    from repro_torch.serving import AsyncFrameEngine
    from repro_torch.video import MultiStreamPacker

    cfg = PAPER_DEFAULT.bg
    counter = {("fused", False): "bg_fused.launches", ("fused", True): "bg_fused.temporal_launches",
               ("fused_streamed", False): "bg_fused.streamed_launches"}
    policy = RetryPolicy(max_attempts=2, backoff_s=0.0)
    rows = {}

    def rounds(eng, batches, stream=False):
        """Submit each batch and wait for it before the next; returns
        {(round, index): result or exception}."""
        got = {}
        for t, batch in enumerate(batches):
            futs = [eng.submit(f, stream_id=i if stream else None) for i, f in enumerate(batch)]
            for i, fut in enumerate(futs):
                exc = fut.exception(timeout=120.0)
                got[(t, i)] = exc if exc is not None else fut.result()
        return got

    # ---- a micro-batch of 8: the primary rung raises on every dispatch
    plan = plan_for(cfg, H, W, n_frames=8, device=dev, cache=False)
    ladder = plan.fallback_ladder()
    check([p.backend for p in ladder] == ["fused_streamed", "fused"], f"micro-batch ladder: {ladder}")
    nxt = ladder[1]
    batches = [frames[0:8], frames[8:16]]
    fused_ref = BGPlan(cfg, backend="fused", device=dev)(np.concatenate(batches))
    inj = FaultInjector(FaultPlan((Fault("raise_dispatch", backend=plan.backend, times=None),)))
    zero_counts()
    with AsyncFrameEngine(plan=plan, max_batch=8, batch_window_ms=1000.0, fault_injector=inj,
                          retry_policy=policy) as eng:
        got = rounds(eng, batches)
        st = eng.stats()
    sync(torch, dev)
    counts = kernel_counts()
    want = {counter[(nxt.backend, False)]: st.dispatches * -(-8 // nxt.tile_for(8))}
    check_counts(counts, want, f"guarded dispatch: {plan.backend} raising, served by {nxt.backend}")
    check(st.dispatches == 2 and st.fallbacks == st.dispatches and st.failed == 0 and st.completed == 16,
          f"primary-rung fault: {st}")
    out = torch.stack([got[(t, i)] for t in range(2) for i in range(8)])
    exact, lsb = quantized_agreement(out, fused_ref)
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"fallback rung {nxt.backend} vs fused: {exact}, {lsb}")
    rows["raise_frames"] = {"phase": "guarded_dispatch", "case": "raise_dispatch on the primary rung, frames",
                            "plan": plan.describe(), "served_by": nxt.describe(), "dispatches": st.dispatches,
                            "fallbacks": st.fallbacks, "retries": st.retries, "failed": st.failed,
                            "launches": counts, "vs_fused_exact": exact, "vs_fused_max_diff": lsb,
                            "injected": list(inj.fired), "card": smi}
    emit(rows["raise_frames"])

    # ---- 4 streams: the primary rung raises on every pack, and there is no
    # rung below it
    vplan = plan_for(cfg, H, W, n_frames=4, temporal=True, device=dev, cache=False)
    check([p.backend for p in vplan.fallback_ladder()] == ["fused"], f"temporal ladder: {vplan.fallback_ladder()}")
    packs = [[frames[(4 * t + s) % len(frames)] for s in range(4)] for t in range(3)]

    def packer_on(p, alphas=ALPHAS):
        pk = MultiStreamPacker(plan=p)
        for s in range(4):
            pk.open(s, alpha=alphas[s])
        return pk

    inj = FaultInjector(FaultPlan((Fault("raise_dispatch", backend=vplan.backend, times=None),)))
    zero_counts()
    with AsyncFrameEngine(packer=packer_on(vplan), max_batch=4, batch_window_ms=1000.0, fault_injector=inj,
                          retry_policy=policy) as eng:
        got = rounds(eng, packs, stream=True)
        st = eng.stats()
    sync(torch, dev)
    counts = kernel_counts()
    check_counts(counts, {}, f"guarded video: {vplan.backend} raising, no rung below it")
    check(all(isinstance(v, AllBackendsFailed) and isinstance(v.__cause__, InjectedFault) for v in got.values())
          and len(got) == 12, f"every pack fails with AllBackendsFailed: {got}")
    check(st.dispatches == 0 and st.fallbacks == 0 and st.retries == 3 and st.failed == 12 and st.completed == 0
          and st.carry_resets == 0, f"primary-rung fault, video: {st}")
    rows["raise_video"] = {"phase": "guarded_dispatch", "case": "raise_dispatch on the primary rung, 4 streams",
                           "plan": vplan.describe(), "served_by": None, "dispatches": st.dispatches,
                           "fallbacks": st.fallbacks, "retries": st.retries, "failed": st.failed,
                           "error": type(got[(0, 0)]).__name__, "launches": counts, "card": smi}
    emit(rows["raise_video"])

    # ---- one hung completion above the watchdog
    watchdog_ms, hang_s = 500.0, 1.5
    inj = FaultInjector(FaultPlan((Fault("hang_completion", dispatch=1, delay_s=hang_s),)))
    zero_counts()
    with AsyncFrameEngine(plan=plan, max_batch=8, batch_window_ms=1000.0, fault_injector=inj,
                          watchdog_ms=watchdog_ms) as eng:
        got = rounds(eng, batches)
        st = eng.stats()
    # the timed-out wait's helper thread sleeps on, then synchronizes its
    # event: a CUDA call that breaks any graph capture it overlaps (the
    # later phases time kernels in graphs), so wait for it here
    for t in threading.enumerate():
        if t.name == "bg-frame-await":
            t.join(4 * hang_s)
            check(not t.is_alive(), "hung completion: the helper thread ends with its sleep")
    sync(torch, dev)
    counts = kernel_counts()
    check_counts(counts, {counter[(plan.backend, False)]: 3 * -(-8 // plan.tile_for(8))},
                 "hung completion: two dispatches and the redispatch")
    check(st.watchdog_trips == 1 and st.failed == 0 and st.completed == 16 and st.fallbacks == 0,
          f"hung completion: {st}")
    out = torch.stack([got[(t, i)] for t in range(2) for i in range(8)])
    exact, lsb = quantized_agreement(out, fused_ref)
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"redispatched frames vs fused: {exact}, {lsb}")
    rows["hang"] = {"phase": "guarded_dispatch", "case": "hang_completion above the watchdog",
                    "plan": plan.describe(), "watchdog_ms": watchdog_ms, "hang_s": hang_s,
                    "watchdog_trips": st.watchdog_trips, "dispatches": st.dispatches, "retries": st.retries,
                    "fallbacks": st.fallbacks, "failed": st.failed, "launches": counts,
                    "vs_fused_exact": exact, "vs_fused_max_diff": lsb, "card": smi}
    emit(rows["hang"])

    # ---- corrupted input: refused at submit; corrupted after admission;
    # a corrupted carry
    faults = (Fault("corrupt_frame", stream_id=0, frame_index=1, mode="nan"),
              Fault("corrupt_carry", stream_id=2, dispatch=1, mode="inf"))
    inj = FaultInjector(FaultPlan(faults, seed=0))
    packer = packer_on(vplan, alphas=(0.6, 0.6, 0.6, 0.6))
    quarantined = []
    real = packer.quarantine
    packer.quarantine = lambda sid: (quarantined.append(sid), real(sid))[1]
    with AsyncFrameEngine(packer=packer, max_batch=4, batch_window_ms=1000.0, fault_injector=inj) as eng:
        bad = np.array(frames[0], copy=True)
        bad[5, 7] = np.nan
        try:
            eng.submit(bad, stream_id=1)
            refused = False
        except AdmissionError:
            refused = True
        submitted_after_refusal = eng.stats().submitted
        got = rounds(eng, packs + [packs[0]], stream=True)
        st = eng.stats()
    failed = sorted(k for k, v in got.items() if isinstance(v, Exception))
    check(refused and submitted_after_refusal == 0, "a NaN frame is refused at submit")
    check(all(isinstance(got[k], NonFiniteOutput) for k in failed) and failed == [(1, 0), (2, 2)],
          f"exactly the corrupted requests fail: {failed}")
    check(all(bool(torch.isfinite(v).all()) for v in got.values() if not isinstance(v, Exception)),
          "no non-finite frame served")
    check(sorted(quarantined) == [0, 2] and st.carry_resets == 2, f"quarantined {quarantined}")
    check(st.retries == st.fallbacks == st.watchdog_trips == 0 and inj.fired == [1, 1], f"corrupted input: {st}")
    rows["corrupt"] = {"phase": "guarded_dispatch", "case": "admission, corrupt_frame, corrupt_carry",
                       "plan": vplan.describe(), "nan_frame_refused_at_submit": refused,
                       "failed_requests": [list(k) for k in failed], "quarantined": quarantined,
                       "carry_resets": st.carry_resets, "failed": st.failed, "injected": list(inj.fired),
                       "card": smi}
    emit(rows["corrupt"])
    return rows


FLEET_ALPHA = 0.6
B2 = "bg_fused.temporal_launches"


def fleet_traffic(n_streams: int, n_frames: int):
    """Noisy full-size video frames on the host, one (frames, h, w) float32
    array per stream, as ``serve_fleet`` makes its traffic."""
    import numpy as np

    from repro_torch.data import synthetic_video_np

    rng = np.random.default_rng(0)
    out = []
    for s in range(n_streams):
        vid = synthetic_video_np(s, n_frames, H, W, motion=1.5)
        noisy = vid + rng.normal(0.0, 30.0, vid.shape)
        out.append(np.clip(np.floor(noisy + 0.5), 0.0, 255.0).astype(np.float32))
    return out


def fleet_served(st: dict, what: str) -> None:
    """A served fleet run answered every frame: 0 failed, shed, router
    shed, retries, fallbacks and watchdog trips, every worker alive."""
    keys = ("failed", "shed", "router_shed", "retries", "fallbacks", "watchdog_trips")
    check(not any(st[k] for k in keys) and st["workers_alive"] == st["workers"],
          f"{what}: {({k: st[k] for k in keys + ('workers_alive',)})}")


def ref_outputs(torch, payload, dev, frames, upto: int):
    """Frames 0..``upto`` of one stream through an uninterrupted in-process
    worker, one frame per pack; returns the host outputs."""
    from repro_torch.fleet import LocalWorker

    ref = LocalWorker("ref", payload, device=dev, max_batch=1)
    try:
        ref.open_stream(0, alpha=FLEET_ALPHA)
        return [ref.submit(frames[t], stream_id=0).result(timeout=60).cpu().numpy()
                for t in range(upto + 1)]
    finally:
        ref.close(timeout=30)


def fleet_failover(torch, dev, n_frames: int = 4, in_flight: int = 4) -> dict:
    """Two subprocess workers behind a router with its watchdog: 4 warm
    streams, each output held to an in-process worker's bit for bit; then
    frames in flight, one child SIGKILLed. Every future resolves (a result
    or ``WorkerDown``) within a bounded wait, the victim's warm streams are
    restored onto the survivor from its shipped snapshots, and the next
    frame of each restored stream equals an uninterrupted worker's bit for
    bit."""
    import numpy as np

    from repro_torch.configs.bg_denoise import SERVE_CONFIG
    from repro_torch.fleet import FleetRouter, PlanController, WorkerDown

    n_streams = 4
    traffic = fleet_traffic(n_streams, n_frames + in_flight + 1)
    controller = PlanController(cfg=SERVE_CONFIG, height=H, width=W, streams_per_worker=2,
                                temporal=True, device=dev)
    payload = controller.payload()
    refs = {s: ref_outputs(torch, payload, dev, traffic[s], n_frames + in_flight)
            for s in range(n_streams)}
    t0 = time.perf_counter()
    router = FleetRouter(controller=controller, n_workers=2, worker_backend="subprocess",
                         health_interval_s=0.1,
                         worker_kwargs=dict(device=str(dev), max_batch=2, batch_window_ms=5.0,
                                            snapshot_interval_s=0.25))
    start_s = time.perf_counter() - t0
    try:
        for s in range(n_streams):
            router.open_stream(s, alpha=FLEET_ALPHA)
        for t in range(n_frames):
            futs = [router.submit(traffic[s][t], stream_id=s) for s in range(n_streams)]
            for s, f in enumerate(futs):
                out = f.result(timeout=60)
                check(isinstance(out, np.ndarray) and np.array_equal(out, refs[s][t]),
                      f"fleet failover: stream {s} frame {t} differs from the local worker")
        victim = router.stream_worker(0)
        vworker = next(w for w in router.workers if w.wid == victim)
        victims = sorted(s for s in range(n_streams) if router.stream_worker(s) == victim)
        check(sorted(vworker.request_snapshot()) == victims, "fleet failover: snapshots of the victim")
        launches = {w.wid: w.launches() for w in router.workers}
        futs = [router.submit(traffic[s][t], stream_id=s)
                for t in range(n_frames, n_frames + in_flight) for s in range(n_streams)]
        router.crash_worker(victim)  # SIGKILL, the router not told
        t_kill = time.perf_counter()
        served = down = 0
        for f in futs:
            try:
                f.result(timeout=30)
                served += 1
            except WorkerDown:
                down += 1
        resolve_s = time.perf_counter() - t_kill
        deadline = time.monotonic() + 10.0
        while not router.is_dead(victim) and time.monotonic() < deadline:
            time.sleep(0.02)
        check(router.is_dead(victim), "fleet failover: the watchdog did not see the SIGKILL")
        check(router.restores == len(victims) and router.quarantined_streams == 0,
              f"fleet failover: {router.restores} restores, {router.quarantined_streams} cold, "
              f"victims {victims}")
        seen = {}
        for s in victims:
            # the survivor's store holds the snapshot it was restored from
            k = router.workers[router.stream_worker(s)].carry_snapshot(s).frames_seen
            seen[s] = k
            out = router.submit(traffic[s][k], stream_id=s).result(timeout=60)
            check(np.array_equal(out, refs[s][k]),
                  f"fleet failover: restored stream {s} frame {k} differs from an uninterrupted worker")
        st = router.stats()
    finally:
        router.close(timeout=30)
    check(all(launches[w].get(B2, 0) > 0 and set(launches[w]) == {B2} for w in launches),
          f"fleet failover: child launches {launches}")
    return {"workers_start_s": start_s, "victim": victim, "victim_streams": victims,
            "in_flight": len(futs), "served_after_kill": served, "worker_down": down,
            "resolve_s": resolve_s, "restores": st.restores, "quarantined": st.quarantined_streams,
            "restore_staleness_p99_s": st.restore_staleness_p99, "restored_frames_seen": seen,
            "child_launches_before_kill": launches, "bitwise_vs_local_frames": n_frames * n_streams,
            "bitwise_after_restore": len(victims)}


def fleet_bf16_snapshot(torch, dev) -> dict:
    """A 2-worker local fleet on a pinned bf16 temporal plan with snapshots:
    only B2-bf16 launches, one per dispatch; the victim's snapshots carry
    "bfloat16" words, half the fp32 bytes, and the restore on the survivor
    gives back the same bits."""
    from repro_torch.configs.bg_denoise import SERVE_CONFIG
    from repro_torch.fleet import FleetRouter, PlanController, codec
    from repro_torch.plan import BGPlan

    plan = BGPlan(SERVE_CONFIG, backend="fused", temporal=True, precision="bf16", device=dev)
    traffic = fleet_traffic(4, 3)
    router = FleetRouter(controller=PlanController(plan), n_workers=2, health_interval_s=None,
                         worker_kwargs=dict(device=dev, max_batch=2, snapshots=True))
    zero_counts()
    try:
        for s in range(4):
            router.open_stream(s, alpha=FLEET_ALPHA)
        for t in range(3):
            for f in [router.submit(traffic[s][t], stream_id=s) for s in range(4)]:
                f.result(timeout=60)
        sync(torch, dev)
        st = router.stats()
        check_counts(kernel_counts(), {"bg_fused.bf16_temporal_launches": st.merged.dispatches},
                     "fleet bf16")
        victim = router.stream_worker(0)
        vworker = next(w for w in router.workers if w.wid == victim)
        victims = sorted(s for s in range(4) if router.stream_worker(s) == victim)
        want = {s: vworker.packer.sessions[s].carry.clone() for s in victims}
        snap = vworker.carry_snapshot(0)
        hdr, data = codec.array_header(snap.carry), codec.array_bytes(snap.carry)
        check(hdr["dtype"] == "bfloat16" and len(data) * 2 == want[0].numel() * 4,
              f"fleet bf16: snapshot {hdr}, {len(data)} bytes")
        back = codec.decode_array(hdr, data)
        check(back.dtype == torch.bfloat16 and torch.equal(back, want[0].cpu()), "fleet bf16: wire bits")
        router.fail_worker(victim)
        survivor = next(w for w in router.workers if w.wid != victim)
        check(router.restores == len(victims), f"fleet bf16: {router.restores} restores of {victims}")
        check(all(torch.equal(survivor.packer.sessions[s].carry, want[s]) for s in victims),
              "fleet bf16: restored carries differ from the victim's")
    finally:
        router.close(timeout=30)
    return {"precision": "bf16", "dispatches": st.merged.dispatches, "snapshot_dtype": hdr["dtype"],
            "snapshot_bytes": len(data), "fp32_bytes": want[0].numel() * 4,
            "restored_bitwise": len(victims)}


def fleet_stateless(torch, dev, micro_batch: int, n_frames: int) -> dict:
    """Two local workers on ``plan_for``'s frame plan for micro-batches of
    ``micro_batch``: every dispatch launches the plan's kernel once (B3 at
    8, B1 at 1 on the cost model), no other kernel runs, and each output
    equals its frame served alone through one in-process worker on the
    same plan, bit for bit (the kernels are bit-equal across packs)."""
    from repro_torch.configs.bg_denoise import SERVE_CONFIG
    from repro_torch.fleet import FleetRouter, LocalWorker, PlanController

    traffic = fleet_traffic(1, n_frames)[0]
    controller = PlanController(cfg=SERVE_CONFIG, height=H, width=W,
                                streams_per_worker=micro_batch, temporal=False, device=dev)
    plan = controller.plan
    router = FleetRouter(controller=controller, n_workers=2, health_interval_s=None,
                         worker_kwargs=dict(device=dev, max_batch=micro_batch, batch_window_ms=5.0))
    zero_counts()
    try:
        t0 = time.perf_counter()
        futs = [router.submit(traffic[i]) for i in range(n_frames)]
        outs = [f.result(timeout=60) for f in futs]
        seconds = time.perf_counter() - t0
        sync(torch, dev)
        st = router.stats()
        launches = {w.wid: w.launches() for w in router.workers}
    finally:
        router.close(timeout=30)
    ran = "bg_fused.streamed_launches" if plan.backend == "fused_streamed" else "bg_fused.launches"
    per = -(-micro_batch // plan.batch_tile)
    got = kernel_counts()
    check(got[ran] > 0 and got[ran] <= st.merged.dispatches * per
          and got[ran] >= st.merged.dispatches, f"fleet stateless b={micro_batch}: {got}")
    check_counts(got, {ran: got[ran]}, f"fleet stateless b={micro_batch}")
    check(sum(v.get(ran, 0) for v in launches.values()) == got[ran], f"per-worker launches {launches}")
    check(all(o.is_cuda and tuple(o.shape) == (H, W) for o in outs), "fleet stateless: CUDA (h, w) results")
    check(st.merged.failed == st.merged.shed == st.router_shed == 0, f"fleet stateless: {st.as_dict()}")
    reliability_zero(st.merged, f"fleet stateless b={micro_batch}")
    alone = LocalWorker("alone", controller.payload(), device=dev, max_batch=1)
    try:  # after the counts were read: these launches are the comparison's
        ref = [alone.submit(traffic[i]).result(timeout=60) for i in range(n_frames)]
    finally:
        alone.close(timeout=30)
    differ = [i for i in range(n_frames) if not torch.equal(outs[i], ref[i])]
    check(not differ, f"fleet stateless b={micro_batch}: frames {differ} differ from the frame served alone")
    return {"micro_batch": micro_batch, "frames": n_frames, "plan": plan.describe(),
            "dispatches": st.merged.dispatches, "mean_batch": st.merged.mean_batch,
            "launches": {ran: got[ran]}, "worker_launches": launches, "seconds": seconds,
            "frames_per_s": n_frames / seconds, "bitwise_alone": True}


def fleet_slice(torch, smi, dev) -> float:
    """Phase "fleet": the port's fleet on the card at full HD on the serve
    grid (the JAX launcher's fleet config), on ``plan_for``'s plans. The
    local and the subprocess temporal fleets through the launcher's
    ``serve_fleet`` (B2 only; the in-process workers' launches equal the
    dispatches, each child's counted over its stats RPC), the SIGKILL
    failover with its bit-for-bit checks, the bf16 snapshot, the stateless
    fleet at micro-batch 8 and 1. First one engine (``serve_video``) on the
    same grid and traffic, the yardstick of the thread-hosted fleet.
    Returns the phase's seconds."""
    from repro_torch.launch.serve import serve_fleet, serve_video

    t_phase = time.perf_counter()
    one = serve_video(4, 24, H, W, FLEET_ALPHA, config="serve", device=dev)
    check(one["bg_fused_temporal_launches"] == one["dispatches"] > 0 and one["bg_fused_launches"] == 0,
          f"fleet one engine: {one}")
    check(not any(one[k] for k in ("failed", "shed", "retries", "fallbacks", "watchdog_trips")),
          f"fleet one engine: {one}")
    emit({"phase": "fleet", "run": "one_engine", "config": "serve (6, 4, 60)", "frame_hw": [H, W],
          "card": smi, **one})
    zero_counts()
    st = serve_fleet(4, 24, H, W, FLEET_ALPHA, workers=2, worker_backend="local", device=dev)
    sync(torch, dev)
    check(st["dispatches"] > 0, f"fleet local: {st}")
    check_counts(kernel_counts(), {B2: st["dispatches"]}, "fleet local")
    check(sum(v.get(B2, 0) for v in st["worker_launches"].values()) == st["dispatches"]
          and all(set(v) <= {B2} for v in st["worker_launches"].values()),
          f"fleet local: worker launches {st['worker_launches']}")
    fleet_served(st, "fleet local")
    emit({"phase": "fleet", "run": "local", "config": "serve (6, 4, 60)", "frame_hw": [H, W],
          "card": smi, **st})

    zero_counts()
    st = serve_fleet(4, 24, H, W, FLEET_ALPHA, workers=2, worker_backend="subprocess", device=dev)
    check_counts(kernel_counts(), {}, "fleet subprocess: the parent launches nothing")
    check(all(v.get(B2, 0) > 0 and set(v) == {B2} for v in st["worker_launches"].values())
          and sum(v[B2] for v in st["worker_launches"].values()) == st["dispatches"],
          f"fleet subprocess: child launches {st['worker_launches']}")
    fleet_served(st, "fleet subprocess")
    emit({"phase": "fleet", "run": "subprocess", "config": "serve (6, 4, 60)", "frame_hw": [H, W],
          "card": smi, **st})

    emit({"phase": "fleet", "run": "failover", "card": smi, **fleet_failover(torch, dev)})
    emit({"phase": "fleet", "run": "bf16_snapshot", "card": smi, **fleet_bf16_snapshot(torch, dev)})
    for mb, n in ((8, 32), (1, 8)):
        emit({"phase": "fleet", "run": "stateless", "card": smi, **fleet_stateless(torch, dev, mb, n)})
    seconds = time.perf_counter() - t_phase
    emit({"phase": "fleet", "run": "done", "seconds": seconds, "card": smi})
    return seconds


def kernel_counts() -> dict:
    """Every launch counter of the port, ``{"bg_fused.launches": n, ...}``."""
    from repro_torch.kernels import launch_counts

    return launch_counts()


def zero_counts() -> None:
    import repro_torch.kernels as k

    for fn, attr in k.COUNTERS:
        setattr(getattr(k, fn), attr, 0)


def check_counts(got: dict, want: dict, what: str) -> None:
    """Every counter is 0 but those in ``want``, which equal their value."""
    expected = {k: want.get(k, 0) for k in got}
    check(got == expected, f"{what}: launches {got}, expected {expected}")


def streamed_vs_fused(torch, x4, label, cfg, b1_out, plain):
    """B3 against B1 on 4 full-HD frames: bit for bit on the frames, at a
    ragged width (1918 columns: rows of 7,672 B, not a multiple of 16), at
    b=1 against the single frame, and across two launches. Returns the
    largest |B3 - plain|."""
    from repro_torch.kernels import bg_fused

    s = bg_fused(x4, cfg, stream_input=True)
    s_again = bg_fused(x4, cfg, stream_input=True)
    xr = x4[:, :, : W - 2].contiguous()
    ragged_b1, ragged_b3 = bg_fused(xr, cfg), bg_fused(xr, cfg, stream_input=True)
    single = bg_fused(x4[2].contiguous(), cfg, stream_input=True)
    one = bg_fused(x4[2:3].contiguous(), cfg, stream_input=True)
    sync(torch, x4.device)
    err = float((s - plain).abs().max())
    row = {"phase": "streamed_vs_fused", "config": label, "shape": list(x4.shape),
           "bitwise_b1": bool(torch.equal(s, b1_out)),
           "ragged_shape": list(xr.shape), "ragged_bitwise_b1": bool(torch.equal(ragged_b3, ragged_b1)),
           "b1_bitwise_single": bool(torch.equal(one[0], single) and torch.equal(single, s[2])),
           "repeat_bitwise": bool(torch.equal(s, s_again)), "max_abs_err_vs_plain": err}
    emit(row)
    check(s.shape == x4.shape and bool(torch.isfinite(s).all()), f"{label}: B3 shape/finite")
    check(row["bitwise_b1"] and row["ragged_bitwise_b1"], f"{label}: B3 differs from B1")
    check(row["b1_bitwise_single"] and row["repeat_bitwise"], f"{label}: B3 bitwise contracts")
    check(err <= TOL_ABS, f"{label}: max |B3 - plain| {err} > {TOL_ABS}")
    return err


def staged_vs_plain(torch, x4, label, cfg):
    """B4, B5 and B6 against their plain versions on 4 full-HD frames at the
    JAX package's tolerances, and the staged backend's quantized output
    against the fused backend's. Returns the largest GC, GF and TI errors."""
    from repro_torch.core import grid_normalize
    from repro_torch.kernels import (bg_blur, bg_blur_plain, bg_create, bg_create_plain,
                                     bg_fused, bg_slice, bg_slice_plain)
    from repro_torch.plan import BGPlan

    dev = x4.device
    grid = bg_create(x4, cfg)
    blurred = bg_blur(grid, cfg)
    gf = grid_normalize(blurred)
    out = bg_slice(gf, x4, cfg)
    gc_plain = bg_create_plain(x4, cfg)
    gc_err = float((grid - gc_plain).abs().max())
    gc_bitwise = bool(torch.equal(grid, gc_plain))
    blurred_plain = bg_blur_plain(grid, cfg)
    gf_err = float((blurred - blurred_plain).abs().max())
    gf_ok = bool(torch.allclose(blurred, blurred_plain, rtol=TOL_GF[0], atol=TOL_GF[1]))
    ti_err = float((out - bg_slice_plain(gf, x4, cfg)).abs().max())
    # B1's blurred grid, read from B2's carry at alpha 0 on a zero carry
    # (1*B + 0*0 is B exactly): every kernel compiles the GF taps as
    # bg::tap3, so B5's grid equals it bit for bit
    fused_blur = bg_fused(x4, cfg, carry=torch.zeros_like(grid), alpha=torch.zeros(len(x4), device=dev))[1]
    gf_fused_differ = int((blurred != fused_blur).sum())
    gf_plain_differ = int((blurred != blurred_plain).sum())
    counted = float(grid[..., 0].sum())
    staged_q = BGPlan(cfg, backend="staged", device=dev)(x4)
    fused_q = BGPlan(cfg, backend="fused", device=dev)(x4)
    sync(torch, dev)
    exact, lsb = quantized_agreement(staged_q, fused_q)
    emit({"phase": "staged_vs_plain", "config": label, "shape": list(x4.shape),
          "grid_shape": list(grid.shape), "gc_max_abs_err": gc_err, "gc_bitwise_plain": gc_bitwise,
          "gc_counts": counted,
          "gf_max_abs_err": gf_err, "gf_within_tolerance": gf_ok, "ti_max_abs_err": ti_err,
          "gf_values": blurred.numel(), "gf_values_differing_from_fused": gf_fused_differ,
          "gf_values_differing_from_plain": gf_plain_differ,
          "tolerances": {"gc": 0.0, "gf": list(TOL_GF), "ti": TOL_TI},
          "staged_vs_fused_exact": exact, "staged_vs_fused_max_diff": lsb})
    check(bool(torch.isfinite(out).all()) and out.shape == x4.shape, f"{label}: staged shape/finite")
    check(gc_bitwise and counted == x4.numel(), f"{label}: B4 differs from plain by {gc_err}, counts {counted}")
    check(gf_ok, f"{label}: GF err {gf_err}")
    check(gf_fused_differ == 0, f"{label}: B5 differs from B1's blurred grid on {gf_fused_differ} values")
    check(ti_err <= TOL_TI, f"{label}: TI err {ti_err}")
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"{label}: staged vs fused {exact}, {lsb}")
    return gc_err, gf_err, ti_err


def streamed_slice(torch, cfg, frames, ref, dev):
    """The JAX engine's ``stream_input=True`` form: 19 full-HD requests at
    max_batch 8 through ``FrameDenoiseEngine(cfg, stream_input=True)``,
    counted, and held to the reference backend's output ``ref``."""
    from repro_torch.serving import FrameDenoiseEngine, FrameRequest

    eng = FrameDenoiseEngine(cfg, max_batch=8, stream_input=True, device=dev)
    zero_counts()
    for i, f in enumerate(frames):
        eng.submit(FrameRequest(uid=i, frame=f))
    done, dispatches = [], 0
    while eng.pending():
        done.extend(eng.step())
        dispatches += 1
    sync(torch, dev)
    counts = kernel_counts()
    check(eng.plan.backend == "fused_streamed", f"engine plan {eng.plan.describe()}")
    check([r.uid for r in done] == list(range(len(frames))), "every request answered in order")
    check(dispatches == 3, f"{dispatches} dispatches")
    check_counts(counts, {"bg_fused.streamed_launches": 3}, "streamed slice")
    out = torch.stack([r.result for r in done])
    check(out.device == dev and bool(torch.isfinite(out).all()) and tuple(out.shape[1:]) == (H, W),
          "streamed output")
    exact, lsb = quantized_agreement(out, ref)
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"streamed vs reference backend: {exact}, {lsb}")
    row = {"phase": "streamed_slice", "requests": len(frames), "max_batch": 8, "dispatches": dispatches,
           "launches": counts, "vs_reference_exact": exact, "vs_reference_max_diff": lsb}
    emit(row)
    return row


def staged_slice(torch, cfg, frames, fused_out, dev):
    """``BGPlan(backend="staged")`` through ``denoise_batch`` on 8 full-HD
    frames: one launch each of B4, B5 and B6, output held to the fused
    backend's ``fused_out``."""
    from repro_torch.data.pipeline import denoise_batch
    from repro_torch.plan import BGPlan

    plan = BGPlan(cfg, backend="staged", device=dev)
    zero_counts()
    out = denoise_batch(frames, plan=plan)
    sync(torch, dev)
    counts = kernel_counts()
    check_counts(counts, {"bg_create.launches": 1, "bg_blur.launches": 1, "bg_slice.launches": 1},
                 "staged slice")
    check(out.device == dev and tuple(out.shape) == (len(frames), H, W) and bool(torch.isfinite(out).all()),
          "staged output")
    exact, lsb = quantized_agreement(out, fused_out)
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"staged vs fused backend: {exact}, {lsb}")
    row = {"phase": "staged_slice", "frames": len(frames), "dispatches": 1, "launches": counts,
           "vs_fused_exact": exact, "vs_fused_max_diff": lsb}
    emit(row)
    return row


def index_add_create(torch, frames, cfg):
    """The library yardstick of B4: one ``index_add_`` of each pixel's
    (1, px), zero outside the z range, into its cell of a zeroed (cells, 2)
    grid; the cell of every pixel is computed from the frames outside the
    timed call. Returns (call, its (b, gx, gy, gz, 2) output)."""
    import numpy as np

    from repro_torch.kernels.common import gc_cells, grid_shape

    b, h, w = frames.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    dev = frames.device
    zbin = torch.floor(frames * float(np.float32(1.0 / cfg.range_scale)) + 0.5).long()
    inside = ((zbin >= 0) & (zbin < gz)).to(torch.float32)
    frame = torch.arange(b, device=dev)[:, None, None]
    xc = torch.as_tensor(gc_cells(h, cfg.r), device=dev)[None, :, None]
    yc = torch.as_tensor(gc_cells(w, cfg.r), device=dev)[None, None, :]
    cell = (((frame * gx + xc) * gy + yc) * gz + zbin.clamp(0, gz - 1)).reshape(-1)
    vals = torch.stack([inside, frames * inside], -1).reshape(-1, 2)
    n = b * gx * gy * gz

    def call():
        return torch.zeros((n, 2), device=dev).index_add_(0, cell, vals)

    return call, call().reshape(b, gx, gy, gz, 2)


def conv3d_blur(torch, grid, cfg):
    """The library yardstick of B5: one grouped ``conv3d`` with the 3x3x3
    outer-product taps over the two channels of a (b, 2, gx, gy, gz) grid.
    Returns (call, its output in the (b, gx, gy, gz, 2) layout)."""
    import torch.nn.functional as F

    from repro_torch.kernels.common import taps_np

    t = torch.as_tensor(taps_np(cfg), device=grid.device)
    weight = (t[:, None, None] * t[None, :, None] * t[None, None, :]).expand(2, 1, 3, 3, 3).contiguous()
    gp = grid.permute(0, 4, 1, 2, 3).contiguous()

    def call():
        return F.conv3d(gp, weight, padding=1, groups=2)

    return call, call().permute(0, 2, 3, 4, 1)


def grid_sample_slice(torch, gf, frames, cfg):
    """The library yardstick of B6: one 3-D trilinear ``grid_sample`` of the
    (b, 1, gx, gy, gz) scalar grid at each pixel's (i/r, j/r, px/rs), zero
    outside, corners aligned. Returns (call, its (b, h, w) output)."""
    import numpy as np
    import torch.nn.functional as F

    b, h, w = frames.shape
    gx, gy, gz = gf.shape[1:]
    dev = frames.device
    fz = frames * float(np.float32(1.0 / cfg.range_scale))
    fy = (torch.arange(w, device=dev, dtype=torch.float32) / cfg.r).expand(b, h, w)
    fx = (torch.arange(h, device=dev, dtype=torch.float32) / cfg.r)[:, None].expand(b, h, w)
    coords = torch.stack([fz / (gz - 1) * 2 - 1, fy / (gy - 1) * 2 - 1, fx / (gx - 1) * 2 - 1], -1)[:, None]
    inp = gf[:, None]

    def call():
        return F.grid_sample(inp, coords, mode="bilinear", padding_mode="zeros", align_corners=True)

    return call, call()[:, 0, 0]


def kernel_sweep(torch, x, cfg, label, limits):
    """The split knobs of B1 (stripes per block, column tile from the whole
    width down to a sixth, rows of every raw plane per GC step) on the
    frames ``x``, and of B5 (run of x-planes, y tile) on their grid, beside
    one grouped ``conv3d`` of B5's function. Every variant is checked bit
    for bit against the default launch before it is timed, both ways
    (``kernel_ms``). Returns one phase row per kernel."""
    import itertools

    from repro_torch.kernels import bg_create

    kmod = importlib.import_module("repro_torch.kernels.bg_fused")
    bmod = importlib.import_module("repro_torch.kernels.bg_blur")
    g = bg_create(x, cfg)
    b, h, w = x.shape
    gx, gy, gz = g.shape[1:4]
    nc = -(-w // cfg.r)
    rows = []
    cols = ("band", "tile", "rows", "ms_per_frame", "device_ms_per_frame")
    out, ref = torch.empty_like(x), kmod.bg_fused(x, cfg)
    default = kmod.launch_geometry(b, h, w, cfg, *limits)
    seen, variants = set(), []
    tiles = sorted({-(-nc // k) for k in (1, 2, 3, 4, 6)}, reverse=True)
    for band, tile, depth in itertools.product((1, 2, 3, 4, 6, 8), tiles, (1, 2, 3, 4, 6)):
        geo = kmod.launch_geometry(b, h, w, cfg, *limits, band=band, tile=tile, rows=depth)
        if geo in seen:  # a knob cut to the same launch
            continue
        seen.add(geo)
        out.fill_(float("nan"))
        kmod._launch(x, out, cfg, band=band, tile=tile, rows=depth)
        check(torch.equal(out, ref), f"B1 {geo} differs from the default launch {default}")
        t = kernel_ms(torch, lambda: kmod._launch(x, out, cfg, band=band, tile=tile, rows=depth), reps=20)
        variants.append([geo.band, geo.tile, geo.rows, t[0] / b, t[1] / b])
    rows.append({"phase": "kernel_sweep", "kernel": "B1", "config": label, "batch": b,
                 "default": default._asdict(), "columns": cols, "variants": variants,
                 "all_bitwise_default": True})
    g_out, g_ref = torch.empty_like(g), torch.empty_like(g)
    bmod._launch(g, g_ref, cfg)
    default = bmod.blur_geometry(b, gx, gy, gz, *limits)
    seen, variants = set(), []
    for run, k in itertools.product((1, 2, 3, 4, 6, 8, 12), (1, 2, 3, 4, 6)):
        geo = bmod.blur_geometry(b, gx, gy, gz, *limits, run=run, ytile=-(-gy // k))
        if geo in seen:
            continue
        seen.add(geo)
        g_out.fill_(float("nan"))
        bmod._launch(g, g_out, cfg, run=geo[0], ytile=geo[2])
        check(torch.equal(g_out, g_ref), f"B5 {geo} differs from the default launch {default}")
        t = kernel_ms(torch, lambda: bmod._launch(g, g_out, cfg, run=geo[0], ytile=geo[2]), reps=20)
        variants.append([geo[0], geo[2], t[0] / b, t[1] / b])
    conv = kernel_ms(torch, conv3d_blur(torch, g, cfg)[0], reps=20)
    rows.append({"phase": "kernel_sweep", "kernel": "B5", "config": label, "batch": b,
                 "default": dict(zip(("run", "runs", "ytile", "ytiles", "smem"), default)),
                 "columns": ("run", "ytile", "ms_per_frame", "device_ms_per_frame"), "variants": variants,
                 "all_bitwise_default": True, "conv3d_ms_per_frame": conv[0] / b,
                 "conv3d_device_ms_per_frame": conv[1] / b})
    return rows


def stream_sweep(torch, x, cfg, limits):
    """B3's knobs on the frames ``x``: band x column tile at the rule's
    chunk and z group, then chunk x z group at the rule's band and tile.
    The default launch is checked bit for bit against B1, every variant
    against the default, before it is timed both ways (``kernel_ms``).
    Returns the phase row."""
    import itertools

    kmod = importlib.import_module("repro_torch.kernels.bg_fused")
    b, h, w = x.shape
    n, nc = -(-h // cfg.r), -(-w // cfg.r)
    out, ref = torch.empty_like(x), kmod.bg_fused(x, cfg)
    default = kmod._stream_launch(x, out, cfg)
    check(torch.equal(out, ref), f"B3 {default} differs from B1")
    bands = sorted({1, 2, 3, 4, 6, 8, 12, 15, 23, n, default.band})
    tiles = sorted({-(-nc // k) for k in (2, 3, 4, 6, 8)} | {default.tile})
    knobs = [dict(band=bd, tile=tl) for bd, tl in itertools.product(bands, tiles)]
    knobs += [dict(band=default.band, tile=default.tile, chunk=c, zgroup=z)
              for c, z in itertools.product(sorted({1, 2, 3, 4, 6, cfg.r}), (1, 2, 4))]
    seen, variants = set(), []
    for kn in knobs:
        geo = kmod.stream_geometry(b, h, w, cfg, *limits, **kn)
        if geo in seen:  # a knob cut to the same launch
            continue
        seen.add(geo)
        out.fill_(float("nan"))
        kmod._stream_launch(x, out, cfg, **kn)
        check(torch.equal(out, ref), f"B3 {geo} differs from the default launch {default}")
        t = kernel_ms(torch, lambda: kmod._stream_launch(x, out, cfg, **kn), reps=20)
        variants.append([geo.band, geo.tile, geo.chunk, geo.zgroup, geo.smem, t[0] / b, t[1] / b])
    b1 = kernel_ms(torch, lambda: kmod.bg_fused(x, cfg), reps=20)
    return {"phase": "stream_sweep", "kernel": "B3", "config": "PAPER_DEFAULT", "batch": b,
            "default": default._asdict(), "all_bitwise_default": True,
            "columns": ("band", "tile", "chunk", "zgroup", "smem", "ms_per_frame", "device_ms_per_frame"),
            "variants": variants, "b1_ms_per_frame": b1[0] / b, "b1_device_ms_per_frame": b1[1] / b}


def create_sweep(torch, x, cfg, limits):
    """B4's knobs on the frames ``x``: band x column tile at the rule's z
    group, then z group x tile at the rule's band (and at a band of one
    plane). The default launch is checked bit for bit against the plain
    version, every variant against the default, before it is timed both
    ways (``kernel_ms``). Returns the phase row, the rule's pick marked."""
    import itertools

    from repro_torch.kernels import bg_create_plain
    from repro_torch.kernels.common import grid_shape

    cmod = importlib.import_module("repro_torch.kernels.bg_create")
    b, h, w = x.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    out = torch.empty((b, gx, gy, gz, 2), device=x.device)
    default = cmod._launch(x, out, cfg)
    ref = out.clone()
    check(torch.equal(ref, bg_create_plain(x, cfg)), f"B4 {default} differs from plain")
    bands = sorted({1, 2, 3, 4, 6, 8, 12, 23, gx, default.band})
    tiles = sorted({-(-gy // k) for k in (1, 2, 3, 4, 6, 8)} | {default.tile})
    knobs = [dict(band=bd, tile=tl) for bd, tl in itertools.product(bands, tiles)]
    knobs += [dict(band=bd, tile=tl, zgroup=z)
              for z, (bd, tl) in itertools.product((1, 2, 4), [(default.band, t) for t in tiles]
                                                   + [(1, default.tile)])]
    seen, variants = set(), []
    for kn in knobs:
        geo = cmod.create_geometry(b, h, w, cfg, *limits, **kn)
        if geo in seen:  # a knob cut to the same launch
            continue
        seen.add(geo)
        out.fill_(float("nan"))
        cmod._launch(x, out, cfg, **kn)
        check(torch.equal(out, ref), f"B4 {geo} differs from the default launch {default}")
        t = kernel_ms(torch, lambda: cmod._launch(x, out, cfg, **kn), reps=20)
        variants.append([geo.band, geo.tile, geo.zgroup, geo.smem, t[0] / b, t[1] / b, geo == default])
    best = min(variants, key=lambda v: v[5])
    pick = next(v for v in variants if v[-1])
    return {"phase": "create_sweep", "kernel": "B4", "config": "PAPER_DEFAULT", "batch": b,
            "default": default._asdict(), "all_bitwise_default": True,
            "columns": ("band", "tile", "zgroup", "smem", "ms_per_frame", "device_ms_per_frame", "rule_pick"),
            "variants": variants, "best_by_device": best[:6], "rule_pick": pick[:6],
            "rule_over_best_device": pick[5] / best[5]}


def slice_sweep(torch, x, gf, cfg):
    """B6's knobs (band x column tile) on the frames ``x`` and their
    normalized grids ``gf``, each variant checked bit for bit against the
    default launch, which is checked against the plain version, then timed
    both ways. Returns the phase row."""
    import itertools

    from repro_torch.kernels import bg_slice_plain

    smod = importlib.import_module("repro_torch.kernels.bg_slice")
    b, h, w = x.shape
    n = -(-h // cfg.r)
    out = torch.empty_like(x)
    default = smod._launch(gf, x, out, cfg)
    ref = out.clone()
    check(torch.equal(ref, bg_slice_plain(gf, x, cfg)), f"B6 {default} differs from plain")
    seen, variants = set(), []
    for band, tile in itertools.product(sorted({1, 2, 3, 4, 6, n}), sorted({5, 10, 16, 21, 32, 42, 64})):
        geo = smod.slice_geometry(h, w, cfg, smod._smem_limit(x.device.index), band, tile)
        if geo in seen:
            continue
        seen.add(geo)
        out.fill_(float("nan"))
        smod._launch(gf, x, out, cfg, band, tile)
        check(torch.equal(out, ref), f"B6 {geo} differs from the default launch {default}")
        t = kernel_ms(torch, lambda: smod._launch(gf, x, out, cfg, band, tile), reps=20)
        variants.append([geo.band, geo.tile, t[0] / b, t[1] / b])
    return {"phase": "slice_sweep", "kernel": "B6", "config": "PAPER_DEFAULT", "batch": b,
            "default": default._asdict(), "all_bitwise_default": True,
            "columns": ("band", "tile", "ms_per_frame", "device_ms_per_frame"), "variants": variants}


# the fixed-point datapath against the pow2 float path, the JAX package's
# tests/test_core_bg.py:124-125: at least 99 % of pixels within 1 LSB, none
# more than 4 apart
TOL_FIXED_SHARE, TOL_FIXED_MAX = 0.99, 4.0
# the exact BF's window claim: BF and BG at the radii of Table I
BF_RADII = (4, 8, 12, 16)
BF_CROP = (270, 480)
# the frontends: vlm_preprocess on 8 frames (16x16 patches to 256 wide
# embeddings), spectrogram_denoise on a (4, 1024, 512) spectrogram
VLM_FRAMES, VLM_PATCH, VLM_DIM = 8, 16, 256
SPEC_SHAPE = (4, 1024, 512)
KERNEL_COUNTER = {"fused": "bg_fused.launches", "fused_streamed": "bg_fused.streamed_launches"}


def frontend_run(torch, dev, call):
    """Run ``call()`` (a frontend on ``plan``) with every launch counter at
    0 and the plan's dispatches counted by the dispatch hook; returns
    ``(result, counters, dispatches)``, the counters read just after."""
    from repro_torch.plan import set_dispatch_hook

    seen = []
    zero_counts()
    prev = set_dispatch_hook(seen.append)
    try:
        out = call()
        sync(torch, dev)
    finally:
        set_dispatch_hook(prev)
    got = kernel_counts()
    return out, got, len(seen)


def zbin_boundary(torch, dev, frames8, audio, aplan) -> dict:
    """Inputs a few ulps below a z-bin edge (ROADMAP C4). An 8-bit picture
    mapped to dB (``frames8 / 255 * 80 - 80``, the spectrogram's shape)
    gives them after the frontend's min-max scaling. Every z bin of the
    port divides, ``floor(px / rs + 0.5)``, the reference's rule, on the
    card as on the CPU. Returns the pixels a product with ``fp32(1/rs)``
    bins apart from the division (the kernels' rule before PR 21), whether
    B4's counts on the scaled frames equal its plain version's and the
    reference ``grid_create``'s, and the share of outputs within 1e-3 of a
    level and the largest difference in levels of the plan (B3 or B1)
    against the reference plan on the card and on the CPU, and of the two
    references. The caller holds them."""
    import numpy as np

    from repro_torch.core import grid_create
    from repro_torch.data import spectrogram_denoise
    from repro_torch.kernels import bg_create, bg_create_plain
    from repro_torch.plan import BGPlan

    spec8 = frames8 / 255.0 * 80.0 - 80.0
    lo8, hi8 = spec8.min(), spec8.max()
    scaled = ((spec8 - lo8) / torch.clamp(hi8 - lo8, min=1e-9) * 255.0).contiguous()  # the frontend's
    rs = audio.range_scale
    product_bin = torch.floor(scaled.cpu() * float(np.float32(1.0 / rs)) + 0.5)
    division_bin = torch.floor(scaled.cpu() / rs + 0.5)
    counts = bg_create(scaled, audio)[..., 0]
    counts_plain = bg_create_plain(scaled, audio)[..., 0]
    counts_ref = torch.stack([grid_create(f, audio)[..., 0] for f in scaled])
    out = spectrogram_denoise(spec8, plan=aplan)
    ref_card = spectrogram_denoise(spec8, plan=BGPlan(audio, backend="reference", device=dev))
    ref_cpu = spectrogram_denoise(spec8.cpu(), audio, device="cpu")
    level = float(hi8 - lo8) / 255.0

    def agree(a, b):
        d = (a.cpu() - b.cpu()).abs() / level
        return {"levels_within_1e-3": float((d <= 1e-3).float().mean()), "max_levels": float(d.max())}

    return {"shape": list(spec8.shape), "config": "(4, 2.0, 40.0)", "plan": aplan.describe(),
            "pixels": spec8.numel(), "pixels_a_product_bins_apart": int((product_bin != division_bin).sum()),
            "b4_counts_bitwise_plain": bool(torch.equal(counts, counts_plain)),
            "b4_counts_bitwise_reference": bool(torch.equal(counts, counts_ref)),
            "kernel_vs_card_reference": agree(out, ref_card), "kernel_vs_cpu_reference": agree(out, ref_cpu),
            "card_reference_vs_cpu_reference": agree(ref_card, ref_cpu)}


def core_paths(torch, smi, dev, clean, x8) -> float:
    """Phase "core_paths": the rest of the image core on the card at
    1080x1920, ``PAPER_DEFAULT``. The ``"streaming"`` plan on 2 frames
    against the ``"reference"`` plan (atol 1e-3 unquantized, the quantized
    contract) and against B1 (the quantized contract); fixed point on one
    frame equal to the port's CPU result (``torch.equal``) and within
    ``TOL_FIXED_*`` of the pow2 float path; the exact BF at r = 4, 8, 12,
    16 beside the BG plan at the same radius and sigmas (ms per frame,
    MSSIM against the clean scene), the BF held to the CPU BF on a 270x480
    crop; ``vlm_preprocess`` and ``spectrogram_denoise`` on ``plan_for``'s
    plans, their launches read from the counters. Each line carries the
    card's name and power limit. ``clean`` and ``x8`` are the script's 8 clean full-HD scenes and
    their noisy frames. Returns the phase's seconds."""
    from repro_torch.configs.bg_denoise import PAPER_DEFAULT
    from repro_torch.core import BGConfig, bilateral_filter, bilateral_grid_filter, bilateral_grid_filter_fixed, mssim
    from repro_torch.data import denoise_batch, spectrogram_denoise, vlm_preprocess
    from repro_torch.plan import BGPlan, plan_for

    t_phase = time.perf_counter()
    cfg = PAPER_DEFAULT.bg
    check(x8.shape[0] == VLM_FRAMES, f"core_paths takes {VLM_FRAMES} frames")
    x2 = x8[:2].contiguous()

    # ---- the streaming backend on 2 frames
    plans = {(be, q): BGPlan(cfg, backend=be, quantize_output=q, device=dev)
             for be in ("streaming", "reference") for q in (False, True)}
    zero_counts()
    s_raw = plans["streaming", False](x2)
    s_q = plans["streaming", True](x2)
    sync(torch, dev)
    check_counts(kernel_counts(), {}, "streaming: plain PyTorch by design, no kernel")
    r_raw = plans["reference", False](x2)
    r_q = plans["reference", True](x2)
    b1 = BGPlan(cfg, backend="fused", device=dev)(x2)
    err = float((s_raw - r_raw).abs().max())
    exact_ref, lsb_ref = quantized_agreement(s_q, r_q)
    exact_b1, lsb_b1 = quantized_agreement(s_q, b1)
    s_ms = cuda_ms(torch, lambda: plans["streaming", True](x2), reps=3, warmup=1)
    r_ms = cuda_ms(torch, lambda: plans["reference", True](x2), reps=3, warmup=1)
    emit({"phase": "core_paths", "check": "streaming", "config": "PAPER_DEFAULT", "shape": list(x2.shape),
          "max_abs_err_vs_reference": err, "tolerance": 1e-3,
          "quantized_exact_vs_reference": exact_ref, "quantized_max_diff_vs_reference": lsb_ref,
          "quantized_exact_vs_b1": exact_b1, "quantized_max_diff_vs_b1": lsb_b1,
          "ms_per_frame": s_ms / 2, "reference_ms_per_frame": r_ms / 2, "card": smi})
    check(s_raw.shape == x2.shape and bool(torch.isfinite(s_raw).all()), "streaming: shape/finite")
    check(err <= 1e-3, f"streaming vs reference: {err}")
    check(exact_ref >= TOL_EXACT and lsb_ref <= TOL_LSB, f"streaming vs reference: {exact_ref}, {lsb_ref}")
    check(exact_b1 >= TOL_EXACT and lsb_b1 <= TOL_LSB, f"streaming vs B1: {exact_b1}, {lsb_b1}")

    # ---- fixed point on one frame: integer sums, so the card gives the CPU's bits
    pow2 = BGConfig(cfg.r, cfg.sigma_s, cfg.sigma_r, weight_mode="pow2")
    frame = x2[0].contiguous()
    fx = bilateral_grid_filter_fixed(frame, pow2, device=dev)
    fx_cpu = bilateral_grid_filter_fixed(frame.cpu(), pow2, device="cpu")
    diff = (fx - bilateral_grid_filter(frame, pow2)).abs()
    within, fmax = float((diff <= 1.0).float().mean()), float(diff.max())
    f_ms = cuda_ms(torch, lambda: bilateral_grid_filter_fixed(frame, pow2, device=dev), reps=5, warmup=1)
    equal = bool(torch.equal(fx.cpu(), fx_cpu))
    emit({"phase": "core_paths", "check": "fixed_point", "config": "PAPER_DEFAULT pow2", "shape": list(frame.shape),
          "bitwise_cpu": equal, "share_within_1_lsb_of_pow2_float": within, "max_diff_vs_pow2_float": fmax,
          "ms_per_frame": f_ms, "card": smi})
    check(fx.device == dev and equal, "fixed point: the card differs from the CPU")
    check(within >= TOL_FIXED_SHARE and fmax <= TOL_FIXED_MAX, f"fixed point vs pow2 float: {within}, {fmax}")

    # ---- the paper's window claim: the exact BF's cost grows with r^2, the BG's does not
    ch, cw = min(BF_CROP[0], H), min(BF_CROP[1], W)
    crop = frame[:ch, :cw].contiguous()
    noisy_m = float(mssim(clean[0], frame))
    rows = {}
    for r in BF_RADII:
        rc = BGConfig(r, cfg.sigma_s, cfg.sigma_r)
        bf = bilateral_filter(frame, r, rc.sigma_s, rc.sigma_r, device=dev)
        crop_err = float((bilateral_filter(crop, r, rc.sigma_s, rc.sigma_r, quantize_output=False, device=dev).cpu()
                          - bilateral_filter(crop.cpu(), r, rc.sigma_s, rc.sigma_r, quantize_output=False,
                                             device="cpu")).abs().max())
        bg_plan = plan_for(rc, H, W, n_frames=1, cache=False, device=dev)
        bg = bg_plan(frame)
        rows[r] = {"bf_ms_per_frame": cuda_ms(torch, lambda: bilateral_filter(frame, r, rc.sigma_s, rc.sigma_r, device=dev),
                                              reps=2, warmup=1),
                   "bg_ms_per_frame": cuda_ms(torch, lambda: bg_plan(frame), reps=20),
                   "bf_mssim": float(mssim(clean[0], bf)), "bg_mssim": float(mssim(clean[0], bg)),
                   "bf_taps": (2 * r + 1) ** 2, "bg_plan": bg_plan.describe(),
                   "bf_crop_max_abs_err_vs_cpu": crop_err}
        emit({"phase": "core_paths", "check": "window_claim", "r": r, "sigma_s": rc.sigma_s,
              "sigma_r": rc.sigma_r, "frame_hw": [H, W], "noisy_mssim": noisy_m, **rows[r], "card": smi})
        check(crop_err <= 1e-3, f"BF r={r}: card vs CPU on the {ch}x{cw} crop: {crop_err}")
        check(rows[r]["bf_mssim"] > noisy_m and rows[r]["bg_mssim"] > noisy_m, f"r={r}: no denoising")
    lo, hi = BF_RADII[0], BF_RADII[-1]
    emit({"phase": "core_paths", "check": "window_claim_summary", "radii": list(BF_RADII),
          "bf_ms_ratio": rows[hi]["bf_ms_per_frame"] / rows[lo]["bf_ms_per_frame"],
          "bf_taps_ratio": rows[hi]["bf_taps"] / rows[lo]["bf_taps"],
          "bg_ms_ratio": rows[hi]["bg_ms_per_frame"] / rows[lo]["bg_ms_per_frame"], "card": smi})

    # ---- the frontends on plan_for's plans: the kernel carries the denoise
    vplan = plan_for(cfg, H, W, n_frames=VLM_FRAMES, cache=False, device=dev)
    emb, got, disp = frontend_run(torch, dev,
                                  lambda: vlm_preprocess(x8, None, VLM_PATCH, VLM_DIM, plan=vplan))
    ran = KERNEL_COUNTER[vplan.backend]
    per = -(-VLM_FRAMES // vplan.tile_for(VLM_FRAMES))
    check(disp == 1, f"vlm_preprocess: {disp} dispatches")
    check_counts(got, {ran: disp * per}, "vlm_preprocess")
    n_patch = (H // VLM_PATCH) * (W // VLM_PATCH)
    check(emb.device == dev and tuple(emb.shape) == (VLM_FRAMES, n_patch, VLM_DIM) and bool(torch.isfinite(emb).all()),
          f"vlm_preprocess: embeddings {tuple(emb.shape)}")
    exact, lsb = quantized_agreement(denoise_batch(x8, plan=vplan), plans["reference", True](x8))
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"vlm_preprocess frames vs reference: {exact}, {lsb}")
    v_ms = cuda_ms(torch, lambda: vlm_preprocess(x8, None, VLM_PATCH, VLM_DIM, plan=vplan), reps=5, warmup=1)
    emit({"phase": "core_paths", "check": "vlm_preprocess", "frames": VLM_FRAMES, "frame_hw": [H, W],
          "patch": VLM_PATCH, "dim": VLM_DIM, "plan": vplan.describe(), "dispatches": disp,
          "launches": got, "launches_per_dispatch": got[ran] / disp, "quantized_exact_vs_reference": exact,
          "quantized_max_diff_vs_reference": lsb, "ms_per_frame": v_ms / VLM_FRAMES, "card": smi})

    audio = BGConfig(r=4, sigma_s=2.0, sigma_r=40.0)  # the JAX package's spectrogram default
    gen = torch.Generator(device=dev).manual_seed(5)
    b, t, f = SPEC_SHAPE
    tt = torch.arange(t, device=dev, dtype=torch.float32)[None, :, None] / 40.0
    ff = torch.arange(f, device=dev, dtype=torch.float32)[None, None, :] / 25.0
    spec = (-60.0 + 30.0 * torch.sin(tt + ff * torch.rand((b, 1, 1), generator=gen, device=dev))
            + 6.0 * torch.randn(SPEC_SHAPE, generator=gen, device=dev))
    aplan = plan_for(audio, t, f, n_frames=b, cache=False, device=dev)
    den, got, disp = frontend_run(torch, dev, lambda: spectrogram_denoise(spec, plan=aplan))
    ran = KERNEL_COUNTER[aplan.backend]
    per = -(-b // aplan.tile_for(b))
    check(disp == 1, f"spectrogram_denoise: {disp} dispatches")
    check_counts(got, {ran: disp * per}, "spectrogram_denoise")
    ref = spectrogram_denoise(spec, plan=BGPlan(audio, backend="reference", device=dev))
    level = float(spec.max() - spec.min()) / 255.0  # one intensity level of the scaled spectrogram
    d = (den - ref).abs() / level
    exact, lsb = float((d <= 1e-3).float().mean()), float(d.max())
    check(den.shape == spec.shape and bool(torch.isfinite(den).all()), "spectrogram_denoise: shape/finite")
    check(exact >= TOL_EXACT and lsb <= TOL_LSB + 1e-3, f"spectrogram_denoise vs reference: {exact}, {lsb}")
    a_ms = cuda_ms(torch, lambda: spectrogram_denoise(spec, plan=aplan), reps=5, warmup=1)
    emit({"phase": "core_paths", "check": "spectrogram_denoise", "shape": list(SPEC_SHAPE),
          "config": "(4, 2.0, 40.0)", "plan": aplan.describe(), "dispatches": disp, "launches": got,
          "launches_per_dispatch": got[ran] / disp, "levels_within_1e-3_vs_reference": exact,
          "max_levels_vs_reference": lsb, "ms": a_ms, "card": smi})
    frames8 = x8[:b, :t, :f].contiguous()  # 8-bit noisy frames, cut to the spectrogram's shape
    edges = zbin_boundary(torch, dev, frames8, audio, aplan)
    emit({"phase": "core_paths", "check": "zbin_boundary", **edges, "card": smi})
    check(edges["b4_counts_bitwise_plain"] and edges["b4_counts_bitwise_reference"],
          f"z bins at the edges: B4's counts differ: {edges}")
    for pair in ("kernel_vs_card_reference", "kernel_vs_cpu_reference", "card_reference_vs_cpu_reference"):
        got = edges[pair]
        check(got["levels_within_1e-3"] >= TOL_EXACT and got["max_levels"] <= TOL_LSB + 1e-3,
              f"z bins at the edges, {pair}: {got}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "core_paths", "check": "done", "seconds": seconds, "card": smi})
    return seconds


MESH_REPS = 10  # timed dispatches per route in mesh_slice


def mesh_slice(torch, smi, dev, x8) -> float:
    """Phase "mesh_slice": batch sharding on the card at 1080x1920,
    ``PAPER_DEFAULT``. ``batch_mesh()`` over the host's cards (one card: the
    plan degrades to the plain one, one launch per dispatch); then a mesh
    naming the card twice (``BatchMesh((dev, dev))``), which drives pad ->
    split -> dispatch -> gather -> trim through the kernels on one card: 8
    frames through B1 and B3 in fp32 and bf16, a 4-stream temporal pack
    through B2 cold then warm, each output (and carry) equal to the
    single-device plan's bit for bit with one launch per shard, timed per
    dispatch beside the single-device plan; ``FrameDenoiseEngine`` and
    ``AsyncFrameEngine`` serving 16 host frames through the mesh, equal to
    the single-device plan's quantized output; a fleet payload with
    ``mesh_size=2`` bound to the mesh in a ``LocalWorker``, equal to a
    single-device worker. The shards of a repeated device run one after the
    other, so the times show the path's overhead, never a gain. Returns the
    phase's seconds."""
    from repro_torch.configs.bg_denoise import PAPER_DEFAULT
    from repro_torch.fleet import LocalWorker, PlanController
    from repro_torch.plan import BGPlan, plan_for
    from repro_torch.serving import AsyncFrameEngine, FrameDenoiseEngine, FrameRequest
    from repro_torch.sharding import BatchMesh, batch_mesh
    from repro_torch.video import carry_shape

    t_phase = time.perf_counter()
    cfg = PAPER_DEFAULT.bg
    count = torch.cuda.device_count()

    # ---- the host's own cards: one card is a size-1 mesh, the plain plan
    auto = batch_mesh()
    plan = BGPlan(cfg, mesh=auto)
    zero_counts()
    out = plan(x8)
    sync(torch, dev)
    if count == 1:
        check(plan.mesh is None and plan.device == dev, f"a size-1 mesh: {plan.describe()}")
        check_counts(kernel_counts(), {"bg_fused.launches": 1}, "batch_mesh() on one card")
    check(bool(torch.equal(out, BGPlan(cfg, device=dev)(x8))), "batch_mesh(): differs from the plain plan")
    auto_pick = plan_for(cfg, H, W, n_frames=8, device="cuda", cache=False)
    emit({"phase": "mesh_slice", "check": "batch_mesh", "count": count, "mesh_size": plan.mesh_size,
          "plan": plan.describe(), "plan_for_mesh_size": auto_pick.mesh_size, "card": smi})
    check(auto_pick.mesh_size == count, f"plan_for's auto-mesh: {auto_pick.describe()} on {count} card(s)")

    # ---- a mesh naming the card twice: B1 and B3, fp32 and bf16, 8 frames
    mesh = BatchMesh((dev, dev))
    for backend, prec in (("fused", "fp32"), ("fused_streamed", "fp32"), ("fused", "bf16"),
                          ("fused_streamed", "bf16")):
        single = BGPlan(cfg, backend=backend, precision=prec, device=dev)
        meshed = BGPlan(cfg, backend=backend, precision=prec, mesh=mesh)
        ref = single(x8)
        zero_counts()
        got = meshed(x8)
        sync(torch, dev)
        counter = KERNEL_COUNTER[backend]
        if prec == "bf16":
            counter = counter.replace("bg_fused.", "bg_fused.bf16_")
        check_counts(kernel_counts(), {counter: 2}, f"mesh of 2, {backend} {prec}")
        bitwise = bool(torch.equal(got, ref))
        emit({"phase": "mesh_slice", "check": "dispatch", "backend": backend, "precision": prec,
              "mesh_size": meshed.mesh_size, "frames": 8, "frame_hw": [H, W], "config": "PAPER_DEFAULT",
              "bitwise_single_device": bitwise, "launches_per_dispatch": 2,
              "ms_per_dispatch": cuda_ms(torch, lambda: meshed(x8), reps=MESH_REPS),
              "single_device_ms_per_dispatch": cuda_ms(torch, lambda: single(x8), reps=MESH_REPS),
              "card": smi})
        check(bitwise, f"mesh of 2, {backend} {prec}: differs from the single-device plan")

    # ---- B2: a 4-stream pack, cold (zero carries, alpha 0), then warm
    single = BGPlan(cfg, temporal=True, device=dev)
    meshed = BGPlan(cfg, temporal=True, mesh=mesh)
    x4 = x8[:4].contiguous()
    carry = torch.zeros((4,) + carry_shape(H, W, cfg), device=dev)
    for step, alpha in enumerate(([0.0] * 4, [0.0, 0.6, 0.4, 0.8])):
        alpha = torch.tensor(alpha, device=dev)
        x = x4 if step == 0 else x8[4:].contiguous()
        ref_img, ref_carry = single(x, carry=carry, alpha=alpha)
        zero_counts()
        img, new_carry = meshed(x, carry=carry, alpha=alpha)
        sync(torch, dev)
        check_counts(kernel_counts(), {"bg_fused.temporal_launches": 2}, f"mesh of 2, temporal step {step}")
        bitwise = bool(torch.equal(img, ref_img)) and bool(torch.equal(new_carry, ref_carry))
        emit({"phase": "mesh_slice", "check": "temporal", "pack": "cold" if step == 0 else "warm",
              "streams": 4, "mesh_size": 2, "frame_hw": [H, W], "config": "PAPER_DEFAULT",
              "bitwise_single_device": bitwise, "launches_per_dispatch": 2,
              "ms_per_dispatch": cuda_ms(torch, lambda: meshed(x, carry=carry, alpha=alpha), reps=MESH_REPS),
              "single_device_ms_per_dispatch": cuda_ms(torch, lambda: single(x, carry=carry, alpha=alpha),
                                                       reps=MESH_REPS),
              "card": smi})
        check(bitwise, f"mesh of 2, temporal step {step}: image or carry differs from the single-device plan")
        carry = new_carry

    # ---- the engines: 16 host frames through the mesh
    host16 = torch.cat([x8, x8.flip(-1)]).cpu()
    fplan = plan_for(cfg, H, W, n_frames=8, mesh=mesh, cache=False)
    want = BGPlan(cfg, backend=fplan.backend, device=dev)(host16)
    eng = FrameDenoiseEngine(plan=fplan, max_batch=8)
    zero_counts()
    for i in range(16):
        eng.submit(FrameRequest(uid=i, frame=host16[i].numpy()))
    done = eng.flush()
    sync(torch, dev)
    per = 2 * -(-4 // fplan.tile_for(8))  # two shards of 4 frames, in tiles
    check_counts(kernel_counts(), {KERNEL_COUNTER[fplan.backend]: 2 * per}, "FrameDenoiseEngine on the mesh")
    f_equal = len(done) == 16 and all(bool(torch.equal(r.result, want[r.uid])) for r in done)
    check(f_equal, "FrameDenoiseEngine on the mesh: differs from the single-device plan")
    aplan = BGPlan(cfg, backend=fplan.backend, mesh=mesh)  # whole shards: one launch per shard
    zero_counts()
    with AsyncFrameEngine(plan=aplan, max_batch=8, batch_window_ms=2.0) as aeng:
        res = [f.result(timeout=120) for f in [aeng.submit(host16[i].numpy()) for i in range(16)]]
        ast = aeng.stats()
    a_equal = all(bool(torch.equal(r, want[i])) for i, r in enumerate(res))
    check_counts(kernel_counts(), {KERNEL_COUNTER[aplan.backend]: 2 * ast.dispatches}, "AsyncFrameEngine on the mesh")
    check(a_equal and ast.failed == 0, f"AsyncFrameEngine on the mesh: equal={a_equal}, failed={ast.failed}")
    check(ast.retries == ast.fallbacks == ast.watchdog_trips == 0, f"AsyncFrameEngine on the mesh: {ast}")
    emit({"phase": "mesh_slice", "check": "engines", "frames": 16, "frame_hw": [H, W],
          "frame_engine_plan": fplan.describe(), "frame_engine_max_batch": eng.max_batch,
          "frame_engine_n_devices": eng.n_devices, "frame_engine_bitwise": f_equal,
          "frame_engine_launches_per_dispatch": per, "async_plan": aplan.describe(),
          "async_dispatches": ast.dispatches, "async_mean_batch": ast.mean_batch, "async_bitwise": a_equal,
          "card": smi})

    # ---- a fleet payload with mesh_size=2, bound to the mesh in a worker
    ctl = PlanController(BGPlan(cfg, temporal=True, mesh=mesh))
    payload = ctl.payload()
    check(payload["plan"]["mesh_size"] == 2, f"fleet payload: {payload['plan']}")
    if count < 2:
        try:
            BGPlan.from_json(payload["plan"])
            check(False, "a 2-device payload bound on one card without mesh=")
        except ValueError:
            pass
    frames3 = [x8[i].cpu().numpy() for i in range(3)]
    outs, launches = [], []
    for pl, kw in ((payload, dict(mesh=mesh)),
                   (PlanController(BGPlan(cfg, temporal=True, device=dev)).payload(), dict(device=dev))):
        w = LocalWorker(0, pl, **kw)
        try:
            w.open_stream("s", alpha=0.6)
            outs.append([w.submit(f, stream_id="s").result(timeout=120) for f in frames3])
            launches.append((w.launches(), w.stats().dispatches))
        finally:
            w.close()
    w_equal = all(bool(torch.equal(a, b)) for a, b in zip(*outs))
    (mesh_launches, mesh_disp), (one_launches, one_disp) = launches
    emit({"phase": "mesh_slice", "check": "fleet_payload", "mesh_size": 2, "plan_hash": ctl.plan_hash,
          "plan": ctl.plan.describe(), "frames": 3, "bitwise_single_device_worker": w_equal,
          "worker_launches": mesh_launches, "worker_dispatches": mesh_disp,
          "single_device_worker_launches": one_launches, "card": smi})
    check(w_equal, "the mesh worker differs from the single-device worker")
    check(mesh_launches == {"bg_fused.temporal_launches": 2 * mesh_disp}
          and one_launches == {"bg_fused.temporal_launches": one_disp},
          f"worker launches: mesh {mesh_launches} in {mesh_disp}, one device {one_launches} in {one_disp}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "mesh_slice", "check": "done", "seconds": seconds, "card": smi})
    return seconds


# ---- the LM serving substrate (phase "lm_slice"): plain PyTorch, no kernel
# of the port's on its path (the JAX package has no Pallas kernel there)
LM_TOL = 1e-4  # fp32 smoke logits, aux and caches: the CPU tests' (tests/test_torch_models.py)
LM_CONSISTENCY_TOL = 5e-2  # prefill + decode vs train forward, the JAX package's tests/test_arch_smoke.py:103
LM_BATCH, LM_SEQ, LM_MAX_LEN = 2, 16, 64
# the JAX package's engine cases, tests/test_serving.py:40-64
LM_ENGINE_PROMPTS = ([1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5])
# yi-6b served through the launcher at the JAX launcher's LM defaults
LM_SERVE = dict(slots=4, max_len=256, requests=8, max_tokens=16)


def lm_close(torch, mine, ref, path=""):
    """(max abs difference, within rtol/atol LM_TOL) of two trees of tensors
    (card and CPU); int8 leaves may differ by one step at a rounding
    boundary (counted in the third value)."""
    if isinstance(ref, tuple):
        mine, ref = dict(enumerate(mine)), dict(enumerate(ref))
    if isinstance(ref, dict):
        worst, ok, steps = 0.0, True, 0
        for k in ref:
            w, o, n = lm_close(torch, mine[k], ref[k], f"{path}/{k}")
            worst, ok, steps = max(worst, w), ok and o, steps + n
        return worst, ok, steps
    a, b = mine.detach().cpu(), ref.detach()
    if a.dtype == torch.int8:
        d = (a.int() - b.int()).abs()
        return float(d.max()), int(d.max()) <= 1, int((d != 0).sum())
    a, b = a.double(), b.double()
    return float((a - b).abs().max()), bool(torch.allclose(a, b, rtol=LM_TOL, atol=LM_TOL)), 0


def lm_runs(torch, cfg, params, kw, dev):
    """Train, prefill and one greedy decode step of the port's model."""
    from repro_torch.models import forward, init_caches

    out = {"train": forward(params, cfg, mode="train", **kw)[::2]}
    if not cfg.encoder_only:
        lp, caches, _ = forward(params, cfg, mode="prefill", caches=init_caches(cfg, LM_BATCH, LM_MAX_LEN, device=dev),
                                **kw)
        nxt = torch.argmax(lp[:, -1], -1)[:, None]
        pos = torch.full((LM_BATCH, 1), LM_SEQ, dtype=torch.int32, device=dev)
        ld, c2, _ = forward(params, cfg, mode="decode", caches=caches, positions=pos, **dict(kw, tokens=nxt))
        out.update(prefill=(lp, caches), decode=(ld, c2), next=nxt)
    return out


def lm_engine_tokens(cfg, params, dev):
    """The JAX package's engine cases on one device: three prompts batched
    in 3 slots (6 tokens each); two slots, a third request refused then
    admitted into a freed slot (3 tokens each). Returns the tokens."""
    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(cfg, params, max_slots=3, max_len=64, device=dev)
    reqs = [Request(uid=i, prompt=list(p), max_tokens=6) for i, p in enumerate(LM_ENGINE_PROMPTS)]
    check(all(eng.submit(r) for r in reqs), "ServeEngine: 3 requests into 3 slots")
    eng.run_to_completion()
    eng = ServeEngine(cfg, params, max_slots=2, max_len=64, device=dev)
    reuse = [Request(uid=i, prompt=[2 * i + 1, 2 * i + 2], max_tokens=3) for i in range(3)]
    check(eng.submit(reuse[0]) and eng.submit(reuse[1]) and not eng.submit(reuse[2]), "ServeEngine: admission")
    eng.run_to_completion()
    check(eng.submit(reuse[2]), "ServeEngine: a freed slot takes the third request")
    eng.run_to_completion()
    return [r.generated for r in reqs + reuse]


LM_PROFILE_STEPS = 3


def lm_decode_profile(torch, cfg, params, prompts, dev) -> dict:
    """Where a full-width decode step's device time goes: ``ServeEngine``
    with 4 slots filled from ``prompts``, two warm-up steps, then
    ``LM_PROFILE_STEPS`` steps under ``torch.profiler``: the kernels'
    summed device time per step (one stream, so kernels do not overlap),
    kernel launches per step and the six kernels with the most device
    time. ``profiler_saw_device`` is False where the profiler recorded no
    device time (then the numbers are not measured). The caller sets the
    busy time against the unprofiled step: the profiler's own host work
    lengthens the profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, ServeEngine

    eng = ServeEngine(cfg, params, max_slots=4, max_len=LM_SERVE["max_len"], device=dev)
    for i, prompt in enumerate(prompts[:4]):
        check(eng.submit(Request(uid=i, prompt=prompt, max_tokens=10_000)), "profile: a slot")
    for _ in range(2):
        eng.step()
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LM_PROFILE_STEPS):
            eng.step()
        sync(torch, dev)
    kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:6]
    return {"profiled_steps": LM_PROFILE_STEPS, "profiler_saw_device": busy_us > 0,
            "device_busy_ms_per_step": busy_us / LM_PROFILE_STEPS / 1e3,
            "kernel_launches_per_step": sum(c for _, _, c in kernels) / LM_PROFILE_STEPS,
            "top_kernels": [{"name": n[:90], "ms_per_step": t / LM_PROFILE_STEPS / 1e3,
                             "launches_per_step": c / LM_PROFILE_STEPS} for n, t, c in top]}


def lm_slice(torch, smi, dev) -> dict:
    """Phase "lm_slice": the LM serving substrate on the card. (1) Every
    arch's smoke config in fp32 on the card and on the CPU with the same
    port parameters (the CPU's, copied over) and inputs: train logits and
    aux, prefill logits and every cache leaf, one decode step, held to
    rtol/atol ``LM_TOL`` (qwen1.5-110b also with int8 KV caches, whose
    values may differ by one step at a rounding boundary: counted); and
    prefill + decode against the train forward on the card
    (``LM_CONSISTENCY_TOL``). (2) yi-6b smoke through ``ServeEngine``: the
    card's tokens equal the CPU's on the JAX package's engine cases.
    (3) yi-6b at full width (32 layers, d_model 4096, vocab 64000, fp32
    params, bf16 activations) served through the launcher's LM mode at the
    JAX launcher's defaults, after one warm-up request: tokens/s, prefill
    ms at batch 1, decode ms per step, peak memory, the bytes a decode step
    must move and the least time the card could take for them, and one
    profiled pass of the step's device time; every request finishes with
    ``max_tokens`` tokens, each request's first token equals its prompt
    prefilled alone, and prefill + decode against the train forward is
    reported. No kernel of the port runs on this path (the counters stay
    at 0). (4) The ``vlm_preprocess`` example on the card: B1 or B3
    denoises the images (counted) within the quantized contract of the
    reference plan on the same frames, logits finite, denoised embeddings
    nearer the clean ones than the noisy. Returns the phase's seconds and
    the full-width decode step's median milliseconds."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
    from repro_torch.examples import vlm_preprocess as vlm_example
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import forward, init_caches, init_params, tree_map

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is off for the fp32 comparisons")
    cpu = torch.device("cpu")

    # ---- (1) every smoke arch, card against CPU, fp32
    variants = [(a, get_smoke_config(a)) for a in ARCHS]
    variants.append(("qwen1.5-110b int8 kv",
                     dataclasses.replace(get_smoke_config("qwen1.5-110b"), kv_cache_dtype="int8")))
    for label, cfg in variants:
        params = init_params(0, cfg, device=cpu)
        rng = np.random.default_rng(1)
        kw = {}
        if cfg.frontend == "audio":
            kw["embeds"] = torch.from_numpy(rng.standard_normal((LM_BATCH, LM_SEQ, cfg.d_model)).astype(np.float32))
        else:
            kw["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_SEQ)))
        if cfg.frontend == "vision":
            kw["cross_ctx"] = torch.from_numpy(
                rng.standard_normal((LM_BATCH, cfg.cross_attn_tokens, cfg.d_model)).astype(np.float32))
        zero_counts()
        card = lm_runs(torch, cfg, tree_map(lambda t: t.to(dev), params), {k: v.to(dev) for k, v in kw.items()}, dev)
        sync(torch, dev)
        check_counts(kernel_counts(), {}, f"{label}: plain PyTorch, no kernel")
        ref = lm_runs(torch, cfg, params, kw, cpu)
        row = {"phase": "lm_slice", "check": "smoke_card_vs_cpu", "arch": label, "dtype": "float32",
               "tolerance": LM_TOL, "card": smi}
        ok = True
        for part in ref:
            if part == "next":
                same = bool(torch.equal(card["next"].cpu(), ref["next"]))
                row["decode_input_tokens_equal"] = same
                ok = ok and same
                continue
            err, within, steps = lm_close(torch, card[part], ref[part])
            row[f"{part}_max_abs_err"] = err
            if steps:
                row[f"{part}_int8_values_one_step_apart"] = steps
            ok = ok and within
        check(card["train"][0].is_cuda and bool(torch.isfinite(card["train"][0]).all()), f"{label}: finite on the card")
        if not cfg.encoder_only and "int8" not in label:
            drop = tuple(dataclasses.replace(b, moe=dataclasses.replace(b.moe, capacity_factor=8.0))
                         if b.moe is not None else b for b in cfg.pattern)
            dcfg = dataclasses.replace(cfg, pattern=drop)
            dparams = tree_map(lambda t: t.to(dev), params)
            dkw = {k: v.to(dev) for k, v in kw.items()}
            lp, caches, _ = forward(dparams, dcfg, mode="prefill",
                                    caches=init_caches(dcfg, LM_BATCH, LM_MAX_LEN, device=dev), **dkw)
            nxt = torch.argmax(lp[:, -1], -1)[:, None]
            ld, _, _ = forward(dparams, dcfg, mode="decode", caches=caches,
                               positions=torch.full((LM_BATCH, 1), LM_SEQ, dtype=torch.int32, device=dev),
                               **dict(dkw, tokens=nxt))
            lf, _, _ = forward(dparams, dcfg, mode="train", **dict(dkw, tokens=torch.cat([dkw["tokens"], nxt], 1)))
            row["prefill_decode_vs_train_max_abs_diff"] = float((lf[:, -1] - ld[:, 0]).abs().max())
            row["consistency_tolerance"] = LM_CONSISTENCY_TOL
            ok = ok and row["prefill_decode_vs_train_max_abs_diff"] < LM_CONSISTENCY_TOL
        emit(row)
        check(ok, f"{label}: card differs from the CPU: {row}")

    # ---- (2) yi-6b smoke through ServeEngine: the card's tokens are the CPU's
    cfg = get_smoke_config("yi-6b")
    params = init_params(0, cfg, device=cpu)
    zero_counts()
    card_tokens = lm_engine_tokens(cfg, tree_map(lambda t: t.to(dev), params), dev)
    check_counts(kernel_counts(), {}, "ServeEngine: plain PyTorch, no kernel")
    cpu_tokens = lm_engine_tokens(cfg, params, cpu)
    emit({"phase": "lm_slice", "check": "engine_card_vs_cpu", "arch": cfg.name, "tokens_equal": card_tokens == cpu_tokens,
          "card_tokens": card_tokens, "card": smi})
    check(card_tokens == cpu_tokens, f"ServeEngine: card {card_tokens} != CPU {cpu_tokens}")

    # ---- (3) yi-6b at full width through the launcher's LM mode
    full = get_config("yi-6b")
    check((full.n_layers, full.d_model, full.vocab_size, full.act_dtype, full.param_dtype)
          == (32, 4096, 64000, "bfloat16", "float32"), f"yi-6b full config: {full}")
    torch.cuda.empty_cache()
    zero_counts()
    st = serve_lm("yi-6b", device=dev, warmup=1, **LM_SERVE)
    check_counts(kernel_counts(), {}, "yi-6b serving: plain PyTorch, no kernel")
    check([len(g) for g in st["generated"]] == [LM_SERVE["max_tokens"]] * LM_SERVE["requests"],
          f"yi-6b: every request finishes with max_tokens tokens: {[len(g) for g in st['generated']]}")
    from repro_torch.plan import HBM_BYTES_PER_S

    # the least a decode step must move: every fp32 weight once but the
    # embedding table's (4 rows gathered, one per slot; the head is its
    # own matrix), and the K and V of the positions each slot holds, at
    # least its shortest prompt and first token, and the logits written; the step as written also
    # casts each weight to bf16 and reads the copy (ROADMAP R6): 4 + 2 + 2
    # bytes per weight
    check(not full.tie_embeddings, "yi-6b: an untied head")
    slots, table = LM_SERVE["slots"], full.vocab_size * full.d_model
    weight_bytes = 4 * (full.param_count() - table) + 4 * slots * full.d_model
    kv_bytes = (2 * full.n_layers * slots * (min(len(p) for p in st["prompts"]) + 1)
                * full.n_kv_heads * full.head_dim * 2)
    step_bytes = weight_bytes + kv_bytes + slots * full.vocab_size * 2  # + the bf16 logits
    cast_bytes = 8 * (full.param_count() - table)
    decode_med = float(np.median(st["decode_ms"]))
    prefill_med = float(np.median(st["prefill_ms"]))
    # every first token against its prompt prefilled alone; prefill +
    # decode against the train forward on one prompt; on fresh parameters
    # drawn from the same seed on the same card (the launcher's are gone)
    params = init_params(0, full, device=dev)
    firsts, finite = [], True
    for prompt in st["prompts"]:
        toks = torch.tensor([prompt], device=dev)
        lp, _, _ = forward(params, full, tokens=toks, mode="prefill",
                           caches=init_caches(full, 1, LM_SERVE["max_len"], device=dev))
        finite = finite and bool(torch.isfinite(lp).all())
        firsts.append(int(torch.argmax(lp[:, -1], -1)[0]))
    prompt = st["prompts"][-1]
    toks = torch.tensor([prompt], device=dev)
    lp, caches, _ = forward(params, full, tokens=toks, mode="prefill",
                            caches=init_caches(full, 1, LM_SERVE["max_len"], device=dev))
    nxt = torch.argmax(lp[:, -1], -1)[:, None]
    ld, _, _ = forward(params, full, tokens=nxt, mode="decode", caches=caches,
                       positions=torch.tensor([[len(prompt)]], dtype=torch.int32, device=dev))
    lf, _, _ = forward(params, full, tokens=torch.cat([toks, nxt], 1), mode="train")
    full_diff = float((lf[:, -1].float() - ld[:, 0].float()).abs().max())
    finite = finite and bool(torch.isfinite(ld).all()) and bool(torch.isfinite(lf).all())
    del caches
    # the device's share of a served step: busy time from one profiled
    # pass over the unprofiled median step of the run above
    prof = lm_decode_profile(torch, full, params, st["prompts"], dev)
    prof["device_busy_share_of_served_step"] = prof["device_busy_ms_per_step"] / decode_med
    del params
    torch.cuda.empty_cache()
    first_equal = firsts == [g[0] for g in st["generated"]]
    emit({"phase": "lm_slice", "check": "yi-6b full width", "arch": st["arch"], "layers": full.n_layers,
          "d_model": full.d_model, "vocab": full.vocab_size, "param_dtype": full.param_dtype,
          "act_dtype": full.act_dtype, "param_count": st["param_count"], **LM_SERVE, "warmup_requests": 1,
          "tokens": st["tokens"], "seconds": st["seconds"], "tokens_per_s": st["tokens_per_s"],
          "prefill_ms_batch1_median": prefill_med, "prefill_ms_batch1": st["prefill_ms"],
          "decode_ms_per_step_median": decode_med, "decode_ms_per_step": st["decode_ms"], "steps": st["steps"],
          "max_memory_allocated": st["max_memory_allocated"],
          "decode_step_bytes": step_bytes, "decode_step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
          "decode_step_bytes_moved_with_cast": cast_bytes,
          "decode_step_profile": prof,
          "first_tokens_equal_prefill_alone": first_equal, "logits_finite": finite,
          "prefill_decode_vs_train_max_abs_diff_bf16": full_diff, "generated": st["generated"][:2],
          "card": smi})
    check(first_equal, f"yi-6b: first tokens {[g[0] for g in st['generated']]} != prefilled alone {firsts}")
    check(finite, "yi-6b: logits finite")

    # ---- (4) the vlm example: B1 or B3 denoises, the model reads the context
    zero_counts()
    res = vlm_example.main(["--device", str(dev)])
    sync(torch, dev)
    got = kernel_counts()
    ran = KERNEL_COUNTER[res["backend"]]
    check(got[ran] > 0, f"vlm example: {ran} never launched: {got}")
    check_counts(got, {ran: got[ran]}, "vlm example")
    # the kernel's frames, at the example's shape, against the reference
    # plan's on the same noisy frames: the quantized contract
    from repro_torch.data import denoise_batch
    from repro_torch.plan import BGPlan

    ref = denoise_batch(res["noisy"], plan=BGPlan(res["bg"], backend="reference", device=dev))
    exact, lsb = quantized_agreement(res["denoised"], ref)
    emit({"phase": "lm_slice", "check": "vlm_preprocess example", "backend": res["backend"], "launches": got,
          "frames_hw": list(res["denoised"].shape), "quantized_exact_vs_reference": exact,
          "quantized_max_diff_vs_reference": lsb, "d_noisy": res["d_noisy"], "d_denoised": res["d_denoised"],
          "logits_shape": list(res["logits_shape"]), "logits_finite": res["finite"], "card": smi})
    check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"vlm example frames vs reference: {exact}, {lsb}")
    check(res["finite"] and res["d_denoised"] < res["d_noisy"] and res["logits"].is_cuda,
          f"vlm example: finite {res['finite']}, {res['d_denoised']} vs {res['d_noisy']}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_slice", "check": "done", "seconds": seconds, "card": smi})
    return {"seconds": seconds, "decode_ms_per_step_median": decode_med}


# phase "train_slice": LM training and checkpoints
TRAIN_BATCH, TRAIN_SEQ = 4, 16  # the smoke steps, card against CPU
# a train step's loss and parameters, card against CPU: the loss within
# rel 1e-4, the parameters within max abs 1e-3 (tests/test_train_substrate.py:83,
# scaled by lr: Adam's first step amplifies summation noise)
TRAIN_LOSS_REL, TRAIN_PARAM_ABS = 1e-4, 1e-3
# stablelm-1.6b at full width: train_4k's sequence length, its global batch
# of 256 cut to 2 to fit one card. One checkpoint, the final synchronous
# save (ckpt_every is the launcher's default, 100): a full-width checkpoint
# is 19.7 GB, the card host's disk takes about 45 GiB of writes per run, and
# a save every 2 steps writes three (steps 2 and 4, then step 4 again at the
# end, as the JAX Trainer does); the async saves run in the example (5)
TRAIN_FULL = dict(batch=2, seq=4096, steps=4, ckpt_every=100)
# remat against none, one sequence of each length: without remat 4096 does
# not fit; at 512 the peak is set where the gradients are stacked, at 2048
# by the activations
TRAIN_REMAT_SEQS = (512, 2048)
BF16_PEAK_FLOPS = 989e12  # one H100 SXM, dense bf16 (the data sheet)
EXAMPLE_STEPS = 300  # examples/train_lm.py's default


def train_batch(cfg, rng):
    """A smoke batch of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` (numpy)."""
    return train_batch_of(cfg, rng, TRAIN_BATCH, TRAIN_SEQ)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def train_slice(torch, smi, dev, work) -> dict:
    """Phase "train_slice": LM training and checkpoints on the card. (1)
    Every arch's smoke config (fp32 activations, TF32 off): one
    ``make_train_step`` step from the same seeded parameters (drawn on the
    CPU, copied over) and batch on the card and on the CPU, the loss within
    rel ``TRAIN_LOSS_REL``, every parameter within ``TRAIN_PARAM_ABS``;
    stablelm also with ``grad_accum=2``. (2) stablelm-1.6b at full width
    through ``train_lm`` (``TRAIN_FULL``: 2 x 4096, the config's
    ``grad_accum=2`` and ``remat="full"``, bf16 activations, a checkpoint
    every 2 steps and at the end): each step's loss, grad norm and time,
    tokens/s over steps 2 to 4, the 6N-FLOP share of the bf16 peak, the peak
    memory, the final synchronous save's seconds and the checkpoint's bytes
    on disk; losses and grad norms finite; then one functional step (JAX's
    form, new state beside the old) on the trained state under
    ``torch.profiler``: its peak beside the in-place trainer's, its device
    busy time against the unprofiled steps, its largest kernels. (3) remat
    against none at full
    width and ``TRAIN_REMAT_SEQS`` on the trained parameters: the same loss
    bit for bit, each peak above the resident state. (4) ``serve_lm`` with
    that checkpoint: the restored parameters equal the trainer's final ones
    leaf for leaf (``torch.equal``, on the card), every request finishes,
    each first token that of its prompt prefilled alone on the restored
    parameters. (5) ``examples/train_lm.py``'s ``LM100M`` for
    ``EXAMPLE_STEPS`` steps: its first-10 and last-10 mean losses (every
    loss finite), each save call's blocking seconds (async every 50 steps, the
    host snapshot in the loop). The Trainer installs SIGTERM/SIGINT handlers; the phase puts
    the previous ones back. No kernel of the port runs on this path (the
    counters stay at 0). Checkpoints go under ``work``; the full-width one
    stays there for ``lm_mesh_slice`` (read only; the caller removes
    ``work``). Returns the phase's seconds, the full-width run's step times
    and peak, and that checkpoint's directory."""
    import dataclasses
    import gc
    import signal

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
    from repro_torch.data import lm_batches
    from repro_torch.examples import train_lm as train_example
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.train import train_lm
    from repro_torch.models import forward, init_caches, init_params, model_flops_per_token, tree_leaves, tree_map
    from repro_torch.train import OptConfig, init_train_state, loss_fn, make_train_step

    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is off for the fp32 comparisons")
    cpu = torch.device("cpu")
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        # ---- (1) every smoke arch, one train step, card against CPU
        opt = OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
        variants = [(a, get_smoke_config(a)) for a in ARCHS]
        variants.append(("stablelm-1.6b grad_accum=2",
                         dataclasses.replace(get_smoke_config("stablelm-1.6b"), grad_accum=2)))
        for label, cfg in variants:
            check(cfg.act_dtype == "float32", f"{label}: fp32 activations")
            params = init_params(0, cfg, device=cpu)
            batch = train_batch(cfg, np.random.default_rng(1))
            step = make_train_step(cfg, opt)
            on_dev = tree_map(lambda t: t.to(dev), params)
            zero_counts()
            card_p, _, card_m = step(on_dev, init_train_state(on_dev), batch)
            sync(torch, dev)
            check_counts(kernel_counts(), {}, f"{label}: plain PyTorch, no kernel")
            cpu_p, _, cpu_m = step(params, init_train_state(params), batch)
            loss_card, loss_cpu = float(card_m["loss"]), float(cpu_m["loss"])
            rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
            perr = max(float((a.cpu() - b).abs().max()) for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)))
            on_card = all(t.is_cuda for t in tree_leaves(card_p))
            emit({"phase": "train_slice", "check": "smoke_step_card_vs_cpu", "arch": label,
                  "grad_accum": cfg.grad_accum, "remat": cfg.remat, "loss_card": loss_card, "loss_cpu": loss_cpu,
                  "loss_rel_err": rel, "param_max_abs_err": perr,
                  "grad_norm_card": float(card_m["grad_norm"]), "grad_norm_cpu": float(cpu_m["grad_norm"]),
                  "tolerance": {"loss_rel": TRAIN_LOSS_REL, "param_abs": TRAIN_PARAM_ABS}, "card": smi})
            check(on_card and rel <= TRAIN_LOSS_REL and perr <= TRAIN_PARAM_ABS,
                  f"{label}: train step, card against CPU: loss rel {rel}, params {perr}")

        # ---- (2) stablelm-1.6b at full width through the launcher's function
        full = get_config("stablelm-1.6b")
        check((full.n_layers, full.d_model, full.vocab_size, full.act_dtype, full.grad_accum, full.remat)
              == (24, 2048, 100352, "bfloat16", 2, "full"), f"stablelm-1.6b full config: {full}")
        ckpt = os.path.join(work, "stablelm")
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated(dev)  # what earlier phases still hold
        zero_counts()
        st = train_lm("stablelm-1.6b", ckpt_dir=ckpt, device=dev, **TRAIN_FULL,
                      log_fn=lambda i, m: print(f"  stablelm-1.6b step {i}: loss {m['loss']:.4f} grad norm "
                                                f"{m['grad_norm']:.3f} {m['step_time']:.3f} s", flush=True))
        check_counts(kernel_counts(), {}, "stablelm-1.6b training: plain PyTorch, no kernel")
        trainer = st.pop("trainer")
        tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
        step_flops = model_flops_per_token(full) * tokens
        later = st["step_time"][1:]
        mean_later = sum(later) / len(later)
        flop_share = step_flops / mean_later / BF16_PEAK_FLOPS
        ckpt_bytes = dir_bytes(os.path.join(ckpt, f"step_{TRAIN_FULL['steps']:08d}"))
        emit({"phase": "train_slice", "check": "stablelm-1.6b full width", "arch": st["arch"],
              "layers": full.n_layers, "d_model": full.d_model, "vocab": full.vocab_size,
              "param_count": sum(t.numel() for t in tree_leaves(trainer.params)),
              "act_dtype": full.act_dtype, "grad_accum": full.grad_accum, "remat": full.remat,
              **TRAIN_FULL, "global_batch_cut": "train_4k's 256 sequences cut to 2 to fit one card",
              "state": st["state"], "last_step": st["last_step"], "loss": st["loss"],
              "grad_norm": st["grad_norm"], "lr": st["lr"], "step_s": st["step_time"],
              "tokens_per_s_steps_2_to_4": st["tokens_per_s"], "step_flops_6n": step_flops,
              "step_bound_ms_6n": step_flops / BF16_PEAK_FLOPS * 1e3, "flop_share_6n_steps_2_to_4": flop_share,
              "max_memory_allocated": st["max_memory_allocated"], "resident_before": resident,
              "save_seconds": st["save_seconds"],
              "checkpoint_bytes": ckpt_bytes, "seconds": st["seconds"], "card": smi})
        check(st["last_step"] == TRAIN_FULL["steps"] and len(st["loss"]) == TRAIN_FULL["steps"],
              f"stablelm-1.6b: {TRAIN_FULL['steps']} steps: {st['last_step']}")
        check(all(np.isfinite(st["loss"])) and all(np.isfinite(st["grad_norm"])),
              f"stablelm-1.6b: finite losses {st['loss']} and grad norms {st['grad_norm']}")
        check(all(t.is_cuda for t in tree_leaves(trainer.params)), "stablelm-1.6b: parameters on the card")
        # the functional step (JAX's form: new parameters and moments beside
        # the old) on the same state and shape, its peak beside the in-place
        # trainer's; its results are dropped
        extra = next(lm_batches(full.vocab_size, TRAIN_FULL["batch"], TRAIN_FULL["seq"], 1, seed=TRAIN_FULL["steps"]))
        # run under torch.profiler: where a full-width step's device time goes
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fp, fo, fm = make_train_step(full, trainer.opt_cfg)(trainer.params, trainer.opt_state, extra)
            sync(torch, dev)
        functional_peak = torch.cuda.max_memory_allocated(dev)
        functional_loss = float(fm["loss"])
        del fp, fo, fm
        torch.cuda.empty_cache()
        kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        busy_ms = sum(t for _, t, _ in kernels) / 1e3
        top = sorted(kernels, key=lambda k: -k[1])[:8]
        emit({"phase": "train_slice", "check": "functional_step_profile", "arch": full.name,
              "max_memory_allocated_functional": functional_peak,
              "max_memory_allocated_in_place": st["max_memory_allocated"], "loss": functional_loss,
              "profiler_saw_device": busy_ms > 0, "device_busy_ms": busy_ms,
              "device_busy_share_of_mean_step_2_to_4": busy_ms / 1e3 / mean_later,
              "kernel_launches": sum(c for _, _, c in kernels),
              "top_kernels": [{"name": n[:90], "ms": t / 1e3, "launches": c} for n, t, c in top], "card": smi})
        check(bool(np.isfinite(functional_loss)), f"stablelm-1.6b functional step: loss {functional_loss}")

        # ---- (3) remat against none, full width at TRAIN_REMAT_SEQS
        trainer.opt_state = None
        torch.cuda.empty_cache()
        rng = np.random.default_rng(2)
        for seq in TRAIN_REMAT_SEQS:
            toks = torch.from_numpy(rng.integers(0, full.vocab_size, (1, seq + 1))).to(dev)
            mb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            remat_row = {}
            for remat in ("full", "none"):
                live = tree_map(lambda p: p.detach().requires_grad_(True), trainer.params)
                gc.collect()  # nothing of an earlier run may be freed inside this one
                sync(torch, dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                loss, parts = loss_fn(live, dataclasses.replace(full, remat=remat), mb)
                loss.backward()
                sync(torch, dev)
                value = float(loss.detach())
                remat_row[remat] = {"loss": value, "loss_bits": int(np.float32(value).view(np.int32)),
                                    "resident": base,
                                    "peak_above_resident": torch.cuda.max_memory_allocated(dev) - base}
                del live, loss, parts  # the parts hold the graph, and through it the gradients
                torch.cuda.empty_cache()
            same = remat_row["full"]["loss_bits"] == remat_row["none"]["loss_bits"]
            emit({"phase": "train_slice", "check": "remat_vs_none", "arch": full.name, "seq": seq,
                  **remat_row, "loss_equal": same, "card": smi})
            check(same, f"remat changes the loss at {seq}: {remat_row}")

        # ---- (4) the checkpoint served: restored leaf for leaf, then served
        like = init_params(0, full, device="meta")
        restored, meta = CheckpointManager(ckpt).restore({"params": like}, device=dev)
        equal = all(torch.equal(a, b) for a, b in zip(tree_leaves(restored["params"]), tree_leaves(trainer.params)))
        on_card = all(t.is_cuda for t in tree_leaves(restored["params"]))
        del trainer
        torch.cuda.empty_cache()
        zero_counts()
        sv = serve_lm("stablelm-1.6b", ckpt_dir=ckpt, device=dev, warmup=1, **LM_SERVE)
        check_counts(kernel_counts(), {}, "stablelm-1.6b serving: plain PyTorch, no kernel")
        firsts = []
        for prompt in sv["prompts"]:
            lp, _, _ = forward(restored["params"], full, tokens=torch.tensor([prompt], device=dev), mode="prefill",
                               caches=init_caches(full, 1, LM_SERVE["max_len"], device=dev))
            firsts.append(int(torch.argmax(lp[:, -1], -1)[0]))
        del restored
        torch.cuda.empty_cache()
        first_equal = firsts == [g[0] for g in sv["generated"]]
        done = [len(g) for g in sv["generated"]] == [LM_SERVE["max_tokens"]] * LM_SERVE["requests"]
        emit({"phase": "train_slice", "check": "train_checkpoint_serve", "arch": sv["arch"],
              "checkpoint_step": meta["step"], "served_restored_step": sv["restored_step"],
              "params_equal_trainer_final": equal, "params_on_card": on_card, **LM_SERVE, "warmup_requests": 1,
              "tokens": sv["tokens"], "seconds": sv["seconds"], "tokens_per_s": sv["tokens_per_s"],
              "decode_ms_per_step_median": float(np.median(sv["decode_ms"])),
              "max_memory_allocated": sv["max_memory_allocated"], "first_tokens_equal_prefill_alone": first_equal,
              "generated": sv["generated"][:2], "card": smi})
        check(equal and on_card, "restored parameters differ from the trainer's final ones")
        check(meta["step"] == sv["restored_step"] == TRAIN_FULL["steps"], f"restored step {sv['restored_step']}")
        check(done and first_equal, f"served from the checkpoint: {sv['generated']} vs first tokens {firsts}")

        # ---- (5) the example: LM100M
        zero_counts()
        ex = train_example.main(["--steps", str(EXAMPLE_STEPS), "--ckpt-dir", os.path.join(work, "lm100m"),
                                 "--device", str(dev)])
        check_counts(kernel_counts(), {}, "train_lm example: plain PyTorch, no kernel")
        ex_steps, ex_saves = ex["trainer"].step, ex["trainer"].save_seconds
        del ex["trainer"]
        emit({"phase": "train_slice", "check": "train_lm example", "config": "lm-100m", "steps": ex_steps,
              "first10_mean_loss": ex["first10"], "last10_mean_loss": ex["last10"],
              "step_s_median": float(np.median(ex["step_time"])), "save_seconds": ex_saves,
              "checkpoint_bytes": dir_bytes(os.path.join(work, "lm100m", f"step_{ex_steps:08d}")),
              "card": smi})
        check(ex_steps == EXAMPLE_STEPS and bool(np.isfinite(ex["losses"]).all()),
              f"train_lm example: {ex_steps} steps, loss {ex['first10']} -> {ex['last10']}")
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({"phase": "train_slice", "check": "done", "seconds": seconds, "card": smi})
    return {"seconds": seconds, "step_s": st["step_time"], "max_memory_allocated": st["max_memory_allocated"],
            "resident_before": resident, "ckpt": ckpt}


MESH_STEPS = 3  # timed steps of the (1, 1) mesh at full width, then one profiled
MESH_BITWISE_REPEATS = 2  # depth of the bit-for-bit check (stablelm-1.6b has 24)
MESH_CPU_SHAPE = (2, 2)  # the multi-rank check on the card host's CPU (gloo)
MESH_CPU_BATCH, MESH_CPU_SEQ = 4, 8
RING_TOL = 3e-5  # tests/test_distributed.py:220
GPIPE_TOL = 1e-5  # tests/test_distributed.py:99
MESH_LOSS_TOL, MESH_PARAM_TOL = 1e-3, 5e-3  # tests/test_distributed.py:67-70
# one AdamW step moves each parameter by about lr whatever the gradient: the
# backward pass is held by the grad norm and the first moments (relative;
# tests/test_torch_lm_sharding.py)
MESH_GNORM_RTOL, MESH_MOMENT_RTOL = 1e-5, 1e-4


def _cpu_mesh_rank(rank, world, work) -> None:
    """One rank of ``lm_mesh_slice``'s CPU check: every smoke arch's train
    step on a ``MESH_CPU_SHAPE`` gloo mesh against the same step on one
    device (both on the CPU, from the same seeded parameters and batch);
    rank 0 writes what it measured to ``work/cpu_mesh.json``."""
    import logging
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.elastic import lay_out
    from repro_torch.configs.registry import ARCHS, get_smoke_config
    from repro_torch.launch.dryrun import _shard_tree
    from repro_torch.models import init_params, param_logical_axes, tree_leaves
    from repro_torch.sharding.compat import set_mesh
    from repro_torch.sharding.partitioning import DEFAULT_RULES, axis_rules
    from repro_torch.train import OptConfig, init_train_state, make_train_step

    dist.init_process_group("gloo", init_method="file://" + os.path.join(work, "store"), rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", MESH_CPU_SHAPE, mesh_dim_names=("data", "model"))
        rows = []
        for arch in ARCHS:
            t0 = time.perf_counter()
            cfg = get_smoke_config(arch)
            params = init_params(0, cfg, device="cpu")
            batch = train_batch_of(cfg, np.random.default_rng(1), MESH_CPU_BATCH, MESH_CPU_SEQ)
            step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10))
            p1, s1, m1 = step(params, init_train_state(params), batch)
            sh = _shard_tree(param_logical_axes(cfg), mesh, DEFAULT_RULES, params)
            with axis_rules(DEFAULT_RULES), set_mesh(mesh):
                state = init_train_state(params)
                p2, s2, m2 = step(lay_out(params, sh), {"m": lay_out(state["m"], sh), "v": lay_out(state["v"], sh),
                                                        "step": state["step"]}, batch)
            perr = max(float((a - b.full_tensor()).abs().max()) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
            merr = max(float((a - b.full_tensor()).abs().max() / a.abs().max().clamp(min=1e-30))
                       for a, b in zip(tree_leaves(s1["m"]), tree_leaves(s2["m"])))
            g1, g2 = float(m1["grad_norm"]), float(m2["grad_norm"])
            rows.append({"arch": arch, "loss_single": float(m1["loss"]), "loss_mesh": float(m2["loss"]),
                         "loss_abs_err": abs(float(m1["loss"]) - float(m2["loss"])), "param_max_abs_err": perr,
                         "grad_norm_single": g1, "grad_norm_mesh": g2, "grad_norm_rel_err": abs(g1 - g2) / g1,
                         "moment_max_rel_err": merr, "seconds": time.perf_counter() - t0})
        if rank == 0:
            with open(os.path.join(work, "cpu_mesh.json"), "w") as f:
                json.dump({"torch": torch.__version__, "rows": rows}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def train_batch_of(cfg, rng, batch: int, seq: int):
    """A smoke batch of ``batch`` x ``seq`` (numpy): the inputs each
    frontend takes and random labels."""
    import numpy as np

    b = {}
    if cfg.frontend == "audio":
        b["embeds"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    if cfg.frontend == "vision":
        b["cross_ctx"] = rng.standard_normal((batch, cfg.cross_attn_tokens, cfg.d_model)).astype(np.float32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return b


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def lm_mesh_slice(torch, smi, dev, trained: dict, work: str) -> float:
    """Phase "lm_mesh_slice": the port's LM sharding on the card, a world-1
    ``nccl`` group and a ``(1, 1)`` ``("data", "model")`` ``DeviceMesh``
    (the card host has one card; NCCL takes one rank per card). (a)
    ``elastic_restore`` of ``train_slice``'s stablelm-1.6b checkpoint
    (full width and depth, read only) onto the mesh: every leaf equal to
    the checkpoint's array, placed as ``train_state_shardings`` says; then
    ``MESH_STEPS`` in-place steps at ``TRAIN_FULL``'s 2 x 4096 under
    ``axis_rules`` and ``set_mesh``, each timed beside ``train_slice``'s
    steps of the same run, tokens/s, the 6N-FLOP share of the bf16 peak,
    the peak memory, and one more step under ``torch.profiler`` (device busy
    time and launches). (b) The same config cut to
    ``MESH_BITWISE_REPEATS`` repeats: one functional step on the mesh equal
    to the step without a mesh bit for bit (loss, grad norm, every
    parameter; tokens drawn without repetition, so no embedding row's
    gradient adds in an order set by atomics, ROADMAP T3). (c)
    ``ring_attention`` on the card's world-1 ring at stablelm's widths
    (1 x 4096, 32 heads of 64, causal, fp32) against ``_sdpa_plain``
    (atol ``RING_TOL``), and ``gpipe`` with one stage against its sequential
    form (atol ``GPIPE_TOL``). (d) ``python -m repro_torch.launch.train
    --smoke --mesh 1x1 --distributed`` in a subprocess with torchrun's
    environment for world 1 on the card. (e) A CPU check on the running host's
    torch: ``MESH_CPU_SHAPE`` gloo ranks (a spawn) take one smoke train step
    of every arch against the single-device step (loss ``MESH_LOSS_TOL``,
    parameters ``MESH_PARAM_TOL``, grad norm ``MESH_GNORM_RTOL`` and first
    moments ``MESH_MOMENT_RTOL``, relative). No kernel of the port runs on this path
    (the counters stay at 0). Returns the phase's seconds."""
    import dataclasses
    import gc

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpointer import _as_tensor, tree_paths
    from repro_torch.checkpoint.elastic import elastic_restore, lay_out, train_state_shardings
    from repro_torch.configs.base import AttnSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.dryrun import _shard_tree
    from repro_torch.models import init_params, model_flops_per_token, param_logical_axes, tree_leaves
    from repro_torch.models.attention import _sdpa_plain
    from repro_torch.sharding.compat import set_mesh
    from repro_torch.sharding.partitioning import DEFAULT_RULES, axis_rules
    from repro_torch.sharding.pipeline_parallel import gpipe
    from repro_torch.sharding.ring_attention import ring_attention
    from repro_torch.train import OptConfig, init_train_state, make_train_step

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)  # what earlier phases still hold
    full = get_config("stablelm-1.6b")
    ckpt = trained["ckpt"]
    check(not dist.is_initialized(), "no process group before lm_mesh_slice")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        # ---- (a) elastic restore at full size, then steps on the mesh
        mgr = CheckpointManager(ckpt)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, opt_state, meta = elastic_restore(mgr, full, mesh)
        restore_s = time.perf_counter() - t0
        restore_peak = torch.cuda.max_memory_allocated(dev)
        state = {"params": params, "opt": opt_state}
        p_sh, o_sh = train_state_shardings(full, mesh)
        placed = all(tuple(t.placements) == s.placements for t, s in
                     zip(tree_leaves(state), tree_leaves({"params": p_sh, "opt": o_sh})))
        on_card = all(t.to_local().is_cuda for t in tree_leaves(state))
        equal, n_leaves = True, 0
        with np.load(os.path.join(mgr._path(meta["step"]), "arrays.npz")) as z:
            for key, leaf in tree_paths(state).items():
                want = _as_tensor(z[key], leaf.dtype).to(dev)
                equal = equal and torch.equal(leaf.full_tensor(), want)
                n_leaves += 1
                del want
        n_params = sum(t.numel() for t in tree_leaves(params))
        want_params = sum(t.numel() for t in tree_leaves(init_params(0, full, device="meta")))
        # each leaf goes straight from the host onto the mesh: the device
        # never holds more than the state (and one leaf in flight)
        leaf_bytes = [t.to_local().numel() * t.element_size() for t in tree_leaves(state)]
        restore_extra = restore_peak - resident - sum(leaf_bytes)
        emit({"phase": "lm_mesh_slice", "check": "elastic_restore", "arch": full.name, "mesh": [1, 1],
              "world_size": dist.get_world_size(), "backend": dist.get_backend(), "checkpoint_step": meta["step"],
              "param_count": n_params, "leaves": n_leaves, "leaves_equal_checkpoint": equal,
              "placements_as_train_state_shardings": placed, "on_card": on_card, "restore_s": restore_s,
              "restore_peak_bytes": restore_peak, "state_bytes": sum(leaf_bytes), "resident_before": resident,
              "restore_peak_beyond_state_bytes": restore_extra, "largest_leaf_bytes": max(leaf_bytes), "card": smi})
        check(equal and placed and on_card and n_params == want_params,
              f"elastic restore: equal {equal}, placed {placed}, on card {on_card}, {n_params} parameters")
        check(restore_extra <= max(leaf_bytes), f"elastic restore held {restore_extra} bytes beyond the state")

        steps_total = TRAIN_FULL["steps"] + MESH_STEPS
        opt = OptConfig(lr=3e-4, warmup_steps=min(100, steps_total // 10 + 1), decay_steps=steps_total)
        step_fn = make_train_step(full, opt, donate=True)
        batches = lm_batches(full.vocab_size, TRAIN_FULL["batch"], TRAIN_FULL["seq"], MESH_STEPS + 1,
                             seed=meta["step"])
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        step_s, losses = [], []
        with axis_rules(DEFAULT_RULES), set_mesh(mesh):
            for _ in range(MESH_STEPS):
                batch = next(batches)
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, batch)
                losses.append(float(m["loss"]))  # waits for the step
                step_s.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated(dev)
            from torch.profiler import ProfilerActivity, profile

            batch = next(batches)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, batch)
                losses.append(float(m["loss"]))
                profiled_s = time.perf_counter() - t0
        check_counts(kernel_counts(), {}, "stablelm-1.6b on the mesh: plain PyTorch, no kernel")
        kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        busy_ms = sum(t for _, t, _ in kernels) / 1e3
        tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
        later = step_s[1:]
        mean_later = sum(later) / len(later)
        step_flops = model_flops_per_token(full) * tokens
        slice_later = trained["step_s"][1:]
        emit({"phase": "lm_mesh_slice", "check": "mesh_steps", "arch": full.name, "mesh": [1, 1],
              "batch": TRAIN_FULL["batch"], "seq": TRAIN_FULL["seq"], "grad_accum": full.grad_accum,
              "remat": full.remat, "act_dtype": full.act_dtype, "step_s": step_s, "loss": losses,
              "mesh_step_s_mean_after_first": mean_later,
              "train_slice_step_s": trained["step_s"],
              "train_slice_step_s_mean_after_first": sum(slice_later) / len(slice_later),
              "mesh_over_train_slice": mean_later / (sum(slice_later) / len(slice_later)),
              "tokens_per_s_after_first": tokens / mean_later,
              "flop_share_6n_after_first": step_flops / mean_later / BF16_PEAK_FLOPS,
              "max_memory_allocated": peak, "resident_before": resident,
              "train_slice_max_memory_allocated": trained["max_memory_allocated"],
              "train_slice_resident_before": trained["resident_before"],
              "profiled_step_s": profiled_s, "profiler_saw_device": busy_ms > 0, "device_busy_ms": busy_ms,
              "device_busy_share_of_profiled_step": busy_ms / 1e3 / profiled_s,
              "device_busy_share_of_mean_step": busy_ms / 1e3 / mean_later,
              "kernel_launches": sum(c for _, _, c in kernels), "card": smi})
        check(all(np.isfinite(losses)), f"mesh steps: losses {losses}")
        check(all(t.to_local().is_cuda for t in tree_leaves(params)), "mesh steps: parameters on the card")
        del params, opt_state, state, m, prof
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (b) the mesh step equals the step without a mesh, bit for bit
        cut = dataclasses.replace(full, n_repeats=MESH_BITWISE_REPEATS)
        p0 = init_params(0, cut, device=dev)
        perm = np.random.default_rng(5).permutation(full.vocab_size)
        n = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
        batch = {"tokens": perm[:n].reshape(TRAIN_FULL["batch"], -1).astype(np.int32),
                 "labels": perm[n:2 * n].reshape(TRAIN_FULL["batch"], -1).astype(np.int32)}
        bit_step = make_train_step(cut, OptConfig(lr=3e-4, warmup_steps=1, decay_steps=10))
        p1, _, m1 = bit_step(p0, init_train_state(p0), batch)
        sh = _shard_tree(param_logical_axes(cut), mesh, DEFAULT_RULES, p0)
        with axis_rules(DEFAULT_RULES), set_mesh(mesh):
            s0 = init_train_state(p0)
            p2, _, m2 = bit_step(lay_out(p0, sh), {"m": lay_out(s0["m"], sh), "v": lay_out(s0["v"], sh),
                                                   "step": s0["step"]}, batch)
        same = [torch.equal(a, b.full_tensor()) for a, b in zip(tree_leaves(p1), tree_leaves(p2))]
        loss_equal = float(m1["loss"]) == float(m2["loss"])
        gnorm_equal = float(m1["grad_norm"]) == float(m2["grad_norm"])
        emit({"phase": "lm_mesh_slice", "check": "mesh_vs_no_mesh_bitwise", "arch": cut.name, "mesh": [1, 1],
              "n_repeats": cut.n_repeats, "cut": f"depth {full.n_repeats} -> {cut.n_repeats} repeats, width full",
              "batch": TRAIN_FULL["batch"], "seq": TRAIN_FULL["seq"], "loss_no_mesh": float(m1["loss"]),
              "loss_mesh": float(m2["loss"]), "loss_equal": loss_equal, "grad_norm_equal": gnorm_equal,
              "params_equal": sum(same), "params": len(same), "card": smi})
        check(loss_equal and gnorm_equal and all(same),
              f"mesh step differs from the step without a mesh: loss {loss_equal}, {sum(same)}/{len(same)} params")
        del p0, p1, p2, m1, m2, sh
        gc.collect()
        torch.cuda.empty_cache()

        # ---- (c) ring attention and GPipe on the card
        ring = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        g = torch.Generator(device=dev).manual_seed(11)
        S, Hh, D = TRAIN_FULL["seq"], full.n_heads, full.head_dim
        q, k, v = (torch.randn((1, S, Hh, D), generator=g, device=dev) for _ in range(3))
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        spec = AttnSpec(kind="global")
        zero_counts()
        out = ring_attention(q, k, v, pos, spec, ring, axis="data").full_tensor()
        ref = _sdpa_plain(q, k, v, pos, pos, spec, 0.0)
        ring_err = float((out - ref).abs().max())
        ring_ms = cuda_ms(torch, lambda: ring_attention(q, k, v, pos, spec, ring, axis="data"), 5)
        plain_ms = cuda_ms(torch, lambda: _sdpa_plain(q, k, v, pos, pos, spec, 0.0), 5)
        del out, ref
        pipe = init_device_mesh("cuda", (1,), mesh_dim_names=("pipe",))
        ws = torch.randn((1, full.d_model, full.d_model), generator=g, device=dev) / full.d_model ** 0.5
        xs = torch.randn((8, 2, full.d_model), generator=g, device=dev)
        gp = gpipe(lambda w, x: torch.tanh(x @ w), ws, xs, pipe, axis="pipe").full_tensor()
        gp_err = float((gp - torch.tanh(xs @ ws[0])).abs().max())
        check_counts(kernel_counts(), {}, "ring attention and GPipe: plain PyTorch, no kernel")
        emit({"phase": "lm_mesh_slice", "check": "ring_attention_and_gpipe", "ring_shape": [1, S, Hh, D],
              "ring_spec": "global causal fp32", "ring_max_abs_err": ring_err, "ring_tolerance": RING_TOL,
              "ring_ms": ring_ms, "sdpa_plain_ms": plain_ms, "gpipe_stages": 1, "gpipe_micro": 8,
              "gpipe_max_abs_err": gp_err, "gpipe_tolerance": GPIPE_TOL, "card": smi})
        check(ring_err <= RING_TOL and gp_err <= GPIPE_TOL, f"ring attention {ring_err}, gpipe {gp_err}")
        del q, k, v, ws, xs, gp
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- (d) the launcher's --mesh 1x1 --distributed under torchrun's environment
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-1.6b", "--smoke",
                           "--mesh", "1x1", "--distributed", "--steps", "3", "--ckpt-dir",
                           os.path.join(work, "launch_mesh")], capture_output=True, text=True, env=env, timeout=600)
    launch_s = time.perf_counter() - t0
    done = "done at step 3" in proc.stdout and "on cuda" in proc.stdout
    emit({"phase": "lm_mesh_slice", "check": "launcher_mesh_distributed", "returncode": proc.returncode,
          "argv": "--arch stablelm-1.6b --smoke --mesh 1x1 --distributed --steps 3", "world_size": 1,
          "backend": "nccl", "seconds": launch_s, "stdout_tail": proc.stdout[-400:], "card": smi})
    check(proc.returncode == 0 and done, f"launcher --mesh 1x1 --distributed: {proc.stdout[-800:]} {proc.stderr[-2000:]}")

    # ---- (e) several ranks, on the host's CPU with its own torch
    cpu_work = os.path.join(work, "cpu_mesh")
    os.makedirs(cpu_work, exist_ok=True)
    t0 = time.perf_counter()
    world = MESH_CPU_SHAPE[0] * MESH_CPU_SHAPE[1]
    mp.start_processes(_cpu_mesh_rank, args=(world, cpu_work), nprocs=world, start_method="spawn")
    with open(os.path.join(cpu_work, "cpu_mesh.json")) as f:
        res = json.load(f)
    worst = {k: max(r[k] for r in res["rows"]) for k in
             ("loss_abs_err", "param_max_abs_err", "grad_norm_rel_err", "moment_max_rel_err")}
    limits = {"loss_abs_err": MESH_LOSS_TOL, "param_max_abs_err": MESH_PARAM_TOL,
              "grad_norm_rel_err": MESH_GNORM_RTOL, "moment_max_rel_err": MESH_MOMENT_RTOL}
    emit({"phase": "lm_mesh_slice", "check": "cpu_multirank", "device": "cpu (a CPU check on the card host)",
          "backend": "gloo", "mesh": list(MESH_CPU_SHAPE), "torch": res["torch"], "archs": len(res["rows"]),
          "worst": worst, "tolerance": limits, "rows": res["rows"], "seconds": time.perf_counter() - t0})
    check(all(worst[k] <= limits[k] for k in limits), f"CPU multi-rank steps: worst {worst}, limits {limits}")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "lm_mesh_slice", "check": "done", "seconds": seconds, "card": smi})
    return seconds


# phase "dryrun_slice": the dry-run and roofline tooling
# (arch, shape, multi-pod): production cells that count in seconds, a
# multi-pod one, and a cell the registry skips
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k", False), ("yi-6b", "decode_32k", False),
                ("qwen2-moe-a2.7b", "train_4k", False), ("yi-6b", "decode_32k", True),
                ("hubert-xlarge", "decode_32k", False))
DRYRUN_TIMEOUT = 600  # seconds a dry-run cell's process may take
# a counted bound above the measured step by more than 5 % means the count
# charges work the card did not do
SHARE_LIMIT = 1.05


def dryrun_slice(torch, smi, served: dict, trained: dict, sweep: dict) -> float:
    """Phase "dryrun_slice": the dry-run and roofline tooling on the card's
    host. (a) ``python -m repro_torch.launch.dryrun`` for ``DRYRUN_CELLS``,
    one process per cell, all started together: each rank-0 step counted on
    a fake group of 256 or 512 ranks over meta tensors (no card); every
    record's status, memory, roofline and seconds printed, no cell errs,
    each skip is ``cell_skip_reason``'s, and the records rendered by the
    port's ``roofline.py``. (b) The roofline held against steps measured
    on the card earlier in this run: ``analyze_step``'s count (through
    ``dry_run`` at world 1, on meta tensors) of ``train_slice``'s
    stablelm-1.6b step (2 x 4096, ``grad_accum=2``, full remat; the mean
    of its steps 2 to 4) and of ``lm_slice``'s yi-6b decode step (4 slots
    of 256; its median), each with its compute and memory terms at the
    H100's peaks, the dominant one, and the share bound / measured, which
    must not pass ``SHARE_LIMIT``; the counted FLOPs at least the model's
    (6N a token to train; 2N less the embedding lookup's 2Vd, which is no
    product, to decode). (c) ``plan_sweep``'s workloads rendered by
    ``render_plan_sweep_table``, printed line by line. No kernel runs in
    this phase. Returns its seconds."""
    import shutil
    import tempfile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import cell_skip_reason, get_config
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.launch.specs import shape_cfg
    from repro_torch.launch.roofline import (load_cells, render_dryrun_table, render_plan_sweep_table,
                                             render_roofline_table)
    from repro_torch.models import model_flops_per_token
    from repro_torch.sharding.partitioning import MeshShape

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="dryrun_slice.", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    try:
        # ---- (a) the CLI, one process per cell, started together
        for arch, shape, multi_pod in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                   "--out", out, "--force"] + (["--multi-pod"] if multi_pod else [])
            procs.append(((arch, shape, multi_pod), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

        # ---- (b) meanwhile: the roofline against the card's steps
        one = MeshShape(("data", "model"), (1, 1))
        stablelm, yi = get_config("stablelm-1.6b"), get_config("yi-6b")
        later = trained["step_s"][1:]
        steps = [("stablelm-1.6b train step", stablelm,
                  ShapeSpec("train_slice", TRAIN_FULL["seq"], TRAIN_FULL["batch"], "train"),
                  sum(later) / len(later), "mean of train_slice's steps 2 to 4",
                  model_flops_per_token(stablelm) * TRAIN_FULL["batch"] * TRAIN_FULL["seq"]),
                 ("yi-6b decode step", yi, ShapeSpec("lm_slice", LM_SERVE["max_len"], LM_SERVE["slots"], "decode"),
                  served["decode_ms_per_step_median"] / 1e3, "median of lm_slice's served decode steps",
                  (model_flops_per_token(yi, train=False) - 2.0 * yi.vocab_size * yi.d_model) * LM_SERVE["slots"])]
        for label, cfg, shape, measured_s, measured_as, floor in steps:
            rec = dry_run(shape_cfg(cfg, shape, 1), shape, one)
            r = rec["roofline"]
            bound = max(r["compute_s"], r["memory_s"])
            row = {"phase": "dryrun_slice", "check": "roofline_vs_measured", "step": label,
                   "batch": shape.global_batch, "seq_or_cache": shape.seq_len, "grad_accum": rec["grad_accum"],
                   "remat": cfg.remat if shape.kind == "train" else None,
                   "counted_flops": r["flops_per_chip"], "counted_hbm_bytes": r["hbm_bytes_per_chip"],
                   "compute_s": r["compute_s"], "memory_s": r["memory_s"], "dominant": r["dominant"],
                   "model_flops": rec["model_flops"], "flops_floor": floor,
                   "counted_temp_bytes": rec["memory"]["temp_size_in_bytes"],
                   "counted_argument_bytes": rec["memory"]["argument_size_in_bytes"],
                   "measured_s": measured_s, "measured_as": measured_as, "share": bound / measured_s,
                   "count_seconds": rec["compile_s"], "card": smi}
            emit(row)
            check(row["share"] <= SHARE_LIMIT, f"{label}: counted bound {bound} s above the measured {measured_s} s")
            check(r["flops_per_chip"] >= floor, f"{label}: counted FLOPs {r['flops_per_chip']} below {floor}")

        # ---- (c) the kernels' plan table from plan_sweep's rows
        table = render_plan_sweep_table(sweep["records"])
        emit({"phase": "dryrun_slice", "check": "plan_sweep_table", "workloads": len(sweep["records"]),
              "regrets": [r["regret"] for r in sweep["records"]], "card": smi})
        for line in table.splitlines():
            print(line, flush=True)

        # ---- (a) the CLI's records
        for cell, proc in procs:
            so, se = proc.communicate(timeout=DRYRUN_TIMEOUT)
            check(proc.returncode == 0, f"dryrun {cell}: exit {proc.returncode}: {so[-1500:]} {se[-1500:]}")
        cells = load_cells(out)
        check(len(cells) == len(DRYRUN_CELLS), f"dryrun: {len(cells)} records for {len(DRYRUN_CELLS)} cells")
        for rec in cells:
            row = {"phase": "dryrun_slice", "check": "dryrun_cell",
                   **{k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "reason", "chips", "grad_accum",
                                              "lower_s", "compile_s", "memory", "roofline", "useful_flops_ratio")},
                   "torch": torch.__version__, "card": smi}
            emit(row)
            check(rec["status"] != "error", f"dryrun {rec['arch']} x {rec['shape']} x {rec['mesh']}: {rec}")
            if rec["status"] == "skipped":
                check(rec["reason"] == cell_skip_reason(rec["arch"], rec["shape"]), f"dryrun skip: {rec}")
            else:
                check(rec["roofline"]["flops_per_chip"] > 0 and rec["roofline"]["hbm_bytes_per_chip"] > 0,
                      f"dryrun {rec['arch']} x {rec['shape']}: an empty roofline")
        for line in (render_dryrun_table(cells) + "\n" + render_roofline_table(cells, "16x16") + "\n"
                     + render_roofline_table(cells, "2x16x16")).splitlines():
            print(line, flush=True)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "dryrun_slice", "check": "done", "seconds": seconds, "card": smi})
    return seconds


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this script runs only on the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # the launcher's plan_for reads the default plan cache: point it at an
    # empty file of this run, so the served plans are the cost model's
    import tempfile

    cache_dir = tempfile.TemporaryDirectory()
    os.environ["REPRO_TORCH_PLAN_CACHE"] = os.path.join(cache_dir.name, "plan_cache.json")
    from repro_torch.configs.bg_denoise import FIG12_SWEEPS, PAPER_DEFAULT, SERVE_CONFIG, TABLE1_SWEEP
    from repro_torch.core import (BGConfig, add_gaussian_noise, grid_normalize, grid_shape, mssim,
                                  psnr, quantize_intensity, synthetic_batch)
    from repro_torch.kernels import (_build, bg_blur, bg_blur_plain, bg_create, bg_create_plain,
                                     bg_fused, bg_fused_plain, bg_slice, bg_slice_plain)
    from repro_torch.launch.serve import serve_frames, serve_video
    from repro_torch.plan import BGPlan
    from repro_torch.serving import FrameDenoiseEngine, FrameRequest

    kmod = importlib.import_module("repro_torch.kernels.bg_fused")
    bmod = importlib.import_module("repro_torch.kernels.bg_blur")
    smod = importlib.import_module("repro_torch.kernels.bg_slice")
    cmod = importlib.import_module("repro_torch.kernels.bg_create")

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
    _build.build_all(_build.SOURCES)  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    limits = (torch.cuda.get_device_properties(0).multi_processor_count, kmod._device_limits(0)[1])
    ptxas = {src: [ln.strip() for ln in _build.build_log(src).splitlines() if "ptxas info" in ln]
             for src in _build.SOURCES}
    emit({"phase": "device", "nvidia_smi": smi, "device_name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "ptxas": ptxas})

    # ---- phase 2: kernel vs plain on the card, full HD, b=4
    clean = synthetic_batch(8, H, W, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x8 = add_gaussian_noise(clean, 30.0, generator=gen).contiguous()
    x4 = x8[:4].contiguous()
    max_err = b3_err = 0.0
    staged_err = [0.0, 0.0, 0.0]  # GC, GF, TI
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
        b3_err = max(b3_err, streamed_vs_fused(torch, x4, label, cfg, k, plain))
        staged_err = [max(a, e) for a, e in zip(staged_err, staged_vs_plain(torch, x4, label, cfg))]
    t_img_err, t_carry_err = temporal_vs_plain(
        torch, x8, cfgs, bg_fused, bg_fused_plain, quantize_intensity, grid_shape
    )
    # r=2 at full HD, with FIG12's sigmas and with PAPER_DEFAULT's: B1 and B3
    # run in column tiles (the whole width would need 461,760 B of shared
    # memory on B1); B3 equals B1 bit for bit
    x1 = x4[:1].contiguous()
    for label, r2 in (("FIG12 r=2", FIG12_SWEEPS["r"][0]), ("r=2 PAPER_DEFAULT sigmas", BGConfig(2, 8.0, 70.0))):
        k = bg_fused(x1, r2)
        s2 = bg_fused(x1, r2, stream_input=True)
        plain = bg_fused_plain(x1, r2)
        torch.cuda.synchronize()
        err = float((k - plain).abs().max())
        s_err = float((s2 - plain).abs().max())
        exact, lsb = quantized_agreement(quantize_intensity(k, r2), quantize_intensity(plain, r2))
        emit({"phase": "kernel_vs_plain", "config": label, "shape": list(x1.shape), "max_abs_err": err,
              "quantized_exact": exact, "quantized_max_diff": lsb, "b3_bitwise_b1": bool(torch.equal(s2, k)),
              "b3_max_abs_err": s_err, "geometry": kmod.launch_geometry(1, H, W, r2, *limits)._asdict(),
              "b3_geometry": kmod.stream_geometry(1, H, W, r2, *limits)._asdict()})
        check(bool(torch.isfinite(k).all()) and err <= TOL_ABS, f"{label}: max |kernel - plain| {err}")
        check(exact >= TOL_EXACT and lsb <= TOL_LSB, f"{label}: quantized {exact}, {lsb}")
        check(torch.equal(s2, k) and s_err <= TOL_ABS, f"{label}: B3 differs from B1 ({s_err} from plain)")
        max_err, b3_err = max(max_err, err), max(b3_err, s_err)

    # ---- phase 2b: the bf16 storage form of B1, B2 and B3 against its plain
    # version, bit for bit, at every full-HD config above and at widths
    # 1918 and 1917 (rows of 3836 and 3834 bytes)
    bf16_checks = [(label, c, W) for label, c in cfgs] + [
        ("PAPER_DEFAULT w=1918", PAPER_DEFAULT.bg, W - 2), ("PAPER_DEFAULT w=1917", PAPER_DEFAULT.bg, W - 3)]
    bf16_values, bf16_err = bf16_vs_plain(torch, x8, bf16_checks, smi)

    # ---- phase 3: the slice, through the engine a user calls
    n_req, max_batch = 19, 8
    cfg = PAPER_DEFAULT.bg
    clean_h = synthetic_batch(n_req, H, W, seed=100, device="cpu")
    noisy_h = add_gaussian_noise(clean_h, 30.0, generator=torch.Generator().manual_seed(2))
    frames = noisy_h.numpy()
    eng = FrameDenoiseEngine(plan=BGPlan(cfg, backend="fused", device="cuda"), max_batch=max_batch)
    zero_counts()
    for i in range(n_req):
        eng.submit(FrameRequest(uid=i, frame=frames[i]))
    done, dispatches = [], 0
    while eng.pending():
        done.extend(eng.step())
        dispatches += 1
    torch.cuda.synchronize()
    launches = bg_fused.launches
    check_counts(kernel_counts(), {"bg_fused.launches": 3}, "frame slice")
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

    # ---- phase 3b: the streamed slice (the JAX engine's stream_input=True)
    streamed = streamed_slice(torch, cfg, frames, ref, dev)

    # ---- phase 3c: the staged backend through denoise_batch, 8 frames
    staged = staged_slice(torch, cfg, frames[:8], out[:8], dev)

    # ---- phase 3d: the video slice, through the async engine and packer
    video = video_slice(torch, cfg, smi, dev)

    # ---- phase 3e: the bf16 slice: frames on bf16 fused and streamed plans,
    # video on a bf16 packer, only the bf16 entry points counted
    bf16 = bf16_slice(torch, cfg, smi, dev)

    # ---- phase 3f: plan selection: the candidates plan_for ranks, timed;
    # the measured winners through a temporary cache and back; the fit of
    # the cost model's overhead constants
    sweep = plan_sweep(torch, x8, smi, dev)

    # ---- phase 3g: guarded dispatch: a failed primary rung, a hung
    # completion, corrupted input
    guarded_dispatch(torch, frames, smi, dev)

    # ---- phase 4: times at b=8, PAPER_DEFAULT, CUDA events: a kernel's
    # `ms` is the mean of back-to-back wrapper calls (the method since the
    # port began), `device_ms` the device's time alone (graph_ms)
    k8 = bg_fused(x8, cfg)
    p8 = bg_fused_plain(x8, cfg)
    err8 = float((k8 - p8).abs().max())
    check(err8 <= TOL_ABS, f"b=8: max |kernel - plain| {err8}")
    max_err = max(max_err, err8)
    ms, device_ms = kernel_ms(torch, lambda: bg_fused(x8, cfg), reps=50)
    plain_ms = cuda_ms(torch, lambda: bg_fused_plain(x8, cfg), reps=5, warmup=1)
    b = x8.shape[0]
    bound_ms, bound_by, nbytes, flops = bg_fused_bound(b, H, W, cfg, grid_shape)
    # B2 at b=4 and b=8 on a carry from the frames themselves, alpha mixed
    gx, gy, gz = grid_shape(H, W, cfg)
    temporal_times, temporal_device = {}, {}
    for tb in (4, 8):
        xs = x8[:tb].contiguous()
        alpha = torch.tensor((ALPHAS * 2)[:tb], device=dev)
        carry = bg_fused(xs, cfg, carry=torch.zeros((tb, gx, gy, gz, 2), device=dev),
                         alpha=torch.zeros_like(alpha))[1]
        k_out, k_carry = bg_fused(xs, cfg, carry=carry, alpha=alpha)
        p_out, p_carry = bg_fused_plain(xs, cfg, carry=carry, alpha=alpha)
        err = float((k_out - p_out).abs().max())
        check(err <= TOL_ABS and carry_close(torch, k_carry, p_carry), f"B2 b={tb}: err {err}")
        t_img_err = max(t_img_err, err)
        t_ms, temporal_device[tb] = kernel_ms(torch, lambda: bg_fused(xs, cfg, carry=carry, alpha=alpha), reps=50)
        t_plain_ms = cuda_ms(torch, lambda: bg_fused_plain(xs, cfg, carry=carry, alpha=alpha), reps=5, warmup=1)
        temporal_times[tb] = (t_ms, t_plain_ms) + bg_fused_temporal_bound(tb, H, W, cfg, grid_shape)
        emit({"phase": "temporal_times", "config": "PAPER_DEFAULT", "batch": tb, "ms": t_ms,
              "ms_per_frame": t_ms / tb, "device_ms_per_frame": temporal_device[tb] / tb,
              "plain_ms": t_plain_ms, "plain_ms_per_frame": t_plain_ms / tb,
              "bound_ms": temporal_times[tb][2], "bound_ms_per_frame": temporal_times[tb][2] / tb,
              "bound_by": temporal_times[tb][3], "card": smi})
    t_ms, t_plain_ms, t_bound_ms, t_bound_by, t_bytes, t_flops = temporal_times[8]

    # B3 at b=8: its plain version is B1's (the same function)
    s8 = bg_fused(x8, cfg, stream_input=True)
    check(torch.equal(s8, k8), "b=8: B3 differs from B1")
    s_ms, s_device_ms = kernel_ms(torch, lambda: bg_fused(x8, cfg, stream_input=True), reps=50)
    # B4, B5, B6 at b=8 (the staged slice's shape) against their plain
    # versions at the JAX tolerances, as at b=4
    g8 = bg_create(x8, cfg)
    bl8 = bg_blur(g8, cfg)
    gf8 = grid_normalize(bl8)
    sl8 = bg_slice(gf8, x8, cfg)
    bl8_plain = bg_blur_plain(g8, cfg)
    g8_plain = bg_create_plain(x8, cfg)
    errs8 = (float((g8 - g8_plain).abs().max()), float((bl8 - bl8_plain).abs().max()),
             float((sl8 - bg_slice_plain(gf8, x8, cfg)).abs().max()))
    gf8_ok = bool(torch.allclose(bl8, bl8_plain, rtol=TOL_GF[0], atol=TOL_GF[1]))
    g8_bitwise = bool(torch.equal(g8, g8_plain))
    emit({"phase": "staged_vs_plain", "config": "PAPER_DEFAULT", "shape": list(x8.shape),
          "gc_max_abs_err": errs8[0], "gc_bitwise_plain": g8_bitwise, "gc_counts": float(g8[..., 0].sum()),
          "gf_max_abs_err": errs8[1], "gf_within_tolerance": gf8_ok, "ti_max_abs_err": errs8[2]})
    check(g8_bitwise and float(g8[..., 0].sum()) == x8.numel(), f"b=8: B4 differs from plain by {errs8[0]}")
    check(gf8_ok, f"b=8: GF err {errs8[1]}")
    check(errs8[2] <= TOL_TI, f"b=8: TI err {errs8[2]}")
    staged_err = [max(a, e) for a, e in zip(staged_err, errs8)]
    # the library yardsticks: each is timed whatever its difference from the
    # kernel, which is recorded and flagged against the kernel's tolerance
    library = {}
    for kid, (call, lib_out), kout, within in (
        ("B4", index_add_create(torch, x8, cfg), g8, lambda d: d <= TOL_GC),
        ("B5", conv3d_blur(torch, g8, cfg), bl8,
         lambda d: bool(torch.allclose(lib_out, bl8, rtol=TOL_GF[0], atol=TOL_GF[1]))),
        ("B6", grid_sample_slice(torch, gf8, x8, cfg), sl8, lambda d: d <= TOL_TI),
    ):
        diff = float((lib_out - kout).abs().max())
        library[kid] = (*kernel_ms(torch, call, reps=20), diff, within(diff))
    descr = {"B4": "index_add_ of each pixel's (1, px) into a zeroed (cells, 2) grid, the cells computed "
                   "from the frames outside the timed call",
             "B5": "grouped conv3d, 3x3x3 outer-product taps, on the grid permuted to (b, 2, gx, gy, gz) "
                   "outside the timed call",
             "B6": "3-D trilinear grid_sample, zero padding, corners aligned, coordinates built outside "
                   "the timed call"}
    sb = staged_bounds(b, H, W, cfg, grid_shape)
    # {kernel: (ms, device_ms, plain_ms, library_ms, library_device_ms,
    #  library_max_abs_diff, library_within_tolerance, library)}
    staged_times = {
        "B4": (*kernel_ms(torch, lambda: bg_create(x8, cfg), reps=50),
               cuda_ms(torch, lambda: bg_create_plain(x8, cfg), reps=3, warmup=1)),
        "B5": (*kernel_ms(torch, lambda: bg_blur(g8, cfg), reps=50),
               cuda_ms(torch, lambda: bg_blur_plain(g8, cfg), reps=3, warmup=1)),
        "B6": (*kernel_ms(torch, lambda: bg_slice(gf8, x8, cfg), reps=50),
               cuda_ms(torch, lambda: bg_slice_plain(gf8, x8, cfg), reps=3, warmup=1)),
    }
    staged_times = {k: v + library[k] + (descr[k],) for k, v in staged_times.items()}
    emit({"phase": "staged_times", "config": "PAPER_DEFAULT", "batch": b, "card": smi,
          "b3_ms_per_frame": s_ms / b, "b1_ms_per_frame": ms / b,
          **{k: {"ms_per_frame": v[0] / b, "device_ms_per_frame": v[1] / b, "plain_ms_per_frame": v[2] / b,
                 "library_ms_per_frame": v[3] / b, "library_device_ms_per_frame": v[4] / b,
                 "library_max_abs_diff": v[5], "library_within_tolerance": v[6], "library": v[7],
                 "bound_ms_per_frame": sb[k][0] / b, "bound_by": sb[k][1]}
             for k, v in staged_times.items()}})
    emit({"phase": "bounds", "config": "PAPER_DEFAULT", "frame_hw": [H, W],
          "bytes_bound_ms_per_frame": tpu_kernel_bounds(cfg, grid_shape)})
    # B1 to B6 at b = 1, 4 and 8 at their default splits, B4 beside
    # index_add_, B5 beside grouped conv3d and B6 beside grid_sample on the
    # same inputs, both ways; and the staged route whole, beside B1 and B3:
    # the sum of B4, B5, the normalization and B6, and one staged plan
    # dispatch (the fused and streamed plans' beside it)
    by_batch, device_by_batch = {}, {}
    plans = {k: BGPlan(cfg, backend=k, device=dev) for k in ("staged", "fused", "fused_streamed")}
    for bb in (1, 4, 8):
        xs = x8[:bb].contiguous()
        alpha = torch.tensor((ALPHAS * 2)[:bb], device=dev)
        carry = bg_fused(xs, cfg, carry=torch.zeros((bb, gx, gy, gz, 2), device=dev),
                         alpha=torch.zeros_like(alpha))[1]
        gb = g8[:bb].contiguous()
        blb = bl8[:bb].contiguous()
        gfb = gf8[:bb].contiguous()
        gc_b = bg_create(xs, cfg)
        b4_bitwise = bool(torch.equal(gc_b, bg_create_plain(xs, cfg)) and torch.equal(gc_b, gb))
        check(b4_bitwise, f"b={bb}: B4 differs from its plain version or from the b=8 launch")
        ia_call, ia_out = index_add_create(torch, xs, cfg)
        gs_call, gs_out = grid_sample_slice(torch, gfb, xs, cfg)
        conv_call, conv_out = conv3d_blur(torch, gb, cfg)
        conv_ok = bool(torch.allclose(conv_out, bg_blur(gb, cfg), rtol=TOL_GF[0], atol=TOL_GF[1]))
        staged_q = plans["staged"](xs)
        fused_q = plans["fused"](xs)
        staged_exact, staged_lsb = quantized_agreement(staged_q, fused_q)
        check(staged_exact == 1.0, f"b={bb}: staged plan equals fused on {staged_exact} of pixels")
        calls = {"B1": lambda: bg_fused(xs, cfg),
                 "B2": lambda: bg_fused(xs, cfg, carry=carry, alpha=alpha),
                 "B3": lambda: bg_fused(xs, cfg, stream_input=True),
                 "B4": lambda: bg_create(xs, cfg),
                 "index_add_": ia_call,
                 "B5": lambda: bg_blur(gb, cfg),
                 "conv3d": conv_call,
                 "normalize": lambda: grid_normalize(blb),
                 "B6": lambda: bg_slice(gfb, xs, cfg),
                 "grid_sample": gs_call,
                 **{f"{k}_dispatch": (lambda p=p: p(xs)) for k, p in plans.items()}}
        t, td = {}, {}
        for k, fn in calls.items():
            t[k], td[k] = (v / bb for v in kernel_ms(torch, fn, reps=50))
        by_batch[bb], device_by_batch[bb] = t, td
        route = ("B4", "B5", "normalize", "B6")
        emit({"phase": "redesign_times", "config": "PAPER_DEFAULT", "batch": bb,
              "ms_per_frame": t, "device_ms_per_frame": td,
              "staged_route": {"kernels": list(route), "sum_ms_per_frame": sum(t[k] for k in route),
                               "sum_device_ms_per_frame": sum(td[k] for k in route),
                               "dispatch_ms_per_frame": t["staged_dispatch"],
                               "dispatch_device_ms_per_frame": td["staged_dispatch"],
                               "b1_ms_per_frame": t["B1"], "b1_device_ms_per_frame": td["B1"],
                               "b3_ms_per_frame": t["B3"], "b3_device_ms_per_frame": td["B3"],
                               "quantized_exact_vs_fused": staged_exact,
                               "quantized_max_diff_vs_fused": staged_lsb},
              "b4_bitwise_plain": b4_bitwise,
              "index_add_max_abs_diff": float((ia_out - gc_b).abs().max()),
              "b4_at_or_below_index_add": t["B4"] <= t["index_add_"],
              "b5_at_or_below_conv3d": t["B5"] <= t["conv3d"],
              "b5_device_at_or_below_conv3d": td["B5"] <= td["conv3d"],
              "conv3d_within_gf_tolerance": conv_ok,
              "b3_at_or_below_b1": t["B3"] <= t["B1"], "b3_device_at_or_below_b1": td["B3"] <= td["B1"],
              "b6_bitwise_plain": bool(torch.equal(bg_slice(gfb, xs, cfg), bg_slice_plain(gfb, xs, cfg))),
              "grid_sample_max_abs_diff": float((gs_out - bg_slice(gfb, xs, cfg)).abs().max()),
              "b1_geometry": kmod.launch_geometry(bb, H, W, cfg, *limits)._asdict(),
              "b2_geometry": kmod.launch_geometry(bb, H, W, cfg, *limits, temporal=True)._asdict(),
              "b5_geometry": dict(zip(("run", "runs", "ytile", "ytiles", "smem"),
                                      bmod.blur_geometry(bb, gx, gy, gz, *limits))),
              "b3_geometry": kmod.stream_geometry(bb, H, W, cfg, *limits)._asdict(),
              "b6_geometry": smod.slice_geometry(H, W, cfg, limits[1])._asdict(),
              "b4_geometry": cmod.create_geometry(bb, H, W, cfg, *limits)._asdict(),
              "card": smi})
    # the bf16 forms beside fp32, and their quality against fp32's
    bf16_t = bf16_times(torch, x8, cfg, smi)
    bf16_plain_ms = {
        "B1": cuda_ms(torch, lambda: bg_fused_plain(x8.to(torch.bfloat16), cfg, precision="bf16"),
                      reps=3, warmup=1),
        "B2": cuda_ms(torch, lambda: bg_fused_plain(
            x8.to(torch.bfloat16), cfg, carry=torch.zeros((b, gx, gy, gz, 2), device=dev, dtype=torch.bfloat16),
            alpha=torch.tensor(ALPHAS * 2, device=dev), precision="bf16"), reps=3, warmup=1)}
    bf16_quality(torch, [("PAPER_DEFAULT", cfg), ("quality r=6", BGConfig(6, 4.0, 60.0)),
                         ("quality r=12 sigma_s=6", BGConfig(12, 6.0, 80.0))], smi, dev)
    # the split knobs of B1 and B5 at b = 1, 4, 8 (and at the serve grid at
    # b=8), each variant checked bit for bit against the default launch
    for label, sweep_cfg, bb in (("PAPER_DEFAULT", cfg, 1), ("PAPER_DEFAULT", cfg, 4),
                                 ("PAPER_DEFAULT", cfg, 8), ("serve r=6", SERVE_CONFIG, 8)):
        for row in kernel_sweep(torch, x8[:bb].contiguous(), sweep_cfg, label, limits):
            emit({**row, "card": smi})
    # B3's knobs (band x tile, then chunk x z group), B4's (band x tile,
    # then z group x tile) and B6's (band x tile) at b = 1, 4, 8, each
    # variant checked bit for bit against the default
    for bb in (1, 4, 8):
        xs = x8[:bb].contiguous()
        emit({**stream_sweep(torch, xs, cfg, limits), "card": smi})
        emit({**create_sweep(torch, xs, cfg, limits), "card": smi})
        emit({**slice_sweep(torch, xs, grid_normalize(bg_blur(bg_create(xs, cfg), cfg)), cfg), "card": smi})
    emit({"kernels": [{
        "name": "bg_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bg_fused.cu",
        "replaces": "src/repro/kernels/bg_fused.py:645",
        "launches": launches, "dispatches": dispatches,
        "launches_per_dispatch": launches / dispatches,
        "video_slice_launches": video["bg_fused_launches"], "video_slice_cold_packs": video["cold_packs"],
        "max_abs_err": max_err, "tolerance": TOL_ABS,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "device_ms": device_ms,
        "ms_per_frame": ms / b, "plain_ms_per_frame": plain_ms / b, "bound_ms_per_frame": bound_ms / b,
        "ms_per_frame_by_batch": {bb: t["B1"] for bb, t in by_batch.items()},
        "device_ms_per_frame_by_batch": {bb: t["B1"] for bb, t in device_by_batch.items()},
        "bytes": nbytes, "flops": flops, "timed_shape": [b, H, W], "config": "PAPER_DEFAULT",
        "card": smi,
    }, {
        "name": "bg_fused_temporal", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bg_fused.cu",
        "replaces": "src/repro/kernels/bg_fused.py:569",
        "launches": video["bg_fused_temporal_launches"], "dispatches": video["dispatches"],
        "launches_per_dispatch": video["bg_fused_temporal_launches"] / video["dispatches"],
        "max_abs_err": t_img_err, "tolerance": TOL_ABS,
        "carry_max_abs_err": t_carry_err, "carry_tolerance": [TOL_CARRY_ABS, TOL_CARRY_REL],
        "ms": t_ms, "plain_ms": t_plain_ms, "bound_ms": t_bound_ms, "bound_by": t_bound_by,
        "library_ms": None, "device_ms": temporal_device[8],
        "ms_per_frame": t_ms / 8, "plain_ms_per_frame": t_plain_ms / 8, "bound_ms_per_frame": t_bound_ms / 8,
        "ms_per_frame_b4": temporal_times[4][0] / 4,
        "ms_per_frame_by_batch": {bb: t["B2"] for bb, t in by_batch.items()},
        "device_ms_per_frame_by_batch": {bb: t["B2"] for bb, t in device_by_batch.items()},
        "bytes": t_bytes, "flops": t_flops, "timed_shape": [8, H, W], "config": "PAPER_DEFAULT",
        "card": smi,
    }, {
        "name": "bg_fused_streamed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bg_fused_streamed.cu",
        "replaces": "src/repro/kernels/bg_fused.py:620",
        "launches": streamed["launches"]["bg_fused.streamed_launches"], "dispatches": streamed["dispatches"],
        "launches_per_dispatch": streamed["launches"]["bg_fused.streamed_launches"] / streamed["dispatches"],
        "max_abs_err": b3_err, "tolerance": TOL_ABS, "bitwise_b1": True,
        "ms": s_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "device_ms": s_device_ms,
        "ms_per_frame": s_ms / b, "plain_ms_per_frame": plain_ms / b, "bound_ms_per_frame": bound_ms / b,
        "ms_per_frame_by_batch": {bb: t["B3"] for bb, t in by_batch.items()},
        "device_ms_per_frame_by_batch": {bb: t["B3"] for bb, t in device_by_batch.items()},
        "bytes": nbytes, "flops": flops, "timed_shape": [b, H, W], "config": "PAPER_DEFAULT",
        "card": smi,
    }] + [{
        "name": kname, "route": "cuda", "precision": "bf16",
        "source": f"src/repro_torch/kernels/csrc/{src}.cu", "replaces": replaces,
        "entry_point": entry,
        "launches": bf16[run]["launches"][counter], "dispatches": bf16[run]["dispatches"],
        "launches_per_dispatch": bf16[run]["launches"][counter] / bf16[run]["dispatches"],
        "max_abs_err": bf16_err, "tolerance": 0.0, "values_compared_bitwise": bf16_values,
        "ms": bf16_t[8]["ms"][kid + "-bf16"] * 8, "device_ms": bf16_t[8]["device_ms"][kid + "-bf16"] * 8,
        "plain_ms": bf16_plain_ms["B2" if kid == "B2" else "B1"],
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        "ms_per_frame": bf16_t[8]["ms"][kid + "-bf16"],
        "plain_ms_per_frame": bf16_plain_ms["B2" if kid == "B2" else "B1"] / 8, "bound_ms_per_frame": bnd[0] / 8,
        "ms_per_frame_by_batch": {bb: v["ms"][kid + "-bf16"] for bb, v in bf16_t.items()},
        "device_ms_per_frame_by_batch": {bb: v["device_ms"][kid + "-bf16"] for bb, v in bf16_t.items()},
        "fp32_ms_per_frame_by_batch": {bb: v["ms"][kid] for bb, v in bf16_t.items()},
        "fp32_device_ms_per_frame_by_batch": {bb: v["device_ms"][kid] for bb, v in bf16_t.items()},
        "bytes": bnd[2], "flops": bnd[3], "timed_shape": [8, H, W], "config": "PAPER_DEFAULT", "card": smi,
    } for kid, kname, src, replaces, entry, run, counter, bnd in (
        ("B1", "bg_fused_bf16", "bg_fused", "src/repro/kernels/bg_fused.py:645", "bg_fused_bf16_launch",
         "fused", "bg_fused.bf16_launches", bg_fused_bound(8, H, W, cfg, grid_shape, 2)),
        ("B2", "bg_fused_temporal_bf16", "bg_fused", "src/repro/kernels/bg_fused.py:569",
         "bg_fused_temporal_bf16_launch", "video", "bg_fused.bf16_temporal_launches",
         bg_fused_temporal_bound(8, H, W, cfg, grid_shape, 2)),
        ("B3", "bg_fused_streamed_bf16", "bg_fused_streamed", "src/repro/kernels/bg_fused.py:620",
         "bg_fused_streamed_bf16_launch", "fused_streamed", "bg_fused.bf16_streamed_launches",
         bg_fused_bound(8, H, W, cfg, grid_shape, 2)),
    )] + [{
        "name": kname, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
        "replaces": replaces,
        "launches": staged["launches"][f"{kname}.launches"], "dispatches": staged["dispatches"],
        "launches_per_dispatch": staged["launches"][f"{kname}.launches"] / staged["dispatches"],
        "max_abs_err": err, "tolerance": tol,
        "ms": staged_times[kid][0], "device_ms": staged_times[kid][1], "plain_ms": staged_times[kid][2],
        "bound_ms": sb[kid][0], "bound_by": sb[kid][1],
        "library_ms": staged_times[kid][3], "library_device_ms": staged_times[kid][4],
        "library_max_abs_diff": staged_times[kid][5],
        "library_within_tolerance": staged_times[kid][6], "library": staged_times[kid][7],
        "ms_per_frame": staged_times[kid][0] / b, "plain_ms_per_frame": staged_times[kid][2] / b,
        "bound_ms_per_frame": sb[kid][0] / b, "bytes": sb[kid][2], "flops": sb[kid][3],
        "timed_shape": [b, H, W], "config": "PAPER_DEFAULT", "card": smi,
        **({"ms_per_frame_by_batch": {bb: t[kid] for bb, t in by_batch.items()},
            "library_ms_per_frame_by_batch": {bb: t[lib] for bb, t in by_batch.items()},
            "device_ms_per_frame_by_batch": {bb: t[kid] for bb, t in device_by_batch.items()},
            "library_device_ms_per_frame_by_batch": {bb: t[lib] for bb, t in device_by_batch.items()}}
           if lib else {}),
    } for kid, kname, replaces, err, tol, lib in (
        ("B4", "bg_create", "src/repro/kernels/bg_create.py:68", staged_err[0], 0.0, "index_add_"),
        ("B5", "bg_blur", "src/repro/kernels/bg_blur.py:57", staged_err[1], list(TOL_GF), "conv3d"),
        ("B6", "bg_slice", "src/repro/kernels/bg_slice.py:90", staged_err[2], TOL_TI, "grid_sample"),
    )]})
    # the previous designs' times, copied from PERF.md's kernel table: not
    # measured in this run
    emit({"phase": "earlier_designs", "measured_here": False, "copied_from": "PERF.md kernel table, PR 13",
          "card": "NVIDIA H100 80GB HBM3, 700.00 W", "config": "PAPER_DEFAULT", "batch": 8,
          "ms_per_frame": {"bg_fused": 0.03417, "bg_fused_temporal": 0.03461, "bg_blur": 0.00410},
          "designs": {"bg_fused": "bands of 2 stripes, one GC thread per cell column",
                      "bg_fused_temporal": "the same template as bg_fused",
                      "bg_blur": "one thread per output value, 27 loads each"}})
    emit({"phase": "earlier_designs", "measured_here": False, "copied_from": "PERF.md kernel table, B4's previous design",
          "card": "NVIDIA H100 80GB HBM3, 700.00 W", "config": "PAPER_DEFAULT",
          "ms_per_frame_by_batch": {"bg_create": {1: 0.04570, 4: 0.01594, 8: 0.01551}},
          "device_ms_per_frame_by_batch": {"bg_create": {1: 0.02404, 4: 0.01549, 8: 0.01516}},
          "designs": {"bg_create": "one thread per (x plane, y cell), its 2*gz bins in shared memory, "
                                   "a read-modify-write per pixel"}})
    emit({"phase": "earlier_designs", "measured_here": False, "copied_from": "PERF.md kernel table, B3's and B6's previous designs",
          "card": "NVIDIA H100 80GB HBM3, 700.00 W", "config": "PAPER_DEFAULT",
          "ms_per_frame_by_batch": {"bg_fused_streamed": {1: 0.08369, 4: 0.03901, 8: 0.03215},
                                    "bg_slice": {8: 0.02035}},
          "designs": {"bg_fused_streamed": "one 512-thread block per band of stripes over the whole width, "
                                           "one GC owner per (plane part, cell), rows copied twice",
                      "bg_slice": "one thread per pixel, three divisions and eight corner gathers each"}})
    # the launcher: plans from plan_for (the cost model: the cache is empty),
    # once as the plan layer chooses and once pinned on each kernel route
    # (stream_input True: B3, the JAX launcher's --stream-input; False: B1)
    for stream_input in (None, True, False):
        st = serve_frames(32, H, W, micro_batch=max_batch, config="paper-default", device="cuda",
                          stream_input=stream_input)
        ran = "bg_fused_streamed_launches" if st["backend"] == "fused_streamed" else "bg_fused_launches"
        idle = "bg_fused_launches" if ran == "bg_fused_streamed_launches" else "bg_fused_streamed_launches"
        per = -(-max_batch // st["batch_tile"])  # 32 frames: 4 dispatches of 8
        pinned = {None: st["backend"], True: "fused_streamed", False: "fused"}[stream_input]
        check(st[ran] == st["dispatches"] * per and st[ran] > 0 and st[idle] == 0 and st["provenance"] == "model"
              and st["backend"] == pinned, f"serve_frames: {st}")
        emit({"phase": "serve", "config": "PAPER_DEFAULT", "frame_hw": [H, W], "stream_input": stream_input,
              "card": smi, **st})
    vstats = serve_video(4, 24, H, W, alpha=0.6, config="paper-default", device="cuda")
    check(vstats["failed"] == vstats["shed"] == 0, f"serve_video: {vstats}")
    check(vstats["retries"] == vstats["fallbacks"] == vstats["watchdog_trips"] == 0, f"serve_video: {vstats}")
    emit({"phase": "serve_video", "config": "PAPER_DEFAULT", "frame_hw": [H, W], "card": smi, **vstats})
    fleet_slice(torch, smi, dev)
    # ---- phase 5: the rest of the image core and the frontends
    core_paths(torch, smi, dev, clean, x8)
    # ---- phase 6: batch sharding (a mesh naming the card twice)
    mesh_slice(torch, smi, dev, x8)
    # ---- phase 7: the LM serving substrate (smoke archs card vs CPU, the
    # engine, yi-6b at full width through the launcher, the vlm example)
    served = lm_slice(torch, smi, dev)
    # ---- phase 8: LM training and checkpoints (smoke archs card vs CPU,
    # stablelm-1.6b at full width, remat, train -> checkpoint -> serve, the
    # train_lm example); checkpoints under the checkout's build/ (git
    # ignores it), the full-width one (19.7 GB) kept for phase 9
    import shutil
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="train_slice.", dir=os.path.join(ROOT, "build"))
    try:
        trained = train_slice(torch, smi, dev, work)
        # ---- phase 9: LM sharding (elastic restore of phase 8's checkpoint
        # onto a (1, 1) DeviceMesh and steps on it, bit for bit against no
        # mesh, ring attention and GPipe, the launcher's --mesh
        # --distributed, a 4-rank CPU check of every arch)
        lm_mesh_slice(torch, smi, dev, trained, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # ---- phase 10: the dry-run and roofline tooling (the CLI on production
    # cells over fake groups, the roofline against phases 7 and 8's measured
    # steps, the plan table from phase 3f's rows)
    dryrun_slice(torch, smi, served, trained, sweep)

    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
