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
chooses, and pinned on B3 and on B1). Every served
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
SOURCES = ("bg_fused", "bg_fused_streamed", "bg_create", "bg_blur", "bg_slice")
# every launch counter of the port: (wrapper, attribute)
COUNTERS = (("bg_fused", "launches"), ("bg_fused", "temporal_launches"),
            ("bg_fused", "streamed_launches"), ("bg_fused", "bf16_launches"),
            ("bg_fused", "bf16_temporal_launches"), ("bg_fused", "bf16_streamed_launches"),
            ("bg_create", "launches"), ("bg_blur", "launches"), ("bg_slice", "launches"))


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
    row."""
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
    rows, design, target = [], [], []
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
            picks = {}
            for mode, prec, ref in (("auto", "auto", best), ("fp32", None, best32)):
                pick = P.plan_for(cfg, hh, ww, n_frames=n, temporal=temporal, precision=prec, cache=False,
                                  device=dev)
                check(pick in meas, f"{label} n={n}: model pick {pick.describe()} is not a swept candidate")
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


def kernel_counts() -> dict:
    import repro_torch.kernels as k

    return {f"{fn}.{attr}": getattr(getattr(k, fn), attr) for fn, attr in COUNTERS}


def zero_counts() -> None:
    import repro_torch.kernels as k

    for fn, attr in COUNTERS:
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
    _build.build_all(SOURCES)  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    limits = (torch.cuda.get_device_properties(0).multi_processor_count, kmod._device_limits(0)[1])
    ptxas = {src: [ln.strip() for ln in _build.build_log(src).splitlines() if "ptxas info" in ln]
             for src in SOURCES}
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
    plan_sweep(torch, x8, smi, dev)

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

    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
